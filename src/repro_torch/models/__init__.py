from repro_torch.models.hybrid import Hybrid
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import Transformer

__all__ = ["build_model", "Hybrid", "Transformer"]
