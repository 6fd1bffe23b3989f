from repro_torch.models.encdec import EncDec
from repro_torch.models.hybrid import Hybrid
from repro_torch.models.registry import (build_model, extra_inputs,
                                         input_specs)
from repro_torch.models.transformer import Transformer
from repro_torch.models.vision import Vision
from repro_torch.models.xlstm import XLSTM

__all__ = ["build_model", "extra_inputs", "input_specs", "EncDec", "Hybrid",
           "Transformer", "Vision", "XLSTM"]
