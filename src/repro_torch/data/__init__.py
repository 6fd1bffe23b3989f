from repro_torch.data import fever
from repro_torch.data.pipeline import PipelineConfig, batches
from repro_torch.data.tokenizer import HashTokenizer

__all__ = ["HashTokenizer", "PipelineConfig", "batches", "fever"]
