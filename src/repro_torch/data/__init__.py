from repro_torch.data import fever
from repro_torch.data.tokenizer import HashTokenizer

__all__ = ["HashTokenizer", "fever"]
