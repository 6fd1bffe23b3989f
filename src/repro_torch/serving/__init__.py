from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.request import EngineStats, Request, RequestState

__all__ = ["InferenceEngine", "Request", "RequestState", "EngineStats"]
