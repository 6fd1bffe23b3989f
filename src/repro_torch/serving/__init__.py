from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.frontdoor import (AdmissionController, FrontDoor,
                                           SessionRouter, ShedError,
                                           TenantQuota, TokenBucket)
from repro_torch.serving.request import EngineStats, Request, RequestState
from repro_torch.serving.session import (Session, SLOClass, StreamError,
                                         TokenStream, Turn)

__all__ = ["InferenceEngine", "Request", "RequestState", "EngineStats",
           "FrontDoor", "AdmissionController", "SessionRouter", "ShedError",
           "TenantQuota", "TokenBucket", "Session", "SLOClass",
           "StreamError", "TokenStream", "Turn"]
