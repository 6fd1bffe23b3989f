"""Device choice for the port's entry points.

``build_model`` and ``InferenceEngine`` run on the card unless the caller
asks for the CPU: without a CUDA device they raise instead of carrying on
silently on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve(device: Union[str, torch.device]) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the card; pass "
            "device='cpu' to run it on the CPU instead")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on 'cuda' or 'cpu', not {dev}")
    return dev
