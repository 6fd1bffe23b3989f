"""Dispatch of the port's kernels, with launch counts.

Port of ``repro.kernels.ops``. Where the reference chooses between the
Pallas kernel and interpret mode by backend, the port chooses by the
tensor's device: a CUDA tensor launches the hand-written kernel (or
raises: there is no fallback), a CPU tensor runs the plain version in
``repro_torch.kernels.ref``. The model layer calls these entry points when
``cfg.use_kernels`` is set.

``LAUNCHES`` counts kernel launches per entry point: one is added where a
kernel launches and nowhere else, so a run can show that its main path
went through the kernels.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import flash_decode_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda

LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_decode": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cpu(x: torch.Tensor, name: str) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"{name}: no kernel for device {x.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, scale: float = 1.0,
                    kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, S, H, D); k, v (B, T, Hkv, D); kv_len (B,) -> (B, S, H, D).

    Rows whose queries see no key (``kv_len[b] == 0``) come out as zeros."""
    if _on_cpu(q, "flash_attention"):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       scale=scale, kv_len=kv_len)
    out = flash_attention_cuda(q, k, v, causal=causal, window=window,
                               scale=scale, kv_len=kv_len)
    LAUNCHES["flash_attention"] += 1
    return out


def flash_decode(q: torch.Tensor, cache_k: torch.Tensor,
                 cache_v: torch.Tensor, lengths: torch.Tensor, *,
                 scale: float = 1.0,
                 active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, H, D); cache (B, Skv, Hkv, D); lengths (B,) -> (B, H, D)."""
    if _on_cpu(q, "flash_decode"):
        return ref.flash_decode_ref(q, cache_k, cache_v, lengths, scale=scale,
                                    active=active)
    out = flash_decode_cuda(q, cache_k, cache_v, lengths, scale=scale,
                            active=active)
    LAUNCHES["flash_decode"] += 1
    return out


__all__ = ["flash_attention", "flash_decode", "LAUNCHES", "reset_launches",
           "ref"]
