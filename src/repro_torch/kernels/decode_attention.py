"""Launch wrapper of the hand-written CUDA flash-decode.

Port of ``repro.kernels.decode_attention.flash_decode`` (the Pallas
``_decode_kernel``). The kernel is ``csrc/flash_decode.cu``: one query token
per slot against the contiguous slot cache, per-slot valid lengths, an
optional active mask, the G grouped query heads of a KV head in one block.
The paged variants of the reference module (``paged_flash_decode``,
``paged_mla_decode``) come with the paged pool in a later slice.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 16  # query heads per KV head one block handles (kMaxG)

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _lib():
    lib = build.library("flash_decode")
    fn = lib.flash_decode_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def check_inputs(q: torch.Tensor, cache_k: torch.Tensor,
                 cache_v: torch.Tensor, lengths: torch.Tensor,
                 active: Optional[torch.Tensor]) -> None:
    dev = q.device
    if not (q.is_cuda and cache_k.device == dev and cache_v.device == dev
            and lengths.device == dev):
        raise ValueError("flash_decode kernel: q, cache and lengths must be "
                         "on one CUDA device")
    if (q.dtype not in _DTYPES or cache_k.dtype != q.dtype
            or cache_v.dtype != q.dtype):
        raise TypeError(f"flash_decode kernel takes f32 or bf16 q and cache "
                        f"of one dtype, got {q.dtype}, {cache_k.dtype}, "
                        f"{cache_v.dtype}")
    if q.dim() != 3 or cache_k.dim() != 4 or cache_k.shape != cache_v.shape:
        raise ValueError(f"flash_decode kernel: q (B,H,D), cache "
                         f"(B,Skv,Hkv,D); got {tuple(q.shape)}, "
                         f"{tuple(cache_k.shape)}, {tuple(cache_v.shape)}")
    B, H, D = q.shape
    Hkv = cache_k.shape[2]
    if cache_k.shape[0] != B or cache_k.shape[3] != D or H % Hkv:
        raise ValueError(f"flash_decode kernel: q {tuple(q.shape)} does not "
                         f"match cache {tuple(cache_k.shape)}")
    if D not in HEAD_DIMS or H // Hkv > MAX_GROUP:
        raise ValueError(f"flash_decode kernel: head_dim {D} (takes "
                         f"{HEAD_DIMS}) or group {H // Hkv} (max "
                         f"{MAX_GROUP}) not supported")
    if not (q.is_contiguous() and cache_k.is_contiguous()
            and cache_v.is_contiguous()):
        raise ValueError("flash_decode kernel: q and cache must be "
                         "contiguous")
    if (lengths.dtype != torch.int32 or lengths.shape != (B,)
            or not lengths.is_contiguous()):
        raise ValueError("flash_decode kernel: lengths must be a contiguous "
                         "(B,) int32 tensor")
    if active is not None and (active.dtype != torch.bool
                               or active.shape != (B,)
                               or active.device != dev
                               or not active.is_contiguous()):
        raise ValueError("flash_decode kernel: active must be a contiguous "
                         "(B,) bool tensor on q's device")


def flash_decode_cuda(q: torch.Tensor, cache_k: torch.Tensor,
                      cache_v: torch.Tensor, lengths: torch.Tensor, *,
                      scale: float,
                      active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, H, D); cache (B, Skv, Hkv, D); lengths (B,) int32; active (B,)
    bool or None -> (B, H, D) in q's dtype. Launches the kernel; raises on a
    refused launch."""
    check_inputs(q, cache_k, cache_v, lengths, active)
    B, H, D = q.shape
    Skv, Hkv = cache_k.shape[1], cache_k.shape[2]
    out = torch.empty_like(q)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.flash_decode_fwd(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        lengths.data_ptr(), active.data_ptr() if active is not None else None,
        out.data_ptr(), B, H, Hkv, Skv, D, float(scale), _DTYPES[q.dtype],
        stream)
    build.check(lib, "flash_decode", code)
    return out
