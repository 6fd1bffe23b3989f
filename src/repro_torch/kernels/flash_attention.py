"""Launch wrapper of the hand-written CUDA prefill flash attention.

Port of ``repro.kernels.flash_attention`` (the Pallas ``flash_attention_bhsd``).
The kernel is ``csrc/flash_attention.cu``: causal, sliding-window or full
attention with per-row valid key counts, per-row query offsets and GQA by
head index, in the reference's public (B, S, H, D) layout: bf16 on
``wgmma`` fed by TMA (q, k, v and the output 16-byte aligned), f32 on the
CUDA cores. This wrapper checks what the kernel takes, allocates the
output and launches on PyTorch's current stream; it never falls back to
another implementation.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 80, 112, 128, 160)

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _lib():
    lib = build.library("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _check_rows(name: str, x: Optional[torch.Tensor], q: torch.Tensor
                ) -> None:
    if x is not None and (x.dtype != torch.int32 or x.shape != q.shape[:1]
                          or x.device != q.device or not x.is_contiguous()):
        raise ValueError(f"flash_attention kernel: {name} must be a "
                         f"contiguous (B,) int32 tensor on q's device")


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: Optional[torch.Tensor],
                 q_offset: Optional[torch.Tensor] = None) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention kernel: q, k, v must be on one "
                         "CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes f32 or bf16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention kernel: q (B,S,H,D), k and v "
                         f"(B,T,Hkv,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"flash_attention kernel: q {tuple(q.shape)} does "
                         f"not match k {tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head_dim {D} not in "
                         f"{HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel: q, k, v must be "
                         "contiguous")
    _check_rows("kv_len", kv_len, q)
    _check_rows("q_offset", q_offset, q)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: int, scale: float,
                         kv_len: Optional[torch.Tensor] = None,
                         q_offset: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """q (B, S, H, D); k, v (B, T, Hkv, D); kv_len, q_offset (B,) int32 or
    None -> (B, S, H, D) in q's dtype. Launches the kernel; raises on a
    refused launch."""
    check_inputs(q, k, v, kv_len, q_offset)
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_len.data_ptr() if kv_len is not None else None,
        q_offset.data_ptr() if q_offset is not None else None, out.data_ptr(),
        B, S, T, H, Hkv, D, int(bool(causal)), int(window), float(scale),
        _DTYPES[q.dtype], stream)
    build.check(lib, "flash_attention", code)
    return out
