"""Launch wrappers of the hand-written CUDA flash-decode kernels.

Port of ``repro.kernels.decode_attention``'s ``flash_decode`` (the Pallas
``_decode_kernel``) and ``paged_flash_decode`` (``_paged_decode_kernel``).
The kernels are ``csrc/flash_decode.cu`` (one query token per slot against
the contiguous slot cache, per-slot valid lengths, an optional active mask)
and ``csrc/paged_flash_decode.cu`` (the same against the paged pool read
through a per-slot page table); both run ``csrc/decode_kernel.cuh``, the G
grouped query heads of a KV head in one block. ``paged_mla_decode`` comes
with the MLA family in a later slice.
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
_PAGED_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [
    ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _lib(name: str, argtypes):
    lib = build.library(name)
    fn = getattr(lib, f"{name}_fwd")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check_q(kernel: str, q: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor, lengths: torch.Tensor) -> None:
    """What both decode kernels require of q, K/V and the lengths: one CUDA
    device, f32 or bf16 of one dtype, q (B, H, D) contiguous, K/V 4-d
    (rows, ..., Hkv, D) of one shape and contiguous, a supported head_dim
    and group, lengths a contiguous (B,) int32 tensor."""
    dev = q.device
    if not (q.is_cuda and k.device == dev and v.device == dev
            and lengths.device == dev):
        raise ValueError(f"{kernel} kernel: q, K/V and lengths must be on "
                         f"one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{kernel} kernel takes f32 or bf16 q and K/V of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{kernel} kernel: q (B,H,D) and K/V 4-d of one "
                         f"shape; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, D = q.shape
    Hkv = k.shape[2]
    if k.shape[3] != D or H % Hkv:
        raise ValueError(f"{kernel} kernel: q {tuple(q.shape)} does not "
                         f"match K/V {tuple(k.shape)}")
    if D not in HEAD_DIMS or H // Hkv > MAX_GROUP:
        raise ValueError(f"{kernel} kernel: head_dim {D} (takes "
                         f"{HEAD_DIMS}) or group {H // Hkv} (max "
                         f"{MAX_GROUP}) not supported")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{kernel} kernel: q and K/V must be contiguous")
    if (lengths.dtype != torch.int32 or lengths.shape != (B,)
            or not lengths.is_contiguous()):
        raise ValueError(f"{kernel} kernel: lengths must be a contiguous "
                         f"(B,) int32 tensor")


def check_inputs(q: torch.Tensor, cache_k: torch.Tensor,
                 cache_v: torch.Tensor, lengths: torch.Tensor,
                 active: Optional[torch.Tensor]) -> None:
    _check_q("flash_decode", q, cache_k, cache_v, lengths)
    if cache_k.shape[0] != q.shape[0]:
        raise ValueError(f"flash_decode kernel: q {tuple(q.shape)} does not "
                         f"match cache {tuple(cache_k.shape)}")
    if active is not None and (active.dtype != torch.bool
                               or active.shape != q.shape[:1]
                               or active.device != q.device
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
    lib = _lib("flash_decode", _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.flash_decode_fwd(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        lengths.data_ptr(), active.data_ptr() if active is not None else None,
        out.data_ptr(), B, H, Hkv, Skv, D, float(scale), _DTYPES[q.dtype],
        stream)
    build.check(lib, "flash_decode", code)
    return out


def check_paged_inputs(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_table: torch.Tensor,
                       lengths: torch.Tensor) -> None:
    _check_q("paged_flash_decode", q, k_pages, v_pages, lengths)
    B = q.shape[0]
    if (page_table.dtype != torch.int32 or page_table.dim() != 2
            or page_table.shape[0] != B or page_table.shape[1] < 1
            or page_table.device != q.device):
        raise ValueError(f"paged_flash_decode kernel: page_table must be a "
                         f"(B, n >= 1) int32 tensor on q's device; got "
                         f"{page_table.dtype} {tuple(page_table.shape)}")
    # a column slice of a wider table is taken as it is (rows are
    # stride(0) apart); any other layout is refused
    if page_table.stride(1) != 1 or (
            B > 1 and page_table.stride(0) < page_table.shape[1]):
        raise ValueError(f"paged_flash_decode kernel: page_table rows must "
                         f"be contiguous (a column slice of a row-major "
                         f"table); got strides {page_table.stride()}")


def paged_flash_decode_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, page_table: torch.Tensor,
                            lengths: torch.Tensor, *,
                            scale: float) -> torch.Tensor:
    """q (B, H, D); k/v_pages (NP+1, P, Hkv, D); page_table (B, n) int32;
    lengths (B,) int32 -> (B, H, D) in q's dtype. Key t of slot b is
    ``pages[page_table[b, t // P], t % P]``. Launches the kernel; raises on
    a refused launch."""
    check_paged_inputs(q, k_pages, v_pages, page_table, lengths)
    B, H, D = q.shape
    P, Hkv = k_pages.shape[1], k_pages.shape[2]
    n = page_table.shape[1]
    stride = page_table.stride(0) if B > 1 else n
    out = torch.empty_like(q)
    lib = _lib("paged_flash_decode", _PAGED_ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.paged_flash_decode_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), stride, n, P, lengths.data_ptr(),
        out.data_ptr(), B, H, Hkv, D, float(scale), _DTYPES[q.dtype], stream)
    build.check(lib, "paged_flash_decode", code)
    return out
