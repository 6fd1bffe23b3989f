"""Launch wrappers of the hand-written CUDA flash-decode kernels.

Port of ``repro.kernels.decode_attention``'s ``flash_decode`` (the Pallas
``_decode_kernel``) and ``paged_flash_decode`` (``_paged_decode_kernel``).
The kernels are ``csrc/flash_decode.cu`` (one query token per slot against
the contiguous slot cache, per-slot valid lengths, an optional active mask)
and ``csrc/paged_flash_decode.cu`` (the same against the paged pool read
through a per-slot page table); both run ``csrc/decode_kernel.cuh``:
split-KV over fixed 256-key ranges (``decode_splits``), a partial pass
whose blocks each take one (split, KV head, slot) and a combine pass that
weighs a slot's splits in order; on request the slot-cache kernel also
gives each (slot, head)'s log-sum-exp, with which ``models.attention.
combine_partials`` merges the outputs of disjoint key ranges (a cache
sharded on its sequence). ``splitkv_decode_plain`` is the same
split-and-combine arithmetic in plain torch, for the CPU tests.
``paged_mla_decode`` (the Pallas ``_paged_mla_kernel``) is
``csrc/paged_mla_decode.cu``: DeepSeek's absorbed MLA decode over the
paged latents, output in latent space.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 80, 112, 128, 160)
MAX_GROUP = 16  # query heads per KV head one block handles (kMaxG)

DECODE_SPLIT = 256    # keys a split of the GQA decode kernel (kSplit)

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_PAGED_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [
    ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_MLA_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [
    ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
    ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
MLA_MAX_LATENT = 512  # widest latent R the MLA kernel's accumulators hold
_MLA_TILE = 64        # keys per tile of the bf16 MLA kernel (tc::kBK)
_MLA_HEADS = 16       # heads per block of the bf16 MLA kernel (tc::kHG)
_MLA_MAX_SPLITS = 64  # key ranges per slot the combine pass takes
_SMS: Dict[int, int] = {}
_MLA_WIDTH: Dict[torch.dtype, int] = {}


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
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{kernel} kernel: K/V must be 16-byte aligned")
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


def decode_splits(capacity: int) -> int:
    """Key ranges of the GQA decode kernel over a cache of ``capacity``
    keys (the slot cache's Skv, or a page table's n * P): split s covers
    keys [256 s, 256 (s + 1)). The boundaries are fixed key positions, so
    a slot's keys fall into the same splits in the slot cache and in the
    paged pool whatever their capacities; the capacity sets only how many
    splits the scratch holds."""
    return -(-capacity // DECODE_SPLIT)


def splitkv_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor, *, scale: float,
                         split: int = DECODE_SPLIT) -> torch.Tensor:
    """The decode kernels' split-and-combine arithmetic in plain torch, f32:
    q (B, H, D) against k, v (B, T, Hkv, D) with keys at or past
    ``lengths[b]`` masked. Each ``split``-key range gives an unnormalised
    accumulator and its (m, l); the live ranges are weighed by exp(m_s -
    max m) in order and divided by max(l, 1e-30). A slot of length 0 gets
    zeros."""
    B, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    n = lengths.long()[:, None]                                  # (B, 1)
    s_all = torch.einsum("bhd,bthd->bht", q.float(), kf) * scale
    dev = q.device
    m_tot = torch.full((B, H), -1e30, device=dev)
    parts = []
    for lo in range(0, T, split):
        pos = torch.arange(lo, min(lo + split, T), device=dev)
        mask = (pos[None, :] < n)[:, None, :]                    # (B, 1, s)
        s = torch.where(mask, s_all[..., lo:lo + split],
                        torch.full((), -1e30, device=dev))
        m = s.amax(dim=-1)                                       # (B, H)
        p = torch.where(mask, torch.exp(s - m[..., None]),
                        torch.zeros((), device=dev))
        acc = torch.einsum("bht,bthd->bhd", p, vf[:, lo:lo + split])
        live = (lo < n)                                          # (B, 1)
        parts.append((m, p.sum(dim=-1), acc, live))
        m_tot = torch.where(live, torch.maximum(m_tot, m), m_tot)
    l_tot = torch.zeros((B, H), device=dev)
    a_tot = torch.zeros((B, H, D), device=dev)
    for m, l, acc, live in parts:
        w = torch.where(live, torch.exp(m - m_tot),
                        torch.zeros((), device=dev))
        l_tot = l_tot + w * l
        a_tot = a_tot + w[..., None] * acc
    return a_tot / torch.clamp(l_tot, min=1e-30)[..., None]


def _decode_scratch(B: int, H: int, D: int, nsplit: int,
                    dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The partial pass's f32 accumulators (B, H, nsplit, D) and (m, l)
    (B, H, nsplit, 2), in one allocation."""
    n = B * H * nsplit
    buf = torch.empty(n * (D + 2), dtype=torch.float32, device=dev)
    return buf[:n * D], buf[n * D:]


def flash_decode_cuda(q: torch.Tensor, cache_k: torch.Tensor,
                      cache_v: torch.Tensor, lengths: torch.Tensor, *,
                      scale: float, active: Optional[torch.Tensor] = None,
                      return_lse: bool = False):
    """q (B, H, D); cache (B, Skv, Hkv, D); lengths (B,) int32; active (B,)
    bool or None -> (B, H, D) in q's dtype; with ``return_lse`` also the
    (B, H) f32 log-sum-exp of the scaled scores over each slot's live keys
    (-inf for a slot with none). Launches the kernel; raises on a refused
    launch."""
    check_inputs(q, cache_k, cache_v, lengths, active)
    B, H, D = q.shape
    Skv, Hkv = cache_k.shape[1], cache_k.shape[2]
    nsplit = decode_splits(Skv)
    part, part_ml = _decode_scratch(B, H, D, nsplit, q.device)
    out = torch.empty_like(q)
    lse = (torch.empty((B, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lib = _lib("flash_decode", _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.flash_decode_fwd(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        lengths.data_ptr(), active.data_ptr() if active is not None else None,
        part.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None, B, H, Hkv, Skv, D, nsplit,
        float(scale), _DTYPES[q.dtype], stream)
    build.check(lib, "flash_decode", code)
    return (out, lse) if return_lse else out


def check_paged_inputs(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_table: torch.Tensor,
                       lengths: torch.Tensor) -> None:
    _check_q("paged_flash_decode", q, k_pages, v_pages, lengths)
    B = q.shape[0]
    _check_table("paged_flash_decode", page_table, B, q.device)


def _check_table(kernel: str, page_table: torch.Tensor, B: int,
                 dev: torch.device) -> None:
    """A (B, n >= 1) int32 table on ``dev`` whose rows are contiguous: a
    column slice of a wider table is taken as it is (rows are stride(0)
    apart); any other layout is refused."""
    if (page_table.dtype != torch.int32 or page_table.dim() != 2
            or page_table.shape[0] != B or page_table.shape[1] < 1
            or page_table.device != dev):
        raise ValueError(f"{kernel} kernel: page_table must be a (B, n >= "
                         f"1) int32 tensor on q's device; got "
                         f"{page_table.dtype} {tuple(page_table.shape)}")
    if page_table.stride(1) != 1 or (
            B > 1 and page_table.stride(0) < page_table.shape[1]):
        raise ValueError(f"{kernel} kernel: page_table rows must be "
                         f"contiguous (a column slice of a row-major "
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
    nsplit = decode_splits(n * P)
    part, part_ml = _decode_scratch(B, H, D, nsplit, q.device)
    out = torch.empty_like(q)
    lib = _lib("paged_flash_decode", _PAGED_ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.paged_flash_decode_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), stride, n, P, lengths.data_ptr(),
        part.data_ptr(), part_ml.data_ptr(), out.data_ptr(), B, H, Hkv, D,
        nsplit, float(scale), _DTYPES[q.dtype], stream)
    build.check(lib, "paged_flash_decode", code)
    return out


def check_mla_inputs(q_lat: torch.Tensor, q_rope: torch.Tensor,
                     ckv_pages: torch.Tensor, krope_pages: torch.Tensor,
                     page_table: torch.Tensor, lengths: torch.Tensor) -> None:
    """What the MLA kernel requires: one CUDA device; f32 or bf16 of one
    dtype; q_lat (B, H, R), q_rope (B, H, Dr), ckv_pages (NP+1, P, R) and
    krope_pages (NP+1, P, Dr), all contiguous, R <= 512, R and Dr
    multiples of 8, R + Dr at most ``mla_max_width``, both pools 16-byte
    aligned; the table as the paged decode's; lengths a contiguous (B,)
    int32 tensor."""
    dev = q_lat.device
    ts = (q_lat, q_rope, ckv_pages, krope_pages)
    if not (q_lat.is_cuda and all(t.device == dev for t in ts)
            and lengths.device == dev):
        raise ValueError("paged_mla_decode kernel: q, the pages and lengths "
                         "must be on one CUDA device")
    if q_lat.dtype not in _DTYPES or any(t.dtype != q_lat.dtype for t in ts):
        raise TypeError(f"paged_mla_decode kernel takes f32 or bf16 inputs "
                        f"of one dtype, got {[t.dtype for t in ts]}")
    if q_lat.dim() != 3 or q_rope.dim() != 3 or ckv_pages.dim() != 3 \
            or krope_pages.dim() != 3:
        raise ValueError("paged_mla_decode kernel: q_lat/q_rope (B,H,.) and "
                         "pages (NP+1,P,.) must be 3-d")
    B, H, R = q_lat.shape
    Dr = q_rope.shape[2]
    if (q_rope.shape[:2] != (B, H) or ckv_pages.shape[2] != R
            or krope_pages.shape != ckv_pages.shape[:2] + (Dr,)):
        raise ValueError(f"paged_mla_decode kernel: shapes do not match: "
                         f"{[tuple(t.shape) for t in ts]}")
    if R > MLA_MAX_LATENT:
        raise ValueError(f"paged_mla_decode kernel: latent width {R} above "
                         f"{MLA_MAX_LATENT}")
    if R % 8 or Dr % 8:
        raise ValueError(f"paged_mla_decode kernel: R and Dr must be "
                         f"multiples of 8, got {R}, {Dr}")
    width = mla_max_width(q_lat.dtype)
    if R + Dr > width:
        raise ValueError(f"paged_mla_decode kernel: R + Dr = {R + Dr} above "
                         f"{width}, the widest {q_lat.dtype} row its shared "
                         f"memory stages")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("paged_mla_decode kernel: q and the pages must be "
                         "contiguous")
    if ckv_pages.data_ptr() % 16 or krope_pages.data_ptr() % 16:
        raise ValueError("paged_mla_decode kernel: the pages must be 16-byte "
                         "aligned")
    if (lengths.dtype != torch.int32 or lengths.shape != (B,)
            or not lengths.is_contiguous()):
        raise ValueError("paged_mla_decode kernel: lengths must be a "
                         "contiguous (B,) int32 tensor")
    _check_table("paged_mla_decode", page_table, B, dev)


def mla_max_width(dtype: torch.dtype) -> int:
    """The widest R + Dr whose rows the MLA kernel stages in ``dtype``,
    read from the built library, which holds the shared-memory budget."""
    if dtype not in _MLA_WIDTH:
        fn = build.library("paged_mla_decode").paged_mla_decode_max_width
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
        _MLA_WIDTH[dtype] = fn(_DTYPES[dtype])
    return _MLA_WIDTH[dtype]


def mla_splits(B: int, H: int, max_keys: int, sms: int) -> Tuple[int, int]:
    """(splits, keys a split) of the MLA kernel's key axis: ranges of
    whole 64-key tiles, enough of them for about two blocks an SM over the
    B x ceil(H / 16) (slot, head group) blocks (the bf16 kernel takes one
    block an SM; ranges past a slot's length exit at once). Sized from the
    table's capacity, never from the lengths on the device."""
    tiles = max(1, -(-max_keys // _MLA_TILE))
    want = -(-2 * sms // (B * -(-H // _MLA_HEADS)))
    per = -(-tiles // max(1, min(want, tiles, _MLA_MAX_SPLITS)))
    return -(-tiles // per), per * _MLA_TILE


def paged_mla_decode_cuda(q_lat: torch.Tensor, q_rope: torch.Tensor,
                          ckv_pages: torch.Tensor, krope_pages: torch.Tensor,
                          page_table: torch.Tensor, lengths: torch.Tensor, *,
                          scale: float) -> torch.Tensor:
    """q_lat (B, H, R); q_rope (B, H, Dr); ckv_pages (NP+1, P, R);
    krope_pages (NP+1, P, Dr); page_table (B, n) int32; lengths (B,) int32
    -> the latent-space output (B, H, R) in q's dtype. Launches the kernel;
    raises on a refused launch."""
    check_mla_inputs(q_lat, q_rope, ckv_pages, krope_pages, page_table,
                     lengths)
    B, H, R = q_lat.shape
    Dr, P = q_rope.shape[2], ckv_pages.shape[1]
    n = page_table.shape[1]
    stride = page_table.stride(0) if B > 1 else n
    dev = q_lat.device
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    splits, split_keys = mla_splits(B, H, n * P, _SMS[dev.index])
    part = torch.empty((B, H, splits, R), dtype=torch.float32, device=dev)
    part_ml = torch.empty((B, H, splits, 2), dtype=torch.float32,
                          device=dev)
    out = torch.empty_like(q_lat)
    lib = _lib("paged_mla_decode", _MLA_ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.paged_mla_decode_fwd(
        q_lat.data_ptr(), q_rope.data_ptr(), ckv_pages.data_ptr(),
        krope_pages.data_ptr(), page_table.data_ptr(), stride, n, P,
        lengths.data_ptr(), part.data_ptr(), part_ml.data_ptr(),
        out.data_ptr(), B, H, R, Dr, float(scale), splits, split_keys,
        _DTYPES[q_lat.dtype], stream)
    build.check(lib, "paged_mla_decode", code)
    return out
