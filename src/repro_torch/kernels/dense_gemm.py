"""Launch wrapper of the hand-written CUDA prefill linear.

``dense_gemm_cuda(x (..., K), w (K, N) or (N, K))`` launches
``csrc/dense_gemm.cu``, the port's own dense GEMM (it replaces no TPU
kernel: the reference leaves its projections to XLA). Each output row's
bits depend on that row and w alone, never on how many rows share the
call, so a shared-prefix tail wave gives a cold wave's bits.

``dense_gemm_plan(K, N)`` fixes, from K and N alone (never M, never the
card's SM count: the plan is sized for an H100's 132 SMs, a constant), the
wgmma accumulator's width and a K split: ``split`` chunks of ``chunk``
elements, whole 64-deep k-slices, the last one cut at K. Every output is
the f32 sum ``((p_0 + p_1) + ...) + p_{S-1}`` of fresh per-chunk
accumulators, rounded once (``split_matmul_ref`` is its plain model).
``across(p, M, N, sms)`` says how the kernel carries that sum out for M
rows on a card of ``sms`` SMs: across blocks (a cluster of ``split``
blocks a tile, each one chunk, folding the tile's partials in chunk order
through their shared memory) while the call's clusters fit the card at
once, else inside one block (``block_cols``: a block of the plan's
columns or of 128). Both give the same bits. These functions are the one
copy of the plan and the route: ``dense_gemm_cuda`` passes them to the
kernel as integers (``launch_plan``, memoized), and the kernel refuses a
plan whose chunks do not tile K.

bf16 runs on the tensor cores (wgmma + TMA), f32 on the CUDA cores (one
fmaf chain an output, no split). K and N multiples of 8, every tensor
16-byte aligned, as TMA requires.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SLICE = 64        # a k-slice: 64 bf16 = 128 bytes, one TMA box deep
TILE_ROWS = 128   # two consumer warpgroups of 64
MAX_SPLIT = 16    # the largest cluster of blocks that folds a tile
PLAN_SMS = 132    # the H100's SMs, which the plan is sized for
# CLUSTERS_AT_ONCE[S]: the clusters of S blocks (one an SM) that an H100
# holds at once, from cudaOccupancyMaxActiveClusters (chip_smoke.py phase
# 3 reads them again through the library's dense_gemm_clusters_at_once): a
# cluster lies within one GPC, so past 8 blocks only 7-9 fit
CLUSTERS_AT_ONCE = (0, 132, 66, 39, 30, 22, 17, 15, 15, 9, 7, 7, 7, 7, 7, 7,
                    7)

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 10
             + [ctypes.c_void_p])
_SMS: Dict[int, int] = {}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class Plan(NamedTuple):
    """The bf16 kernel's plan for one (K, N): a tile's rows, its wgmma
    accumulator's columns, and ``split`` chunks of ``chunk`` elements of
    K (a multiple of the 64-deep k-slice; the last chunk cut at K)."""
    K: int
    tile_rows: int
    tile_cols: int
    chunk: int
    split: int

    @property
    def chunks(self) -> Tuple[Tuple[int, int], ...]:
        """The [lo, hi) element ranges of K, chunk by chunk."""
        return tuple((lo, min(lo + self.chunk, self.K))
                     for lo in range(0, self.split * self.chunk, self.chunk))


def splits(nk: int):
    """(split, chunk) for each split that chunks of whole k-slices give:
    chunk = cdiv(nk, s) k-slices, split = cdiv(nk, chunk), no two alike."""
    seen = set()
    for s in range(1, min(MAX_SPLIT, nk) + 1):
        chunk = _cdiv(nk, s)
        split = _cdiv(nk, chunk)
        if split not in seen:
            seen.add(split)
            yield split, chunk


@functools.lru_cache(maxsize=None)
def dense_gemm_plan(K: int, N: int) -> Plan:
    """The plan for (K, N), sized for a 128-row call on an H100: for each
    accumulator width (64 columns, 128), the fewest chunks whose items
    (column tiles x chunks) reach three quarters of PLAN_SMS with every
    tile's cluster of blocks on the card at once (CLUSTERS_AT_ONCE), else
    the most items that do; 64 columns unless those items fall short of
    two thirds of PLAN_SMS and 128 columns give more. It reads K and N
    and nothing else."""
    nk = _cdiv(K, SLICE)
    best = None
    for cols in (64, 128):
        nt = _cdiv(N, cols)
        plan, most = None, -1
        for split, chunk in splits(nk):
            if split > 1 and nt > CLUSTERS_AT_ONCE[split]:
                continue
            items = min(nt * split, PLAN_SMS)
            if items > most:
                plan, most = Plan(K, TILE_ROWS, cols, chunk * SLICE,
                                  split), items
            if 4 * items >= 3 * PLAN_SMS:
                break
        if best is None or (3 * best[0] < 2 * PLAN_SMS and most > best[0]):
            best = (most, plan)
    return best[1]


def across(p: Plan, M: int, N: int, sms: int) -> bool:
    """Whether M rows take the across-block route on a card of ``sms``
    SMs (a cluster of ``split`` blocks a tile, one chunk each, folding the
    tile in shared memory): while the call's clusters fit the card at
    once. Either route gives the same bits."""
    tiles = _cdiv(M, p.tile_rows) * _cdiv(N, p.tile_cols)
    return (p.split > 1 and tiles * p.split <= sms
            and tiles <= CLUSTERS_AT_ONCE[p.split])


def block_cols(p: Plan, M: int, N: int, sms: int) -> int:
    """A block's columns for M rows: the plan's on the across route; on
    the inside route 128 (an m64n128k16 accumulator where the plan's is
    m64n64k16) where the call has a wave of 128-column tiles, else the
    plan's. The two instructions give an output the same bits on the card
    (the row-bits sweeps cross this switch), so the bits do not change
    with it."""
    if p.tile_cols != 64 or across(p, M, N, sms):
        return p.tile_cols
    wide = _cdiv(M, p.tile_rows) * _cdiv(N, 128)
    return 128 if wide >= sms else 64


def switch_rows(K: int, N: int, sms: int) -> int:
    """The most rows that still take the across-block route (0: none)."""
    p = dense_gemm_plan(K, N)
    mt = 0
    while across(p, (mt + 1) * p.tile_rows, N, sms):
        mt += 1
    return mt * p.tile_rows


def wide_block_rows(K: int, N: int, sms: int) -> int:
    """The fewest rows (a multiple of 128) whose blocks of a 64-column plan
    take 128 columns (0: none up to 65 536 rows)."""
    p = dense_gemm_plan(K, N)
    return next((M for M in range(p.tile_rows, 65537, p.tile_rows)
                 if block_cols(p, M, N, sms) > p.tile_cols), 0)


@functools.lru_cache(maxsize=4096)
def launch_plan(M: int, K: int, N: int, sms: int) -> Tuple[int, int, int,
                                                            int]:
    """What ``dense_gemm_cuda`` passes the bf16 kernel for M rows of (K, N)
    on a card of ``sms`` SMs: (split, chunk in 64-deep k-slices, a block's
    columns, 1 for the across-block route else 0)."""
    p = dense_gemm_plan(K, N)
    return (p.split, p.chunk // SLICE, block_cols(p, M, N, sms),
            int(across(p, M, N, sms)))


def split_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                     w_kmajor: bool = False) -> torch.Tensor:
    """The plain model of the bf16 kernel's arithmetic: x (M, K) times w
    (K, N), or (N, K) with ``w_kmajor``, as ``((p_0 + p_1) + ...) +
    p_{S-1}`` in f32 over the plan's chunks, each p_s one f32 accumulator
    over its chunk's k in order from zero (one multiply and one add a k,
    where the tensor cores add 16 products at a time), rounded once to x's
    dtype. Every step is elementwise over the rows, so a row's result does
    not depend on M. Slow: for tests at small sizes."""
    wk = (w.t() if w_kmajor else w).float()
    xf = x.float()
    total = None
    for lo, hi in dense_gemm_plan(x.shape[-1], wk.shape[1]).chunks:
        part = torch.zeros(x.shape[:-1] + (wk.shape[1],))
        for k in range(lo, hi):
            part = part + xf[..., k, None] * wk[k]
        total = part if total is None else total + part
    return total.to(x.dtype)


def _lib():
    lib = build.library("dense_gemm")
    if lib.dense_gemm_fwd.argtypes is None:
        lib.dense_gemm_fwd.argtypes = _ARGTYPES
        lib.dense_gemm_fwd.restype = ctypes.c_int
    return lib


def _sms(device: torch.device) -> int:
    if device.index not in _SMS:
        _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device.index]


def _stream(device: torch.device) -> int:
    return torch._C._cuda_getCurrentRawStream(device.index)


def check_inputs(x: torch.Tensor, w: torch.Tensor,
                 w_kmajor: bool) -> Tuple[int, int, int]:
    """x (..., K) and w (K, N), or (N, K) with ``w_kmajor``: contiguous,
    16-byte aligned CUDA tensors of one dtype (f32 or bf16) on one device,
    K and N multiples of 8, K > 0. Returns (M, K, N), M the rows of x (the
    product of its leading sizes)."""
    if not (x.is_cuda and w.device == x.device):
        raise ValueError("dense_gemm kernel: x and w must be on one CUDA "
                         "device")
    dtype = x.dtype
    if dtype not in _DTYPES or w.dtype != dtype:
        raise TypeError(f"dense_gemm kernel takes f32 or bf16 x and w of "
                        f"one dtype, got {dtype}, {w.dtype}")
    if x.dim() < 2 or w.dim() != 2:
        raise ValueError(f"dense_gemm kernel: x (..., K) and w 2-D; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    K = x.shape[-1]
    N, Kw = (w.shape if w_kmajor else w.shape[::-1])
    if Kw != K:
        raise ValueError(f"dense_gemm kernel: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} (K-major: {w_kmajor}) do not "
                         f"contract")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("dense_gemm kernel: x and w must be contiguous")
    if K % 8 or N % 8 or not K:
        raise ValueError(f"dense_gemm kernel: K and N must be multiples of "
                         f"8 and K > 0, got {K}, {N}")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("dense_gemm kernel: x and w must be 16-byte "
                         "aligned")
    return x.numel() // K, K, N


def dense_gemm_cuda(x: torch.Tensor, w: torch.Tensor,
                    w_kmajor: bool = False) -> torch.Tensor:
    """x (..., K) x w (K, N), or x w^T for w (N, K) with ``w_kmajor`` ->
    (..., N) in x's dtype, f32 accumulation: x's rows are read in place
    and the output is made in its final shape, so a call costs the host no
    reshape. Launches the kernel on ``launch_plan``'s plan and route;
    raises on a refused launch."""
    M, K, N = check_inputs(x, w, w_kmajor)
    dev = x.device
    sms = _sms(dev)
    split, chunk, cols, acr = launch_plan(M, K, N, sms)
    out = x.new_empty(x.shape[:-1] + (N,))
    lib = _lib()
    code = lib.dense_gemm_fwd(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), M, K, N,
        _DTYPES[x.dtype], int(w_kmajor), split, chunk, cols, acr, sms,
        _stream(dev))
    build.check(lib, "dense_gemm", code)
    return out
