"""Launch wrappers of the hand-written CUDA grouped expert GEMM.

Port of ``repro.kernels.moe_gemm.grouped_gemm`` (the Pallas
``_gemm_kernel``). One kernel, ``csrc/grouped_gemm.cu``, behind two
entry points:

* ``grouped_gemm_segments_cuda(x (N, d), counts (E,), w (E, d, f))``: rows
  grouped by expert in contiguous segments of ``counts[e]`` rows, as the
  port's MoE dispatch lays them out. The counts stay on the device; the
  launch grid is sized from N and E alone.
* ``grouped_gemm_cuda(x (E, C, d), w (E, d, f))``: the reference's
  contract, the special case of E uniform segments of C rows.

(The port's dense prefill linear is ``kernels/dense_gemm.py``.) Both
accumulate in f32 and return x's dtype; f32 or bf16; d and f
multiples of 8 (DeepSeek's 2048 and 1408 are), every tensor 16-byte
aligned, as TMA requires. The bf16 kernel runs on a persistent grid of one
block an SM, in one of two tile shapes that ``gemm_shape`` picks from (N,
E) alone, never from the counts on the device: "wide" 128 x 128 tiles for
prefill waves, "narrow" swap-AB 64-column x 16-row tiles for decode steps,
where each expert gets a row or two.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SHAPES = {"wide": 0, "narrow": 1}
# the narrow (swap-AB) shape up to this many rows an expert on average
NARROW_MAX_ROWS = 16
MAX_EXPERTS = 4096  # kMaxE: the experts whose scan fits in shared memory

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_SMS: Dict[int, int] = {}


def gemm_shape(N: int, E: int) -> str:
    """The bf16 kernel's tile shape for N rows over E experts: "narrow"
    (64 columns of an expert's f by 16 of its rows, the weights streamed)
    when the experts average at most NARROW_MAX_ROWS rows, else "wide"
    (128 rows x 128 columns on the tensor cores)."""
    return "narrow" if N <= NARROW_MAX_ROWS * E else "wide"


def _lib():
    lib = build.library("grouped_gemm")
    if lib.grouped_gemm_fwd.argtypes is None:
        lib.grouped_gemm_fwd.argtypes = _ARGTYPES
        lib.grouped_gemm_fwd.restype = ctypes.c_int
    return lib


def _sms(device: torch.device) -> int:
    if device.index not in _SMS:
        _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device.index]


def check_inputs(x: torch.Tensor, counts: torch.Tensor,
                 w: torch.Tensor) -> None:
    """x (N, d) and w (E, d, f) contiguous, 16-byte aligned CUDA tensors
    of one dtype (f32 or bf16), E >= 1, d and f multiples of 8; counts a
    contiguous (E,) int32 tensor on x's device."""
    dev = x.device
    if not (x.is_cuda and w.device == dev and counts.device == dev):
        raise ValueError("grouped_gemm kernel: x, counts and w must be on "
                         "one CUDA device")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"grouped_gemm kernel takes f32 or bf16 x and w of "
                        f"one dtype, got {x.dtype}, {w.dtype}")
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"grouped_gemm kernel: x (N, d) and w (E, d, f); "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}")
    E = w.shape[0]
    if E < 1:
        raise ValueError("grouped_gemm kernel: no experts")
    if (counts.dtype != torch.int32 or counts.shape != (E,)
            or not counts.is_contiguous()):
        raise ValueError("grouped_gemm kernel: counts must be a contiguous "
                         "(E,) int32 tensor")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("grouped_gemm kernel: x and w must be contiguous")
    if x.shape[1] % 8 or w.shape[2] % 8:
        raise ValueError(f"grouped_gemm kernel: d and f must be multiples of "
                         f"8, got {x.shape[1]}, {w.shape[2]}")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("grouped_gemm kernel: x and w must be 16-byte "
                         "aligned")
    if E > MAX_EXPERTS:
        raise ValueError(f"grouped_gemm kernel: {E} experts (takes at most "
                         f"{MAX_EXPERTS})")


def grouped_gemm_segments_cuda(x: torch.Tensor, counts: torch.Tensor,
                               w: torch.Tensor,
                               out: Optional[torch.Tensor] = None,
                               shape: Optional[str] = None) -> torch.Tensor:
    """x (N, d) grouped by expert; counts (E,) int32; w (E, d, f) -> (N, f)
    in x's dtype, into ``out`` when given (a contiguous (N, f) tensor of
    x's dtype and device). Rows past sum(counts) are left unwritten.
    ``shape`` ("wide" or "narrow") overrides ``gemm_shape`` for bf16 (a
    test reads one row's bits on both). Launches the kernel; raises on a
    refused launch."""
    check_inputs(x, counts, w)
    N, d = x.shape
    E, f = w.shape[0], w.shape[2]
    if out is None:
        out = torch.empty((N, f), dtype=x.dtype, device=x.device)
    elif (out.shape != (N, f) or out.dtype != x.dtype
          or out.device != x.device or not out.is_contiguous()
          or out.data_ptr() % 16):
        raise ValueError(f"grouped_gemm kernel: out must be a contiguous, "
                         f"16-byte aligned ({N}, {f}) {x.dtype} tensor on "
                         f"x's device")
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.grouped_gemm_fwd(x.data_ptr(), counts.data_ptr(),
                                w.data_ptr(), out.data_ptr(), N, E, d, f,
                                _DTYPES[x.dtype],
                                _SHAPES[shape or gemm_shape(N, E)],
                                _sms(x.device), stream)
    build.check(lib, "grouped_gemm", code)
    return out


def grouped_gemm_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, C, d); w (E, d, f) -> (E, C, f): E uniform segments of C
    rows."""
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0]:
        raise ValueError(f"grouped_gemm kernel: x (E, C, d) and w (E, d, "
                         f"f); got {tuple(x.shape)}, {tuple(w.shape)}")
    E, C, d = x.shape
    counts = torch.full((E,), C, dtype=torch.int32, device=x.device)
    out = grouped_gemm_segments_cuda(x.reshape(E * C, d), counts, w)
    return out.reshape(E, C, w.shape[2])
