"""Launch wrapper of the hand-written CUDA SSD scan.

Port of ``repro.kernels.ssm_scan`` (the Pallas ``ssd_scan_bhs``). The
kernel is ``csrc/ssd_scan.cu``: the Mamba2 recurrence ``state_t =
exp(log_a_t) * state_{t-1} + B_t v_t^T``, ``y_t = C_t . state_t`` in
chunked form on the tensor cores (3xTF32), in ``ops.ssm_scan``'s (Bb, S,
H, .) layout read through the inputs' strides; B and C may come per group,
(Bb, S, G, N) with head h reading group ``h // (H // G)``. This wrapper
checks what the kernel takes, allocates y and the final state and launches
on PyTorch's current stream; it never falls back to another
implementation.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

STATE_DIMS = (8, 16, 32, 64)   # N the kernel is built for
HEAD_DIMS = (16, 32, 64)       # P the kernel is built for

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _lib():
    lib = build.library("ssd_scan")
    if lib.ssd_scan_fwd.argtypes is None:
        lib.ssd_scan_fwd.argtypes = _ARGTYPES
        lib.ssd_scan_fwd.restype = ctypes.c_int
    return lib


def check_inputs(C: torch.Tensor, B: torch.Tensor, v: torch.Tensor,
                 log_a: torch.Tensor) -> None:
    """C and B (Bb, S, G, N) with H % G == 0, v (Bb, S, H, P), log_a (Bb,
    S, H): f32 CUDA tensors on one device, N and P sizes the kernel is built
    for, the last axis of C, B and v contiguous (other strides are read as
    they are)."""
    ts = (C, B, v, log_a)
    if not (C.is_cuda and all(t.device == C.device for t in ts)):
        raise ValueError("ssd_scan kernel: C, B, v and log_a must be on one "
                         "CUDA device")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"ssd_scan kernel takes f32 inputs, got "
                        f"{[t.dtype for t in ts]}")
    if C.dim() != 4 or B.shape != C.shape or v.dim() != 4 \
            or v.shape[:2] != C.shape[:2] or log_a.shape != v.shape[:3] \
            or v.shape[2] % C.shape[2]:
        raise ValueError(f"ssd_scan kernel: C, B (Bb,S,G,N) with H % G == "
                         f"0, v (Bb,S,H,P), log_a (Bb,S,H); got "
                         f"{[tuple(t.shape) for t in ts]}")
    N, P = C.shape[3], v.shape[3]
    if N not in STATE_DIMS or P not in HEAD_DIMS:
        raise ValueError(f"ssd_scan kernel: state dim {N} (takes "
                         f"{STATE_DIMS}) or head dim {P} (takes {HEAD_DIMS}) "
                         f"not supported")
    if C.stride(3) != 1 or B.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("ssd_scan kernel: the last axis of C, B and v must "
                         "be contiguous")


def _rows_aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its rows start on 16-byte boundaries (the
    kernel's 16-byte copies), else a contiguous copy."""
    if t.data_ptr() % 16 or any(s % 4 for s in t.stride()[:3]):
        return t.contiguous()
    return t


def ssd_scan_cuda(C: torch.Tensor, B: torch.Tensor, v: torch.Tensor,
                  log_a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """C, B (Bb, S, G, N), G dividing H (G == H: per head); v (Bb, S, H,
    P); log_a (Bb, S, H), f32 -> (y (Bb, S, H, P), final state (Bb, H, N,
    P)), both f32. Launches the kernel; raises on a refused launch."""
    check_inputs(C, B, v, log_a)
    C, B, v = (_rows_aligned(t) for t in (C, B, v))
    Bb, S, G, N = C.shape
    H, P = v.shape[2], v.shape[3]
    y = torch.empty((Bb, S, H, P), dtype=torch.float32, device=C.device)
    state = torch.empty((Bb, H, N, P), dtype=torch.float32, device=C.device)
    strides = (ctypes.c_longlong * 12)(*C.stride()[:3], *B.stride()[:3],
                                       *v.stride()[:3], *log_a.stride())
    lib = _lib()
    stream = torch.cuda.current_stream(C.device).cuda_stream
    code = lib.ssd_scan_fwd(C.data_ptr(), B.data_ptr(), v.data_ptr(),
                            log_a.data_ptr(), strides, y.data_ptr(),
                            state.data_ptr(), Bb, S, H, G, N, P, stream)
    build.check(lib, "ssd_scan", code)
    return y, state
