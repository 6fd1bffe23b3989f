"""Dispatch of the port's kernels, with launch counts.

Port of ``repro.kernels.ops``. Where the reference chooses between the
Pallas kernel and interpret mode by backend, the port chooses by the
tensor's device: a CUDA tensor launches the hand-written kernel (or
raises: there is no fallback), a CPU tensor runs the plain version in
``repro_torch.kernels.ref``. The model layer calls these entry points when
``cfg.use_kernels`` is set.

``LAUNCHES`` counts kernel launches per entry point: one is added where a
kernel launches and nowhere else, so a run can show that its main path
went through the kernels. The PCM runtime's worker threads launch
concurrently, so the counts change under a lock.

The kernels are forward-only, as the reference's are (none has a custom
VJP). A kernel's output carries no autograd graph, so a backward pass
through it would give the weights upstream zero gradients without a word:
on a CUDA tensor every entry point raises instead when gradients are on
and an input requires them. Training runs the plain path, as the
reference's does. The plain versions a CPU tensor runs stay
differentiable.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import (flash_decode_cuda,
                                                  paged_flash_decode_cuda,
                                                  paged_mla_decode_cuda)
from repro_torch.kernels.dense_gemm import dense_gemm_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.moe_gemm import (grouped_gemm_cuda,
                                          grouped_gemm_segments_cuda)
from repro_torch.kernels.ssm_scan import ssd_scan_cuda

# one key per entry point; grouped_gemm and grouped_gemm_segments launch
# the same kernel (csrc/grouped_gemm.cu), prefill_linear its own
# (csrc/dense_gemm.cu)
LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_decode": 0,
                            "paged_flash_decode": 0, "paged_mla_decode": 0,
                            "grouped_gemm": 0, "grouped_gemm_segments": 0,
                            "ssm_scan": 0, "prefill_linear": 0}


_LAUNCH_LOCK = threading.Lock()


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _launched(name: str) -> None:
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1


def _on_cpu(name: str, x: torch.Tensor, *inputs: Optional[torch.Tensor]
            ) -> bool:
    """True when ``x`` lies on the CPU (the plain version runs); False on
    the card, where the kernel ``name`` will launch: after refusing inputs
    that need a gradient, which the kernel cannot give. Fake tensors are
    refused on every device."""
    if any(isinstance(t, FakeTensor) for t in (x,) + inputs):
        raise RuntimeError(
            f"{name}: a fake tensor (FakeTensorMode, as the dry-run runs a "
            f"cell) has no data for the kernel to read, and a kernel launch "
            f"is not counted; run the plain path (cfg.use_kernels=False)")
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x,) + inputs):
        raise RuntimeError(
            f"{name}: an input requires a gradient, and the CUDA kernel is "
            f"forward-only (it has no backward); run training on the plain "
            f"path (cfg.use_kernels=False) or call it under torch.no_grad()")
    return False


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, scale: float = 1.0,
                    kv_len: Optional[torch.Tensor] = None,
                    q_offset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, S, H, D); k, v (B, T, Hkv, D); kv_len (B,); q_offset (B,) ->
    (B, S, H, D). Query row i of batch row b sits at position
    ``q_offset[b] + i``.

    Rows whose queries see no key (``kv_len[b] == 0``) come out as zeros."""
    if _on_cpu("flash_attention", q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       scale=scale, kv_len=kv_len,
                                       q_offset=q_offset)
    out = flash_attention_cuda(q, k, v, causal=causal, window=window,
                               scale=scale, kv_len=kv_len, q_offset=q_offset)
    _launched("flash_attention")
    return out


def flash_decode(q: torch.Tensor, cache_k: torch.Tensor,
                 cache_v: torch.Tensor, lengths: torch.Tensor, *,
                 scale: float = 1.0, active: Optional[torch.Tensor] = None,
                 return_lse: bool = False):
    """q (B, H, D); cache (B, Skv, Hkv, D); lengths (B,) -> (B, H, D);
    with ``return_lse``, (out, the (B, H) f32 log-sum-exp of the scaled
    scores over each slot's valid keys, -inf for a slot with none), which
    the kernel gives too: the plain version never stands in for it."""
    if _on_cpu("flash_decode", q, cache_k, cache_v):
        return ref.flash_decode_ref(q, cache_k, cache_v, lengths, scale=scale,
                                    active=active, return_lse=return_lse)
    out = flash_decode_cuda(q, cache_k, cache_v, lengths, scale=scale,
                            active=active, return_lse=return_lse)
    _launched("flash_decode")
    return out


def paged_flash_decode(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_table: torch.Tensor,
                       lengths: torch.Tensor, *,
                       scale: float = 1.0) -> torch.Tensor:
    """q (B, H, D); k/v_pages (NP+1, P, Hkv, D); page_table (B, n);
    lengths (B,) -> (B, H, D). A slot of length 0 gets zeros."""
    if _on_cpu("paged_flash_decode", q, k_pages, v_pages):
        return ref.paged_decode_ref(q, k_pages, v_pages, page_table, lengths,
                                    scale=scale)
    out = paged_flash_decode_cuda(q, k_pages, v_pages, page_table, lengths,
                                  scale=scale)
    _launched("paged_flash_decode")
    return out


def paged_mla_decode(q_lat: torch.Tensor, q_rope: torch.Tensor,
                     ckv_pages: torch.Tensor, krope_pages: torch.Tensor,
                     page_table: torch.Tensor, lengths: torch.Tensor, *,
                     scale: float = 1.0) -> torch.Tensor:
    """Absorbed-matrix MLA decode over paged latents: q_lat (B, H, R),
    q_rope (B, H, Dr), ckv_pages (NP+1, P, R), krope_pages (NP+1, P, Dr),
    page_table (B, n), lengths (B,) -> latent output (B, H, R). A slot of
    length 0 gets zeros."""
    if _on_cpu("paged_mla_decode", q_lat, q_rope, ckv_pages, krope_pages):
        return ref.paged_mla_decode_ref(q_lat, q_rope, ckv_pages,
                                        krope_pages, page_table, lengths,
                                        scale=scale)
    out = paged_mla_decode_cuda(q_lat, q_rope, ckv_pages, krope_pages,
                                page_table, lengths, scale=scale)
    _launched("paged_mla_decode")
    return out


def grouped_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, C, d); w (E, d, f) -> (E, C, f), f32 accumulation, in x's
    dtype (the reference's contract)."""
    if _on_cpu("grouped_gemm", x, w):
        return ref.grouped_gemm_ref(x, w)
    out = grouped_gemm_cuda(x, w)
    _launched("grouped_gemm")
    return out


def grouped_gemm_segments(x: torch.Tensor, counts: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    """x (N, d) whose rows are grouped by expert (``counts[e]`` rows of
    expert e after expert e-1's), counts (E,) int32 on x's device, w
    (E, d, f) -> (N, f) in x's dtype. The MoE dispatch's entry point: the
    counts are never read on the host."""
    if _on_cpu("grouped_gemm_segments", x, w):
        return ref.grouped_gemm_segments_ref(x, counts, w)
    out = grouped_gemm_segments_cuda(x, counts, w)
    _launched("grouped_gemm_segments")
    return out


def prefill_linear(x: torch.Tensor, w: torch.Tensor, *,
                   w_kmajor: bool = False) -> torch.Tensor:
    """x (..., K) x w (K, N), or x w^T for w (N, K) with ``w_kmajor`` (the
    tied unembedding's ``tok``) -> (..., N) in x's dtype: the prefill's
    linears (``models.layers.linear`` inside ``row_invariant_linears``).
    The kernel sums each output over K in a plan fixed by (K, N) alone
    (``kernels.dense_gemm.dense_gemm_plan``), so a row's bits depend on
    that row and w alone, never on how many rows the call has: a
    shared-prefix tail wave gives the bits of a cold wave. x need not be
    contiguous (a non-contiguous x is copied first)."""
    if _on_cpu("prefill_linear", x, w):
        return ref.prefill_linear_ref(x, w, w_kmajor)
    out = dense_gemm_cuda(x.contiguous(), w, w_kmajor)
    _launched("prefill_linear")
    return out


def ssm_scan(C_mat: torch.Tensor, B_mat: torch.Tensor, v: torch.Tensor,
             log_a: torch.Tensor, *, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2/SSD entry point, the reference's contract: C_mat (q-like)
    and B_mat (k-like) (B, S, H, N); v (B, S, H, P); log_a (B, S, H) ->
    (y (B, S, H, P) f32, final state (B, H, N, P) f32). C_mat and B_mat may
    also come once per group, (B, S, G, N) with H % G == 0: head h reads
    group ``h // (H // G)`` (the reference's ``jnp.repeat``), and the kernel
    reads each group's B and C in place of H / G copies. ``chunk`` is the
    reference's chunk length; the kernel picks its own tile length, and the
    plain version scans step by step, so neither reads it."""
    C_mat, B_mat, v, log_a = (t.float() for t in (C_mat, B_mat, v, log_a))
    if _on_cpu("ssm_scan", C_mat, B_mat, v, log_a):
        Bb, S, H, P = v.shape
        N = C_mat.shape[-1]
        rep = H // C_mat.shape[2]

        def bhs(t):
            return t.transpose(1, 2).reshape(Bb * H, S, t.shape[-1])
        C_mat, B_mat = (t.repeat_interleave(rep, dim=2)
                        for t in (C_mat, B_mat))
        y, state = ref.ssd_scan_ref(bhs(C_mat), bhs(B_mat), bhs(v),
                                    bhs(log_a[..., None]))
        return (y.reshape(Bb, H, S, P).transpose(1, 2),
                state.reshape(Bb, H, N, P))
    out = ssd_scan_cuda(C_mat, B_mat, v, log_a)
    _launched("ssm_scan")
    return out


__all__ = ["flash_attention", "flash_decode", "paged_flash_decode",
           "paged_mla_decode", "grouped_gemm", "grouped_gemm_segments",
           "ssm_scan", "prefill_linear", "LAUNCHES", "reset_launches", "ref"]
