"""Plain PyTorch versions of the port's kernels (the allclose targets).

Port of ``repro.kernels.ref`` for the port's kernels, in the kernels'
public layout (``ssd_scan_ref`` in the reference's (BH, S, .) one), plus ``grouped_gemm_segments_ref``, the plain
version of the grouped GEMM's entry point over rows sorted by expert, and
``prefill_linear_ref``, the plain version of the port's own row-invariant
prefill linear (no reference kernel: the reference leaves it to XLA). Each
is what ``repro_torch.kernels.ops`` runs for a tensor on the CPU, and what
``chip_smoke.py`` holds the CUDA kernel against on the card. Masked scores use the reference's ``-1e30`` sentinel and get a
weight of exactly 0, and the normaliser is ``max(l, 1e-30)``, as in the
kernels: a row with no visible key comes out as zeros.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _masked_softmax_av(s: torch.Tensor, mask: torch.Tensor,
                       v: torch.Tensor, eq: str, lse: bool = False):
    """exp-normalise f32 scores ``s`` over the last axis where ``mask``,
    weights exactly 0 elsewhere, then contract with ``v`` by ``eq``. With
    ``lse`` also the log-sum-exp of the masked scores over that axis, -inf
    where no score is unmasked."""
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum(eq, p / torch.clamp(l, min=1e-30), v)
    if not lse:
        return out
    return out, torch.where(l > 0, m + torch.log(l),
                            torch.full_like(l, -math.inf))[..., 0]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: float = 1.0,
                        kv_len: Optional[torch.Tensor] = None,
                        q_offset: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """q (B, S, H, D); k, v (B, T, Hkv, D); kv_len (B,); q_offset (B,) ->
    (B, S, H, D).

    Full-matrix attention. Query head h reads KV head ``h // (H // Hkv)``;
    keys at or past ``kv_len[b]`` are masked. Query row i of batch row b
    sits at position ``q_offset[b] + i`` (0 + i without it): the tail of a
    prompt whose first ``q_offset[b]`` keys are already in ``k``/``v``."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    s = torch.einsum("bshd,bthd->bhst", q.float(), kf) * scale
    q_pos = torch.arange(S, device=q.device)[None, :, None]        # (1,S,1)
    if q_offset is not None:
        q_pos = q_pos + q_offset.long()[:, None, None]             # (B,S,1)
    k_pos = torch.arange(T, device=q.device)[None, None, :]
    mask = torch.ones((1, S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (q_pos >= k_pos)
    if window:
        mask = mask & ((q_pos - k_pos) < window)
    mask = mask[:, None]
    if kv_len is not None:
        mask = mask & (k_pos[0, 0][None, None, None, :]
                       < kv_len.long()[:, None, None, None])
    out = _masked_softmax_av(s, mask, vf, "bhst,bthd->bshd")
    return out.to(q.dtype)


def flash_decode_ref(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, lengths: torch.Tensor, *,
                     scale: float = 1.0,
                     active: Optional[torch.Tensor] = None,
                     return_lse: bool = False):
    """q (B, H, D); cache (B, Skv, Hkv, D); lengths (B,) -> (B, H, D).

    Keys at or past ``lengths[b]`` are masked; ``active`` (B,) bool forces
    a slot's length to 0, and a slot with length 0 gets zeros. With
    ``return_lse``: (out, the (B, H) f32 log-sum-exp of the scaled scores
    over the slot's valid keys, -inf for a slot with none)."""
    B, H, D = q.shape
    Skv, Hkv = cache_k.shape[1], cache_k.shape[2]
    lengths = lengths.long()
    if active is not None:
        lengths = torch.where(active, lengths, torch.zeros_like(lengths))
    g = H // Hkv
    kf = cache_k.float().repeat_interleave(g, dim=2)
    vf = cache_v.float().repeat_interleave(g, dim=2)
    s = torch.einsum("bhd,bthd->bht", q.float(), kf) * scale
    pos = torch.arange(Skv, device=q.device)
    mask = (pos[None, :] < lengths[:, None])[:, None, :]
    if return_lse:
        out, lse = _masked_softmax_av(s, mask, vf, "bht,bthd->bhd", lse=True)
        return out.to(q.dtype), lse
    out = _masked_softmax_av(s, mask, vf, "bht,bthd->bhd")
    return out.to(q.dtype)


def _gather_pages(pages: torch.Tensor, page_table: torch.Tensor
                  ) -> torch.Tensor:
    """(NP+1, P, ...) + (B, n) -> contiguous (B, n*P, ...)."""
    B, n = page_table.shape
    P = pages.shape[1]
    return pages[page_table.reshape(-1).long()].reshape(
        (B, n * P) + pages.shape[2:])


def paged_decode_ref(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, page_table: torch.Tensor,
                     lengths: torch.Tensor, *,
                     scale: float = 1.0) -> torch.Tensor:
    """q (B, H, D); k/v_pages (NP+1, P, Hkv, D); page_table (B, n);
    lengths (B,) -> (B, H, D). Gather through the table, then
    ``flash_decode_ref``: key t of slot b is ``pages[pt[b, t // P], t % P]``
    and keys at or past ``lengths[b]`` are masked."""
    k = _gather_pages(k_pages, page_table)
    v = _gather_pages(v_pages, page_table)
    return flash_decode_ref(q, k, v, lengths, scale=scale)


def paged_mla_decode_ref(q_lat: torch.Tensor, q_rope: torch.Tensor,
                         ckv_pages: torch.Tensor, krope_pages: torch.Tensor,
                         page_table: torch.Tensor, lengths: torch.Tensor, *,
                         scale: float = 1.0) -> torch.Tensor:
    """Absorbed MLA decode over paged latents: q_lat (B, H, R) (q_nope
    through w_uk), q_rope (B, H, Dr), ckv_pages (NP+1, P, R), krope_pages
    (NP+1, P, Dr), page_table (B, n), lengths (B,) -> the latent-space
    output (B, H, R) in q_lat's dtype. Score ``(q_lat . c_kv + q_rope .
    k_rope) * scale`` in f32; the value is the latent itself. Keys at or
    past ``lengths[b]`` are masked; a slot of length 0 gets zeros."""
    ckv = _gather_pages(ckv_pages, page_table).float()         # (B, T, R)
    kr = _gather_pages(krope_pages, page_table).float()        # (B, T, Dr)
    s = (torch.einsum("bhr,btr->bht", q_lat.float(), ckv)
         + torch.einsum("bhd,btd->bht", q_rope.float(), kr)) * scale
    pos = torch.arange(ckv.shape[1], device=q_lat.device)
    mask = (pos[None, :] < lengths.long()[:, None])[:, None, :]
    out = _masked_softmax_av(s, mask, ckv, "bht,btr->bhr")
    return out.to(q_lat.dtype)


def grouped_gemm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-expert matmul (E, C, d) x (E, d, f) -> (E, C, f), f32
    accumulation, output in x's dtype."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def prefill_linear_ref(x: torch.Tensor, w: torch.Tensor,
                       w_kmajor: bool = False) -> torch.Tensor:
    """x (..., K) x w (K, N), or x w^T for w (N, K) with ``w_kmajor`` ->
    (..., N): ``torch.matmul`` in the inputs' (compute) dtype, what the
    model's projections, MLP and unembedding computed before the prefill
    linear existed, bit for bit."""
    return torch.matmul(x, w.t() if w_kmajor else w)


def grouped_gemm_segments_ref(x: torch.Tensor, counts: torch.Tensor,
                              w: torch.Tensor) -> torch.Tensor:
    """x (N, d) whose rows are grouped by expert, expert e's ``counts[e]``
    rows next after expert e-1's; counts (E,); w (E, d, f) -> (N, f) in
    x's dtype, f32 accumulation. Rows past ``sum(counts)`` belong to no
    expert: zeros here, left unwritten by the kernel. (Reads the counts on
    the host: a comparison target, never the serving path on the card.)"""
    out = torch.zeros((x.shape[0], w.shape[2]), dtype=x.dtype,
                      device=x.device)
    lo = 0
    for e, n in enumerate(counts.tolist()):
        hi = min(lo + int(n), x.shape[0])
        if hi > lo:
            out[lo:hi] = torch.matmul(x[lo:hi].float(), w[e].float()).to(
                x.dtype)
        lo = hi
    return out


def ssd_scan_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 log_a: torch.Tensor):
    """Sequential SSD scan: ``state_t = exp(log_a_t) * state_{t-1} + k_t
    v_t^T`` and ``y_t = q_t . state_t``, one step at a time in f32.

    q, k (BH, S, Dk); v (BH, S, Dv); log_a (BH, S, 1). Returns (y (BH, S,
    Dv) in q's dtype, final state (BH, Dk, Dv) f32)."""
    BH, S, Dk = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    a = torch.exp(log_a.float())
    state = torch.zeros((BH, Dk, v.shape[-1]), dtype=torch.float32,
                        device=q.device)
    ys = []
    for t in range(S):
        state = state * a[:, t, :, None] + \
            kf[:, t, :, None] * vf[:, t, None, :]
        ys.append(torch.einsum("bk,bkv->bv", qf[:, t], state))
    return torch.stack(ys, dim=1).to(q.dtype), state
