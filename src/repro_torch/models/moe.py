"""Mixture-of-experts FFN, single-device semantics.

Port of the no-mesh part of ``repro.models.moe``. The reference's
single-device ``apply_moe`` (no mesh) routes every token through
``_dense_moe``: each of the E experts runs on all T tokens and its output is
weighted by the token's routing weight for it (0 unless chosen), summed in
expert order. No token is ever dropped, whatever the capacity factor: the
capacity-bounded gather (``_local_expert_pass``) belongs to the reference's
sharded path and is not ported.

``apply_moe`` keeps that result on two routes:

* plain (``cfg.use_kernels`` off): ``_dense_moe`` as the reference has it;
* kernels: the T*k (token, expert) assignments are sorted by expert, each
  expert's rows gathered into one contiguous segment, and the expert FFN
  runs as three grouped GEMMs over the segments (gate, up, down;
  ``repro_torch.kernels.ops.grouped_gemm_segments``), so an expert's
  weights are read only where tokens chose it. The outputs are put back in
  (token, choice) order by a permutation and summed per token over its k
  choices in ascending expert order, the order ``_dense_moe`` sums in.
  Nothing is accumulated with atomics: two runs give the same bits.

Routing (``route``) is the reference's: f32 router logits, softmax, k
rounds of argmax (the first index on ties: ``torch.argmax`` promises the
first maximal index as ``jnp.argmax`` does), weights renormalised to sum 1.
Parameters keep the reference's layouts: ``router`` (d, E), experts
``gate``/``up`` (E, d, f) and ``down`` (E, f, d), the shared experts one
MLP of width ``n_shared * shared_d_ff``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import cdt


# ---------------------------------------------------------------- router ---
def _topk_partitioned(probs: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k rounds of (argmax, mask to -1): (weights (T,k), ids (T,k) int64),
    the reference's iterative top-k with its tie rule (first index). The
    weights are gathered from ``probs``, so under autograd the router gets
    their gradient, as in the reference; the masked copy only picks ids and
    stays out of the graph."""
    w, ids = [], []
    remaining = probs.detach().clone()
    rows = torch.arange(probs.shape[0], device=probs.device)
    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1)
        w.append(probs.gather(1, idx[:, None])[:, 0])
        ids.append(idx)
        # scatter_ fills on the device; an indexed assignment of a Python
        # float copies it from the host and syncs, once per round
        remaining.scatter_(1, idx[:, None], -1.0)
    return torch.stack(w, dim=-1), torch.stack(ids, dim=-1)


def route(p, x: torch.Tensor, cfg
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (T, d) -> (top-k ids (T,k) int64, weights (T,k) f32, aux loss).
    The Switch-style load-balance loss is the reference's: training adds
    it to the loss (through ``forward_hidden``), serving ignores it."""
    e = cfg.moe
    logits = torch.matmul(x.float(), p.router.float())
    probs = torch.softmax(logits, dim=-1)
    w, ids = _topk_partitioned(probs, e.experts_per_token)
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    frac_tokens = F.one_hot(ids[:, 0], e.n_experts).float().mean(dim=0)
    frac_probs = probs.mean(dim=0)
    aux = e.n_experts * (frac_tokens * frac_probs).sum() * e.aux_loss_weight
    return ids, w, aux


# ------------------------------------------------------- expert compute ----
def _activate(cfg, up: torch.Tensor,
              gate: Optional[torch.Tensor]) -> torch.Tensor:
    if gate is not None:
        return F.silu(gate) * up
    if cfg.activation == "squared_relu":
        r = F.relu(up)
        return r * r
    return F.gelu(up, approximate="tanh")


def _expert_ffn(experts, xt: torch.Tensor, cfg,
                sl: slice = slice(None)) -> torch.Tensor:
    """xt (E', C, d) -> (E', C, d): batched expert GEMMs in the compute
    dtype over the experts ``sl`` selects."""
    c = cdt(cfg)
    xc = xt.to(c)
    up = torch.matmul(xc, experts.up[sl].to(c))
    gate = (torch.matmul(xc, experts.gate[sl].to(c))
            if experts.gate is not None else None)
    return torch.matmul(_activate(cfg, up, gate), experts.down[sl].to(c))


def _dense_moe(p, x_flat: torch.Tensor, ids: torch.Tensor, w: torch.Tensor,
               cfg) -> torch.Tensor:
    """The reference's no-mesh path: every expert on every token, weighted
    by the token's routing weight for it, summed in expert order."""
    out = torch.zeros_like(x_flat)
    for ei in range(cfg.moe.n_experts):
        w_e = torch.where(ids == ei, w, 0.0).sum(dim=-1)           # (T,)
        y = _expert_ffn(p.experts, x_flat[None], cfg,
                        slice(ei, ei + 1))[0]
        out = out + y * w_e[:, None].to(y.dtype)
    return out


def _sorted_moe(p, x_flat: torch.Tensor, ids: torch.Tensor, w: torch.Tensor,
                cfg) -> torch.Tensor:
    """``_dense_moe``'s sum computed by dispatch: rows sorted by expert,
    three grouped GEMMs over the experts' segments, un-permute, then a sum
    over each token's k choices in ascending expert order. No host sync:
    the segment sizes stay on the device."""
    T, k = ids.shape
    E = cfg.moe.n_experts
    c = cdt(cfg)
    ids, order = ids.sort(dim=1)               # each token's picks by expert
    w = w.gather(1, order)
    flat = ids.reshape(-1)
    perm = torch.argsort(flat, stable=True)    # (T*k,) rows grouped by expert
    # not torch.bincount: on CUDA it reads the ids' max on the host
    counts = torch.zeros(E, dtype=torch.int32, device=flat.device
                         ).scatter_add_(0, flat, torch.ones_like(
                             flat, dtype=torch.int32))
    xs = x_flat.to(c).index_select(0, perm // k)                   # (N, d)
    ex = p.experts
    up = kops.grouped_gemm_segments(xs, counts, ex.up.to(c))
    gate = (kops.grouped_gemm_segments(xs, counts, ex.gate.to(c))
            if ex.gate is not None else None)
    y = kops.grouped_gemm_segments(_activate(cfg, up, gate), counts,
                                   ex.down.to(c))                  # (N, d)
    yk = torch.empty_like(y)
    yk[perm] = y
    yk = yk.reshape(T, k, -1)
    out = torch.zeros_like(x_flat)
    for j in range(k):
        out = out + yk[:, j] * w[:, j, None].to(yk.dtype)
    return out


def _shared(p, x: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(x) if p.shared is None else p.shared(x)


# ------------------------------------------------------------ public api ---
def apply_moe(p, x: torch.Tensor, cfg,
              capacity_factor: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) -> (y (B,S,d), aux loss). ``capacity_factor`` is taken and
    ignored, as by the reference's single-device path: no token drops."""
    del capacity_factor
    B, S, d = x.shape
    x_flat = x.reshape(B * S, d)
    ids, w, aux = route(p, x_flat, cfg)
    moe = _sorted_moe if cfg.use_kernels else _dense_moe
    y = moe(p, x_flat, ids, w, cfg)
    return y.reshape(B, S, d) + _shared(p, x), aux
