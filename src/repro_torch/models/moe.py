"""Mixture-of-experts FFN: the single-device path and the
expert-parallel path under a mesh.

Port of ``repro.models.moe``. With no mesh, or no ``experts`` rule, the
reference's ``apply_moe`` routes every token through ``_dense_moe``: each
of the E experts runs on all T tokens and its output is weighted by the
token's routing weight for it (0 unless chosen), summed in expert order.
No token is ever dropped, whatever the capacity factor.

Under a mesh with an ``experts`` rule (``models.sharding``) it takes the
reference's expert-parallel path (``_expert_parallel``), which computes
something else: tokens sharded on the batch axes and replicated on the
expert axes, the router replicated, the experts sharded on the expert
axes (the reference's ``shard_map``, here two ``sharding.local``
regions). Each rank routes its tokens with ``torch.topk`` (the
reference's ``lax.top_k`` here, not the iterative top-k); the aux loss
takes global means over the batch axes (DTensor means of the routing's
outputs); and ``_local_expert_pass`` runs the rank's ``n_local`` experts:
each expert takes at most ``_capacity`` of its tokens, in token order,
and the rest of its (token, expert) assignments are dropped
(``capacity_slots``). The outputs are weighted and combined in the
activation dtype; each rank's is its share of a sum over the expert axes
(``Partial``), which DTensor reduces where the output is next placed (the
reference's ``psum``), and whose backward hands each rank the whole
cotangent. With ``cfg.use_kernels`` the expert FFN runs on
``ops.grouped_gemm`` over the (E_loc, C, d) capacity buffers; without, on
batched matmuls. Under the rule the path never falls back to the dense
one.

With no mesh ``apply_moe`` keeps ``_dense_moe``'s result on two routes:

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

import math
from types import SimpleNamespace
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models import sharding
from repro_torch.models.layers import cdt
from repro_torch.models.sharding import shard


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
    logits = shard(torch.matmul(x.float(), p.router.float()), "batch", None)
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


def _expert_ffn(experts, xt: torch.Tensor, cfg, sl: slice = slice(None),
                use_kernels: bool = False) -> torch.Tensor:
    """xt (E', C, d) -> (E', C, d): batched expert GEMMs in the compute
    dtype over the experts ``sl`` selects (``experts`` has ``up``,
    ``gate`` (or None) and ``down``); with ``use_kernels`` the three
    GEMMs are ``ops.grouped_gemm``'s (E, C, d) x (E, d, f) form."""
    c = cdt(cfg)
    xc = xt.to(c)
    mm = kops.grouped_gemm if use_kernels else torch.matmul
    up = mm(xc, experts.up[sl].to(c))
    gate = (mm(xc, experts.gate[sl].to(c))
            if experts.gate is not None else None)
    return mm(_activate(cfg, up, gate), experts.down[sl].to(c))


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


# ------------------------------------------------ expert-parallel path ----
def _capacity(tokens: int, cfg, cf: Optional[float] = None) -> int:
    """Per-expert slots of one shard's pass: ceil(tokens * k * cf / E),
    at least 4 (the reference's)."""
    e = cfg.moe
    cf = cf if cf is not None else e.capacity_factor
    return max(4, int(math.ceil(tokens * e.experts_per_token * cf
                                / e.n_experts)))


def capacity_slots(ids: torch.Tensor, w: torch.Tensor, n_local: int,
                   shard_idx: int, capacity: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's slot tables for one expert shard (experts
    ``shard_idx * n_local`` on): ids, w (T, k) -> (token of each slot
    (n_local * C,) int64, its weight f32, dropped (T, n_local) bool).
    Expert e's tokens fill its C slots in token order; a (token, expert)
    assignment past them is dropped (``dropped``). Empty slots hold token
    0 at weight 0. Writes go through an overflow row past the table, as
    the reference's, and it is cut off."""
    T = ids.shape[0]
    local = ids - shard_idx * n_local
    in_range = (local >= 0) & (local < n_local)
    onehot = (F.one_hot(local.clamp(0, n_local - 1), n_local).float()
              * in_range[..., None])                            # (T,k,E_loc)
    w_te = torch.einsum("tke,tk->te", onehot, w.float())
    mask_te = onehot.sum(dim=1) > 0                             # (T,E_loc)
    pos = torch.cumsum(mask_te.int(), dim=0) - 1
    valid = mask_te & (pos < capacity)
    rows = torch.arange(n_local, device=ids.device)[None, :] * capacity
    slot = torch.where(valid, rows + pos, n_local * capacity).reshape(-1)
    t_idx = torch.arange(T, device=ids.device)[:, None].expand(T, n_local)
    tok = torch.zeros(n_local * capacity + 1, dtype=torch.int64,
                      device=ids.device).scatter_(
        0, slot, torch.where(valid, t_idx, 0).reshape(-1))
    wgt = torch.zeros(n_local * capacity + 1, dtype=torch.float32,
                      device=ids.device).scatter_(
        0, slot, torch.where(valid, w_te, 0.0).reshape(-1))
    return tok[:-1], wgt[:-1], mask_te & ~valid


def _local_expert_pass(x_flat: torch.Tensor, ids: torch.Tensor,
                       w: torch.Tensor, experts, cfg, n_local: int,
                       shard_idx: int, capacity: int,
                       use_kernels: Optional[bool] = None) -> torch.Tensor:
    """Capacity gather, the expert GEMMs and the weighted scatter-add for
    one expert shard: x_flat (T, d), ids/w (T, k), ``experts`` holding
    ``n_local`` experts' weights -> (T, d) in x's dtype, this shard's
    share of the sum. ``use_kernels`` (default ``cfg.use_kernels``)
    runs the GEMMs on ``ops.grouped_gemm``."""
    use_kernels = cfg.use_kernels if use_kernels is None else use_kernels
    d = x_flat.shape[1]
    tok, wgt, _ = capacity_slots(ids, w, n_local, shard_idx, capacity)
    xt = x_flat.index_select(0, tok).reshape(n_local, capacity, d)
    y = _expert_ffn(experts, xt, cfg, use_kernels=use_kernels)
    # combine in the activation dtype, as the reference does: an f32
    # combine would double the bytes of the sum over the expert axes
    y = y * wgt.reshape(n_local, capacity, 1).to(y.dtype)
    out = torch.zeros(x_flat.shape, dtype=y.dtype, device=y.device
                      ).index_add_(0, tok, y.reshape(n_local * capacity, d))
    return out.to(x_flat.dtype)


def ep_route(xf: torch.Tensor, router: torch.Tensor, cfg
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The expert-parallel path's routing of one rank's tokens xf (T, d):
    (ids (T, k) by ``torch.topk``, weights (T, k) renormalised, probs
    (T, E)), in f32."""
    probs = torch.softmax(torch.matmul(xf.float(), router.float()), dim=-1)
    w, ids = torch.topk(probs, cfg.moe.experts_per_token, dim=-1)
    return ids, w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9), probs


def _expert_parallel(p, x: torch.Tensor, cfg,
                     capacity_factor: Optional[float]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``shard_map`` region: x (B, S, d) under a mesh with
    an ``experts`` rule -> (y (B, S, d) without the shared experts, aux).
    Two ``sharding.local`` regions: the routing of each rank's tokens
    (every rank of an expert axis routes the same ones), then the
    capacity pass over the rank's experts, whose output is the rank's
    share of a sum over the expert axes (``Partial``); the aux loss's
    global means and that sum are DTensor reductions, so their backward
    passes are DTensor's."""
    e = cfg.moe
    B, S, d = x.shape
    n_local = e.n_experts // sharding.axis_size("experts")
    cap = _capacity((B // sharding.axis_size("batch")) * S, cfg,
                    capacity_factor)

    def routing(xf, router):
        ids, w, probs = ep_route(xf, router, cfg)
        return ids, w, probs, F.one_hot(ids[:, 0], e.n_experts).float()

    def experts_pass(xf, ids, w, up, down, gate):
        experts = SimpleNamespace(up=up, down=down, gate=gate)
        return _local_expert_pass(xf, ids, w, experts, cfg, n_local,
                                  sharding.axis_index("experts"), cap)

    tok, ew = ("batch", None), ("experts", None, None)
    xf = x.reshape(B * S, d)
    ids, w, probs, first = sharding.local(
        routing, (tok, (None, None)), (tok,) * 4)(xf, p.router)
    # load-balance aux from global means over the batch axes
    aux = (e.n_experts * (first.mean(dim=0) * probs.mean(dim=0)).sum()
           * e.aux_loss_weight)
    ex = p.experts
    y = sharding.local(experts_pass, (tok, tok, tok, ew, ew, ew), (tok,),
                       summed="experts")(xf, ids, w, ex.up, ex.down, ex.gate)
    return shard(y.reshape(B, S, d), "batch", "seq", None), aux


def _shared(p, x: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(x) if p.shared is None else p.shared(x)


# ------------------------------------------------------------ public api ---
def apply_moe(p, x: torch.Tensor, cfg,
              capacity_factor: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) -> (y (B,S,d), aux loss). ``capacity_factor`` (default
    the config's) sizes the expert-parallel path's capacity; the
    single-device path ignores it, as the reference's does: no token
    drops there."""
    if sharding.active() and "experts" in sharding.current_rules():
        y, aux = _expert_parallel(p, x, cfg, capacity_factor)
        return y + _shared(p, x), aux
    B, S, d = x.shape
    x_flat = x.reshape(B * S, d)
    ids, w, aux = route(p, x_flat, cfg)
    moe = _sorted_moe if cfg.use_kernels else _dense_moe
    y = moe(p, x_flat, ids, w, cfg)
    return y.reshape(B, S, d) + _shared(p, x), aux
