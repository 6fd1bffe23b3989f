"""Recurrent blocks: Mamba2 (SSD), mLSTM and sLSTM (xLSTM).

Port of ``repro.models.ssm``. Mamba2 is a gated outer-product recurrence
``state_t = a_t * state_{t-1} + k_t v_t^T`` with a per-(step, head) scalar
decay ``a = exp(-exp(A_log) * dt)``, ``k = B`` (group-broadcast), ``q =
C`` and ``v = dt * x`` (ZOH discretization), plus the D skip and a gated
RMSNorm. Prefill runs the chunked form (``chunked_linear_attention``), or
with ``cfg.use_kernels`` the SSD scan kernel behind ``ops.ssm_scan``,
which takes B and C once per group;
decode is one ``linear_attention_step``.

Parameters live on a ``Mamba2`` module in the reference's layouts (the
projections split by role: ``w_zx`` (d, 2 d_in), ``w_bcdt`` (d, 2 G N +
H), depthwise conv weights (K, C) and biases, ``A_log``, ``D`` and
``dt_bias`` (H,) in f32 whatever the param dtype, the gated norm's scale
(d_in,), ``out_proj`` (d_in, d)). The per-slot cache of one layer is
``{"ssm": (B, H, N, P) f32, "conv_x": (B, K-1, d_in), "conv_bc": (B, K-1,
2 G N)}``; rounding follows the reference step by step.

mLSTM runs the same chunked core as Mamba2's plain path, as in the
reference (whose ``mlstm_prefill`` calls ``chunked_linear_attention``
directly, never the SSD scan kernel): ``a = sigmoid(f_pre)``, k scaled by
the input gate, q by 1/sqrt(hd), and the normaliser carried by a ones
channel appended to v (Dv = hd + 1). Its state is (B, H, hd, hd + 1) f32.
sLSTM has a true hidden-to-gate recurrence, so its prefill is a loop over
time (``slstm_forward``), one step per position, as the reference's
``lax.scan`` is; its state is ``{"h": (B, d) in the cache dtype, "c",
"n": (B, d) f32}``. The ``MLSTM`` and ``SLSTM`` modules hold the
reference's ``init_mlstm``/``init_slstm`` leaves under the same names,
``gate_bias`` and the sLSTM's ``bias`` in f32 whatever the param dtype.

Under a mesh (``models.sharding``) the Mamba2 prefill keeps the
reference's ``shard`` sites, x (batch, seq, heads, -) and the output
(batch, seq, -), and runs its scan (the SSD kernel, or the plain chunked
core) in ``sharding.local`` over the rank's heads: v and log_a come in
sharded on heads, B and C with every group, and each rank takes the
groups its heads read (``attention._local_heads``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.models import sharding
from repro_torch.models.attention import _local_heads
from repro_torch.models.layers import cdt, pdt
from repro_torch.models.sharding import shard
from repro_torch.models.transformer import Norm, _param

Cache = Dict[str, torch.Tensor]

# ---------------------------------------------------------------- core -----
def chunked_linear_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, log_a: torch.Tensor,
                             chunk: int,
                             initial_state: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k (B, S, H, Dk); v (B, S, H, Dv); log_a (B, S, H) per-step
    log-decay. Returns (y (B, S, H, Dv) in q's dtype, final state (B, H,
    Dk, Dv) f32). Within a chunk of L = min(chunk, S) steps a masked-decay
    product; between chunks a loop carries the state."""
    B, S, H, Dk = q.shape
    Dv = v.shape[-1]
    L = min(chunk, S)
    assert S % L == 0, f"seq {S} not divisible by chunk {L}"
    nc = S // L

    qc = q.reshape(B, nc, L, H, Dk).float()
    kc = k.reshape(B, nc, L, H, Dk).float()
    vc = v.reshape(B, nc, L, H, Dv).float()
    lcum = torch.cumsum(log_a.reshape(B, nc, L, H).float(), dim=2)
    total = lcum[:, :, -1]                                   # (B, nc, H)

    # intra-chunk: score[s, t] = (q_s . k_t) * exp(lcum_s - lcum_t), t <= s
    rel = lcum[:, :, :, None, :] - lcum[:, :, None, :, :]    # (B,nc,S,T,H)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=q.device))
    decay = torch.where(causal[None, None, :, :, None], torch.exp(rel),
                        torch.zeros((), device=q.device))
    scores = torch.einsum("bnshk,bnthk->bnsth", qc, kc)
    y_intra = torch.einsum("bnsth,bnthv->bnshv", scores * decay, vc)

    # chunk summaries and the inter-chunk recurrence
    w_in = torch.exp(total[:, :, None, :] - lcum)            # (B, nc, L, H)
    s_chunk = torch.einsum("bnthk,bnth,bnthv->bnhkv", kc, w_in, vc)
    state = (torch.zeros((B, H, Dk, Dv), dtype=torch.float32,
                         device=q.device) if initial_state is None
             else initial_state.float())
    prev = []
    for n in range(nc):
        prev.append(state)                                   # before chunk n
        state = state * torch.exp(total[:, n])[:, :, None, None] + \
            s_chunk[:, n]
    prev_states = torch.stack(prev, dim=1)                   # (B,nc,H,Dk,Dv)

    y_inter = torch.einsum("bnshk,bnsh,bnhkv->bnshv", qc, torch.exp(lcum),
                           prev_states)
    y = (y_intra + y_inter).reshape(B, S, H, Dv)
    return y.to(q.dtype), state


def linear_attention_step(state: torch.Tensor, q: torch.Tensor,
                          k: torch.Tensor, v: torch.Tensor, a: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step. state (B, H, Dk, Dv); q, k (B, H, Dk); v (B, H, Dv);
    a (B, H). Returns (y (B, H, Dv), new state), in the state's dtype."""
    dt = state.dtype
    state = state * a[:, :, None, None].to(dt) + \
        k.to(dt)[..., :, None] * v.to(dt)[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", q.to(dt), state)
    return y, state


# ================================================================= Mamba2 ==
def mamba2_dims(cfg) -> Tuple[int, int, int]:
    """(d_in, SSM heads, conv channels)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    conv_ch = d_in + 2 * s.n_groups * s.state_dim
    return d_in, n_heads, conv_ch


class Mamba2(nn.Module):
    """One Mamba2 mixer's weights in the reference's ``init_mamba2``
    shapes (the values come from ``repro_torch.weights``)."""

    def __init__(self, cfg, device):
        super().__init__()
        s, d, dt = cfg.ssm, cfg.d_model, pdt(cfg)
        d_in, n_heads, _ = mamba2_dims(cfg)
        bc = 2 * s.n_groups * s.state_dim
        self.w_zx = _param(d, 2 * d_in, dtype=dt, device=device)
        self.w_bcdt = _param(d, bc + n_heads, dtype=dt, device=device)
        self.conv_x_w = _param(s.conv_dim, d_in, dtype=dt, device=device)
        self.conv_x_b = _param(d_in, dtype=dt, device=device)
        self.conv_bc_w = _param(s.conv_dim, bc, dtype=dt, device=device)
        self.conv_bc_b = _param(bc, dtype=dt, device=device)
        f32 = torch.float32
        self.A_log = _param(n_heads, dtype=f32, device=device)
        self.D = _param(n_heads, dtype=f32, device=device)
        self.dt_bias = _param(n_heads, dtype=f32, device=device)
        self.norm = Norm(cfg, device, d_in)
        self.out_proj = _param(d_in, d, dtype=dt, device=device)


def _mamba2_split(p: Mamba2, u: torch.Tensor, cfg):
    """u (B, S, d) -> z, x, bc (pre-conv), dt (pre-softplus)."""
    s, c = cfg.ssm, cdt(cfg)
    d_in = mamba2_dims(cfg)[0]
    bc = 2 * s.n_groups * s.state_dim
    zx = torch.matmul(u.to(c), p.w_zx.to(c))
    bcdt = torch.matmul(u.to(c), p.w_bcdt.to(c))
    return zx[..., :d_in], zx[..., d_in:], bcdt[..., :bc], bcdt[..., bc:]


def _ragged_conv_state(x_raw: torch.Tensor, K: int,
                       valid: torch.Tensor) -> torch.Tensor:
    """Conv state = the last K-1 *valid* inputs of each ragged row:
    x_raw (B, S, C), valid (B, S) bool -> (B, K-1, C)."""
    lengths = valid.to(torch.int64).sum(dim=1)                  # (B,)
    ext = torch.cat([torch.zeros((x_raw.shape[0], K - 1, x_raw.shape[2]),
                                 dtype=x_raw.dtype, device=x_raw.device),
                     x_raw], dim=1)
    idx = lengths[:, None] + torch.arange(K - 1, device=x_raw.device)
    return torch.gather(ext, 1, idx[:, :, None].expand(-1, -1,
                                                       x_raw.shape[2]))


def _mamba2_core_inputs(p: Mamba2, xBC: torch.Tensor, dt: torch.Tensor,
                        cfg, valid: Optional[torch.Tensor] = None):
    """Post-conv split into the SSD core's operands: x (B, S, H, P), B and
    C once per group (B, S, G, N) (heads [g*rep, (g+1)*rep) read group g:
    ``_per_head`` broadcasts them), v = x * dt (f32) and log_a (B, S, H)
    f32. ``valid`` (B, S) bool makes padding steps exact state no-ops (dt
    -> 0: decay 1, zero input)."""
    s = cfg.ssm
    d_in, n_heads, _ = mamba2_dims(cfg)
    B_sz, S = xBC.shape[0], xBC.shape[1]
    gn = s.n_groups * s.state_dim
    x = xBC[..., :d_in].reshape(B_sz, S, n_heads, s.head_dim)
    Bm = xBC[..., d_in:d_in + gn].reshape(B_sz, S, s.n_groups, s.state_dim)
    Cm = xBC[..., d_in + gn:].reshape(B_sz, S, s.n_groups, s.state_dim)
    dt = F.softplus(dt.float() + p.dt_bias[None, None, :])
    if valid is not None:
        dt = dt * valid[:, :, None].to(dt.dtype)
    log_a = -torch.exp(p.A_log)[None, None, :] * dt
    v = x.float() * dt[..., None]
    return x, Bm, Cm, v, log_a


def _per_head(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, G, N) group operands -> (B, S, H, N): head h reads group
    ``h // (H // G)``."""
    return t.repeat_interleave(n_heads // t.shape[2], dim=2)


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv as the reference's K shifted multiply-adds.
    xBC (B, S, C); w (K, C); state (B, K-1, C) or None. Returns (y (B, S,
    C), new state (B, K-1, C)); a state of another dtype promotes, as
    ``jnp.concatenate`` does."""
    K, S = w.shape[0], xBC.shape[1]
    if state is None:
        state = torch.zeros((xBC.shape[0], K - 1, xBC.shape[2]),
                            dtype=xBC.dtype, device=xBC.device)
    dt = torch.promote_types(state.dtype, xBC.dtype)
    ext = torch.cat([state.to(dt), xBC.to(dt)], dim=1)
    y = sum(ext[:, i:i + S] * w[i][None, None, :] for i in range(K))
    y = F.silu(y + b[None, None, :])
    new_state = ext[:, -(K - 1):] if K > 1 else state
    return y, new_state


def _gated_norm(p: Mamba2, y: torch.Tensor, z: torch.Tensor,
                cfg) -> torch.Tensor:
    """Mamba2's gated RMSNorm: norm(y * silu(z))."""
    g = y.float() * F.silu(z.float())
    return p.norm(g.to(y.dtype))


def _finish(p: Mamba2, y: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
            u: torch.Tensor, cfg) -> torch.Tensor:
    """D skip, gated norm and the out projection: y (B, S, H, P)."""
    y = y + x.float() * p.D[None, None, :, None]
    y = y.reshape(u.shape[0], u.shape[1], -1)
    y = _gated_norm(p, y, z, cfg)
    c = cdt(cfg)
    return torch.matmul(y.to(c), p.out_proj.to(c))


def mamba2_prefill(p: Mamba2, u: torch.Tensor, cfg,
                   return_state: bool = False,
                   valid: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """u (B, S, d) -> (out (B, S, d), the layer's cache or None). With
    ``valid`` (B, S) the conv state holds each row's last K-1 valid inputs
    and padding steps leave the SSM state as their row's last valid step
    left it."""
    K = p.conv_x_w.shape[0]
    z, x_raw, bc_raw, dt = _mamba2_split(p, u, cfg)
    x_c, conv_x_state = _causal_conv(x_raw, p.conv_x_w.to(x_raw.dtype),
                                     p.conv_x_b.to(x_raw.dtype))
    bc_c, conv_bc_state = _causal_conv(bc_raw, p.conv_bc_w.to(bc_raw.dtype),
                                       p.conv_bc_b.to(bc_raw.dtype))
    if valid is not None:
        conv_x_state = _ragged_conv_state(x_raw, K, valid)
        conv_bc_state = _ragged_conv_state(bc_raw, K, valid)
    xBC = torch.cat([x_c, bc_c], dim=-1)
    x, Bm, Cm, v, log_a = _mamba2_core_inputs(p, xBC, dt, cfg,
                                                 valid=valid)
    x = shard(x, "batch", "seq", "heads", None)
    n_heads = mamba2_dims(cfg)[1]

    def scan(Cm, Bm, v, log_a):
        H = v.shape[2]                         # this rank's heads
        Cm, Bm = (_local_heads(t, H, n_heads) for t in (Cm, Bm))
        if cfg.use_kernels:  # the kernel reads B and C once per group
            return kops.ssm_scan(Cm, Bm, v, log_a, chunk=cfg.ssm.chunk)
        return chunked_linear_attention(_per_head(Cm, H), _per_head(Bm, H),
                                        v, log_a, cfg.ssm.chunk)
    grp, hd = ("batch", "seq", None, None), ("batch", "seq", "heads", None)
    y, state = sharding.local(
        scan, (grp, grp, hd, ("batch", "seq", "heads")),
        (hd, ("batch", "heads", None, None)))(Cm, Bm, v, log_a)
    out = shard(_finish(p, y, x, z, u, cfg), "batch", "seq", None)
    cache = ({"ssm": state, "conv_x": conv_x_state,
              "conv_bc": conv_bc_state} if return_state else None)
    return out, cache


def mamba2_decode(p: Mamba2, u: torch.Tensor, cfg,
                  cache: Cache) -> Tuple[torch.Tensor, Cache]:
    """u (B, 1, d); cache {"ssm", "conv_x", "conv_bc"} -> (out (B, 1, d),
    the new cache)."""
    z, x_raw, bc_raw, dt = _mamba2_split(p, u, cfg)
    x_c, conv_x_state = _causal_conv(x_raw, p.conv_x_w.to(x_raw.dtype),
                                     p.conv_x_b.to(x_raw.dtype),
                                     state=cache["conv_x"])
    bc_c, conv_bc_state = _causal_conv(bc_raw, p.conv_bc_w.to(bc_raw.dtype),
                                       p.conv_bc_b.to(bc_raw.dtype),
                                       state=cache["conv_bc"])
    xBC = torch.cat([x_c, bc_c], dim=-1)
    x, Bm, Cm, v, log_a = _mamba2_core_inputs(p, xBC, dt, cfg)
    H = v.shape[2]
    y, state = linear_attention_step(cache["ssm"], _per_head(Cm, H)[:, 0],
                                     _per_head(Bm, H)[:, 0], v[:, 0],
                                     torch.exp(log_a[:, 0]))
    out = _finish(p, y[:, None], x, z, u, cfg)
    return out, {"ssm": state, "conv_x": conv_x_state,
                 "conv_bc": conv_bc_state}


def mamba2_init_cache(cfg, batch: int, dtype: torch.dtype,
                      device) -> Cache:
    """One layer's zeroed cache: the SSM state in f32, the conv states in
    ``dtype``."""
    s = cfg.ssm
    d_in, n_heads, _ = mamba2_dims(cfg)
    bc = 2 * s.n_groups * s.state_dim
    return {
        "ssm": torch.zeros((batch, n_heads, s.state_dim, s.head_dim),
                           dtype=torch.float32, device=device),
        "conv_x": torch.zeros((batch, s.conv_dim - 1, d_in), dtype=dtype,
                              device=device),
        "conv_bc": torch.zeros((batch, s.conv_dim - 1, bc), dtype=dtype,
                               device=device),
    }


# ================================================================== mLSTM ==
def mlstm_dims(cfg) -> Tuple[int, int]:
    """(d_in, head_dim) of the mLSTM's up-projected inner width."""
    d_in = int(cfg.d_model * cfg.ssm.mlstm_proj_factor)
    return d_in, d_in // cfg.n_heads


class MLSTM(nn.Module):
    """One mLSTM's weights in ``init_mlstm``'s shapes: ``up`` (d, 2 d_in)
    ([x | z]), ``wq``/``wk``/``wv`` (d_in, d_in), ``w_gates`` (d_in, 2 H)
    ([i | f]), ``gate_bias`` (2 H,) f32, the gated norm over d_in and
    ``down`` (d_in, d)."""

    def __init__(self, cfg, device):
        super().__init__()
        d, H, dt = cfg.d_model, cfg.n_heads, pdt(cfg)
        d_in, _ = mlstm_dims(cfg)
        self.up = _param(d, 2 * d_in, dtype=dt, device=device)
        self.wq = _param(d_in, d_in, dtype=dt, device=device)
        self.wk = _param(d_in, d_in, dtype=dt, device=device)
        self.wv = _param(d_in, d_in, dtype=dt, device=device)
        self.w_gates = _param(d_in, 2 * H, dtype=dt, device=device)
        self.gate_bias = _param(2 * H, dtype=torch.float32, device=device)
        self.norm = Norm(cfg, device, d_in)
        self.down = _param(d_in, d, dtype=dt, device=device)


def _mlstm_qkvg(p: MLSTM, u: torch.Tensor, cfg):
    """u (B, S, d) -> q (scaled by 1/sqrt(hd)), k (scaled by the input
    gate), v (B, S, H, hd), the forget gate f (B, S, H) f32 and z."""
    c = cdt(cfg)
    d_in, hd = mlstm_dims(cfg)
    B, S = u.shape[0], u.shape[1]
    H = cfg.n_heads
    xz = torch.matmul(u.to(c), p.up.to(c))
    xin, z = xz[..., :d_in], xz[..., d_in:]
    q = torch.matmul(xin, p.wq.to(c)).reshape(B, S, H, hd) / math.sqrt(hd)
    k = torch.matmul(xin, p.wk.to(c)).reshape(B, S, H, hd)
    v = torch.matmul(xin, p.wv.to(c)).reshape(B, S, H, hd)
    gates = torch.matmul(xin, p.w_gates.to(c)).float() + \
        p.gate_bias[None, None, :]
    i_gate = torch.sigmoid(gates[..., :H])     # bounded input gate
    f_gate = torch.sigmoid(gates[..., H:])
    return q, k * i_gate[..., None].to(k.dtype), v, f_gate, z


def _mlstm_finish(p: MLSTM, num: torch.Tensor, den: torch.Tensor,
                  z: torch.Tensor, u: torch.Tensor, cfg) -> torch.Tensor:
    """num / max(|den|, 1), the gated norm and the down projection."""
    d_in, _ = mlstm_dims(cfg)
    h = num / torch.clamp(den.abs(), min=1.0)
    h = _gated_norm(p, h.reshape(u.shape[0], u.shape[1], d_in), z, cfg)
    c = cdt(cfg)
    return torch.matmul(h.to(c), p.down.to(c))


def _ones_channel(v: torch.Tensor) -> torch.Tensor:
    """v (..., hd) -> (..., hd + 1): the denominator's constant channel."""
    return torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)


def mlstm_prefill(p: MLSTM, u: torch.Tensor, cfg,
                  return_state: bool = False,
                  valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """u (B, S, d) -> (out (B, S, d), {"state": (B, H, hd, hd + 1) f32} or
    None). With ``valid`` (B, S) a padding step adds nothing (k zeroed)
    and decays nothing (f held at 1), so the state is the one at the
    row's last valid step. S must be a multiple of ``min(chunk, S)``."""
    q, k, v, f, z = _mlstm_qkvg(p, u, cfg)
    if valid is not None:
        k = k * valid[:, :, None, None].to(k.dtype)
        f = torch.where(valid[:, :, None], f, torch.ones_like(f))
    y, state = chunked_linear_attention(q, k, _ones_channel(v),
                                        torch.log(f + 1e-9), cfg.ssm.chunk)
    out = _mlstm_finish(p, y[..., :-1].float(), y[..., -1:].float(), z, u,
                        cfg)
    return out, ({"state": state} if return_state else None)


def mlstm_decode(p: MLSTM, u: torch.Tensor, cfg,
                 cache: Cache) -> Tuple[torch.Tensor, Cache]:
    """u (B, 1, d); cache {"state"} -> (out (B, 1, d), the new cache)."""
    q, k, v, f, z = _mlstm_qkvg(p, u, cfg)
    y, state = linear_attention_step(cache["state"], q[:, 0], k[:, 0],
                                     _ones_channel(v)[:, 0], f[:, 0])
    y = y[:, None]                                       # (B, 1, H, hd + 1)
    out = _mlstm_finish(p, y[..., :-1].float(), y[..., -1:].float(), z, u,
                        cfg)
    return out, {"state": state}


def mlstm_init_cache(cfg, batch: int, device) -> Cache:
    _, hd = mlstm_dims(cfg)
    return {"state": torch.zeros((batch, cfg.n_heads, hd, hd + 1),
                                 dtype=torch.float32, device=device)}


# ================================================================== sLSTM ==
class SLSTM(nn.Module):
    """One sLSTM's weights in ``init_slstm``'s shapes: ``w_in`` and
    ``w_rec`` (d, 4 d) ([i | f | z | o]), ``bias`` (4 d,) f32, the FFN's
    ``ffn_up`` (d, d_ff) and ``ffn_down`` (d_ff, d), and a norm over d
    that the reference initialises and never applies."""

    def __init__(self, cfg, device):
        super().__init__()
        d, dt = cfg.d_model, pdt(cfg)
        d_ff = int(d * cfg.ssm.slstm_proj_factor)
        self.w_in = _param(d, 4 * d, dtype=dt, device=device)
        self.w_rec = _param(d, 4 * d, dtype=dt, device=device)
        self.bias = _param(4 * d, dtype=torch.float32, device=device)
        self.ffn_up = _param(d, d_ff, dtype=dt, device=device)
        self.ffn_down = _param(d_ff, d, dtype=dt, device=device)
        self.norm = Norm(cfg, device, d)


def _slstm_step(p: SLSTM, x_in: torch.Tensor, h: torch.Tensor,
                c_state: torch.Tensor, n_state: torch.Tensor, cfg):
    """One sLSTM step from ``x_in`` = x_t @ w_in (B, 4 d), in the compute
    dtype: the reference's sum of its two compute-dtype products, then f32
    gates. Returns (h (B, d) in x_in's dtype, c, n (B, d) f32)."""
    c = cdt(cfg)
    d = h.shape[-1]
    pre = (x_in + torch.matmul(h.to(c), p.w_rec.to(c))).float() + \
        p.bias[None, :]
    i = torch.sigmoid(pre[:, :d])
    f = torch.sigmoid(pre[:, d:2 * d])
    zt = torch.tanh(pre[:, 2 * d:3 * d])
    o = torch.sigmoid(pre[:, 3 * d:])
    c_state = f * c_state + i * zt
    n_state = f * n_state + i
    h_new = o * (c_state / torch.clamp(n_state, min=1.0))
    return h_new.to(x_in.dtype), c_state, n_state


def slstm_forward(p: SLSTM, u: torch.Tensor, cfg,
                  cache: Optional[Cache] = None, return_state: bool = False,
                  valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """The sLSTM over u (B, S, d), one step per position (its input
    product for every position in one matmul first), then its FFN.
    ``cache`` {"h", "c", "n"} is the state to start from (zeros without
    it); ``valid`` (B, S) freezes h, c and n at padding steps. Returns (y
    (B, S, d), the final state when ``return_state`` or ``cache``, else
    None)."""
    B, S, d = u.shape
    c = cdt(cfg)
    if cache is None:
        h = torch.zeros((B, d), dtype=u.dtype, device=u.device)
        c_s = torch.zeros((B, d), dtype=torch.float32, device=u.device)
        n_s = torch.zeros((B, d), dtype=torch.float32, device=u.device)
    else:
        h, c_s, n_s = cache["h"], cache["c"], cache["n"]
    x_in = torch.matmul(u.to(c), p.w_in.to(c))               # (B, S, 4 d)
    hs = []
    for t in range(S):
        h_new, c_new, n_new = _slstm_step(p, x_in[:, t], h, c_s, n_s, cfg)
        if valid is not None:
            keep = valid[:, t, None]
            h_new = torch.where(keep, h_new, h.to(h_new.dtype))
            c_new = torch.where(keep, c_new, c_s)
            n_new = torch.where(keep, n_new, n_s)
        h, c_s, n_s = h_new, c_new, n_new
        hs.append(h)
    y = torch.stack(hs, dim=1)                                # (B, S, d)
    ff = F.gelu(torch.matmul(y.to(c), p.ffn_up.to(c)), approximate="tanh")
    y = y + torch.matmul(ff, p.ffn_down.to(c))
    state = ({"h": h, "c": c_s, "n": n_s}
             if return_state or cache is not None else None)
    return y, state


def slstm_init_cache(cfg, batch: int, dtype: torch.dtype, device) -> Cache:
    d = cfg.d_model
    return {"h": torch.zeros((batch, d), dtype=dtype, device=device),
            "c": torch.zeros((batch, d), dtype=torch.float32, device=device),
            "n": torch.zeros((batch, d), dtype=torch.float32, device=device)}
