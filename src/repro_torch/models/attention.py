"""Dense GQA/MHA self-attention: prefill, cache writes and one-token decode.

Port of the dense part of ``repro.models.attention``. Projection weights
keep the reference's einsum layouts (``wq`` (d, H, hd), ``wk``/``wv``
(d, Hkv, hd), ``wo`` (H, hd, d)); each projection runs as one matmul over a
reshaped view.

With ``cfg.use_kernels`` prefill attention goes to the flash-attention
kernel (also for the engine's padded waves: per-row ``kv_len`` is the
kernel's own argument) and decode attention to the flash-decode kernel,
through ``repro_torch.kernels.ops``. Without it, the ports of the
reference's XLA paths run: ``blockwise_attention`` for prefill and
``grouped_attention_narrow`` for decode.

Cache writes are in place (the reference rebuilt the cache arrays), and
only the rows of active slots are written.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import (apply_rope, cdt, rms_norm_heads,
                                       rope_cos_sin)
from repro_torch.serving.kvcache import select_slots

NEG_INF = -1e30


def _proj(x: torch.Tensor, w: torch.Tensor, c: torch.dtype) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul: x (B,S,d), w (d,H,k)."""
    d, H, k = w.shape
    return torch.matmul(x.to(c), w.to(c).reshape(d, H * k)).unflatten(
        -1, (H, k))


def _out_proj(o: torch.Tensor, wo: torch.Tensor,
              c: torch.dtype) -> torch.Tensor:
    """einsum("bshk,hkd->bsd"): o (B,S,H,k), wo (H,k,d)."""
    H, k, d = wo.shape
    return torch.matmul(o.to(c).flatten(-2), wo.to(c).reshape(H * k, d))


def _project_qkv(p, x: torch.Tensor, cfg, positions: torch.Tensor):
    """Returns q (B,S,H,D) and k, v (B,S,Hkv,D), RoPE applied at
    ``positions`` ((S,) or (B,S))."""
    c = cdt(cfg)
    q = _proj(x, p.wq, c)
    k = _proj(x, p.wk, c)
    v = _proj(x, p.wv, c)
    if cfg.qk_norm:
        q = rms_norm_heads(q, p.q_norm, cfg.norm_eps)
        k = rms_norm_heads(k, p.k_norm, cfg.norm_eps)
    cos, sin = rope_cos_sin(positions, q.shape[-1], cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B,T,Hkv,D) -> (B,T,H,D): KV head j serves query heads j*G..j*G+G-1."""
    hkv = k.shape[2]
    if hkv == n_heads:
        return k
    return k.repeat_interleave(n_heads // hkv, dim=2)


def write_cache_row(cache: torch.Tensor, new_row: torch.Tensor,
                    slot: torch.Tensor,
                    active: Optional[torch.Tensor] = None) -> None:
    """Write one token per sequence into a (B, S, ...) cache at ``slot``,
    in place. Rows where ``active`` is False keep their old value bit for
    bit (a gather, select and scatter on the device: no host sync), which
    is what leaves free slots untouched through a megastep."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    new_row = new_row.to(cache.dtype)
    if active is not None:
        new_row = select_slots(cache[rows, slot], new_row, active)
    cache[rows, slot] = new_row


# ------------------------------------------------- blockwise prefill core --
def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float, causal: bool, window: int = 0,
                        q_offset: int = 0,
                        kv_len: Optional[torch.Tensor] = None,
                        chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV chunks; never builds (S, T) for the
    whole T. q (B,S,H,D); k, v (B,T,H,D), same head count (callers repeat
    GQA KV). ``q_offset`` shifts query positions; ``kv_len`` (B,) masks
    padding keys. Rows with no visible key come out as the reference's do
    (a uniform average), finite."""
    B, S, H, D = q.shape
    T = k.shape[1]
    chunk = min(chunk, T)
    if T % chunk:
        pad = chunk - T % chunk
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        if kv_len is None:
            kv_len = torch.full((B,), T, dtype=torch.int32, device=q.device)
        T = T + pad
    dev = q.device
    q_pos = torch.arange(S, device=dev) + q_offset
    qf = q.float() * scale
    acc = torch.zeros((B, S, H, D), dtype=torch.float32, device=dev)
    m = torch.full((B, S, H), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, S, H), dtype=torch.float32, device=dev)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    for c0 in range(0, T, chunk):
        k_i = k[:, c0:c0 + chunk].float()
        v_i = v[:, c0:c0 + chunk].float()
        s = torch.einsum("bshd,bchd->bshc", qf, k_i)
        k_pos = c0 + torch.arange(chunk, device=dev)
        mask = torch.ones((S, chunk), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        if window:
            mask = mask & ((q_pos[:, None] - k_pos[None, :]) < window)
        s = torch.where(mask[None, :, None, :], s, neg)
        if kv_len is not None:
            valid = k_pos[None, :] < kv_len.long()[:, None]        # (B,C)
            s = torch.where(valid[:, None, None, :], s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bshc,bchd->bshd", p, v_i)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


# -------------------------------------------------------------- prefill ----
def attend_prefill(p, x: torch.Tensor, cfg, *, positions: torch.Tensor,
                   layer_window: int = 0,
                   kv_len: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Causal self-attention over the whole sequence. Returns (y (B,S,d),
    (k, v) narrow-head (B,S,Hkv,D))."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    scale = 1.0 / math.sqrt(q.shape[-1])
    if cfg.use_kernels:
        out = kops.flash_attention(
            q, k, v, causal=True, window=layer_window, scale=scale,
            kv_len=None if kv_len is None else kv_len.to(torch.int32))
    else:
        out = blockwise_attention(q, _repeat_kv(k, cfg.n_heads),
                                  _repeat_kv(v, cfg.n_heads), scale=scale,
                                  causal=True, window=layer_window,
                                  kv_len=kv_len)
    return _out_proj(out, p.wo, cdt(cfg)), (k, v)


# --------------------------------------------------------------- decode ----
def grouped_attention_narrow(q: torch.Tensor, cache_k: torch.Tensor,
                             cache_v: torch.Tensor,
                             valid: torch.Tensor) -> torch.Tensor:
    """GQA scoring on the narrow cache, no head repeat. q (B,S,H,D)
    pre-scaled; cache (B,T,Hkv,D); valid (B,T) bool -> (B,S,H,D) f32."""
    B, S, H, D = q.shape
    hkv = cache_k.shape[2]
    qg = q.reshape(B, S, hkv, H // hkv, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(), cache_k.float())
    s = torch.where(valid[:, None, None, None, :], s,
                    torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, cache_v.float())
    return out.reshape(B, S, H, D)


def attend_decode(p, x: torch.Tensor, cfg, *, cache_k: torch.Tensor,
                  cache_v: torch.Tensor, lengths: torch.Tensor,
                  active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-token decode. x (B,1,d); cache (B,Scache,Hkv,D) updated in place
    at ``min(lengths, Scache-1)`` for active rows; lengths (B,). Returns
    y (B,1,d). With kernels, inactive rows do no attention work and their
    (discarded) output is zero."""
    c = cdt(cfg)
    q = _proj(x, p.wq, c)
    k_new = _proj(x, p.wk, c)
    v_new = _proj(x, p.wv, c)
    if cfg.qk_norm:
        q = rms_norm_heads(q, p.q_norm, cfg.norm_eps)
        k_new = rms_norm_heads(k_new, p.k_norm, cfg.norm_eps)
    cos, sin = rope_cos_sin(lengths[:, None], q.shape[-1], cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k_new = apply_rope(k_new, cos, sin)

    s_cache = cache_k.shape[1]
    slot = torch.clamp(lengths.long(), max=s_cache - 1)
    write_cache_row(cache_k, k_new[:, 0], slot, active)
    write_cache_row(cache_v, v_new[:, 0], slot, active)

    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    if cfg.use_kernels:
        n_valid = torch.clamp(lengths + 1, max=s_cache).to(torch.int32)
        out = kops.flash_decode(q[:, 0].contiguous(), cache_k, cache_v,
                                n_valid, scale=scale,
                                active=active)[:, None]
    else:
        pos = torch.arange(s_cache, device=cache_k.device)
        valid = pos[None, :] <= lengths.long()[:, None]
        out = grouped_attention_narrow(q * scale, cache_k, cache_v,
                                       valid)[:, :1]
    return _out_proj(out, p.wo, c)
