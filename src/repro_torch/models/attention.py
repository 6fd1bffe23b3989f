"""Attention: dense GQA/MHA self-attention (prefill, cache writes,
one-token decode), cross-attention against a memory, and DeepSeek's MLA.

Port of ``repro.models.attention``. Projection weights
keep the reference's einsum layouts (``wq`` (d, H, hd), ``wk``/``wv``
(d, Hkv, hd), ``wo`` (H, hd, d)); each projection runs as one matmul over a
reshaped view.

With ``cfg.use_kernels`` prefill attention goes to the flash-attention
kernel (also for the engine's padded waves and for the tail-only prefill
of prefix sharing: per-row ``kv_len`` and ``q_offset`` are the kernel's own
arguments) and decode attention to the flash-decode kernels (slot cache or
paged pool), through ``repro_torch.kernels.ops``. Without it, the ports of
the reference's XLA paths run: ``blockwise_attention`` for prefill and
``grouped_attention_narrow`` for decode (over the gathered pages, for the
paged pool). Cross-attention (``attend_cached_memory``: Whisper's decoder
over its encoder's frames, the vision model's image layers over the
patches) runs on the same two kernels with kernels on, where the reference
keeps it on XLA; an encoder's attention is ``attend_prefill`` not causal.

Cache writes are in place (the reference rebuilt the cache arrays), and
only the rows of active slots are written: into their own slot, or into
their own pages through the page table, with every masked write aimed at
the pool's TRASH page.

Under a mesh (``models.sharding``) the reference's ``shard`` sites place
q (batch, seq, heads, -), K/V (batch, seq, -, -) and the outputs, and
every attention core runs in ``sharding.local`` over the rank's own rows
and query heads, as plain tensors: the kernel calls (``attend_prefill``,
``attend_prefill_shared``, ``attend_decode``, ``attend_cached_memory``,
``paged_attend_decode``, ``paged_mla_decode``), their plain branches, and
the slot cache's row writes (``write_cache_row``, an indexed write DTensor
has no sharding strategy for). K/V come in with every head; each rank
takes the heads its query heads read (``_local_heads``). A decode cache
sharded on ``kv_seq`` is gathered to whole rows for the step and its
rank's part written back (``shard``, then ``sharding.write_back``): an
all-gather per layer and step, right but not fast. The paged pool is the
engine's, and the engine never runs under a mesh.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import sharding
from repro_torch.models.layers import (apply_rope, cdt, rms_norm_heads,
                                       rope_cos_sin)
from repro_torch.models.sharding import shard
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


# logical axes of attention's tensors under a mesh: queries and outputs
# (B, S, H, D), K/V and slot caches (B, S, Hkv, D), per-row vectors (B,)
QA = ("batch", "seq", "heads", None)
KA = ("batch", "seq", None, None)
ROW = ("batch",)


def _local_heads(kv: torch.Tensor, n_local: int, n_heads: int
                 ) -> torch.Tensor:
    """The K/V heads (B, T, Hkv, D) that serve this rank's ``n_local`` of
    the ``n_heads`` query heads, keeping GQA: kv head j serves query heads
    j*G..j*G+G-1. All of them with no head sharding; a contiguous slice
    when a rank's query heads cover whole groups; else one K/V head per
    query head."""
    if n_local == n_heads:
        return kv
    g = n_heads // kv.shape[2]
    h0 = sharding.axis_index("heads") * n_local
    if n_local % g == 0:
        return kv[:, :, h0 // g:(h0 + n_local) // g].contiguous()
    idx = (h0 + torch.arange(n_local, device=kv.device)) // g
    return kv.index_select(2, idx)


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
                        q_offset: Union[int, torch.Tensor] = 0,
                        kv_len: Optional[torch.Tensor] = None,
                        chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV chunks; never builds (S, T) for the
    whole T. q (B,S,H,D); k, v (B,T,H,D), same head count (callers repeat
    GQA KV). ``q_offset`` shifts query positions: an int for every row, or
    a (B,) tensor per row (the shared-prefix tail prefill); ``kv_len`` (B,)
    masks padding keys. Rows with no visible key come out as the
    reference's do (a uniform average), finite."""
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
    per_row = isinstance(q_offset, torch.Tensor) and q_offset.dim() == 1
    if per_row:
        q_pos = q_offset.long()[:, None] + torch.arange(S, device=dev)
    else:
        q_pos = torch.arange(S, device=dev) + q_offset          # (S,)
    qp = q_pos[..., :, None]                         # (S,1) or (B,S,1)
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
        mask = torch.ones(qp.shape[:-1] + (chunk,), dtype=torch.bool,
                          device=dev)
        if causal:
            mask = mask & (qp >= k_pos)
        if window:
            mask = mask & ((qp - k_pos) < window)
        mask = mask if per_row else mask[None]                  # (B|1,S,C)
        s = torch.where(mask[:, :, None, :], s, neg)
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
                   layer_window: int = 0, causal: bool = True,
                   kv_len: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Self-attention over the whole sequence: causal, or with ``causal``
    False every query over every key (an encoder's). Returns (y (B,S,d),
    (k, v) narrow-head (B,S,Hkv,D))."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    q = shard(q, *QA)
    k = shard(k, *KA)
    v = shard(v, *KA)

    def core(q, k, v, kv_len):
        k = _local_heads(k, q.shape[2], cfg.n_heads)
        v = _local_heads(v, q.shape[2], cfg.n_heads)
        scale = 1.0 / math.sqrt(q.shape[-1])
        if cfg.use_kernels:
            return kops.flash_attention(
                q, k, v, causal=causal, window=layer_window, scale=scale,
                kv_len=None if kv_len is None else kv_len.to(torch.int32))
        return blockwise_attention(q, _repeat_kv(k, q.shape[2]),
                                   _repeat_kv(v, q.shape[2]), scale=scale,
                                   causal=causal, window=layer_window,
                                   kv_len=kv_len)
    out = sharding.local(core, (QA, KA, KA, ROW), (QA,))(q, k, v, kv_len)
    out = shard(out, *QA)
    y = shard(_out_proj(out, p.wo, cdt(cfg)), "batch", "seq", None)
    return y, (k, v)


def _merge_rows(view: torch.Tensor, tail: torch.Tensor,
                starts: torch.Tensor) -> torch.Tensor:
    """Overlay freshly computed tail rows onto a gathered cache view.

    view (B, L, ...) holds per-row cache content (shared prefix pages plus
    whatever the row's private pages hold); tail (B, Tb, ...) holds new
    values for logical positions [start, start + Tb). Row b of the result
    equals view outside that span and tail inside it: prefix positions pass
    through bit for bit, which keeps the shared prefill exact."""
    B, L = view.shape[:2]
    Tb = tail.shape[1]
    pos = torch.arange(L, device=view.device)[None, :]            # (1, L)
    st = starts.long()[:, None]
    idx = torch.clamp(pos - st, 0, Tb - 1)                       # (B, L)
    idxe = idx.reshape((B, L) + (1,) * (tail.dim() - 2)).expand(
        (B, L) + tail.shape[2:])
    gathered = torch.gather(tail.to(view.dtype), 1, idxe)
    in_tail = (pos >= st) & (pos < st + Tb)
    return torch.where(in_tail.reshape((B, L) + (1,) * (view.dim() - 2)),
                       gathered, view)


def attend_prefill_shared(p, x: torch.Tensor, cfg, *, positions: torch.Tensor,
                          starts: torch.Tensor, kv_len: torch.Tensor,
                          view_k: torch.Tensor, view_v: torch.Tensor
                          ) -> Tuple[torch.Tensor,
                                     Tuple[torch.Tensor, torch.Tensor]]:
    """Tail-only prefill attention for page-level prefix sharing.

    x (B,Tb,d) embeds only the unshared tail tokens of each row;
    ``positions`` (B,Tb) are their absolute positions (starts[b] + i);
    view_k/view_v (B,L,Hkv,D) are the rows' cache views gathered through
    the page table, already holding the shared prefix K/V. Computes q/k/v
    for the tail, merges the tail K/V into the view at each row's offset,
    and runs causal attention with per-row query offsets over the merged
    K/V, masked to ``kv_len``: masked keys weigh exactly 0, so a row's
    output is what a whole-prompt prefill of it gives. With
    ``cfg.use_kernels`` that is the flash-attention kernel with
    ``q_offset=starts`` (the reference sends this to its blockwise path).

    Returns (y (B,Tb,d), the tail's narrow (k, v) (B,Tb,Hkv,D)): the caller
    writes the tail into the row's pages (the reference returned the merged
    view and scattered it back whole)."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    q = shard(q, *QA)

    def core(q, k, v, view_k, view_v, starts, kv_len):
        mk = _local_heads(_merge_rows(view_k, k, starts), q.shape[2],
                          cfg.n_heads)
        mv = _local_heads(_merge_rows(view_v, v, starts), q.shape[2],
                          cfg.n_heads)
        scale = 1.0 / math.sqrt(q.shape[-1])
        if cfg.use_kernels:
            return kops.flash_attention(q, mk, mv, causal=True, scale=scale,
                                        kv_len=kv_len.to(torch.int32),
                                        q_offset=starts.to(torch.int32))
        return blockwise_attention(q, _repeat_kv(mk, q.shape[2]),
                                   _repeat_kv(mv, q.shape[2]), scale=scale,
                                   causal=True, q_offset=starts,
                                   kv_len=kv_len)
    out = sharding.local(core, (QA, KA, KA, KA, KA, ROW, ROW), (QA,))(
        q, k, v, view_k, view_v, starts, kv_len)
    out = shard(out, *QA)
    y = shard(_out_proj(out, p.wo, cdt(cfg)), "batch", "seq", None)
    return y, (k, v)


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
                  layer_window: int = 0,
                  active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-token decode. x (B,1,d); cache (B,Scache,Hkv,D) updated in place
    for active rows; lengths (B,). A full cache is written at
    ``min(lengths, Scache-1)``; with ``layer_window`` the cache is a ring
    buffer (Scache == min(cache_len, window)) written at ``lengths %
    Scache``, whose first ``min(lengths+1, Scache)`` slots are valid. The
    softmax does not care in which order the valid keys sit, so the ring
    goes through the same decode kernel. Returns y (B,1,d). With kernels,
    inactive rows do no attention work and their (discarded) output is
    zero."""
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

    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)

    def core(q, k_new, v_new, cache_k, cache_v, lengths, active):
        s_cache = cache_k.shape[1]
        slot = (lengths.long() % s_cache if layer_window
                else torch.clamp(lengths.long(), max=s_cache - 1))
        write_cache_row(cache_k, k_new[:, 0], slot, active)
        write_cache_row(cache_v, v_new[:, 0], slot, active)
        ck = _local_heads(cache_k, q.shape[2], cfg.n_heads)
        cv = _local_heads(cache_v, q.shape[2], cfg.n_heads)
        n_valid = torch.clamp(lengths + 1, max=s_cache)
        if cfg.use_kernels:
            return kops.flash_decode(q[:, 0].contiguous(), ck, cv,
                                     n_valid.to(torch.int32), scale=scale,
                                     active=active)[:, None]
        pos = torch.arange(s_cache, device=cache_k.device)
        if layer_window:
            valid = pos[None, :] < n_valid.long()[:, None]
        else:
            valid = pos[None, :] <= lengths.long()[:, None]
        return grouped_attention_narrow(q * scale, ck, cv, valid)[:, :1]

    # the kernel reads whole rows: a kv_seq-sharded cache is gathered for
    # the step, written in the gathered copy and its shards written back
    ck, cv = shard(cache_k, *KA), shard(cache_v, *KA)
    out = sharding.local(core, (QA, KA, KA, KA, KA, ROW, ROW), (QA,))(
        shard(q, *QA), k_new, v_new, ck, cv, lengths, active)
    sharding.write_back(cache_k, ck)
    sharding.write_back(cache_v, cv)
    return _out_proj(shard(out, *QA), p.wo, c)


# ---------------------------------------------------- cross-attention ----
def project_memory_kv(p, memory: torch.Tensor, cfg
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V from an encoder's or a vision frontend's memory
    (B, T, d_mem), once: (k, v) (B, T, Hkv, D) in the compute dtype, no
    RoPE."""
    c = cdt(cfg)
    return _proj(memory, p.wk, c), _proj(memory, p.wv, c)


def attend_cached_memory(p, x: torch.Tensor, cfg, mem_k: torch.Tensor,
                         mem_v: torch.Tensor,
                         mem_len: Optional[torch.Tensor] = None,
                         active: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Cross-attention of x (B, S, d) against precomputed memory K/V (B, T,
    Hkv, D): no RoPE, no cache write; ``mem_len`` (B,) masks memory keys
    past it. Returns y (B, S, d).

    With ``cfg.use_kernels`` it runs on the port's kernels, where the
    reference keeps it on XLA: S = 1 (a decode step) on the decode kernel
    with ``n_valid = mem_len`` (T without it; ``active`` lets inactive
    rows do no work, their output zeros the caller discards), longer S (a
    prefill wave) on the prefill kernel, not causal, S queries over T
    keys. Without, the reference's two plain branches: above 256 queries
    the blockwise online softmax over K/V repeated to every head, else
    ``grouped_attention_narrow`` on the narrow K/V with q scaled first."""
    c = cdt(cfg)
    q = _proj(x, p.wq, c)
    if cfg.qk_norm:
        q = rms_norm_heads(q, p.q_norm, cfg.norm_eps)
    scale = 1.0 / math.sqrt(q.shape[-1])

    def core(q, mem_k, mem_v, mem_len, active):
        B, S, H = q.shape[:3]
        T = mem_k.shape[1]
        mem_k = _local_heads(mem_k, H, cfg.n_heads)
        mem_v = _local_heads(mem_v, H, cfg.n_heads)
        if cfg.use_kernels:
            n = (torch.full((B,), T, dtype=torch.int32, device=q.device)
                 if mem_len is None else mem_len.to(torch.int32))
            if S == 1:
                return kops.flash_decode(q[:, 0].contiguous(), mem_k, mem_v,
                                         n, scale=scale,
                                         active=active)[:, None]
            return kops.flash_attention(q, mem_k, mem_v, causal=False,
                                        scale=scale, kv_len=n)
        if S > 256:
            return blockwise_attention(q, _repeat_kv(mem_k, H),
                                       _repeat_kv(mem_v, H), scale=scale,
                                       causal=False, kv_len=mem_len)
        pos = torch.arange(T, device=q.device)
        valid = (torch.ones((B, T), dtype=torch.bool, device=q.device)
                 if mem_len is None
                 else pos[None, :] < mem_len.long()[:, None])
        return grouped_attention_narrow(q * scale, mem_k, mem_v, valid)
    out = sharding.local(core, (QA, KA, KA, ROW, ROW), (QA,))(
        shard(q, *QA), mem_k, mem_v, mem_len, active)
    y = _out_proj(shard(out, *QA), p.wo, c)
    return shard(y, "batch", "seq", None)


# ------------------------------------------------------------ paged pool ----
def _paged_write_span(pages: torch.Tensor, kv: torch.Tensor,
                      page_table: torch.Tensor,
                      starts: Optional[torch.Tensor] = None) -> None:
    """Write a prefill's K or V into the pool, in place: kv (B, S, Hkv, D)
    row b at logical positions ``starts[b] + i`` (``i`` without starts),
    through the row's page table (B, n). Positions in columns that name the
    TRASH page, or past the table's n * P, land in TRASH (index NP), so
    padding rows, whose table rows are all TRASH, write nothing live."""
    B, S = kv.shape[:2]
    n = page_table.shape[1]
    P = pages.shape[1]
    trash = pages.shape[0] - 1
    pos = torch.arange(S, device=kv.device)[None, :]
    if starts is not None:
        pos = pos + starts.long()[:, None]                          # (B, S)
    col = pos // P
    inside = col < n
    dest = page_table.long().gather(
        1, torch.clamp(col, max=n - 1).expand(B, S))
    dest = torch.where(inside, dest, trash)
    pages[dest, (pos % P).expand(B, S)] = kv.to(pages.dtype)


def _paged_write_row(pages: torch.Tensor, new_row: torch.Tensor,
                     page_table: torch.Tensor, lengths: torch.Tensor,
                     active: torch.Tensor) -> None:
    """Write one token per slot into the pool at logical position
    ``lengths``, in place. pages (NP+1, P, ...); page_table (B, n); new_row
    (B, ...).

    Inactive slots write into the TRASH page (index NP): their stale page
    table may name pages another slot now owns, so they never write through
    it. The clamp mirrors ``attend_decode``'s ``min(lengths, cache - 1)``
    with cache = n * P, so an at-capacity slot overwrites its last position
    instead of escaping its reservation."""
    B, n = page_table.shape
    P = pages.shape[1]
    trash = pages.shape[0] - 1
    wpos = torch.clamp(lengths.long(), max=n * P - 1)
    rows = torch.arange(B, device=pages.device)
    dest = torch.where(active, page_table[rows, wpos // P].long(), trash)
    pages[dest, wpos % P] = new_row.to(pages.dtype)


def _paged_gather(pages: torch.Tensor, page_table: torch.Tensor
                  ) -> torch.Tensor:
    """(NP+1, P, ...) + (B, n) -> contiguous view (B, n*P, ...)."""
    B, n = page_table.shape
    P = pages.shape[1]
    return pages[page_table.reshape(-1).long()].reshape(
        (B, n * P) + pages.shape[2:])


def paged_attend_decode(p, x: torch.Tensor, cfg, *, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, page_table: torch.Tensor,
                        lengths: torch.Tensor,
                        active: torch.Tensor) -> torch.Tensor:
    """One-token GQA decode against the paged pool.

    x (B,1,d); k/v_pages (NP+1, P, Hkv, D), written in place; page_table
    (B, n) int32 (a column slice of the engine's table is fine); lengths
    (B,); active (B,) bool (inactive slots write into TRASH and their
    outputs are garbage the caller discards). Returns y (B,1,d).

    With ``cfg.use_kernels`` attention runs in the paged flash-decode
    kernel, which reads the pages in place through the table; otherwise
    the pages are gathered into a contiguous view and scored by the slot
    cache's ``grouped_attention_narrow``."""
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

    _paged_write_row(k_pages, k_new[:, 0], page_table, lengths, active)
    _paged_write_row(v_pages, v_new[:, 0], page_table, lengths, active)
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    cap = page_table.shape[1] * k_pages.shape[1]
    if cfg.use_kernels:
        n_valid = torch.where(active, torch.clamp(lengths + 1, max=cap),
                              0).to(torch.int32)

        def core(q, page_table, n_valid, k_pages, v_pages):
            return kops.paged_flash_decode(
                q[:, 0].contiguous(), k_pages, v_pages, page_table, n_valid,
                scale=scale)[:, None]
        out = sharding.local(
            core, (("batch", None, None, None), ("batch", None), ROW,
                   (None,) * 4, (None,) * 4),
            (("batch", None, None, None),))(
            q, page_table, n_valid, k_pages, v_pages)
    else:
        kv = _paged_gather(k_pages, page_table)
        vv = _paged_gather(v_pages, page_table)
        pos = torch.arange(cap, device=kv.device)
        valid = pos[None, :] <= lengths.long()[:, None]
        out = grouped_attention_narrow(q * scale, kv, vv, valid)[:, :1]
    return _out_proj(out, p.wo, c)


# -------------------------------------------------------------- MLA --------
def _mla_q(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """Queries (B,S,H,dn+dr): direct (``wq``) or through the query latent
    (``w_dq`` then ``w_uq``)."""
    c = cdt(cfg)
    if getattr(p, "w_dq", None) is not None:
        return _proj(torch.matmul(x.to(c), p.w_dq.to(c)), p.w_uq, c)
    return _proj(x, p.wq, c)


def _mla_latent(p, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Down-project to (latent c_kv (B,S,R) RMS-normed, shared rope key
    (B,S,dr) before its rotation)."""
    m = cfg.mla
    c = cdt(cfg)
    dkv = torch.matmul(x.to(c), p.w_dkv.to(c))
    ckv, k_rope = dkv[..., :m.kv_lora_rank], dkv[..., m.kv_lora_rank:]
    return rms_norm_heads(ckv, p.kv_norm, cfg.norm_eps), k_rope


def _mla_qk(p, x: torch.Tensor, cfg, positions: torch.Tensor):
    """(q_nope, q_rope rotated, c_kv, k_rope rotated) at ``positions``
    ((S,) or (B,S))."""
    m = cfg.mla
    q = _mla_q(p, x, cfg)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    cos, sin = rope_cos_sin(positions, m.qk_rope_head_dim, cfg.rope_theta)
    ckv, k_rope = _mla_latent(p, x, cfg)
    return (q_nope, apply_rope(q_rope, cos, sin), ckv,
            apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :])


def _mla_scale(cfg) -> float:
    m = cfg.mla
    return 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)


def mla_prefill(p, x: torch.Tensor, cfg, *, positions: torch.Tensor,
                kv_len: Optional[torch.Tensor] = None, chunk: int = 1024
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Causal MLA over the whole sequence: a blockwise online softmax whose
    keys and values are decompressed from the latent one chunk of
    ``chunk`` positions at a time (the reference's XLA path; no kernel).
    Returns (y (B,S,d), (c_kv (B,S,R), k_rope (B,S,dr))), the latents the
    cache keeps.

    Under a mesh the chunk loop runs in ``sharding.local`` over the rank's
    rows and query heads, as the other attention cores do: the score
    einsum of DTensors folds batch and heads into one ``bmm`` dim sharded
    on two mesh dims (a ``_StridedShard``), whose sharding DTensor's cost
    model cannot work out over fake tensors."""
    c = cdt(cfg)
    q_nope, q_rope, ckv, k_rope = _mla_qk(p, x, cfg, positions)
    scale = _mla_scale(cfg)
    dv = cfg.mla.v_head_dim

    def core(q_nope, q_rope, ckv, k_rope, w_uk, w_uv, kv_len):
        B, S, h = q_nope.shape[:3]
        qn = q_nope.float() * scale
        qr = q_rope.float() * scale
        dev = qn.device
        qp = torch.arange(S, device=dev)[:, None]
        acc = torch.zeros((B, S, h, dv), dtype=torch.float32, device=dev)
        m = torch.full((B, S, h), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, S, h), dtype=torch.float32, device=dev)
        neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
        for c0 in range(0, S, min(chunk, S)):
            ckv_i = ckv[:, c0:c0 + chunk].to(c)
            k_i = torch.einsum("bcr,rhk->bchk", ckv_i, w_uk).float()
            v_i = torch.einsum("bcr,rhk->bchk", ckv_i, w_uv).float()
            s = torch.einsum("bshd,bchd->bshc", qn, k_i)
            s = s + torch.einsum("bshd,bcd->bshc", qr,
                                 k_rope[:, c0:c0 + chunk].float())
            k_pos = c0 + torch.arange(k_i.shape[1], device=dev)
            s = torch.where((qp >= k_pos)[None, :, None, :], s, neg)
            if kv_len is not None:
                valid = k_pos[None, :] < kv_len.long()[:, None]     # (B,C)
                s = torch.where(valid[:, None, None, :], s, neg)
            m_new = torch.maximum(m, s.amax(dim=-1))
            pr = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + pr.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bshc,bchd->bshd",
                                                       pr, v_i)
            m = m_new
        return (acc / torch.clamp(l, min=1e-30)[..., None]).to(c)
    lat, w = ("batch", "seq", None), (None, "heads", None)
    out = sharding.local(core, (QA, QA, lat, lat, w, w, ROW), (QA,))(
        q_nope, q_rope, ckv, k_rope, p.w_uk.to(c), p.w_uv.to(c), kv_len)
    y = shard(_out_proj(out, p.wo, c), "batch", "seq", None)
    return y, (ckv, k_rope)


def _mla_attend_latent(q_lat: torch.Tensor, q_rope: torch.Tensor,
                       ckv: torch.Tensor, kr: torch.Tensor,
                       valid: torch.Tensor, scale: float) -> torch.Tensor:
    """Absorbed scores in latent space over a contiguous latent cache:
    q_lat (B,1,H,R), q_rope (B,1,H,dr), ckv (B,T,R), kr (B,T,dr), valid
    (B,T) -> latent output (B,1,H,R) f32 (the reference's einsums)."""
    s = torch.einsum("bshr,btr->bhst", q_lat.float() * scale, ckv.float())
    s = s + torch.einsum("bshd,btd->bhst", q_rope.float() * scale, kr.float())
    s = torch.where(valid[:, None, None, :], s,
                    torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,btr->bshr", w, ckv.float())


def _mla_out(p, out_lat: torch.Tensor, cfg) -> torch.Tensor:
    """Latent output (B,1,H,R) -> y (B,1,d) through ``w_uv`` then ``wo``."""
    c = cdt(cfg)
    out = torch.einsum("bshr,rhd->bshd", out_lat.to(c), p.w_uv.to(c))
    return _out_proj(out, p.wo, c)


def _mla_decode_q(p, x: torch.Tensor, cfg, lengths: torch.Tensor):
    """One token per row at position ``lengths``: (q_lat (B,1,H,R) with
    ``w_uk`` absorbed, q_rope (B,1,H,dr), new c_kv row (B,R), new rotated
    rope key row (B,dr))."""
    c = cdt(cfg)
    q_nope, q_rope, ckv_new, kr_new = _mla_qk(p, x, cfg, lengths[:, None])
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope.to(c), p.w_uk.to(c))
    return q_lat, q_rope, ckv_new[:, 0], kr_new[:, 0]


def mla_decode(p, x: torch.Tensor, cfg, *, cache_ckv: torch.Tensor,
               cache_krope: torch.Tensor, lengths: torch.Tensor,
               active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Absorbed-matrix MLA decode over the slot cache: attention runs in
    latent space, never decompressing keys or values. x (B,1,d); cache_ckv
    (B,Sc,R) and cache_krope (B,Sc,dr) written in place at ``min(lengths,
    Sc-1)`` for active rows. Plain torch on every device: the reference has
    no kernel for it either. Returns y (B,1,d)."""
    q_lat, q_rope, ckv_new, kr_new = _mla_decode_q(p, x, cfg, lengths)

    def core(q_lat, q_rope, ckv_new, kr_new, cache_ckv, cache_krope,
             lengths, active):
        s_cache = cache_ckv.shape[1]
        slot = torch.clamp(lengths.long(), max=s_cache - 1)
        write_cache_row(cache_ckv, ckv_new, slot, active)
        write_cache_row(cache_krope, kr_new, slot, active)
        pos = torch.arange(s_cache, device=q_lat.device)
        valid = pos[None, :] <= lengths.long()[:, None]
        return _mla_attend_latent(q_lat, q_rope, cache_ckv, cache_krope,
                                  valid, _mla_scale(cfg))
    lat, row, cache = ("batch", None, "heads", None), ("batch", None), \
        ("batch", None, None)
    ckv, kr = (shard(cache_ckv, *cache),
               shard(cache_krope, *cache))
    out_lat = sharding.local(
        core, (lat, lat, row, row, cache, cache, ROW, ROW), (lat,))(
        q_lat, q_rope, ckv_new, kr_new, ckv, kr, lengths, active)
    sharding.write_back(cache_ckv, ckv)
    sharding.write_back(cache_krope, kr)
    return _mla_out(p, out_lat, cfg)


def paged_mla_decode(p, x: torch.Tensor, cfg, *, ckv_pages: torch.Tensor,
                     krope_pages: torch.Tensor, page_table: torch.Tensor,
                     lengths: torch.Tensor,
                     active: torch.Tensor) -> torch.Tensor:
    """Absorbed-matrix MLA decode against the paged latents: ckv_pages
    (NP+1, P, R) and krope_pages (NP+1, P, dr), written in place through
    ``page_table`` (B, n) (inactive rows into TRASH). The pool holds only
    the compressed latents, never decompressed keys or values.

    With ``cfg.use_kernels`` attention runs in the paged MLA decode kernel
    (``ops.paged_mla_decode``), which reads the pages in place; otherwise
    the pages are gathered and scored by the slot cache's math. Returns
    y (B,1,d)."""
    q_lat, q_rope, ckv_new, kr_new = _mla_decode_q(p, x, cfg, lengths)
    _paged_write_row(ckv_pages, ckv_new, page_table, lengths, active)
    _paged_write_row(krope_pages, kr_new, page_table, lengths, active)
    scale = _mla_scale(cfg)
    cap = page_table.shape[1] * ckv_pages.shape[1]
    if cfg.use_kernels:
        n_valid = torch.where(active, torch.clamp(lengths + 1, max=cap),
                              0).to(torch.int32)

        def core(q_lat, q_rope, page_table, n_valid, ckv_pages,
                 krope_pages):
            return kops.paged_mla_decode(
                q_lat[:, 0].contiguous(), q_rope[:, 0].contiguous(),
                ckv_pages, krope_pages, page_table, n_valid,
                scale=scale)[:, None].float()
        out_lat = sharding.local(
            core, (("batch", None, "heads", None),) * 2
            + (("batch", None), ROW, (None,) * 3, (None,) * 3),
            (("batch", None, "heads", None),))(
            q_lat, q_rope, page_table, n_valid, ckv_pages, krope_pages)
    else:
        pos = torch.arange(cap, device=x.device)
        valid = pos[None, :] <= lengths.long()[:, None]
        out_lat = _mla_attend_latent(
            q_lat, q_rope, _paged_gather(ckv_pages, page_table),
            _paged_gather(krope_pages, page_table), valid, scale)
    return _mla_out(p, out_lat, cfg)
