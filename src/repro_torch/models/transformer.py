"""Decoder-only transformer, dense family.

Port of ``repro.models.transformer.build_decoder`` for ``family="dense"``
as ``nn.Module``s. ``Transformer`` has the methods of the reference's
``Model`` record: ``init_cache``, ``forward``, ``prefill``,
``prefill_shared``, ``decode_step`` and ``decode_paged`` (``init`` is
``repro_torch.weights.init_params``). Layers
are a ``ModuleList`` instead of a stacked scan; parameter names follow the
reference's pytree paths (``layers.{i}.attn.wq`` is ``layers/attn/wq[i]``).

The KV cache is ``{"k": (L, B, S, Hkv, D), "v": ...}``: the reference's
``{"layers": (k, v)}`` with the same stacked layer axis; the paged pool is
the same dict built as ``init_cache(num_pages + 1, page_size)``, pages
where the slots were. The methods update the cache in place and return
only the logits, where the reference returned a new cache. Parameters
never require gradients: the port serves.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_mlp, apply_norm, cdt, embed,
                                       pdt, unembed)
from repro_torch.serving.kvcache import merge_slots

Cache = Dict[str, torch.Tensor]


def _param(*shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Norm(nn.Module):
    def __init__(self, cfg, device, d: Optional[int] = None):
        super().__init__()
        d = d or cfg.d_model
        self.scale = _param(d, dtype=pdt(cfg), device=device)
        self.bias = (_param(d, dtype=pdt(cfg), device=device)
                     if cfg.norm == "layernorm" else None)
        self.cfg = cfg

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_norm(x, self.scale, self.cfg, self.bias)


class Attention(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        d, hd, dt = cfg.d_model, cfg.resolved_head_dim, pdt(cfg)
        self.wq = _param(d, cfg.n_heads, hd, dtype=dt, device=device)
        self.wk = _param(d, cfg.n_kv_heads, hd, dtype=dt, device=device)
        self.wv = _param(d, cfg.n_kv_heads, hd, dtype=dt, device=device)
        self.wo = _param(cfg.n_heads, hd, d, dtype=dt, device=device)
        if cfg.qk_norm:
            self.q_norm = _param(hd, dtype=dt, device=device)
            self.k_norm = _param(hd, dtype=dt, device=device)


class MLP(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, pdt(cfg)
        self.up = _param(d, f, dtype=dt, device=device)
        self.down = _param(f, d, dtype=dt, device=device)
        self.gate = (_param(d, f, dtype=dt, device=device)
                     if cfg.activation == "swiglu" else None)
        self.cfg = cfg

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_mlp(x, self.up, self.down, self.cfg, gate=self.gate)


class DenseBlock(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        self.cfg = cfg
        self.ln1 = Norm(cfg, device)
        self.attn = Attention(cfg, device)
        self.ln2 = Norm(cfg, device)
        self.mlp = MLP(cfg, device)

    def prefill(self, x, *, positions, kv_len):
        """Returns (x, (k, v)) with the narrow-head K/V of the sequence."""
        a, kv = attn.attend_prefill(self.attn, self.ln1(x), self.cfg,
                                    positions=positions, kv_len=kv_len)
        x = x + a
        return x + self.mlp(self.ln2(x)), kv

    def prefill_shared(self, x, *, positions, starts, kv_len, view_k,
                       view_v):
        """``prefill`` over tail tokens only, attending over the row's
        gathered page view; returns (x, the tail's narrow (k, v))."""
        a, kv = attn.attend_prefill_shared(
            self.attn, self.ln1(x), self.cfg, positions=positions,
            starts=starts, kv_len=kv_len, view_k=view_k, view_v=view_v)
        x = x + a
        return x + self.mlp(self.ln2(x)), kv

    def decode(self, x, *, lengths, cache_k, cache_v, active):
        x = x + attn.attend_decode(self.attn, self.ln1(x), self.cfg,
                                   cache_k=cache_k, cache_v=cache_v,
                                   lengths=lengths, active=active)
        return x + self.mlp(self.ln2(x))

    def decode_paged(self, x, *, lengths, k_pages, v_pages, page_table,
                     active):
        x = x + attn.paged_attend_decode(
            self.attn, self.ln1(x), self.cfg, k_pages=k_pages,
            v_pages=v_pages, page_table=page_table, lengths=lengths,
            active=active)
        return x + self.mlp(self.ln2(x))


class Embedding(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        self.tok = _param(cfg.padded_vocab, cfg.d_model, dtype=pdt(cfg),
                          device=device)
        self.unembed = (None if cfg.tie_embeddings else
                        _param(cfg.d_model, cfg.padded_vocab, dtype=pdt(cfg),
                               device=device))


class Transformer(nn.Module):
    """Dense decoder (smollm2 and the other dense GQA/MHA configs)."""

    def __init__(self, cfg, device):
        super().__init__()
        if cfg.family != "dense" or cfg.attention != "full":
            raise NotImplementedError(
                f"the port builds dense full-attention decoders so far; "
                f"{cfg.arch_id!r} is family {cfg.family!r} with "
                f"{cfg.attention!r} attention")
        self.cfg = cfg
        self.embed = Embedding(cfg, device)
        self.final_norm = Norm(cfg, device)
        self.layers = nn.ModuleList(DenseBlock(cfg, device)
                                    for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return unembed(self.embed.tok, x, self.cfg, self.embed.unembed)

    def forward(self, tokens: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens (B,S) -> logits (B,S,V_pad); ``lengths`` masks padding
        keys as the reference's ``batch["lengths"]`` does."""
        x = embed(self.embed.tok, tokens, self.cfg)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        for blk in self.layers:
            x, _ = blk.prefill(x, positions=positions, kv_len=lengths)
        return self._logits(self.final_norm(x))

    def init_cache(self, batch: int, cache_len: int,
                   dtype: Optional[torch.dtype] = None) -> Cache:
        """Zeroed KV cache {"k", "v"} of shape (L, batch, cache_len, Hkv,
        D) in ``dtype`` (default: the compute dtype)."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        dtype = dtype or cdt(cfg)
        return {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device)}

    def prefill(self, tokens: torch.Tensor, lengths: torch.Tensor,
                cache: Cache, slots: Optional[torch.Tensor] = None,
                page_table: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Prefill right-padded prompts. tokens (B,S); lengths (B,) valid
        counts. Each layer's K/V for positions [0, S) is written in place:
        into the slot cache, row i into cache row ``slots[i]`` for i <
        len(slots) (rows past it are padding and write nothing), or into
        row i when ``slots`` is None; or, with ``page_table`` (B, n), into
        the paged pool through row i's table (padding rows' tables are all
        TRASH). Returns the logits at position ``lengths - 1``, (B, V_pad).
        """
        B, S = tokens.shape
        x = embed(self.embed.tok, tokens, self.cfg)
        positions = torch.arange(S, device=tokens.device)
        for i, blk in enumerate(self.layers):
            x, (k, v) = blk.prefill(x, positions=positions, kv_len=lengths)
            if page_table is None:
                merge_slots(cache["k"][i], k, slots)
                merge_slots(cache["v"][i], v, slots)
            else:
                attn._paged_write_span(cache["k"][i], k, page_table)
                attn._paged_write_span(cache["v"][i], v, page_table)
        x = self.final_norm(x)
        last = x[torch.arange(B, device=x.device),
                 torch.clamp(lengths.long() - 1, min=0)]
        return self._logits(last)

    def prefill_shared(self, tokens: torch.Tensor, lengths: torch.Tensor,
                       starts: torch.Tensor, cache: Cache,
                       page_table: torch.Tensor) -> torch.Tensor:
        """Tail-only prefill over the paged pool. ``tokens`` (B,Tb) holds
        prompt[starts:] per row; the pool already holds each row's first
        ``starts`` positions in the pages ``page_table`` (B, n) names (a
        partially shared boundary page copied into the row's own page
        beforehand). Each layer gathers the rows' views, attends the tail
        over them and writes the tail's K/V into the pages at positions
        [starts, starts + Tb), in place. Logits come from logical position
        ``lengths - 1``, which is tail index ``lengths - starts - 1``."""
        B, Tb = tokens.shape
        x = embed(self.embed.tok, tokens, self.cfg)
        positions = starts.long()[:, None] + torch.arange(
            Tb, device=tokens.device)[None, :]
        for i, blk in enumerate(self.layers):
            x, (k, v) = blk.prefill_shared(
                x, positions=positions, starts=starts, kv_len=lengths,
                view_k=attn._paged_gather(cache["k"][i], page_table),
                view_v=attn._paged_gather(cache["v"][i], page_table))
            attn._paged_write_span(cache["k"][i], k, page_table, starts)
            attn._paged_write_span(cache["v"][i], v, page_table, starts)
        x = self.final_norm(x)
        last = x[torch.arange(B, device=x.device),
                 torch.clamp(lengths.long() - starts.long() - 1, min=0)]
        return self._logits(last)

    def decode_step(self, tokens: torch.Tensor, lengths: torch.Tensor,
                    cache: Cache,
                    active: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One token per row. tokens (B,1) at position ``lengths``; the
        cache is written in place at ``min(lengths, S-1)`` for rows where
        ``active`` (default: all rows). Returns logits (B, V_pad)."""
        x = embed(self.embed.tok, tokens, self.cfg)
        for i, blk in enumerate(self.layers):
            x = blk.decode(x, lengths=lengths, cache_k=cache["k"][i],
                           cache_v=cache["v"][i], active=active)
        return self._logits(self.final_norm(x))[:, 0]

    def decode_paged(self, tokens: torch.Tensor, lengths: torch.Tensor,
                     cache: Cache, page_table: torch.Tensor,
                     active: torch.Tensor) -> torch.Tensor:
        """One token per row against the paged pool: tokens (B,1) at
        position ``lengths``, written through ``page_table`` (B, n), the
        one table every layer shares, for rows where ``active`` (inactive
        rows write into TRASH). Returns logits (B, V_pad)."""
        x = embed(self.embed.tok, tokens, self.cfg)
        for i, blk in enumerate(self.layers):
            x = blk.decode_paged(x, lengths=lengths, k_pages=cache["k"][i],
                                 v_pages=cache["v"][i],
                                 page_table=page_table, active=active)
        return self._logits(self.final_norm(x))[:, 0]
