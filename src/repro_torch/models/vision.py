"""Llama-3.2-Vision-style VLM: a text decoder with gated cross-attention
image layers before every ``cross_attn_every`` self-attention layers.

Port of ``repro.models.vision.build_vlm`` as an ``nn.Module`` with the
``Transformer``'s interface. The vision tower is a stub, as in the
reference: the model takes precomputed patch embeddings ``patches`` (B,
vision_tokens, vision_dim) through ``extra`` (``models.registry.
extra_inputs``); each cross block projects its K/V straight from them.
Group g is cross block g, then self-attention layers ``g * every`` ..
``g * every + every - 1`` (the port's dense ``Block``). A cross block adds
``tanh(gate_attn)`` x its cross-attention and ``tanh(gate_mlp)`` x its
MLP; both gates are zero at init, as in the released model, so a fresh
model's cross blocks add nothing. Parameters follow the reference's
paths: its ``self_groups`` leaves (stacked (G, every, ...)) are
``self_groups.{g * every + i}.*`` here, its ``cross`` leaves (stacked
(G, ...)) ``cross.{g}.*``.

The cache is one flat dict: ``"k"``, ``"v"`` (n_layers, slots, cache_len,
Hkv, D), the self-attention layers in the order they run, and
``"cross_k"``, ``"cross_v"`` (G, slots, vision_tokens, Hkv, D), the cross
blocks' K/V of the patches, written for the wave's slots at prefill and
read-only at decode. With ``cfg.use_kernels`` self- and cross-attention
run on the prefill and decode kernels. The model has no ``decode_paged``
and no ``prefill_shared``: the engine keeps the slot cache, as the
reference's does.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.layers import cdt, embed, frontend_input
from repro_torch.models.sharding import remat
from repro_torch.models.transformer import (MLP, Attention, Block, Embedding,
                                            LanguageModel, Norm, _param,
                                            write_prefill)

Cache = Dict[str, torch.Tensor]


class CrossBlock(nn.Module):
    """A gated cross-attention image block: ``ln1``, ``xattn`` (K/V from
    ``vision_dim``), the f32 scalar ``gate_attn``, ``ln2``, ``mlp`` and
    the f32 scalar ``gate_mlp``."""

    def __init__(self, cfg, device):
        super().__init__()
        self.ln1 = Norm(cfg, device)
        self.xattn = Attention(cfg, device, cross=True)
        self.gate_attn = _param(dtype=torch.float32, device=device)
        self.ln2 = Norm(cfg, device)
        self.mlp = MLP(cfg, device)
        self.gate_mlp = _param(dtype=torch.float32, device=device)


class Vision(LanguageModel):
    cache_names = ("k", "v")

    def __init__(self, cfg, device):
        super().__init__()
        if cfg.family != "vlm" or not cfg.cross_attn_every:
            raise NotImplementedError(
                f"Vision builds the cross-attention VLM family; "
                f"{cfg.arch_id!r} is family {cfg.family!r}")
        self.cfg = cfg
        self.every = cfg.cross_attn_every
        self.n_groups = cfg.n_layers // self.every
        self.embed = Embedding(cfg, device)
        self.final_norm = Norm(cfg, device)
        self.self_groups = nn.ModuleList(
            Block(cfg, device) for _ in range(self.n_groups * self.every))
        self.cross = nn.ModuleList(CrossBlock(cfg, device)
                                   for _ in range(self.n_groups))

    def _cross_block(self, g: int, x: torch.Tensor, mem_k: torch.Tensor,
                     mem_v: torch.Tensor,
                     active: Optional[torch.Tensor] = None) -> torch.Tensor:
        cp = self.cross[g]
        a = attn.attend_cached_memory(cp.xattn, cp.ln1(x), self.cfg, mem_k,
                                      mem_v, active=active)
        x = x + torch.tanh(cp.gate_attn).to(x.dtype) * a
        return x + torch.tanh(cp.gate_mlp).to(x.dtype) * cp.mlp(cp.ln2(x))

    def _group_prefill(self, g: int, x: torch.Tensor, positions, kv_len,
                       patches: torch.Tensor):
        """Group ``g`` over a whole sequence: (x, the cross K/V, the self
        layers' K/V)."""
        mem = attn.project_memory_kv(self.cross[g].xattn, patches, self.cfg)
        x = self._cross_block(g, x, *mem)
        kvs = []
        for i in range(self.every):
            x, kv, _ = self.self_groups[g * self.every + i].prefill(
                x, positions=positions, kv_len=kv_len)
            kvs.append(kv)
        return x, mem, kvs

    def forward_hidden(self, tokens: torch.Tensor,
                       lengths: Optional[torch.Tensor] = None,
                       extra: Optional[Dict] = None, train: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) and ``extra["patches"]`` -> (the final-normed
        hidden states (B, S, d), an f32 zero). ``lengths`` masks padding
        keys. With ``train`` and ``cfg.remat`` not "none" each group (its
        cross block and self layers) runs under
        ``torch.utils.checkpoint``, as the reference wraps its group
        body."""
        patches = frontend_input(extra, "patches", self.cfg)
        x = embed(self.embed.tok, tokens, self.cfg)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        use_remat = train and self.cfg.remat != "none"
        for g in range(self.n_groups):
            def body(x, g=g):
                return self._group_prefill(g, x, positions, lengths,
                                           patches)[0]
            x = remat(body, x) if use_remat else body(x)
        return (self.final_norm(x),
                torch.zeros((), dtype=torch.float32, device=x.device))

    def forward(self, tokens: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                extra: Optional[Dict] = None) -> torch.Tensor:
        """tokens (B, S), ``extra["patches"]`` -> logits (B, S, V_pad)."""
        return self._logits(self.forward_hidden(tokens, lengths, extra)[0])

    def init_cache(self, batch: int, cache_len: int,
                   dtype: Optional[torch.dtype] = None,
                   device=None) -> Cache:
        """Zeroed cache in ``dtype`` (default the compute dtype) on
        ``device`` (default the model's): the self layers' K/V of
        ``cache_len`` positions and the cross K/V of vision_tokens."""
        cfg = self.cfg
        dtype = dtype or cdt(cfg)
        hd = cfg.resolved_head_dim
        self_kv = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, hd)
        cross = (self.n_groups, batch, cfg.vision_tokens, cfg.n_kv_heads,
                 hd)
        return self._zeros({"k": (self_kv, dtype), "v": (self_kv, dtype),
                            "cross_k": (cross, dtype),
                            "cross_v": (cross, dtype)}, device)

    def prefill(self, tokens: torch.Tensor, lengths: torch.Tensor,
                cache: Cache, slots: Optional[torch.Tensor] = None,
                extra: Optional[Dict] = None) -> torch.Tensor:
        """Prefill right-padded prompts. tokens (B, S); lengths (B,);
        ``extra["patches"]`` (B, vision_tokens, vision_dim): row i's
        patches. Row i's self K/V at positions [0, S) and its whole cross
        K/V go to cache row ``slots[i]`` for i < len(slots) (row i when
        ``slots`` is None; rows past it are padding and write nothing).
        Returns the logits at ``lengths - 1``, (B, V_pad)."""
        S = tokens.shape[1]
        patches = frontend_input(extra, "patches", self.cfg)
        x = embed(self.embed.tok, tokens, self.cfg)
        positions = torch.arange(S, device=tokens.device)
        for g in range(self.n_groups):
            x, (mk, mv), kvs = self._group_prefill(g, x, positions, lengths,
                                                   patches)
            write_prefill(cache["cross_k"][g], mk, slots, seq=False)
            write_prefill(cache["cross_v"][g], mv, slots, seq=False)
            for i, (k, v) in enumerate(kvs):
                write_prefill(cache["k"][g * self.every + i], k, slots)
                write_prefill(cache["v"][g * self.every + i], v, slots)
        return self._last_logits(x, lengths)

    def decode_step(self, tokens: torch.Tensor, lengths: torch.Tensor,
                    cache: Cache,
                    active: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One token per row: tokens (B, 1) at position ``lengths``. Rows
        where ``active`` (default: all) write their self K/V at
        ``min(lengths, S-1)``; the cross K/V are only read. Returns logits
        (B, V_pad)."""
        x = embed(self.embed.tok, tokens, self.cfg)
        for g in range(self.n_groups):
            x = self._cross_block(g, x, cache["cross_k"][g],
                                  cache["cross_v"][g], active=active)
            for i in range(self.every):
                j = g * self.every + i
                x = self.self_groups[j].decode(
                    x, lengths=lengths, kv=(cache["k"][j], cache["v"][j]),
                    active=active)
        return self._step_logits(x)
