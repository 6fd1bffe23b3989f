"""Zamba2-style hybrid: a Mamba2 backbone and ONE shared attention block.

Port of ``repro.models.hybrid.build_hybrid`` as an ``nn.Module``. Layer
pattern (every = ``cfg.shared_attn_every``)::

    [shared] m m m m m m  [shared] m m m m m m ... then the tail mambas

The shared attention + MLP block is one set of weights, the port's
``Block``, applied before each group of ``every`` Mamba2 layers; each
application keeps its own K/V. The Mamba2 layers are a ``ModuleList`` of
(norm, mixer) pairs: the reference's ``groups`` leaves (stacked (n_groups,
every, ...)) and ``tail`` leaves (stacked (tail, ...)) are layers
``g * every + i`` and ``n_groups * every + i`` here. As in the reference,
the shared block reads the current hidden state (not concat(hidden,
embedding)) and the per-application LoRA deltas are left out.

The cache is one flat dict, so the engine's demote and restore move it
leaf by leaf with each leaf's own dtype: ``"k"``, ``"v"`` (n_groups,
slots, cache_len, Hkv, D) in the cache dtype, ``"ssm"`` (n_layers, slots,
H, N, P) in f32, and ``"conv_x"``, ``"conv_bc"`` (n_layers, slots, K-1,
C) in the cache dtype. The state leaves have no sequence axis: a prefill
writes their whole rows. The model has no ``decode_paged`` and no
``prefill_shared``, as the reference's hybrid has neither: the engine
keeps the slot cache.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import ssm
from repro_torch.models.layers import cdt, embed
from repro_torch.models.sharding import remat
from repro_torch.models.transformer import (Block, Embedding, LanguageModel,
                                          Norm, write_prefill)
from repro_torch.serving.kvcache import select_slots

Cache = Dict[str, torch.Tensor]

STATE_LEAVES = ("ssm", "conv_x", "conv_bc")


def _counts(cfg) -> Tuple[int, int, int]:
    every = cfg.shared_attn_every
    n_groups = cfg.n_layers // every
    return every, n_groups, cfg.n_layers - n_groups * every


class MambaLayer(nn.Module):
    """A pre-norm residual Mamba2 layer: ``x + mamba(ln(x))``."""

    def __init__(self, cfg, device):
        super().__init__()
        self.ln = Norm(cfg, device)
        self.mamba = ssm.Mamba2(cfg, device)


class Hybrid(LanguageModel):
    """The Zamba2 hybrid with the ``Transformer``'s interface
    (``forward_hidden``, ``forward``, ``init_cache``, ``prefill``,
    ``decode_step``); the cache is updated in place."""

    cache_names = ("k", "v")

    def __init__(self, cfg, device):
        super().__init__()
        if cfg.family != "hybrid" or not cfg.shared_attn_every \
                or cfg.attention != "full":
            raise NotImplementedError(
                f"Hybrid builds the Mamba2 + shared full-attention family; "
                f"{cfg.arch_id!r} is family {cfg.family!r}")
        self.cfg = cfg
        self.every, self.n_groups, self.tail = _counts(cfg)
        self.embed = Embedding(cfg, device)
        self.final_norm = Norm(cfg, device)
        self.shared_block = Block(cfg, device)
        self.layers = nn.ModuleList(MambaLayer(cfg, device)
                                    for _ in range(cfg.n_layers))

    def _schedule(self) -> Iterator[Tuple[str, int]]:
        """The run order: ("attn", g) before each group of ``every`` Mamba2
        layers ("mamba", layer index), then the tail layers."""
        for g in range(self.n_groups):
            yield "attn", g
            for i in range(self.every):
                yield "mamba", g * self.every + i
        for i in range(self.tail):
            yield "mamba", self.n_groups * self.every + i

    def _mamba_prefill(self, i: int, x: torch.Tensor,
                       valid: Optional[torch.Tensor], want_state: bool):
        lyr = self.layers[i]
        y, st = ssm.mamba2_prefill(lyr.mamba, lyr.ln(x), self.cfg,
                                   return_state=want_state, valid=valid)
        return x + y, st

    def _group(self, g: int, x: torch.Tensor, positions: torch.Tensor,
               lengths: Optional[torch.Tensor],
               valid: Optional[torch.Tensor]) -> torch.Tensor:
        """Group ``g``: the shared block, then its ``every`` Mamba2
        layers (the reference's ``group_body``)."""
        x = self.shared_block.prefill(x, positions=positions,
                                      kv_len=lengths)[0]
        for i in range(self.every):
            x = self._mamba_prefill(g * self.every + i, x, valid, False)[0]
        return x

    def forward_hidden(self, tokens: torch.Tensor,
                       lengths: Optional[torch.Tensor] = None,
                       extra: Optional[Dict] = None, train: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) -> (the final-normed hidden states (B, S, d), an
        f32 zero: the hybrid has no auxiliary loss). ``lengths`` masks
        padding keys in the shared block and makes padding steps no-ops in
        the Mamba2 layers, as the reference's ``batch["lengths"]`` does.
        With ``train`` and ``cfg.remat`` in ("block", "full"), each group
        (the shared block and its Mamba2 layers; not the tail) runs under
        ``torch.utils.checkpoint``, as the reference wraps its
        ``group_body``. ``extra`` is unused: every family shares this
        signature."""
        x = embed(self.embed.tok, tokens, self.cfg)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        valid = (None if lengths is None
                 else positions[None, :] < lengths[:, None])
        use_remat = train and self.cfg.remat in ("block", "full")
        for g in range(self.n_groups):
            if use_remat:
                x = remat(self._group, g, x, positions, lengths, valid)
            else:
                x = self._group(g, x, positions, lengths, valid)
        for i in range(self.tail):
            x = self._mamba_prefill(self.n_groups * self.every + i, x,
                                    valid, False)[0]
        return (self.final_norm(x),
                torch.zeros((), dtype=torch.float32, device=x.device))

    def forward(self, tokens: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, V_pad) (``forward_hidden``'s
        hidden states unembedded)."""
        return self._logits(self.forward_hidden(tokens, lengths)[0])

    def init_cache(self, batch: int, cache_len: int,
                   dtype: Optional[torch.dtype] = None,
                   device=None) -> Cache:
        """Zeroed cache on ``device`` (default: the model's): K/V of every
        shared-block application and every Mamba2 layer's states (the SSM
        state in f32, the rest in ``dtype``, default the compute dtype)."""
        cfg = self.cfg
        dtype = dtype or cdt(cfg)
        kv = (self.n_groups, batch, cache_len, cfg.n_kv_heads,
              cfg.resolved_head_dim)
        leaves = {n: (kv, dtype) for n in self.cache_names}
        for n, t in ssm.mamba2_init_cache(cfg, batch, dtype,
                                          "meta").items():
            leaves[n] = ((cfg.n_layers,) + t.shape, t.dtype)
        return self._zeros(leaves, device)

    def prefill(self, tokens: torch.Tensor, lengths: torch.Tensor,
                cache: Cache,
                slots: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Prefill right-padded prompts. tokens (B, S); lengths (B,) valid
        counts. Row i goes to cache row ``slots[i]`` for i < len(slots)
        (rows past it are padding and write nothing), or to row i when
        ``slots`` is None: the shared block's K/V at positions [0, S), the
        Mamba2 states whole. Returns the logits at ``lengths - 1``, (B,
        V_pad)."""
        S = tokens.shape[1]
        x = embed(self.embed.tok, tokens, self.cfg)
        positions = torch.arange(S, device=tokens.device)
        valid = positions[None, :] < lengths[:, None]
        for kind, i in self._schedule():
            if kind == "attn":
                x, kv, _ = self.shared_block.prefill(
                    x, positions=positions, kv_len=lengths)
                for n, src in zip(self.cache_names, kv):
                    write_prefill(cache[n][i], src, slots)
            else:
                x, st = self._mamba_prefill(i, x, valid, True)
                for n in STATE_LEAVES:
                    write_prefill(cache[n][i], st[n], slots, seq=False)
        return self._last_logits(x, lengths)

    def decode_step(self, tokens: torch.Tensor, lengths: torch.Tensor,
                    cache: Cache,
                    active: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One token per row. tokens (B, 1) at position ``lengths``. Rows
        where ``active`` (default: all) write their K/V at
        ``min(lengths, S-1)`` and advance their Mamba2 states; the other
        rows' cache stays bit for bit. Returns logits (B, V_pad)."""
        x = embed(self.embed.tok, tokens, self.cfg)
        for kind, i in self._schedule():
            if kind == "attn":
                x = self.shared_block.decode(
                    x, lengths=lengths,
                    kv=tuple(cache[n][i] for n in self.cache_names),
                    active=active)
                continue
            lyr = self.layers[i]
            old = {n: cache[n][i] for n in STATE_LEAVES}
            y, new = ssm.mamba2_decode(lyr.mamba, lyr.ln(x), self.cfg, old)
            x = x + y
            for n in STATE_LEAVES:
                old[n].copy_(new[n] if active is None
                             else select_slots(old[n], new[n], active))
        return self._step_logits(x)
