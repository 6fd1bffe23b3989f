"""xLSTM: groups of [sLSTM, mLSTM x (g - 1)] blocks.

Port of ``repro.models.xlstm.build_xlstm`` as an ``nn.Module`` with the
``Transformer``'s interface (``forward_hidden``, ``forward``,
``init_cache``, ``prefill``, ``decode_step``). Each of the ``n_groups =
n_layers // slstm_every`` groups runs one pre-norm residual sLSTM block,
then ``slstm_every - 1`` pre-norm residual mLSTM blocks. Parameters follow
the reference's paths: its ``slstm`` leaves (stacked (G, ...)) are
``slstm.{g}.*`` here, its ``mlstm`` leaves (stacked (G, n_m, ...)) are
``mlstm.{g * n_m + i}.*``.

All state is O(1) per sequence and nothing has a sequence axis: the cache
is one flat dict, ``"slstm_h"`` (G, slots, d) in the cache dtype,
``"slstm_c"``, ``"slstm_n"`` (G, slots, d) f32 and ``"mlstm"`` (G * n_m,
slots, H, hd, hd + 1) f32, the reference's tree with its two stacked axes
of the mLSTM state flattened to one; a prefill writes whole rows.
Right-padded prompts are exact: a padding step leaves every state as the
row's last valid step left it (``ssm.mlstm_prefill``,
``ssm.slstm_forward``). No kernel runs: the reference's mLSTM prefill is
its chunked XLA path and the sLSTM a time loop, and the port keeps both
in torch. The model has no ``decode_paged`` and no ``prefill_shared``, so
the engine keeps the slot cache, as the reference's does.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import ssm
from repro_torch.models.layers import cdt, embed
from repro_torch.models.sharding import remat
from repro_torch.models.transformer import (Embedding, LanguageModel, Norm,
                                          write_prefill)
from repro_torch.serving.kvcache import select_slots

Cache = Dict[str, torch.Tensor]

SLSTM_LEAVES = ("h", "c", "n")


class _Residual(nn.Module):
    """A pre-norm residual block's weights: ``ln`` and its ``core``."""

    def __init__(self, cfg, device, core):
        super().__init__()
        self.ln = Norm(cfg, device)
        self.core = core(cfg, device)


class XLSTM(LanguageModel):
    """xLSTM-350M's family: sLSTM and mLSTM blocks, no attention."""

    cache_names = ("slstm_h",)

    def __init__(self, cfg, device):
        super().__init__()
        if cfg.family != "ssm" or not cfg.ssm.slstm_every:
            raise NotImplementedError(
                f"XLSTM builds the sLSTM + mLSTM family; {cfg.arch_id!r} "
                f"is family {cfg.family!r}")
        self.cfg = cfg
        self.every = cfg.ssm.slstm_every
        self.n_groups = cfg.n_layers // self.every
        self.n_m = self.every - 1
        self.embed = Embedding(cfg, device)
        self.final_norm = Norm(cfg, device)
        self.slstm = nn.ModuleList(_Residual(cfg, device, ssm.SLSTM)
                                   for _ in range(self.n_groups))
        self.mlstm = nn.ModuleList(_Residual(cfg, device, ssm.MLSTM)
                                   for _ in range(self.n_groups * self.n_m))

    def _group(self, g: int, x: torch.Tensor, valid: Optional[torch.Tensor],
               want_state: bool) -> Tuple[torch.Tensor, Optional[Cache],
                                          list]:
        """Group ``g`` over a whole sequence: (x, the sLSTM's state, the
        mLSTMs' states) (the states None unless ``want_state``)."""
        blk = self.slstm[g]
        y, s_state = ssm.slstm_forward(blk.core, blk.ln(x), self.cfg,
                                       return_state=want_state, valid=valid)
        x = x + y
        m_states = []
        for i in range(self.n_m):
            blk = self.mlstm[g * self.n_m + i]
            y, st = ssm.mlstm_prefill(blk.core, blk.ln(x), self.cfg,
                                      return_state=want_state, valid=valid)
            x = x + y
            m_states.append(st)
        return x, s_state, m_states

    def _valid(self, tokens: torch.Tensor,
               lengths: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        if lengths is None:
            return None
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        return pos[None, :] < lengths.long()[:, None]

    def forward_hidden(self, tokens: torch.Tensor,
                       lengths: Optional[torch.Tensor] = None,
                       extra: Optional[Dict] = None, train: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) -> (the final-normed hidden states (B, S, d), an
        f32 zero: xLSTM has no auxiliary loss). ``lengths`` makes padding
        steps state no-ops, as the reference's ``batch["lengths"]`` does.
        With ``train`` and ``cfg.remat`` in ("block", "full") each group
        runs under ``torch.utils.checkpoint``, as the reference wraps its
        group body. ``extra`` is unused: every family shares this
        signature."""
        x = embed(self.embed.tok, tokens, self.cfg)
        valid = self._valid(tokens, lengths)
        use_remat = train and self.cfg.remat in ("block", "full")
        for g in range(self.n_groups):
            if use_remat:
                x = remat(lambda x, g=g: self._group(g, x, valid, False)[0],
                          x)
            else:
                x = self._group(g, x, valid, False)[0]
        return (self.final_norm(x),
                torch.zeros((), dtype=torch.float32, device=x.device))

    def forward(self, tokens: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, V_pad)."""
        return self._logits(self.forward_hidden(tokens, lengths)[0])

    def init_cache(self, batch: int, cache_len: int,
                   dtype: Optional[torch.dtype] = None,
                   device=None) -> Cache:
        """Zeroed state for ``batch`` slots on ``device`` (default: the
        model's): the sLSTM's h in ``dtype`` (default the compute dtype),
        its c and n and the mLSTM states in f32. ``cache_len`` sizes
        nothing: the state does not grow with the context."""
        cfg = self.cfg
        leaves = {f"slstm_{n}": ((self.n_groups,) + t.shape, t.dtype)
                  for n, t in ssm.slstm_init_cache(
                      cfg, batch, dtype or cdt(cfg), "meta").items()}
        st = ssm.mlstm_init_cache(cfg, batch, "meta")["state"]
        leaves["mlstm"] = ((self.n_groups * self.n_m,) + st.shape, st.dtype)
        return self._zeros(leaves, device)

    def prefill(self, tokens: torch.Tensor, lengths: torch.Tensor,
                cache: Cache,
                slots: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Prefill right-padded prompts. tokens (B, S); lengths (B,) valid
        counts. Row i's states go to cache row ``slots[i]`` for i <
        len(slots) (rows past it are padding and write nothing), or to row
        i when ``slots`` is None. Returns the logits at ``lengths - 1``,
        (B, V_pad)."""
        x = embed(self.embed.tok, tokens, self.cfg)
        valid = self._valid(tokens, lengths)
        for g in range(self.n_groups):
            x, s_state, m_states = self._group(g, x, valid, True)
            for n in SLSTM_LEAVES:
                write_prefill(cache[f"slstm_{n}"][g], s_state[n], slots,
                            seq=False)
            for i, st in enumerate(m_states):
                write_prefill(cache["mlstm"][g * self.n_m + i], st["state"],
                            slots, seq=False)
        return self._last_logits(x, lengths)

    def decode_step(self, tokens: torch.Tensor, lengths: torch.Tensor,
                    cache: Cache,
                    active: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One token per row: tokens (B, 1). Rows where ``active``
        (default: all) advance their states in place; the others keep
        theirs bit for bit. ``lengths`` is not read: the state carries the
        position. Returns logits (B, V_pad)."""
        x = embed(self.embed.tok, tokens, self.cfg)

        def keep(old: torch.Tensor, new: torch.Tensor) -> None:
            old.copy_(new if active is None
                      else select_slots(old, new, active))

        for g in range(self.n_groups):
            blk = self.slstm[g]
            old = {n: cache[f"slstm_{n}"][g] for n in SLSTM_LEAVES}
            y, new = ssm.slstm_forward(blk.core, blk.ln(x), self.cfg,
                                       cache=old)
            x = x + y
            for n in SLSTM_LEAVES:
                keep(old[n], new[n])
            for i in range(self.n_m):
                j = g * self.n_m + i
                blk = self.mlstm[j]
                y, new = ssm.mlstm_decode(blk.core, blk.ln(x), self.cfg,
                                          {"state": cache["mlstm"][j]})
                x = x + y
                keep(cache["mlstm"][j], new["state"])
        return self._step_logits(x)
