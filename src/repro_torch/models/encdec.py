"""Whisper-style encoder-decoder (the audio family).

Port of ``repro.models.encdec.build_encdec`` as an ``nn.Module`` with the
``Transformer``'s interface. The conv/mel frontend is a stub, as in the
reference: the model takes precomputed frame embeddings ``frames`` (B,
encoder_seq_len, d_model) through ``extra`` (``models.registry.
extra_inputs``). The encoder's blocks are bidirectional self-attention
(RoPE over the frame positions) and a GELU MLP; each decoder block is
causal self-attention, cross-attention over the encoder's output, then
the MLP. Parameters follow the reference's paths: its stacked
``encoder`` and ``decoder`` leaves are ``encoder.{i}.*`` and
``decoder.{i}.*`` here (a decoder block's attentions are ``self`` and
``cross``).

The cache is one flat dict: ``"k"``, ``"v"`` (n_dec, slots, cache_len, H,
D), the decoder's self-attention, and ``"cross_k"``, ``"cross_v"``
(n_dec, slots, encoder_seq_len, H, D), the cross-attention's K/V of the
encoder's output, written for the wave's slots at prefill and read-only
at decode; the cross part does not grow with ``cache_len``. With
``cfg.use_kernels`` the encoder, the decoder's self-attention and the
cross-attention all run on the prefill and decode kernels. The model has
no ``decode_paged`` and no ``prefill_shared``: the engine keeps the slot
cache, as the reference's does.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.layers import cdt, embed, frontend_input
from repro_torch.models.sharding import remat
from repro_torch.models.transformer import (MLP, Attention, Embedding,
                                          LanguageModel, Norm,
                                          write_prefill)

Cache = Dict[str, torch.Tensor]


class EncoderBlock(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        self.ln1 = Norm(cfg, device)
        self.attn = Attention(cfg, device)
        self.ln2 = Norm(cfg, device)
        self.mlp = MLP(cfg, device)


class DecoderBlock(nn.Module):
    """Self-attention (``self``), cross-attention (``cross``, a K/V head
    per query head) and the MLP, each pre-normed."""

    def __init__(self, cfg, device):
        super().__init__()
        self.ln1 = Norm(cfg, device)
        setattr(self, "self", Attention(cfg, device))
        self.ln2 = Norm(cfg, device)
        self.cross = Attention(cfg, device, cross=True)
        self.ln3 = Norm(cfg, device)
        self.mlp = MLP(cfg, device)


class EncDec(LanguageModel):
    cache_names = ("k", "v")

    def __init__(self, cfg, device):
        super().__init__()
        if cfg.family != "audio" or not cfg.n_encoder_layers:
            raise NotImplementedError(
                f"EncDec builds the audio encoder-decoder family; "
                f"{cfg.arch_id!r} is family {cfg.family!r}")
        self.cfg = cfg
        self.embed = Embedding(cfg, device)
        self.enc_norm = Norm(cfg, device)
        self.final_norm = Norm(cfg, device)
        self.encoder = nn.ModuleList(EncoderBlock(cfg, device)
                                     for _ in range(cfg.n_encoder_layers))
        self.decoder = nn.ModuleList(DecoderBlock(cfg, device)
                                     for _ in range(cfg.n_layers))

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, T, d) -> the encoder's normed output (B, T, d)."""
        cfg = self.cfg
        x = frames.to(cdt(cfg))
        positions = torch.arange(x.shape[1], device=x.device)
        for blk in self.encoder:
            a, _ = attn.attend_prefill(blk.attn, blk.ln1(x), cfg,
                                       positions=positions, causal=False)
            x = x + a
            x = x + blk.mlp(blk.ln2(x))
        return self.enc_norm(x)

    def _dec_prefill(self, blk: DecoderBlock, x: torch.Tensor,
                     positions: torch.Tensor,
                     kv_len: Optional[torch.Tensor], enc: torch.Tensor):
        """One decoder block over a whole sequence: (x, its self K/V, its
        cross K/V of ``enc``)."""
        cfg = self.cfg
        a, kv = attn.attend_prefill(getattr(blk, "self"), blk.ln1(x), cfg,
                                    positions=positions, kv_len=kv_len)
        x = x + a
        mem = attn.project_memory_kv(blk.cross, enc, cfg)
        x = x + attn.attend_cached_memory(blk.cross, blk.ln2(x), cfg, *mem)
        return x + blk.mlp(blk.ln3(x)), kv, mem

    def forward_hidden(self, tokens: torch.Tensor,
                       lengths: Optional[torch.Tensor] = None,
                       extra: Optional[Dict] = None, train: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) and ``extra["frames"]`` -> (the final-normed
        decoder states (B, S, d), an f32 zero). ``lengths`` masks padding
        keys of the self-attention. With ``train`` and ``cfg.remat`` not
        "none" each decoder block runs under ``torch.utils.checkpoint``,
        as the reference wraps its decoder body."""
        enc = self.encode(frontend_input(extra, "frames", self.cfg))
        x = embed(self.embed.tok, tokens, self.cfg)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        use_remat = train and self.cfg.remat != "none"
        for blk in self.decoder:
            def body(x, blk=blk):
                return self._dec_prefill(blk, x, positions, lengths, enc)[0]
            x = remat(body, x) if use_remat else body(x)
        return (self.final_norm(x),
                torch.zeros((), dtype=torch.float32, device=x.device))

    def forward(self, tokens: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                extra: Optional[Dict] = None) -> torch.Tensor:
        """tokens (B, S), ``extra["frames"]`` -> logits (B, S, V_pad)."""
        return self._logits(self.forward_hidden(tokens, lengths, extra)[0])

    def init_cache(self, batch: int, cache_len: int,
                   dtype: Optional[torch.dtype] = None,
                   device=None) -> Cache:
        """Zeroed cache in ``dtype`` (default the compute dtype) on
        ``device`` (default the model's): the self-attention's K/V of
        ``cache_len`` positions and the cross K/V of encoder_seq_len."""
        cfg = self.cfg
        dtype = dtype or cdt(cfg)
        hd = cfg.resolved_head_dim
        self_kv = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, hd)
        cross = (cfg.n_layers, batch, cfg.encoder_seq_len, cfg.n_heads, hd)
        return self._zeros({"k": (self_kv, dtype), "v": (self_kv, dtype),
                            "cross_k": (cross, dtype),
                            "cross_v": (cross, dtype)}, device)

    def prefill(self, tokens: torch.Tensor, lengths: torch.Tensor,
                cache: Cache, slots: Optional[torch.Tensor] = None,
                extra: Optional[Dict] = None) -> torch.Tensor:
        """Prefill right-padded prompts. tokens (B, S); lengths (B,);
        ``extra["frames"]`` (B, T, d): row i's frames. Encodes the frames,
        then writes row i's self K/V at positions [0, S) and its whole
        cross K/V into cache row ``slots[i]`` for i < len(slots) (row i
        when ``slots`` is None; rows past it are padding and write
        nothing). Returns the logits at ``lengths - 1``, (B, V_pad)."""
        S = tokens.shape[1]
        enc = self.encode(frontend_input(extra, "frames", self.cfg))
        x = embed(self.embed.tok, tokens, self.cfg)
        positions = torch.arange(S, device=tokens.device)
        for i, blk in enumerate(self.decoder):
            x, (k, v), (mk, mv) = self._dec_prefill(blk, x, positions,
                                                    lengths, enc)
            write_prefill(cache["k"][i], k, slots)
            write_prefill(cache["v"][i], v, slots)
            write_prefill(cache["cross_k"][i], mk, slots, seq=False)
            write_prefill(cache["cross_v"][i], mv, slots, seq=False)
        return self._last_logits(x, lengths)

    def decode_step(self, tokens: torch.Tensor, lengths: torch.Tensor,
                    cache: Cache,
                    active: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One token per row: tokens (B, 1) at position ``lengths``. Rows
        where ``active`` (default: all) write their self K/V at
        ``min(lengths, S-1)``; the cross K/V are only read. Returns logits
        (B, V_pad)."""
        cfg = self.cfg
        x = embed(self.embed.tok, tokens, cfg)
        for i, blk in enumerate(self.decoder):
            x = x + attn.attend_decode(
                getattr(blk, "self"), blk.ln1(x), cfg, cache_k=cache["k"][i],
                cache_v=cache["v"][i], lengths=lengths, active=active)
            x = x + attn.attend_cached_memory(
                blk.cross, blk.ln2(x), cfg, cache["cross_k"][i],
                cache["cross_v"][i], active=active)
            x = x + blk.mlp(blk.ln3(x))
        return self._step_logits(x)
