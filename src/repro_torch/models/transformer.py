"""Decoder-only transformer: the dense family (full or sliding-window
attention) and the MoE family, with DeepSeek's Multi-head Latent
Attention or GQA.

Port of ``repro.models.transformer.build_decoder`` for ``family="dense"``
(GQA/MHA attention, full or with a sliding window, dense MLPs) and
``family="moe"`` with MLA attention (DeepSeek-V2-Lite) or GQA with
qk-norm (Qwen3-MoE, planned on a mesh, never allocated whole), as
``nn.Module``s. ``Transformer`` has the methods of
the reference's ``Model`` record: ``init_cache``, ``forward``, ``prefill``,
``prefill_shared``, ``decode_step`` and ``decode_paged`` (``init`` is
``repro_torch.weights.init_params``). Layers are ``ModuleList``s instead of
a stacked scan; parameter names follow the reference's pytree paths
(``layers.{i}.attn.wq`` is ``layers/attn/wq[i]``, ``dense0.0.mlp.up`` is
``dense0[0]/mlp/up``). A MoE config's leading dense layers
(``moe.first_dense_layers``, d_ff ``moe.dense_d_ff``) are ``dense0`` and
run first, then the MoE blocks of ``layers``.

The KV cache holds one tensor per cache leaf, stacked over all layers in
the order they run (the reference's ``{"dense0": [...], "layers": ...}``
flattened to one layer axis): ``{"k", "v"}`` of shape (L, B, S, Hkv, D)
for GQA/MHA, ``{"ckv": (L, B, S, R), "krope": (L, B, S, dr)}`` (the
compressed latent and the shared rope key) for MLA. A sliding-window
model's K/V are ring buffers of ``min(cache_len, window)`` positions
(``attention.attend_decode``). The paged pool is the same dict built as
``init_cache(num_pages + 1, page_size)``, pages where the slots were. The
methods update the cache in place and return only the logits, where the
reference returned a new cache. Parameters are built
frozen (``requires_grad=False``): a model that trains turns them on
(``repro_torch.train.trainable``), a serving model never does.

``prefill_shared`` (tail-only prefill for prefix sharing) is None for MoE,
MLA or sliding-window models, as the reference's ``Model.prefill_shared``
is: MLA latents recompress and MoE routing is sequence-dependent, so a
tail-only prefill could diverge from a whole one, and ring buffers do not
page. ``decode_paged`` is None for sliding-window models likewise, so the
engine keeps them on the slot cache.

Under a mesh (``models.sharding``) the methods run on DTensor parameters,
inputs and caches (``launch.steps`` places them). The cache is still
written in place: a prefill's rows by ``write_prefill`` and a decode's by
the attention cores, each rank into its own rows, inside
``sharding.local``; ``shard_kv_cache`` gives the placement the reference
constrains a layer's cache to. Each row's last hidden state is picked
locally too (``_last_logits``). MoE layers take the reference's capacity
factors: the config's in ``forward_hidden``, 2.0 in ``prefill`` and the
decode steps (only the expert-parallel path reads them).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import sharding
from repro_torch.models.sharding import remat, shard
from repro_torch.models.layers import (apply_mlp, apply_norm, cdt, embed,
                                       pdt, row_invariant_linears, unembed)
from repro_torch.serving.kvcache import merge_slots

Cache = Dict[str, torch.Tensor]


def _window(cfg) -> int:
    """The attention window of every layer: ``cfg.sliding_window`` for the
    sliding-window family, else 0 (full attention)."""
    return cfg.sliding_window if cfg.attention == "sliding_window" else 0


def shard_kv_cache(kv):
    """The reference's constraint on one layer's cache leaves: each placed
    (batch, kv_seq, -...). The port writes caches in place, so a leaf must
    lie so already (``launch.sharding.cache_specs`` places a cell's cache
    alike): placing it here would write into a copy, which is refused."""
    for c in kv:
        if sharding.shard(c, "batch", "kv_seq",
                          *([None] * (c.dim() - 2))) is not c:
            raise ValueError(
                f"a cache leaf placed {c.placements} where the rules place "
                f"it (batch, kv_seq, ...): place the cache by "
                f"launch.sharding.cache_specs; its writes are in place")
    return kv


def write_prefill(dst: torch.Tensor, src: torch.Tensor,
                  slots: Optional[torch.Tensor] = None,
                  seq: bool = True) -> None:
    """``kvcache.merge_slots`` (a prefill's rows into the cache, in place)
    that also runs under a mesh: each rank writes its own rows of a
    batch-sharded cache. Under a mesh the rows go to rows 0..n-1 (the step
    builders' whole-batch prefill); slot lists are the engine's, which
    never runs under one."""
    if not sharding.active():
        merge_slots(dst, src, slots, seq)
        return
    if slots is not None:
        raise ValueError("write_prefill: slots are the engine's; under a "
                         "mesh the prefill writes its rows in order")
    d_axes = ("batch",) + (None,) * (dst.dim() - 1)
    s_axes = ("batch",) + (None,) * (src.dim() - 1)
    d = shard(dst, *d_axes)
    sharding.local(lambda d, s: merge_slots(d, s, None, seq),
                   (d_axes, s_axes), ())(d, src)
    sharding.write_back(dst, d)


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


def kv_shape(cfg, cross: bool = False) -> Tuple[int, int]:
    """(K/V input width, K/V heads) of ``init_attention``: a cross
    attention's K/V read the vision frontend's ``vision_dim`` when the
    config has one, and an audio model's cross attention has a K/V head
    per query head."""
    n_kv = cfg.n_heads if cross and cfg.family == "audio" else cfg.n_kv_heads
    return (cfg.vision_dim if cross and cfg.vision_dim else cfg.d_model), n_kv


class Attention(nn.Module):
    """GQA/MHA weights in ``init_attention``'s layouts; ``cross`` gives the
    cross-attention shapes (``kv_shape``)."""

    def __init__(self, cfg, device, cross: bool = False):
        super().__init__()
        d, hd, dt = cfg.d_model, cfg.resolved_head_dim, pdt(cfg)
        kv_in, n_kv = kv_shape(cfg, cross)
        self.wq = _param(d, cfg.n_heads, hd, dtype=dt, device=device)
        self.wk = _param(kv_in, n_kv, hd, dtype=dt, device=device)
        self.wv = _param(kv_in, n_kv, hd, dtype=dt, device=device)
        self.wo = _param(cfg.n_heads, hd, d, dtype=dt, device=device)
        if cfg.qk_norm:
            self.q_norm = _param(hd, dtype=dt, device=device)
            self.k_norm = _param(hd, dtype=dt, device=device)


class MLAAttention(nn.Module):
    """DeepSeek MLA weights in ``init_mla``'s layouts: ``wq`` (d, H, dn+dr)
    (or ``w_dq`` (d, q_lora) and ``w_uq`` (q_lora, H, dn+dr)), the joint
    down-projection ``w_dkv`` (d, R+dr), the up-projections ``w_uk``
    (R, H, dn) and ``w_uv`` (R, H, dv), ``wo`` (H, dv, d) and the latent's
    RMSNorm scale ``kv_norm`` (R,)."""

    def __init__(self, cfg, device):
        super().__init__()
        m, d, H, dt = cfg.mla, cfg.d_model, cfg.n_heads, pdt(cfg)
        q_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
        if m.q_lora_rank:
            self.w_dq = _param(d, m.q_lora_rank, dtype=dt, device=device)
            self.w_uq = _param(m.q_lora_rank, H, q_dim, dtype=dt,
                               device=device)
        else:
            self.wq = _param(d, H, q_dim, dtype=dt, device=device)
        self.w_dkv = _param(d, m.kv_lora_rank + m.qk_rope_head_dim, dtype=dt,
                            device=device)
        self.w_uk = _param(m.kv_lora_rank, H, m.qk_nope_head_dim, dtype=dt,
                           device=device)
        self.w_uv = _param(m.kv_lora_rank, H, m.v_head_dim, dtype=dt,
                           device=device)
        self.wo = _param(H, m.v_head_dim, d, dtype=dt, device=device)
        self.kv_norm = _param(m.kv_lora_rank, dtype=dt, device=device)


class MLP(nn.Module):
    """Dense MLP of width ``d_ff`` (default ``cfg.d_ff``): a MoE config's
    leading dense layer and its shared experts take their own widths."""

    def __init__(self, cfg, device, d_ff: Optional[int] = None):
        super().__init__()
        d, f, dt = cfg.d_model, d_ff or cfg.d_ff, pdt(cfg)
        self.up = _param(d, f, dtype=dt, device=device)
        self.down = _param(f, d, dtype=dt, device=device)
        self.gate = (_param(d, f, dtype=dt, device=device)
                     if cfg.activation == "swiglu" else None)
        self.cfg = cfg

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_mlp(x, self.up, self.down, self.cfg, gate=self.gate)


class Experts(nn.Module):
    """The routed experts' stacked weights: ``up``/``gate`` (E, d, f),
    ``down`` (E, f, d)."""

    def __init__(self, cfg, device):
        super().__init__()
        e, d, dt = cfg.moe, cfg.d_model, pdt(cfg)
        self.up = _param(e.n_experts, d, e.d_ff, dtype=dt, device=device)
        self.down = _param(e.n_experts, e.d_ff, d, dtype=dt, device=device)
        self.gate = (_param(e.n_experts, d, e.d_ff, dtype=dt, device=device)
                     if cfg.activation == "swiglu" else None)


class MoE(nn.Module):
    """Router (d, E), routed experts and, where the config has them, the
    always-on shared experts as one MLP of ``n_shared * shared_d_ff``."""

    def __init__(self, cfg, device):
        super().__init__()
        e = cfg.moe
        self.router = _param(cfg.d_model, e.n_experts, dtype=pdt(cfg),
                             device=device)
        self.experts = Experts(cfg, device)
        self.shared = (MLP(cfg, device, (e.shared_d_ff or e.d_ff)
                           * e.n_shared_experts)
                       if e.n_shared_experts else None)


class Block(nn.Module):
    """One decoder block: GQA/MHA (full or over the last ``window`` keys,
    its cache then a ring buffer) or MLA attention, then a dense MLP (of
    width ``d_ff``) or, with ``use_moe``, the MoE FFN."""

    def __init__(self, cfg, device, use_moe: bool = False,
                 d_ff: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        self.mla = cfg.attention == "mla"
        self.window = _window(cfg)
        self.ln1 = Norm(cfg, device)
        self.attn = (MLAAttention(cfg, device) if self.mla
                     else Attention(cfg, device))
        self.ln2 = Norm(cfg, device)
        if use_moe:
            self.moe = MoE(cfg, device)
        else:
            self.mlp = MLP(cfg, device, d_ff)

    def _ffn(self, x: torch.Tensor, capacity_factor: Optional[float] = None
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(x + the FFN of ln2(x), the MoE load-balance loss, or None for a
        dense MLP)."""
        h = self.ln2(x)
        if hasattr(self, "moe"):
            y, aux = moe_lib.apply_moe(self.moe, h, self.cfg,
                                       capacity_factor=capacity_factor)
            return x + y, aux
        return x + self.mlp(h), None

    def prefill(self, x, *, positions, kv_len, capacity_factor=None):
        """Returns (x, the sequence's two cache leaves (narrow-head (k, v)
        or MLA's (c_kv, k_rope)), the MoE aux loss or None)."""
        h = self.ln1(x)
        if self.mla:
            a, kv = attn.mla_prefill(self.attn, h, self.cfg,
                                     positions=positions, kv_len=kv_len)
        else:
            a, kv = attn.attend_prefill(self.attn, h, self.cfg,
                                        positions=positions,
                                        layer_window=self.window,
                                        kv_len=kv_len)
        x, aux = self._ffn(x + a, capacity_factor)
        return x, kv, aux

    def prefill_shared(self, x, *, positions, starts, kv_len, view_k,
                       view_v):
        """``prefill`` over tail tokens only, attending over the row's
        gathered page view; returns (x, the tail's narrow (k, v)). Dense
        GQA/MHA blocks only."""
        a, kv = attn.attend_prefill_shared(
            self.attn, self.ln1(x), self.cfg, positions=positions,
            starts=starts, kv_len=kv_len, view_k=view_k, view_v=view_v)
        return self._ffn(x + a)[0], kv

    def decode(self, x, *, lengths, kv, active):
        h = self.ln1(x)
        if self.mla:
            a = attn.mla_decode(self.attn, h, self.cfg, cache_ckv=kv[0],
                                cache_krope=kv[1], lengths=lengths,
                                active=active)
        else:
            a = attn.attend_decode(self.attn, h, self.cfg, cache_k=kv[0],
                                   cache_v=kv[1], lengths=lengths,
                                   layer_window=self.window,
                                   active=active)
        return self._ffn(x + a, 2.0)[0]

    def decode_paged(self, x, *, lengths, kv, page_table, active):
        h = self.ln1(x)
        if self.mla:
            a = attn.paged_mla_decode(
                self.attn, h, self.cfg, ckv_pages=kv[0], krope_pages=kv[1],
                page_table=page_table, lengths=lengths, active=active)
        else:
            a = attn.paged_attend_decode(
                self.attn, h, self.cfg, k_pages=kv[0], v_pages=kv[1],
                page_table=page_table, lengths=lengths, active=active)
        return self._ffn(x + a, 2.0)[0]


class Embedding(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        self.tok = _param(cfg.padded_vocab, cfg.d_model, dtype=pdt(cfg),
                          device=device)
        self.unembed = (None if cfg.tie_embeddings else
                        _param(cfg.d_model, cfg.padded_vocab, dtype=pdt(cfg),
                               device=device))


class LanguageModel(nn.Module):
    """What every model family shares: its ``cfg``, ``embed`` and
    ``final_norm``, the device its weights live on, and the readout of
    logits from the last hidden states."""

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return unembed(self.embed.tok, x, self.cfg, self.embed.unembed)

    def _last_logits(self, x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
        """x (B, S, d) final-normed, each row's position ``n - 1`` (0 where
        n is 0) unembedded: (B, V_pad)."""
        def pick(x, n):
            return x[torch.arange(x.shape[0], device=x.device),
                     torch.clamp(n.long() - 1, min=0)]
        last = sharding.local(pick, (("batch", "seq", None), ("batch",)),
                              (("batch", None),))(self.final_norm(x), n)
        return self._logits(last)

    def _step_logits(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, 1, d) of a decode step -> logits (B, V_pad)."""
        return self._logits(self.final_norm(x))[:, 0]

    def _zeros(self, leaves: Dict[str, Tuple[Tuple[int, ...], torch.dtype]],
               device=None) -> "Cache":
        """A zeroed cache: one leaf per name -> (shape, dtype), on
        ``device`` (default: the model's)."""
        device = device or self.device
        return {n: torch.zeros(shape, dtype=dt, device=device)
                for n, (shape, dt) in leaves.items()}


class Transformer(LanguageModel):
    """Dense decoders with full attention (smollm2, granite, stablelm,
    nemotron) or a sliding window (h2o-danube), and MoE decoders with MLA
    attention (deepseek-v2-lite) or GQA (qwen3-moe)."""

    def __init__(self, cfg, device):
        super().__init__()
        if (cfg.family, cfg.attention) not in (("dense", "full"),
                                               ("dense", "sliding_window"),
                                               ("moe", "mla"),
                                               ("moe", "full")):
            raise NotImplementedError(
                f"the port builds dense decoders with full or "
                f"sliding-window attention and MoE decoders with MLA or "
                f"full GQA attention; {cfg.arch_id!r} is family "
                f"{cfg.family!r} with {cfg.attention!r} attention")
        self.cfg = cfg
        self.window = _window(cfg)
        n_dense = cfg.moe.first_dense_layers if cfg.moe.enabled else 0
        self.embed = Embedding(cfg, device)
        self.final_norm = Norm(cfg, device)
        self.dense0 = nn.ModuleList(
            Block(cfg, device, d_ff=cfg.moe.dense_d_ff)
            for _ in range(n_dense))
        self.layers = nn.ModuleList(
            Block(cfg, device, use_moe=cfg.moe.enabled)
            for _ in range(cfg.n_layers - n_dense))
        self.cache_names: Tuple[str, str] = (
            ("ckv", "krope") if cfg.attention == "mla" else ("k", "v"))
        if cfg.moe.enabled or cfg.attention == "mla" or self.window:
            self.prefill_shared = None
        if self.window:
            self.decode_paged = None

    @property
    def _row_invariant(self) -> bool:
        """Whether the prefill's linears take the row-invariant kernel
        (``kernels.ops.prefill_linear``): with ``cfg.use_kernels``, in a
        dense decoder. A MoE decoder keeps ``torch.matmul``, as its plain
        path does: it has no shared-prefix prefill, which is what row
        invariance is for, and its router's top-k is discrete. On an H100
        the last bits in which the kernel's K split differs from cuBLAS
        moved 7.2 % and 10.7 % of DeepSeek-V2-Lite's prefill routing
        decisions from the plain path's (``chip_smoke.py`` phase 6, mixes
        (e) and (f)), above the 5 % bound with which that phase tells a
        fault in the MoE and MLA kernels from rounding."""
        return self.cfg.use_kernels and not self.cfg.moe.enabled

    @property
    def blocks(self) -> List[Block]:
        """Every block in the order it runs (``dense0`` first); block i
        owns layer i of the cache."""
        return list(self.dense0) + list(self.layers)

    def _kv(self, cache: Cache, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
        kv = tuple(cache[n][i] for n in self.cache_names)
        return shard_kv_cache(kv) if sharding.active() else kv

    def forward_hidden(self, tokens: torch.Tensor,
                       lengths: Optional[torch.Tensor] = None,
                       extra: Optional[Dict] = None, train: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B,S) -> (the final-normed hidden states (B,S,d), the
        MoE load-balance loss summed over the layers in order, f32; 0 for
        a dense model). ``lengths`` masks padding keys as the reference's
        ``batch["lengths"]`` does. With ``train`` and ``cfg.remat`` in
        ("block", "full"), each block of ``layers`` (the reference's layer
        scan; not ``dense0``) runs under ``torch.utils.checkpoint``: its
        activations are recomputed in the backward pass. Both policies
        recompute the whole block here: the reference's "block" keeps its
        batch-free dots (``dots_with_no_batch_dims_saveable``), a memory
        policy with no counterpart in eager PyTorch. The values are the
        same either way. ``extra`` (the frontend inputs of the audio and
        vision families) is unused: every family shares this signature."""
        x = embed(self.embed.tok, tokens, self.cfg)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        use_remat = train and self.cfg.remat in ("block", "full")
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, blk in enumerate(self.blocks):
            if use_remat and i >= len(self.dense0):
                x, _, a = remat(blk.prefill, x, positions=positions,
                                kv_len=lengths)
            else:
                x, _, a = blk.prefill(x, positions=positions,
                                      kv_len=lengths)
            if a is not None:
                aux = aux + a
        return self.final_norm(x), aux

    def forward(self, tokens: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens (B,S) -> logits (B,S,V_pad); ``lengths`` masks padding
        keys as the reference's ``batch["lengths"]`` does."""
        return self._logits(self.forward_hidden(tokens, lengths)[0])

    def init_cache(self, batch: int, cache_len: int,
                   dtype: Optional[torch.dtype] = None,
                   device=None) -> Cache:
        """Zeroed cache in ``dtype`` (default: the compute dtype) on
        ``device`` (default: the model's): {"k", "v"} of shape (L, batch,
        cache_len, Hkv, D) (``min(cache_len, window)`` positions for a
        sliding-window model's ring buffers), or for MLA {"ckv": (L, batch,
        cache_len, R), "krope": (L, batch, cache_len, dr)}."""
        cfg = self.cfg
        lead = (cfg.n_layers, batch, cache_len)
        if cfg.attention == "mla":
            tails = ((cfg.mla.kv_lora_rank,), (cfg.mla.qk_rope_head_dim,))
        else:
            if self.window:
                lead = (cfg.n_layers, batch, min(cache_len, self.window))
            tails = ((cfg.n_kv_heads, cfg.resolved_head_dim),) * 2
        dtype = dtype or cdt(cfg)
        return self._zeros({n: (lead + t, dtype)
                            for n, t in zip(self.cache_names, tails)}, device)

    def prefill(self, tokens: torch.Tensor, lengths: torch.Tensor,
                cache: Cache, slots: Optional[torch.Tensor] = None,
                page_table: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Prefill right-padded prompts. tokens (B,S); lengths (B,) valid
        counts. Each layer's cache leaves for positions [0, S) are written
        in place: into the slot cache, row i into cache row ``slots[i]``
        for i < len(slots) (rows past it are padding and write nothing), or
        into row i when ``slots`` is None; or, with ``page_table`` (B, n),
        into the paged pool through row i's table (padding rows' tables are
        all TRASH). A ring buffer shorter than S takes the wave's last
        ``Scache`` columns into positions [0, Scache), as the reference's
        ``_write_prefill_kv`` does: the last columns of the padded wave,
        not of each row's prompt, and from column 0, where decode's ring
        expects position p at p % Scache. So a prompt or wave longer than
        the window decodes over another key set than ``forward`` attends,
        in both packages. Returns the logits at position ``lengths - 1``,
        (B, V_pad). With ``cfg.use_kernels`` a dense decoder's linears
        run in ``row_invariant_linears``: a row's bits do not depend on
        its wave's size (``_row_invariant``)."""
        S = tokens.shape[1]
        with row_invariant_linears(self._row_invariant):
            x = embed(self.embed.tok, tokens, self.cfg)
            positions = torch.arange(S, device=tokens.device)
            for i, blk in enumerate(self.blocks):
                x, kv, _ = blk.prefill(x, positions=positions,
                                       kv_len=lengths, capacity_factor=2.0)
                for dst, src in zip(self._kv(cache, i), kv):
                    if page_table is None:
                        if self.window and S > dst.shape[1]:
                            src = src[:, S - dst.shape[1]:]
                        write_prefill(dst, src, slots)
                    else:
                        attn._paged_write_span(dst, src, page_table)
            return self._last_logits(x, lengths)

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
        ``lengths - 1``, which is tail index ``lengths - starts - 1``. Its
        linears run as ``prefill``'s do, so a tail row gets the bits the
        same row gets in a cold wave."""
        Tb = tokens.shape[1]
        with row_invariant_linears(self._row_invariant):
            x = embed(self.embed.tok, tokens, self.cfg)
            positions = starts.long()[:, None] + torch.arange(
                Tb, device=tokens.device)[None, :]
            for i, blk in enumerate(self.blocks):
                x, (k, v) = blk.prefill_shared(
                    x, positions=positions, starts=starts, kv_len=lengths,
                    view_k=attn._paged_gather(cache["k"][i], page_table),
                    view_v=attn._paged_gather(cache["v"][i], page_table))
                attn._paged_write_span(cache["k"][i], k, page_table, starts)
                attn._paged_write_span(cache["v"][i], v, page_table, starts)
            return self._last_logits(x, lengths.long() - starts.long())

    def decode_step(self, tokens: torch.Tensor, lengths: torch.Tensor,
                    cache: Cache,
                    active: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One token per row. tokens (B,1) at position ``lengths``; the
        cache is written in place at ``min(lengths, S-1)`` (a ring buffer
        at ``lengths % S``) for rows where ``active`` (default: all rows).
        Returns logits (B, V_pad)."""
        x = embed(self.embed.tok, tokens, self.cfg)
        for i, blk in enumerate(self.blocks):
            x = blk.decode(x, lengths=lengths, kv=self._kv(cache, i),
                           active=active)
        return self._step_logits(x)

    def decode_paged(self, tokens: torch.Tensor, lengths: torch.Tensor,
                     cache: Cache, page_table: torch.Tensor,
                     active: torch.Tensor) -> torch.Tensor:
        """One token per row against the paged pool: tokens (B,1) at
        position ``lengths``, written through ``page_table`` (B, n), the
        one table every layer shares, for rows where ``active`` (inactive
        rows write into TRASH). Returns logits (B, V_pad)."""
        x = embed(self.embed.tok, tokens, self.cfg)
        for i, blk in enumerate(self.blocks):
            x = blk.decode_paged(x, lengths=lengths, kv=self._kv(cache, i),
                                 page_table=page_table, active=active)
        return self._step_logits(x)
