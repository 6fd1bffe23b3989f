"""Base configuration dataclasses for the model zoo (PyTorch port's copy).

A field-for-field copy of ``repro.configs.base``, its analytic size
helpers (``param_count``, ``active_param_count``, ``kv_bytes_per_token``,
``n_attention_layers``) included: the port imports nothing of the JAX
package, so it keeps its own ``ModelConfig``. Equal field values
give an equal ``key()`` in both packages, so a config built on either side
names the same model.

One ``ModelConfig`` describes every architecture family the reference
knows; the port builds the ``dense``, ``hybrid``, ``ssm`` (xLSTM),
``audio`` and ``vlm`` families and the ``moe`` family with MLA attention
(see ``repro_torch.models.registry``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings (applies to layers in ``moe_layers``)."""

    n_experts: int = 0                 # routed experts
    experts_per_token: int = 0         # top-k
    d_ff: int = 0                      # per-expert hidden width
    n_shared_experts: int = 0          # DeepSeek-style always-on experts
    shared_d_ff: int = 0               # hidden width of the shared expert(s)
    capacity_factor: float = 1.25      # train-time dispatch capacity
    router_jitter: float = 0.0
    first_dense_layers: int = 0        # leading layers that stay dense
    dense_d_ff: int = 0                # width of those dense layers
    aux_loss_weight: float = 1e-2      # load-balance loss

    @property
    def enabled(self) -> bool:
        return self.n_experts > 0


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek Multi-head Latent Attention settings."""

    kv_lora_rank: int = 0              # compressed KV latent width
    q_lora_rank: int = 0               # 0 => direct q projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def enabled(self) -> bool:
        return self.kv_lora_rank > 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / xLSTM recurrent-block settings."""

    state_dim: int = 0                 # N: SSM state size per head
    conv_dim: int = 4                  # depthwise causal conv width
    expand: int = 2                    # inner width = expand * d_model
    head_dim: int = 64                 # mamba2 head dim (P)
    n_groups: int = 1                  # B/C groups
    chunk: int = 256                   # chunked-scan block length
    # xLSTM only:
    slstm_every: int = 0               # 0 => no sLSTM blocks; else 1 sLSTM per group
    slstm_proj_factor: float = 4 / 3
    mlstm_proj_factor: float = 2.0

    @property
    def enabled(self) -> bool:
        return self.state_dim > 0 or self.slstm_every > 0


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description. Defaults give a small dense GQA decoder."""

    arch_id: str = "tiny-dense"
    family: str = "dense"  # dense|audio|ssm|hybrid|vlm|moe

    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0                  # 0 => d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    vocab_pad_to: int = 256            # pad vocab for TP divisibility

    activation: str = "swiglu"         # swiglu|squared_relu|gelu
    norm: str = "rmsnorm"              # rmsnorm|layernorm
    norm_eps: float = 1e-5
    qk_norm: bool = False              # Qwen3-style per-head q/k RMSNorm
    rope_theta: float = 10_000.0
    max_seq_len: int = 8192
    tie_embeddings: bool = False

    # Attention variants
    attention: str = "full"            # full|sliding_window|mla
    sliding_window: int = 0            # SWA window (tokens), 0 = unlimited
    swa_every: int = 1                 # 1 => all layers SWA; n => 1 full per n

    # Encoder-decoder (audio family)
    n_encoder_layers: int = 0
    encoder_seq_len: int = 1500        # whisper: 30 s of audio at 50 Hz
    encoder_bidirectional: bool = True

    # VLM cross attention
    cross_attn_every: int = 0          # every k-th layer gets cross-attn
    vision_tokens: int = 0
    vision_dim: int = 0                # frontend embedding dim (stub provides these)

    # Hybrid (zamba2): shared attention block every `shared_attn_every` SSM layers
    shared_attn_every: int = 0

    moe: MoEConfig = field(default_factory=MoEConfig)
    mla: MLAConfig = field(default_factory=MLAConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    logit_dtype: str = "float32"
    use_kernels: bool = False          # route attention, MoE and SSD scans
                                       # through the kernels
    remat: str = "none"                # none|block|full  (training remat policy)
    kv_update: str = "scatter"         # scatter|mask  (decode cache write; see
                                       # EXPERIMENTS.md §Perf — mask avoids a
                                       # GSPMD involuntary-remat on TP meshes)
    gqa_decode: str = "grouped"        # grouped|repeat (decode attention on
                                       # narrow KV vs head-repeated cache;
                                       # repeat = paper-faithful baseline,
                                       # grouped kills the per-layer cache
                                       # all-gather — EXPERIMENTS.md §Perf)
    kv_cache_dtype: str = "bfloat16"   # bfloat16|float8_e4m3fn — fp8 halves
                                       # the decode memory floor (§Perf)

    # ---- derived -------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad_to)

    @property
    def q_heads_per_kv(self) -> int:
        return max(1, self.n_heads // max(1, self.n_kv_heads))

    def key(self) -> str:
        """Stable hash identifying this config (used in context recipes)."""
        blob = json.dumps(dataclasses.asdict(self), sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    # ---- parameter counting (analytic, used by roofline & DESIGN docs) --
    def param_count(self) -> int:
        return _param_count(self)

    def active_param_count(self) -> int:
        return _param_count(self, active_only=True)

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """Per-token KV-cache footprint (bytes) across all attention layers."""
        hd = self.resolved_head_dim
        if self.mla.enabled:
            per_layer = self.mla.kv_lora_rank + self.mla.qk_rope_head_dim
        else:
            per_layer = 2 * self.n_kv_heads * hd
        return self.n_attention_layers() * per_layer * dtype_bytes

    def n_attention_layers(self) -> int:
        if self.family == "ssm":
            return 0
        if self.family == "hybrid" and self.shared_attn_every:
            return self.n_layers // self.shared_attn_every
        if self.family == "audio":
            return self.n_layers  # decoder self-attn layers (cross handled apart)
        return self.n_layers


def _mlp_params(d_model: int, d_ff: int, activation: str) -> int:
    if activation == "swiglu":
        return 3 * d_model * d_ff
    return 2 * d_model * d_ff  # squared_relu / gelu: up + down


def _attn_params(cfg: ModelConfig) -> int:
    hd = cfg.resolved_head_dim
    if cfg.mla.enabled:
        m = cfg.mla
        q_dim = cfg.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
        p = cfg.d_model * q_dim if not m.q_lora_rank else (
            cfg.d_model * m.q_lora_rank + m.q_lora_rank * q_dim)
        p += cfg.d_model * (m.kv_lora_rank + m.qk_rope_head_dim)       # down-proj
        p += m.kv_lora_rank * cfg.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
        p += cfg.n_heads * m.v_head_dim * cfg.d_model                  # o proj
        return p
    q = cfg.d_model * cfg.n_heads * hd
    kv = 2 * cfg.d_model * cfg.n_kv_heads * hd
    o = cfg.n_heads * hd * cfg.d_model
    return q + kv + o


def _param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Analytic parameter count; close enough for 6ND roofline accounting."""
    d = cfg.d_model
    total = cfg.padded_vocab * d  # embeddings
    if not cfg.tie_embeddings:
        total += cfg.padded_vocab * d

    if cfg.family == "ssm":  # xLSTM
        s = cfg.ssm
        per_group = 0
        group = max(1, s.slstm_every)
        # mLSTM blocks
        d_inner = int(d * s.mlstm_proj_factor)
        mlstm = 2 * d * d_inner + 3 * d_inner * d_inner // max(1, cfg.n_heads) \
            + d_inner * d + 3 * d_inner
        # sLSTM blocks
        d_s = int(d * s.slstm_proj_factor)
        slstm = 4 * d * d + 2 * d * d_s + d_s * d
        n_s = cfg.n_layers // group if s.slstm_every else 0
        total += n_s * slstm + (cfg.n_layers - n_s) * mlstm + per_group
        return total

    mamba_per_layer = 0
    if cfg.ssm.enabled and cfg.family == "hybrid":
        s = cfg.ssm
        d_in = s.expand * d
        n_h = d_in // s.head_dim
        mamba_per_layer = (
            d * (2 * d_in + 2 * s.n_groups * s.state_dim + n_h)  # in_proj
            + s.conv_dim * (d_in + 2 * s.n_groups * s.state_dim)  # conv
            + d_in * d                                             # out proj
            + 2 * n_h                                              # A, D
        )

    attn = _attn_params(cfg)
    for layer in range(cfg.n_layers):
        if cfg.family == "hybrid":
            total += mamba_per_layer
            continue
        total += attn
        if cfg.moe.enabled and layer >= cfg.moe.first_dense_layers:
            e = cfg.moe
            per_expert = _mlp_params(d, e.d_ff, cfg.activation)
            n_used = e.experts_per_token if active_only else e.n_experts
            total += n_used * per_expert
            total += e.n_shared_experts * _mlp_params(d, e.shared_d_ff or e.d_ff,
                                                      cfg.activation)
            total += d * e.n_experts  # router
        elif cfg.moe.enabled:
            total += _mlp_params(d, cfg.moe.dense_d_ff or cfg.d_ff, cfg.activation)
        else:
            total += _mlp_params(d, cfg.d_ff, cfg.activation)

    if cfg.family == "hybrid" and cfg.shared_attn_every:
        total += attn + _mlp_params(d, cfg.d_ff, cfg.activation)  # ONE shared block

    if cfg.family == "audio":
        enc_attn = _attn_params(dataclasses.replace(cfg, n_kv_heads=cfg.n_heads))
        per_enc = enc_attn + _mlp_params(d, cfg.d_ff, "gelu")
        total += cfg.n_encoder_layers * per_enc
        total += cfg.n_layers * enc_attn  # decoder cross-attention

    if cfg.cross_attn_every:
        n_cross = cfg.n_layers // cfg.cross_attn_every
        total += n_cross * (_attn_params(cfg) + (cfg.vision_dim or d) * d)

    return total


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Shrink a config to smoke-test scale while keeping its family/topology."""
    small: dict = dict(
        d_model=64,
        n_heads=4,
        n_kv_heads=min(4, cfg.n_kv_heads) if cfg.n_kv_heads else 4,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
        vocab_pad_to=64,
        max_seq_len=256,
        sliding_window=min(cfg.sliding_window, 32) if cfg.sliding_window else 0,
        encoder_seq_len=24 if cfg.family == "audio" else cfg.encoder_seq_len,
        vision_tokens=12 if cfg.vision_tokens else 0,
        vision_dim=32 if cfg.vision_dim else 0,
        param_dtype="float32",
        compute_dtype="float32",
    )
    # keep layer pattern divisibility
    if cfg.family == "hybrid" and cfg.shared_attn_every:
        small["n_layers"] = 2 * cfg.shared_attn_every + 1
    elif cfg.cross_attn_every:
        small["n_layers"] = 2 * cfg.cross_attn_every
    elif cfg.family == "ssm" and cfg.ssm.slstm_every:
        small["n_layers"] = 2 * cfg.ssm.slstm_every
    else:
        small["n_layers"] = 2
    if cfg.family == "audio":
        small["n_encoder_layers"] = 2
    if cfg.moe.enabled:
        small["moe"] = dataclasses.replace(
            cfg.moe, n_experts=8, experts_per_token=min(2, cfg.moe.experts_per_token),
            d_ff=64, shared_d_ff=64 if cfg.moe.n_shared_experts else 0,
            dense_d_ff=128 if cfg.moe.first_dense_layers else 0)
    if cfg.mla.enabled:
        small["mla"] = dataclasses.replace(
            cfg.mla, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16)
    if cfg.ssm.enabled:
        small["ssm"] = dataclasses.replace(
            cfg.ssm, state_dim=16 if cfg.ssm.state_dim else 0, head_dim=16,
            chunk=32, expand=2)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
