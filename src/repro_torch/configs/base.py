"""Base configuration dataclasses for the model zoo (PyTorch port's copy).

A field-for-field copy of ``repro.configs.base``: the port imports nothing
of the JAX package, so it keeps its own ``ModelConfig``. Equal field values
give an equal ``key()`` in both packages, so a config built on either side
names the same model.

One ``ModelConfig`` describes every architecture family the reference
knows; the port builds the ``dense`` family, the ``moe`` family with MLA
attention and the ``hybrid`` family so far (see
``repro_torch.models.registry``).
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
