"""Qwen3-MoE-235B-A22B: 128 routed experts top-8, GQA with 4 KV heads,
qk-norm. [hf:Qwen/Qwen3-235B-A22B]

Copy of ``repro.configs.qwen3_moe_235b``: 94 layers, d_model 4096, 64
heads of an explicit head_dim 128 (64 x 128 = 8192, not d_model), 4 KV
heads; every layer MoE: 128 experts of d_ff 1536, 8 per token, no shared
experts, capacity factor 1.25; vocab 151 936 (152 064 padded), untied
embeddings, bf16. 235 093 884 928 parameters by the reference's
``param_count()`` (235 094 683 136 with the norm scales): 470 GB in bf16,
more than one H100's 80 GB or four's 320 GB, so it is planned on a mesh
(``launch.sharding``: 8 experts a rank on a 16-way model axis) and never
allocated whole (``models.registry.build_model`` refuses it on a card).
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=0,                 # all layers MoE
    vocab_size=151_936,
    activation="swiglu",
    norm="rmsnorm",
    qk_norm=True,
    rope_theta=1_000_000.0,
    max_seq_len=131_072,
    moe=MoEConfig(
        n_experts=128,
        experts_per_token=8,
        d_ff=1536,
        n_shared_experts=0,
        capacity_factor=1.25,
    ),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
