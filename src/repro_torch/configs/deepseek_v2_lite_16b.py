"""DeepSeek-V2-Lite-16B: MLA (kv_lora 512) + MoE, 64 routed experts top-6
and 2 shared. [arXiv:2405.04434]

Copy of ``repro.configs.deepseek_v2_lite_16b``: 27 layers, d_model 2048,
16 heads; Multi-head Latent Attention with a 512-wide compressed KV latent,
128-wide no-rope and 64-wide rope query/key parts and 128-wide values (no
query compression); 64 routed experts of d_ff 1408, 6 per token, and 2
shared experts of 1408 each; layer 0 stays dense with d_ff 10 944; vocab
102 400, untied embeddings, bf16. 15 706 357 760 parameters by the
reference's ``param_count()``, which leaves out the 126 464 norm scales:
15 706 484 224 in all.
"""

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=0,
    vocab_size=102_400,
    activation="swiglu",
    norm="rmsnorm",
    attention="mla",
    rope_theta=10_000.0,
    max_seq_len=163_840,
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=0,       # lite: direct q projection
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        n_experts=64,
        experts_per_token=6,
        d_ff=1408,
        n_shared_experts=2,
        shared_d_ff=1408,
        first_dense_layers=1,
        dense_d_ff=10944,
        capacity_factor=1.25,
    ),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
