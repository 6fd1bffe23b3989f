"""Nemotron-4-15B — dense GQA decoder, squared-ReLU MLP. [arXiv:2402.16819]

Copy of ``repro.configs.nemotron_4_15b``: 32 layers, d_model 6144, 48
heads over 8 KV heads (group 6), head_dim 128, squared-ReLU d_ff 24 576,
vocab 256 000, untied, LayerNorm with biases, bf16.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=256_000,
    activation="squared_relu",
    norm="layernorm",
    rope_theta=10_000.0,
    max_seq_len=32_768,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
