"""Granite-3.0-2B — dense GQA decoder. [hf:ibm-granite/granite-3.0-2b-base]

vocab 49155 is not divisible by the 16-way model axis; the embedding table is
padded to ``padded_vocab`` (49408) by the sharding plan (see DESIGN.md §5).

Copy of ``repro.configs.granite_3_2b``: 40 layers, d_model 2048, 32 heads
over 8 KV heads (GQA group 4), head_dim 64, SwiGLU d_ff 8192, vocab
49 155, tied embeddings, RMSNorm, bf16.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=49_155,
    activation="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    rope_theta=10_000.0,
    max_seq_len=32_768,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
