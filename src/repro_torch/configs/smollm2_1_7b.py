"""SmolLM2-1.7B — the paper's own fact-verification model. [arXiv:2502.02737]

Copy of ``repro.configs.smollm2_1_7b``: 24 layers, d_model 2048, 32 heads
with 32 KV heads (MHA), head_dim 64, SwiGLU d_ff 8192, vocab 49 152, tied
embeddings, bf16.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="smollm2-1.7b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=49_152,
    activation="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    rope_theta=130_000.0,
    max_seq_len=8192,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
