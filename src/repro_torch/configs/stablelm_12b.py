"""StableLM-2-12B — dense GQA decoder. [hf:stabilityai/stablelm-2-12b; hf]

Copy of ``repro.configs.stablelm_12b``: 40 layers, d_model 5120, 32 heads
over 8 KV heads (group 4), head_dim 160, SwiGLU d_ff 13 824, vocab
100 352, untied, LayerNorm with biases, bf16.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=100_352,
    activation="swiglu",
    norm="layernorm",
    rope_theta=10_000.0,
    max_seq_len=32_768,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
