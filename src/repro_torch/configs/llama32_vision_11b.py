"""Llama-3.2-Vision-11B: a text decoder with cross-attention image layers.
[hf:meta-llama/Llama-3.2-11B-Vision]

Copy of ``repro.configs.llama32_vision_11b``: 40 dense self-attention
layers of d_model 4096 (32 heads over 8 KV heads of 128, SwiGLU 14 336,
RMSNorm, vocab 128 256, untied, bf16) and, before each group of 5, a
gated cross-attention block (8 in all) over 4100 image tokens (about 4
tiles of 1025 patches). The vision frontend is a stub, as in the
reference: the model takes precomputed patch embeddings (batch,
vision_tokens, vision_dim = 1280) and owns the 1280 -> K/V projections.
``param_count()`` reads 10.15 G; the reference initialises (and the port
holds) 11.47 G.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128_256,
    activation="swiglu",
    norm="rmsnorm",
    cross_attn_every=5,
    vision_tokens=4100,     # ~4 tiles x 1025 patches
    vision_dim=1280,
    rope_theta=500_000.0,
    max_seq_len=131_072,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
