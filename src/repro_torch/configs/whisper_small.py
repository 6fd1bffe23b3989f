"""Whisper-small: an encoder-decoder audio backbone. [arXiv:2212.04356]

Copy of ``repro.configs.whisper_small``: 12 encoder and 12 decoder layers
of d_model 768, 12 MHA heads of 64, GELU MLPs of 3072, LayerNorm, vocab
51 865, untied, bf16. The conv frontend is a stub, as in the reference:
the model takes precomputed frame embeddings (batch, encoder_seq_len =
1500, d_model) (``models.registry.extra_inputs``). Positions enter through
RoPE in the encoder and in the decoder's self-attention (the released
Whisper learns absolute embeddings); each decoder layer cross-attends to
the encoder's 1500 frames.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-small",
    family="audio",
    n_layers=12,            # decoder layers
    n_encoder_layers=12,
    encoder_seq_len=1500,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51_865,
    activation="gelu",
    norm="layernorm",
    rope_theta=10_000.0,    # RoPE where whisper learns pos-emb (docstring)
    max_seq_len=32_768,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
