"""H2O-Danube-1.8B — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; hf]

SWA bounds the KV window, so this arch RUNS the ``long_500k`` decode cell
(the cache holds only the last ``sliding_window`` tokens).

Copy of ``repro.configs.h2o_danube_1_8b``: 24 layers, d_model 2560, 32
heads over 8 KV heads (group 4), head_dim 80, SwiGLU d_ff 6912, vocab
32 000, untied, RMSNorm, a 4096-token sliding window on every layer (the
slot cache is a ring of min(cache_len, 4096) columns), bf16.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab_size=32_000,
    activation="swiglu",
    norm="rmsnorm",
    attention="sliding_window",
    sliding_window=4096,
    swa_every=1,
    rope_theta=10_000.0,
    max_seq_len=524_288,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
