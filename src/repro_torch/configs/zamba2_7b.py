"""Zamba2-7B: a Mamba2 backbone with ONE shared attention block applied
every 6th layer. [arXiv:2411.15242]

Copy of ``repro.configs.zamba2_7b``: 81 Mamba2 layers of d_model 3584,
``expand`` 2 (d_in 7168: 112 SSM heads of head_dim 64), state 64, 2 B/C
groups, conv width 4, chunk 256; the shared attention + SwiGLU block
(32 MHA heads of 3584 / 32 = 112, d_ff 14 336) runs before each group of 6
Mamba2 layers, 13 times, then 3 tail layers; vocab 32 000, untied, bf16.
6 786 849 504 parameters by the reference's ``param_count()``, which
leaves out the norm scales, the conv biases and ``dt_bias``.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,          # shared block is MHA
    d_ff=14336,             # shared block MLP width
    vocab_size=32_000,
    activation="swiglu",
    norm="rmsnorm",
    shared_attn_every=6,
    max_seq_len=524_288,
    ssm=SSMConfig(
        state_dim=64,
        conv_dim=4,
        expand=2,
        head_dim=64,
        n_groups=2,
        chunk=256,
    ),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
