"""xLSTM-350M: sLSTM + mLSTM recurrent blocks, no attention, no KV cache.
[arXiv:2405.04517]

Copy of ``repro.configs.xlstm_350m``: 24 blocks of d_model 1024 in 6
groups of [sLSTM, mLSTM, mLSTM, mLSTM] (``slstm_every`` 4); the mLSTM
up-projects by 2 (d_in 2048: 4 heads of 512), the sLSTM's FFN by 4/3;
chunk 256; vocab 50 304, untied, LayerNorm, bf16. Its state is O(1) per
sequence (matrix memories and scalar cells). ``param_count()`` reads
0.32 G: it counts ``wq``/``wk``/``wv`` as block-diagonal, where the
reference initialises (and the port holds) them dense, 0.51 G in all.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                 # xLSTM blocks carry their own projections
    vocab_size=50_304,
    norm="layernorm",
    max_seq_len=524_288,
    ssm=SSMConfig(
        slstm_every=4,      # [sLSTM, mLSTM, mLSTM, mLSTM] x 6
        slstm_proj_factor=4 / 3,
        mlstm_proj_factor=2.0,
        chunk=256,
    ),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
