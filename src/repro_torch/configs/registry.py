"""Architecture registry of the port: ``arch id -> ModelConfig``.

The port serves the dense GQA/MHA decoders SmolLM2-1.7B, Granite-3-2B,
StableLM-12B and Nemotron-4-15B, the sliding-window decoder
H2O-Danube-1.8B, the MLA + MoE DeepSeek-V2-Lite-16B, the Mamba2 +
shared-attention hybrid Zamba2-7B, the recurrent xLSTM-350M, the
encoder-decoder Whisper-small, the cross-attention VLM
Llama-3.2-Vision-11B, and Qwen3-MoE-235B: every architecture of the
reference. Qwen3-MoE's 470 GB of bf16 weights fit no card the port runs
on, one H100 or four: the sharded path plans it (``launch.sharding``,
``launch.steps`` on the meta device) and ``models.registry.build_model``
refuses to allocate it.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as DEEPSEEK_V2_LITE
from repro_torch.configs.granite_3_2b import CONFIG as GRANITE_3_2B
from repro_torch.configs.h2o_danube_1_8b import CONFIG as H2O_DANUBE_1_8B
from repro_torch.configs.llama32_vision_11b import \
    CONFIG as LLAMA32_VISION_11B
from repro_torch.configs.nemotron_4_15b import CONFIG as NEMOTRON_4_15B
from repro_torch.configs.qwen3_moe_235b import CONFIG as QWEN3_MOE_235B
from repro_torch.configs.smollm2_1_7b import CONFIG as SMOLLM2_1_7B
from repro_torch.configs.stablelm_12b import CONFIG as STABLELM_12B
from repro_torch.configs.whisper_small import CONFIG as WHISPER_SMALL
from repro_torch.configs.xlstm_350m import CONFIG as XLSTM_350M
from repro_torch.configs.zamba2_7b import CONFIG as ZAMBA2_7B

_CONFIGS = {"smollm2-1.7b": SMOLLM2_1_7B,
            "granite-3-2b": GRANITE_3_2B,
            "h2o-danube-1.8b": H2O_DANUBE_1_8B,
            "stablelm-12b": STABLELM_12B,
            "nemotron-4-15b": NEMOTRON_4_15B,
            "deepseek-v2-lite-16b": DEEPSEEK_V2_LITE,
            "zamba2-7b": ZAMBA2_7B,
            "xlstm-350m": XLSTM_350M,
            "whisper-small": WHISPER_SMALL,
            "llama-3.2-vision-11b": LLAMA32_VISION_11B,
            "qwen3-moe-235b-a22b": QWEN3_MOE_235B}

ALL_ARCHS = tuple(_CONFIGS)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in _CONFIGS:
        return _CONFIGS[arch_id]
    raise KeyError(f"unknown arch {arch_id!r}; available: "
                   f"{', '.join(sorted(_CONFIGS))}")


def get_reduced_config(arch_id: str, **overrides) -> ModelConfig:
    return reduced(get_config(arch_id), **overrides)
