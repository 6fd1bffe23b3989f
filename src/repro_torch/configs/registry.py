"""Architecture registry of the port: ``arch id -> ModelConfig``.

The port serves the dense SmolLM2-1.7B so far. The reference's other
architectures are known by name and raise, naming the port slice that
brings their model family.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.configs.smollm2_1_7b import CONFIG as SMOLLM2_1_7B

_CONFIGS = {"smollm2-1.7b": SMOLLM2_1_7B}

# arch id -> the later port slice that brings it (ROADMAP.md, queue 1)
_LATER = {
    "stablelm-12b": "dense GQA decoders",
    "nemotron-4-15b": "dense GQA decoders",
    "granite-3-2b": "dense GQA decoders",
    "h2o-danube-1.8b": "sliding-window ring-buffer caches",
    "whisper-small": "the audio encoder-decoder family",
    "xlstm-350m": "the SSM/xLSTM family",
    "zamba2-7b": "the hybrid Mamba2 family (needs the SSD scan kernel)",
    "llama-3.2-vision-11b": "the vision cross-attention family",
    "qwen3-moe-235b-a22b": "the MoE family (needs the grouped GEMM kernel)",
    "deepseek-v2-lite-16b": "MLA + MoE (needs the paged MLA decode kernel)",
}

ALL_ARCHS = tuple(_CONFIGS)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in _CONFIGS:
        return _CONFIGS[arch_id]
    if arch_id in _LATER:
        raise NotImplementedError(
            f"{arch_id!r} is not ported yet: it arrives with the port slice "
            f"for {_LATER[arch_id]}")
    raise KeyError(f"unknown arch {arch_id!r}; available: "
                   f"{', '.join(sorted(_CONFIGS))}")


def get_reduced_config(arch_id: str, **overrides) -> ModelConfig:
    return reduced(get_config(arch_id), **overrides)
