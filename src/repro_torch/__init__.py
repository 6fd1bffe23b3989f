"""PyTorch/CUDA port of the PCM reproduction, beside the JAX package
``repro`` (the reference, which this package never imports).

It serves the dense SmolLM2-1.7B (slot cache and paged pool with prefix
sharing), the MLA + MoE DeepSeek-V2-Lite-16B (paged pool) and the Mamba2
hybrid Zamba2-7B (slot cache) through ``serving.InferenceEngine``, with a
hand-written CUDA kernel (``csrc/``) for each of the reference's Pallas
kernels, and the engine's context demote/restore hooks. See ROADMAP.md for
the slices to come.
"""
