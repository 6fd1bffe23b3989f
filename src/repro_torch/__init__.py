"""PyTorch/CUDA port of the PCM reproduction, beside the JAX package
``repro`` (the reference, which this package never imports).

Slice 1: the dense SmolLM2-1.7B, served by the slot-cache
``serving.InferenceEngine`` with hand-written CUDA prefill-attention and
flash-decode kernels (``csrc/``), and the engine's context demote/restore
hooks. See ROADMAP.md for the slices to come.
"""
