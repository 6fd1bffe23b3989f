"""Weights of the port's models: its own seeded init, and the bridge that
carries the JAX reference's parameters across.

Both return a state dict for ``repro_torch.models.transformer.Transformer``
whose names follow the reference's pytree paths. The reference stacks every
layer's leaves along a leading layer axis (``transformer.py:210-222``): the
bridge splits that axis into ``layers.{i}.*``. Every other layout is kept
as it is: ``wq``/``wk``/``wv`` (d, H|Hkv, hd), ``wo`` (H, hd, d), MLP
``up``/``gate`` (d, f) and ``down`` (f, d), and the tied, vocab-padded
``embed.tok`` (V_pad, d).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.models.layers import normal_init, pdt

StateDict = Dict[str, torch.Tensor]


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for name, leaf in tree.items():
        path = f"{prefix}{name}"
        if isinstance(leaf, Mapping):
            out.update(_flatten(leaf, path + "."))
        else:
            out[path] = np.asarray(leaf)
    return out


def from_jax_params(params_np: Mapping, cfg,
                    device: torch.device) -> StateDict:
    """The reference's params pytree (nested dicts of numpy arrays, e.g.
    ``jax.device_get(model.init(key))``) -> the port's state dict on
    ``device``, in ``cfg.param_dtype``. Dense family only."""
    if "dense0" in params_np:
        raise NotImplementedError("leading dense layers (MoE configs) are "
                                  "not ported yet")
    dtype = pdt(cfg)
    state: StateDict = {}
    for path, arr in _flatten(params_np).items():
        arr = np.array(arr, dtype=np.float32)  # a writable copy
        if path.startswith("layers."):
            if arr.shape[0] != cfg.n_layers:
                raise ValueError(f"{path}: leading axis {arr.shape[0]} is "
                                 f"not the layer count {cfg.n_layers}")
            rest = path[len("layers."):]
            for i in range(cfg.n_layers):
                state[f"layers.{i}.{rest}"] = torch.from_numpy(
                    arr[i]).to(device=device, dtype=dtype)
        else:
            state[path] = torch.from_numpy(arr).to(device=device,
                                                   dtype=dtype)
    return state


def init_params(cfg, generator: torch.Generator,
                device: torch.device) -> StateDict:
    """The port's own init, with the reference's scheme
    (``layers.normal_init``: standard normal x fan_in^-0.5 in f32, cast to
    the param dtype; norm scales one, biases zero). The draws differ from
    JAX's; ``generator`` must live on ``device``."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    dt = pdt(cfg)

    def w(shape, fan_in):
        return normal_init(shape, fan_in, dt, generator, device)

    def norm(prefix, state):
        state[f"{prefix}.scale"] = torch.ones(d, dtype=dt, device=device)
        if cfg.norm == "layernorm":
            state[f"{prefix}.bias"] = torch.zeros(d, dtype=dt, device=device)

    state: StateDict = {}
    for i in range(cfg.n_layers):
        p = f"layers.{i}"
        norm(f"{p}.ln1", state)
        state[f"{p}.attn.wq"] = w((d, H, hd), d)
        state[f"{p}.attn.wk"] = w((d, Hkv, hd), d)
        state[f"{p}.attn.wv"] = w((d, Hkv, hd), d)
        state[f"{p}.attn.wo"] = w((H, hd, d), H * hd)
        if cfg.qk_norm:
            state[f"{p}.attn.q_norm"] = torch.ones(hd, dtype=dt,
                                                   device=device)
            state[f"{p}.attn.k_norm"] = torch.ones(hd, dtype=dt,
                                                   device=device)
        norm(f"{p}.ln2", state)
        state[f"{p}.mlp.up"] = w((d, f), d)
        state[f"{p}.mlp.down"] = w((f, d), f)
        if cfg.activation == "swiglu":
            state[f"{p}.mlp.gate"] = w((d, f), d)
    state["embed.tok"] = w((cfg.padded_vocab, d), d)
    if not cfg.tie_embeddings:
        state["embed.unembed"] = w((d, cfg.padded_vocab), d)
    norm("final_norm", state)
    return state
