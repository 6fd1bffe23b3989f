"""Weights of the port's models: its own seeded init, and the bridge that
carries the JAX reference's parameters across.

Both return a state dict for ``repro_torch.models.transformer.Transformer``
whose names follow the reference's pytree paths. The reference stacks every
layer's leaves along a leading layer axis (``transformer.py:210-222``): the
bridge splits that axis into ``layers.{i}.*``; a MoE config's leading dense
layers are a Python list there (``params["dense0"]``) and ``dense0.{j}.*``
here. Every other layout is kept as it is: ``wq``/``wk``/``wv`` (d, H|Hkv,
hd), ``wo`` (H, hd, d), MLP ``up``/``gate`` (d, f) and ``down`` (f, d), the
vocab-padded ``embed.tok`` (V_pad, d) (and ``embed.unembed`` (d, V_pad)
when untied); MLA's ``wq`` (d, H, dn+dr), ``w_dkv`` (d, R+dr), ``w_uk``
(R, H, dn), ``w_uv`` (R, H, dv), ``wo`` (H, dv, d), ``kv_norm`` (R,); MoE's
``router`` (d, E), experts ``up``/``gate`` (E, d, f) and ``down`` (E, f,
d), and the shared experts' MLP.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from repro_torch.models.layers import normal_init, pdt

StateDict = Dict[str, torch.Tensor]


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts and lists -> {dotted path: array}; list items are named
    by their index (``dense0.0.mlp.up``)."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, Sequence) and not isinstance(tree, str):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for name, leaf in items:
        out.update(_flatten(leaf, f"{prefix}{name}."))
    return out


def from_jax_params(params_np: Mapping, cfg,
                    device: torch.device) -> StateDict:
    """The reference's params pytree (nested dicts and lists of numpy
    arrays, e.g. ``jax.device_get(model.init(key))``) -> the port's state
    dict on ``device``, in ``cfg.param_dtype``."""
    dtype = pdt(cfg)
    n_stacked = cfg.n_layers - (cfg.moe.first_dense_layers
                                if cfg.moe.enabled else 0)
    state: StateDict = {}
    for path, arr in _flatten(params_np).items():
        arr = np.array(arr, dtype=np.float32)  # a writable copy
        if path.startswith("layers."):
            if arr.shape[0] != n_stacked:
                raise ValueError(f"{path}: leading axis {arr.shape[0]} is "
                                 f"not the stacked layer count {n_stacked}")
            rest = path[len("layers."):]
            for i in range(n_stacked):
                state[f"layers.{i}.{rest}"] = torch.from_numpy(
                    arr[i]).to(device=device, dtype=dtype)
        else:
            state[path] = torch.from_numpy(arr).to(device=device,
                                                   dtype=dtype)
    return state


def init_params(cfg, generator: torch.Generator,
                device: torch.device) -> StateDict:
    """The port's own init, with the reference's scheme and fan-ins
    (``layers.normal_init``: standard normal x fan_in^-0.5 in f32, cast to
    the param dtype; norm scales one, biases zero; ``init_mla`` and
    ``init_moe`` for MLA and MoE blocks). The draws differ from JAX's;
    ``generator`` must live on ``device``."""
    d, H, Hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd, dt = cfg.resolved_head_dim, pdt(cfg)
    m, e = cfg.mla, cfg.moe

    def w(shape, fan_in):
        return normal_init(shape, fan_in, dt, generator, device)

    def ones(n):
        return torch.ones(n, dtype=dt, device=device)

    def norm(prefix, state):
        state[f"{prefix}.scale"] = ones(d)
        if cfg.norm == "layernorm":
            state[f"{prefix}.bias"] = torch.zeros(d, dtype=dt, device=device)

    def mlp(prefix, f, state):
        state[f"{prefix}.up"] = w((d, f), d)
        state[f"{prefix}.down"] = w((f, d), f)
        if cfg.activation == "swiglu":
            state[f"{prefix}.gate"] = w((d, f), d)

    def attention(p, state):
        if cfg.attention == "mla":
            q_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
            R = m.kv_lora_rank
            if m.q_lora_rank:
                state[f"{p}.w_dq"] = w((d, m.q_lora_rank), d)
                state[f"{p}.w_uq"] = w((m.q_lora_rank, H, q_dim),
                                       m.q_lora_rank)
            else:
                state[f"{p}.wq"] = w((d, H, q_dim), d)
            state[f"{p}.w_dkv"] = w((d, R + m.qk_rope_head_dim), d)
            state[f"{p}.w_uk"] = w((R, H, m.qk_nope_head_dim), R)
            state[f"{p}.w_uv"] = w((R, H, m.v_head_dim), R)
            state[f"{p}.wo"] = w((H, m.v_head_dim, d), H * m.v_head_dim)
            state[f"{p}.kv_norm"] = ones(R)
            return
        state[f"{p}.wq"] = w((d, H, hd), d)
        state[f"{p}.wk"] = w((d, Hkv, hd), d)
        state[f"{p}.wv"] = w((d, Hkv, hd), d)
        state[f"{p}.wo"] = w((H, hd, d), H * hd)
        if cfg.qk_norm:
            state[f"{p}.q_norm"] = ones(hd)
            state[f"{p}.k_norm"] = ones(hd)

    def moe(p, state):
        E, f = e.n_experts, e.d_ff
        state[f"{p}.router"] = w((d, E), d)
        state[f"{p}.experts.up"] = w((E, d, f), d)
        state[f"{p}.experts.down"] = w((E, f, d), f)
        if cfg.activation == "swiglu":
            state[f"{p}.experts.gate"] = w((E, d, f), d)
        if e.n_shared_experts:
            mlp(f"{p}.shared", (e.shared_d_ff or f) * e.n_shared_experts,
                state)

    def block(p, state, use_moe, d_ff):
        norm(f"{p}.ln1", state)
        attention(f"{p}.attn", state)
        norm(f"{p}.ln2", state)
        if use_moe:
            moe(f"{p}.moe", state)
        else:
            mlp(f"{p}.mlp", d_ff, state)

    state: StateDict = {}
    n_dense = e.first_dense_layers if e.enabled else 0
    for j in range(n_dense):
        block(f"dense0.{j}", state, False, e.dense_d_ff)
    for i in range(cfg.n_layers - n_dense):
        block(f"layers.{i}", state, e.enabled, cfg.d_ff)
    state["embed.tok"] = w((cfg.padded_vocab, d), d)
    if not cfg.tie_embeddings:
        state["embed.unembed"] = w((d, cfg.padded_vocab), d)
    norm("final_norm", state)
    return state
