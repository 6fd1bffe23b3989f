"""Weights of the port's models: its own seeded init, and the bridge that
carries the JAX reference's parameters across.

Both return a state dict for the port's ``Transformer`` or ``Hybrid``
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

The hybrid's Mamba2 layers are stacked differently in the reference: its
``groups`` leaves (n_groups, every, ...) and ``tail`` leaves (tail, ...)
become ``layers.{g * every + i}.*`` and ``layers.{n_groups * every +
i}.*``; its ``shared_block`` is the port's one shared ``Block``. Mamba2's
``A_log``, ``D`` and ``dt_bias`` stay f32 whatever the param dtype, as in
the reference.

``to_jax_params`` is the bridge's inverse: it restacks a port state dict
into the reference's pytree (how the port's training loop writes its
checkpoints in the reference's layout), and ``reference_ndim`` gives each
port leaf the rank of the reference leaf it came from (what AdamW's
decay mask reads, ``decay_mask``). ``_split_layers`` (reference to
port) and ``_stacked_axes`` (port to reference) state the layout
mapping; the public functions go through them.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.layers import normal_init, pdt
from repro_torch.models.ssm import F32_LEAVES, mamba2_dims

StateDict = Dict[str, torch.Tensor]


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts and lists -> {dotted path: array}; list items are named
    by their index (``dense0.0.mlp.up``). Tensor leaves (a reference
    checkpoint read by ``repro_torch.checkpoint``, bf16 ones too) come out
    as f32 arrays."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, Sequence) and not isinstance(tree, str):
        items = enumerate(tree)
    elif isinstance(tree, torch.Tensor):
        return {prefix[:-1]: tree.detach().float().cpu().numpy()}
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for name, leaf in items:
        out.update(_flatten(leaf, f"{prefix}{name}."))
    return out


def _split_layers(path: str, arr: np.ndarray, cfg) -> Dict[str, np.ndarray]:
    """One reference leaf -> the port's names for it: stacked layer axes
    split into ``layers.{i}.*``, everything else as it is."""
    head, _, rest = path.partition(".")
    if cfg.family == "hybrid" and head in ("groups", "tail"):
        every = cfg.shared_attn_every
        n_groups = cfg.n_layers // every
        if head == "groups":
            if arr.shape[:2] != (n_groups, every):
                raise ValueError(f"{path}: leading axes {arr.shape[:2]} are "
                                 f"not (n_groups, every) = "
                                 f"{(n_groups, every)}")
            arr = arr.reshape((n_groups * every,) + arr.shape[2:])
            first = 0
        else:
            first = n_groups * every
            if arr.shape[0] != cfg.n_layers - first:
                raise ValueError(f"{path}: leading axis {arr.shape[0]} is "
                                 f"not the tail count {cfg.n_layers - first}")
        return {f"layers.{first + i}.{rest}": arr[i]
                for i in range(arr.shape[0])}
    if head == "layers":
        n_stacked = cfg.n_layers - (cfg.moe.first_dense_layers
                                    if cfg.moe.enabled else 0)
        if arr.shape[0] != n_stacked:
            raise ValueError(f"{path}: leading axis {arr.shape[0]} is "
                             f"not the stacked layer count {n_stacked}")
        return {f"layers.{i}.{rest}": arr[i] for i in range(n_stacked)}
    return {path: arr}


def from_jax_params(params_np: Mapping, cfg, device: torch.device,
                    dtype: Optional[torch.dtype] = None) -> StateDict:
    """The reference's params pytree (nested dicts and lists of numpy
    arrays, e.g. ``jax.device_get(model.init(key))``, or of CPU tensors,
    e.g. a reference checkpoint loaded by ``repro_torch.checkpoint``) ->
    the port's state dict on ``device``, in ``cfg.param_dtype``
    (``F32_LEAVES`` in f32), or every leaf in ``dtype`` when it is given
    (AdamW's f32 moments, which are keyed like the parameters)."""
    state: StateDict = {}
    for path, arr in _flatten(params_np).items():
        arr = np.array(arr, dtype=np.float32)  # a writable copy
        for name, a in _split_layers(path, arr, cfg).items():
            leaf_dtype = dtype or (
                torch.float32 if name.rsplit(".", 1)[-1] in F32_LEAVES
                else pdt(cfg))
            state[name] = torch.from_numpy(np.ascontiguousarray(a)).to(
                device=device, dtype=leaf_dtype)
    return state


def _stacked_axes(name: str, cfg) -> Tuple[str, int, int]:
    """Where the port leaf ``name`` sits in the reference's pytree: (the
    reference's path, its index on the stacked layer axes (0 when the leaf
    is not stacked), how many stacked axes lead there: 1 for ``layers``
    and the hybrid's ``tail``, 2 for its ``groups``, 0 for every other
    leaf, ``dense0.{j}.*`` and ``shared_block.*`` among them)."""
    head, _, rest = name.partition(".")
    if head != "layers":
        return name, 0, 0
    i, _, leaf = rest.partition(".")
    i = int(i)
    if cfg.family == "hybrid":
        every = cfg.shared_attn_every
        n_grouped = (cfg.n_layers // every) * every
        if i < n_grouped:
            return f"groups.{leaf}", i, 2
        return f"tail.{leaf}", i - n_grouped, 1
    return f"layers.{leaf}", i, 1


def reference_ndim(name: str, shape: Sequence[int], cfg) -> int:
    """The rank of the reference leaf that the port leaf ``name`` (of
    ``shape``) came from: the reference stacks ``layers`` on one leading
    axis and the hybrid's ``groups`` on two, ``tail`` on one."""
    return len(shape) + _stacked_axes(name, cfg)[2]


def decay_mask(cfg, state: Mapping[str, torch.Tensor]) -> Dict[str, bool]:
    """Which leaves AdamW decays: those whose reference leaf is a matrix
    (ndim >= 2), the test the reference applies to its stacked pytree.
    So every per-layer norm scale decays (and for Zamba2 Mamba2's
    ``A_log``, ``D``, ``dt_bias`` and conv biases), where the port's own
    1-D leaves would say otherwise; ``final_norm``, ``dense0`` and
    ``shared_block`` vectors do not."""
    return {name: reference_ndim(name, t.shape, cfg) >= 2
            for name, t in state.items()}


def to_jax_params(state: Mapping[str, torch.Tensor], cfg,
                  device="cpu") -> dict:
    """The inverse of ``from_jax_params``: a port state dict (parameters,
    or AdamW moments keyed like them) -> the reference's params pytree,
    nested dicts with ``layers`` (and the hybrid's ``groups`` (n_groups,
    every, ...) and ``tail``) stacked on their leading axes and
    ``dense0`` a list. Leaves are tensors on ``device`` (the host by
    default; ``"meta"`` gives the shapes alone) in their own dtypes: a
    bf16 leaf stays bf16 (numpy has no bf16; ``repro_torch.checkpoint``
    writes a bf16 tensor as the reference writes its bf16 arrays)."""
    stacks: Dict[str, Dict[int, torch.Tensor]] = {}
    flat: Dict[str, torch.Tensor] = {}
    for name, t in state.items():
        t = t.detach().to(device)
        path, i, n_axes = _stacked_axes(name, cfg)
        if n_axes:
            stacks.setdefault(path, {})[i] = t
        else:
            flat[path] = t
    every = cfg.shared_attn_every
    for path, rows in stacks.items():
        leaf = torch.stack([rows[i] for i in range(len(rows))])
        if path.startswith("groups."):
            leaf = leaf.reshape((-1, every) + leaf.shape[1:])
        flat[path] = leaf
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *heads, last = path.split(".")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = t
    if "dense0" in tree:
        tree["dense0"] = [tree["dense0"][str(j)]
                          for j in range(len(tree["dense0"]))]
    return tree


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

    def zeros(n, dtype=dt):
        return torch.zeros(n, dtype=dtype, device=device)

    def norm(prefix, state, n=d):
        state[f"{prefix}.scale"] = ones(n)
        if cfg.norm == "layernorm":
            state[f"{prefix}.bias"] = zeros(n)

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

    def mamba(p, state):
        s = cfg.ssm
        d_in, n_heads, _ = mamba2_dims(cfg)
        bc = 2 * s.n_groups * s.state_dim
        K = s.conv_dim
        state[f"{p}.w_zx"] = w((d, 2 * d_in), d)
        state[f"{p}.w_bcdt"] = w((d, bc + n_heads), d)
        state[f"{p}.conv_x_w"] = w((K, d_in), K)
        state[f"{p}.conv_x_b"] = zeros(d_in)
        state[f"{p}.conv_bc_w"] = w((K, bc), K)
        state[f"{p}.conv_bc_b"] = zeros(bc)
        state[f"{p}.A_log"] = zeros(n_heads, torch.float32)   # A = -1
        state[f"{p}.D"] = torch.ones(n_heads, dtype=torch.float32,
                                     device=device)
        state[f"{p}.dt_bias"] = zeros(n_heads, torch.float32)
        norm(f"{p}.norm", state, d_in)
        state[f"{p}.out_proj"] = w((d_in, d), d_in)

    state: StateDict = {}
    if cfg.family == "hybrid":
        block("shared_block", state, False, cfg.d_ff)
        for i in range(cfg.n_layers):
            norm(f"layers.{i}.ln", state)
            mamba(f"layers.{i}.mamba", state)
    else:
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
