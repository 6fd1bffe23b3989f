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
i}.*``; its ``shared_block`` is the port's one shared ``Block``. The
other families keep the reference's stack names and flatten their stacked
axes into one index (``_stacks``): xLSTM's ``slstm`` (G, ...) and
``mlstm`` (G, n_m, ...) are ``slstm.{g}.*`` and ``mlstm.{g * n_m +
i}.*``, the audio model's ``encoder`` and ``decoder`` ``encoder.{i}.*``
and ``decoder.{i}.*``, the VLM's ``self_groups`` (G, every, ...) and
``cross`` (G, ...) ``self_groups.{g * every + i}.*`` and ``cross.{g}.*``.
Each leaf takes the dtype its module declares (``_param_dtypes``): the
param dtype, or f32 where the reference keeps f32 whatever the param
dtype (Mamba2's ``A_log``, ``D`` and ``dt_bias``, the mLSTM's
``gate_bias``, the sLSTM's ``bias``, the VLM's gates).

``to_jax_params`` is the bridge's inverse: it restacks a port state dict
into the reference's pytree (how the port's training loop writes its
checkpoints in the reference's layout), and ``reference_ndim`` gives each
port leaf the rank of the reference leaf it came from (what AdamW's
decay mask reads, ``decay_mask``). ``_split_layers`` (reference to
port) and ``_stacked_axes`` (port to reference) state the layout
mapping; the public functions go through them.

On a mesh, ``launch.sharding.distribute_params`` places either state dict
(the port's init or the reference's parameters through
``from_jax_params``) by ``param_specs`` after ``build_model`` has loaded
it.
"""

from __future__ import annotations

import functools
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.layers import normal_init, pdt
from repro_torch.models.ssm import mamba2_dims, mlstm_dims
from repro_torch.models.transformer import kv_shape

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


def _stacks(cfg) -> Dict[str, Tuple[int, int]]:
    """The reference's stacked heads of a non-hybrid family: head -> (its
    block count, the size of its second stacked axis, or 1 when it has
    one stacked axis). Empty for the hybrid, whose stacks are renamed."""
    if cfg.family == "hybrid":
        return {}
    if cfg.family == "ssm":
        every = cfg.ssm.slstm_every
        g = cfg.n_layers // every
        return {"slstm": (g, 1), "mlstm": (g * (every - 1), every - 1)}
    if cfg.family == "audio":
        return {"encoder": (cfg.n_encoder_layers, 1),
                "decoder": (cfg.n_layers, 1)}
    if cfg.family == "vlm":
        every = cfg.cross_attn_every
        return {"self_groups": (cfg.n_layers // every * every, every),
                "cross": (cfg.n_layers // every, 1)}
    return {"layers": (cfg.n_layers - (cfg.moe.first_dense_layers
                                       if cfg.moe.enabled else 0), 1)}


def _split_layers(path: str, arr: np.ndarray, cfg) -> Dict[str, np.ndarray]:
    """One reference leaf -> the port's names for it: stacked layer axes
    split into ``{head}.{i}.*`` (the hybrid's into ``layers.{i}.*``),
    everything else as it is."""
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
    stacks = _stacks(cfg)
    if head in stacks:
        count, inner = stacks[head]
        lead = (count,) if inner == 1 else (count // inner, inner)
        if arr.shape[:len(lead)] != lead:
            raise ValueError(f"{path}: leading axes "
                             f"{arr.shape[:len(lead)]} are not the stacked "
                             f"block counts {lead}")
        arr = arr.reshape((count,) + arr.shape[len(lead):])
        return {f"{head}.{i}.{rest}": arr[i] for i in range(count)}
    return {path: arr}


@functools.lru_cache(maxsize=None)
def _param_dtypes(cfg) -> Dict[str, torch.dtype]:
    """Each parameter's dtype as ``cfg``'s model declares it (read from
    the model built on the meta device)."""
    from repro_torch.models.registry import _meta_model
    return {n: p.dtype for n, p in _meta_model(cfg).named_parameters()}


def from_jax_params(params_np: Mapping, cfg, device: torch.device,
                    dtype: Optional[torch.dtype] = None) -> StateDict:
    """The reference's params pytree (nested dicts and lists of numpy
    arrays, e.g. ``jax.device_get(model.init(key))``, or of CPU tensors,
    e.g. a reference checkpoint loaded by ``repro_torch.checkpoint``) ->
    the port's state dict on ``device``, each leaf in the dtype its module
    declares (``_param_dtypes``), or every leaf in ``dtype`` when it is
    given (AdamW's f32 moments, which are keyed like the parameters)."""
    state: StateDict = {}
    dtypes = _param_dtypes(cfg)
    for path, arr in _flatten(params_np).items():
        arr = np.array(arr, dtype=np.float32)  # a writable copy
        for name, a in _split_layers(path, arr, cfg).items():
            leaf_dtype = dtype or dtypes.get(name, pdt(cfg))
            # np.array, not ascontiguousarray: a stacked scalar (the
            # VLM's per-block gates) stays 0-d
            state[name] = torch.from_numpy(np.array(a)).to(
                device=device, dtype=leaf_dtype)
    return state


def _stacked_axes(name: str, cfg) -> Tuple[str, int, int]:
    """Where the port leaf ``name`` sits in the reference's pytree: (the
    reference's path, its index on the stacked layer axes flattened (0
    when the leaf is not stacked), how many stacked axes lead there: 1 for
    ``layers`` and the hybrid's ``tail``, 2 for its ``groups``, as
    ``_stacks`` says for the other families, 0 for every other leaf,
    ``dense0.{j}.*`` and ``shared_block.*`` among them)."""
    head, _, rest = name.partition(".")
    i, _, leaf = rest.partition(".")
    if cfg.family == "hybrid":
        if head != "layers":
            return name, 0, 0
        i = int(i)
        every = cfg.shared_attn_every
        n_grouped = (cfg.n_layers // every) * every
        if i < n_grouped:
            return f"groups.{leaf}", i, 2
        return f"tail.{leaf}", i - n_grouped, 1
    stacks = _stacks(cfg)
    if head not in stacks:
        return name, 0, 0
    return f"{head}.{leaf}", int(i), 1 if stacks[head][1] == 1 else 2


def reference_ndim(name: str, shape: Sequence[int], cfg) -> int:
    """The rank of the reference leaf that the port leaf ``name`` (of
    ``shape``) came from: the reference stacks ``layers`` on one leading
    axis and the hybrid's ``groups`` on two, ``tail`` on one (the other
    families as ``_stacks`` says)."""
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
    every, ...) and ``tail``, and the other families' stacks) stacked on
    their leading axes and
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
    inner = ({"groups": cfg.shared_attn_every} if cfg.family == "hybrid"
             else {h: n for h, (_, n) in _stacks(cfg).items()})
    for path, rows in stacks.items():
        leaf = torch.stack([rows[i] for i in range(len(rows))])
        n = inner.get(path.partition(".")[0], 1)
        if n > 1:
            leaf = leaf.reshape((-1, n) + leaf.shape[1:])
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
    ``init_moe`` for MLA and MoE blocks, ``init_mlstm`` and ``init_slstm``
    for xLSTM's, ``init_attention(cross=True)`` for cross-attention, the
    VLM's gates zero). The draws differ from JAX's;
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

    def attention(p, state, cross=False):
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
        kv_in, n_kv = kv_shape(cfg, cross)
        state[f"{p}.wq"] = w((d, H, hd), d)
        state[f"{p}.wk"] = w((kv_in, n_kv, hd), kv_in)
        state[f"{p}.wv"] = w((kv_in, n_kv, hd), kv_in)
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

    def mlstm(p, state):
        d_in, _ = mlstm_dims(cfg)
        state[f"{p}.up"] = w((d, 2 * d_in), d)
        for name in ("wq", "wk", "wv"):
            state[f"{p}.{name}"] = w((d_in, d_in), d_in)
        state[f"{p}.w_gates"] = w((d_in, 2 * H), d_in)
        state[f"{p}.gate_bias"] = torch.cat([
            zeros(H, torch.float32),
            torch.full((H,), 3.0, dtype=torch.float32, device=device)])
        norm(f"{p}.norm", state, d_in)
        state[f"{p}.down"] = w((d_in, d), d_in)

    def slstm(p, state):
        d_ff = int(d * cfg.ssm.slstm_proj_factor)
        state[f"{p}.w_in"] = w((d, 4 * d), d)
        state[f"{p}.w_rec"] = w((d, 4 * d), d)
        state[f"{p}.bias"] = zeros(4 * d, torch.float32)
        state[f"{p}.ffn_up"] = w((d, d_ff), d)
        state[f"{p}.ffn_down"] = w((d_ff, d), d_ff)
        norm(f"{p}.norm", state)

    state: StateDict = {}
    stacks = _stacks(cfg)
    if cfg.family == "hybrid":
        block("shared_block", state, False, cfg.d_ff)
        for i in range(cfg.n_layers):
            norm(f"layers.{i}.ln", state)
            mamba(f"layers.{i}.mamba", state)
    elif cfg.family == "ssm":
        for name, core in (("slstm", slstm), ("mlstm", mlstm)):
            for i in range(stacks[name][0]):
                norm(f"{name}.{i}.ln", state)
                core(f"{name}.{i}.core", state)
    elif cfg.family == "audio":
        for i in range(stacks["encoder"][0]):
            p = f"encoder.{i}"
            norm(f"{p}.ln1", state)
            attention(f"{p}.attn", state)
            norm(f"{p}.ln2", state)
            mlp(f"{p}.mlp", cfg.d_ff, state)
        for i in range(stacks["decoder"][0]):
            p = f"decoder.{i}"
            norm(f"{p}.ln1", state)
            attention(f"{p}.self", state)
            norm(f"{p}.ln2", state)
            attention(f"{p}.cross", state, cross=True)
            norm(f"{p}.ln3", state)
            mlp(f"{p}.mlp", cfg.d_ff, state)
        norm("enc_norm", state)
    elif cfg.family == "vlm":
        for j in range(stacks["self_groups"][0]):
            block(f"self_groups.{j}", state, False, cfg.d_ff)
        for g in range(stacks["cross"][0]):
            p = f"cross.{g}"
            norm(f"{p}.ln1", state)
            attention(f"{p}.xattn", state, cross=True)
            state[f"{p}.gate_attn"] = zeros((), torch.float32)
            norm(f"{p}.ln2", state)
            mlp(f"{p}.mlp", cfg.d_ff, state)
            state[f"{p}.gate_mlp"] = zeros((), torch.float32)
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
