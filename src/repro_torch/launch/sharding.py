"""Divisibility-aware sharding plans: logical rules and parameter, cache
and batch specs.

Port of ``repro.launch.sharding``. ``make_rules`` decides, per (arch,
shape suite, mesh), which logical activation axes map to which mesh axes,
checking every divisibility constraint, so the same code serves whisper's
12 heads (heads unsharded, d_ff sharded) and qwen3's 128 experts (8
experts a rank on a 16-way model axis). ``param_specs`` gives every
parameter a spec (one entry per dim: a mesh axis name, a tuple of names,
or None) by its name and shape; anything that fails a divisibility check
is replicated.

The port's parameter names are the reference's pytree paths with dots
(``layers.3.attn.wq`` for ``layers/attn/wq[3]``), so the reference's
patterns match the same names; a port leaf has no stacked layer axis, so
its spec is the trailing entries of the reference leaf's. Every function
takes a ``DeviceMesh`` or a shape-only stand-in whose ``shape`` is the
``{axis: size}`` dict (``models.sharding.mesh_sizes``). ``distribute``
and ``distribute_params`` turn specs into DTensors on a real mesh.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeSuite
from repro_torch.models.sharding import (Spec, as_dtensor, mesh_sizes,
                                         placements, same_layout)
from repro_torch.models.ssm import mamba2_dims


def _tp(mesh) -> int:
    return mesh_sizes(mesh).get("model", 1)


def _batch_axes(mesh, global_batch: int):
    """Largest batch sharding the batch size supports."""
    sizes = mesh_sizes(mesh)
    axes = []
    size = 1
    for name in ("pod", "data"):
        if name in sizes and global_batch % (size * sizes[name]) == 0:
            axes.append(name)
            size *= sizes[name]
    return tuple(axes) if axes else None


def make_rules(cfg: ModelConfig, mesh, suite: Optional[ShapeSuite]
               ) -> Dict[str, Any]:
    tp = _tp(mesh)
    gb = suite.global_batch if suite else 0
    rules: Dict[str, Any] = {}
    batch = _batch_axes(mesh, gb) if gb else ("data",)
    if batch:
        rules["batch"] = batch

    if cfg.family == "ssm":
        heads_ok = False                      # xlstm: 4 heads, replicated
    elif cfg.family == "hybrid":
        _, m_heads, _ = mamba2_dims(cfg)
        heads_ok = cfg.n_heads % tp == 0 and m_heads % tp == 0
    else:
        heads_ok = cfg.n_heads % tp == 0
    if heads_ok:
        rules["heads"] = "model"

    d_ff = cfg.d_ff or (cfg.moe.dense_d_ff if cfg.moe.enabled else 0)
    if d_ff and d_ff % tp == 0:
        rules["d_ff"] = "model"
    if cfg.padded_vocab % tp == 0:
        rules["vocab"] = "model"
    if cfg.moe.enabled and cfg.moe.n_experts % tp == 0:
        rules["experts"] = "model"

    # decode KV cache: batch over the data axes, cache-seq over the model
    # axis; when batch cannot shard (long_500k B=1) kv_seq takes pod too
    if suite is not None and suite.kind == "decode":
        if batch is None and "pod" in mesh_sizes(mesh):
            rules["kv_seq"] = ("pod", "model")
        else:
            rules["kv_seq"] = "model"
    return rules


# -------------------------------------------------------- parameter specs --
def _spec_from_trailing(name: str, shape: Tuple[int, ...], cfg: ModelConfig,
                        rules: Dict[str, Any], tp: int) -> Tuple:
    """Spec entries for the TRAILING (pattern) dims of a parameter."""
    heads = rules.get("heads")
    d_ff = rules.get("d_ff")
    vocab = rules.get("vocab")
    experts = rules.get("experts")

    def ok(dim_size, axes):
        if axes is None:
            return None
        n = 1
        for a in ((axes,) if isinstance(axes, str) else axes):
            n *= tp if a == "model" else 1
        return axes if dim_size % max(n, 1) == 0 else None

    if re.search(r"embed\.tok$", name):
        return (ok(shape[0], vocab), None)
    if re.search(r"embed\.unembed$", name):
        return (None, ok(shape[1], vocab))
    if re.search(r"(attn|self|cross|xattn)\.(wq|wk|wv|w_uk|w_uv)$", name) \
            and len(shape) >= 3:
        return (None, ok(shape[-2], heads), None)
    if re.search(r"(attn|self|cross|xattn)\.wo$", name) and len(shape) >= 3:
        return (ok(shape[-3], heads), None, None)
    if re.search(r"(mlp|shared)\.(up|gate)$", name):
        return (None, ok(shape[-1], d_ff))
    if re.search(r"(mlp|shared)\.down$", name):
        return (ok(shape[-2], d_ff), None)
    if re.search(r"experts\.(up|gate|down)$", name):
        return (ok(shape[-3], experts), None, None)
    if re.search(r"mamba\.w_zx$", name):
        return (None, ok(shape[-1], heads))      # [z|x]: both % tp == 0
    if re.search(r"mamba\.out_proj$", name):
        return (ok(shape[-2], heads), None)
    if re.search(r"mamba\.conv_x_w$", name):
        return (None, ok(shape[-1], heads))
    if re.search(r"mamba\.conv_x_b$", name):
        return (ok(shape[-1], heads),)
    return tuple(None for _ in shape)


def _named(params) -> Mapping[str, torch.Tensor]:
    return (dict(params.named_parameters()) if isinstance(params, nn.Module)
            else params)


def param_specs(params, cfg: ModelConfig, mesh,
                rules: Dict[str, Any]) -> Dict[str, Spec]:
    """{parameter name: spec} over a model (a meta model allocates
    nothing) or a {name: tensor} mapping."""
    tp = _tp(mesh)
    out = {}
    for name, leaf in _named(params).items():
        shape = tuple(leaf.shape)
        trailing = _spec_from_trailing(name, shape, cfg, rules, tp)
        trailing = trailing[-len(shape):] if shape else ()
        out[name] = (None,) * (len(shape) - len(trailing)) + tuple(trailing)
    return out


# ------------------------------------------------------------ cache specs --
def cache_specs(cache: Mapping[str, torch.Tensor], cfg: ModelConfig, mesh,
                rules: Dict[str, Any], batch: int, cache_len: int
                ) -> Dict[str, Spec]:
    """Shard cache leaves: the first axis equal to ``batch`` gets the batch
    rule, the first equal to the kv length (``cache_len``, or the window
    of a ring buffer) the kv_seq rule. Sizes are unique per cell in
    practice, so matching by size is unambiguous, as in the reference."""
    batch_axes = rules.get("batch")
    kv_axes = rules.get("kv_seq")
    window = cfg.sliding_window or 0
    kv_sizes = {cache_len}
    if window:
        kv_sizes.add(min(window, cache_len))
    sizes = mesh_sizes(mesh)

    def n_shards(axes):
        n = 1
        for a in ((axes,) if isinstance(axes, str) else (axes or ())):
            n *= sizes[a]
        return n

    def spec_for(leaf):
        entries = []
        used_batch = used_kv = False
        for dim in leaf.shape:
            if (not used_batch and batch_axes and dim == batch
                    and dim % n_shards(batch_axes) == 0):
                entries.append(batch_axes)
                used_batch = True
            elif (not used_kv and kv_axes and dim in kv_sizes
                    and dim % n_shards(kv_axes) == 0):
                entries.append(kv_axes)
                used_kv = True
            else:
                entries.append(None)
        return tuple(entries)

    return {n: spec_for(leaf) for n, leaf in cache.items()}


def batch_specs(batch: Mapping[str, torch.Tensor],
                rules: Dict[str, Any]) -> Dict[str, Spec]:
    """Input batches: leading dim -> batch axes, everything else
    replicated."""
    b = rules.get("batch")
    return {k: (b,) + (None,) * (leaf.dim() - 1) for k, leaf in batch.items()}


def bytes_per_rank(params, specs: Mapping[str, Spec], mesh) -> int:
    """Bytes of parameters one rank holds under ``specs``: every dim cut
    by the mesh axes its entry names (the larger shard where it does not
    divide). Reads shapes only: a meta model or a shape-only mesh will
    do."""
    sizes = mesh_sizes(mesh)
    total = 0
    for name, p in _named(params).items():
        n = 1
        for dim, entry in zip(p.shape, specs[name]):
            ext = 1
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                ext *= sizes[a]
            n *= -(-dim // ext)
        total += n * p.element_size()
    return total


# ------------------------------------------------------------ placement ----
def distribute(x: torch.Tensor, mesh, spec: Spec):
    """x placed by ``spec`` on ``mesh``: a DTensor redistributed (a no-op
    where it lies so already, ``models.sharding.same_layout``), a plain
    tensor every rank holds whole cut to its shard, without
    communication."""
    pl = placements(spec, mesh)
    x = as_dtensor(x, mesh)
    return x if same_layout(x.placements, pl, mesh) else x.redistribute(
        mesh, pl)


def distribute_params(model: nn.Module, mesh,
                      specs: Mapping[str, Spec]) -> nn.Module:
    """Swap every parameter for a DTensor parameter placed by its spec
    (``param_specs``), in place, keeping its ``requires_grad``. Returns
    the model."""
    for prefix, mod in model.named_modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            full = f"{prefix}.{name}" if prefix else name
            setattr(mod, name, nn.Parameter(
                distribute(p.detach(), mesh, specs[full]),
                requires_grad=p.requires_grad))
    return model
