"""Logical-axis sharding for the port's model code, on a torch DeviceMesh.

Port of ``repro.models.sharding``. Model code annotates activations with
*logical* axis names (``batch``, ``seq``, ``heads``, ``kv_heads``,
``d_model``, ``d_ff``, ``vocab``, ``experts``, ``kv_seq``, ``state``); the
launcher maps them to mesh axes (``batch -> ("pod", "data")``, ``heads ->
"model"``) with ``set_rules``. With no mesh or no rules installed every
annotation is a no-op that returns its input, so the same model code runs
on one device and on a mesh unchanged.

Where the reference lowers a ``PartitionSpec`` to XLA, the port turns it
into placements of ``torch.distributed.tensor`` (DTensor): ``placements``
gives one ``Shard(dim)`` or ``Replicate()`` per mesh dim, and ``shard``
redistributes a DTensor to them (a plain tensor is taken as the same
global value on every rank). The values never change, only where they
live; a ``Partial`` sum reaching ``shard`` is reduced there.

Code that DTensor cannot run sharded (a kernel, an indexed write into a
cache, a capacity gather) runs in ``local``: ``local_map`` hands the
function each rank's shards as plain tensors under placements taken from
the same logical names, and wraps its outputs back. A rank's gradient of
an input it holds whole but uses only in part (the router and tokens of
the expert-parallel MoE, Mamba2's B and C, K/V every rank reads whole) is
its share of a sum (``grad_placements``), as the transpose of the
reference's ``shard_map`` makes it.

The reference's ``layer_scan``, ``set_layer_unroll`` and ``layer_unroll``
have no counterpart: they switch ``lax.scan`` over the layer stack to a
fully unrolled scan so XLA's cost analysis sees every layer. The port's
layers are a Python loop, run once per layer already, and its analysis
tools (the dry-run, to come) count executed operations, not a lowered
program.
"""

from __future__ import annotations

import contextlib
import threading
from contextlib import contextmanager
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch

MeshAxes = Union[str, Tuple[str, ...], None]
Spec = Tuple[MeshAxes, ...]
Axes = Optional[Sequence[Optional[str]]]

_state = threading.local()


def _get() -> Tuple[Optional[Any], Dict[str, MeshAxes]]:
    return getattr(_state, "mesh", None), getattr(_state, "rules", {})


def set_rules(mesh, rules: Optional[Dict[str, MeshAxes]]) -> None:
    _state.mesh = mesh
    _state.rules = dict(rules or {})


@contextmanager
def sharding_rules(mesh, rules: Optional[Dict[str, MeshAxes]]):
    prev = _get()
    set_rules(mesh, rules)
    try:
        yield
    finally:
        set_rules(*prev)


@contextmanager
def on_mesh(mesh, rules: Optional[Dict[str, MeshAxes]]):
    """``sharding_rules`` with DTensor's implicit replication: a plain
    tensor made inside the model (positions, masks, a zero accumulator)
    meets DTensors as a tensor every rank holds whole. The step builders
    run their cells in it."""
    from torch.distributed.tensor.experimental import implicit_replication
    with sharding_rules(mesh, rules), implicit_replication():
        yield


def remat(fn: Callable, *args, **kwargs):
    """``torch.utils.checkpoint`` (non-reentrant) of ``fn(*args,
    **kwargs)`` whose recomputation runs under the rules it ran under:
    the backward pass may recompute on autograd's own thread, where this
    module's thread-local mesh and rules are not installed."""
    from torch.utils.checkpoint import checkpoint
    mesh, rules = _get()
    if mesh is None or not rules:
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)

    def contexts():
        return contextlib.nullcontext(), on_mesh(mesh, rules)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=contexts,
                      **kwargs)


def current_mesh():
    return _get()[0]


def current_rules() -> Dict[str, MeshAxes]:
    return dict(_get()[1])


def active() -> bool:
    """True when a mesh and rules are installed: annotations take effect."""
    mesh, rules = _get()
    return mesh is not None and bool(rules)


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a shape-only stand-in
    whose ``shape`` is already that dict (the reference tests'
    ``FakeMesh``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _flat(axes: MeshAxes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def logical_to_spec(logical_axes: Sequence[Optional[str]]) -> Spec:
    """One entry per dim under the current rules: a mesh axis name, a
    tuple of names, or None. A mesh axis already used by an earlier dim
    is dropped, as the reference does."""
    _, rules = _get()
    parts = []
    used: set = set()
    for name in logical_axes:
        flat = _flat(rules.get(name) if name else None)
        flat = tuple(a for a in flat if a not in used)
        used.update(flat)
        if not flat:
            parts.append(None)
        elif len(flat) == 1:
            parts.append(flat[0])
        else:
            parts.append(flat)
    return tuple(parts)


def placements(spec: Spec, mesh) -> tuple:
    """A spec -> one placement per mesh dim: ``Shard(d)`` where tensor dim
    d names the mesh dim, else ``Replicate()``. A dim naming several mesh
    dims is split by each in mesh order, as a tuple entry is split
    major-to-minor in the reference."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, entry in enumerate(spec) if name in _flat(entry)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def axis_placements(logical_axes: Sequence[Optional[str]]) -> tuple:
    """``placements`` of the current rules' spec for these names."""
    return placements(logical_to_spec(logical_axes), current_mesh())


def same_layout(a: Sequence, b: Sequence, mesh) -> bool:
    """Two placements lay a tensor out alike: they agree on every mesh dim
    of more than one rank (on a dim of one rank every placement holds the
    whole value, so the one-card mesh never moves data)."""
    return all(x == y or mesh.size(i) == 1
               for i, (x, y) in enumerate(zip(a, b)))


def as_dtensor(x: torch.Tensor, mesh=None):
    """A plain tensor, the same on every rank, as a replicated DTensor;
    a DTensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        return x
    mesh = mesh or current_mesh()
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def shard(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Place x by logical axis names (no-op without a mesh and rules): the
    DTensor counterpart of ``with_sharding_constraint``."""
    if not active():
        return x
    if x.dim() != len(logical_axes):
        raise ValueError(
            f"shard(): rank {x.dim()} array got {len(logical_axes)} axis "
            f"names")
    pl = axis_placements(logical_axes)
    x = as_dtensor(x)
    if same_layout(x.placements, pl, x.device_mesh):
        return x
    return x.redistribute(x.device_mesh, pl)


def axis_size(logical: str) -> int:
    """Size of the mesh extent a logical axis maps to (1 if unmapped)."""
    mesh, rules = _get()
    axes = rules.get(logical)
    if mesh is None or axes is None:
        return 1
    sizes = mesh_sizes(mesh)
    n = 1
    for a in _flat(axes):
        n *= sizes[a]
    return n


def axis_index(logical: str) -> int:
    """This rank's coordinate along the mesh extent a logical axis maps to
    (0 if unmapped): the index of its shard, the first named axis major."""
    mesh, rules = _get()
    axes = rules.get(logical)
    if mesh is None or axes is None:
        return 0
    sizes = mesh_sizes(mesh)
    idx = 0
    for a in _flat(axes):
        idx = idx * sizes[a] + mesh.get_local_rank(a)
    return idx


def lies_as(x: torch.Tensor, logical_axes: Sequence[Optional[str]]) -> bool:
    """x is a DTensor laid out as the current rules place these logical
    names (``same_layout``): a ``local`` region taking it so hands ``fn``
    its own shards, and an in-place write reaches it."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor) and same_layout(
        x.placements, axis_placements(logical_axes), x.device_mesh)


def mesh_axes(logical: Optional[str]) -> Tuple[str, ...]:
    """The mesh axes the current rules map a logical axis to (none when
    unmapped)."""
    return _flat(_get()[1].get(logical)) if logical else ()


def all_reduce(t: torch.Tensor, op: str, logical: str) -> torch.Tensor:
    """Inside a ``local`` region: this rank's ``t`` reduced by ``op``
    ("sum", "max") over the mesh dims of more than one rank that
    ``logical`` maps to, one dim after another, by functional collectives
    (``launch.hlo``'s counter sees them); ``t`` itself where there are
    none."""
    import torch.distributed._functional_collectives as funcol
    mesh = current_mesh()
    names = set(mesh_axes(logical))
    for i, name in enumerate(mesh.mesh_dim_names):
        if name in names and mesh.size(i) > 1:
            t = funcol.wait_tensor(funcol.all_reduce(t, op, (mesh, i)))
    return t


def _partial_on(pl: tuple, logical: Optional[str], mesh) -> tuple:
    """``pl`` with ``Partial()`` on the mesh dims of more than one rank
    that ``logical`` maps to (a sum of the ranks' shares there)."""
    from torch.distributed.tensor import Partial
    _, rules = _get()
    summed = set(_flat(rules.get(logical))) if logical else set()
    return tuple(Partial() if name in summed and mesh.size(i) > 1 else p
                 for i, (name, p) in enumerate(zip(mesh.mesh_dim_names,
                                                   pl)))


def grad_placements(in_pl: Sequence[tuple], out_pl: Sequence[tuple],
                    mesh) -> list:
    """The placements of the gradients ``local`` hands back for inputs
    placed ``in_pl``, given outputs placed ``out_pl``. On a mesh dim of
    more than one rank where some input or output is not replicated, the
    ranks do different work, so a rank's gradient for an input it holds
    whole (``Replicate``) is only its share: ``Partial``, summed where
    it is used (the reference's ``shard_map`` transpose does the same).
    Elsewhere a gradient is placed as its input."""
    from torch.distributed.tensor import Partial
    split = [mesh.size(i) > 1 and any(
        not pl[i].is_replicate() for pl in list(in_pl) + list(out_pl))
        for i in range(mesh.ndim)]
    return [tuple(Partial() if split[i] and p.is_replicate() else p
                  for i, p in enumerate(pl)) for pl in in_pl]


def local(fn: Callable, in_axes: Sequence[Axes], out_axes: Sequence[Axes],
          summed: Optional[str] = None) -> Callable:
    """``fn`` run on each rank's shards: positional argument i is placed
    by the logical names ``in_axes[i]`` (None: passed as it is, a
    non-tensor or a tensor every rank holds whole), ``fn`` sees plain
    local tensors, and its outputs (a tuple of them, one, or None) become
    DTensors placed by ``out_axes``; with ``summed``, a logical axis,
    each output is this rank's share of a sum over the mesh dims it maps
    to (``Partial``), reduced where it is next placed. Gradients come
    back placed by ``grad_placements``. With no mesh and no rules,
    ``fn`` itself. Through ``torch.distributed.tensor.experimental.
    local_map`` with ``redistribute_inputs``: an input is redistributed
    where its placement lays it out otherwise (``same_layout``); an
    in-place write inside ``fn`` reaches the caller's DTensor only when
    it was not."""
    if not active():
        return fn
    from torch.distributed.tensor.experimental import local_map
    mesh = current_mesh()
    out_pl = tuple(None if a is None
                   else _partial_on(axis_placements(a), summed, mesh)
                   for a in out_axes)

    def run(*args):
        slots = [i for i, (a, ax) in enumerate(zip(args, in_axes))
                 if ax is not None and a is not None]
        tensors = [as_dtensor(args[i], mesh) for i in slots]
        in_pl = []
        for t, i in zip(tensors, slots):
            pl = axis_placements(in_axes[i])
            in_pl.append(tuple(t.placements)
                         if same_layout(t.placements, pl, mesh) else pl)

        def inner(*local_tensors):
            full = list(args)
            for i, t in zip(slots, local_tensors):
                full[i] = t
            return fn(*full)

        # one output's placements go as a list (local_map reads a tuple
        # as one placement sequence per output), no output as None
        wrapped = local_map(inner, out_placements=(
            list(out_pl[0]) if len(out_pl) == 1 else out_pl or None),
            in_placements=tuple(in_pl),
            in_grad_placements=tuple(grad_placements(
                in_pl, [pl for pl in out_pl if pl is not None], mesh)),
            device_mesh=mesh, redistribute_inputs=True)
        return wrapped(*tensors)

    return run


def write_back(dst: torch.Tensor, src: torch.Tensor) -> None:
    """After in-place writes into ``src = shard(dst, ...)`` (dst placed as
    a local region needs it, a copy where that moves data): copy src's
    value into dst's own shards (a no-op when src is dst)."""
    if src is dst:
        return
    from torch.distributed.tensor import DTensor
    if isinstance(dst, DTensor):
        dst.to_local().copy_(src.redistribute(
            dst.device_mesh, dst.placements).to_local())
    else:
        dst.copy_(src.full_tensor() if isinstance(src, DTensor) else src)
