"""Counters for the dry-run: FLOPs, bytes, collective bytes and memory of
what one rank runs.

Port of ``repro.launch.hlo``. The reference parses the HLO text of a
compiled program; the port runs a cell once in eager mode (in the dry-run
over fake tensors, on a fake world of ranks: ``launch.dryrun``) under
``Counter``, a ``TorchDispatchMode`` that sees every aten op rank 0 runs.

Like torch's ``CommDebugMode``, the mode returns ``NotImplemented`` for an
op with DTensor arguments: DTensor then runs the op on its local shards
and issues the collectives its redistributions and ``Partial`` reductions
need inside its own dispatch, and the mode sees those local ops and
collectives. So every count is of what one rank runs on its shards,
``sharding.local`` regions included. (torch's ``FlopCounterMode`` counts
a DTensor op at its global shape and an op in a ``local`` region at the
shard's: two scales in one sum. A plain dispatch mode that takes DTensor
ops whole misses the collectives DTensor issues.)

What ``Counter`` records:

* FLOPs, by ``torch.utils.flop_counter``'s registry of formulas; an op
  with no formula that has a decomposition is decomposed and its parts
  counted, as ``FlopCounterMode`` does;
* pre-fusion bytes accessed: the input plus output bytes of every op that
  returns a tensor and is not a view (the counterpart of XLA's ``bytes
  accessed``: an upper bound, nothing is fused);
* collective bytes by kind, each collective sized by its result, the
  reference's convention: exact for all-reduce and all-to-all, received
  bytes for all-gather, the shard for reduce-scatter. ``wait_tensor`` is
  not counted, as the reference skips ``-done``;
* an op log (``overloadpacket`` names, ``aten.mm``), read by ``count_ops``;
* rank 0's memory, by a small tracker of storage lifetimes of its own
  (not torch's private ``MemTracker``): the bytes of the arguments' local
  shards, and the peak of the bytes of storages made during the run and
  still alive. Fake storages are tracked as real ones.

DTensor's sharding propagation runs each new op signature once on fake
tensors of the global shapes (to learn the output's shape) and works out
its cost model with torch ops: that is bookkeeping, cached after the
first call, not work a rank does. ``run_counted`` pauses the counter
while the propagator runs, so a run counts the same whether the cache is
cold or warm.

The reference's ``transcendentals`` and ``optimal_seconds`` are fields of
XLA's cost analysis with no counterpart here; they are left out.
"""

from __future__ import annotations

import weakref
from collections import defaultdict
from contextlib import contextmanager
from typing import Any, Dict, Iterable, List

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# funcol op name -> the reference's kind; namespaces DTensor issues them in
_KINDS = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
          "reduce_scatter_tensor": "reduce-scatter",
          "all_to_all_single": "all-to-all"}
_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd")


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def local_tensors(tree) -> List[torch.Tensor]:
    """The tensors of ``tree`` as this rank holds them: a DTensor's local
    shard, a plain tensor as it is."""
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in _tensors(tree)]


class Counter(TorchDispatchMode):
    """Counts what this rank runs while it is entered (see the module)."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives: Dict[str, int] = defaultdict(int)
        self.log: List[str] = []
        self.argument_bytes = 0
        self.output_bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages: Dict[int, int] = {}    # storage key -> bytes made
        self._arguments: set = set()
        self._paused = 0

    # ------------------------------------------------------- memory ------
    def track_arguments(self, tree) -> None:
        """Count ``tree``'s local shards as the arguments (not made by the
        run). Call before entering."""
        for t in local_tensors(tree):
            key = t.untyped_storage()._cdata
            if key not in self._arguments:
                self._arguments.add(key)
                self.argument_bytes += _nbytes(t)

    def track_outputs(self, tree) -> None:
        """Count the storages of ``tree``'s local shards that the run made
        as the outputs. Call after leaving."""
        seen = set()
        for t in local_tensors(tree):
            key = t.untyped_storage()._cdata
            if key in self._storages and key not in seen:
                seen.add(key)
                self.output_bytes += self._storages[key]

    def _made(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages or key in self._arguments:
                continue
            n = st.nbytes()
            self._storages[key] = n
            self.live_bytes += n
            weakref.finalize(st, self._freed, key)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _freed(self, key: int) -> None:
        self.live_bytes -= self._storages.pop(key, 0)

    # ------------------------------------------------------- dispatch ----
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if self._paused:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        ns = func.namespace
        if ns in _COLLECTIVE_NS:
            out = func(*args, **kwargs)
            name = func._opname.rstrip("_")
            if name != "wait_tensor":
                kind = _KINDS.get(name, name.replace("_", "-"))
                n = sum(_nbytes(t) for t in _tensors(out))
                self.collectives[kind] += n
                self.collectives["total"] += n
                self.log.append(str(packet))
            self._made(out)
            return out
        if packet not in flop_registry and func is not \
                torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if ns == "prim":
            return out
        self.log.append(str(packet))
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        outs = _tensors(out)
        if outs and not func.is_view:
            self.bytes_accessed += (
                sum(_nbytes(t) for t in _tensors((args, kwargs)))
                + sum(_nbytes(t) for t in outs))
        self._made(out)
        return out


# the sharding propagator's entry points that run ops: the cached one the
# dispatch calls first and the uncached one it calls while tracing
_PROPAGATORS = ("propagate_op_sharding", "propagate_op_sharding_non_cached")


@contextmanager
def _propagation_paused(counter: Counter):
    """Pause ``counter`` inside DTensor's sharding propagation (the
    dispatcher's propagator, patched on the instance and restored)."""
    prop = DTensor._op_dispatcher.sharding_propagator
    saved = {name: prop.__dict__[name] for name in _PROPAGATORS
             if name in prop.__dict__}

    def paused(call):
        def run(*args, **kwargs):
            counter._paused += 1
            try:
                return call(*args, **kwargs)
            finally:
                counter._paused -= 1
        return run

    for name in _PROPAGATORS:
        setattr(prop, name, paused(getattr(prop, name)))
    try:
        yield
    finally:
        for name in _PROPAGATORS:
            if name in saved:
                setattr(prop, name, saved[name])
            else:
                delattr(prop, name)


def run_counted(fn, args: Iterable[Any]):
    """``fn(*args)`` under a fresh ``Counter`` whose arguments are
    ``args`` -> (outputs, counter)."""
    args = tuple(args)
    counter = Counter()
    counter.track_arguments(args)
    with _propagation_paused(counter), counter:
        out = fn(*args)
    counter.track_outputs(out)
    return out, counter


def collective_bytes(counter: Counter) -> Dict[str, int]:
    """Per-collective-kind bytes of one rank (plus 'total'), as the
    reference's parse of a partitioned (per-device) program gives them."""
    return dict(counter.collectives)


def count_ops(log: List[str], opname: str) -> int:
    """How many ops of the log are ``opname``: a packet name in full
    (``aten.mm``) or its last part (``mm``)."""
    return sum(1 for e in log if e == opname or e.rsplit(".", 1)[-1] == opname)


def memory_stats(counter: Counter) -> Dict[str, float]:
    """Rank 0's memory, in the reference's keys where they have a
    counterpart: ``argument_size_in_bytes`` (the arguments' local
    shards), ``output_size_in_bytes`` (storages the run made that the
    outputs hold; outputs written in place into an argument are
    arguments), ``temp_size_in_bytes`` (the peak of what the run made,
    less the outputs); and ``peak_size_in_bytes``, arguments plus that
    peak: what a card must hold."""
    return {"argument_size_in_bytes": float(counter.argument_bytes),
            "output_size_in_bytes": float(counter.output_bytes),
            "temp_size_in_bytes": float(max(
                0, counter.peak_bytes - counter.output_bytes)),
            "peak_size_in_bytes": float(counter.argument_bytes
                                        + counter.peak_bytes)}


def cost_stats(counter: Counter, world: int) -> Dict[str, float]:
    """``flops`` and ``bytes_accessed`` summed over the ``world`` ranks
    (rank 0's count times the world size: every rank runs the same
    program on shards of the same size), and ``flops_per_rank``.

    The reference's ``flops`` are those of the global program XLA lowers
    before it partitions: work that every rank repeats on a replicated
    tensor (a norm of replicated activations, a replicated router) counts
    once there and once per rank here."""
    return {"flops": float(counter.flops * world),
            "bytes_accessed": float(counter.bytes_accessed * world),
            "flops_per_rank": float(counter.flops)}
