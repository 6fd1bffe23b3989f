"""Chunk-granular context movement: plans, stripe lanes, and the
receiver-side reassembly buffer.

Every snapshot transfer used to move as one monolithic blob — a donor's
``export_context`` blocked its serving thread for the whole ``device_get``
and the receiver restored only once everything had landed. This module is
the machinery that breaks a template export into verifiable chunks so

* a donor ships a few chunks per mailbox turn and keeps serving between
  them (non-blocking export, ``repro_torch.core.manager._handle_donate_chunks``),
* a receiver pulls disjoint chunk ranges concurrently from several
  sources — multiple warm donors, plus the node SnapshotPool for the
  immutable weight leaves (multi-source striping), and
* a single corrupt or lost lane degrades (reassign its refs to a healthy
  lane, or fall down the fetch ladder) without restarting the fetch.

The plan is DETERMINISTIC in the template's shapes alone: two donors
holding the same recipe's template compute byte-identical
:class:`ChunkPlan`s with zero coordination, so lane assignment is just
"donor *i* exports the refs assigned to lane *i*".

Integrity: every chunk travels with the sha256 of its bytes
(``chunk_digest``); the receiver re-hashes on delivery and a mismatch
surfaces as :class:`~repro_torch.checkpoint.io.ChunkCorruptionError` on
that lane only.

Port of ``repro.core.streaming``: trees flatten through
``checkpoint.io.tree_flatten`` (the reference's path names), a donor's
leaves are device tensors sliced per chunk, each chunk is copied to the
host on its own, and completed leaves are assembled with ``torch.cat``.
Chunks that cross a process boundary travel as transport frames
(``core/wire.py``'s chunk helpers), verified again on arrival.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint import io as ckio
from repro_torch.checkpoint.io import ChunkCorruptionError, _sha256_array

__all__ = ["ChunkRef", "ChunkPlan", "StripeBuffer", "ChunkCorruptionError",
           "assign_lanes", "chunk_digest", "pool_eligible"]


def _flatten_paths(tree) -> Tuple[List[Tuple[str, Any]], Any]:
    """Ordered ``[(flat_key, leaf), ...]`` plus the tree structure — the
    "/"-joined key scheme of ``checkpoint.io`` WITHOUT copying leaves to
    the host (donor-side leaves are device tensors; copying one whole is
    the exact stall chunking removes)."""
    return ckio.tree_flatten(tree)


def chunk_digest(arr) -> str:
    return _sha256_array(arr)


def host_chunk(piece: torch.Tensor) -> torch.Tensor:
    """One chunk on the host: a device tensor's slice copied (this is the
    only point a donor's export touches the device)."""
    return piece.detach().cpu().contiguous()


def pool_eligible(key: str) -> bool:
    """Whether a chunk of this flat key may be served by a SnapshotPool
    stripe lane. Only the model weights qualify: ``params`` never mutate
    after build, so a pooled (demoted) snapshot's copy is bit-identical
    to every donor's. Everything else in a template (RNG, decode state)
    is synthesized or point-in-time and must come from a live donor."""
    return "params" in key.split("/")


@dataclass(frozen=True)
class ChunkRef:
    """One chunk of one leaf: rows ``[start, stop)`` along ``axis``.
    ``axis < 0`` marks a whole-leaf chunk (small or scalar leaves ship
    unsplit)."""

    key: str
    index: int                  # chunk index within the leaf
    count: int                  # total chunks of this leaf
    axis: int
    start: int
    stop: int

    @property
    def id(self) -> Tuple[str, int]:
        return (self.key, self.index)


class ChunkPlan:
    """Deterministic chunking of a whole pytree (a template's device half,
    a snapshot's host_state, ...): leaves bigger than ``chunk_bytes``
    split along their chunk axis (``axes`` maps flat-key prefixes to an
    axis — e.g. a paged KV page axis; default the leading axis) into
    ``<= chunk_bytes`` pieces, small leaves ride whole. ``refs`` is the
    global transfer order (leaf order, then chunk index); the treedef is
    carried so :meth:`assemble` rebuilds the exact structure — including
    list/tuple pytrees whose "/" keys alone would be ambiguous."""

    def __init__(self, tree, chunk_bytes: int = 64 << 20,
                 axes: Optional[Dict[str, int]] = None):
        self.chunk_bytes = int(chunk_bytes)
        flat, self.treedef = _flatten_paths(tree)
        self.leaf_keys: List[str] = [k for k, _ in flat]
        self.refs: List[ChunkRef] = []
        self.total_bytes = 0
        for key, leaf in flat:
            # shape x itemsize: the plan is a pure function of shapes
            nbytes = ckio.leaf_nbytes(leaf)
            self.total_bytes += nbytes
            shape = getattr(leaf, "shape", ())
            axis = 0
            for prefix, ax in (axes or {}).items():
                if key == prefix or key.startswith(prefix + "/"):
                    axis = int(ax)
                    break
            dim = shape[axis] if shape else 0
            if nbytes <= self.chunk_bytes or dim <= 1:
                self.refs.append(ChunkRef(key=key, index=0, count=1,
                                          axis=-1, start=0, stop=0))
                continue
            row_bytes = max(1, nbytes // dim)
            rows = max(1, min(dim, self.chunk_bytes // row_bytes))
            n = -(-dim // rows)
            for i in range(n):
                self.refs.append(ChunkRef(
                    key=key, index=i, count=n, axis=axis,
                    start=i * rows, stop=min(dim, (i + 1) * rows)))

    def extract(self, flat: Dict[str, Any], ref: ChunkRef):
        """Slice ``ref``'s chunk out of a flat key->tensor map (device or
        host — slicing a device tensor stays on the device; the caller
        decides when the host copy happens)."""
        arr = flat[ref.key]
        if ref.axis < 0:
            return arr
        sel = (slice(None),) * ref.axis
        return arr[sel + (slice(ref.start, ref.stop),)]

    @staticmethod
    def flat_map(tree) -> Dict[str, Any]:
        return dict(_flatten_paths(tree)[0])


def assign_lanes(refs: List[ChunkRef], n_donor_lanes: int,
                 n_pool_lanes: int = 0) -> List[List[ChunkRef]]:
    """Split a plan's refs across stripe lanes: donor lanes first
    (``0 .. n_donor_lanes-1``), then pool lanes. Pool-eligible refs
    (immutable ``params``) round-robin over ALL lanes; everything else
    only over donor lanes. Pure function of the plan — every participant
    computes the same assignment independently."""
    total = n_donor_lanes + n_pool_lanes
    if n_donor_lanes < 1:
        raise ValueError("striping requires at least one donor lane")
    lanes: List[List[ChunkRef]] = [[] for _ in range(total)]
    rr_all = rr_donor = 0
    for ref in refs:
        if pool_eligible(ref.key):
            lanes[rr_all % total].append(ref)
            rr_all += 1
        else:
            lanes[rr_donor % n_donor_lanes].append(ref)
            rr_donor += 1
    return lanes


class StripeBuffer:
    """Receiver-side accumulation of one striped template transfer.

    Donor lanes (and the optional pool lane) deliver verified chunks
    concurrently from their own threads; the buffer verifies each
    delivery against its claimed digest, assembles a leaf eagerly the
    moment its last chunk lands (freeing the chunk pieces — the
    double-buffering half of the overlapped restore), and reports
    completion once the primary lane's template metadata AND every
    expected ref have arrived. ``assemble()`` then rebuilds the device
    half via the plan's treedef and merges it into the host halves.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: Dict[str, Dict[int, Any]] = {}
        self._leaves: Dict[str, Any] = {}
        self._expected: Optional[Dict[Tuple[str, int], ChunkRef]] = None
        self._delivered: set = set()
        self.plan: Optional[ChunkPlan] = None
        self.clone = None
        self.host_halves: Optional[Dict[str, Any]] = None
        self.nbytes = 0
        self.build_seconds = 0.0
        self.aot_seconds = 0.0
        self.lane_seconds: Dict[int, float] = {}
        self.chunks_delivered = 0
        self.install_posted = False     # guarded by the manager's lock

    # ------------------------------------------------------------ filling --
    def set_template(self, plan: ChunkPlan, clone, host_halves: Dict,
                     nbytes: int, build_seconds: float, aot_seconds: float):
        """Primary-lane metadata: the deterministic plan (for the expected
        ref set + treedef), the structural clone sharing the donor's AOT
        executables, and the synthesized host halves of each component's
        template."""
        with self._lock:
            self.plan = plan
            self.clone = clone
            self.host_halves = host_halves
            self.nbytes = nbytes
            self.build_seconds = build_seconds
            self.aot_seconds = aot_seconds
            self._expected = {r.id: r for r in plan.refs}

    def deliver(self, ref: ChunkRef, arr: torch.Tensor, sha: str,
                lane: int = 0):
        """Accept one chunk (a host tensor) from a lane, re-hashing to
        verify. Raises ChunkCorruptionError on digest mismatch (the caller
        fails that LANE, not the whole stripe)."""
        if _sha256_array(arr) != sha:
            raise ChunkCorruptionError(
                f"stripe chunk {ref.index} of {ref.key!r} from lane {lane} "
                "failed verification")
        with self._lock:
            if ref.id in self._delivered:
                return
            self._delivered.add(ref.id)
            self.chunks_delivered += 1
            if ref.count == 1 and ref.axis < 0:
                self._leaves[ref.key] = arr
                return
            parts = self._pending.setdefault(ref.key, {})
            parts[ref.index] = arr
            if len(parts) == ref.count:     # leaf complete: assemble eagerly
                self._leaves[ref.key] = torch.cat(
                    [parts[i] for i in range(ref.count)], dim=ref.axis)
                del self._pending[ref.key]

    def add_lane_seconds(self, lane: int, seconds: float):
        with self._lock:
            self.lane_seconds[lane] = \
                self.lane_seconds.get(lane, 0.0) + seconds

    # ----------------------------------------------------------- querying --
    def complete(self) -> bool:
        with self._lock:
            return (self._expected is not None
                    and len(self._delivered) >= len(self._expected))

    def missing_refs(self, assigned: List[ChunkRef]) -> List[ChunkRef]:
        """The subset of a lost lane's refs not yet delivered — what a
        surviving lane must re-export."""
        with self._lock:
            return [r for r in assigned if r.id not in self._delivered]

    @property
    def export_seconds(self) -> float:
        """Donor-side cost of the transfer: the slowest lane's cumulative
        export time (lanes ran concurrently) — the striped analogue of the
        monolithic snapshot's ``demote_seconds``."""
        with self._lock:
            return max(self.lane_seconds.values(), default=0.0)

    # ----------------------------------------------------------- assembly --
    def assemble(self) -> Dict[str, Any]:
        """Rebuild the per-component host_state: unflatten the device half
        from the assembled leaves via the plan's treedef, then merge into
        the host halves. Called on the receiver's thread once complete."""
        with self._lock:
            if self._expected is None or \
                    len(self._delivered) < len(self._expected):
                raise RuntimeError("stripe transfer incomplete")
            leaves = [self._leaves[k] for k in self.plan.leaf_keys]
            device_half = ckio.tree_unflatten(self.plan.treedef, leaves)
            host_state: Dict[str, Any] = {}
            for name, half in (self.host_halves or {}).items():
                merged = dict(half)
                merged.update(device_half.get(name, {}))
                host_state[name] = merged
            self._leaves = {}
            return host_state
