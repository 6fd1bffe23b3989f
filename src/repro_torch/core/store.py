"""Tiered per-worker context store + the node-level snapshot pool.

Port of ``repro.core.store``: framework-free, a copy with its imports
pointed at this package. Below, module names are the port's; the WIRE
edges run through ``core/wire.py`` and ``core/transport.py``.

Tiers mirror the paper's startup pipeline: SHARED_FS -> LOCAL_DISK ->
HOST_RAM -> DEVICE. The three application transformations map onto how deep
residency is allowed to persist across tasks:

  context-agnostic : nothing persists (store cleared after every task)
  partial-context  : LOCAL_DISK persists (artifact + env cached on disk;
                     HBM state still rebuilt per task)
  full-context     : DEVICE persists (the Library keeps the loaded model)

Residency state machine of one context on one worker::

                 fetch/build                 task start
    SHARED_FS ---------------> LOCAL_DISK ---------------> DEVICE
        ^                        |    ^                      |  ^
        |        drop(force)     |    |   promote (restore   |  | PEER
        +------------------------+    |   from snapshot,     |  | transfer
                                      |   zero compiles)     |  | (donor
                                      |                      v  | export ->
                                      +----- HOST_RAM <------+  | receiver
                                         demote (copy to host   | restore;
                                         snapshot of params +   | donor
                                         engine state); HOST_RAM| keeps its
                                         spills to LOCAL_DISK   | DEVICE
                                         via checkpoint/io when | copy)
                                         the pool is over       |
                                         capacity      [warm peer worker]

DEVICE->HOST_RAM demotion and HOST_RAM->LOCAL_DISK spill are PHYSICAL in
the live runtime: the bytes move (see :class:`SnapshotPool` and
``repro_torch.core.context.ContextSnapshot``), and promotion restores
the materialized context without re-running the builder or rebuilding a
kernel.

Every snapshot-moving edge above also exists as a cross-NODE **WIRE**
edge when the worker is a process on another machine (versioned
``repro.core.wire`` blobs — chunked-sha256 arrays, executables as
AOTRecipes — over the ``repro.core.transport`` socket frames)::

        node A (remote process)                 manager host
    DEVICE --demote--> node pool ==demoted_ctx==> manager POOL
       |                                            |    (HOST_RAM,
       |  stripe_chunk frames                       |     spills to
       |  (per-chunk sha256,              ==install=+     LOCAL_DISK)
       |  striped across donors)          |
       +===========================> node B DEVICE (adopt/restore,
                 PEER over the wire        zero builds, AOT cache hits)

The FetchSource vocabulary is unchanged — a wire install still lands as
PEER/POOL/DISK in the fetch history — so live-vs-sim decision parity
holds across process boundaries.

Every edge below DEVICE moves LIVE bytes, not allocated capacity: a paged
engine (``repro.serving.paged``) snapshots only the KV pages its requests
actually own, so snapshot ``nbytes`` — and with it SnapshotPool occupancy,
spill I/O, TransferPlanner predictions and peer-transfer seconds — scales
with live context. The allocated pool (``capacity_bytes``) is an
HBM-only cost that is rebuilt zero-filled at restore; contiguous slot
caches estimate the same split via ``repro.serving.kvcache.live_bytes``.

Pages can be SHARED: with prefix sharing on, a page may be referenced by
several slot reservations and by the engine's radix prefix cache at once
(``repro.serving.paged.PrefixCache`` — copy-on-write page-level prefix
sharing). The live set that demotes is the refcount>0 set, deduplicated:
a page three requests map is one page of snapshot bytes, so sharing
shrinks every rung below DEVICE exactly as it shrinks HBM. Demotion
carries the per-page refcounts alongside the live-page index (restore
validates them; the allocator and prefix cache ride on the engine object
as host metadata, like the AOT executables), and the HOST_RAM ->
LOCAL_DISK spill streams paged cache leaves through ``checkpoint/io`` in
PAGE-ALIGNED chunks — one manifest sha256 per chunk of whole pages, so
spill integrity and partial reads (``io.load_chunks``) address page
boundaries, never a byte range that splits a page.

Every movement edge is CHUNK-STREAMED, not monolithic: the HOST_RAM ->
LOCAL_DISK spill and the DISK -> DEVICE promotion move per-chunk-sha256
npz entries (``checkpoint/io`` — a streamed restore overlaps disk
read/verify of entry *i+1* with the device copy of entry *i* and never
materializes the whole host snapshot), and the PEER edge ships a
:class:`~repro.core.streaming.ChunkPlan` of verified chunks::

      donor A  --chunks (lane 0, budgeted between decode steps)--+
      donor B  --chunks (lane 1)---------------------------------+--> cold
      SnapshotPool --params chunks (pool lane, HOST_RAM/DISK)----+   worker

A receiver stripes disjoint chunk ranges across several warm donors at
once — and this pool doubles as a stripe source for the immutable weight
chunks (``peek``: non-consuming read) — while each donor exports a few
chunks per mailbox turn so its own serving never stalls. A corrupt or
lost lane degrades alone (refs reassigned to a surviving lane, or the
receiver falls down the ladder); the fetch never restarts.

The PEER edge is the join-storm bootstrap path (paper §4.1): a cold
worker reaches DEVICE directly from a warm peer's exported template
(``repro.core.context.export_context`` — non-destructive, the donor keeps
serving) instead of through the shared filesystem. Which inbound edge a
cold worker takes is decided by COST, not fixed priority: the scheduler
scores every feasible FetchSource rung (PEER / POOL / DISK / FS / BUILD,
see ``repro.core.transfer``) in predicted seconds — the TransferPlanner's
EWMA-calibrated bandwidths, per-donor fanout shares, shared-FS contention
and the worker's own PCIe link — and takes the cheapest, so a
slow-measured donor loses to a local NVMe promotion. The canonical
PEER > POOL > DISK > FS > BUILD order is what uncalibrated defaults
produce for a paper-size context and remains the deterministic tie-break;
per-donor fanout admission still gates concurrent peer flows.

:class:`ContextStore` is the bookkeeping half (which keys are resident at
which tier, capacity-bounded with LRU eviction per tier); eviction from a
tier demotes nothing (re-fetch from below), matching worker sandbox
semantics. Admission REFUSES (raises :class:`TierFullError`) when pinned
entries block the eviction needed to make room — a tier never silently
exceeds its capacity.
"""

from __future__ import annotations

import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import enum

from repro_torch.checkpoint import io as ckio
from repro_torch.core.context import (GB, ContextRecipe, ContextSnapshot,
                                      _offloadable)


class Tier(enum.IntEnum):
    SHARED_FS = 0      # always available (the cluster filesystem)
    LOCAL_DISK = 1
    HOST_RAM = 2
    DEVICE = 3


class ContextMode(enum.Enum):
    AGNOSTIC = "agnostic"
    PARTIAL = "partial"
    FULL = "full"

    @property
    def persist_tier(self) -> Tier:
        return {ContextMode.AGNOSTIC: Tier.SHARED_FS,
                ContextMode.PARTIAL: Tier.LOCAL_DISK,
                ContextMode.FULL: Tier.DEVICE}[self]


class TierFullError(ValueError):
    """Admission refused: the tier cannot make room because every eviction
    candidate is pinned (or the payload exceeds raw capacity)."""


@dataclass
class _Entry:
    key: str
    nbytes: int
    last_used: float = field(default_factory=time.monotonic)


class ContextStore:
    """Tracks which context keys are resident at which tier of one worker."""

    def __init__(self, disk_bytes: int = 70 * GB, host_bytes: int = 10 * GB,
                 device_bytes: int = 24 * GB):
        self.capacity = {Tier.LOCAL_DISK: disk_bytes,
                         Tier.HOST_RAM: host_bytes,
                         Tier.DEVICE: device_bytes}
        self._tiers: Dict[Tier, Dict[str, _Entry]] = {
            Tier.LOCAL_DISK: {}, Tier.HOST_RAM: {}, Tier.DEVICE: {}}
        self.evictions = 0
        self.pinned: Set[str] = set()

    # ------------------------------------------------------------- pinning --
    def pin(self, key: str):
        """Exempt ``key`` from LRU eviction and mode cleanup. Pinned entries
        never become eviction victims; once they fill a tier, further
        admissions are REFUSED with TierFullError rather than overcommitted."""
        self.pinned.add(key)

    def unpin(self, key: str):
        self.pinned.discard(key)

    def has(self, key: str, tier: Tier) -> bool:
        if tier == Tier.SHARED_FS:
            return True
        return key in self._tiers[tier]

    def highest_tier(self, key: str) -> Tier:
        for tier in (Tier.DEVICE, Tier.HOST_RAM, Tier.LOCAL_DISK):
            if key in self._tiers[tier]:
                return tier
        return Tier.SHARED_FS

    def used(self, tier: Tier) -> int:
        return sum(e.nbytes for e in self._tiers[tier].values())

    def pinned_bytes(self, tier: Tier) -> int:
        if tier == Tier.SHARED_FS:
            return 0
        return sum(e.nbytes for k, e in self._tiers[tier].items()
                   if k in self.pinned)

    def admit(self, key: str, tier: Tier, nbytes: int, now: float = None
              ) -> List[str]:
        """Place key at tier, LRU-evicting as needed. Returns evicted keys.

        Raises :class:`TierFullError` when the payload exceeds the tier's
        raw capacity, or when pinned entries block the evictions needed to
        make room — admission never silently overcommits a tier."""
        if tier == Tier.SHARED_FS:
            return []
        if nbytes > self.capacity[tier]:
            raise TierFullError(
                f"context {key} ({nbytes / GB:.1f} GB) exceeds tier "
                f"{tier.name} capacity ({self.capacity[tier] / GB:.1f} GB)")
        entries = self._tiers[tier]
        # re-admission replaces the existing entry: only the delta counts
        resident = entries[key].nbytes if key in entries else 0
        evicted = []
        while self.used(tier) - resident + nbytes > self.capacity[tier]:
            victim = min((e for k, e in entries.items()
                          if k != key and k not in self.pinned),
                         key=lambda e: e.last_used, default=None)
            if victim is None:
                raise TierFullError(
                    f"tier {tier.name} full admitting {key} "
                    f"({nbytes / GB:.1f} GB): {self.pinned_bytes(tier) / GB:.1f}"
                    f" GB pinned of {self.capacity[tier] / GB:.1f} GB "
                    "capacity and no evictable entries remain")
            del entries[victim.key]
            evicted.append(victim.key)
            self.evictions += 1
        now = time.monotonic() if now is None else now
        entries[key] = _Entry(key=key, nbytes=nbytes, last_used=now)
        return evicted

    def admit_recipe(self, recipe: ContextRecipe, upto: Tier,
                     now: float = None) -> List[str]:
        """Admit a recipe's footprint at every tier up to ``upto``.

        Atomic w.r.t. this key: if a higher tier refuses (TierFullError),
        residency this call just added at lower tiers is rolled back, so a
        failed admission never leaves phantom HOST_RAM/LOCAL_DISK entries
        for the scheduler's restore ladder to chase. (Evictions performed
        along the way are not undone — eviction is always lossy.)"""
        key = recipe.key()
        plan = [(Tier.LOCAL_DISK, recipe.transfer_bytes),
                (Tier.HOST_RAM, recipe.host_bytes),
                (Tier.DEVICE, recipe.device_bytes)]
        added = []
        evicted = []
        try:
            for tier, nbytes in plan:
                if upto >= tier:
                    was_resident = key in self._tiers[tier]
                    evicted += self.admit(key, tier, nbytes, now)
                    if not was_resident:
                        added.append(tier)
        except TierFullError:
            for tier in added:
                self._tiers[tier].pop(key, None)
            raise
        return evicted

    def touch(self, key: str, now: float = None):
        now = time.monotonic() if now is None else now
        for entries in self._tiers.values():
            if key in entries:
                entries[key].last_used = now

    def invalidate(self, key: str, tier: Tier):
        """Remove one key from ONE tier (no pin check): bookkeeping
        correction when the physical copy backing that tier is gone (e.g.
        the node pool's snapshot was consumed by another worker)."""
        if tier != Tier.SHARED_FS:
            self._tiers[tier].pop(key, None)

    def drop(self, key: str, down_to: Tier = Tier.SHARED_FS,
             force: bool = False):
        """Remove residency above ``down_to`` (mode cleanup after a task).
        Pinned keys survive unless ``force`` (worker actually gone)."""
        if key in self.pinned and not force:
            return
        for tier, entries in self._tiers.items():
            if tier > down_to:
                entries.pop(key, None)

    def clear(self, force: bool = False):
        for entries in self._tiers.values():
            if force or not self.pinned:
                entries.clear()
            else:
                for k in [k for k in entries if k not in self.pinned]:
                    del entries[k]

    def keys(self, tier: Tier) -> Set[str]:
        if tier == Tier.SHARED_FS:
            return set()
        return set(self._tiers[tier])

    def stats(self) -> Dict:
        """Per-tier occupancy incl. pinned bytes (admission headroom that
        eviction can never reclaim)."""
        return {
            "evictions": self.evictions,
            "tiers": {
                tier.name: {
                    "used_bytes": self.used(tier),
                    "capacity_bytes": self.capacity[tier],
                    "pinned_bytes": self.pinned_bytes(tier),
                    "entries": len(self._tiers[tier]),
                } for tier in (Tier.LOCAL_DISK, Tier.HOST_RAM, Tier.DEVICE)
            },
        }


class SnapshotPool:
    """Node-level pool of demoted :class:`ContextSnapshot` payloads.

    The physical half of tier movement: DEVICE->HOST_RAM demotion `put`s a
    snapshot here (params + engine device state copied to host arenas,
    page-locked on the card; the built kernels and host structures
    retained as metadata); when host occupancy exceeds ``host_bytes``, the
    LRU snapshot SPILLS its arrays to LOCAL_DISK through ``checkpoint/io``
    (atomic npz + manifest).
    Promotion (`take`) returns the snapshot for restore and removes it from
    the pool — the materialized value is a single mutable object (engine +
    executables), so a restore MOVES it to the requesting worker rather
    than aliasing it across workers.

    The pool is owned by the node (PCMManager), not by one worker: it
    models host RAM + local disk surviving a no-warning GPU reclaim, which
    is exactly why a preempted-then-rejoining worker pays restore cost
    instead of full startup cost (the paper's core claim).

    Host occupancy counts what really stays in host RAM: each tensor
    storage once, by its size. An engine's snapshot holds two
    ``repro_torch.hostmem`` arenas (its parameters' and the rest's), whose
    views share their arena's storage, so each arena counts once,
    alignment included: the bytes the process holds. A serving engine
    demoted as the last one over its model releases the model's parameters
    in place, and the model keeps the snapshot's host copies of them
    (``InferenceEngine.offload_device_state``: ``model._released_params``).
    That arena outlives a spill of the snapshot and a ``take`` of it, so
    the pool watches the models behind the snapshots it was given and
    counts their released parameters too: while the snapshot is at
    HOST_RAM they are its own ``params``. A spill frees the other arena;
    a restore into the model, an engine built over it, or dropping it
    frees the parameters'.

    Thread-safe: worker actor threads demote/restore concurrently.
    """

    def __init__(self, host_bytes: int = 48 * GB,
                 disk_bytes: int = 200 * GB,
                 spill_dir: Optional[str] = None,
                 on_gone=None,
                 chunk_bytes: int = 64 << 20):
        self.host_bytes = host_bytes
        self.disk_bytes = disk_bytes
        # chunk granularity of HOST_RAM -> LOCAL_DISK spills (per-chunk
        # sha256 manifests; streamed restores verify entry-by-entry)
        self.chunk_bytes = int(chunk_bytes)
        self._spill_dir = spill_dir
        self._spill_store = None            # lazy: repro.checkpoint.SpillStore
        # on_gone(key): fired (outside the pool lock) when a snapshot
        # leaves the pool without being re-insertable — consumed by a
        # restore or dropped for capacity — so owners of residency
        # bookkeeping can invalidate phantom HOST_RAM claims
        self._on_gone = on_gone
        self._snaps: Dict[str, ContextSnapshot] = {}
        # the models behind the snapshots ``put`` here, weakly: a released
        # one pins its parameters in host RAM wherever its snapshot went
        self._models: "weakref.WeakSet" = weakref.WeakSet()
        self._lost_keys: List[str] = []     # dropped under lock, fired after
        self._lock = threading.RLock()
        self.demotions = 0
        self.spills = 0
        self.restores = 0
        self.restore_seconds = 0.0
        self.lost = 0                       # dropped for capacity, never used
        self.stripe_reads = 0               # chunks served as a stripe lane

    # ------------------------------------------------------------ internal --
    def spill_store(self):
        """The lazily created LOCAL_DISK backend (checkpoint SpillStore)."""
        if self._spill_store is None:
            from repro_torch.checkpoint.manager import SpillStore
            self._spill_store = SpillStore(self._spill_dir)
        return self._spill_store

    def set_on_gone(self, cb):
        """Install the gone-notification callback (see ``__init__``) when
        the pool was constructed before its owner existed."""
        self._on_gone = cb

    def _held_tensors(self) -> Tuple[List[ContextSnapshot], List]:
        """The snapshots at HOST_RAM, and the parameters released models
        keep in host RAM."""
        held = [s for s in self._snaps.values() if s.tier == Tier.HOST_RAM]
        released = [t for m in list(self._models)
                    for t in (m.__dict__.get("_released_params")
                              or {}).values()]
        return held, released

    def _host_held(self) -> Tuple[int, int]:
        """(bytes of the snapshots at HOST_RAM, bytes of released
        parameters beyond them): a storage a snapshot holds is counted
        with it (``ContextSnapshot.nbytes``), and every other once by its
        size."""
        held, released = self._held_tensors()
        snap_bytes = sum(s.nbytes for s in held)
        if not released:
            return snap_bytes, 0
        seen = {t.untyped_storage().data_ptr() for s in held
                for t in ckio.tree_leaves(s.host_state)
                if hasattr(t, "untyped_storage")}
        extra = 0
        for t in released:
            storage = t.untyped_storage()
            if storage.data_ptr() not in seen:
                seen.add(storage.data_ptr())
                extra += storage.nbytes()
        return snap_bytes, extra

    def _pinned_host(self) -> int:
        """Bytes of the counted storages that are page-locked for the card
        (each once)."""
        held, released = self._held_tensors()
        pinned = {}
        for t in released + [t for s in held
                             for t in ckio.tree_leaves(s.host_state)]:
            if hasattr(t, "untyped_storage"):
                storage = t.untyped_storage()
                if storage.data_ptr() not in pinned:
                    pinned[storage.data_ptr()] = (storage.nbytes()
                                                  if t.is_pinned() else 0)
        return sum(pinned.values())

    def _host_used(self) -> int:
        return sum(self._host_held())

    def _disk_used(self) -> int:
        return sum(s.nbytes for s in self._snaps.values()
                   if s.tier == Tier.LOCAL_DISK)

    def _select_spill_victims(self) -> List[ContextSnapshot]:
        """LRU-pick HOST_RAM snapshots until host occupancy fits; caller
        holds the lock. Victims are REMOVED from the pool so the GB-scale
        npz write can happen outside the lock (a concurrent ``take`` of a
        mid-spill key simply misses and cold-builds); snapshots the disk
        tier cannot hold are dropped outright (rebuild is always
        possible). Released parameters stay counted once their
        snapshot spills (their model still pins them), so a victim frees
        only what it holds beyond them, and the walk goes on to the next."""
        victims: List[ContextSnapshot] = []
        disk_planned = self._disk_used()
        while self._host_used() > self.host_bytes:
            cands = sorted((s for s in self._snaps.values()
                            if s.tier == Tier.HOST_RAM),
                           key=lambda s: s.last_used)
            if not cands:
                break
            victim = cands[0]
            del self._snaps[victim.key]
            if disk_planned + victim.nbytes <= self.disk_bytes:
                victims.append(victim)
                disk_planned += victim.nbytes
            else:
                self.lost += 1
                self._lost_keys.append(victim.key)
        return victims

    def _finish_spills(self, victims: List[ContextSnapshot]):
        """Re-insert spilled snapshots (disk writes done outside the
        lock); a snapshot superseded by a newer demotion of the same key
        while we were writing gets its disk copy discarded instead."""
        stale: List[ContextSnapshot] = []
        with self._lock:
            for v in victims:
                if v.key in self._snaps:
                    stale.append(v)
                else:
                    self._snaps[v.key] = v
                    self.spills += 1
        for v in stale:
            v.discard(self.spill_store())

    def _fire_gone(self):
        """Notify the owner about snapshots that left the pool for good
        (capacity drops); called WITHOUT the pool lock held."""
        if self._on_gone is None:
            with self._lock:
                self._lost_keys.clear()
            return
        with self._lock:
            keys, self._lost_keys = self._lost_keys, []
        for key in keys:
            self._on_gone(key)

    # -------------------------------------------------------------- public --
    def put(self, snap: ContextSnapshot):
        """Admit a freshly demoted snapshot at HOST_RAM (spilling LRU
        residents to disk as needed). Replaces any older snapshot of the
        same context. Disk I/O runs outside the pool lock so concurrent
        demotes/restores never serialize behind a multi-GB npz write."""
        with self._lock:
            old = self._snaps.pop(snap.key, None)
            self._snaps[snap.key] = snap
            for comp in _offloadable(snap.value):
                model = getattr(comp, "model", None)
                if model is not None and hasattr(model, "__dict__"):
                    self._models.add(model)
            self.demotions += 1
            victims = self._select_spill_victims()
        if old is not None and old.tier == Tier.LOCAL_DISK:
            old.discard(self.spill_store())
        for v in victims:
            v.spill(self.spill_store(), chunk_bytes=self.chunk_bytes)
        if victims:
            self._finish_spills(victims)
        self._fire_gone()

    def take(self, key: str) -> Optional[ContextSnapshot]:
        """Remove and return the snapshot for ``key`` (promotion consumes
        it — the value object moves to the restoring worker). Fires
        ``on_gone`` so residency bookkeeping recorded for this snapshot
        elsewhere (other workers' HOST_RAM claims) is invalidated."""
        with self._lock:
            snap = self._snaps.pop(key, None)
            if snap is not None:
                self.restores += 1
        if snap is not None and self._on_gone is not None:
            self._on_gone(key)
        return snap

    def peek(self, key: str) -> Optional[ContextSnapshot]:
        """Non-consuming read of the pooled snapshot — the handle a
        striped PEER fetch uses to serve immutable ``params`` chunks as an
        extra stripe lane (HOST_RAM arrays are never mutated in place, and
        a spilled snapshot's entries are read via the spill store, so a
        concurrent ``take`` at worst fails this lane — which then degrades
        to a donor lane instead of corrupting anything)."""
        with self._lock:
            return self._snaps.get(key)

    def spill(self, key: str) -> bool:
        """Explicitly demote one snapshot HOST_RAM -> LOCAL_DISK (the
        write happens outside the lock; the key is briefly absent from
        the pool while in flight)."""
        with self._lock:
            snap = self._snaps.pop(key, None)
            if snap is None or snap.tier != Tier.HOST_RAM:
                if snap is not None:      # disk-resident already: keep it
                    self._snaps[key] = snap
                return False
        snap.spill(self.spill_store(), chunk_bytes=self.chunk_bytes)
        self._finish_spills([snap])
        return True

    def tier(self, key: str) -> Optional[Tier]:
        with self._lock:
            snap = self._snaps.get(key)
            return None if snap is None else snap.tier

    def keys(self) -> Set[str]:
        with self._lock:
            return set(self._snaps)

    def discard(self, key: str):
        with self._lock:
            snap = self._snaps.pop(key, None)
        if snap is not None and snap.tier == Tier.LOCAL_DISK:
            snap.discard(self.spill_store())

    def stats(self) -> Dict:
        with self._lock:
            snap_bytes, released = self._host_held()
            return {
                "snapshots": len(self._snaps),
                "host_used_bytes": snap_bytes + released,
                "released_param_bytes": released,
                "pinned_host_bytes": self._pinned_host(),
                "disk_used_bytes": self._disk_used(),
                "demotions": self.demotions,
                "spills": self.spills,
                "restores": self.restores,
                "restore_seconds": self.restore_seconds,
                "lost": self.lost,
                "stripe_reads": self.stripe_reads,
            }
