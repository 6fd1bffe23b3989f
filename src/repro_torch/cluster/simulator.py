"""Discrete-event cluster simulator: runs the REAL ContextAwareScheduler
against modeled time.

Only three things are simulated — the clock, task durations (device cost
models), and transfer times (bandwidth models). All scheduling decisions,
store/residency bookkeeping, requeue-on-preemption and straggler logic are
the production classes from ``repro_torch.core``. This is how the paper's
cluster-scale figures (RQ1–RQ4) are reproduced on a laptop, deterministic
to the last event.

Like the SimulatorBackend, the paper-figure simulator models the node
snapshot pool across preemptions in full-context mode: a preempted
worker's device-resident contexts survive as modeled HOST_RAM snapshots
(the live runtime's retirement demotion), so a later joiner's cost ladder
can take the POOL/DISK rung — restore cost, not a cold rebuild — exactly
as the live PCMManager does. Pool snapshots are single-owner: a promotion
(fetch or on-path start) consumes the entry.

Streamed context movement needs NO special-casing here: the shared
scheduler/planner already price a PEER rung as a chunk-pipelined, striped
transfer (``TransferPlanner.peer_plan(width=...)`` commits one flow per
stripe lane and ``plan.seconds`` is the slowest lane's fill+bottleneck
time), so ``modeled_fetch_seconds`` consuming ``plan.seconds`` keeps the
modeled duration — and every FetchSource decision — in lockstep with the
live streamed runtime.

Port of ``repro.cluster.simulator``: framework-free, a copy over this
package's scheduler, store, transfer planner and factory, which are
themselves copies of the reference's, so the same sweep gives the same
``SimResult`` float for float in both packages.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.cluster.devices import (CostModel, DeviceProfile, GB, PROFILES,
                                   fs_fetch_bytes, inference_seconds,
                                   load_seconds)
from repro_torch.cluster.events import Event, EventLoop
from repro_torch.core.context import ContextRecipe
from repro_torch.core.factory import WorkerFactory
from repro_torch.core.scheduler import Action, ContextAwareScheduler, Task
from repro_torch.core.store import ContextMode, ContextStore, Tier
from repro_torch.core.transfer import FetchSource, TransferPlanner


class ModeledNodePool:
    """Modeled node snapshot pool shared by BOTH dry-run surfaces
    (SimulatorBackend and ClusterSimulator): a preempted worker's
    device-resident contexts survive here as HOST_RAM snapshots (the live
    SnapshotPool's retirement demotion), feeding the scheduler's
    POOL/DISK rungs via :meth:`get`. Snapshots are single-owner — a
    promotion consumes the entry, whether it happens through a bootstrap
    fetch or on the start path of a host/disk-resident placement. One
    pool for the whole modeled cluster: the single-node simplification
    both surfaces share, so their FetchSource decision sequences stay
    comparable (and cannot drift by one surface editing its own copy of
    this logic)."""

    def __init__(self):
        self._tiers: Dict[str, Tier] = {}

    def get(self, key: str) -> Optional[Tier]:
        """Residency oracle installed as ``scheduler.pool_tier``."""
        return self._tiers.get(key)

    def __contains__(self, key: str) -> bool:
        return key in self._tiers

    def put(self, key: str, tier: Tier = Tier.HOST_RAM):
        self._tiers[key] = tier

    def demote_worker(self, store: ContextStore):
        """Model a preempted worker's retirement demotion: its
        device-resident contexts survive in node host RAM."""
        for key in store.keys(Tier.DEVICE):
            self._tiers[key] = Tier.HOST_RAM

    def consume_fetch(self, source, key: str):
        """A completed POOL/DISK fetch promoted (and so consumed) the
        single-owner snapshot."""
        if source in (FetchSource.POOL, FetchSource.DISK):
            self._tiers.pop(key, None)

    def consume_start(self, a: Action):
        """A start on a host/disk-resident worker is a snapshot promotion
        (as the live ``Library.ensure`` takes the SnapshotPool copy): it
        consumes the pooled entry, so a later joiner's ladder does not
        chase a snapshot the runtime no longer has."""
        for recipe, on_host, on_disk, on_device in zip(
                a.recipes, a.host_resident or (), a.disk_resident or (),
                a.device_resident or ()):
            if (on_host or on_disk) and not on_device:
                self._tiers.pop(recipe.key(), None)


def modeled_start_seconds(a: Action, task: Task, profile: DeviceProfile,
                          scheduler: ContextAwareScheduler,
                          planner: TransferPlanner, cost: CostModel,
                          mode: ContextMode, page_cached: set, stats: dict,
                          now: float) -> float:
    """Modeled duration (startup + execution) of one start action.

    The single cost model behind BOTH dry-run surfaces (ClusterSimulator
    sweeps and the SimulatorBackend behind PCMClient). Updates ``stats``
    counters (warm/disk/cold/p2p/fs) and the ``page_cached`` working-set
    tracker in place.

    Startup is charged only for contexts not already device-resident
    (``a.device_resident``): a recipe on the worker's local disk
    (``a.disk_resident``) pays only the disk->HBM load, colder ones pay a
    planned transfer too, and the framework warm-up is paid ONCE per start
    rather than once per context. Execution charges one task dispatch
    overhead plus the per-item inference cost of EVERY attached context (a
    multi-context pipeline runs each engine per item); contextless tasks
    pay overheads only.
    """
    startup = 0.0
    if a.warm:     # includes contextless tasks (always-warm)
        stats["warm"] += 1
    else:
        if a.had_disk:
            stats["disk"] += 1
        else:
            stats["cold"] += 1
        disk_resident = a.disk_resident or (False,) * len(a.recipes)
        host_resident = a.host_resident or (False,) * len(a.recipes)
        device_resident = a.device_resident or (False,) * len(a.recipes)
        loaded_any = False
        for recipe, on_disk, on_host, on_device in zip(
                a.recipes, disk_resident, host_resident, device_resident):
            if on_device:
                continue     # already in HBM: nothing to fetch or load
            key = recipe.key()
            if on_host:
                # demoted snapshot in host RAM: promotion is a single
                # host->HBM transfer — no network fetch, no disk read, no
                # framework warm-up (the process never died)
                startup += planner.restore_seconds(
                    recipe.host_bytes,
                    h2d_bytes_per_s=profile.pcie_gbps * GB)
                loaded_any = True
                continue
            if not on_disk:
                donors = {
                    wid for wid, info in scheduler.workers.items()
                    if wid != a.worker_id
                    and info.store.has(key, Tier.LOCAL_DISK)}
                plan = planner.plan(
                    recipe.transfer_bytes, donors, now,
                    allow_p2p=mode != ContextMode.AGNOSTIC,
                    fs_nbytes=fs_fetch_bytes(recipe, cost))
                stats["p2p" if plan.p2p else "fs"] += 1
                startup += plan.seconds
            startup += load_seconds(
                profile, recipe, cost, from_disk=True,
                page_cached=(a.worker_id, key) in page_cached,
                include_warmup=not loaded_any)
            loaded_any = True
            page_cached.add((a.worker_id, key))
    exec_s = cost.task_overhead_s + task.n_items * (
        sum(inference_seconds(profile, r, cost) for r in task.recipes)
        or cost.inference_overhead_s)
    if exec_s > cost.page_cache_evict_s:
        # the inference working set evicts the cached model/env pages
        for recipe in a.recipes:
            page_cached.discard((a.worker_id, recipe.key()))
    return startup + exec_s


def modeled_fetch_seconds(a: Action, profile: DeviceProfile,
                          cost: CostModel, stats: dict) -> float:
    """Modeled duration of one bootstrap-fetch action, shared by
    ClusterSimulator and SimulatorBackend and keyed by the action's
    FetchSource: POOL/DISK are snapshot promotions (the plan's restore
    seconds — no network, no framework warm-up: the node process never
    died), PEER uses the scheduler's committed prediction
    (``a.eta_seconds``, the chunk-pipelined d2h/wire/restore composition
    that scored the rung — no warm-up, no disk pass: the template ships
    host-to-host and restores straight to HBM), FS is the transfer
    followed by the full disk->HBM cold load, and BUILD (no plan) pays
    the load path alone. Updates transfer stats."""
    if a.plan is not None and a.plan.fetch_source in (FetchSource.POOL,
                                                      FetchSource.DISK):
        stats["pool"] = stats.get("pool", 0) + 1
        return a.plan.seconds
    if a.plan is None:                      # BUILD: nothing to transfer
        return load_seconds(profile, a.recipe, cost, from_disk=False)
    stats["p2p" if a.plan.p2p else "fs"] += 1
    if a.plan.p2p and a.eta_seconds > 0:
        return a.eta_seconds
    return a.plan.seconds + load_seconds(profile, a.recipe, cost,
                                         from_disk=True)


@dataclass
class SimResult:
    mode: str
    end_time: float
    completions: List[Tuple[float, int]]          # (t, n_items)
    worker_samples: List[Tuple[float, int]]       # (t, pool size)
    cold_starts: int
    warm_starts: int
    disk_hits: int
    preemptions: int
    p2p_transfers: int
    fs_transfers: int
    pool_restores: int = 0        # POOL/DISK-rung snapshot promotions

    @property
    def total_inferences(self) -> int:
        return sum(n for _, n in self.completions)

    def cumulative(self, t: float) -> int:
        return sum(n for tc, n in self.completions if tc <= t)

    def curve(self, dt: float = 60.0) -> List[Tuple[float, int]]:
        if not self.completions:
            return []
        out, acc, ti = [], 0, 0.0
        comp = sorted(self.completions)
        i = 0
        while ti <= self.end_time + dt:
            while i < len(comp) and comp[i][0] <= ti:
                acc += comp[i][1]
                i += 1
            out.append((ti, acc))
            ti += dt
        return out


class ClusterSimulator:
    def __init__(self, mode: ContextMode, capacity_fn: Callable,
                 recipe: ContextRecipe,
                 cost: Optional[CostModel] = None,
                 planner: Optional[TransferPlanner] = None,
                 straggler_factor: float = 0.0,
                 reconcile_every: float = 15.0):
        self.mode = mode
        self.recipe = recipe
        self.cost = cost or CostModel()
        self.loop = EventLoop()
        self.planner = planner or TransferPlanner()
        self.scheduler = ContextAwareScheduler(
            mode=mode, planner=self.planner,
            straggler_factor=straggler_factor)
        self._node_pool = ModeledNodePool()
        self.scheduler.pool_tier = self._node_pool.get
        self.factory = WorkerFactory(capacity_fn)
        self.reconcile_every = reconcile_every

        self.profiles: Dict[str, DeviceProfile] = {}
        self._page_cached: set = set()            # (worker_id, ctx_key)
        self._task_events: Dict[str, Event] = {}
        self._fetch_events: Dict[str, Event] = {}
        self._completions: List[Tuple[float, int]] = []
        self._worker_samples: List[Tuple[float, int]] = []
        self._stats = dict(cold=0, warm=0, disk=0, preempt=0, p2p=0, fs=0,
                           pool=0)
        self._reconcile_ev: Optional[Event] = None

    # ------------------------------------------------------------ submit ---
    def submit_sweep(self, total_inferences: int, batch_size: int):
        """The paper's workload: a fixed inference sweep split into tasks
        of ``batch_size`` inferences each."""
        n_tasks = (total_inferences + batch_size - 1) // batch_size
        for i in range(n_tasks):
            items = min(batch_size, total_inferences - i * batch_size)
            task = Task(task_id=f"task{i:06d}", recipe=self.recipe,
                        n_items=items)
            self._apply(self.scheduler.submit(task, self.loop.now))

    # --------------------------------------------------------------- run ---
    def run(self, until: float = 10_000_000.0) -> SimResult:
        self._reconcile()
        self.loop.run(until=until)
        return SimResult(
            mode=self.mode.value, end_time=self._end_time(),
            completions=sorted(self._completions),
            worker_samples=self._worker_samples,
            cold_starts=self._stats["cold"], warm_starts=self._stats["warm"],
            disk_hits=self._stats["disk"],
            preemptions=self._stats["preempt"],
            p2p_transfers=self._stats["p2p"], fs_transfers=self._stats["fs"],
            pool_restores=self._stats["pool"])

    def _end_time(self) -> float:
        return max((t for t, _ in self._completions), default=self.loop.now)

    # --------------------------------------------------------- factory -----
    def _reconcile(self):
        now = self.loop.now
        for d in self.factory.reconcile(now):
            if d.kind == "join":
                self.profiles[d.worker_id] = PROFILES[d.profile_name]
                store = ContextStore(
                    device_bytes=int(
                        PROFILES[d.profile_name].hbm_gb * 1024 ** 3))
                self._apply(self.scheduler.on_worker_join(
                    d.worker_id, now, profile=PROFILES[d.profile_name],
                    store=store))
            else:
                self._stats["preempt"] += 1
                for evmap in (self._task_events, self._fetch_events):
                    ev = evmap.pop(d.worker_id, None)
                    if ev:
                        ev.cancel()
                self._page_cached = {(w, k) for (w, k) in self._page_cached
                                     if w != d.worker_id}
                if self.mode == ContextMode.FULL:
                    info = self.scheduler.workers.get(d.worker_id)
                    if info is not None:
                        self._node_pool.demote_worker(info.store)
                self._apply(self.scheduler.on_worker_leave(d.worker_id, now))
        self._worker_samples.append((now, self.factory.size))
        if not self.scheduler.all_done() or self.scheduler.outstanding:
            self._reconcile_ev = self.loop.schedule_in(
                self.reconcile_every, self._reconcile)

    # ---------------------------------------------------------- actions ----
    def _apply(self, actions: List[Action]):
        for a in actions:
            if a.kind == "start":
                self._start_task(a)
            elif a.kind == "fetch":
                self._start_fetch(a)
            elif a.kind == "cancel":
                ev = self._task_events.pop(a.worker_id, None)
                if ev:
                    ev.cancel()

    def _start_fetch(self, a: Action):
        from repro_torch.core.store import TierFullError
        dur = modeled_fetch_seconds(a, self.profiles[a.worker_id],
                                    self.cost, self._stats)
        wid, key = a.worker_id, a.recipe.key()

        def done():
            self._fetch_events.pop(wid, None)
            self._node_pool.consume_fetch(a.source, key)
            info = self.scheduler.workers.get(wid)
            if info is not None:
                try:
                    info.store.admit_recipe(a.recipe, Tier.DEVICE,
                                            now=self.loop.now)
                except TierFullError:
                    pass     # on_fetch_done marks the key fetch_blocked
            self._apply(self.scheduler.on_fetch_done(wid, key,
                                                     self.loop.now))

        self._fetch_events[wid] = self.loop.schedule_in(dur, done)

    def _start_task(self, a: Action):
        profile = self.profiles[a.worker_id]
        task = self.scheduler.tasks[a.task_id]
        self._node_pool.consume_start(a)
        dur = modeled_start_seconds(a, task, profile, self.scheduler,
                                    self.planner, self.cost, self.mode,
                                    self._page_cached, self._stats,
                                    self.loop.now)
        wid, tid = a.worker_id, a.task_id

        def done():
            self._task_events.pop(wid, None)
            primary = task.duplicates_of or tid
            if primary not in self.scheduler.done_ids:
                self._completions.append((self.loop.now, task.n_items))
            self._apply(self.scheduler.on_task_done(wid, tid, self.loop.now))

        self._task_events[wid] = self.loop.schedule_in(dur, done)


def simulate_sweep(mode: ContextMode, capacity_fn, recipe: ContextRecipe,
                   total_inferences: int, batch_size: int,
                   cost: Optional[CostModel] = None,
                   straggler_factor: float = 0.0,
                   until: float = 10_000_000.0) -> SimResult:
    sim = ClusterSimulator(mode, capacity_fn, recipe, cost=cost,
                           straggler_factor=straggler_factor)
    sim.submit_sweep(total_inferences, batch_size)
    return sim.run(until=until)
