"""Pluggable execution backends behind the PCMClient session API.

Port of ``repro.core.backend``. An ``ExecutionBackend`` is anything that
can accept PCM task submissions and resolve their Futures. Two
implementations ship:

  * :class:`repro_torch.core.manager.PCMManager` — the LIVE backend: tasks
    run real PyTorch inference in-process (or in worker node processes),
    contexts are actual (weights, kernels, KV pool) objects.
  * :class:`SimulatorBackend` (here) — the DRY-RUN backend: the identical
    ContextAwareScheduler drives a discrete-event clock with the paper's
    calibrated device cost models. Task functions are **never executed**;
    each Future resolves to a :class:`SimTaskResult` describing the modeled
    placement and timing, float for float the reference's on the same
    inputs. ``PCMClient(backend=SimulatorBackend(...))`` turns one
    application script into a paper-figure simulation.

Both backends share the scheduler, the tiered ContextStore residency
bookkeeping, pinning, and the transfer planner — the only thing that
changes is whether wall-clock work happens. They differ in HOW progress is
made (``concurrent``): the live manager runs worker actor threads and
``wait`` blocks on condition variables; the simulator is single-threaded
and ``wait``/``step`` drive the discrete-event loop. Each exposes its own
single clock source (``now``) that stamps every scheduler event.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import (Any, Callable, Dict, List, Mapping, Optional, Protocol,
                    runtime_checkable)

from repro_torch.core.context import ContextRecipe
from repro_torch.core.manager import Future, PCMManager
from repro_torch.core.scheduler import Action, ContextAwareScheduler, Task
from repro_torch.core.store import (ContextMode, ContextStore, Tier,
                                    TierFullError)
from repro_torch.core.transfer import TransferPlanner


@runtime_checkable
class ExecutionBackend(Protocol):
    """What the PCMClient needs from a runtime. ``PCMManager`` and
    ``SimulatorBackend`` both satisfy it.

    ``concurrent`` tells consumers how progress is made: True — worker
    threads run independently and ``wait`` blocks on condition variables;
    False — single-threaded, and ``wait``/``step`` drive the event loop.
    ``now`` is the backend's single clock source: every scheduler event
    timestamp comes from it (wall seconds since start for the live
    runtime, modeled event-loop seconds for the simulator) — never from
    ``time.monotonic()`` directly."""

    concurrent: bool

    def submit(self, fn: Callable, args: tuple = (), kwargs: dict = None,
               recipe: Optional[ContextRecipe] = None,
               recipes: Optional[Mapping[str, ContextRecipe]] = None,
               n_items: int = 1, priority: int = 0) -> Future: ...

    def step(self) -> bool: ...

    def run_until_idle(self) -> int: ...

    def wait(self, fut: Future, timeout: Optional[float] = None) -> None: ...

    def warm_up(self, recipe: ContextRecipe,
                worker_ids: Optional[List[str]] = None) -> List[str]: ...

    def demote_context(self, recipe: ContextRecipe,
                       tier: Tier = Tier.HOST_RAM,
                       worker_ids: Optional[List[str]] = None
                       ) -> List[str]: ...

    def pin_context(self, recipe: ContextRecipe) -> None: ...

    def release_context(self, recipe: ContextRecipe) -> None: ...

    def residency(self, recipe: ContextRecipe) -> Dict[str, Tier]: ...

    def fetch_history(self, recipe: Optional[ContextRecipe] = None
                      ) -> List: ...

    def lookup_task(self, task_id: str) -> Optional[Task]: ...

    @property
    def outstanding(self) -> int: ...

    @property
    def now(self) -> float: ...

    def stats(self) -> Dict: ...


LiveBackend = PCMManager     # the live runtime under its backend name


@dataclass(frozen=True)
class SimTaskResult:
    """What a dry-run Future resolves to: the modeled execution record."""

    task_id: str
    worker_id: str
    n_items: int
    finished_at: float        # modeled seconds since t=0
    duration: float           # modeled startup + execution seconds
    warm: bool                # all contexts device-resident at start


class SimulatorBackend:
    """Discrete-event dry-run ExecutionBackend.

    Runs the production ContextAwareScheduler against modeled time using
    the calibrated device cost models from
    :mod:`repro_torch.cluster.devices`. ``capacity_fn`` (a trace from
    :mod:`repro_torch.cluster.traces`) makes the pool opportunistic; without one, a static pool of ``n_workers`` x
    ``profile`` joins at t=0.
    """

    concurrent = False       # progress happens by driving step()/wait()

    def __init__(self, n_workers: int = 4, profile: str = "a10",
                 mode: ContextMode = ContextMode.FULL,
                 cost=None, capacity_fn: Optional[Callable] = None,
                 planner: Optional[TransferPlanner] = None,
                 straggler_factor: float = 0.0,
                 reconcile_every: float = 15.0,
                 p2p: bool = True,
                 donor_wait: bool = False,
                 stripe_width: Optional[int] = None):
        # cluster imports stay local: core does not depend on cluster at
        # module load, so the live path never pays for the simulator
        from repro_torch.cluster.devices import PROFILES, CostModel
        from repro_torch.cluster.events import EventLoop
        from repro_torch.cluster.simulator import ModeledNodePool

        self.mode = mode
        self.cost = cost or CostModel()
        self.loop = EventLoop()
        self.planner = planner or TransferPlanner()
        stripe_kw = {} if stripe_width is None else \
            {"stripe_width": stripe_width}
        self.scheduler = ContextAwareScheduler(
            mode=mode, planner=self.planner,
            straggler_factor=straggler_factor,
            p2p=p2p, donor_wait=donor_wait, **stripe_kw)
        # modeled node snapshot pool (shared with ClusterSimulator):
        # preempting a worker in full-context mode "demotes" its
        # device-resident contexts here (mirroring the live runtime's
        # retirement demotion), so a later joiner's ladder can decide
        # POOL/DISK exactly like the live scheduler does
        self._node_pool = ModeledNodePool()
        self.scheduler.pool_tier = self._node_pool.get
        self._profiles_db = PROFILES
        self.profiles: Dict[str, Any] = {}
        self.reconcile_every = reconcile_every
        self._futures: Dict[str, Future] = {}
        self._unresolved = 0
        self._ids = itertools.count()
        self._task_ids = itertools.count()
        self._task_events: Dict[str, Any] = {}
        self._fetch_events: Dict[str, Any] = {}
        self._page_cached: set = set()
        self._pinned: set = set()
        self._pending: List[Action] = []
        self._stats = dict(cold=0, warm=0, disk=0, preempt=0, p2p=0, fs=0,
                           pool=0)
        self._reconcile_ev = None
        self.factory = None
        if capacity_fn is not None:
            from repro_torch.core.factory import WorkerFactory
            self.factory = WorkerFactory(capacity_fn)
            self._reconcile()
        else:
            for _ in range(n_workers):
                self.add_worker(profile)

    # ------------------------------------------------------------- pool ----
    def add_worker(self, profile: str = "a10") -> str:
        wid = f"sim{next(self._ids):03d}"
        self._join(wid, profile)
        return wid

    def _join(self, worker_id: str, profile_name: str):
        prof = self._profiles_db[profile_name]
        store = ContextStore(device_bytes=int(prof.hbm_gb * 1024 ** 3))
        store.pinned.update(self._pinned)
        self.profiles[worker_id] = prof
        self._apply(self.scheduler.on_worker_join(
            worker_id, self.loop.now, profile=prof, store=store))

    def preempt_worker(self, worker_id: str):
        self._stats["preempt"] += 1
        for evmap in (self._task_events, self._fetch_events):
            ev = evmap.pop(worker_id, None)
            if ev:
                ev.cancel()
        self._page_cached = {(w, k) for (w, k) in self._page_cached
                             if w != worker_id}
        self.profiles.pop(worker_id, None)
        if self.mode == ContextMode.FULL:
            # modeled retirement demotion: the reclaimed device's contexts
            # survive in node host RAM (the live SnapshotPool behavior)
            info = self.scheduler.workers.get(worker_id)
            if info is not None:
                self._node_pool.demote_worker(info.store)
        self._apply(self.scheduler.on_worker_leave(worker_id, self.loop.now))

    def _reconcile(self):
        now = self.loop.now
        for d in self.factory.reconcile(now):
            if d.kind == "join":
                self._join(d.worker_id, d.profile_name)
            else:
                self.preempt_worker(d.worker_id)
        self._reconcile_ev = None
        if self.scheduler.outstanding:
            self._reconcile_ev = self.loop.schedule_in(
                self.reconcile_every, self._reconcile)

    # ------------------------------------------------------------ submit ---
    def submit(self, fn: Callable, args: tuple = (), kwargs: dict = None,
               recipe: Optional[ContextRecipe] = None,
               recipes: Optional[Mapping[str, ContextRecipe]] = None,
               n_items: int = 1, priority: int = 0) -> Future:
        """Dry-run submission: ``fn`` is recorded but never called."""
        named: Dict[str, ContextRecipe] = dict(recipes or {})
        if recipe is not None and not named:
            named = {recipe.name: recipe}
        task_id = f"s{next(self._task_ids):05d}"
        task = Task(task_id=task_id, recipes=tuple(named.values()),
                    context_names=tuple(named.keys()), n_items=n_items,
                    priority=priority, payload=(fn, args, kwargs or {}))
        fut = Future(task_id, self)
        self._futures[task_id] = fut
        self._unresolved += 1
        fut.add_done_callback(self._on_resolved)
        self._apply(self.scheduler.submit(task, self.loop.now))
        if self.factory is not None and self._reconcile_ev is None:
            self._reconcile_ev = self.loop.schedule_in(
                self.reconcile_every, self._reconcile)
        return fut

    # ----------------------------------------------------------- contexts --
    def warm_up(self, recipe: ContextRecipe,
                worker_ids: Optional[List[str]] = None) -> List[str]:
        """Mark the context resident (modeled as prewarmed before t=0)."""
        warmed = []
        for wid in list(worker_ids or self.scheduler.workers):
            info = self.scheduler.workers.get(wid)
            if info is None:
                continue
            info.store.admit_recipe(recipe, self.mode.persist_tier,
                                    now=self.loop.now)
            warmed.append(wid)
        return warmed

    def pin_context(self, recipe: ContextRecipe):
        key = recipe.key()
        self._pinned.add(key)
        for info in self.scheduler.workers.values():
            info.store.pin(key)

    def release_context(self, recipe: ContextRecipe):
        key = recipe.key()
        self._pinned.discard(key)
        for info in self.scheduler.workers.values():
            info.store.unpin(key)

    def residency(self, recipe: ContextRecipe) -> Dict[str, Tier]:
        key = recipe.key()
        return {wid: info.store.highest_tier(key)
                for wid, info in self.scheduler.workers.items()}

    def demote_context(self, recipe: ContextRecipe,
                       tier: Tier = Tier.HOST_RAM,
                       worker_ids: Optional[List[str]] = None) -> List[str]:
        """Modeled demotion: device residency drops to ``tier`` on each
        holding worker; a later start there pays the modeled promotion
        (host->HBM, or disk load) instead of a cold transfer+build.
        Pinned contexts refuse demotion, matching the live backend."""
        if tier not in (Tier.HOST_RAM, Tier.LOCAL_DISK):
            raise ValueError(f"demotion target must be HOST_RAM or "
                             f"LOCAL_DISK, got {tier!r}")
        key = recipe.key()
        moved = []
        for wid in list(worker_ids or self.scheduler.workers):
            info = self.scheduler.workers.get(wid)
            if info is None or not info.store.has(key, Tier.DEVICE) \
                    or key in info.store.pinned:
                continue
            info.store.drop(key, down_to=tier)
            moved.append(wid)
        if moved:
            # the demoted snapshot lands in the modeled node pool, where a
            # cold joiner's ladder can find it (POOL/DISK rungs)
            self._node_pool.put(key, tier)
        return moved

    # --------------------------------------------------------- execution ---
    def step(self) -> bool:
        """Advance modeled time by one event; False when none pending."""
        return self.loop.run_one()

    def wait(self, fut: Future, timeout: Optional[float] = None):
        """Drive the event loop until ``fut`` resolves. Stepwise, not
        run_until_idle: the deadline is checked between events, so a
        timeout can't be overshot by the whole backlog."""
        import time as _time
        deadline = None if timeout is None else _time.monotonic() + timeout
        while not fut.done:
            progressed = self.step()
            if fut.done:
                break
            if not progressed:
                if self.outstanding == 0:
                    raise RuntimeError(fut._lost_message())
                if deadline is None:
                    # single-threaded runtime: no event can arrive while we
                    # block here, so a stall with work outstanding is final
                    raise RuntimeError(
                        f"backend stalled with {self.outstanding} "
                        f"task(s) outstanding and no runnable workers "
                        f"while waiting on {fut.task_id} — add workers or "
                        "pass result(timeout=...)")
                _time.sleep(0.001)   # bounded wait until the deadline
            if deadline is not None and _time.monotonic() >= deadline:
                raise TimeoutError(
                    f"task {fut.task_id} did not complete within "
                    f"{timeout:.3f}s ({self.outstanding} tasks "
                    "still outstanding)")

    def _on_resolved(self, fut: Future):
        self._unresolved -= 1

    def run_until_idle(self) -> int:
        n = 0
        while self._unresolved and self.loop.run_one():
            n += 1
        return n

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
        from repro_torch.cluster.simulator import modeled_fetch_seconds
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
                    pass     # pin-blocked: on_fetch_done marks the worker
                    # fetch_blocked for this key; other ValueErrors are
                    # admission bugs and propagate

            self._apply(self.scheduler.on_fetch_done(wid, key,
                                                     self.loop.now))

        self._fetch_events[wid] = self.loop.schedule_in(dur, done)

    def _start_task(self, a: Action):
        from repro_torch.cluster.simulator import modeled_start_seconds
        profile = self.profiles[a.worker_id]
        task = self.scheduler.tasks[a.task_id]
        self._node_pool.consume_start(a)
        dur = modeled_start_seconds(a, task, profile, self.scheduler,
                                    self.planner, self.cost, self.mode,
                                    self._page_cached, self._stats,
                                    self.loop.now)
        wid, tid = a.worker_id, a.task_id
        warm_start = a.warm

        def done():
            self._task_events.pop(wid, None)
            fut = self._futures.get(task.duplicates_of or tid)
            if fut:
                fut.set_result(SimTaskResult(
                    task_id=task.duplicates_of or tid, worker_id=wid,
                    n_items=task.n_items, finished_at=self.loop.now,
                    duration=dur, warm=warm_start))
            self._apply(self.scheduler.on_task_done(wid, tid, self.loop.now))

        self._task_events[wid] = self.loop.schedule_in(dur, done)

    # ------------------------------------------------------------- status --
    @property
    def outstanding(self) -> int:
        return self.scheduler.outstanding

    def lookup_task(self, task_id: str) -> Optional[Task]:
        return self.scheduler.tasks.get(task_id)

    def fetch_history(self, recipe: Optional[ContextRecipe] = None) -> List:
        """FetchSource-ladder decisions (optionally for one recipe) — the
        same ``fetch_log`` records the live backend exposes, on modeled
        time."""
        return self.scheduler.fetch_history(recipe)

    @property
    def now(self) -> float:
        """Modeled seconds since the backend was created."""
        return self.loop.now

    def stats(self) -> Dict:
        return {"now": self.loop.now,
                "completed": len(self.scheduler.completions),
                "cold_starts": self._stats["cold"],
                "warm_starts": self._stats["warm"],
                "disk_hits": self._stats["disk"],
                "preemptions": self._stats["preempt"],
                "p2p_transfers": self._stats["p2p"],
                "fs_transfers": self._stats["fs"],
                "pool_restores": self._stats["pool"]}
