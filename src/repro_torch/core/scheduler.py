"""Context-aware scheduler — the manager-side half of Pervasive Context
Management.

Port of ``repro.core.scheduler``: framework-free, a copy with its imports
pointed at this package, so the same event trace gives the same actions
and the same ``fetch_log`` in both packages.

Pure policy, no clock of its own: callers (the live PCMManager or the
discrete-event cluster simulator) feed it events
(``on_worker_join/leave``, ``on_fetch_done``, ``on_task_done``, ...) and it
returns Actions (StartFetch / StartTask / Requeue). That split lets the
SAME scheduling code run the real runtime and the paper-figure simulations.

Policy highlights (paper §3 + production extensions):
  * placement prefers idle workers whose store already holds the task's
    context at the mode's persist tier (warm-context affinity); candidates
    at the same residency rung are ranked by their DeviceProfile (fastest
    compute for warm/cold starts, fastest PCIe for snapshot restores);
  * cold workers bootstrap down the **FetchSource ladder**
    (PEER / POOL / DISK / FS / BUILD, see ``repro.core.transfer``) by
    PREDICTED SECONDS, not fixed priority: every feasible rung is scored
    with the TransferPlanner's EWMA-calibrated bandwidths (donor fanout
    shares, shared-FS contention, the worker's own PCIe link for snapshot
    promotions, a modeled build cost) and the cheapest wins — a donor that
    measured slow genuinely loses to a local NVMe restore; the canonical
    PEER > POOL > DISK > FS > BUILD order is the deterministic tie-break.
    In full-context mode a queued task whose only idle candidates are cold
    is held while its context is bootstrapped (fetch first, start warm)
    instead of cold-building on the task path; with ``donor_wait`` the
    scheduler queues behind saturated donors — but only when an in-flight
    fetch whose completion can actually unblock THIS key exists and the
    predicted wait + transfer beats the best alternative rung. Every
    ladder decision is recorded in ``fetch_log`` (including commit-time
    degrades from the rung a dry placement decision promised) — the live
    runtime and the discrete-event simulator produce comparable decision
    sequences from the same policy;
  * preempted tasks are requeued at the FRONT (they have already waited);
  * straggler mitigation: optionally duplicate the slowest running task to
    a warm idle worker when it exceeds ``straggler_factor`` x the median
    completed duration; first result wins, the loser is cancelled.
"""

from __future__ import annotations

import collections
import enum
import itertools
import statistics
from dataclasses import dataclass, field
from typing import (Callable, Deque, Dict, List, Optional, Set, Tuple)

from repro_torch.core.context import ContextRecipe
from repro_torch.core.store import (ContextMode, ContextStore, Tier,
                                    TierFullError)
from repro_torch.core.transfer import (GBPS, FetchSource, TransferPlan,
                                       TransferPlanner)


# ------------------------------------------------------------------ types --
@dataclass
class Task:
    """One unit of work. ``recipes`` lists EVERY context the task needs
    (multi-context tasks hold several); an empty tuple means a contextless
    task, which the scheduler treats as always-warm. ``recipe`` remains the
    single-context shorthand and aliases ``recipes[0]``."""

    task_id: str
    recipe: Optional[ContextRecipe] = None
    recipes: Tuple[ContextRecipe, ...] = ()
    context_names: Tuple[str, ...] = () # names aligned with ``recipes``
    n_items: int = 1                    # inferences in this task
    payload: object = None              # live mode: (fn, args, kwargs)
    attempts: int = 0
    submitted_at: float = 0.0
    duplicates_of: Optional[str] = None
    priority: int = 0                   # >0 = front-of-queue hint
    last_worker: str = ""               # most recent placement (diagnostics)

    def __post_init__(self):
        if self.recipe is not None and not self.recipes:
            self.recipes = (self.recipe,)
        elif self.recipes and self.recipe is None:
            self.recipe = self.recipes[0]
        if not self.context_names:
            self.context_names = tuple(r.name for r in self.recipes)

    def keys(self) -> List[str]:
        return [r.key() for r in self.recipes]


class WorkerPhase(enum.Enum):
    IDLE = "idle"
    FETCHING = "fetching"
    BUSY = "busy"


@dataclass
class WorkerInfo:
    worker_id: str
    profile: object = None              # cluster.devices.DeviceProfile
    store: ContextStore = field(default_factory=ContextStore)
    phase: WorkerPhase = WorkerPhase.IDLE
    current: Optional[str] = None       # running / fetching task id
    fetching_key: Optional[str] = None
    fetching_recipe: Optional[ContextRecipe] = None
    fetching_source: Optional[FetchSource] = None
    fetching_donor: str = ""            # PEER fetch: the serving donor
    fetching_eta: Optional[float] = None  # predicted completion time
    joined_at: float = 0.0
    fetch_blocked: Set[str] = field(default_factory=set)  # admission refused
    # how bytes reach/leave this worker: "memcpy" for an in-process
    # thread, "socket" for a worker living in another OS process — feeds
    # the planner's per-kind calibration namespaces
    transport_kind: str = "memcpy"


@dataclass
class FetchDecision:
    """One FetchSource-ladder decision, recorded in ``fetch_log`` when a
    fetch action is issued. The live runtime and the simulator log through
    the same code path, so their sequences are directly comparable."""

    worker_id: str
    key: str
    source: FetchSource
    donor: str = ""                     # PEER decisions: the chosen donor
    t: float = 0.0
    # commit-time degrade: the rung a dry (commit=False) decision promised
    # when the commit landed on a different one (e.g. the promised donor's
    # fanout filled in between) — None for decisions that held
    degraded_from: Optional[FetchSource] = None


@dataclass
class Action:
    kind: str                           # "fetch" | "start" | "cancel"
    worker_id: str
    task_id: str
    plan: Optional[TransferPlan] = None
    recipe: Optional[ContextRecipe] = None
    recipes: Tuple[ContextRecipe, ...] = ()   # all contexts for a start
    warm: bool = False                  # device-resident before this start
    had_disk: bool = False              # ALL contexts disk-resident
    disk_resident: Tuple[bool, ...] = ()      # per-recipe disk residency
    host_resident: Tuple[bool, ...] = ()      # per-recipe host-RAM residency
    device_resident: Tuple[bool, ...] = ()    # per-recipe HBM residency
    source: Optional[FetchSource] = None      # fetch: ladder rung chosen
    donor: str = ""                           # fetch: PEER donor worker id
    donors: Tuple[str, ...] = ()              # PEER stripe lanes, primary 1st
    eta_seconds: float = 0.0        # fetch: scheduler's committed duration
    # prediction (the pipeline-aware rung model that chose the source) —
    # the dry-run surfaces price PEER fetches with it, so modeled timing
    # cannot drift from the policy's own cost model


@dataclass
class Completion:
    task_id: str
    worker_id: str
    t: float
    n_items: int
    duration: float


# -------------------------------------------------------------- scheduler --
class ContextAwareScheduler:
    def __init__(self, mode: ContextMode = ContextMode.FULL,
                 planner: Optional[TransferPlanner] = None,
                 straggler_factor: float = 0.0,
                 max_attempts: int = 100,
                 p2p: bool = True,
                 donor_wait: bool = False,
                 stripe_width: int = 2,
                 fetch_log_limit: int = 4096):
        self.mode = mode
        self.planner = planner or TransferPlanner()
        self.straggler_factor = straggler_factor
        self.max_attempts = max_attempts
        self.p2p = p2p                  # False: FS-only bootstrap (bench)
        # multi-source striping: a PEER bootstrap may pull disjoint chunk
        # ranges from up to this many free donors concurrently (1 = the
        # monolithic single-donor transfer)
        self.stripe_width = stripe_width
        # donor_wait: when every donor is fanout-saturated, hold the fetch
        # until a slot frees instead of taking a worse rung — the paper's
        # admission-controlled join storm. Cost-bounded: engaged only when
        # an in-flight fetch that can unblock THIS key exists (its
        # completion re-drives dispatch, so a wait can never stall the
        # runtime) AND predicted wait + peer transfer beats the cheapest
        # alternative rung (see _wait_for_donor_beats).
        self.donor_wait = donor_wait
        # node SnapshotPool residency oracle (key -> Tier or None),
        # installed by the backend: the POOL/DISK rungs of the ladder
        self.pool_tier: Optional[Callable[[str], Optional[Tier]]] = None
        # template-prefix placement oracle ((task, worker_id) -> bool),
        # installed by serving layers that know which worker's engine
        # already holds a task's shared prompt prefix in its page-level
        # prefix cache (repro.serving.paged.PrefixCache). A hit outranks
        # every equally-placed candidate — the hitting worker skips the
        # shared prefill entirely, which no DeviceProfile edge buys back
        self.prefix_hit: Optional[Callable[[Task, str], bool]] = None
        # ring buffer: long-lived front-door runs issue fetches forever,
        # so the decision log must not grow without bound
        self.fetch_log: Deque[FetchDecision] = collections.deque(
            maxlen=fetch_log_limit)

        self.queue: Deque[Task] = collections.deque()
        self.tasks: Dict[str, Task] = {}
        self.workers: Dict[str, WorkerInfo] = {}
        self.running: Dict[str, Tuple[str, float]] = {}   # task -> (worker, t0)
        self.completions: List[Completion] = []
        self.done_ids: Set[str] = set()
        self.failed: List[Task] = []
        self._durations: List[float] = []

    # ------------------------------------------------------------- events --
    def submit(self, task: Task, t: float = 0.0) -> List[Action]:
        task.submitted_at = t
        self.tasks[task.task_id] = task
        self._enqueue(task)
        return self.dispatch(t)

    def _enqueue(self, task: Task):
        """FIFO, except priority>0 tasks slot in ahead of lower-priority
        work (behind earlier tasks of equal-or-higher priority)."""
        if task.priority <= 0:
            self.queue.append(task)
            return
        idx = 0
        for queued in self.queue:
            if queued.priority >= task.priority:
                idx += 1
            else:
                break
        self.queue.insert(idx, task)

    def on_worker_join(self, worker_id: str, t: float, profile=None,
                       store: Optional[ContextStore] = None,
                       transport_kind: str = "memcpy") -> List[Action]:
        self.workers[worker_id] = WorkerInfo(
            worker_id=worker_id, profile=profile,
            store=store or ContextStore(), joined_at=t,
            transport_kind=transport_kind)
        return self.dispatch(t)

    def on_worker_leave(self, worker_id: str, t: float) -> List[Action]:
        """No-warning preemption: requeue whatever was running/fetching."""
        info = self.workers.pop(worker_id, None)
        if info is None:
            return []
        if info.current is not None:
            task = self.tasks.get(info.current)
            self.running.pop(info.current, None)
            if task and task.task_id not in self.done_ids:
                task.attempts += 1
                if task.attempts >= self.max_attempts:
                    self.failed.append(task)
                elif not self._has_live_duplicate(task):
                    self.queue.appendleft(task)      # preempted work first
        return self.dispatch(t)

    def on_fetch_done(self, worker_id: str, ctx_key: str, t: float
                      ) -> List[Action]:
        info = self.workers.get(worker_id)
        if info is None:
            return []
        info.phase = WorkerPhase.IDLE
        if (info.fetching_recipe is not None
                and info.fetching_recipe.key() == ctx_key):
            try:
                # the fetch materialized the context: record device
                # residency so placement sees the worker as warm and
                # prefetch never re-fires
                info.store.admit_recipe(info.fetching_recipe, Tier.DEVICE,
                                        now=t)
            except TierFullError:
                # admission refused (pinned-full tier): remember the key so
                # prefetch doesn't re-fire forever at this worker. Other
                # ValueErrors are genuine bugs and propagate.
                info.fetch_blocked.add(ctx_key)
        elif info.fetching_recipe is not None:
            # fetch FAILED (builder raised / transfer aborted): block the
            # key at this worker so the next dispatch cold-starts instead
            # of re-fetching forever
            info.fetch_blocked.add(info.fetching_recipe.key())
        info.fetching_key = None
        info.fetching_recipe = None
        info.fetching_source = None
        info.fetching_donor = ""
        info.fetching_eta = None
        info.current = None
        return self.dispatch(t)

    def on_task_done(self, worker_id: str, task_id: str, t: float
                     ) -> List[Action]:
        info = self.workers.get(worker_id)
        task = self.tasks.get(task_id)
        entry = self.running.pop(task_id, None)
        if info is not None:
            info.phase = WorkerPhase.IDLE
            info.current = None
            info.fetch_blocked.clear()   # capacity may have changed
            if self.mode == ContextMode.AGNOSTIC:
                info.store.clear()
            elif self.mode == ContextMode.PARTIAL and task is not None:
                for key in task.keys():
                    info.store.drop(key, down_to=Tier.LOCAL_DISK)
        actions: List[Action] = []
        primary = task.duplicates_of or task_id if task else task_id
        if primary not in self.done_ids:
            self.done_ids.add(primary)
            dur = t - entry[1] if entry else 0.0
            self._durations.append(dur)
            self.completions.append(Completion(
                task_id=primary, worker_id=worker_id, t=t,
                n_items=task.n_items if task else 1, duration=dur))
            actions += self._cancel_other_copies(primary, task_id)
        return actions + self.dispatch(t)

    # ------------------------------------------------- profile-aware rank --
    @staticmethod
    def _compute_rank(w: WorkerInfo):
        """Sort key: fastest accelerator first (warm/cold execution),
        deterministic tie-break on worker id. Workers without a profile
        rank behind profiled ones with nonzero compute."""
        return (-float(getattr(w.profile, "fp16_tflops", 0.0) or 0.0),
                w.worker_id)

    def _placement_rank(self, task: Task):
        """Candidate sort for warm/bootstrap placement. With a
        ``prefix_hit`` oracle installed, a worker holding the task's
        shared prompt prefix sorts ahead of every other candidate at the
        same residency rung; compute rank breaks ties as before. Without
        one this is exactly ``_compute_rank``."""
        if self.prefix_hit is None:
            return self._compute_rank

        def rank(w: WorkerInfo):
            return (0 if self.prefix_hit(task, w.worker_id) else 1,
                    self._compute_rank(w))
        return rank

    @staticmethod
    def _restore_rank(w: WorkerInfo):
        """Sort key for snapshot-promotion placement: restore cost is one
        host->HBM transfer, so the widest PCIe link wins."""
        return (-float(getattr(w.profile, "pcie_gbps", 0.0) or 0.0),
                w.worker_id)

    # ----------------------------------------------------------- dispatch --
    def dispatch(self, t: float) -> List[Action]:
        actions: List[Action] = []
        idle = [w for w in self.workers.values()
                if w.phase == WorkerPhase.IDLE]
        # 1) warm-affinity placement — a worker is warm for a task iff ALL
        #    its contexts are device-resident; contextless tasks (no
        #    recipes) are vacuously warm anywhere. Same-rung candidates are
        #    ranked by DeviceProfile (heterogeneity-aware placement).
        while self.queue and idle:
            task = self.queue[0]
            keys = task.keys()
            warm = sorted((w for w in idle
                           if all(w.store.has(k, Tier.DEVICE)
                                  for k in keys)),
                          key=self._placement_rank(task))
            target = None
            warm_start = False
            if warm:
                target, warm_start = warm[0], True
            else:
                # restore ladder: HOST_RAM (snapshot promotion, one H2D
                # transfer) beats LOCAL_DISK (unspill + load) beats a cold
                # worker (full transfer + build + compile)
                host = sorted((w for w in idle
                               if all(w.store.has(k, Tier.HOST_RAM)
                                      for k in keys)),
                              key=self._restore_rank)
                disk = host or sorted(
                    (w for w in idle
                     if all(w.store.has(k, Tier.LOCAL_DISK)
                            for k in keys)), key=self._restore_rank)
                if disk:
                    target = disk[0]
                else:
                    # every idle candidate is COLD. In full-context mode,
                    # bootstrap the context onto a cold worker down the
                    # FetchSource ladder (fetch first, start warm) when a
                    # cheap source exists, instead of cold-building on the
                    # task critical path.
                    verdict = (self._bootstrap_cold(task, idle, t, actions)
                               if self.mode == ContextMode.FULL and keys
                               else "start")
                    if verdict == "fetch":
                        continue          # idle shrank; task stays queued
                    if verdict == "wait":
                        break             # a completion will re-drive us
                    target = sorted(idle, key=self._compute_rank)[0]
            self.queue.popleft()
            idle.remove(target)
            actions.append(self._start(task, target, t, warm_start))
        # 2) prefetch contexts onto remaining idle workers (full mode only:
        #    it is the mode where warm residency outlives the fetching task).
        #    Demand covers queued AND running recipes: an idle worker warmed
        #    with a running task's context catches its requeue after a
        #    preemption (and hosts straggler duplicates) with zero startup.
        if self.mode == ContextMode.FULL:
            free = list(idle)
            for recipe in self._pending_context_demand():
                if not free:
                    break
                key = recipe.key()
                # offer each demanded recipe to a worker that LACKS it —
                # a worker already warm for it must not consume the demand
                # (and one whose admission was refused stays excluded)
                cands = [w for w in free
                         if not w.store.has(key, Tier.DEVICE)
                         and key not in w.fetch_blocked]
                if not cands:
                    continue
                w = cands[0]
                act = self._fetch(recipe, w, t)
                if act is None:
                    continue              # donor-wait: retry next dispatch
                free.remove(w)
                actions.append(act)
        # 3) straggler duplication
        if self.straggler_factor and not self.queue:
            actions += self._duplicate_stragglers(t)
        return actions

    def _bootstrap_cold(self, task: Task, idle: List[WorkerInfo], t: float,
                        actions: List[Action]) -> str:
        """Try to bootstrap the head task's first missing context onto a
        cold idle worker instead of cold-starting the task. Returns
        "fetch" (fetch issued, worker consumed from ``idle``), "wait"
        (donors saturated, hold the queue for a completing transfer) or
        "start" (no cheap source — cold-start as before)."""
        for w in sorted(idle, key=self._placement_rank(task)):
            # bootstrap the first context THIS candidate is missing
            recipe = next((r for r in task.recipes
                           if not w.store.has(r.key(), Tier.DEVICE)
                           and r.key() not in w.fetch_blocked), None)
            if recipe is None:
                continue
            source, _, wait = self._choose_source(recipe, w, t, commit=False)
            if wait:
                return "wait"
            if source in (FetchSource.PEER, FetchSource.POOL,
                          FetchSource.DISK):
                act = self._fetch(recipe, w, t, expected=source)
                if act is not None:
                    idle.remove(w)
                    actions.append(act)
                    return "fetch"
                # commit found the rung closed AND waiting now predicted
                # cheaper than the alternatives: a key-relevant fetch is
                # in flight, its completion re-drives dispatch
                return "wait"
            break       # cheapest candidate says FS/BUILD: cold-start
        return "start"

    def _start(self, task: Task, w: WorkerInfo, t: float, warm: bool
               ) -> Action:
        # snapshot per-recipe residency BEFORE admitting (admission
        # populates every tier, which would pollute the reading)
        disk_resident = tuple(w.store.has(r.key(), Tier.LOCAL_DISK)
                              for r in task.recipes)
        host_resident = tuple(w.store.has(r.key(), Tier.HOST_RAM)
                              for r in task.recipes)
        device_resident = tuple(w.store.has(r.key(), Tier.DEVICE)
                                for r in task.recipes)
        had_disk = bool(disk_resident) and all(disk_resident)
        w.phase = WorkerPhase.BUSY
        w.current = task.task_id
        task.last_worker = w.worker_id
        self.running[task.task_id] = (w.worker_id, t)
        # residency the task execution will create:
        for recipe in task.recipes:
            try:
                w.store.admit_recipe(recipe, Tier.DEVICE, now=t)
            except TierFullError:
                # pinned entries block admission: the task still runs, but
                # residency is NOT recorded — the store never lies about
                # capacity, and this worker won't be treated as warm for
                # the key it couldn't admit. Only TierFullError is
                # tolerable here; any other ValueError is an admission bug
                # and must propagate.
                pass
            w.store.touch(recipe.key(), now=t)
        return Action(kind="start", worker_id=w.worker_id,
                      task_id=task.task_id, recipe=task.recipe,
                      recipes=task.recipes, warm=warm, had_disk=had_disk,
                      disk_resident=disk_resident,
                      host_resident=host_resident,
                      device_resident=device_resident)

    def _donors_for(self, key: str, exclude: str) -> Set[str]:
        """Workers that can serve the context template peer-to-peer: any
        worker (other than the receiver) holding it DEVICE-resident and
        not itself mid-fetch. DEVICE, not LOCAL_DISK: a worker that
        demoted the context into the node pool still shows lower-tier
        residency but no longer holds a materialized copy to export —
        routing a receiver at it would always degrade to the builder."""
        return {wid for wid, info in self.workers.items()
                if wid != exclude
                and info.phase != WorkerPhase.FETCHING
                and info.store.has(key, Tier.DEVICE)}

    def _pool_claimed(self, key: str) -> bool:
        """True while an in-flight fetch is already promoting this key out
        of the node pool — pool snapshots are single-owner, so a second
        POOL fetch for the same key would race it and cold-build."""
        return any(info.fetching_key == key
                   and info.fetching_source in (FetchSource.POOL,
                                                FetchSource.DISK)
                   for info in self.workers.values())

    # fixed-priority tie-break between rungs predicting equal seconds —
    # the order the uncalibrated defaults produce for a paper-size context
    _LADDER_TIEBREAK = {FetchSource.PEER: 0, FetchSource.POOL: 1,
                        FetchSource.DISK: 2, FetchSource.FS: 3,
                        FetchSource.BUILD: 4}

    @staticmethod
    def _h2d_rate(w: WorkerInfo) -> Optional[float]:
        """The worker's own host->HBM bandwidth (bytes/s) from its
        DeviceProfile; None falls back to the planner's generic link."""
        pcie = float(getattr(w.profile, "pcie_gbps", 0) or 0)
        return pcie * GBPS if pcie > 0 else None

    def _lane_kinds(self, w: WorkerInfo, donors: Set[str]) -> Dict[str, str]:
        """Per-donor transport kind for a transfer INTO ``w``: a lane is a
        socket hop when either endpoint lives in another process, memcpy
        only for thread-to-thread handoff inside this one. Keys the
        planner's per-kind calibration namespaces."""
        if w.transport_kind == "socket":
            return {d: "socket" for d in donors}
        return {d: self.workers[d].transport_kind
                for d in donors if d in self.workers}

    def _rung_costs(self, recipe: ContextRecipe, w: WorkerInfo, t: float
                    ) -> Tuple[List[Tuple[float, int, FetchSource,
                                          Optional[str]]], Set[str]]:
        """Score every FEASIBLE rung for bootstrapping ``recipe`` onto
        ``w`` in predicted seconds (side-effect-free — nothing registers
        with the planner). Returns the rungs sorted cheapest-first (fixed
        ladder order breaks ties) plus the donor set, so callers can tell
        'no donors' from 'donors all fanout-saturated' (donor_wait)."""
        key = recipe.key()
        h2d = self._h2d_rate(w)
        rungs: List[Tuple[float, int, FetchSource, Optional[str]]] = []
        donors: Set[str] = set()
        if self.p2p and self.mode != ContextMode.AGNOSTIC:
            donors = self._donors_for(key, w.worker_id)
        if donors:
            best = self.planner.peer_seconds(recipe.transfer_bytes,
                                             donors, t,
                                             width=self.stripe_width,
                                             kinds=self._lane_kinds(w,
                                                                    donors))
            if best is not None:
                donor, transfer_s = best
                # the receiver restores the shipped template host->HBM;
                # no framework warm-up (its process is already alive) and
                # no compile (AOT executables ride along). Chunk-streamed:
                # the donor's device_get, the wire, and the receiver's
                # device_put pipeline instead of summing
                rungs.append((self.planner.pipeline_seconds(
                    [self.planner.d2h_seconds(recipe.transfer_bytes),
                     transfer_s,
                     self.planner.restore_seconds(
                         recipe.host_bytes, h2d_bytes_per_s=h2d)],
                    recipe.transfer_bytes),
                    self._LADDER_TIEBREAK[FetchSource.PEER],
                    FetchSource.PEER, donor))
        pool_tier = self.pool_tier(key) if self.pool_tier is not None \
            else None
        if pool_tier is not None and not self._pool_claimed(key):
            from_disk = Tier(pool_tier) == Tier.LOCAL_DISK
            src = FetchSource.DISK if from_disk else FetchSource.POOL
            rungs.append((self.planner.restore_seconds(
                recipe.host_bytes, from_disk=from_disk, h2d_bytes_per_s=h2d),
                self._LADDER_TIEBREAK[src], src, None))
        if recipe.transfer_bytes > 0:
            rungs.append((self.planner.cold_seconds(
                recipe.transfer_bytes, recipe.host_bytes, t,
                h2d_bytes_per_s=h2d),
                self._LADDER_TIEBREAK[FetchSource.FS], FetchSource.FS, None))
        rungs.append((self.planner.build_seconds(recipe.transfer_bytes),
                      self._LADDER_TIEBREAK[FetchSource.BUILD],
                      FetchSource.BUILD, None))
        rungs.sort(key=lambda r: (r[0], r[1]))
        return rungs, donors

    def rung_costs(self, recipe: ContextRecipe, worker_id: str, t: float
                   ) -> List[Tuple[FetchSource, float, str]]:
        """Public observability surface of the cost chooser: the feasible
        rungs for bootstrapping ``recipe`` onto ``worker_id`` as
        ``(source, predicted_seconds, donor)`` tuples, cheapest first —
        what ``_choose_source`` would pick and why."""
        rungs, _ = self._rung_costs(recipe, self.workers[worker_id], t)
        return [(src, sec, donor or "") for sec, _, src, donor in rungs]

    def _wait_for_donor_beats(self, key: str, recipe: ContextRecipe,
                              w: WorkerInfo, donors: Set[str], t: float,
                              best_alternative: float) -> bool:
        """donor_wait admission: hold this fetch for a donor slot ONLY if
        (a) an in-flight fetch exists whose completion can actually
        unblock THIS key — a receiver currently drawing from one of its
        donors (frees a fanout slot), or a worker fetching the same key
        (becomes a new donor) — and (b) the predicted wait plus an
        unconstrained peer transfer still beats the best alternative rung.
        Scoping to key-relevant fetches is both correctness (a joiner must
        not queue behind an unrelated transfer that will never free a
        donor for it) and liveness (each unblocker is a scheduler-tracked
        fetch whose completion re-drives dispatch)."""
        etas = [info.fetching_eta for info in self.workers.values()
                if info.phase == WorkerPhase.FETCHING
                and info.fetching_eta is not None
                and (info.fetching_key == key
                     or (info.fetching_donor
                         and info.fetching_donor in donors))]
        if not etas:
            return False
        wait_s = max(0.0, min(etas) - t)
        peer_s = (self.planner.peer_rate_seconds(recipe.transfer_bytes,
                                                 kind=w.transport_kind)
                  + self.planner.restore_seconds(
                      recipe.host_bytes, h2d_bytes_per_s=self._h2d_rate(w)))
        return wait_s + peer_s < best_alternative

    def _choose_source(self, recipe: ContextRecipe, w: WorkerInfo, t: float,
                       commit: bool = True
                       ) -> Tuple[Optional[FetchSource],
                                  Optional[TransferPlan], bool]:
        """Pick the cheapest FetchSource rung (predicted seconds, see
        ``_rung_costs``) for bootstrapping ``recipe`` onto ``w``. Returns
        (source, plan, wait). ``wait=True`` means every donor is fanout-
        saturated and waiting for a slot is predicted cheaper than the
        best alternative rung (donor_wait). With ``commit=False`` nothing
        is registered with the planner — a dry decision for placement;
        re-invoke with ``commit=True`` (via ``_fetch``) to reserve the
        flow. The commit path re-validates with the SAME admission
        predicate and walks the cost order, so a rung that closed between
        dry and commit degrades to the next-cheapest (``_fetch`` logs the
        degrade) instead of silently changing shape."""
        rungs, donors = self._rung_costs(recipe, w, t)
        best_sec, _, best_src, _ = rungs[0]
        peer_feasible = any(r[2] == FetchSource.PEER for r in rungs)
        if (self.donor_wait and donors and not peer_feasible
                and self._wait_for_donor_beats(recipe.key(), recipe, w,
                                               donors, t, best_sec)):
            return None, None, True
        if not commit:
            return best_src, None, False
        for _, _, source, donor in rungs:
            if source == FetchSource.PEER:
                plan = self.planner.peer_plan(recipe.transfer_bytes,
                                              donors, t,
                                              width=self.stripe_width,
                                              kinds=self._lane_kinds(w,
                                                                     donors))
                if plan is None:
                    # defensive only: within one call the scoring and the
                    # commit see the same planner state at the same t, so
                    # a scored-feasible PEER rung always commits — but a
                    # plan-less PEER action would silently run the builder
                    # on the receiver, so degrade rather than ship one
                    continue
                return FetchSource.PEER, plan, False
            if source in (FetchSource.POOL, FetchSource.DISK):
                plan = self.planner.pool_plan(
                    recipe.host_bytes, t,
                    from_disk=source == FetchSource.DISK,
                    h2d_bytes_per_s=self._h2d_rate(w))
                return source, plan, False
            if source == FetchSource.FS:
                return source, self.planner.fs_plan(recipe.transfer_bytes,
                                                    t), False
            return FetchSource.BUILD, None, False
        # unreachable: _rung_costs always appends the BUILD rung, and the
        # loop returns unconditionally when it reaches it

    def _fetch_eta(self, source: FetchSource, plan: Optional[TransferPlan],
                   recipe: ContextRecipe, w: WorkerInfo, t: float) -> float:
        """Predicted completion time of a fetch just issued — the transfer
        plus what the receiver does with it (mirroring the shape of the
        backends' fetch execution): a PEER install restores the shipped
        template host->HBM, POOL/DISK promotions are the plan alone, an FS
        fetch pays the full cold load (warm-up + disk read + host->HBM),
        and BUILD is the chooser's own build-cost model. Feeds
        ``_wait_for_donor_beats`` — a wait estimate, not a contract."""
        h2d = self._h2d_rate(w)
        if source in (FetchSource.POOL, FetchSource.DISK):
            return t + plan.seconds
        if source == FetchSource.PEER:
            # same chunk-pipelined d2h/wire/restore composition as the
            # rung score in _rung_costs — score, wait estimate, and the
            # dry-run surfaces' fetch pricing all read one formula
            return t + self.planner.pipeline_seconds(
                [self.planner.d2h_seconds(recipe.transfer_bytes),
                 plan.seconds,
                 self.planner.restore_seconds(recipe.host_bytes,
                                              h2d_bytes_per_s=h2d)],
                recipe.transfer_bytes)
        if source == FetchSource.FS:
            return t + plan.seconds + self.planner.cold_load_seconds(
                recipe.transfer_bytes, recipe.host_bytes,
                h2d_bytes_per_s=h2d)
        return t + self.planner.build_seconds(recipe.transfer_bytes)

    def _fetch(self, recipe: ContextRecipe, w: WorkerInfo, t: float,
               expected: Optional[FetchSource] = None) -> Optional[Action]:
        """Issue a bootstrap fetch for ``recipe`` on ``w`` at the cheapest
        FetchSource rung; None when the policy decides to wait for a donor
        slot. The decision is appended to ``fetch_log``; when a caller
        passes the rung its dry decision promised (``expected``) and the
        commit lands elsewhere, the decision records the degrade."""
        source, plan, wait = self._choose_source(recipe, w, t, commit=True)
        if wait:
            return None
        donor = plan.source if (plan is not None and plan.p2p) else ""
        self.fetch_log.append(FetchDecision(
            worker_id=w.worker_id, key=recipe.key(), source=source,
            donor=donor, t=t,
            degraded_from=expected if (expected is not None
                                       and expected != source) else None))
        w.phase = WorkerPhase.FETCHING
        w.fetching_key = recipe.key()
        w.fetching_recipe = recipe
        w.fetching_source = source
        w.fetching_donor = donor
        w.fetching_eta = self._fetch_eta(source, plan, recipe, w, t)
        w.current = None
        return Action(kind="fetch", worker_id=w.worker_id, task_id="",
                      plan=plan, recipe=recipe, source=source, donor=donor,
                      donors=plan.stripes if plan is not None else (),
                      eta_seconds=w.fetching_eta - t)

    def record_degrade(self, worker_id: str, key: str, source: FetchSource,
                       t: float, degraded_from: FetchSource,
                       donor: str = ""):
        """Log a runtime degrade the policy could not see at commit time —
        e.g. a striped PEER transfer whose every lane died mid-stream and
        whose receiver fell back down the ladder via its Library. Keeps
        ``fetch_log`` the complete account of where every context
        actually came from."""
        self.fetch_log.append(FetchDecision(
            worker_id=worker_id, key=key, source=source, donor=donor, t=t,
            degraded_from=degraded_from))

    def _pending_context_demand(self) -> List[ContextRecipe]:
        # scan a bounded prefix: queues can hold 100k+ tasks and demand is
        # dominated by the first few distinct recipes anyway
        seen = {}
        for task in itertools.islice(self.queue, 256):
            for recipe in task.recipes:
                seen.setdefault(recipe.key(), recipe)
        for tid in itertools.islice(self.running, 64):
            task = self.tasks.get(tid)
            if task is not None:
                for recipe in task.recipes:
                    seen.setdefault(recipe.key(), recipe)
        return list(seen.values())

    # ---------------------------------------------------------- straggler --
    def _duplicate_stragglers(self, t: float) -> List[Action]:
        if len(self._durations) < 5 or not self.running:
            return []
        med = statistics.median(self._durations)
        if med <= 0:
            return []
        actions = []
        idle_warm = [w for w in self.workers.values()
                     if w.phase == WorkerPhase.IDLE]
        for task_id, (wid, t0) in list(self.running.items()):
            if not idle_warm:
                break
            task = self.tasks.get(task_id)
            if task is None or task.duplicates_of is not None:
                continue
            if self._has_live_duplicate(task, exclude=task_id):
                continue
            if (t - t0) > self.straggler_factor * med:
                keys = task.keys()
                cands = [w for w in idle_warm
                         if all(w.store.has(k, Tier.DEVICE) for k in keys)
                         ] or idle_warm
                w = cands[0]
                idle_warm.remove(w)
                dup = Task(task_id=f"{task_id}~dup{task.attempts}",
                           recipes=task.recipes,
                           context_names=task.context_names,
                           n_items=task.n_items,
                           payload=task.payload, duplicates_of=task_id)
                self.tasks[dup.task_id] = dup
                actions.append(self._start(
                    dup, w, t,
                    all(w.store.has(k, Tier.DEVICE) for k in keys)))
        return actions

    def _has_live_duplicate(self, task: Task, exclude: str = "") -> bool:
        primary = task.duplicates_of or task.task_id
        for tid in self.running:
            if tid == exclude:
                continue
            other = self.tasks.get(tid)
            if other and (other.duplicates_of or other.task_id) == primary:
                return True
        return False

    def _cancel_other_copies(self, primary: str, done_tid: str
                             ) -> List[Action]:
        actions = []
        for tid, (wid, _) in list(self.running.items()):
            other = self.tasks.get(tid)
            if other and tid != done_tid and \
                    (other.duplicates_of or other.task_id) == primary:
                self.running.pop(tid)
                info = self.workers.get(wid)
                if info:
                    info.phase = WorkerPhase.IDLE
                    info.current = None
                actions.append(Action(kind="cancel", worker_id=wid,
                                      task_id=tid))
        # drop queued copies too (only rebuild the deque when needed —
        # O(queue) per completion would be quadratic on 100k-task sweeps)
        if any(tk.duplicates_of is not None for tk in
               itertools.islice(self.queue, 64)) or actions:
            self.queue = collections.deque(
                tk for tk in self.queue
                if (tk.duplicates_of or tk.task_id) != primary)
        return actions

    # ------------------------------------------------------------- status --
    def fetch_history(self, recipe: Optional[ContextRecipe] = None
                      ) -> List[FetchDecision]:
        """The FetchSource-ladder decisions issued so far, optionally
        filtered to one recipe. Backends expose this under their own
        locking."""
        log = list(self.fetch_log)
        if recipe is not None:
            key = recipe.key()
            log = [d for d in log if d.key == key]
        return log

    @property
    def outstanding(self) -> int:
        return len(self.queue) + len(self.running)

    def all_done(self) -> bool:
        live = {tid for tid, tk in self.tasks.items()
                if tk.duplicates_of is None}
        return live.issubset(self.done_ids)
