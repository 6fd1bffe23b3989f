"""Worker factory — the TaskVine-factory analogue — and the elastic
runner that drives a LIVE PCMManager from a capacity trace.

Port of ``repro.core.factory``: the capacity callable is any trace of
``repro_torch.cluster.traces`` (or a cluster API), and a join carries the
DeviceProfile that ``profiles`` maps its name to.

:class:`WorkerFactory` watches the opportunistic capacity signal (a trace
in simulation; a cluster API in production) and reconciles the worker pool
against it: spawn directives when capacity rises, and — because
opportunistic preemption is the CLUSTER's decision, not ours — the
preemption events the trace dictates. The factory is reactive (paper §1):
it never requests capacity, it adapts to what appears/disappears.

:class:`ElasticRunner` is the live half: it applies the factory's
directives to a running :class:`~repro.core.manager.PCMManager` on a real
clock (``add_worker``/``preempt_worker``, with the trace's heterogeneous
DeviceProfiles attached to the live workers), either stepped explicitly
(``step()``, deterministic — what the policy-parity tests use) or from a
background reconcile thread (``start()``/``stop()``). ``time_scale``
compresses trace time so an hours-long capacity trace can drive a
seconds-long live run: ``trace_t = wall_elapsed * time_scale``.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional


@dataclass
class PoolDirective:
    kind: str              # "join" | "leave"
    worker_id: str
    profile_name: str = ""
    t: float = 0.0


class WorkerFactory:
    """Reconciles the worker pool to a capacity function.

    ``capacity_fn(t) -> list[profile_name]`` describes which opportunistic
    slots exist at time t (one entry per available GPU/slice, identified by
    device profile). Heterogeneity is first-class: slots carry profiles.
    """

    def __init__(self, capacity_fn: Callable[[float], List[str]],
                 min_workers: int = 0, max_workers: int = 10_000,
                 name_prefix: str = "w"):
        self.capacity_fn = capacity_fn
        self.min_workers = min_workers
        self.max_workers = max_workers
        self._ids = itertools.count()
        self._prefix = name_prefix
        self.live: Dict[str, str] = {}       # worker_id -> profile name

    def reconcile(self, t: float) -> List[PoolDirective]:
        want = list(self.capacity_fn(t))[:self.max_workers]
        directives: List[PoolDirective] = []

        # count per profile
        want_counts: Dict[str, int] = {}
        for p in want:
            want_counts[p] = want_counts.get(p, 0) + 1
        have_counts: Dict[str, int] = {}
        for p in self.live.values():
            have_counts[p] = have_counts.get(p, 0) + 1

        # leaves: profiles with surplus (cluster reclaimed those slots)
        for profile, have in sorted(have_counts.items()):
            surplus = have - want_counts.get(profile, 0)
            if surplus > 0:
                victims = [wid for wid, p in sorted(self.live.items())
                           if p == profile][:surplus]
                for wid in victims:
                    del self.live[wid]
                    directives.append(PoolDirective("leave", wid, profile, t))

        # joins: profiles with deficit
        for profile, want_n in sorted(want_counts.items()):
            deficit = want_n - have_counts.get(profile, 0)
            for _ in range(max(0, deficit)):
                wid = f"{self._prefix}{next(self._ids):04d}"
                self.live[wid] = profile
                directives.append(PoolDirective("join", wid, profile, t))
        return directives

    @property
    def size(self) -> int:
        return len(self.live)


class ElasticRunner:
    """Drives a live PCMManager's worker pool from a capacity function.

    The live analogue of ``ClusterSimulator._reconcile``: every
    ``reconcile_every`` wall seconds (or every explicit ``step()``) the
    factory's directives are applied to the manager — ``join`` spawns a
    real worker actor carrying the slot's DeviceProfile, ``leave``
    preempts it with no warning (contexts demote to the node snapshot
    pool; joiners later restore peer-to-peer or from the pool).

    ``profiles`` maps trace profile names to DeviceProfile objects and
    defaults to ``repro_torch.cluster.devices.PROFILES`` (imported lazily
    so the core package stays cluster-free at import time); a name it
    does not hold joins without a profile. ``time_scale`` compresses trace
    time against the manager clock.

    With ``spawn_remote=True`` a ``join`` directive spawns a WHOLE WORKER
    PROCESS (``repro_torch.cluster.node``) that connects to the manager's
    socket transport instead of an in-process actor thread — the manager
    must be ``listen()``-ing first. Joins become asynchronous (the worker
    appears when its HELLO lands), which is exactly how an opportunistic
    cluster behaves; ``leave`` retires the node through the same
    preemption path (its contexts demote over the wire into the manager
    pool) and the process exits on the BYE handshake. ``node_kwargs``
    passes through to :func:`repro_torch.cluster.node.spawn_node_process`
    (device, kernel build directory, extra import paths, heartbeat
    cadence).
    """

    def __init__(self, manager, capacity_fn: Callable[[float], List[str]],
                 profiles: Optional[Mapping[str, object]] = None,
                 reconcile_every: float = 0.25,
                 time_scale: float = 1.0,
                 max_workers: int = 10_000,
                 name_prefix: str = "w",
                 spawn_remote: bool = False,
                 node_kwargs: Optional[Dict] = None):
        self.manager = manager
        if profiles is None:
            from repro_torch.cluster.devices import PROFILES as profiles
        self.profiles = profiles
        self.factory = WorkerFactory(capacity_fn, max_workers=max_workers,
                                     name_prefix=name_prefix)
        self.reconcile_every = reconcile_every
        self.time_scale = time_scale
        self.spawn_remote = spawn_remote
        self.node_kwargs = dict(node_kwargs or {})
        self.procs: Dict[str, object] = {}        # worker_id -> Popen
        self.events: List[PoolDirective] = []     # every applied directive
        self.joins = 0
        self.preemptions = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- drive ---
    def trace_now(self) -> float:
        """The trace clock: manager seconds compressed by ``time_scale``."""
        return self.manager.now * self.time_scale

    def step(self, trace_t: Optional[float] = None) -> List[PoolDirective]:
        """One reconcile pass at trace time ``trace_t`` (default: the
        scaled manager clock). Deterministic given the trace — tests and
        the policy-parity harness call this directly."""
        t = self.trace_now() if trace_t is None else trace_t
        applied: List[PoolDirective] = []
        for d in self.factory.reconcile(t):
            if d.kind == "join":
                if self.spawn_remote:
                    self._spawn_node(d)
                else:
                    self.manager.add_worker(
                        worker_id=d.worker_id,
                        profile=self.profiles.get(d.profile_name))
                self.joins += 1
            else:
                self._leave(d.worker_id)
                self.preemptions += 1
            applied.append(d)
        self.events.extend(applied)
        self._reap()
        return applied

    def _spawn_node(self, d: PoolDirective):
        from repro_torch.cluster.node import spawn_node_process
        addr = self.manager.address
        if addr is None:
            raise RuntimeError(
                "spawn_remote=True requires manager.listen() before the "
                "first join directive")
        profile = d.profile_name \
            if d.profile_name in self.profiles else None
        self.procs[d.worker_id] = spawn_node_process(
            addr, d.worker_id, profile=profile, **self.node_kwargs)

    def _leave(self, worker_id: str):
        proc = self.procs.get(worker_id)
        if proc is not None and worker_id not in self.manager.workers:
            # reclaimed before its HELLO ever landed: nothing to retire —
            # kill the half-started process so it cannot join a pool that
            # no longer wants it
            self.procs.pop(worker_id, None)
            try:
                proc.terminate()
            except Exception:
                pass
            return
        # joined workers (thread or process) retire through the normal
        # no-warning preemption path (contexts demote to the node pool);
        # a node process exits on the BYE handshake and is reaped on a
        # later step
        self.manager.preempt_worker(worker_id)

    def _reap(self):
        """Collect node processes that exited after retiring."""
        for wid, proc in list(self.procs.items()):
            if getattr(proc, "poll", lambda: None)() is not None:
                self.procs.pop(wid, None)

    def run_for(self, wall_seconds: float):
        """Blocking drive loop for ``wall_seconds`` of wall time."""
        import time as _time
        deadline = _time.monotonic() + wall_seconds
        while _time.monotonic() < deadline and not self._stop.is_set():
            self.step()
            self._stop.wait(self.reconcile_every)

    def start(self) -> "ElasticRunner":
        """Reconcile from a background thread until ``stop()``."""
        if self._thread is not None:
            raise RuntimeError("ElasticRunner already started")
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    self.step()
                except Exception:
                    import sys
                    import traceback
                    traceback.print_exc(file=sys.stderr)
                self._stop.wait(self.reconcile_every)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="pcm-elastic-runner")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    @property
    def size(self) -> int:
        return self.factory.size

    def stats(self) -> Dict:
        return {"pool_size": self.size, "joins": self.joins,
                "preemptions": self.preemptions,
                "node_procs": len(self.procs),
                "trace_now": self.trace_now()}
