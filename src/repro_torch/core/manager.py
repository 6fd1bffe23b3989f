"""PCMManager — the live concurrent (in-process) PCM runtime.

Port of ``repro.core.manager`` for workers that are threads of this
process. Actor-style execution core. Each logical worker is a **thread
with a mailbox** (:class:`LiveWorker`) that owns its :class:`Library` and
:class:`ContextStore`: builds, invocations, demotions and restores for a
worker all happen on its own thread, serialized by the mailbox. The
manager side — the ContextAwareScheduler, the Future table and the task
clock — lives behind one lock; every runtime event (submit, fetch-done,
task-done, join, leave) enters through that lock, asks the scheduler for
Actions, and routes them to worker mailboxes. Nothing busy-polls:
Futures carry condition variables and resolve the moment a worker reports
completion.

Context tier movement is PHYSICAL here. Preempting a worker
(``preempt_worker``) reclaims its device: the scheduler instantly requeues
its in-flight task (no-warning semantics), and the worker's retirement
demotes every device-resident context into the node
:class:`~repro_torch.core.store.SnapshotPool` — weights and engine state
copied to pinned host tensors, the built kernels retained, LRU snapshots
spilling to local disk through ``checkpoint/io``. A later ``add_worker``
(or any worker that needs the context) PROMOTES the snapshot instead of
re-running the builder: zero builder calls, zero kernel builds,
bit-identical decode state — the paper's restore-cost-not-startup-cost
claim, executed for real.

Every worker thread issues its kernels and copies on the default stream
of the one device, so the work of different workers serializes on the
card; per-worker streams are later work. Workers that are processes on
other nodes (the reference's ``RemoteWorker``, ``listen`` and the
wire-blob install) arrive with the port slice for ``core/wire.py``,
``core/transport.py`` and ``cluster/node.py``.

All scheduler event timestamps come from one clock source: ``self.now``
(monotonic seconds since the manager started).

PCMManager implements the ``ExecutionBackend`` protocol
(:mod:`repro_torch.core.backend`): the PCMClient session API drives it.
"""

from __future__ import annotations

import atexit
import itertools
import queue
import sys
import threading
import time
import traceback
import weakref
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from repro_torch.core.context import (GB, ContextRecipe, ContextSnapshot,
                                      export_context, restore_context,
                                      stripe_export_state,
                                      stripe_export_template)
from repro_torch.core.library import Library
from repro_torch.core.scheduler import (Action, ContextAwareScheduler,
                                        ContextMode, Task)
from repro_torch.core.store import (ContextStore, SnapshotPool, Tier,
                                    TierFullError)
from repro_torch.core.streaming import (ChunkCorruptionError, ChunkPlan,
                                        StripeBuffer, assign_lanes,
                                        chunk_digest, host_chunk)
from repro_torch.core.transfer import (FetchSource, TransferPlan,
                                       TransferPlanner)


class Future:
    """Handle to one submitted task.

    Resolution is event-driven: worker threads (live backend) or the
    discrete-event loop (simulator backend) call ``set_result`` /
    ``set_exception``; ``result(timeout=...)`` blocks on a condition
    variable (live) or drives the event loop (sim) via ``backend.wait``.
    """

    def __init__(self, task_id: str, backend):
        self.task_id = task_id
        self._backend = backend
        self._value: Any = None
        self._ready = False
        self.error: Optional[BaseException] = None
        self._callbacks: List[Callable[["Future"], None]] = []
        self._cond = threading.Condition(threading.RLock())

    # ------------------------------------------------------- resolution ----
    def set_result(self, value: Any):
        with self._cond:
            if self._ready:
                return
            self._value = value
            self._ready = True
            self._cond.notify_all()
            self._fire_callbacks()

    def set_exception(self, error: BaseException):
        with self._cond:
            if self._ready:
                return
            self.error = error
            self._ready = True
            self._cond.notify_all()
            self._fire_callbacks()

    def _fire_callbacks(self):
        # fired from the resolving thread (a worker actor, holding runtime
        # locks): a raising user callback must never wedge the runtime
        callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            try:
                cb(self)
            except BaseException:
                traceback.print_exc(file=sys.stderr)

    def add_done_callback(self, cb: Callable[["Future"], None]):
        """Run ``cb(self)`` once the future resolves (immediately if it
        already has)."""
        with self._cond:
            if not self._ready:
                self._callbacks.append(cb)
                return
        cb(self)

    # --------------------------------------------------------- consumers ---
    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._ready:
            self._backend.wait(self, timeout)
        if self.error is not None:
            raise self.error
        return self._value

    def _lost_message(self) -> str:
        task = self._backend.lookup_task(self.task_id)
        if task is None:
            return f"task {self.task_id} lost (unknown to the scheduler)"
        where = task.last_worker or "<never placed>"
        return (f"task {self.task_id} lost after {task.attempts} attempt(s); "
                f"last worker {where} — exceeded max_attempts or the pool "
                "drained with the task unfinished")

    @property
    def done(self) -> bool:
        return self._ready


_STOP = "stop"
_RETIRE = "retire"


class _StripeFetch:
    """Bookkeeping for one in-flight striped PEER transfer: which physical
    lanes exist (donor workers, plus an optional receiver-side pool lane),
    which lane currently OWNS each assignment lane's refs (ownership moves
    when a lane dies), and the receiver-side :class:`StripeBuffer` that
    verifies and assembles the chunks."""

    def __init__(self, stripe_id: int, recipe: ContextRecipe,
                 receiver_id: str, plan: Optional[TransferPlan],
                 donor_ids: tuple, n_pool: int):
        self.stripe_id = stripe_id
        self.recipe = recipe
        self.receiver_id = receiver_id
        self.plan = plan                  # planner TransferPlan (the flows)
        self.donor_ids = donor_ids        # assignment lane -> donor worker
        self.n_pool = n_pool
        self.buffer = StripeBuffer()
        self.failed_lanes: set = set()    # physical lanes that died
        # assignment lane -> physical lane responsible for its refs
        self.lane_owner: Dict[int, int] = {
            lane: lane for lane in range(len(donor_ids))}
        self.done = False


def _shutdown_at_exit(mgr_ref):
    """Join every worker thread before the interpreter (and the CUDA
    runtime underneath it) tears down: a thread still inside a kernel
    launch or a device copy at exit can abort the process."""
    mgr = mgr_ref()
    if mgr is not None:
        mgr.shutdown()


class LiveWorker:
    """One worker actor: a daemon thread + mailbox owning this worker's
    Library (materialized contexts) and ContextStore (residency
    bookkeeping).

    Mailbox messages are ``(kind, ...)`` tuples routed by the manager:

      ("start", task_id)              run one task invocation
      ("fetch", recipe, plan)         materialize/restore off-path (the
                                      POOL/DISK/FS/BUILD ladder rungs)
      ("donate", recipe, rcv, plan)   export this worker's warm context as
                                      a template snapshot and ship it to
                                      receiver ``rcv`` (monolithic PEER
                                      transfer — the donor keeps its copy
                                      serving)
      ("donate_chunks", sid, recipe,  streamed PEER: export a budget of
       rcv, spec)                     verified chunks of stripe ``sid``
                                      this turn, then repost the
                                      continuation to our own tail so
                                      queued serving work interleaves
      ("stripe_pool", sid, recipe,    serve immutable params chunks out of
       spec)                          the node SnapshotPool as an extra
                                      stripe lane (runs on the receiver)
      ("install_stripe", sid)         assemble stripe ``sid``'s chunks and
                                      promote the result (adopt)
      ("install", recipe, snap, plan  adopt a donated snapshot (restore to
       [, degraded_from])             device); ``snap=None`` degrades to
                                      the normal fetch ladder (logged as a
                                      degrade when ``degraded_from`` set)
      ("warm", recipe, event)         synchronous warm-up (event set when
                                      resident)
      ("demote", key, tier, event)    physically demote one context
      ("retire",)                     device reclaimed: demote everything
                                      to the node snapshot pool and exit
      ("stop",)                       plain shutdown (no demotion)

    The thread executes messages strictly in order, so a preemption that
    lands mid-invocation simply marks the worker dead (``alive=False``):
    the in-flight result is discarded at the revalidation barrier and the
    retirement demotion runs right after the current message finishes —
    no state is ever snapshotted mid-mutation.
    """

    def __init__(self, worker_id: str, manager: "PCMManager", profile=None):
        self.worker_id = worker_id
        self.profile = profile          # cluster.devices.DeviceProfile
        self.library = Library(worker_id, snapshots=manager.snapshots,
                               streamed=manager.streamed)
        hbm_gb = getattr(profile, "hbm_gb", None)
        self.store = ContextStore(device_bytes=int(hbm_gb * GB)) \
            if hbm_gb else ContextStore()
        self.mailbox: "queue.SimpleQueue" = queue.SimpleQueue()
        self.alive = True
        self._mgr = manager
        self._thread = threading.Thread(
            target=self._run, name=f"pcm-worker-{worker_id}", daemon=True)

    def start(self):
        self._thread.start()

    def post(self, msg: tuple):
        self.mailbox.put(msg)

    def join(self, timeout: Optional[float] = None):
        self._thread.join(timeout)

    # ------------------------------------------------------------ thread ---
    def _run(self):
        while True:
            msg = self.mailbox.get()
            kind = msg[0]
            if kind == _STOP:
                self._mgr._absorb_library(self.library)
                break
            if kind == _RETIRE:
                try:
                    self.library.demote_all(force=True)
                except BaseException:
                    traceback.print_exc(file=sys.stderr)
                self._mgr._absorb_library(self.library)
                break
            try:
                if kind == "start":
                    self._handle_start(msg[1])
                elif kind == "fetch":
                    self._handle_fetch(msg[1], msg[2])
                elif kind == "donate":
                    self._handle_donate(msg[1], msg[2], msg[3])
                elif kind == "donate_chunks":
                    self._handle_donate_chunks(msg[1], msg[2], msg[3],
                                               msg[4])
                elif kind == "stripe_pool":
                    self._handle_stripe_pool(msg[1], msg[2], msg[3])
                elif kind == "install_stripe":
                    self._handle_install_stripe(msg[1])
                elif kind == "install":
                    self._handle_install(msg[1], msg[2], msg[3],
                                         msg[4] if len(msg) > 4 else None)
                elif kind == "warm":
                    self._handle_warm(msg[1], msg[2], msg[3])
                elif kind == "demote":
                    self._handle_demote(msg[1], msg[2], msg[3], msg[4])
            except BaseException:
                traceback.print_exc(file=sys.stderr)
        self._drain_events()

    def _drain_events(self):
        # a retiring worker must not strand synchronous callers or wedge
        # the transfer pipeline: release every event still waiting in the
        # mailbox, degrade pending donations so their receivers fall back
        # down the ladder, and free every planner flow we would have
        # completed
        while True:
            try:
                msg = self.mailbox.get_nowait()
            except queue.Empty:
                return
            kind = msg[0]
            if kind == "donate":
                # the receiver is still FETCHING on our donation: hand it
                # a None snapshot so it degrades to pool/disk/builder
                self._mgr._deliver_install(msg[2], msg[1], None, msg[3],
                                           degraded_from=FetchSource.PEER)
            elif kind == "donate_chunks":
                self._mgr._stripe_lane_lost(
                    msg[1], msg[4].get("via_lane", msg[4]["lane"]))
            elif kind == "stripe_pool":
                self._mgr._stripe_lane_lost(msg[1], msg[3]["lane"])
            elif kind == "install_stripe":
                self._mgr._stripe_failed(msg[1])
            elif kind == "fetch":
                self._mgr._flow_done(msg[2], failed=True)
            elif kind == "install":
                self._mgr._flow_done(msg[3], failed=True)
            for part in msg:
                if isinstance(part, threading.Event):
                    part.set()

    # ---------------------------------------------------------- handlers ---
    def _handle_start(self, task_id: str):
        mgr = self._mgr
        with mgr._lock:
            entry = mgr.scheduler.running.get(task_id)
            if not self.alive or entry is None or entry[0] != self.worker_id:
                return                    # cancelled / reassigned / dead
            task = mgr.scheduler.tasks[task_id]
            fn, args, kwargs = task.payload
            named = dict(zip(task.context_names, task.recipes))
        # the invocation (context build/restore + user fn) runs OUTSIDE the
        # manager lock: other workers keep dispatching and completing
        value: Any = None
        error: Optional[BaseException] = None
        try:
            value = self.library.invoke(fn, args, kwargs,
                                        recipes=named or None,
                                        task_id=task_id)
        except BaseException as e:       # report, don't wedge the pool
            error = e
        with mgr._cond:
            self._drain_stage_obs_locked()
            entry = mgr.scheduler.running.get(task_id)
            if not self.alive or entry is None or entry[0] != self.worker_id:
                # preempted or cancelled while running: the scheduler has
                # already requeued/completed elsewhere — discard this copy
                return
            if mgr.mode == ContextMode.AGNOSTIC:
                self.library.evict_all()
            elif mgr.mode == ContextMode.PARTIAL:
                for key in task.keys():
                    self.library.evict(key)
            fut = mgr._futures.get(task.duplicates_of or task_id)
            if fut is not None:
                if error is None:
                    fut.set_result(value)
                else:
                    fut.set_exception(error)
            acts = mgr.scheduler.on_task_done(self.worker_id, task_id,
                                              mgr.now)
            mgr._fail_unresolved()
            mgr._dispatch(acts)
            mgr._cond.notify_all()

    def _handle_fetch(self, recipe: ContextRecipe,
                      plan: Optional[TransferPlan]):
        mgr = self._mgr
        if not self.alive:
            mgr._flow_done(plan, failed=True)
            return           # preempted with the fetch still queued: the
            # scheduler already forgot this worker — don't burn a build
        key = recipe.key()
        failed = False
        try:
            self.library.ensure(recipe)
        except BaseException:
            traceback.print_exc(file=sys.stderr)
            failed = True
        with mgr._cond:
            # no bandwidth calibration here: the ladder fallback may have
            # run the builder, which says nothing about a transfer rate
            mgr._flow_done_locked(plan, failed=failed)
            self._drain_stage_obs_locked()
            if not self.alive:
                return
            # a failed build reports a non-matching key: the scheduler
            # clears the fetching state without recording residency
            acts = mgr.scheduler.on_fetch_done(
                self.worker_id, "<build-failed>" if failed else key, mgr.now)
            mgr._dispatch(acts)
            mgr._cond.notify_all()

    def _handle_donate(self, recipe: ContextRecipe, receiver_id: str,
                       plan: Optional[TransferPlan]):
        """Donor side of a PEER transfer: export a template snapshot of
        the warm context (non-destructive — this worker keeps serving from
        its own copy) and ship it to the receiver's mailbox. A donor that
        lost the context (race with eviction/preemption) or whose export
        fails degrades the receiver to the normal fetch ladder."""
        mgr = self._mgr
        key = recipe.key()
        snap = None
        if self.alive and self.library.has(key):
            try:
                snap = export_context(self.library.context(key))
                self.library.peer_exports += 1
            except BaseException:
                traceback.print_exc(file=sys.stderr)
        mgr._deliver_install(receiver_id, recipe, snap, plan,
                             degraded_from=None if snap is not None
                             else FetchSource.PEER)

    def _export_budget(self) -> Optional[int]:
        """Chunks this donor may export in ONE mailbox turn, tied to its
        queue depth: an idle donor drains its lane in one go (None = no
        cap); a donor with queued serving work exports fewer chunks per
        turn the deeper its mailbox, so decode latency under fanout stays
        bounded by a few chunk host copies."""
        depth = self.mailbox.qsize()
        if depth <= 0:
            return None
        return max(1, self._mgr.export_chunk_budget // (1 + depth))

    def _drain_stage_obs_locked(self):
        """Feed per-stage (disk/h2d) timings observed by this worker's
        streamed restores into the planner's pipeline calibration (callers
        hold the manager lock)."""
        obs, self.library.stage_observations = \
            self.library.stage_observations, []
        for stage, nbytes, seconds in obs:
            self._mgr.planner.observe_stage(stage, nbytes, seconds)

    def _handle_donate_chunks(self, stripe_id: int, recipe: ContextRecipe,
                              receiver_id: str, spec: dict):
        """Donor lane of a STREAMED peer transfer: recompute the
        deterministic ChunkPlan over this context's device half (plans
        depend on template shapes alone, so every donor and the manager
        agree with zero coordination), export up to a budget of chunks
        this turn — each a per-chunk host copy + sha256 — then repost
        the continuation to our own mailbox TAIL so serving work queued
        behind this message runs between export turns. The primary lane
        additionally ships the template metadata (structural clone sharing
        our built kernels + synthesized host halves) before its first
        chunk."""
        mgr = self._mgr
        key = recipe.key()
        lane = spec["lane"]                      # assignment lane
        via = spec.get("via_lane", lane)         # physical lane doing work
        with mgr._lock:
            sf = mgr._stripes.get(stripe_id)
        if sf is None or sf.done:
            return                               # stripe already concluded
        if not (self.alive and self.library.has(key)):
            mgr._stripe_lane_lost(stripe_id, via)
            return
        t0 = time.monotonic()
        sent = 0
        try:
            ctx = self.library.context(key)
            device = stripe_export_state(ctx)
            plan = ChunkPlan(device, chunk_bytes=mgr.chunk_bytes)
            if spec.get("with_template"):
                clone, host_halves, host_nbytes = stripe_export_template(ctx)
                self.library.peer_exports += 1
                mgr._stripe_template(stripe_id, plan, clone, host_halves,
                                     host_nbytes + plan.total_bytes,
                                     ctx.build_seconds, ctx.aot_seconds)
                spec = dict(spec, with_template=False)
            if spec.get("ref_ids") is not None:
                refs = [r for r in plan.refs if r.id in spec["ref_ids"]]
            else:
                refs = assign_lanes(plan.refs, spec["n_donor"],
                                    spec["n_pool"])[lane]
            cursor = spec.get("cursor", 0)
            budget = self._export_budget()
            stop = len(refs) if budget is None \
                else min(len(refs), cursor + budget)
            flat = ChunkPlan.flat_map(device)
            while cursor < stop:
                ref = refs[cursor]
                # the host copy of the device slice is the only point
                # this turn touches the device
                piece = host_chunk(plan.extract(flat, ref))
                sent += int(piece.nbytes)
                if not mgr._stripe_deliver(stripe_id, ref, piece,
                                           chunk_digest(piece), via):
                    return               # lane failed or stripe concluded
                cursor += 1
        except BaseException:
            traceback.print_exc(file=sys.stderr)
            mgr._stripe_lane_lost(stripe_id, via)
            return
        finally:
            elapsed = time.monotonic() - t0
            sf.buffer.add_lane_seconds(via, elapsed)
            if sent:
                with mgr._lock:
                    mgr.planner.observe_stage("d2h", sent, elapsed)
        if cursor < len(refs):
            self.post(("donate_chunks", stripe_id, recipe, receiver_id,
                       dict(spec, cursor=cursor)))
        # else: lane drained — the install fires from the last delivery

    def _handle_stripe_pool(self, stripe_id: int, recipe: ContextRecipe,
                            spec: dict):
        """Receiver-side pool lane of a striped fetch: serve the immutable
        ``params`` chunks straight out of the node SnapshotPool — HOST_RAM
        slices, or per-entry verified reads of a spilled snapshot — while
        donor lanes carry the rest. Activated only after the template
        lands (the plan must exist). Any failure loses this lane only: its
        refs reassign to a surviving donor lane."""
        mgr = self._mgr
        lane = spec["lane"]
        with mgr._lock:
            sf = mgr._stripes.get(stripe_id)
        if sf is None or sf.done:
            return
        if not self.alive:
            mgr._stripe_lane_lost(stripe_id, lane)
            return
        t0 = time.monotonic()
        try:
            plan = sf.buffer.plan
            refs = sf.buffer.missing_refs(
                assign_lanes(plan.refs, spec["n_donor"],
                             spec["n_pool"])[lane])
            if not refs:
                return
            snap = mgr.snapshots.peek(recipe.key())
            if snap is None:
                raise LookupError(
                    f"pool snapshot for {recipe.key()} gone before the "
                    "stripe lane could read it")
            if snap.spilled:
                needed = {r.key for r in refs}
                flat = dict(mgr.snapshots.spill_store().iter_entries(
                    snap.spill_key, keys=needed))
            else:
                flat = ChunkPlan.flat_map(
                    {name: {"params": comp["params"]}
                     for name, comp in snap.host_state.items()
                     if isinstance(comp, dict) and "params" in comp})
            mgr.snapshots.stripe_reads += len(refs)
            for ref in refs:
                piece = host_chunk(plan.extract(flat, ref))
                if not mgr._stripe_deliver(stripe_id, ref, piece,
                                           chunk_digest(piece), lane):
                    return
        except BaseException:
            traceback.print_exc(file=sys.stderr)
            mgr._stripe_lane_lost(stripe_id, lane)
        finally:
            sf.buffer.add_lane_seconds(lane, time.monotonic() - t0)

    def _handle_install_stripe(self, stripe_id: int):
        """Receiver end of a striped transfer: assemble the verified
        chunks into a template snapshot and promote it (adopt — zero
        builder calls, zero builds, exactly like the monolithic PEER
        install)."""
        mgr = self._mgr
        with mgr._lock:
            sf = mgr._stripes.get(stripe_id)
        if sf is None:
            return
        if not self.alive:
            mgr._stripe_failed(stripe_id)
            return
        key = sf.recipe.key()
        failed = False
        measured = None
        try:
            buf = sf.buffer
            host_state = buf.assemble()
            snap = ContextSnapshot(
                recipe=sf.recipe, value=buf.clone, host_state=host_state,
                nbytes=buf.nbytes, build_seconds=buf.build_seconds,
                aot_seconds=buf.aot_seconds,
                demote_seconds=buf.export_seconds)
            ctx = restore_context(snap, self.worker_id)
            self.library.adopt(ctx)
            # same calibration contract as the monolithic install: export
            # work (slowest lane) + restore work, never queue wait
            measured = snap.demote_seconds + ctx.restore_seconds
        except BaseException:
            traceback.print_exc(file=sys.stderr)
            failed = True
            measured = None
        with mgr._cond:
            mgr._stripes.pop(stripe_id, None)
            sf.done = True
            mgr._flow_done_locked(sf.plan, measured_seconds=measured,
                                  failed=failed)
            self._drain_stage_obs_locked()
            if not self.alive:
                return
            acts = mgr.scheduler.on_fetch_done(
                self.worker_id, "<transfer-failed>" if failed else key,
                mgr.now)
            mgr._dispatch(acts)
            mgr._cond.notify_all()

    def _handle_install(self, recipe: ContextRecipe, snap,
                        plan: Optional[TransferPlan],
                        degraded_from: Optional[FetchSource] = None):
        """Receiver side of a PEER transfer: promote the donated snapshot
        to the device and adopt it (zero builder calls, zero builds).
        ``snap=None`` means the donor could not serve — fall back down the
        ladder (pool -> disk -> builder) via ``Library.ensure``, recorded
        in the scheduler's fetch_log as a degrade from ``degraded_from``
        when set."""
        mgr = self._mgr
        if not self.alive:
            mgr._flow_done(plan, failed=True)
            return
        key = recipe.key()
        failed = False
        measured = None
        try:
            if snap is not None:
                ctx = restore_context(snap, self.worker_id)
                self.library.adopt(ctx)
                # calibrate on the transfer WORK (donor export + receiver
                # restore), not end-to-end latency: mailbox queue wait —
                # or a builder run on a degraded donation — is not
                # bandwidth
                measured = snap.demote_seconds + ctx.restore_seconds
            else:
                self.library.ensure(recipe)
        except BaseException:
            traceback.print_exc(file=sys.stderr)
            failed = True
            measured = None
        with mgr._cond:
            mgr._flow_done_locked(plan, measured_seconds=measured,
                                  failed=failed)
            self._drain_stage_obs_locked()
            if not self.alive:
                return
            if snap is None and not failed and degraded_from is not None:
                # the ladder fallback actually acquired the context — log
                # where it landed so fetch_history stays a complete account
                mgr.scheduler.record_degrade(
                    self.worker_id, key, self.library.fetch_sources[-1],
                    mgr.now, degraded_from=degraded_from)
            acts = mgr.scheduler.on_fetch_done(
                self.worker_id, "<transfer-failed>" if failed else key,
                mgr.now)
            mgr._dispatch(acts)
            mgr._cond.notify_all()

    def _handle_warm(self, recipe: ContextRecipe, event: threading.Event,
                     errors: List[BaseException]):
        mgr = self._mgr
        try:
            self.library.ensure(recipe)
            with mgr._lock:
                if self.alive:
                    self.store.admit_recipe(recipe, mgr.mode.persist_tier,
                                            now=mgr.now)
        except BaseException as e:       # surfaced by warm_up in the caller
            errors.append(e)
        finally:
            event.set()

    def _handle_demote(self, key: str, tier: Tier, event: threading.Event,
                       demoted: List[str]):
        mgr = self._mgr
        try:
            snap = self.library.demote(key)   # None when absent or pinned
            if snap is not None and tier == Tier.LOCAL_DISK:
                mgr.snapshots.spill(key)
            with mgr._lock:
                if snap is not None:
                    demoted.append(self.worker_id)
                    self.store.drop(key, down_to=tier)
                    try:
                        self.store.admit(key, tier, snap.nbytes,
                                         now=mgr.now)
                    except TierFullError:
                        # bookkeeping refused (pin-blocked tier); the
                        # snapshot is in the pool regardless — the worker
                        # just shows as cold to the placement ladder.
                        # Other ValueErrors are admission bugs: propagate.
                        pass
        finally:
            event.set()


class PCMManager:
    concurrent = True        # work progresses on threads, not via step()

    def __init__(self, mode: ContextMode = ContextMode.FULL,
                 n_workers: int = 2,
                 planner: Optional[TransferPlanner] = None,
                 snapshots: Optional[SnapshotPool] = None,
                 spill_dir: Optional[str] = None,
                 p2p: bool = True,
                 donor_wait: bool = True,
                 streamed: bool = True,
                 stripe_width: Optional[int] = None,
                 export_chunk_budget: int = 4,
                 chunk_bytes: int = 64 << 20):
        self.mode = mode
        # streamed=True (default): PEER fetches stripe verified chunks
        # across multiple donors with non-blocking budgeted donor exports,
        # and DISK promotions stream spill entries to device; False keeps
        # the monolithic export/restore path (the measured baseline)
        self.streamed = streamed
        self.export_chunk_budget = int(export_chunk_budget)
        self.chunk_bytes = int(chunk_bytes)
        self.planner = planner or TransferPlanner()
        sched_kwargs = {} if stripe_width is None \
            else {"stripe_width": stripe_width}
        self.scheduler = ContextAwareScheduler(mode=mode, planner=self.planner,
                                               p2p=p2p, donor_wait=donor_wait,
                                               **sched_kwargs)
        self.snapshots = snapshots or SnapshotPool(spill_dir=spill_dir,
                                                   chunk_bytes=chunk_bytes)
        # the POOL/DISK rungs of the scheduler's FetchSource ladder read
        # node-pool residency straight from the live SnapshotPool
        self.scheduler.pool_tier = self.snapshots.tier
        # when a pooled snapshot is consumed (restored elsewhere) or lost
        # (capacity), the HOST_RAM residency other workers recorded for it
        # is a phantom — invalidate it so the placement ladder stays honest
        self.snapshots.set_on_gone(self._on_snapshot_gone)
        self.workers: Dict[str, LiveWorker] = {}
        self._futures: Dict[str, Future] = {}
        self._ids = itertools.count()
        self._task_ids = itertools.count()
        # in-flight striped PEER transfers, by stripe id
        self._stripes: Dict[int, _StripeFetch] = {}
        self._stripe_ids = itertools.count()
        self._stripe_stats = {"stripes": 0, "chunks": 0,
                              "lane_failures": 0, "degrades": 0}
        # test hook: callable(stripe_id, ref, lane) -> bool; True corrupts
        # that chunk's digest in transit (exercises the degrade paths)
        self._chunk_fault = None
        self._pinned: set = set()
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._t0 = time.monotonic()
        # counters of departed workers (preempted/stopped), folded into
        # stats() so churn doesn't erase history
        self._retired = {"cold": 0, "warm": 0, "build_seconds": 0.0,
                         "restore_seconds": 0.0, "builder_calls": 0,
                         "restores": 0, "demotions": 0,
                         "peer_installs": 0, "peer_exports": 0,
                         "peer_install_seconds": 0.0}
        # every worker ever spawned (incl. preempted ones): shutdown joins
        # them all so no thread is mid-kernel at interpreter teardown
        self._spawned: List[LiveWorker] = []
        atexit.register(_shutdown_at_exit, weakref.ref(self))
        for _ in range(n_workers):
            self.add_worker()

    # ------------------------------------------------------------- clock ----
    @property
    def now(self) -> float:
        """THE clock for scheduler events on this backend: monotonic
        seconds since the manager started (the simulator backend's ``now``
        is its modeled event-loop time — same contract)."""
        return time.monotonic() - self._t0

    # ------------------------------------------------------------- pool ----
    def add_worker(self, worker_id: Optional[str] = None,
                   profile=None) -> str:
        """Spawn one worker actor. ``worker_id``/``profile`` let a
        WorkerFactory-driven elastic pool attach the trace's worker
        identity and DeviceProfile (heterogeneous HBM capacity + profile-
        aware placement); both default to manager-generated/anonymous."""
        with self._cond:
            wid = worker_id or f"live{next(self._ids):03d}"
            if wid in self.workers:
                raise ValueError(f"worker {wid!r} already exists")
            w = LiveWorker(wid, self, profile=profile)
            w.store.pinned.update(self._pinned)
            w.library.pinned.update(self._pinned)
            self.workers[wid] = w
            self._spawned.append(w)
            w.start()
            acts = self.scheduler.on_worker_join(wid, self.now,
                                                 profile=profile,
                                                 store=w.store)
            self._dispatch(acts)
            self._cond.notify_all()
            return wid

    def preempt_worker(self, worker_id: str):
        """No-warning device reclaim. The scheduler requeues the worker's
        in-flight task immediately; the worker thread finishes whatever
        invocation it cannot abandon, discards the result, then retires —
        demoting every device-resident context (pins included: they cannot
        survive losing the device) into the node snapshot pool, where a
        rejoining worker restores it at transfer cost."""
        with self._cond:
            w = self.workers.pop(worker_id, None)
            if w is not None:
                w.alive = False
            acts = self.scheduler.on_worker_leave(worker_id, self.now)
            self._fail_unresolved()
            self._dispatch(acts)
            self._cond.notify_all()
        if w is not None:
            w.post((_RETIRE,))

    # --------------------------------------------------------- multi-host --
    def listen(self, host: str = "127.0.0.1", port: int = 0,
               heartbeat: float = 1.0,
               lost_after: float = 10.0) -> Tuple[str, int]:
        """Workers that are processes on other nodes (the reference's
        socket transport, ``RemoteWorker`` and the wire-blob install)
        arrive with the port slice of ``core/wire.py``,
        ``core/transport.py`` and ``cluster/node.py``; this runtime's
        workers are threads of this process."""
        raise NotImplementedError(
            "remote workers arrive with the port slice for core/wire.py, "
            "core/transport.py and cluster/node.py; this runtime runs "
            "in-process workers only")

    def shutdown(self, timeout: Optional[float] = None):
        """Stop all worker threads and join every thread this manager ever
        spawned — including retired (preempted) ones that may still be
        finishing a demotion or a kernel build. Joins indefinitely by
        default: every runtime-internal message terminates (a build just
        takes seconds), and a thread left alive inside a CUDA call at
        interpreter exit can abort the process at teardown. Pass a
        ``timeout`` to bound the join when user task functions may block.
        Idempotent; also runs via atexit."""
        with self._cond:
            live, self.workers = list(self.workers.values()), {}
            spawned, self._spawned = list(self._spawned), []
            for w in live:
                w.alive = False
            # nothing will run the remaining work: fail its futures now so
            # waiters error immediately instead of sleeping out a deadline
            for fut in self._futures.values():
                if not fut.done:
                    fut.set_exception(RuntimeError(
                        f"backend shut down with task {fut.task_id} "
                        "unresolved"))
            self._cond.notify_all()
        for w in live:
            w.post((_STOP,))
        for w in spawned:
            w.join(timeout)

    # ------------------------------------------------------------ submit ---
    def submit(self, fn: Callable, args: tuple = (), kwargs: dict = None,
               recipe: Optional[ContextRecipe] = None,
               recipes: Optional[Mapping[str, ContextRecipe]] = None,
               n_items: int = 1, priority: int = 0) -> Future:
        """Submit one task. ``recipe=None`` (and no ``recipes``) is an
        explicitly contextless task — the scheduler treats it as warm on
        every worker. ``recipes`` maps context names to recipes for
        multi-context tasks."""
        named: Dict[str, ContextRecipe] = dict(recipes or {})
        if recipe is not None and not named:
            named = {recipe.name: recipe}
        with self._cond:
            task_id = f"t{next(self._task_ids):05d}"
            task = Task(task_id=task_id, recipes=tuple(named.values()),
                        context_names=tuple(named.keys()), n_items=n_items,
                        priority=priority, payload=(fn, args, kwargs or {}))
            fut = Future(task_id, self)
            self._futures[task_id] = fut
            acts = self.scheduler.submit(task, self.now)
            self._dispatch(acts)
            return fut

    # ----------------------------------------------------------- contexts --
    def warm_up(self, recipe: ContextRecipe,
                worker_ids: Optional[List[str]] = None) -> List[str]:
        """Materialize ``recipe`` on the given (default: all) workers now,
        off the task critical path. Synchronous: returns once every worker
        has the context resident; a failing builder re-raises here."""
        pending: List[tuple] = []
        errors: List[BaseException] = []
        with self._lock:
            for wid in list(worker_ids or self.workers):
                w = self.workers.get(wid)
                if w is None or not w.alive:
                    continue
                ev = threading.Event()
                w.post(("warm", recipe, ev, errors))
                pending.append((wid, ev))
        for _, ev in pending:
            ev.wait()
        if errors:
            raise errors[0]
        return [wid for wid, _ in pending]

    def demote_context(self, recipe: ContextRecipe,
                       tier: Tier = Tier.HOST_RAM,
                       worker_ids: Optional[List[str]] = None) -> List[str]:
        """Physically demote the context off the device on the given
        (default: all) workers: DEVICE -> HOST_RAM snapshot in the node
        pool, spilled on to LOCAL_DISK when ``tier=Tier.LOCAL_DISK``.
        Synchronous; returns the workers that held (and demoted) it."""
        if tier not in (Tier.HOST_RAM, Tier.LOCAL_DISK):
            raise ValueError(f"demotion target must be HOST_RAM or "
                             f"LOCAL_DISK, got {tier!r}")
        key = recipe.key()
        pending: List[threading.Event] = []
        demoted: List[str] = []
        with self._lock:
            for wid in list(worker_ids or self.workers):
                w = self.workers.get(wid)
                if w is None or not w.alive or not w.library.has(key):
                    continue
                ev = threading.Event()
                w.post(("demote", key, tier, ev, demoted))
                pending.append(ev)
        for ev in pending:
            ev.wait()
        return demoted   # pinned contexts refuse demotion and are omitted

    def pin_context(self, recipe: ContextRecipe):
        """Exempt the context from mode-driven eviction on every current
        and future worker."""
        with self._lock:
            key = recipe.key()
            self._pinned.add(key)
            for w in self.workers.values():
                w.store.pin(key)
                w.library.pin(key)

    def release_context(self, recipe: ContextRecipe):
        with self._lock:
            key = recipe.key()
            self._pinned.discard(key)
            for w in self.workers.values():
                w.store.unpin(key)
                w.library.unpin(key)

    def residency(self, recipe: ContextRecipe) -> Dict[str, Tier]:
        """Highest tier at which each worker currently holds the context."""
        with self._lock:
            key = recipe.key()
            return {wid: w.store.highest_tier(key)
                    for wid, w in self.workers.items()}

    def snapshot_tier(self, recipe: ContextRecipe) -> Optional[Tier]:
        """Tier of the node-pool snapshot for this context (HOST_RAM or
        LOCAL_DISK), or None when no demoted copy exists."""
        t = self.snapshots.tier(recipe.key())
        return None if t is None else Tier(t)

    def fetch_history(self, recipe: Optional[ContextRecipe] = None) -> List:
        """FetchSource-ladder decisions made so far (optionally filtered
        to one recipe) — (worker, key, source, donor, t) records from the
        scheduler's ``fetch_log``."""
        with self._lock:
            return self.scheduler.fetch_history(recipe)

    def _on_snapshot_gone(self, key: str):
        """Pool callback (fired outside the pool lock): the snapshot for
        ``key`` no longer exists, so HOST_RAM/LOCAL_DISK residency claims
        by workers that do not actually hold the materialized context are
        phantoms — clear them or the placement ladder keeps routing tasks
        to a worker that would cold-rebuild."""
        with self._lock:
            for w in self.workers.values():
                if not w.library.has(key):
                    w.store.invalidate(key, Tier.HOST_RAM)
                    w.store.invalidate(key, Tier.LOCAL_DISK)

    # --------------------------------------------------------- execution ---
    def _dispatch(self, actions: List[Action]):
        """Route scheduler actions to worker mailboxes (callers hold the
        lock). A PEER fetch goes to the DONOR first (("donate", ...) —
        export then ship to the receiver); every other fetch source runs
        on the receiver's own thread down the Library ladder. ``cancel``
        needs no message: the revalidation barrier in ``_handle_start``
        discards any stale in-flight copy."""
        for a in actions:
            w = self.workers.get(a.worker_id)
            if w is None or not w.alive:
                if a.kind == "start":
                    acts = self.scheduler.on_worker_leave(a.worker_id,
                                                          self.now)
                    self._fail_unresolved()
                    self._dispatch(acts)
                elif a.kind == "fetch":
                    self._flow_done_locked(a.plan)
                continue
            if a.kind == "start":
                w.post(("start", a.task_id))
            elif a.kind == "fetch":
                if a.source == FetchSource.PEER and a.donor:
                    lanes = []
                    for did in (a.donors or (a.donor,)):
                        dw = self.workers.get(did)
                        if dw is not None and dw.alive and did not in lanes:
                            lanes.append(did)
                    if lanes and self.streamed:
                        self._start_stripe(a, lanes)
                        continue
                    if lanes:
                        self.workers[lanes[0]].post(
                            ("donate", a.recipe, a.worker_id, a.plan))
                        continue
                w.post(("fetch", a.recipe, a.plan))

    # ---------------------------------------------------------- striping ---
    def _start_stripe(self, a: Action, lanes: List[str]):
        """Launch a striped PEER fetch (callers hold the lock): one
        ``donate_chunks`` lane per live donor from the planner's committed
        stripe set, plus — once the template lands — a receiver-side pool
        lane for the immutable params when the node pool holds a copy."""
        sid = next(self._stripe_ids)
        n_pool = 1 if self.snapshots.tier(a.recipe.key()) is not None else 0
        sf = _StripeFetch(sid, a.recipe, a.worker_id, a.plan,
                          tuple(lanes), n_pool)
        self._stripes[sid] = sf
        self._stripe_stats["stripes"] += 1
        for lane, did in enumerate(lanes):
            self.workers[did].post(
                ("donate_chunks", sid, a.recipe, a.worker_id,
                 {"lane": lane, "n_donor": len(lanes), "n_pool": n_pool,
                  "with_template": lane == 0, "ref_ids": None,
                  "cursor": 0}))

    def _stripe_template(self, stripe_id: int, plan, clone, host_halves,
                         nbytes: int, build_seconds: float,
                         aot_seconds: float):
        """Primary-lane template metadata arrived: arm the buffer's
        expected-ref set and activate the pool lane (it needs the plan)."""
        with self._cond:
            sf = self._stripes.get(stripe_id)
            if sf is None or sf.done:
                return
            sf.buffer.set_template(plan, clone, host_halves, nbytes,
                                   build_seconds, aot_seconds)
            if sf.n_pool:
                pool_lane = len(sf.donor_ids)
                sf.lane_owner[pool_lane] = pool_lane
                w = self.workers.get(sf.receiver_id)
                if w is not None and w.alive:
                    w.post(("stripe_pool", stripe_id, sf.recipe,
                            {"lane": pool_lane,
                             "n_donor": len(sf.donor_ids),
                             "n_pool": sf.n_pool}))
        self._maybe_install_stripe(stripe_id)

    def _stripe_deliver(self, stripe_id: int, ref, piece, sha: str,
                        lane: int) -> bool:
        """Verify-and-buffer one chunk from a lane thread. Returns False
        when the lane should stop exporting (corruption failed the lane,
        or the stripe concluded elsewhere)."""
        with self._lock:
            sf = self._stripes.get(stripe_id)
            fault = self._chunk_fault
        if sf is None or sf.done:
            return False
        if fault is not None and fault(stripe_id, ref, lane):
            sha = "0" * 64              # test hook: corrupt in transit
        try:
            sf.buffer.deliver(ref, piece, sha, lane=lane)
        except ChunkCorruptionError:
            traceback.print_exc(file=sys.stderr)
            with self._lock:
                self._stripe_stats["lane_failures"] += 1
            self._stripe_lane_lost(stripe_id, lane)
            return False
        with self._lock:
            self._stripe_stats["chunks"] += 1
        self._maybe_install_stripe(stripe_id)
        return True

    def _maybe_install_stripe(self, stripe_id: int):
        with self._cond:
            sf = self._stripes.get(stripe_id)
            if sf is None or sf.done or sf.buffer.install_posted \
                    or not sf.buffer.complete():
                return
            sf.buffer.install_posted = True
            w = self.workers.get(sf.receiver_id)
            if w is None or not w.alive:
                self._stripe_failed_locked(stripe_id)
                return
            w.post(("install_stripe", stripe_id))

    def _stripe_lane_lost(self, stripe_id: int, phys_lane: int):
        """A physical stripe lane died — corrupt chunk, donor preempted or
        evicted, pool snapshot consumed. Reassign every assignment lane it
        owned to a surviving donor lane (only the UNDELIVERED refs are
        re-exported; the fetch never restarts), or — with no survivors —
        degrade the receiver down the normal fetch ladder."""
        with self._cond:
            sf = self._stripes.get(stripe_id)
            if sf is None or sf.done or phys_lane in sf.failed_lanes:
                return
            sf.failed_lanes.add(phys_lane)
            lost = [al for al, owner in sf.lane_owner.items()
                    if owner == phys_lane]
            if not lost:
                return
            n_donor = len(sf.donor_ids)
            survivors = []
            for lane in range(n_donor):
                if lane in sf.failed_lanes:
                    continue
                dw = self.workers.get(sf.donor_ids[lane])
                if dw is not None and dw.alive:
                    survivors.append(lane)
            plan = sf.buffer.plan
            if survivors:
                sl = survivors[0]
                donor = self.workers[sf.donor_ids[sl]]
                for al in lost:
                    sf.lane_owner[al] = sl
                    spec = {"lane": al, "via_lane": sl, "n_donor": n_donor,
                            "n_pool": sf.n_pool,
                            "with_template": plan is None and al == 0,
                            "ref_ids": None, "cursor": 0}
                    if plan is not None:
                        assigned = assign_lanes(plan.refs, n_donor,
                                                sf.n_pool)[al]
                        spec["ref_ids"] = frozenset(
                            r.id for r in sf.buffer.missing_refs(assigned))
                    donor.post(("donate_chunks", stripe_id, sf.recipe,
                                sf.receiver_id, spec))
                return
            # every donor lane gone: fall down the ladder without
            # restarting — the receiver's Library resolves POOL/DISK/FS/
            # BUILD and the degrade is logged against the PEER promise
            sf.done = True
            self._stripes.pop(stripe_id, None)
            self._stripe_stats["degrades"] += 1
            self._flow_done_locked(sf.plan, failed=True)
            w = self.workers.get(sf.receiver_id)
            if w is not None and w.alive:
                w.post(("install", sf.recipe, None, None,
                        FetchSource.PEER))
            self._cond.notify_all()

    def _stripe_failed_locked(self, stripe_id: int):
        """The stripe cannot conclude (receiver gone): drop it and free
        its planner flows as failed (callers hold the lock)."""
        sf = self._stripes.pop(stripe_id, None)
        if sf is None:
            return
        sf.done = True
        self._flow_done_locked(sf.plan, failed=True)
        self._cond.notify_all()

    def _stripe_failed(self, stripe_id: int):
        with self._cond:
            self._stripe_failed_locked(stripe_id)

    def _deliver_install(self, receiver_id: str, recipe: ContextRecipe,
                         snap, plan: Optional[TransferPlan],
                         degraded_from: Optional[FetchSource] = None):
        """Hand a donated snapshot (or a None fallback) to the receiving
        worker's mailbox; called from donor threads and drain paths. The
        post happens under the manager lock: preemption flips ``alive``
        and enqueues the retirement under the same lock, so the install
        either lands ahead of the retirement (drained with its flow freed)
        or is rerouted here — never stranded in a dead mailbox."""
        with self._cond:
            w = self.workers.get(receiver_id)
            if w is None or not w.alive:
                # receiver departed mid-transfer: the scheduler already
                # cleaned it up — just free the planner flow
                self._flow_done_locked(plan, failed=True)
                self._cond.notify_all()
                return
            w.post(("install", recipe, snap, plan, degraded_from))

    def _flow_done(self, plan: Optional[TransferPlan],
                   measured_seconds: Optional[float] = None,
                   failed: bool = False):
        with self._lock:
            self._flow_done_locked(plan, measured_seconds, failed=failed)

    def _flow_done_locked(self, plan: Optional[TransferPlan],
                          measured_seconds: Optional[float] = None,
                          failed: bool = False):
        """Report a planned transfer finished: frees the donor/FS slots
        immediately and, when real transfer work was measured (peer
        export + restore), feeds it into the planner's bandwidth
        calibration. Failed transfers are recorded as such — never
        calibrated, never left as phantom in-flight flows (callers hold
        the lock)."""
        if plan is not None:
            self.planner.complete(plan, self.now,
                                  measured_seconds=measured_seconds,
                                  failed=failed)

    def _fail_unresolved(self):
        """Surface scheduler-declared failures (max_attempts exceeded) as
        Future exceptions; callers hold the lock."""
        for task in self.scheduler.failed:
            fut = self._futures.get(task.duplicates_of or task.task_id)
            if fut is not None and not fut.done:
                fut.set_exception(RuntimeError(fut._lost_message()))

    def wait(self, fut: Future, timeout: Optional[float] = None):
        """Block until ``fut`` resolves. Purely event-driven: futures are
        resolved (and workers joined/preempted) under ``self._cond`` with
        a ``notify_all``, so this waits on that condition and re-checks
        only when the runtime actually changed. Raises TimeoutError on
        deadline; RuntimeError when the future can no longer resolve
        (pool drained, or stalled with no live workers and no timeout)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not fut.done:
                if self.outstanding == 0:
                    raise RuntimeError(fut._lost_message())
                if not self.workers and deadline is None:
                    raise RuntimeError(
                        f"backend stalled with {self.outstanding} task(s) "
                        f"outstanding and no live workers while waiting on "
                        f"{fut.task_id} — add workers or pass "
                        "result(timeout=...)")
                if deadline is None:
                    self._cond.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"task {fut.task_id} did not complete within "
                            f"{timeout:.3f}s ({self.outstanding} tasks "
                            "still outstanding)")
                    self._cond.wait(remaining)

    def step(self) -> bool:
        """Protocol compatibility for pollers: the concurrent runtime makes
        progress on worker threads, so ``step`` just waits briefly for
        activity. False once nothing is outstanding."""
        with self._cond:
            if self.outstanding == 0:
                return False
            self._cond.wait(0.01)
            return True

    def run_until_idle(self, timeout: Optional[float] = None) -> int:
        """Block until no tasks are queued or running (or the pool has no
        live workers to run them). Returns completions observed while
        draining."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            start = len(self.scheduler.completions)
            while self.outstanding and self.workers:
                if deadline is not None and time.monotonic() >= deadline:
                    break
                self._cond.wait(0.05)
            return len(self.scheduler.completions) - start

    # ------------------------------------------------------------- status ---
    @property
    def outstanding(self) -> int:
        return self.scheduler.outstanding

    def lookup_task(self, task_id: str) -> Optional[Task]:
        return self.scheduler.tasks.get(task_id)

    def _absorb_library(self, library: Library):
        """Fold a departing worker's Library counters into the manager
        totals (called from the worker thread at retirement/stop)."""
        with self._lock:
            r = self._retired
            for rec in library.records:
                r["cold" if rec.cold else "warm"] += 1
            r["build_seconds"] += library.build_seconds_total
            r["restore_seconds"] += library.restore_seconds_total
            r["builder_calls"] += library.builder_calls
            r["restores"] += library.restores
            r["demotions"] += library.demotions
            r["peer_installs"] += library.peer_installs
            r["peer_exports"] += library.peer_exports
            r["peer_install_seconds"] += library.peer_install_seconds

    # ------------------------------------------------------------- stats ---
    def stats(self) -> Dict:
        with self._lock:
            cold, warm = self._retired["cold"], self._retired["warm"]
            build_s = self._retired["build_seconds"]
            restore_s = self._retired["restore_seconds"]
            builder_calls = self._retired["builder_calls"]
            restores = self._retired["restores"]
            demotions = self._retired["demotions"]
            peer_installs = self._retired["peer_installs"]
            peer_exports = self._retired["peer_exports"]
            peer_install_s = self._retired["peer_install_seconds"]
            for w in self.workers.values():
                for rec in w.library.records:
                    cold += rec.cold
                    warm += not rec.cold
                build_s += w.library.build_seconds_total
                restore_s += w.library.restore_seconds_total
                builder_calls += w.library.builder_calls
                restores += w.library.restores
                demotions += w.library.demotions
                peer_installs += w.library.peer_installs
                peer_exports += w.library.peer_exports
                peer_install_s += w.library.peer_install_seconds
            return {"cold_invocations": cold, "warm_invocations": warm,
                    "context_build_seconds": build_s,
                    "context_restore_seconds": restore_s,
                    "builder_calls": builder_calls,
                    "context_restores": restores,
                    "context_demotions": demotions,
                    "peer_installs": peer_installs,
                    "peer_exports": peer_exports,
                    "peer_install_seconds": peer_install_s,
                    "completed": len(self.scheduler.completions),
                    "snapshot_pool": self.snapshots.stats(),
                    "striping": dict(self._stripe_stats),
                    "transfer": self.planner.stats(self.now)}
