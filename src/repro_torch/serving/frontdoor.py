"""The streaming session front door: admission, fairness, routing, pumps.

This is the million-user-facing layer over the elastic PCM pool. It turns
the bulk task API into an open-loop serving system:

  Session.submit(prompt)
      -> AdmissionController       per-tenant token bucket + bounded queue
         (explicit ShedError backpressure; DRR fairness across tenants;
         INTERACTIVE turns claimed ahead of BATCH)
      -> SessionRouter             sticky (context, lane) -> serving pump
      -> backend.submit(pump)      the ContextAwareScheduler places the
         pump with its warm-affinity + PEER/POOL/DISK/FS/BUILD cost ladder
      -> InferenceEngine           continuous batching; per-token
         callbacks feed each turn's TokenStream

**The serving pump** is the bridge between the task-oriented runtime and
long-lived streams: one PCM task per (context, lane) that loads the
context's engine, then loops — claim admitted turns, feed them to the
continuously-batched engine, stream tokens out — and exits when the lane
goes idle (the idle-exit handshake with the front door is atomic, so a
turn admitted at the same instant either keeps the pump alive or respawns
it). This is the sticky invocation stream StickyInvoc argues for: the
scheduler sees one long task, the session sees a persistent server.

**Preemption mid-stream.** When a worker running a pump is preempted, two
things happen: the worker's actor thread finishes its current pump run as
a zombie (its claimed turns stream to completion — claims are atomic and
token delivery dedups by index), and the scheduler requeues the pump
task, re-acquiring the context on a surviving worker through the cost
ladder (PEER/POOL/DISK restore: zero builder calls, zero kernel builds).
New turns flow to the new worker; the session never sees the move except
as latency.

**Simulator parity.** On a ``SimulatorBackend`` the identical admission /
fairness / shed logic runs (same code, same decisions); each claimed turn
becomes one modeled task in claim order with the same scheduler priority,
so live-vs-sim decision parity extends to routing (``fetch_history`` on
the session's context speaks the same FetchSource vocabulary) and sheds
are bit-identical. Modeled streams deliver a single synthetic token at
the modeled completion time — the simulator models arrival/placement/
timing, never token values.

Port of ``repro.serving.frontdoor``: the same admission arithmetic, claim
order, lanes and error texts. The pump drives this package's
``InferenceEngine``, whose tokens reach a stream in one block after each
megastep's single host sync (no per-token device read), so a turn's
time to first token includes its prefill wave, as in the reference. Pumps
run on in-process workers only: their arguments carry the front door,
which holds a lock and cannot be pickled for a worker process.
"""

from __future__ import annotations

import functools
import itertools
import math
import threading
import zlib
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.library import load_variable_from_context
from repro_torch.serving.request import Request
from repro_torch.serving.session import (Session, SLOClass, StreamError,
                                   TokenStream, Turn)

_session_ids = itertools.count()


class ShedError(RuntimeError):
    """Explicit admission backpressure: the turn was NOT queued.

    ``reason`` is ``"rate_limit"`` (token bucket empty — retry after
    ``retry_after_seconds``) or ``"queue_full"`` (the tenant's bounded
    queue is at depth — drain before submitting more). Shedding at the
    door is the design: queues stay bounded and the client learns
    immediately, instead of a turn silently aging in an unbounded queue.
    """

    def __init__(self, tenant: str, reason: str,
                 retry_after_seconds: Optional[float] = None):
        self.tenant = tenant
        self.reason = reason
        self.retry_after_seconds = retry_after_seconds
        extra = (f" (retry after {retry_after_seconds:.2f}s)"
                 if retry_after_seconds is not None else "")
        super().__init__(f"tenant {tenant!r} shed: {reason}{extra}")


@dataclass(frozen=True)
class TenantQuota:
    """Per-tenant admission budget.

    ``tokens_per_second`` refills the token bucket (cost of a turn =
    prompt tokens + generation budget); ``burst_tokens`` caps it;
    ``max_queued_turns`` bounds the tenant's admitted-but-unclaimed queue
    depth."""
    tokens_per_second: float = math.inf
    burst_tokens: float = 65536.0
    max_queued_turns: int = 256


class TokenBucket:
    """Classic token bucket on the front door's clock (modeled time on the
    simulator backend, so admission decisions replay identically)."""

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = rate
        self.burst = burst
        self.level = burst
        self.stamp = now

    def _refill(self, now: float):
        if now > self.stamp:
            self.level = min(self.burst,
                             self.level + (now - self.stamp) * self.rate)
            self.stamp = now

    def try_take(self, n: float, now: float) -> bool:
        if self.rate == math.inf:
            return True
        self._refill(now)
        if self.level + 1e-9 >= n:
            self.level -= n
            return True
        return False

    def retry_after(self, n: float, now: float) -> Optional[float]:
        if self.rate == math.inf:
            return 0.0
        self._refill(now)
        if n > self.burst:
            return None          # can never be admitted at this quota
        return max(0.0, (n - self.level) / max(self.rate, 1e-9))


class _TenantState:
    __slots__ = ("bucket", "deficit", "interactive", "batch")

    def __init__(self, quota: TenantQuota, now: float):
        self.bucket = TokenBucket(quota.tokens_per_second,
                                  quota.burst_tokens, now)
        self.deficit = 0.0
        self.interactive: deque = deque()
        self.batch: deque = deque()


Selector = Optional[Tuple[str, int]]        # (ctx_key, lane) or "any"


class AdmissionController:
    """Token-bucket admission + bounded queues + DRR fairness.

    ``admit`` is the backpressure point: it either queues the turn or
    raises :class:`ShedError` — there is no silent drop and no unbounded
    queue. ``claim`` is the fairness point, called by serving pumps (live)
    or the sim dispatcher: INTERACTIVE turns are served first,
    round-robin across tenants; BATCH turns go through deficit round
    robin, so a tenant flooding cheap turns and a tenant submitting
    expensive ones each get ~``drr_quantum`` tokens of service per round
    regardless of turn count. All state is guarded by the front door's
    single lock, passed in — admission, claims and pump lifecycle
    transitions are mutually atomic."""

    def __init__(self, default_quota: Optional[TenantQuota] = None,
                 drr_quantum: float = 256.0,
                 lock: Optional[threading.RLock] = None):
        self.default_quota = default_quota or TenantQuota()
        self.drr_quantum = drr_quantum
        self._lock = lock or threading.RLock()
        self._quotas: Dict[str, TenantQuota] = {}
        self._tenants: Dict[str, _TenantState] = {}
        self._order: List[str] = []         # tenant registration order
        self._rr_idx = 0                    # interactive round-robin cursor
        self._drr_idx = 0                   # batch DRR cursor
        self.admitted = 0
        self.claimed = 0
        self.shed: Dict[str, int] = {}      # reason -> count
        self.shed_by_tenant: Dict[str, int] = {}

    def set_quota(self, tenant: str, quota: TenantQuota):
        with self._lock:
            self._quotas[tenant] = quota
            # a fresh quota resets the bucket, not the queued turns
            if tenant in self._tenants:
                st = self._tenants[tenant]
                st.bucket = TokenBucket(quota.tokens_per_second,
                                        quota.burst_tokens, st.bucket.stamp)

    def quota(self, tenant: str) -> TenantQuota:
        return self._quotas.get(tenant, self.default_quota)

    def _state(self, tenant: str, now: float) -> _TenantState:
        st = self._tenants.get(tenant)
        if st is None:
            st = _TenantState(self.quota(tenant), now)
            self._tenants[tenant] = st
            self._order.append(tenant)
        return st

    # ---------------------------------------------------------- admission --
    def admit(self, turn: Turn, now: float):
        """Queue the turn or raise ShedError — the explicit backpressure
        response. Order of checks: queue depth first (cheaper to retry
        later than to burn bucket tokens on a turn that can't queue)."""
        with self._lock:
            st = self._state(turn.tenant, now)
            q = self.quota(turn.tenant)
            if len(st.interactive) + len(st.batch) >= q.max_queued_turns:
                self._record_shed(turn.tenant, "queue_full")
                raise ShedError(turn.tenant, "queue_full")
            if not st.bucket.try_take(turn.cost, now):
                ra = st.bucket.retry_after(turn.cost, now)
                self._record_shed(turn.tenant, "rate_limit")
                raise ShedError(turn.tenant, "rate_limit",
                                retry_after_seconds=ra)
            turn.admitted_at = now
            (st.interactive if turn.slo is SLOClass.INTERACTIVE
             else st.batch).append(turn)
            self.admitted += 1

    def _record_shed(self, tenant: str, reason: str):
        self.shed[reason] = self.shed.get(reason, 0) + 1
        self.shed_by_tenant[tenant] = self.shed_by_tenant.get(tenant, 0) + 1

    # -------------------------------------------------------------- claims --
    @staticmethod
    def _first_match(dq: deque, sel: Selector) -> Optional[Turn]:
        for t in dq:
            if sel is None or (t.ctx_key, t.lane) == sel:
                return t
        return None

    def claim(self, sel: Selector, now: float) -> Optional[Turn]:
        """Pop the next turn a pump for ``sel`` should serve (None = any).
        INTERACTIVE before BATCH; fairness within each class."""
        with self._lock:
            turn = self._claim_interactive(sel) or self._claim_batch(sel)
            if turn is not None:
                turn.claimed = True
                self.claimed += 1
            return turn

    def _claim_interactive(self, sel: Selector) -> Optional[Turn]:
        n = len(self._order)
        for i in range(n):
            name = self._order[(self._rr_idx + i) % n]
            st = self._tenants[name]
            turn = self._first_match(st.interactive, sel)
            if turn is not None:
                st.interactive.remove(turn)
                self._rr_idx = (self._rr_idx + i + 1) % max(n, 1)
                return turn
        return None

    def _claim_batch(self, sel: Selector) -> Optional[Turn]:
        n = len(self._order)
        if n == 0:
            return None
        # DRR: each visit to a tenant with eligible work grants one
        # quantum of deficit; a turn is served once its cost is covered.
        # Deficits persist across claim calls (reset when a tenant's
        # eligible queue empties), so expensive turns accumulate service
        # credit instead of starving.
        for _ in range(64 * n):
            matched_any = False
            for _ in range(n):
                name = self._order[self._drr_idx % n]
                self._drr_idx += 1
                st = self._tenants[name]
                turn = self._first_match(st.batch, sel)
                if turn is None:
                    st.deficit = 0.0
                    continue
                matched_any = True
                st.deficit += self.drr_quantum
                if turn.cost <= st.deficit:
                    st.deficit -= turn.cost
                    st.batch.remove(turn)
                    return turn
            if not matched_any:
                return None
        # unreachable at sane quanta (cost would need to exceed 64n
        # quanta); serve rather than starve
        for name in self._order:
            turn = self._first_match(self._tenants[name].batch, sel)
            if turn is not None:
                self._tenants[name].batch.remove(turn)
                return turn
        return None

    def cancel_session(self, session_id: str) -> List[Turn]:
        """Withdraw every admitted-but-unclaimed turn of one session from
        the queues (session close / abandon). Claimed turns are untouched
        — they are already in an engine and finish normally. Returns the
        withdrawn turns so the caller can finish their streams; bucket
        tokens are NOT refunded (the admission decision was made)."""
        with self._lock:
            out: List[Turn] = []
            for st in self._tenants.values():
                for dq in (st.interactive, st.batch):
                    mine = [t for t in dq if t.session_id == session_id]
                    for t in mine:
                        dq.remove(t)
                        out.append(t)
            return out

    def pending_for(self, sel: Selector) -> int:
        with self._lock:
            return sum(
                1
                for st in self._tenants.values()
                for dq in (st.interactive, st.batch)
                for t in dq
                if sel is None or (t.ctx_key, t.lane) == sel)

    def pending_interactive(self, sel: Selector) -> int:
        with self._lock:
            return sum(1 for st in self._tenants.values()
                       for t in st.interactive
                       if sel is None or (t.ctx_key, t.lane) == sel)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            total_shed = sum(self.shed.values())
            seen = self.admitted + total_shed
            return {
                "admitted": self.admitted,
                "claimed": self.claimed,
                "shed": dict(self.shed),
                "shed_by_tenant": dict(self.shed_by_tenant),
                "shed_rate": (total_shed / seen) if seen else 0.0,
                "pending": self.pending_for(None),
            }


# ------------------------------------------------------------------- pumps --
def _modeled_turn(turn_id: int):         # pragma: no cover - never executed
    raise RuntimeError("modeled front-door turns run only on the "
                       "SimulatorBackend, which never executes task fns")


def _serve_pump(fd: "FrontDoor", ctx_key: str, lane: int,
                engine_var: str) -> int:
    """The serving pump task body (live backend; runs on a worker actor
    thread with the session context installed).

    Claims admitted turns for its (context, lane), feeds them to the
    continuously-batched engine — at most ``slots`` queued beyond the
    active set, so late-arriving INTERACTIVE turns claim ahead of batch
    work still at the door — and streams every token out through the
    turn's TokenStream. Exits via the idle-exit handshake when the lane
    drains. Safe to run concurrently with a zombie attempt of itself
    after a preemption: claims are atomic and streams dedup by index."""
    eng = load_variable_from_context(engine_var)
    inflight: Dict[int, Turn] = {}       # request_id -> turn
    served = 0
    while True:
        while len(eng.queue) < max(1, eng.slots):
            turn = fd._claim(ctx_key, lane)
            if turn is None:
                break
            stream = turn.stream
            stream.attempts += 1
            req = Request(prompt=list(turn.prompt),
                          max_new_tokens=turn.max_new_tokens,
                          temperature=turn.temperature,
                          stop_tokens=tuple(turn.stop_tokens),
                          priority=turn.slo.priority,
                          on_token=lambda r, tok, i, _s=stream:
                              _s.push(i, tok))
            try:
                eng.submit(req)
            except ValueError as e:      # e.g. prompt exceeds the cache
                stream.finish(error=e)
                continue
            inflight[req.request_id] = turn
        if not eng.has_work():
            if fd._pump_idle_exit(ctx_key, lane):
                return served
            continue                     # a turn arrived during the check
        for r in eng.step():
            turn = inflight.pop(r.request_id, None)
            if turn is not None:
                fd._complete(turn, r)
                served += 1


# -------------------------------------------------------------------- router --
class SessionRouter:
    """sessions -> contexts -> live workers, with sticky lanes.

    The router does NOT pick workers — that stays with the
    ContextAwareScheduler's warm-affinity placement and cost ladder. It
    decides the serving topology above it: each session sticks to one
    ``lane`` of its context (stable hash of the session id), each
    (context, lane) has at most one pump task in flight, and pumps are
    (re)spawned exactly when a lane has pending turns and no pump — the
    scheduler then routes each pump submission like any context-bearing
    task, which is precisely how sessions survive preemption (the requeued
    pump re-fetches the context down the PEER/POOL/DISK/FS/BUILD ladder).
    """

    def __init__(self, frontdoor: "FrontDoor", lanes: int = 1):
        if lanes < 1:
            raise ValueError("lanes must be >= 1")
        self._fd = frontdoor
        self.lanes = lanes
        self._running: Dict[Tuple[str, int], bool] = {}
        self.pumps_submitted = 0
        self.pump_errors = 0

    def lane_for(self, session_id: str,
                 prefix_key: Optional[str] = None) -> int:
        """Sticky: stable across the session's lifetime and across runs
        (crc32, not the salted builtin hash). A declared ``prefix_key``
        REPLACES the session id in the hash: every session sharing a
        prompt template lands on the same lane — hence the same pump,
        engine and page pool — so the template's prefix pages are prefilled
        once and copy-on-write-shared by all of them, instead of being
        re-prefilled per lane."""
        key = prefix_key if prefix_key is not None else session_id
        return zlib.crc32(key.encode()) % self.lanes

    # caller holds the front door lock for all four methods below; the
    # actual backend.submit happens OUTSIDE that lock (see
    # FrontDoor._spawn_pump) — future callbacks fire under runtime locks,
    # so holding the front-door lock across a submit would invert order
    def reserve_pump(self, ctx_key: str, lane: int) -> bool:
        """Atomically mark the lane's pump as running. True = the caller
        must now spawn the pump task; False = one is already in flight."""
        key = (ctx_key, lane)
        if self._running.get(key):
            return False
        self._running[key] = True
        self.pumps_submitted += 1
        return True

    def running(self, ctx_key: str, lane: int) -> bool:
        return bool(self._running.get((ctx_key, lane)))

    def pump_idle_exit(self, ctx_key: str, lane: int,
                       pending: int) -> bool:
        if pending > 0:
            return False
        self._running[(ctx_key, lane)] = False
        return True

    def mark_stopped(self, ctx_key: str, lane: int):
        self._running[(ctx_key, lane)] = False

    def stats(self) -> Dict[str, Any]:
        return {"lanes": self.lanes,
                "pumps_submitted": self.pumps_submitted,
                "pump_errors": self.pump_errors,
                "running": sum(1 for v in self._running.values() if v)}


# ---------------------------------------------------------------- front door --
class FrontDoor:
    """SLO-aware streaming ingress over a PCM execution backend.

    One instance per client/backend. ``open_session`` registers a
    (tenant, SLO, context) session; ``Session.submit`` flows through
    admission (ShedError on backpressure) and is served by a pump on the
    live backend or dispatched as modeled tasks on the simulator — same
    admission and claim-order decisions either way.
    """

    def __init__(self, backend, *, engine_var: str = "engine",
                 default_quota: Optional[TenantQuota] = None,
                 quotas: Optional[Dict[str, TenantQuota]] = None,
                 lanes: int = 1, drr_quantum: float = 256.0):
        # accept a PCMClient for convenience
        backend = getattr(backend, "backend", backend)
        self.backend = backend
        self.engine_var = engine_var
        self._lock = threading.RLock()
        self.admission = AdmissionController(default_quota,
                                             drr_quantum=drr_quantum,
                                             lock=self._lock)
        for tenant, q in (quotas or {}).items():
            self.admission.set_quota(tenant, q)
        self.router = SessionRouter(self, lanes=lanes)
        self._recipes: Dict[str, Any] = {}       # ctx_key -> recipe
        self._sessions: Dict[str, Session] = {}
        self.turns_completed = 0
        self.turns_cancelled = 0
        # page-level prefix sharing, aggregated from completed turns'
        # Requests (live backend only — the simulator models placement and
        # timing, not KV reuse)
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0

    def _now(self) -> float:
        return self.backend.now

    @property
    def concurrent(self) -> bool:
        return bool(getattr(self.backend, "concurrent", False))

    # ------------------------------------------------------------ sessions --
    def open_session(self, context, tenant: str = "default",
                     slo: SLOClass = SLOClass.BATCH,
                     session_id: Optional[str] = None,
                     prefix_key: Optional[str] = None) -> Session:
        """Open a streaming session bound to one context. ``context`` is a
        ContextHandle or ContextRecipe whose built value exposes
        ``engine_var`` (an InferenceEngine). ``prefix_key`` declares the
        session's shared prompt template (any stable string — e.g. a hash
        of the template tokens): sessions sharing it are routed to the
        SAME lane so one engine's page-level prefix cache serves them all
        (see ``SessionRouter.lane_for``)."""
        recipe = getattr(context, "recipe", context)
        if session_id is None:
            session_id = f"{tenant}-s{next(_session_ids)}"
        with self._lock:
            self._recipes.setdefault(recipe.key(), recipe)
            lane = self.router.lane_for(session_id, prefix_key)
            sess = Session(self, session_id, tenant, slo, recipe, lane,
                           prefix_key=prefix_key)
            self._sessions[session_id] = sess
        return sess

    def _session_closed(self, session: Session,
                        cancel_pending: bool = False):
        cancelled: List[Turn] = []
        with self._lock:
            self._sessions.pop(session.session_id, None)
            if cancel_pending:
                cancelled = self.admission.cancel_session(
                    session.session_id)
                self.turns_cancelled += len(cancelled)
        # finish the withdrawn streams outside the lock (consumers may be
        # blocked on them and their wakeup path takes stream locks)
        for turn in cancelled:
            if turn.stream is not None:
                turn.stream.finish(error=StreamError(
                    f"turn {turn.turn_id}: session "
                    f"{session.session_id} closed before the turn was "
                    f"claimed"))

    # --------------------------------------------------------------- turns --
    def submit_turn(self, session: Session, prompt,
                    max_new_tokens: int = 32, temperature: float = 0.0,
                    stop_tokens: Tuple[int, ...] = (1,)) -> TokenStream:
        """Admission -> routing for one turn. Raises ShedError instead of
        queueing when the tenant is over budget."""
        concurrent = self.concurrent
        spawn = False
        with self._lock:
            now = self._now()
            turn = Turn(session_id=session.session_id,
                        tenant=session.tenant, slo=session.slo,
                        ctx_key=session.recipe.key(), lane=session.lane,
                        prompt=list(prompt), max_new_tokens=max_new_tokens,
                        temperature=temperature,
                        stop_tokens=tuple(stop_tokens))
            turn.stream = TokenStream(
                turn.turn_id, clock=self._now,
                driver=None if concurrent else self._drive_sim)
            self.admission.admit(turn, now)      # may raise ShedError
            session.turns.append(turn)
            if concurrent:
                # reserve the lane's pump atomically with admission, so
                # the idle-exit handshake can't lose this turn: either the
                # running pump observes it as pending, or we spawn one
                spawn = self.router.reserve_pump(turn.ctx_key, turn.lane)
        if spawn:
            self._spawn_pump(turn.ctx_key, turn.lane, turn.slo.priority)
        elif not concurrent:
            self._dispatch_sim()
        return turn.stream

    # ------------------------------------------------------ live pump seam --
    def _claim(self, ctx_key: str, lane: int) -> Optional[Turn]:
        return self.admission.claim((ctx_key, lane), self._now())

    def _pump_idle_exit(self, ctx_key: str, lane: int) -> bool:
        with self._lock:
            pending = self.admission.pending_for((ctx_key, lane))
            return self.router.pump_idle_exit(ctx_key, lane, pending)

    def _complete(self, turn: Turn, request: Request):
        turn.stream.finish(request=request)
        with self._lock:
            self.turns_completed += 1
            if request.prefix_tokens:
                self.prefix_hits += 1
                self.prefix_tokens_reused += request.prefix_tokens

    def _spawn_pump(self, ctx_key: str, lane: int, priority: int):
        """Submit the lane's serving pump. Called WITHOUT the front-door
        lock: backend.submit takes runtime locks, and future callbacks
        (which take the front-door lock) fire under those same runtime
        locks — submitting under our lock would be an ABBA inversion."""
        recipe = self._recipes[ctx_key]
        fut = self.backend.submit(
            _serve_pump, (self, ctx_key, lane, self.engine_var),
            recipes={recipe.name: recipe}, n_items=1, priority=priority)
        fut.add_done_callback(
            functools.partial(self._pump_future_done, ctx_key, lane))

    def _pump_future_done(self, ctx_key: str, lane: int, fut):
        """Pump task resolved. Normal exits already cleared the running
        flag via the idle-exit handshake; a pump that died (exception) or
        was discarded must not leave the lane unserved, so respawn when
        matching turns remain and the pool is alive."""
        spawn = False
        with self._lock:
            if fut.error is not None:
                self.router.pump_errors += 1
                self.router.mark_stopped(ctx_key, lane)
            if (not self.router.running(ctx_key, lane)
                    and self.admission.pending_for((ctx_key, lane)) > 0
                    and getattr(self.backend, "workers", True)):
                spawn = self.router.reserve_pump(ctx_key, lane)
        if spawn:
            self._spawn_pump(ctx_key, lane, 0)

    # ------------------------------------------------------------ sim seam --
    def _dispatch_sim(self):
        """Simulator routing: drain the admission queues in the SAME claim
        order the live pumps would use (interactive RR, then batch DRR)
        and submit one modeled task per turn with the same scheduler
        priority — the decision stream (sheds, claim order, fetch ladder)
        is what live-vs-sim parity asserts; the modeled stream carries one
        synthetic token at the modeled completion time."""
        while True:
            turn = self.admission.claim(None, self._now())
            if turn is None:
                return
            recipe = self._recipes[turn.ctx_key]
            fut = self.backend.submit(
                _modeled_turn, (turn.turn_id,),
                recipes={recipe.name: recipe}, n_items=1,
                priority=turn.slo.priority)
            fut.add_done_callback(
                functools.partial(self._sim_turn_done, turn))

    def _sim_turn_done(self, turn: Turn, fut):
        stream = turn.stream
        stream.attempts += 1
        if fut.error is not None:
            stream.finish(error=fut.error)
            return
        stream.push(0, 0)                # the modeled first token
        stream.finish(sim_result=fut.result(timeout=0))
        with self._lock:
            self.turns_completed += 1

    def _drive_sim(self):
        if not self.backend.step() and self.backend.outstanding == 0:
            raise RuntimeError(
                "simulator idle with front-door streams unfinished")

    # --------------------------------------------------------------- stats --
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "admission": self.admission.stats(),
                "router": self.router.stats(),
                "sessions_open": len(self._sessions),
                "turns_completed": self.turns_completed,
                "turns_cancelled": self.turns_cancelled,
                "prefix": {"hits": self.prefix_hits,
                           "tokens_reused": self.prefix_tokens_reused},
            }
