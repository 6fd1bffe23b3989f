"""Streaming sessions: the sticky, long-lived unit of front-door work.

The PCM runtime's original client surface was bulk-oriented
(``client.map`` -> FutureBatch) — the task model StickyInvoc argues is
wrong for LLM-era workflows. A :class:`Session` is the replacement: a
tenant opens it against one context, submits *turns* (prompts) over time,
and consumes each turn's tokens as they are generated. Sessions are
sticky: every turn of a session routes through the same lane (see
``repro_torch.serving.frontdoor.SessionRouter``), so a conversation keeps
hitting the worker whose context is warm for it, and they survive worker
preemption — the lane's serving pump is requeued by the scheduler and the
context re-acquired through the PEER/POOL/DISK/FS/BUILD ladder with zero
builder calls and zero kernel builds mid-stream.

:class:`TokenStream` is the per-turn consumption handle. Tokens arrive
from the engine's ``on_token`` callback on a *worker* thread and are
consumed from the client thread — the stream is the thread-safe seam
between the two. Delivery is exactly-once by token index: a preempted
worker's zombie pump and its requeued replacement may both replay a turn,
but greedy decoding makes the replay a prefix-identical token sequence,
so index-deduplication is sound (and divergence — same index, different
token — is detected and raised, because it would mean the bit-parity
guarantee broke).

:class:`SLOClass` is the admission-time service class. INTERACTIVE turns
jump ahead of BATCH turns in admission order (front-door claim order AND
the engine's prefill queue) — they never preempt a running decode.

Port of ``repro.serving.session``: framework-free, a copy.
"""

from __future__ import annotations

import enum
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, List, Optional, Tuple

_turn_ids = itertools.count()


class SLOClass(enum.Enum):
    """Service class attached at admission.

    INTERACTIVE — latency-sensitive: claimed ahead of batch work and
    admitted ahead of queued batch prefills (never preempting running
    decodes).
    BATCH — throughput work: deficit-round-robin fairness across tenants.
    """
    INTERACTIVE = "interactive"
    BATCH = "batch"

    @property
    def priority(self) -> int:
        return 1 if self is SLOClass.INTERACTIVE else 0


class StreamError(RuntimeError):
    """A turn failed mid-stream (engine error or greedy divergence)."""


class TokenStream:
    """Thread-safe, exactly-once, in-order stream of one turn's tokens.

    Producers (engine callbacks, possibly from several pump attempts after
    a preemption) call ``push(index, token)``; duplicate indices are
    dropped (greedy replay), gaps and divergent replays raise. Consumers
    iterate (``for tok in stream``) or block on ``result()``. On the
    simulator backend nothing progresses unless the event loop is stepped,
    so the front door installs a ``driver`` the consumer-side waits call
    instead of sleeping.
    """

    def __init__(self, turn_id: int, clock: Callable[[], float] = None,
                 driver: Callable[[], Any] = None):
        self.turn_id = turn_id
        self._clock = clock or time.monotonic
        self._driver = driver
        self._cond = threading.Condition()
        self._tokens: List[int] = []
        self._done = False
        self._error: Optional[BaseException] = None
        self.created_at = self._clock()
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.request = None            # live backend: the engine Request
        self.sim_result = None         # simulator backend: SimTaskResult
        self.attempts = 0              # pump attempts that served this turn

    # ------------------------------------------------------------ producer --
    def push(self, index: int, token: int) -> bool:
        """Deliver one token. Returns True when the token is new, False on
        a duplicate replay (same index, same token). Raises StreamError on
        divergence or a gap — both mean a runtime invariant broke."""
        with self._cond:
            if index < len(self._tokens):
                if self._tokens[index] != token:
                    err = StreamError(
                        f"turn {self.turn_id}: replayed token {index} "
                        f"diverged ({self._tokens[index]} != {token}) — "
                        f"greedy replay must be prefix-identical")
                    self._error = self._error or err
                    self._done = True
                    self._cond.notify_all()
                    raise err
                return False
            if index > len(self._tokens):
                raise StreamError(
                    f"turn {self.turn_id}: token {index} arrived before "
                    f"{len(self._tokens)} — streams deliver in order")
            if self.first_token_at is None:
                self.first_token_at = self._clock()
            self._tokens.append(token)
            self._cond.notify_all()
            return True

    def finish(self, request=None, error: BaseException = None,
               sim_result=None):
        """Mark the turn complete (idempotent — the first finisher wins,
        later zombie-pump finishes are no-ops)."""
        with self._cond:
            if self._done:
                return
            self._done = True
            self.finished_at = self._clock()
            if request is not None:
                self.request = request
            if sim_result is not None:
                self.sim_result = sim_result
            self._error = self._error or error
            self._cond.notify_all()

    # ------------------------------------------------------------ consumer --
    def _wait(self, timeout: Optional[float]):
        """One bounded wait for progress; drives the sim event loop when a
        driver is installed (the DES produces nothing while we sleep)."""
        if self._driver is not None:
            self._cond.release()
            try:
                self._driver()
            finally:
                self._cond.acquire()
        else:
            self._cond.wait(timeout)

    def tokens(self, timeout: Optional[float] = None) -> Iterator[int]:
        """Yield tokens in order as they are generated; returns when the
        turn finishes, raises on stream error or stall (> ``timeout``
        seconds with no progress)."""
        i = 0
        with self._cond:
            while True:
                if i < len(self._tokens):
                    tok = self._tokens[i]
                    i += 1
                    self._cond.release()
                    try:
                        yield tok
                    finally:
                        self._cond.acquire()
                    continue
                if self._done:
                    if self._error is not None:
                        raise self._error
                    return
                deadline = (None if timeout is None
                            else time.monotonic() + timeout)
                while i >= len(self._tokens) and not self._done:
                    self._wait(0.1 if timeout is not None else None)
                    if deadline is not None and i >= len(self._tokens) \
                            and not self._done \
                            and time.monotonic() > deadline:
                        raise TimeoutError(
                            f"turn {self.turn_id}: no token for "
                            f"{timeout}s ({i} received)")

    def __iter__(self) -> Iterator[int]:
        return self.tokens()

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until the turn finishes; return all generated tokens."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._done:
                self._wait(0.1)
                if deadline is not None and not self._done \
                        and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"turn {self.turn_id} unfinished after {timeout}s")
            if self._error is not None:
                raise self._error
            return list(self._tokens)

    # ------------------------------------------------------------- metrics --
    @property
    def done(self) -> bool:
        with self._cond:
            return self._done

    @property
    def token_count(self) -> int:
        with self._cond:
            return len(self._tokens)

    @property
    def ttft_seconds(self) -> Optional[float]:
        """Session-level time to first token: admission queueing + pump
        scheduling + context acquisition + prefill — measured from the
        front-door submit, on the front door's clock (modeled time on the
        simulator backend)."""
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.created_at

    @property
    def decode_tokens_per_second(self) -> Optional[float]:
        """First-token-relative decode throughput (the non-conflated half
        of the TTFT/throughput split — see Request.tokens_per_second)."""
        if (self.first_token_at is None or self.finished_at is None
                or len(self._tokens) <= 1):
            return None
        dt = self.finished_at - self.first_token_at
        return (len(self._tokens) - 1) / max(dt, 1e-9)


@dataclass
class Turn:
    """One admitted prompt of one session, queued at the front door until a
    serving pump claims it."""
    session_id: str
    tenant: str
    slo: SLOClass
    ctx_key: str                      # recipe key — which context serves it
    lane: int                         # sticky lane within the context
    prompt: List[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    stop_tokens: Tuple[int, ...] = (1,)
    turn_id: int = field(default_factory=lambda: next(_turn_ids))
    stream: Optional[TokenStream] = None
    admitted_at: float = 0.0
    claimed: bool = False

    @property
    def cost(self) -> int:
        """Admission cost in tokens (prompt + generation budget) — the
        unit of token-bucket spend and DRR deficit accounting."""
        return len(self.prompt) + self.max_new_tokens


class Session:
    """An open streaming session: tenant + SLO class + one context.

    Obtained from ``FrontDoor.open_session`` (or ``PCMClient.session``).
    ``submit``/``stream`` push one turn through admission (raising
    ``ShedError`` on backpressure) and return its :class:`TokenStream`.
    Usable as a context manager; ``close`` refuses new turns but lets
    in-flight streams finish.
    """

    def __init__(self, frontdoor, session_id: str, tenant: str,
                 slo: SLOClass, recipe, lane: int,
                 prefix_key: Optional[str] = None):
        self._frontdoor = frontdoor
        self.session_id = session_id
        self.tenant = tenant
        self.slo = slo
        self.recipe = recipe
        self.lane = lane
        # declared shared-prompt template (see FrontDoor.open_session):
        # sessions with the same key are laned together so ONE engine's
        # prefix cache serves all of them
        self.prefix_key = prefix_key
        self.closed = False
        self.turns: List[Turn] = []

    def submit(self, prompt: List[int], max_new_tokens: int = 32,
               temperature: float = 0.0,
               stop_tokens: Tuple[int, ...] = (1,)) -> TokenStream:
        """Admit one turn; returns its TokenStream or raises ShedError."""
        if self.closed:
            raise RuntimeError(f"session {self.session_id} is closed")
        return self._frontdoor.submit_turn(
            self, prompt, max_new_tokens=max_new_tokens,
            temperature=temperature, stop_tokens=stop_tokens)

    # alias: "stream me this prompt"
    stream = submit

    def close(self, cancel_pending: bool = False):
        """Refuse new turns; already-submitted streams keep flowing to
        completion (the ephemeral `client.stream()` pattern: submit, close,
        then iterate). With ``cancel_pending=True`` — an abandoning caller
        — the session's admitted-but-UNCLAIMED turns are withdrawn instead
        (their streams finish with a StreamError; no request ever reached
        an engine, so nothing leaks and no admission-queue depth stays
        consumed); claimed in-flight streams still finish either way."""
        self.closed = True
        self._frontdoor._session_closed(self, cancel_pending)

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc):
        self.close()
        return False
