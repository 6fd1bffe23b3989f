"""The Library — the persistent executor that holds materialized contexts.

Port of ``repro.core.library``: framework-free, a copy with its imports
pointed at this package. Where the reference compiles executables, this
package loads (and at first use builds) its kernel libraries.

Mirrors the TaskVine library process (paper §3): it registers a function's
context recipe once, materializes it (builder runs in this process's
address space), then executes every subsequent invocation against the
resident context. The materialization includes loading (at first use,
building) the kernel libraries, so the (weights, kernels, KV pool) triple
survives across tasks.

In the concurrent runtime each Library is owned by ONE worker actor thread
(see ``repro.core.manager``): all builds, invocations and demotions happen
on that thread, serialized by the worker's mailbox. The Library is also
the seam for physical tier movement — ``ensure`` prefers promoting a
demoted snapshot from the node :class:`~repro.core.store.SnapshotPool`
(restore cost: one host/disk -> device transfer, zero builder calls, zero
kernel builds) over re-running the builder, and ``demote``/``demote_all`` push
resident contexts the other way when a worker idles or loses its device.

A task may hold SEVERAL named contexts at once (e.g. a verifier engine and
a reranker engine); ``invoke`` installs the whole mapping and
``load_variable_from_context`` resolves both unqualified variable names
(``"engine"``, searched across the installed contexts) and qualified
``"ctxname.var"`` references.

``current_context()`` is the in-task accessor — the analogue of the
paper's ``load_variable_from_serverless``.
"""

from __future__ import annotations

import contextvars
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Set

from repro_torch.core.context import (Context, ContextRecipe, materialize,
                                      restore_context, snapshot_context)
from repro_torch.core.transfer import FetchSource

_current: contextvars.ContextVar = contextvars.ContextVar(
    "repro_pcm_context", default=None)


def current_context() -> Any:
    """Inside a PCM task: the context value built by the recipe's builder.

    With a single installed context this is that context's value; with
    multiple named contexts it is a ``{name: value}`` mapping.
    """
    installed: Optional[Dict[str, Context]] = _current.get()
    if not installed:
        raise RuntimeError("no PCM context installed — is this function "
                           "running under a Library / PCMManager?")
    if len(installed) == 1:
        return next(iter(installed.values())).value
    return {name: ctx.value for name, ctx in installed.items()}


def load_variable_from_context(name: str) -> Any:
    """Resolve a context variable for the running task.

    ``"var"``          searched across every installed context whose value
                       is a dict; must match exactly one.
    ``"ctxname.var"``  looked up in the named context (multi-context tasks).
    """
    installed: Optional[Dict[str, Context]] = _current.get()
    if not installed:
        raise RuntimeError("no PCM context installed — is this function "
                           "running under a Library / PCMManager?")
    if "." in name:
        ctx_name, var = name.split(".", 1)
        if ctx_name in installed:
            value = installed[ctx_name].value
            if isinstance(value, dict) and var in value:
                return value[var]
            raise KeyError(f"context {ctx_name!r} has no variable {var!r}")
    hits = [(cname, ctx.value[name]) for cname, ctx in installed.items()
            if isinstance(ctx.value, dict) and name in ctx.value]
    if len(hits) == 1:
        return hits[0][1]
    if not hits:
        raise KeyError(f"no installed context has variable {name!r} "
                       f"(contexts: {sorted(installed)})")
    raise KeyError(f"variable {name!r} is ambiguous across contexts "
                   f"{sorted(c for c, _ in hits)} — qualify as "
                   f"'<context>.{name}'")


@dataclass
class InvocationRecord:
    task_id: str
    ctx_key: str
    seconds: float
    cold: bool


class Library:
    """One per worker. Materializes recipes once; executes invocations."""

    def __init__(self, worker_id: str = "local", snapshots=None,
                 streamed: bool = False, fetch_source_limit: int = 4096):
        self.worker_id = worker_id
        self.snapshots = snapshots     # node SnapshotPool (may be None)
        # streamed=True: DISK promotions stream spill entries straight to
        # device (read+verify one thread, device_put the other) instead of
        # materializing the whole host snapshot first
        self.streamed = streamed
        self.fetch_source_limit = int(fetch_source_limit)
        self._contexts: Dict[str, Context] = {}
        self.pinned: Set[str] = set()
        self.records: List[InvocationRecord] = []
        self.build_seconds_total = 0.0
        self.aot_seconds_total = 0.0   # executable warm-up inside builds
        self.builder_calls = 0         # full materializations (cold builds)
        self.restores = 0              # snapshot promotions (no builder)
        self.restore_seconds_total = 0.0
        self.demotions = 0
        self.peer_installs = 0         # contexts adopted from a P2P donor
        self.peer_exports = 0          # templates exported to receivers
        self.peer_install_seconds = 0.0
        # the ACTUAL source of every acquisition this Library performed
        # (POOL/DISK/BUILD via ensure, PEER via adopt) — the execution-side
        # complement of the scheduler's fetch_log decisions. Bounded: a
        # long-lived worker trims the oldest entries past
        # ``fetch_source_limit`` (kept a list, not a deque, so existing
        # slicing/comparison call sites are untouched).
        self.fetch_sources: List[FetchSource] = []
        # per-stage (disk/h2d) timings observed during streamed restores,
        # as (stage, nbytes, seconds) — drained by the manager into
        # TransferPlanner.observe_stage for pipeline-cost calibration
        self.stage_observations: List[tuple] = []

    # ---------------------------------------------------------- contexts --
    def has(self, key: str) -> bool:
        return key in self._contexts

    def ensure(self, recipe: ContextRecipe) -> Context:
        """Return the resident context, RESTORING it from the node snapshot
        pool when a demoted copy exists (promotion: a copy of the host/disk
        snapshot to the device — zero builder calls, zero builds), and
        materializing it from scratch only when it does not (the one-time
        startup).

        Materialization warms any engines in the built value (see
        ``repro_torch.core.context.materialize``), so the resident context
        holds weights + KV pools + loaded kernels: tasks executed against
        it never pay a build."""
        key = recipe.key()
        if key not in self._contexts:
            ctx = None
            if self.snapshots is not None:
                snap = self.snapshots.take(key)
                if snap is not None:
                    from_disk = snap.spilled
                    ctx = restore_context(
                        snap, self.worker_id,
                        spill_store=self.snapshots.spill_store(),
                        streamed=self.streamed)
                    self.restores += 1
                    self.restore_seconds_total += ctx.restore_seconds
                    self.snapshots.restore_seconds += ctx.restore_seconds
                    for stage, info in (ctx.stage_seconds or {}).items():
                        self.stage_observations.append(
                            (stage, info[0], info[1]))
                    self._record_source(
                        FetchSource.DISK if from_disk else FetchSource.POOL)
            if ctx is None:
                ctx = materialize(recipe, self.worker_id)
                self.builder_calls += 1
                self.build_seconds_total += ctx.build_seconds
                self.aot_seconds_total += ctx.aot_seconds
                self._record_source(
                    FetchSource.FS if recipe.transfer_bytes > 0
                    else FetchSource.BUILD)
            self._contexts[key] = ctx
        return self._contexts[key]

    def demote(self, key: str, force: bool = False):
        """Physically demote one resident context DEVICE -> HOST_RAM: pull
        its device state into a ContextSnapshot and hand it to the node
        snapshot pool (which may later spill it to LOCAL_DISK). Returns the
        snapshot, or None when the key is absent/pinned (pins are a
        device-residency promise; pass ``force`` when the device itself is
        being lost). A Library without a snapshot pool cannot demote —
        refusing up front, NOT evicting, so the context is never destroyed
        by a demotion that has nowhere to put it."""
        if self.snapshots is None:
            return None
        ctx = self.evict(key, force=force)
        if ctx is None:
            return None
        snap = snapshot_context(ctx)
        self.snapshots.put(snap)
        self.demotions += 1
        return snap

    def demote_all(self, force: bool = False):
        """Demote every resident context (worker retirement: the device is
        being reclaimed, so even pinned contexts move to host)."""
        for key in list(self._contexts):
            self.demote(key, force=force)

    def install(self, ctx: Context):
        """Make a context resident without building it here."""
        self._contexts[ctx.key] = ctx

    def adopt(self, ctx: Context):
        """Adopt a context restored from a peer-donated template snapshot
        (P2P bootstrap): resident with zero builder calls and zero
        builds, at one host-to-device copy of transfer cost. Counted under
        ``peer_install_seconds`` only — ``restore_seconds_total`` stays
        pool/disk promotions, so the two never double-count."""
        self.install(ctx)
        self.peer_installs += 1
        self.peer_install_seconds += ctx.restore_seconds
        self._record_source(FetchSource.PEER)

    def _record_source(self, source: FetchSource):
        self.fetch_sources.append(source)
        if len(self.fetch_sources) > self.fetch_source_limit:
            del self.fetch_sources[:-self.fetch_source_limit]

    def pin(self, key: str):
        self.pinned.add(key)

    def unpin(self, key: str):
        self.pinned.discard(key)

    def evict(self, key: str, force: bool = False) -> Optional[Context]:
        if key in self.pinned and not force:
            return None
        return self._contexts.pop(key, None)

    def evict_all(self, force: bool = False):
        if force or not self.pinned:
            self._contexts.clear()
        else:
            self._contexts = {k: v for k, v in self._contexts.items()
                              if k in self.pinned}

    def context(self, key: str) -> Context:
        return self._contexts[key]

    @property
    def resident_keys(self):
        return set(self._contexts)

    # -------------------------------------------------------- invocation --
    def invoke(self, fn: Callable, args: tuple = (), kwargs: dict = None,
               recipe: Optional[ContextRecipe] = None,
               recipes: Optional[Mapping[str, ContextRecipe]] = None,
               task_id: str = "") -> Any:
        """Execute fn with the recipes' contexts installed.

        ``recipes`` is an ordered ``{name: recipe}`` mapping (multi-context
        tasks); ``recipe`` is the single-context shorthand, installed under
        its own ``recipe.name``. ``cold`` in the record marks invocations
        that had to materialize at least one context first (the startup the
        paper amortizes away)."""
        kwargs = kwargs or {}
        named: Dict[str, ContextRecipe] = dict(recipes or {})
        if recipe is not None and recipe.key() not in {
                r.key() for r in named.values()}:
            named.setdefault(recipe.name, recipe)
        t0 = time.monotonic()
        cold = False
        token = None
        if named:
            installed: Dict[str, Context] = {}
            for cname, rec in named.items():
                cold = cold or not self.has(rec.key())
                ctx = self.ensure(rec)
                ctx.touch()
                installed[cname] = ctx
            token = _current.set(installed)
        try:
            return fn(*args, **kwargs)
        finally:
            if token is not None:
                _current.reset(token)
            self.records.append(InvocationRecord(
                task_id=task_id,
                ctx_key=",".join(r.key() for r in named.values()),
                seconds=time.monotonic() - t0, cold=cold))
