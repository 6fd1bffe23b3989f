"""PCMClient — the first-class Pervasive Context Management session API.

Port of ``repro.core.api``. The paper's Fig. 5 transformation, grown into
a session: contexts are handles you can pin, warm up and introspect; tasks
may hold several named contexts; submission returns Futures (with timeouts
and callbacks) or FutureBatches (``client.map``) or, through the front
door, TokenStreams of sessions (``client.session`` / ``client.stream``);
and the whole application runs unchanged against the LIVE runtime or the
discrete-event SIMULATOR by swapping the backend constructor argument.

    from repro_torch.core import PCMClient, SimulatorBackend, load_context

    client = PCMClient(n_workers=2)                  # live PyTorch backend
    # client = PCMClient(backend=SimulatorBackend(n_workers=20))  # dry-run

    verifier = client.context(load_model, "smollm2-1.7b")   # ContextHandle
    verifier.warm_up()                               # build off-path
    verifier.pin()                                   # survive mode eviction

    @client.task(context=verifier)
    def infer_model(claims):                         # runs per task
        engine = load_context("engine")
        return engine.generate(claims, max_new_tokens=4)

    batch = client.map(infer_model.fn, claim_batches,
                       context=verifier, n_items=16)
    for fut in batch.as_completed():
        consume(fut.result(timeout=60))
    results = batch.gather()

Multi-context tasks name their contexts and resolve variables with
qualified ``load_context("name.var")``:

    @client.task(contexts={"verify": verifier, "rank": ranker})
    def pipeline(claims):
        v = load_context("verify.engine")
        r = load_context("rank.engine")
        ...

Migration from the PR-0 decorator API: ``@context_app(...)`` /
``load_context`` / ``make_recipe`` / ``set_default_manager`` still work
(kept below as thin shims over a default PCMClient) — new code should
construct a PCMClient and use ``client.context`` + ``@client.task``.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Mapping,
                    Optional, Sequence, Tuple, Union)

from repro_torch.core.context import ContextRecipe
from repro_torch.core.library import load_variable_from_context
from repro_torch.core.manager import Future, PCMManager
from repro_torch.core.store import ContextMode, Tier


def load_context(name: str) -> Any:
    """Inside a PCM task body: fetch a variable from the held context(s).

    ``"var"`` searches the installed contexts; ``"ctxname.var"`` reads from
    one named context of a multi-context task."""
    return load_variable_from_context(name)


def make_recipe(name: str, builder: Callable, args: Tuple = (),
                **footprints) -> ContextRecipe:
    return ContextRecipe(name=name, **footprints).with_builder(builder,
                                                               *args)


# ---------------------------------------------------------------- handles --
class ContextHandle:
    """First-class reference to one context recipe within a client session.

    Wraps the recipe with residency operations on the session's backend:
    ``warm_up`` materializes off the task critical path, ``pin``/``release``
    exempt it from (or return it to) mode-driven eviction, ``residency``
    reports the highest tier each worker holds it at. Usable as a context
    manager (``with handle: ...`` pins for the block)."""

    def __init__(self, client: "PCMClient", recipe: ContextRecipe):
        self._client = client
        self.recipe = recipe
        self._pin_depth = 0

    @property
    def pinned(self) -> bool:
        return self._pin_depth > 0

    @property
    def name(self) -> str:
        return self.recipe.name

    @property
    def key(self) -> str:
        return self.recipe.key()

    def warm_up(self, worker_ids: Optional[List[str]] = None) -> List[str]:
        """Materialize the context on the given (default all) workers now.
        Returns the worker ids warmed."""
        return self._client.backend.warm_up(self.recipe,
                                            worker_ids=worker_ids)

    def demote(self, tier: Tier = Tier.HOST_RAM,
               worker_ids: Optional[List[str]] = None) -> List[str]:
        """Physically move the context off the device: DEVICE -> HOST_RAM
        snapshot (params + engine state copied to host), spilled on
        to LOCAL_DISK with ``tier=Tier.LOCAL_DISK``. The next task that
        needs it RESTORES at transfer cost — zero builder calls, zero
        builds, bit-identical state. Returns the workers that held it."""
        return self._client.backend.demote_context(self.recipe, tier=tier,
                                                   worker_ids=worker_ids)

    def snapshot_tier(self) -> Optional[Tier]:
        """Tier of the demoted snapshot in the node pool (live backend),
        or None when no demoted copy exists."""
        getter = getattr(self._client.backend, "snapshot_tier", None)
        return None if getter is None else getter(self.recipe)

    def pin(self) -> "ContextHandle":
        """Refcounted: nested pins (e.g. a with-block inside a standing
        pin) only release the backend pin when the count reaches zero."""
        self._pin_depth += 1
        if self._pin_depth == 1:
            self._client.backend.pin_context(self.recipe)
        return self

    def release(self):
        if self._pin_depth == 0:
            return
        self._pin_depth -= 1
        if self._pin_depth == 0:
            self._client.backend.release_context(self.recipe)

    def residency(self) -> Dict[str, Tier]:
        """worker id -> highest tier currently holding this context."""
        return self._client.backend.residency(self.recipe)

    def fetch_history(self) -> List:
        """The FetchSource-ladder decisions the scheduler made for this
        context so far: ``FetchDecision(worker_id, key, source, donor, t)``
        records, in decision order. PEER entries name the donor worker the
        bootstrap was served from. Identical vocabulary on the live and
        simulator backends."""
        return self._client.backend.fetch_history(self.recipe)

    def resident_workers(self, tier: Tier = Tier.DEVICE) -> List[str]:
        return [wid for wid, t in self.residency().items() if t >= tier]

    def __enter__(self) -> "ContextHandle":
        return self.pin()

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return (f"ContextHandle({self.recipe.name!r}, key={self.key}, "
                f"pinned={self.pinned})")


ContextLike = Union[ContextHandle, ContextRecipe]


def _as_recipe(ctx: ContextLike) -> ContextRecipe:
    return ctx.recipe if isinstance(ctx, ContextHandle) else ctx


# ----------------------------------------------------------------- batches --
class FutureBatch:
    """An ordered collection of Futures from one ``client.map`` call.

    ``gather()`` returns results in submission order; ``as_completed()``
    yields futures in completion order while driving the backend; iteration
    walks the futures in submission order."""

    def __init__(self, futures: Sequence[Future], backend,
                 timeout: Optional[float] = None):
        self._futures: List[Future] = list(futures)
        self._backend = backend
        self._timeout = timeout
        self._completed: List[Future] = []     # completion order
        self._cond = threading.Condition()
        for f in self._futures:
            f.add_done_callback(self._on_done)

    def _on_done(self, fut: Future):
        with self._cond:
            self._completed.append(fut)
            self._cond.notify_all()

    def __len__(self) -> int:
        return len(self._futures)

    def __iter__(self) -> Iterator[Future]:
        return iter(self._futures)

    def __getitem__(self, i) -> Future:
        return self._futures[i]

    @property
    def done(self) -> bool:
        return all(f.done for f in self._futures)

    @property
    def done_count(self) -> int:
        return len(self._completed)

    def add_done_callback(self, cb: Callable[[Future], None]):
        """Attach ``cb`` to every future in the batch."""
        for f in self._futures:
            f.add_done_callback(cb)

    def gather(self, timeout: Optional[float] = None,
               return_exceptions: bool = False) -> List[Any]:
        """Resolve every future; results in submission order. ``timeout``
        bounds the WHOLE batch (defaults to the batch's timeout)."""
        timeout = self._timeout if timeout is None else timeout
        deadline = None if timeout is None else time.monotonic() + timeout
        out: List[Any] = []
        for f in self._futures:
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            try:
                out.append(f.result(timeout=remaining))
            except BaseException as e:
                # only capture errors raised BY the task; a batch deadline
                # or lost task (future still unresolved) always propagates
                if not return_exceptions or not f.done:
                    raise
                out.append(e)
        return out

    def as_completed(self, timeout: Optional[float] = None
                     ) -> Iterator[Future]:
        """Yield futures as they complete — ALWAYS in true completion
        order, promptly. ``timeout`` is a rolling per-future deadline: it
        bounds the wait since the LAST yielded completion (reset on every
        yield), not the whole batch — so one slow future raises after
        ``timeout`` stalled seconds without ever delaying or suppressing
        faster completions that keep arriving. On a concurrent backend
        this waits on a condition variable (worker threads progress on
        their own); on the single-threaded simulator it drives the event
        loop stepwise."""
        timeout = self._timeout if timeout is None else timeout
        deadline = None if timeout is None else time.monotonic() + timeout
        concurrent = getattr(self._backend, "concurrent", False)
        yielded = 0
        while yielded < len(self._futures):
            if yielded < len(self._completed):
                yield self._completed[yielded]
                yielded += 1
                # progress resets the rolling deadline: the timeout bounds
                # the gap to the NEXT completion, so an eventually-slow
                # future never blocks the prompt ones from being yielded
                if timeout is not None:
                    deadline = time.monotonic() + timeout
                continue
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(
                    f"{len(self._futures) - yielded} of "
                    f"{len(self._futures)} futures incomplete after "
                    f"{timeout:.3f}s without progress")
            if concurrent:
                # completions notify immediately; the 0.1s slice is only a
                # heartbeat for the stall checks below
                with self._cond:
                    if len(self._completed) <= yielded:
                        self._cond.wait(0.1)
                if len(self._completed) <= yielded and \
                        self._backend.outstanding == 0:
                    raise RuntimeError(
                        f"{len(self._futures) - yielded} futures lost: "
                        "backend idle with tasks unresolved")
                if deadline is None and \
                        not getattr(self._backend, "workers", True):
                    # no live workers and no deadline: nothing can resolve
                    raise RuntimeError(
                        "backend stalled (no live workers) with "
                        f"{self._backend.outstanding} tasks outstanding")
                continue
            if not self._backend.step():
                if self._backend.outstanding == 0:
                    raise RuntimeError(
                        f"{len(self._futures) - yielded} futures lost: "
                        "backend idle with tasks unresolved")
                if deadline is None:
                    # single-threaded runtime: a stall with work
                    # outstanding cannot resolve itself
                    raise RuntimeError(
                        "backend stalled (no runnable workers?) with "
                        f"{self._backend.outstanding} tasks outstanding")
                time.sleep(0.0001)


# ------------------------------------------------------------------ client --
class PCMClient:
    """A Pervasive-Context-Management session over an ExecutionBackend.

    ``backend`` defaults to a live :class:`PCMManager`; pass a
    :class:`repro_torch.core.backend.SimulatorBackend` to dry-run the
    identical application against modeled cluster time."""

    def __init__(self, backend=None, *, mode: ContextMode = ContextMode.FULL,
                 n_workers: int = 2):
        self.backend = backend if backend is not None else PCMManager(
            mode=mode, n_workers=n_workers)
        self._handles: Dict[str, ContextHandle] = {}
        self._frontdoor = None

    # ---------------------------------------------------------- contexts --
    def context(self, builder_or_recipe: Union[Callable, ContextRecipe],
                *builder_args, name: Optional[str] = None,
                **footprints) -> ContextHandle:
        """Declare a context and get its handle. Accepts a prebuilt
        ContextRecipe, or a builder callable (+ args) from which a recipe
        is made; ``footprints`` forward to ContextRecipe (artifact_bytes,
        device_bytes, ...). Handles are cached per recipe key."""
        if isinstance(builder_or_recipe, ContextRecipe):
            recipe = builder_or_recipe
        else:
            builder = builder_or_recipe
            recipe = ContextRecipe(
                name=name or f"{builder.__name__}.ctx",
                **footprints).with_builder(builder, *builder_args)
        handle = self._handles.get(recipe.key())
        if handle is None:
            handle = ContextHandle(self, recipe)
            self._handles[recipe.key()] = handle
        return handle

    def _named_recipes(self, context: Optional[ContextLike],
                       contexts: Optional[Mapping[str, ContextLike]]
                       ) -> Dict[str, ContextRecipe]:
        if context is not None and contexts is not None:
            raise TypeError("pass either context= or contexts=, not both")
        if contexts is not None:
            return {cname: _as_recipe(c) for cname, c in contexts.items()}
        if context is not None:
            recipe = _as_recipe(context)
            return {recipe.name: recipe}
        return {}

    # -------------------------------------------------------- submission --
    def task(self, context: Optional[ContextLike] = None,
             contexts: Optional[Mapping[str, ContextLike]] = None,
             n_items: int = 1, priority: int = 0):
        """Decorator: invoking the function submits a PCM task and returns
        a Future. ``contexts={"name": handle, ...}`` gives the task several
        named contexts; the body reads them with
        ``load_context("name.var")``."""
        named = self._named_recipes(context, contexts)

        def deco(fn: Callable):
            @functools.wraps(fn)
            def wrapper(*args, **kwargs) -> Future:
                return self.backend.submit(fn, args, kwargs, recipes=named,
                                           n_items=n_items,
                                           priority=priority)

            wrapper.fn = fn
            wrapper.contexts = named
            wrapper.recipe = next(iter(named.values()), None)
            return wrapper

        return deco

    def submit(self, fn: Callable, *args,
               context: Optional[ContextLike] = None,
               contexts: Optional[Mapping[str, ContextLike]] = None,
               n_items: int = 1, priority: int = 0, **kwargs) -> Future:
        """Submit one call of ``fn(*args, **kwargs)`` as a PCM task."""
        named = self._named_recipes(context, contexts)
        return self.backend.submit(fn, args, kwargs, recipes=named,
                                   n_items=n_items, priority=priority)

    def map(self, fn: Callable, items: Iterable, *,
            batch_size: Optional[int] = None,
            context: Optional[ContextLike] = None,
            contexts: Optional[Mapping[str, ContextLike]] = None,
            priority: int = 0, timeout: Optional[float] = None,
            on_done: Optional[Callable[[Future], None]] = None
            ) -> FutureBatch:
        """Bulk submission. Without ``batch_size``, one task per item
        (``fn(item)``); with it, one task per chunk (``fn(list_of_items)``,
        ``n_items=len(chunk)``). ``timeout`` becomes the batch default;
        ``on_done`` runs per future as it resolves. ``priority>0`` is a
        front-of-queue hint honored by the ContextAwareScheduler."""
        named = self._named_recipes(context, contexts)
        seq = list(items)
        if batch_size is None:
            calls = [((item,), 1) for item in seq]
        else:
            if batch_size <= 0:
                raise ValueError("batch_size must be positive")
            calls = [((seq[i:i + batch_size],), len(seq[i:i + batch_size]))
                     for i in range(0, len(seq), batch_size)]
        futures = []
        for call_args, n in calls:
            fut = self.backend.submit(fn, call_args, {}, recipes=named,
                                      n_items=n, priority=priority)
            if on_done is not None:
                fut.add_done_callback(on_done)
            futures.append(fut)
        return FutureBatch(futures, self.backend, timeout=timeout)

    # ------------------------------------------------- streaming sessions --
    def frontdoor(self, **kwargs) -> "Any":
        """The client's streaming front door (admission, per-tenant
        fairness, SLO routing — see ``repro_torch.serving.frontdoor``),
        created on first use. Configuration kwargs (``quotas``, ``lanes``,
        ``engine_var``, ...) are accepted only on the creating call."""
        if self._frontdoor is None:
            from repro_torch.serving.frontdoor import FrontDoor
            self._frontdoor = FrontDoor(self.backend, **kwargs)
        elif kwargs:
            raise ValueError("front door already configured for this "
                             "client — pass kwargs on the first call only")
        return self._frontdoor

    def session(self, context: ContextLike, *, tenant: str = "default",
                slo=None, session_id: Optional[str] = None,
                prefix_key: Optional[str] = None):
        """Open a streaming session against ``context`` (whose built value
        must expose an InferenceEngine under the front door's
        ``engine_var``, default ``"engine"``). Works on the live AND
        simulator backends; ``session.submit(prompt)`` returns a
        TokenStream or raises ShedError on admission backpressure.
        ``prefix_key`` names the session's shared prompt template so the
        router colocates template-mates on one lane (prefix-cache hits)."""
        from repro_torch.serving.session import SLOClass
        return self.frontdoor().open_session(
            context, tenant=tenant, slo=slo or SLOClass.BATCH,
            session_id=session_id, prefix_key=prefix_key)

    def stream(self, prompt, *, context: ContextLike,
               tenant: str = "default", slo=None,
               max_new_tokens: int = 32, temperature: float = 0.0,
               stop_tokens: Tuple[int, ...] = (1,)):
        """One-shot streaming: open an ephemeral session, submit one turn,
        return its TokenStream (iterate it for tokens as they decode)."""
        sess = self.session(context, tenant=tenant, slo=slo)
        try:
            return sess.submit(prompt, max_new_tokens=max_new_tokens,
                               temperature=temperature,
                               stop_tokens=stop_tokens)
        finally:
            sess.close()

    # ----------------------------------------------------------- session --
    def drain(self) -> int:
        """Run the backend until no actions/events are pending."""
        return self.backend.run_until_idle()

    def shutdown(self):
        """Stop the backend's worker threads (live backend; no-op on the
        simulator)."""
        stop = getattr(self.backend, "shutdown", None)
        if stop is not None:
            stop()

    def stats(self) -> Dict:
        return self.backend.stats()

    @property
    def workers(self) -> List[str]:
        return list(self.backend.scheduler.workers)


# --------------------------------------------------- backward-compat shim --
_default_client: Optional[PCMClient] = None


def set_default_manager(manager: PCMManager):
    """Legacy: point the module-level decorator API at a live manager."""
    global _default_client
    _default_client = PCMClient(backend=manager)


def get_default_manager() -> PCMManager:
    return get_default_client().backend


def get_default_client() -> PCMClient:
    global _default_client
    if _default_client is None:
        _default_client = PCMClient(mode=ContextMode.FULL, n_workers=1)
    return _default_client


def context_app(context: Optional[Tuple] = None, n_items: int = 1,
                manager: Optional[PCMManager] = None,
                recipe: Optional[ContextRecipe] = None):
    """Legacy decorator (paper Fig. 5): invoking the function submits a PCM
    task and returns a Future. ``context=(builder, args)`` mirrors the
    paper's parsl_spec. New code: ``PCMClient`` + ``@client.task``."""

    def deco(fn: Callable):
        if recipe is not None:
            task_recipe = recipe
        elif context is not None:
            builder, args = context[0], tuple(context[1]) if len(
                context) > 1 else ()
            task_recipe = make_recipe(f"{fn.__name__}.ctx", builder, args)
        else:
            task_recipe = None

        @functools.wraps(fn)
        def wrapper(*args, **kwargs) -> Future:
            backend = manager if manager is not None \
                else get_default_client().backend
            return backend.submit(fn, args, kwargs, recipe=task_recipe,
                                  n_items=n_items)

        wrapper.recipe = task_recipe
        wrapper.fn = fn
        return wrapper

    return deco
