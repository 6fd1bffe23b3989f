"""The port's PCM policy layer against the JAX reference's: recipe keys,
the context-aware scheduler on one scripted trace (the same Actions and the
same fetch_log in both packages), the ContextStore and SnapshotPool cases
of tests/test_runtime.py (pins, TierFullError, LRU spill to disk), and the
live manager and client cases of tests/test_pcm.py and test_elastic.py on
plain-value contexts."""

import collections
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.core.context import GB  # noqa: E402
from repro_torch.core import (ContextStore, Library, SnapshotPool,  # noqa
                              Tier, TierFullError, make_recipe)


def build_verifier(arch, slots, table=None):
    """A builder shared by both packages' recipes (its qualname is part of
    the key)."""
    return {"arch": arch, "slots": slots, "table": table}


# ------------------------------------------------------------ recipe keys --
RECIPE_FIELDS = [
    dict(name="smol.ctx"),
    dict(name="smol.ctx", model_key="smollm2-1.7b", version=2,
         artifact_bytes=123, env_bytes=0, host_bytes=7, device_bytes=9),
]


@pytest.mark.parametrize("fields", RECIPE_FIELDS, ids=["defaults", "sized"])
@pytest.mark.parametrize("args", [
    (), ("smollm2-1.7b", 4), ("smollm2-1.7b", 4, np.arange(6.0)),
    ("smollm2-1.7b", 4, {"b": [1, 2.5, None], "a": np.ones((2, 3),
                                                           np.int32)})],
    ids=["no-args", "plain", "array", "nested"])
def test_recipe_key_matches_reference(fields, args):
    j = jcore.ContextRecipe(**fields).with_builder(build_verifier, *args)
    t = tcore.ContextRecipe(**fields).with_builder(build_verifier, *args)
    assert t.key() == j.key()
    assert len(t.key()) == 16
    if not args:
        assert tcore.ContextRecipe(**fields).key() == \
            jcore.ContextRecipe(**fields).key()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_tensor_builder_args_hash_by_value(dtype):
    def key(x):
        return tcore.make_recipe("t", build_verifier, ("a", 1, x)).key()

    x = torch.arange(10000).to(dtype)
    y = x.clone()
    z = x.clone()
    z[5000] = 7
    assert key(x) == key(y)                 # equal tensors alias
    assert key(x) != key(z)                 # one element apart: distinct
    assert key(x) != key(x.reshape(100, 100))
    assert key(x) != key(x.to(torch.float64))
    if dtype != torch.bfloat16:
        # a tensor hashes as the numpy array of its values and dtype
        assert key(x) == key(x.numpy())


# -------------------------------------------------------- scheduler trace --
def _pkg(core):
    return types.SimpleNamespace(**{n: getattr(core, n) for n in (
        "ContextAwareScheduler", "ContextMode", "ContextRecipe",
        "ContextStore", "Task", "Tier", "TransferPlanner")})


def _action(a):
    return (a.kind, a.worker_id, a.task_id,
            a.recipe.name if a.recipe is not None else None,
            tuple(r.name for r in a.recipes), a.warm,
            a.source.name if a.source is not None else None, a.donor,
            tuple(a.donors), round(a.eta_seconds, 9),
            tuple(a.host_resident))


def _decision(d):
    return (d.worker_id, d.key, d.source.name, d.donor, round(d.t, 9),
            d.degraded_from.name if d.degraded_from is not None else None)


def run_trace(P):
    """One scripted run of the scheduler: two workers join, single-,
    multi- and no-context tasks (one with priority) arrive, actions
    complete in order on a one-second clock, a worker is preempted while
    busy (its task requeues) and its context lands in the node pool, two
    workers join (one bootstraps from a peer or the pool), and another is
    preempted mid-fetch. Returns the Actions, the fetch_log and the
    completion order."""
    sched = P.ContextAwareScheduler(mode=P.ContextMode.FULL,
                                    planner=P.TransferPlanner())
    pool = {}
    sched.pool_tier = pool.get
    A = P.ContextRecipe(name="verifier", model_key="smollm2-1.7b",
                        version=1)
    B = P.ContextRecipe(name="ranker", artifact_bytes=2 * GB,
                        env_bytes=GB, host_bytes=3 * GB,
                        device_bytes=2 * GB)
    actions, pending = [], collections.deque()
    clock = [0.0]

    def feed(acts):
        for a in acts:
            actions.append(_action(a))
            if a.kind != "cancel":
                pending.append(a)

    def complete(n):
        for _ in range(n):
            if not pending:
                return
            a = pending.popleft()
            clock[0] += 1.0
            if a.worker_id not in sched.workers:
                continue
            if a.kind == "fetch":
                if a.plan is not None:
                    sched.planner.complete(a.plan, clock[0])
                feed(sched.on_fetch_done(a.worker_id, a.recipe.key(),
                                         clock[0]))
            else:
                feed(sched.on_task_done(a.worker_id, a.task_id, clock[0]))

    def join(wid):
        feed(sched.on_worker_join(wid, clock[0], store=P.ContextStore()))

    join("w0")
    join("w1")
    for i, (recipes, prio) in enumerate([
            ((A,), 0), ((A,), 0), ((A, B), 0), ((), 0), ((B,), 1),
            ((A,), 0), ((A, B), 0), ((A,), 0)]):
        task = P.Task(task_id=f"t{i}", recipes=recipes, priority=prio)
        feed(sched.submit(task, clock[0]))
    complete(5)
    busy = [w for w, info in sched.workers.items() if info.current]
    victim = busy[0] if busy else "w0"
    feed(sched.on_worker_leave(victim, clock[0]))
    pool[A.key()] = P.Tier.HOST_RAM
    join("w2")
    join("w3")
    complete(3)
    fetching = [w for w, info in sched.workers.items()
                if info.fetching_key is not None]
    if fetching:
        feed(sched.on_worker_leave(fetching[-1], clock[0]))
    for i in range(8, 11):
        feed(sched.submit(P.Task(task_id=f"t{i}", recipes=(B, A)),
                          clock[0]))
    join("w4")
    complete(200)
    attempts = {tid: t.attempts for tid, t in sched.tasks.items()}
    return (actions, [_decision(d) for d in sched.fetch_log],
            [c.task_id for c in sched.completions], attempts,
            sched.outstanding)


def test_scheduler_trace_matches_reference():
    t_actions, t_log, t_done, t_attempts, t_left = run_trace(_pkg(tcore))
    j_actions, j_log, j_done, j_attempts, j_left = run_trace(_pkg(jcore))
    assert t_actions == j_actions
    assert t_log == j_log
    assert t_done == j_done and t_attempts == j_attempts
    # the trace exercises what it claims: every task done, a requeue, and
    # several rungs of the ladder
    assert t_left == 0 and len(t_done) == 11
    assert any(n >= 1 for n in t_attempts.values())
    sources = {d[2] for d in t_log}
    assert len(sources) >= 2 and sources & {"PEER", "POOL"}, sources


# ---------------------------------------------------- store admit refusal --
def test_store_pinned_blockage_refused_not_overcommitted():
    s = ContextStore(device_bytes=10 * GB)
    s.pin("a")
    s.admit("a", Tier.DEVICE, 8 * GB)
    with pytest.raises(TierFullError):
        s.admit("b", Tier.DEVICE, 6 * GB)
    assert not s.has("b", Tier.DEVICE)
    assert s.used(Tier.DEVICE) == 8 * GB


def test_store_pinned_bytes_surfaced_in_stats():
    s = ContextStore(device_bytes=10 * GB)
    s.pin("a")
    s.admit("a", Tier.DEVICE, 8 * GB)
    s.admit("b", Tier.HOST_RAM, 1 * GB)
    st = s.stats()
    assert st["tiers"]["DEVICE"]["pinned_bytes"] == 8 * GB
    assert st["tiers"]["DEVICE"]["used_bytes"] == 8 * GB
    assert st["tiers"]["HOST_RAM"]["pinned_bytes"] == 0
    assert st["tiers"]["HOST_RAM"]["entries"] == 1


def test_store_unpinned_victims_still_evicted():
    s = ContextStore(device_bytes=10 * GB)
    s.pin("a")
    s.admit("a", Tier.DEVICE, 4 * GB, now=1.0)
    s.admit("b", Tier.DEVICE, 4 * GB, now=2.0)
    assert s.admit("c", Tier.DEVICE, 4 * GB, now=3.0) == ["b"]
    assert s.has("a", Tier.DEVICE) and s.has("c", Tier.DEVICE)


def test_store_readmission_replaces_not_double_counts():
    s = ContextStore(device_bytes=10 * GB)
    s.admit("a", Tier.DEVICE, 8 * GB, now=1.0)
    assert s.admit("a", Tier.DEVICE, 8 * GB, now=2.0) == []
    assert s.used(Tier.DEVICE) == 8 * GB


def test_store_oversized_is_tier_full():
    s = ContextStore(device_bytes=1 * GB)
    with pytest.raises(TierFullError):
        s.admit("big", Tier.DEVICE, 2 * GB)


# ------------------------------------------------------------ snapshot pool --
class FakeEngine:
    """Minimal offloadable component (the serving engine's duck-type),
    holding a tensor and a numpy array."""

    def __init__(self, n=1000):
        self.weights = torch.arange(n, dtype=torch.float64)
        self.ids = np.arange(7, dtype=np.int32)
        self.exe_cache = {"megastep": object()}   # survives the round trip

    def offload_device_state(self):
        state = {"weights": self.weights, "ids": self.ids}
        self.weights = self.ids = None
        return state

    def restore_device_state(self, host_state):
        self.weights, self.ids = host_state["weights"], host_state["ids"]


def _check_fake(eng):
    assert isinstance(eng, FakeEngine)
    assert torch.equal(eng.weights, torch.arange(1000, dtype=torch.float64))
    assert isinstance(eng.ids, np.ndarray) and eng.ids.dtype == np.int32
    assert "megastep" in eng.exe_cache            # metadata never left


def test_pool_demote_restore_roundtrip_plain_value():
    pool = SnapshotPool()
    builds = []
    rec = make_recipe("plain", lambda: builds.append(1) or {"v": 5})
    lib = Library("w0", snapshots=pool)
    lib.ensure(rec)
    assert lib.demote(rec.key()) is not None
    assert not lib.has(rec.key())
    assert pool.tier(rec.key()) == Tier.HOST_RAM
    ctx = lib.ensure(rec)
    assert ctx.value == {"v": 5} and ctx.restored
    assert builds == [1]
    assert lib.restores == 1 and lib.builder_calls == 1


@pytest.mark.parametrize("streamed", [False, True])
def test_pool_host_capacity_spills_lru_to_disk(tmp_path, streamed):
    pool = SnapshotPool(host_bytes=10_000, spill_dir=str(tmp_path))
    lib = Library("w0", snapshots=pool, streamed=streamed)
    r1 = make_recipe("e1", FakeEngine, host_bytes=0)
    r2 = make_recipe("e2", FakeEngine, host_bytes=0)
    lib.ensure(r1)
    lib.ensure(r2)
    lib.demote(r1.key())                      # 8028 B in host
    lib.demote(r2.key())                      # over 10k: r1 spills
    assert pool.tier(r1.key()) == Tier.LOCAL_DISK
    assert pool.tier(r2.key()) == Tier.HOST_RAM
    assert pool.stats()["spills"] == 1
    _check_fake(lib.ensure(r1).value)         # DISK -> resident
    assert not list(tmp_path.iterdir())       # the spill was consumed


def test_pool_explicit_spill_and_restore(tmp_path):
    pool = SnapshotPool(spill_dir=str(tmp_path))
    lib = Library("w0", snapshots=pool)
    rec = make_recipe("e", FakeEngine)
    lib.ensure(rec)
    lib.demote(rec.key())
    assert pool.spill(rec.key())
    assert pool.tier(rec.key()) == Tier.LOCAL_DISK
    _check_fake(lib.ensure(rec).value)


def test_pool_demote_without_pool_refuses_not_destroys():
    lib = Library("w0")
    builds = []
    rec = make_recipe("nopool", lambda: builds.append(1) or {"v": 1})
    lib.ensure(rec)
    assert lib.demote(rec.key()) is None
    assert lib.has(rec.key())
    lib.ensure(rec)
    assert builds == [1]


def test_pool_pinned_context_requires_force_demote():
    pool = SnapshotPool()
    lib = Library("w0", snapshots=pool)
    rec = make_recipe("pinned", lambda: {"v": 1})
    lib.ensure(rec)
    lib.pin(rec.key())
    assert lib.demote(rec.key()) is None
    assert lib.has(rec.key())
    assert lib.demote(rec.key(), force=True) is not None


# ------------------------------------------------- live manager and client --
@pytest.fixture
def manager():
    made = []

    def make(**kw):
        mgr = tcore.PCMManager(**kw)
        made.append(mgr)
        return mgr

    yield make
    for mgr in made:
        mgr.shutdown()


def test_live_full_mode_amortizes_builds(manager):
    builds = []
    mgr = manager(mode=tcore.ContextMode.FULL, n_workers=2)
    rec = make_recipe("ctx", lambda: builds.append(1) or {"m": 7})

    @tcore.context_app(recipe=rec, manager=mgr)
    def f(x):
        return tcore.load_context("m") + x

    assert [f(i).result(timeout=30) for i in range(8)] == \
        [7 + i for i in range(8)]
    assert len(builds) <= 2
    assert mgr.stats()["warm_invocations"] >= 6


def test_live_preemption_requeues_and_completes(manager):
    mgr = manager(mode=tcore.ContextMode.FULL, n_workers=2)
    rec = make_recipe("ctx2", lambda: {"m": 1})

    @tcore.context_app(recipe=rec, manager=mgr)
    def f(x):
        return x * 2

    futs = [f(i) for i in range(5)]
    mgr.preempt_worker(next(iter(mgr.workers)))
    mgr.add_worker()
    assert [fu.result(timeout=30) for fu in futs] == [0, 2, 4, 6, 8]


def test_live_errors_reach_the_future(manager):
    import threading
    mgr = manager(mode=tcore.ContextMode.FULL, n_workers=1)

    @tcore.context_app(manager=mgr)
    def bad():
        raise ValueError("boom")

    with pytest.raises(ValueError):
        bad().result(timeout=30)
    gate = threading.Event()
    try:
        mgr.scheduler.max_attempts = 2
        fut = mgr.submit(lambda: gate.wait(10))
        mgr.preempt_worker(next(iter(mgr.workers)))      # attempt 1
        mgr.preempt_worker(mgr.add_worker())              # attempt 2
        with pytest.raises(RuntimeError, match="2 attempt"):
            fut.result()
    finally:
        gate.set()


def test_client_map_gather_and_as_completed(manager):
    client = tcore.PCMClient(backend=manager(n_workers=2))
    ctx = client.context(lambda: {"m": 10}, name="ctx")

    def f(x):
        return tcore.load_context("m") + x

    batch = client.map(f, list(range(8)), context=ctx)
    assert batch.gather(timeout=30) == [10 + i for i in range(8)]
    assert batch.done and batch.done_count == 8
    seen = [fut.result() for fut in
            client.map(f, [1, 2, 3], context=ctx).as_completed(timeout=30)]
    assert sorted(seen) == [11, 12, 13]
    assert client.map(lambda xs: sum(xs), list(range(10)),
                      batch_size=4).gather(timeout=30) == [6, 22, 17]


def test_client_multi_context_qualified_load(manager):
    client = tcore.PCMClient(backend=manager(n_workers=1))
    verify = client.context(lambda: {"engine": "V"}, name="verify")
    rank = client.context(lambda: {"engine": "R"}, name="rank")

    @client.task(contexts={"verify": verify, "rank": rank})
    def pipeline(x):
        return (tcore.load_context("verify.engine"),
                tcore.load_context("rank.engine"), x)

    assert pipeline(3).result(timeout=30) == ("V", "R", 3)

    @client.task(contexts={"verify": verify, "rank": rank})
    def ambiguous():
        return tcore.load_context("engine")

    with pytest.raises(KeyError, match="ambiguous"):
        ambiguous().result(timeout=30)


def test_client_pins_warm_up_and_demote(manager):
    agnostic = tcore.PCMClient(backend=manager(
        mode=tcore.ContextMode.AGNOSTIC, n_workers=1))
    builds = []
    ctx = agnostic.context(lambda: builds.append(1) or {"m": 1},
                           name="pinned")
    with ctx:
        for _ in range(3):
            assert agnostic.submit(lambda: tcore.load_context("m"),
                                   context=ctx).result(timeout=30) == 1
    assert len(builds) == 1                   # survived agnostic cleanup

    client = tcore.PCMClient(backend=manager(n_workers=2))
    ctx = client.context(lambda: {"m": 1}, name="warm")
    assert all(t == Tier.SHARED_FS for t in ctx.residency().values())
    assert len(ctx.warm_up()) == 2
    assert ctx.resident_workers(Tier.DEVICE) == client.workers
    client.submit(lambda: tcore.load_context("m"), context=ctx).result(30)
    assert client.stats()["cold_invocations"] == 0

    client = tcore.PCMClient(backend=manager(n_workers=1))
    builds = []
    ctx = client.context(lambda: builds.append(1) or {"m": 9}, name="d")
    ctx.warm_up()
    assert ctx.demote(Tier.HOST_RAM)
    assert ctx.snapshot_tier() == Tier.HOST_RAM
    assert all(t == Tier.HOST_RAM for t in ctx.residency().values())
    assert client.submit(lambda: tcore.load_context("m"),
                         context=ctx).result(timeout=30) == 9
    assert builds == [1] and client.stats()["context_restores"] == 1


def test_unported_entry_points_name_their_slice(manager):
    """Every entry point of the reference's client is ported: the socket
    transport, the front door and the simulator backend."""
    mgr = manager(n_workers=1)
    assert isinstance(mgr, tcore.ExecutionBackend)
    # the socket transport is ported: listen() opens it
    addr = mgr.listen()
    assert mgr.address == addr and addr[1] > 0
    from repro_torch.serving import FrontDoor
    assert isinstance(tcore.PCMClient(backend=mgr).frontdoor(), FrontDoor)
    assert isinstance(tcore.SimulatorBackend(n_workers=1),
                      tcore.ExecutionBackend)


def test_elastic_runner_follows_a_capacity_callable(manager):
    mgr = manager(n_workers=0)
    cap = {"slots": ["h100", "h100"]}
    runner = tcore.ElasticRunner(mgr, lambda t: list(cap["slots"]),
                                 reconcile_every=1e9)
    runner.step(0.0)
    assert len(mgr.workers) == 2 and runner.joins == 2
    assert mgr.submit(lambda: 7).result(timeout=30) == 7
    cap["slots"] = ["h100"]                    # the cluster reclaims one
    runner.step(1.0)
    assert len(mgr.workers) == 1 and runner.preemptions == 1
    assert mgr.submit(lambda: 8).result(timeout=30) == 8
    assert [d.kind for d in runner.events] == ["join", "join", "leave"]
