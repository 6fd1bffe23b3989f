"""The port's cluster model against the JAX reference's: the event loop
(ties included), every capacity trace, ``simulate_sweep`` over four traces
in FULL and PARTIAL mode (the same ``SimResult`` float for float), the
``SimulatorBackend`` behind a PCMClient (the same ``SimTaskResult``s and
fetch decisions), the modeled node pool across preemptions, the live and
simulated policy parity of tests/test_elastic.py, and an ElasticRunner
driven by a trace (tests/test_cluster_sim.py and the trace, sim-pool and
parity cases of tests/test_elastic.py)."""

import dataclasses
import time

import pytest

torch = pytest.importorskip("torch")

import repro.cluster as jcl  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro_torch.cluster as tcl  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.cluster import traces  # noqa: E402
from repro_torch.cluster.devices import PROFILES  # noqa: E402
from repro_torch.cluster.simulator import ClusterSimulator  # noqa: E402
from repro_torch.core import (ContextMode, ElasticRunner,  # noqa: E402
                              FetchSource, PCMClient, PCMManager,
                              SimulatorBackend, Tier, load_context,
                              make_recipe)
from repro_torch.core.context import GB  # noqa: E402

RECIPE = tcore.ContextRecipe(name="smollm2-pff")
JRECIPE = jcore.ContextRecipe(name="smollm2-pff")


# ------------------------------------------------------------ event loop --
def _script(cl):
    """Events at 1.0 (three tied, one cancelled), a callback that schedules
    a tie at its own time and one in the past, a run bounded by ``until``
    and then the rest."""
    loop, seen = cl.EventLoop(), []

    def at(label, then=None):
        def fn():
            seen.append((label, loop.now))
            if then:
                then()
        return fn

    loop.schedule(2.0, at("b"))
    loop.schedule(1.0, at("a0", lambda: (
        loop.schedule_in(0.0, at("a0-tie")),
        loop.schedule(0.5, at("past")))))
    loop.schedule(1.0, at("a1")).cancel()
    loop.schedule(1.0, at("a2"))
    loop.schedule(5.0, at("late"))
    for i in range(4):
        loop.schedule(3.0, at(f"t{i}"))
    loop.run(until=3.0)
    mid = (list(seen), loop.now, loop.processed, loop.empty)
    loop.run()
    return mid, seen, loop.now, loop.processed, loop.empty


def test_event_loop_order_matches_reference():
    got, want = _script(tcl), _script(jcl)
    assert got == want
    (mid, seen, now, processed, empty) = got
    assert [s for s, _ in mid[0]] == ["a0", "a2", "a0-tie", "past", "b",
                                      "t0", "t1", "t2", "t3"]
    assert seen[-1] == ("late", 5.0) and now == 5.0 and empty
    assert processed == 10


def test_event_loop_run_one_skips_cancelled():
    loop, seen = tcl.EventLoop(), []
    loop.schedule(1.0, lambda: seen.append(1)).cancel()
    loop.schedule(2.0, lambda: seen.append(2))
    assert loop.run_one() and seen == [2] and loop.now == 2.0
    assert not loop.run_one() and loop.empty


# ---------------------------------------------------------------- traces --
TRACES = {
    "static": ("static", {}),
    "static-h100": ("static", {"profiles": ["h100"] * 3}),
    "rq3": ("rq3_aggressive_preemption", {}),
    "rq3-floor": ("rq3_aggressive_preemption",
                  {"start_at": 1.0, "period": 1.0, "floor": 1,
                   "pool": ["a10", "a10", "titan-x-pascal"]}),
    "rq4-low": ("rq4_low_capacity", {}),
    "rq4-low-ramp": ("rq4_low_capacity",
                     {"ramp_every": 100.0, "start": 2, "cap": 6}),
    "rq4-high": ("rq4_high_capacity", {}),
    "rq4-high-60": ("rq4_high_capacity", {"peak": 60,
                                          "ramp_seconds": 100.0}),
    "churn": ("churn", {}),
    "churn-small": ("churn", {"base": 8, "amplitude": 6, "period": 90.0}),
}
GRID = [0.0, 0.5, 1.0, 2.0, 37.3, 99.9, 100.0, 123.4, 240.0, 419.0,
        900.0, 901.0, 960.5, 999.9, 1500.0, 2222.2, 5000.0]


@pytest.mark.parametrize("name", sorted(TRACES))
def test_trace_capacity_matches_reference(name):
    fn, kw = TRACES[name]
    got = getattr(traces, fn)(**kw)
    want = getattr(jcl.traces, fn)(**kw)
    assert [got(t) for t in GRID] == [want(t) for t in GRID]
    assert all(p in PROFILES for t in GRID for p in got(t))


def test_trace_shapes():
    """tests/test_elastic.py::TestTraces on the port's traces."""
    cap = traces.rq3_aggressive_preemption(start_at=100.0, period=10.0)
    sizes = [len(cap(t)) for t in range(0, 400, 5)]
    assert sizes[0] == 20 and sizes[-1] == 0
    assert all(a >= b for a, b in zip(sizes, sizes[1:]))
    mid = cap(100.0 + 10.0 * 4.5)
    assert mid.count("a10") == 5 and mid.count("titan-x-pascal") == 10
    cap = traces.rq4_low_capacity(ramp_every=100.0, start=4, cap=20)
    sizes = [len(cap(t)) for t in range(0, 3000, 50)]
    assert sizes[0] == 4 and sizes[-1] == 20 == max(sizes)
    assert all(a <= b for a, b in zip(sizes, sizes[1:]))


# ---------------------------------------------------------- sweep parity --
# (trace, total inferences, batch size, until): the rq3 pool depletes at
# 700 s, with work left, so its run is bounded
SWEEPS = {
    "static": (lambda tr: tr.static(), 4_000, 50, 1e7),
    "rq3": (lambda tr: tr.rq3_aggressive_preemption(start_at=100.0,
                                                    period=30.0),
            40_000, 100, 1_000.0),
    "rq4-low": (lambda tr: tr.rq4_low_capacity(ramp_every=60.0), 4_000, 50,
                1e7),
    "churn": (lambda tr: tr.churn(base=8, amplitude=6, period=120.0),
              4_000, 50, 1e7),
}


def _sweep(cl, core, trace, mode, total, bs, until, recipe):
    return cl.simulate_sweep(getattr(core.ContextMode, mode),
                             trace(cl.traces), recipe, total, bs,
                             until=until)


@pytest.mark.parametrize("mode", ["FULL", "PARTIAL"])
@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_simulate_sweep_matches_reference(name, mode):
    trace, total, bs, until = SWEEPS[name]
    got = _sweep(tcl, tcore, trace, mode, total, bs, until, RECIPE)
    want = _sweep(jcl, jcore, trace, mode, total, bs, until, JRECIPE)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.curve(30.0) == want.curve(30.0)
    assert got.total_inferences == want.total_inferences > 0
    if name != "rq3":
        assert got.total_inferences == total
    else:
        assert got.preemptions == 20 and got.total_inferences < total


def test_sweep_rq1_ordering_and_determinism():
    """tests/test_cluster_sim.py's RQ1 shape on the port: full < partial <
    agnostic, each run deterministic."""
    ends = {m: tcl.simulate_sweep(m, traces.static(), RECIPE, 4_000,
                                  100).end_time for m in ContextMode}
    assert ends[ContextMode.FULL] < ends[ContextMode.PARTIAL] \
        < ends[ContextMode.AGNOSTIC]
    again = tcl.simulate_sweep(ContextMode.FULL, traces.static(), RECIPE,
                               4_000, 100)
    assert again.end_time == ends[ContextMode.FULL]


def _preempt_then_rejoin(t):
    if t < 50:
        return ["a10", "a10"]
    if t < 100:
        return ["a10"]
    return ["a10", "a10"]


def test_cluster_simulator_node_pool():
    """tests/test_cluster_sim.py::TestSimNodePool: a preempted worker's
    context survives in the modeled pool, the rejoining worker takes the
    POOL rung, and the promotion consumes the single-owner entry."""
    sim = ClusterSimulator(ContextMode.FULL, _preempt_then_rejoin, RECIPE,
                           reconcile_every=10.0)
    sim.submit_sweep(2_000, 50)
    sim._reconcile()
    sim.loop.run(until=60.0)
    assert sim._node_pool.get(RECIPE.key()) is not None
    r = sim.run()
    assert r.total_inferences == 2_000 and r.preemptions == 1
    assert r.pool_restores >= 1
    assert any(d.source == FetchSource.POOL for d in sim.scheduler.fetch_log)
    assert RECIPE.key() not in sim._node_pool
    want = jcl.simulate_sweep(jcore.ContextMode.FULL, _preempt_then_rejoin,
                              JRECIPE, 2_000, 50)
    got = tcl.simulate_sweep(ContextMode.FULL, _preempt_then_rejoin, RECIPE,
                             2_000, 50)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ----------------------------------------------------- simulator backend --
def _fetch_log(log):
    return [(d.worker_id, d.key, d.source.name, d.donor,
             d.degraded_from.name if d.degraded_from else None, d.t)
            for d in log]


def _drive_backend(core, capacity_fn, n_workers):
    """One application on a SimulatorBackend: warm a context, map tasks,
    preempt a worker, demote, submit more, and read every result."""
    backend = core.SimulatorBackend(n_workers=n_workers,
                                    capacity_fn=capacity_fn,
                                    profile="h100", reconcile_every=5.0)
    client = core.PCMClient(backend=backend)
    h = client.context(core.ContextRecipe(name="parity",
                                          device_bytes=4 * GB,
                                          host_bytes=4 * GB))
    h.warm_up(worker_ids=sorted(backend.scheduler.workers)[:1])
    futs = [client.submit(lambda x: x, i, context=h, n_items=20)
            for i in range(12)]
    futs[3].result()
    victim = sorted(backend.scheduler.workers)[0]
    backend.preempt_worker(victim)
    if capacity_fn is None:
        backend.add_worker("h100")
    futs += [client.submit(lambda x: x, i, context=h, n_items=5,
                           priority=i % 2) for i in range(6)]
    backend.demote_context(h.recipe, Tier.HOST_RAM)
    futs += [client.submit(lambda: None, context=h) for _ in range(3)]
    results = [dataclasses.asdict(f.result()) for f in futs]
    return (results, _fetch_log(backend.fetch_history()), backend.stats(),
            backend.now)


@pytest.mark.parametrize("capacity", ["static", "rq3"])
def test_simulator_backend_matches_reference(capacity):
    def cap(tr):
        if capacity == "static":
            return None
        return tr.rq3_aggressive_preemption(
            start_at=30.0, period=20.0, pool=["h100", "a10", "a10"], floor=1)

    got = _drive_backend(tcore, cap(traces), 3)
    want = _drive_backend(jcore, cap(jcl.traces), 3)
    assert got == want
    results, fetches, stats, _ = got
    assert len(results) == 21 and fetches
    assert stats["preemptions"] >= 1


def test_sim_preemption_demotes_to_modeled_pool():
    """tests/test_elastic.py::TestSimNodePool on the port's backend."""
    backend = SimulatorBackend(n_workers=2, donor_wait=False)
    assert isinstance(backend, tcore.ExecutionBackend)
    assert backend.concurrent is False
    client = PCMClient(backend=backend)
    h = client.context(tcore.ContextRecipe(name="np"))
    h.warm_up()
    victim = next(iter(backend.scheduler.workers))
    backend.preempt_worker(victim)
    assert backend.scheduler.pool_tier(h.recipe.key()) == Tier.HOST_RAM
    for wid in list(backend.scheduler.workers):
        backend.preempt_worker(wid)
    backend.add_worker()
    res = client.submit(lambda: None, context=h).result()
    assert isinstance(res, tcore.SimTaskResult)
    assert backend.stats()["pool_restores"] >= 1
    assert backend.scheduler.pool_tier(h.recipe.key()) is None

    backend = SimulatorBackend(n_workers=1)
    client = PCMClient(backend=backend)
    h = client.context(tcore.ContextRecipe(name="hp"))
    h.warm_up()
    backend.demote_context(h.recipe, Tier.HOST_RAM)
    assert backend.scheduler.pool_tier(h.recipe.key()) == Tier.HOST_RAM
    client.submit(lambda: None, context=h).result()
    assert backend.scheduler.pool_tier(h.recipe.key()) is None
    with pytest.raises(ValueError, match="demotion target"):
        backend.demote_context(h.recipe, Tier.DEVICE)


def test_sim_stall_raises_instead_of_hanging():
    backend = SimulatorBackend(n_workers=1)
    client = PCMClient(backend=backend)
    h = client.context(tcore.ContextRecipe(name="stall"))
    backend.preempt_worker(next(iter(backend.scheduler.workers)))
    fut = client.submit(lambda: None, context=h)
    with pytest.raises(RuntimeError, match="stalled"):
        fut.result()
    with pytest.raises(TimeoutError):
        fut.result(timeout=0.05)


# -------------------------------------------------------- policy parity ----
def _storm_trace(t: float):
    return ["a10"] * (2 if t < 5.0 else 10)


def test_live_and_sim_fetch_decisions_match():
    """tests/test_elastic.py::TestPolicyParity on the port: the port's live
    PCMManager and the port's SimulatorBackend, driven by the same trace
    and policy, give every joiner the same FetchSource sequence — and the
    port's simulator gives the reference simulator's."""
    rec = make_recipe("parity", lambda: {"v": 1})
    mgr = PCMManager(mode=ContextMode.FULL, n_workers=0, donor_wait=True)
    try:
        runner = ElasticRunner(mgr, _storm_trace, reconcile_every=1e9)
        runner.step(0.0)
        mgr.warm_up(rec)
        futs = [mgr.submit(lambda: time.sleep(0.05) or load_context("v"),
                           recipe=rec) for _ in range(32)]
        runner.step(10.0)
        assert all(f.result(timeout=120) == 1 for f in futs)
        mgr.run_until_idle(timeout=60)
        live = {}
        for d in mgr.scheduler.fetch_log:
            live.setdefault(d.worker_id, []).append(d.source)
    finally:
        mgr.shutdown()

    def sim(core, r):
        backend = core.SimulatorBackend(capacity_fn=_storm_trace,
                                        donor_wait=True, reconcile_every=5.0)
        client = core.PCMClient(backend=backend)
        h = client.context(r)
        h.warm_up()
        for f in [client.submit(lambda x: x, i, context=h, n_items=40)
                  for i in range(32)]:
            f.result()
        return backend.scheduler.fetch_log

    log = sim(tcore, rec)
    jlog = sim(jcore, jcore.make_recipe("parity", lambda: {"v": 1}))
    simulated = {}
    for d in log:
        simulated.setdefault(d.worker_id, []).append(d.source)
    assert live == simulated
    assert len(live) == 8
    assert all(v == [FetchSource.PEER] for v in live.values())
    # the recipes' keys differ (their builders are two lambdas)
    assert [f[:1] + f[2:] for f in _fetch_log(log)] == \
        [f[:1] + f[2:] for f in _fetch_log(jlog)]


# ------------------------------------------------------ elastic runner ----
def test_elastic_runner_follows_rq3_trace_with_profiles():
    """An ElasticRunner driven by ``traces.rq3_aggressive_preemption``
    joins the trace's workers with their DeviceProfiles and preempts the
    A10 first; its directives are the reference factory's."""
    kw = dict(start_at=1.0, period=1.0, pool=["a10", "titan-x-pascal"],
              floor=1)
    mgr = PCMManager(mode=ContextMode.FULL, n_workers=0)
    runner = ElasticRunner(mgr, traces.rq3_aggressive_preemption(**kw),
                           reconcile_every=1e9)
    try:
        runner.step(0.0)
        infos = mgr.scheduler.workers
        assert sorted(i.profile.name for i in infos.values()) == [
            "a10", "titan-x-pascal"]
        a10 = next(w for w, i in infos.items() if i.profile.name == "a10")
        assert mgr.workers[a10].store.capacity[Tier.DEVICE] == \
            int(PROFILES["a10"].hbm_gb * GB)
        assert mgr.submit(lambda: 7).result(timeout=30) == 7
        runner.step(1.0)
        assert list(mgr.workers) == [w for w in infos if w != a10]
        assert runner.preemptions == 1 and runner.joins == 2
        assert mgr.submit(lambda: 8).result(timeout=30) == 8
        runner.step(50.0)                      # the floor keeps one slot
        assert len(mgr.workers) == 1
    finally:
        mgr.shutdown()
    jfactory = jcore.WorkerFactory(jcl.traces.rq3_aggressive_preemption(**kw))
    want = [dataclasses.astuple(d) for t in (0.0, 1.0, 50.0)
            for d in jfactory.reconcile(t)]
    assert [dataclasses.astuple(d) for d in runner.events] == want
