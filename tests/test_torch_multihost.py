"""Multi-host PCM in the port: worker node processes
(``python -m repro_torch.cluster.node --device cpu``) joined to a
``PCMManager.listen()`` socket over loopback, serving the reduced
smollm2-1.7b engine built from a checkpoint the reference's
``CheckpointManager`` wrote. Against the JAX ``InferenceEngine`` on the
same weights and prompts, for megastep K in {1, 4}: a node's greedy
tokens, a second node's after a PEER bootstrap over the socket (striped
verified chunks, zero builder calls, zero builds), and the requeued
tasks' after ``kill -9`` of the donor; the FetchSource sequence of that
run against the reference scheduler's on the same join/task/leave
events; ``ElasticRunner(spawn_remote=True)`` joining and retiring a node;
and a node refusing to start without its card.

Every wait has a timeout and every child is killed in a ``finally``, so a
hang fails one test instead of the suite. Recipes and tasks live in
``torch_multihost_helpers`` (pickled by reference into the nodes)."""

import collections
import os
import signal
import time
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import torch_multihost_helpers as H  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro.checkpoint import CheckpointManager as JaxCheckpoints  # noqa
from repro.configs import get_reduced_config as jax_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serving import InferenceEngine as JaxEngine  # noqa: E402
from repro_torch.cluster import node  # noqa: E402
from repro_torch.core import (ContextMode, ElasticRunner,  # noqa: E402
                              FetchSource, PCMManager)

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
MAX_NEW = 6


def _wait(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def _spawn(addr, wid):
    return node.spawn_node_process(addr, wid, extra_path=(TESTS_DIR,),
                                   device="cpu", heartbeat=0.2)


def _teardown(mgr, procs):
    try:
        mgr.shutdown(timeout=20)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait(timeout=20)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reduced smollm2-1.7b weights from PRNGKey(0), written by the
    reference's CheckpointManager, and the JAX engine's greedy tokens on
    two prompts for K in {1, 4}."""
    cfg = jax_config("smollm2-1.7b")
    model = jax_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    ckpt = str(tmp_path_factory.mktemp("mh_ckpt"))
    JaxCheckpoints(ckpt).save(0, params)
    rng = np.random.RandomState(0)
    prompts = [list(map(int, rng.randint(8, cfg.vocab_size,
                                         size=rng.randint(3, 12))))
               for _ in range(2)]
    want = {k: JaxEngine(model, params, megastep=k, **H.ENGINE).generate(
        prompts, max_new_tokens=MAX_NEW) for k in (1, 4)}
    return ckpt, prompts, want


@pytest.fixture(scope="module", params=[1, 4], ids=lambda k: f"K{k}")
def peer_run(request, reference):
    """One multi-process run at megastep K: node A joins and serves a task
    (a cold invocation); node B joins cold and six slow tasks arrive, so B
    bootstraps the context from A by PEER over the socket while A serves;
    then six more slow tasks, and A is killed with SIGKILL while it runs
    one of them, so its task requeues to B."""
    ckpt, prompts, _ = reference
    k = request.param
    rec = H.engine_recipe(ckpt, k)
    mgr = PCMManager(mode=ContextMode.FULL, n_workers=0,
                     chunk_bytes=32 << 10)
    procs = {}
    run = types.SimpleNamespace(recipe=rec, k=k)
    try:
        addr = mgr.listen(heartbeat=0.2, lost_after=10.0)
        procs["A"] = _spawn(addr, "A")
        mgr.wait_for_workers(["A"], timeout=120)
        run.first = mgr.submit(H.generate_task, args=(prompts, MAX_NEW),
                               recipe=rec).result(timeout=120)
        procs["B"] = _spawn(addr, "B")
        mgr.wait_for_workers(["B"], timeout=120)
        futs = [mgr.submit(H.generate_task, args=(prompts, MAX_NEW, 0.3),
                           recipe=rec) for _ in range(6)]
        run.shared = [f.result(timeout=120) for f in futs]
        assert _wait(lambda: not mgr._stripes, timeout=30)
        run.history = [(d.worker_id, d.source, d.donor)
                       for d in mgr.fetch_history(rec)]
        mirror = mgr.workers["B"].library
        run.b_builder_calls = mirror.builder_calls
        run.b_peer_installs = mirror.peer_installs
        run.striping = dict(mgr.stats()["striping"])

        futs = [mgr.submit(H.generate_task, args=(prompts, MAX_NEW, 0.2),
                           recipe=rec) for _ in range(6)]

        def a_running():
            with mgr._lock:
                return any(e[0] == "A"
                           for e in mgr.scheduler.running.values())

        assert _wait(a_running, timeout=60), "A never ran a task"
        os.kill(procs["A"].pid, signal.SIGKILL)
        run.after_kill = [f.result(timeout=120) for f in futs]
        run.attempts = [mgr.lookup_task(f.task_id).attempts for f in futs]
        run.a_left = "A" not in mgr.workers
        run.pids = {w: p.pid for w, p in procs.items()}
    finally:
        _teardown(mgr, procs.values())
    return run


def test_node_tokens_match_reference(peer_run, reference):
    """Node A's greedy tokens, and both nodes' while B bootstraps, equal
    the JAX engine's."""
    _, _, want = reference
    out, pid, stats = peer_run.first
    assert out == want[peer_run.k] and pid == peer_run.pids["A"]
    assert stats["compiles"] == 0
    assert all(r[0] == want[peer_run.k] for r in peer_run.shared)


def test_peer_bootstrap_over_the_socket(peer_run):
    """B's context came from A by PEER, striped in verified chunks over the
    socket: no builder call on B and no build."""
    assert peer_run.history == [("B", FetchSource.PEER, "A")]
    assert peer_run.b_builder_calls == 0 and peer_run.b_peer_installs == 1
    assert peer_run.striping["stripes"] == 1
    assert peer_run.striping["chunks"] > 1
    assert peer_run.striping["lane_failures"] == 0
    b_stats = [r[2] for r in peer_run.shared + peer_run.after_kill
               if r[1] == peer_run.pids["B"]]
    assert b_stats and all(s["compiles"] == 0 for s in b_stats)


def test_kill9_of_the_donor_requeues_to_the_survivor(peer_run, reference):
    """SIGKILL of A while it runs a task: EOF takes the preemption path, A
    leaves the pool, its task requeues and B — serving the context it
    took by PEER — finishes every task with the reference's tokens."""
    _, _, want = reference
    assert peer_run.a_left
    assert max(peer_run.attempts) >= 1
    assert all(r[0] == want[peer_run.k] for r in peer_run.after_kill)
    assert {r[1] for r in peer_run.after_kill} == {peer_run.pids["B"]}


def test_fetch_sources_match_reference_scheduler(peer_run):
    """The remote run's FetchSource sequence equals the reference
    ContextAwareScheduler's for the same events, driven in-process: A
    joins over the socket and runs the first task cold, B joins over the
    socket, six tasks arrive, and A leaves while both serve."""
    P = jcore
    sched = P.ContextAwareScheduler(mode=P.ContextMode.FULL,
                                    planner=P.TransferPlanner())
    recipe = P.ContextRecipe(name=peer_run.recipe.name)
    clock = [0.0]
    pending = collections.deque()

    def feed(acts):
        pending.extend(a for a in acts if a.kind != "cancel")

    def tick(n):
        for _ in range(n):
            if not pending:
                return
            a = pending.popleft()
            clock[0] += 1.0
            if a.worker_id not in sched.workers:
                continue
            if a.kind == "fetch":
                sched.planner.complete(a.plan, clock[0])
                feed(sched.on_fetch_done(a.worker_id, a.recipe.key(),
                                         clock[0]))
            else:
                feed(sched.on_task_done(a.worker_id, a.task_id, clock[0]))

    feed(sched.on_worker_join("A", clock[0], store=P.ContextStore(),
                              transport_kind="socket"))
    feed(sched.submit(P.Task(task_id="t0", recipes=(recipe,)), clock[0]))
    tick(1)
    feed(sched.on_worker_join("B", clock[0], store=P.ContextStore(),
                              transport_kind="socket"))
    for i in range(1, 7):
        feed(sched.submit(P.Task(task_id=f"t{i}", recipes=(recipe,)),
                          clock[0]))
    tick(3)
    feed(sched.on_worker_leave("A", clock[0]))
    tick(100)
    assert sched.outstanding == 0
    want = [(d.worker_id, d.source.name, d.donor) for d in sched.fetch_log]
    got = [(w, s.name, d) for w, s, d in peer_run.history]
    assert got == want == [("B", "PEER", "A")]


def test_elastic_runner_joins_and_retires_a_node(reference):
    """A capacity rise spawns a node process; reclaim retires it through
    the preemption path (its context demotes over the wire into the
    manager's pool, the process exits on the BYE handshake); the next
    rise restores a fresh node from that pool with no builder call."""
    ckpt, prompts, want = reference
    rec = H.engine_recipe(ckpt, 4, name="mh-elastic")
    mgr = PCMManager(mode=ContextMode.FULL, n_workers=0)
    capacity = {"n": 1}
    runner = ElasticRunner(
        mgr, lambda t: ["gpu"] * capacity["n"], spawn_remote=True,
        name_prefix="en", node_kwargs={"extra_path": (TESTS_DIR,),
                                       "device": "cpu", "heartbeat": 0.2})
    procs = []
    try:
        mgr.listen(heartbeat=0.2)
        runner.step()
        (wid1, proc1), = runner.procs.items()
        procs.append(proc1)
        mgr.wait_for_workers([wid1], timeout=120)
        out, pid, _ = mgr.submit(H.generate_task, args=(prompts,),
                                 recipe=rec).result(timeout=120)
        assert out == want[4] and pid == proc1.pid

        capacity["n"] = 0
        runner.step()
        assert _wait(lambda: wid1 not in mgr.workers)
        assert _wait(lambda: rec.key() in mgr.snapshots.keys())
        assert proc1.wait(timeout=30) == 0

        capacity["n"] = 1
        runner.step()
        (wid2, proc2), = runner.procs.items()
        procs.append(proc2)
        assert wid2 != wid1
        mgr.wait_for_workers([wid2], timeout=120)
        out, pid, stats = mgr.submit(H.generate_task, args=(prompts,),
                                     recipe=rec).result(timeout=120)
        assert out == want[4] and pid == proc2.pid
        assert stats["compiles"] == 0
        mirror = mgr.workers[wid2].library
        assert mirror.builder_calls == 0 and mirror.restores == 1
        assert [s.name for s in mirror.fetch_sources] == ["POOL"]
        assert runner.stats()["preemptions"] == 1
    finally:
        runner.stop()
        _teardown(mgr, procs)


def test_node_without_its_card_does_not_join(monkeypatch):
    """A node asked for the card on a machine without one raises before it
    dials the manager: it never serves on the CPU by default."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        node.run(["--connect", "127.0.0.1:9", "--worker-id", "w0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        node.WorkerHost("w0")
