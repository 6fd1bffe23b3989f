"""Engines that share one model module: a demote never changes a tensor
another resident engine reads (``InferenceEngine.offload_device_state``).

A context builder that closes over one model (the examples' builders do)
wraps every worker's engine around the same parameters. The last
resident engine over a model releases them in place when it is demoted;
any other copies them to the host and moves onto a model shell of its
own, so the engines still serving keep decoding as the JAX engines do on
the same bridged weights (reduced smollm2-1.7b, f32, CPU), and the
demoted engine continues bit for bit once restored. A released model
keeps the snapshot's host copies, so the builder goes on working once
every engine over it is demoted, as the reference's does."""

import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced_config as jax_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serving import InferenceEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.core import (ContextMode, PCMManager,  # noqa: E402
                              load_context, make_recipe)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import InferenceEngine, Request  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

SLOT = dict(slots=4, cache_len=64, prefill_buckets=(16, 32), megastep=4)
PAGED = dict(SLOT, paged=True, page_size=8, prefix_sharing=False)
NEW = 9


@pytest.fixture(scope="module")
def bridged():
    jcfg = jax_config("smollm2-1.7b")
    jmodel = jax_build(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, params, from_jax_params(
        jax.device_get(params), get_reduced_config("smollm2-1.7b"), "cpu")


def prompts(n, seed):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(8, 512, size=rng.randint(3, 14)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def jax_tokens(bridged):
    jmodel, params, _ = bridged
    return {name: JaxEngine(jmodel, params, **kw).generate(
                prompts(7, seed=11), max_new_tokens=NEW)
            for name, kw in (("slot", SLOT), ("paged", PAGED))}


def fresh_model(bridged):
    """A port model over a copy of the bridged weights (a test that
    releases them must not release the module fixture's)."""
    return build_model(get_reduced_config("smollm2-1.7b"), device="cpu",
                       params={n: t.clone() for n, t in bridged[2].items()})


def engine(model, kw):
    return InferenceEngine(model, device="cpu", **kw)


def in_flight(eng, ps):
    reqs = [eng.submit(Request(prompt=list(p), max_new_tokens=NEW))
            for p in ps]
    eng.step()
    assert eng.active and eng.queue, "nothing in flight — test is vacuous"
    return reqs


@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_demote_leaves_the_other_engine_serving(bridged, jax_tokens, kind):
    """Two engines over one model: demoting one mid-stream leaves the
    model's tensors as they were; the other's greedy tokens equal the
    JAX engine's; the demoted one, restored into its own shell,
    continues bit for bit."""
    kw = SLOT if kind == "slot" else PAGED
    model = fresh_model(bridged)
    before = {n: (p.data_ptr(), p.clone())
              for n, p in model.named_parameters()}
    a, b = engine(model, kw), engine(model, kw)
    ps = prompts(7, seed=11)
    reqs = in_flight(a, ps)
    host = a.offload_device_state()
    assert a.offloaded and a.model is not model and b.model is model
    for n, p in model.named_parameters():
        assert p.data_ptr() == before[n][0] and torch.equal(p, before[n][1])
    assert all(p.numel() == 0 for p in a.model.parameters())
    assert b.generate(ps, max_new_tokens=NEW) == jax_tokens[kind]
    a.restore_device_state(host)
    a.run_to_completion()
    assert [r.generated for r in reqs] == jax_tokens[kind]
    assert a.stats.compiles == 0
    # the restore is a second copy: the shared tensors stay the model's
    for n, p in a.model.named_parameters():
        assert p.data_ptr() != before[n][0] and torch.equal(p, before[n][1])
    assert b.generate(ps, max_new_tokens=NEW) == jax_tokens[kind]


def test_a_lone_engine_still_releases_its_parameters(bridged, jax_tokens):
    """The last resident engine over a model releases the parameters in
    place; an engine built over the released model brings them back from
    the snapshot's host copies (which the model kept, not a copy of
    them) and serves the JAX engine's tokens; the demoted engine, restored
    while that one is resident, fills a shell of its own and continues
    bit for bit."""
    model = fresh_model(bridged)
    want = {n: p.clone() for n, p in model.named_parameters()}
    a = engine(model, SLOT)
    ps = prompts(7, seed=11)
    reqs = in_flight(a, ps)
    host = a.offload_device_state()
    assert a.model is model
    assert all(p.numel() == 0 for p in model.parameters())
    kept = model._released_params
    assert all(kept[n] is host["params"][n] for n in want)
    b = engine(model, SLOT)
    assert "_released_params" not in model.__dict__
    for n, p in model.named_parameters():
        assert torch.equal(p, want[n]) and p.data_ptr() != \
            host["params"][n].data_ptr()
    assert b.generate(ps, max_new_tokens=NEW) == jax_tokens["slot"]
    a.restore_device_state(host)
    assert a.model is not model and b.model is model
    a.run_to_completion()
    assert [r.generated for r in reqs] == jax_tokens["slot"]
    for n, p in model.named_parameters():
        assert torch.equal(p, want[n])
    assert b.generate(ps, max_new_tokens=NEW) == jax_tokens["slot"]


def test_a_restore_with_no_engine_resident_fills_the_model(bridged,
                                                           jax_tokens):
    """An engine built over the released model and then demoted itself
    releases the model again; the first engine's restore then fills the
    model in place (no one reads it), and so does the second's into a
    shell: both continue bit for bit."""
    model = fresh_model(bridged)
    a = engine(model, SLOT)
    ps = prompts(7, seed=11)
    ra = in_flight(a, ps)
    ha = a.offload_device_state()
    b = engine(model, SLOT)
    rb = in_flight(b, ps)
    hb = b.offload_device_state()
    assert b.model is model and all(p.numel() == 0
                                    for p in model.parameters())
    a.restore_device_state(ha)
    assert a.model is model and "_released_params" not in model.__dict__
    b.restore_device_state(hb)
    assert b.model is not model
    a.run_to_completion()
    b.run_to_completion()
    assert [r.generated for r in ra] == jax_tokens["slot"]
    assert [r.generated for r in rb] == jax_tokens["slot"]


def test_builder_over_a_demoted_model_builds_in_the_runtime(bridged):
    """A live PCM manager whose context builder closes over one model:
    its only worker's engine is preempted into the snapshot pool (the last
    engine over the model, so the demote releases the parameters), the
    pool's copy is evicted, and a fresh worker's task is served by a
    builder call over the released model, which builds and gives a bare
    engine's first tokens."""
    model = fresh_model(bridged)
    ps = prompts(6, seed=21)
    bare = engine(fresh_model(bridged), SLOT).generate(ps, max_new_tokens=1)
    calls = []

    def build():
        calls.append(1)
        return {"engine": InferenceEngine(model, device="cpu", **SLOT)}

    def task():
        return load_context("engine").generate(ps, max_new_tokens=1)

    rec = make_recipe("released", build, host_bytes=0)
    mgr = PCMManager(mode=ContextMode.FULL, n_workers=1)
    try:
        assert mgr.submit(task, recipe=rec).result(timeout=120) == bare
        mgr.preempt_worker(next(iter(mgr.workers)))
        deadline = time.monotonic() + 60
        while rec.key() not in mgr.snapshots.keys():
            assert time.monotonic() < deadline, "the preempted context " \
                "never reached the snapshot pool"
            time.sleep(0.01)
        assert all(p.numel() == 0 for p in model.parameters())
        mgr.snapshots.discard(rec.key())
        mgr.add_worker()
        assert mgr.submit(task, recipe=rec).result(timeout=120) == bare
        assert calls == [1, 1]
        assert mgr.stats()["context_restores"] == 0
        assert all(p.numel() > 0 for p in model.parameters())
    finally:
        mgr.shutdown()


@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_demote_both_then_restore_both(bridged, jax_tokens, kind):
    """The first demote moves its engine onto a shell, the second (now
    the last resident) releases the model in place; both restores
    continue bit for bit, the first into its shell, the second into the
    model."""
    kw = SLOT if kind == "slot" else PAGED
    model = fresh_model(bridged)
    a, b = engine(model, kw), engine(model, kw)
    ps = prompts(7, seed=11)
    ra, rb = in_flight(a, ps), in_flight(b, ps)
    ha = a.offload_device_state()
    hb = b.offload_device_state()
    assert a.model is not model and b.model is model
    assert all(p.numel() == 0 for p in model.parameters())
    a.restore_device_state(ha)
    b.restore_device_state(hb)
    assert b.model is model
    a.run_to_completion()
    b.run_to_completion()
    assert [r.generated for r in ra] == jax_tokens[kind]
    assert [r.generated for r in rb] == jax_tokens[kind]


def test_concurrent_demotes_never_empty_a_tensor_being_copied(bridged):
    """Eight engines over one model demoted at once from eight threads,
    with a short switch interval: every snapshot holds the whole weights,
    exactly one engine (the last) released the model in place, and every
    engine decodes the same after its restore."""
    model = fresh_model(bridged)
    want = {n: p.clone() for n, p in model.named_parameters()}
    engines = [engine(model, SLOT) for _ in range(8)]
    ps = prompts(2, seed=3)
    ref = engines[0].generate(ps, max_new_tokens=3)
    hosts = [None] * len(engines)
    start = threading.Barrier(len(engines))

    def demote(i):
        start.wait(timeout=60)
        hosts[i] = engines[i].offload_device_state()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=demote, args=(i,))
                   for i in range(len(engines))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    for h in hosts:
        assert all(torch.equal(h["params"][n], want[n]) for n in want)
    assert sum(e.model is model for e in engines) == 1
    assert all(p.numel() == 0 for p in model.parameters())
    for e, h in zip(engines, hosts):
        e.restore_device_state(h)
        assert e.generate(ps, max_new_tokens=3) == ref



def test_a_build_in_flight_keeps_the_model(bridged, monkeypatch):
    """An engine being built over a model reads it from the start: a
    demote of the only other engine, made in the main thread while a
    second thread's build has joined the model but not yet made its
    cache, moves the demoted engine onto a shell and leaves the model
    whole. Then the built engine decodes as the demoted one did, and so
    does the demoted one once restored."""
    model = fresh_model(bridged)
    want = {n: p.clone() for n, p in model.named_parameters()}
    a = engine(model, SLOT)
    ps = prompts(2, seed=5)
    ref = a.generate(ps, max_new_tokens=3)
    building, demoted = threading.Event(), threading.Event()
    init_cache, built, errors = model.init_cache, [], []

    def held_init_cache(*args, **kw):
        if threading.current_thread().name == "build" and \
                not building.is_set():
            building.set()
            assert demoted.wait(timeout=60)
        return init_cache(*args, **kw)

    def build():
        try:
            built.append(engine(model, SLOT))
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    monkeypatch.setattr(model, "init_cache", held_init_cache)
    t = threading.Thread(target=build, name="build")
    t.start()
    try:
        assert building.wait(timeout=60)
        host = a.offload_device_state()
    finally:
        demoted.set()
        t.join(timeout=120)
    assert not t.is_alive() and errors == [] and len(built) == 1
    assert a.model is not model
    for n, p in model.named_parameters():
        assert torch.equal(p, want[n])
    assert built[0].generate(ps, max_new_tokens=3) == ref
    a.restore_device_state(host)
    assert a.generate(ps, max_new_tokens=3) == ref
