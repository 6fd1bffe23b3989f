"""The port's PCM runtime with the port's engine (reduced smollm2-1.7b, f32,
CPU), mirroring tests/test_runtime.py's TestEngineTierRoundTrip and
TestPagedEngineUnderPCM and its preempt-then-rejoin case with a real
engine: DEVICE -> HOST_RAM -> LOCAL_DISK -> DEVICE plain and streamed with
zero builder calls and zero builds and the reference engine's greedy
tokens, a mid-stream restore, a preemption during an in-flight megastep, a
paged snapshot that ships live pages only, a PEER bootstrap, and the
fact-verification application (``repro_torch.launch.serve``) under a
preemption against the reference CLI's path on the same weights."""

import threading
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import CheckpointManager as JaxManager  # noqa: E402
from repro.configs import get_reduced_config as jax_config  # noqa: E402
from repro.data import fever as jfever  # noqa: E402
from repro.data.tokenizer import HashTokenizer as JaxTokenizer  # noqa: E402
from repro.data.tokenizer import LABEL_TOKENS as JAX_LABELS  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serving import InferenceEngine as JaxEngine  # noqa: E402
from repro_torch.checkpoint.io import tree_leaves  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.core import (ContextMode, FetchSource, Library,  # noqa
                              PCMManager, SnapshotPool, Tier, context_app,
                              export_context, load_context, make_recipe,
                              materialize, restore_context)
from repro_torch.data import fever  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import InferenceEngine, Request  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

SLOT = dict(slots=2, cache_len=64, prefill_buckets=(16,), megastep=4)
PAGED = dict(slots=4, cache_len=64, prefill_buckets=(16,), megastep=4,
             paged=True, page_size=8)


@pytest.fixture(scope="module")
def smol():
    cfg = jax_config("smollm2-1.7b")
    jmodel = jax_build(cfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    tcfg = get_reduced_config("smollm2-1.7b")
    state = from_jax_params(jax.device_get(params), tcfg, "cpu")

    def tmodel():
        """A model of its own over the shared weights (no copy): a
        demotion empties its engine's model's parameters."""
        return build_model(tcfg, device="cpu", params=state)

    return cfg, jmodel, params, tmodel


def _prompts(cfg, n, seed=0):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(8, cfg.vocab_size,
                             size=rng.randint(3, 14))) for _ in range(n)]


def _recipe(name, model, kw, builds=None):
    def build():
        if builds is not None:
            builds.append(1)
        return {"engine": InferenceEngine(model(), device="cpu", **kw)}

    return make_recipe(name, build, host_bytes=0)


def _run_requests(eng, prompts, max_new):
    for p in prompts:
        eng.submit(Request(prompt=list(p), max_new_tokens=max_new))
    return sorted(r.generated for r in eng.run_to_completion())


# ---------------------------------------------------- tier round trip ----
@pytest.mark.parametrize("streamed", [False, True])
def test_device_host_disk_device_parity(smol, tmp_path, streamed):
    """DEVICE -> HOST_RAM -> LOCAL_DISK -> DEVICE restores with zero
    builder calls and zero builds, and greedy tokens equal to the
    never-demoted context's and to the reference engine's."""
    cfg, jmodel, params, tmodel = smol
    ps = _prompts(cfg, 5)
    want = JaxEngine(jmodel, params, **SLOT).generate(ps, max_new_tokens=6)
    builds = []
    pool = SnapshotPool(spill_dir=str(tmp_path))
    lib = Library("w0", snapshots=pool, streamed=streamed)
    rec = _recipe("rt", tmodel, SLOT, builds)

    eng = lib.ensure(rec).value["engine"]
    baseline = eng.generate(ps, max_new_tokens=6)
    assert baseline == want
    compiles = eng.stats.compiles

    snap = lib.demote(rec.key())                   # DEVICE -> HOST_RAM
    assert eng.offloaded and snap.nbytes > 0
    # the leaves' own bytes: ``nbytes`` counts their arenas, alignment
    # included, which the spill does not write
    data = sum(t.numel() * t.element_size() if isinstance(t, torch.Tensor)
               else t.nbytes for t in tree_leaves(snap.host_state))
    with pytest.raises(RuntimeError, match="offloaded"):
        eng.generate(ps, max_new_tokens=1)
    assert pool.spill(rec.key())                   # HOST_RAM -> LOCAL_DISK
    assert pool.tier(rec.key()) == Tier.LOCAL_DISK

    ctx = lib.ensure(rec)                          # LOCAL_DISK -> DEVICE
    assert ctx.value["engine"] is eng and not eng.offloaded
    assert builds == [1]
    assert eng.generate(ps, max_new_tokens=6) == baseline
    assert eng.stats.compiles == compiles == 0
    assert lib.restores == 1 and ctx.restored and ctx.restore_seconds > 0
    if streamed:
        assert set(ctx.stage_seconds) == {"disk", "h2d"}
        assert ctx.stage_seconds["disk"][0] >= data - 1024
    assert not list(tmp_path.iterdir())            # the spill was consumed


def test_restore_preserves_midstream_state(smol, tmp_path):
    """Demoted through the pool to disk between megasteps, the engine
    continues exactly where the never-demoted engine does."""
    cfg, _, _, tmodel = smol
    ps = _prompts(cfg, 2, seed=7)
    want = _run_requests(InferenceEngine(tmodel(), device="cpu", **SLOT), ps,
                         12)
    pool = SnapshotPool(spill_dir=str(tmp_path))
    lib = Library("w0", snapshots=pool, streamed=True)
    rec = _recipe("mid", tmodel, SLOT)
    eng = lib.ensure(rec).value["engine"]
    reqs = [eng.submit(Request(prompt=list(p), max_new_tokens=12))
            for p in ps]
    eng.step()                                     # prefill + one megastep
    assert all(0 < len(r.generated) < 12 for r in reqs)
    lib.demote(rec.key())
    pool.spill(rec.key())
    lib.ensure(rec)
    while eng.has_work():
        eng.step()
    assert sorted(r.generated for r in reqs) == want


def test_preemption_during_inflight_megastep(smol):
    """Preempting the worker while generate() is mid-megastep reruns the
    task on the replacement, which gives the reference's tokens."""
    cfg, jmodel, params, tmodel = smol
    ps = _prompts(cfg, 3, seed=1)
    expected = JaxEngine(jmodel, params, **SLOT).generate(ps,
                                                          max_new_tokens=8)
    mgr = PCMManager(mode=ContextMode.FULL, n_workers=1)
    try:
        rec = _recipe("live", tmodel, SLOT)
        decoding = threading.Event()

        def task():
            eng = load_context("engine")
            decoding.set()
            return eng.generate(ps, max_new_tokens=8)

        fut = mgr.submit(task, recipe=rec)
        assert decoding.wait(120)
        mgr.preempt_worker(next(iter(mgr.workers)))
        mgr.add_worker()
        assert fut.result(timeout=300) == expected
        assert mgr.lookup_task(fut.task_id).attempts >= 1
    finally:
        mgr.shutdown()


def test_preempt_then_rejoin_restores_from_pool(smol):
    """preempt_worker -> add_worker round-trips a real engine context at
    restore cost: no builder rerun, the same tokens."""
    cfg, _, _, tmodel = smol
    ps = _prompts(cfg, 3, seed=2)
    builds = []
    mgr = PCMManager(mode=ContextMode.FULL, n_workers=1)
    try:
        rec = _recipe("rejoin", tmodel, SLOT, builds)
        mgr.warm_up(rec)
        want = mgr.submit(lambda: load_context("engine").generate(
            ps, max_new_tokens=5), recipe=rec).result(timeout=60)
        mgr.preempt_worker(next(iter(mgr.workers)))
        deadline = time.monotonic() + 30
        while rec.key() not in mgr.snapshots.keys():
            assert time.monotonic() < deadline, "retirement demotion " \
                "never reached the snapshot pool"
            time.sleep(0.01)
        assert mgr.snapshots.tier(rec.key()) == Tier.HOST_RAM
        mgr.add_worker()
        got = mgr.submit(lambda: load_context("engine").generate(
            ps, max_new_tokens=5), recipe=rec).result(timeout=60)
        assert got == want and builds == [1]
        st = mgr.stats()
        assert st["context_restores"] == 1
        assert st["snapshot_pool"]["demotions"] >= 1
    finally:
        mgr.shutdown()


# ------------------------------------------------------------ paged pool --
def test_midstream_snapshot_ships_live_pages_only(smol, tmp_path):
    """A paged engine demoted mid-stream snapshots only its live pages,
    and its HOST_RAM -> LOCAL_DISK -> DEVICE round trip continues the
    in-flight decodes with the reference paged engine's tokens, zero
    builder calls and zero builds."""
    cfg, jmodel, params, tmodel = smol
    ps = _prompts(cfg, 2, seed=3)
    want = _run_requests(JaxEngine(jmodel, params, **PAGED), ps, 12)
    builds = []
    pool = SnapshotPool(spill_dir=str(tmp_path))
    lib = Library("w0", snapshots=pool)
    rec = _recipe("paged-rt", tmodel, PAGED, builds)
    eng = lib.ensure(rec).value["engine"]
    assert eng.warm_executables() >= 0.0
    reqs = [eng.submit(Request(prompt=list(p), max_new_tokens=12))
            for p in ps]
    eng.step()
    live1 = eng._alloc.live_pages
    assert 0 < live1 < eng.num_pages
    snap = eng.snapshot()
    live_b, cap_b = snap["live_bytes"], snap["capacity_bytes"]

    lib.demote(rec.key())
    nbytes_mid = pool.stats()["host_used_bytes"]
    assert pool.spill(rec.key())
    assert pool.tier(rec.key()) == Tier.LOCAL_DISK
    eng2 = lib.ensure(rec).value["engine"]
    assert eng2 is eng and builds == [1]
    while eng.has_work():
        eng.step()
    assert sorted(r.generated for r in reqs) == want
    assert eng.stats.compiles == 0

    eng.drop_prefix_cache()
    assert eng._alloc.live_pages == 0
    lib.demote(rec.key())
    delta = nbytes_mid - pool.stats()["host_used_bytes"]
    # live pages + their int64 ids + int32 refcounts; never the pool
    assert live_b <= delta <= live_b + 12 * live1
    assert nbytes_mid < pool.stats()["host_used_bytes"] + cap_b


# ------------------------------------------------------- peer bootstrap --
def test_peer_bootstrap_decodes_like_a_cold_build(smol):
    """export_context -> clone_offloaded -> restore_device_state: the
    receiver decodes bit-identically to a cold-built engine, and the donor
    keeps serving."""
    cfg, _, _, tmodel = smol
    ps = _prompts(cfg, 4, seed=4)
    builds = []
    rec = _recipe("peer", tmodel, SLOT, builds)
    donor = materialize(rec, "donor")
    donor_eng = donor.value["engine"]
    donor_eng.generate(ps[:1], max_new_tokens=3)   # a used donor
    snap = export_context(donor)
    recv = restore_context(snap, "receiver").value["engine"]
    assert recv is not donor_eng and not donor_eng.offloaded
    cold = InferenceEngine(tmodel(), device="cpu", **SLOT)
    want = cold.generate(ps, max_new_tokens=6)
    assert recv.generate(ps, max_new_tokens=6) == want
    assert donor_eng.generate(ps, max_new_tokens=6) == want
    assert builds == [1] and recv.stats.compiles == 0


@pytest.mark.parametrize("streamed", [False, True])
def test_joiner_bootstraps_from_a_peer(smol, streamed):
    """A worker that joins while a warm worker runs a task of the context
    prefetches it from that worker (monolithic, or striped in verified
    chunks), not from the builder, and serves the same tokens."""
    cfg, _, _, tmodel = smol
    ps = _prompts(cfg, 3, seed=5)
    builds = []
    mgr = PCMManager(mode=ContextMode.FULL, n_workers=1, streamed=streamed,
                     chunk_bytes=256 << 10)
    gate = threading.Event()
    try:
        rec = make_recipe(
            "joiner", lambda: builds.append(1) or {
                "engine": InferenceEngine(tmodel(), device="cpu", **SLOT)},
            artifact_bytes=48 << 20, env_bytes=16 << 20,
            host_bytes=64 << 20, device_bytes=64 << 20)
        mgr.warm_up(rec)

        def task():
            gate.wait(60)
            return load_context("engine").generate(ps, max_new_tokens=5)

        fut = mgr.submit(task, recipe=rec)          # the donor is busy
        joiner = mgr.add_worker()                   # demand: prefetch
        gate.set()
        want = fut.result(timeout=60)
        deadline = time.monotonic() + 60
        while mgr.residency(rec).get(joiner) != Tier.DEVICE:
            assert time.monotonic() < deadline, mgr.fetch_history(rec)
            time.sleep(0.02)
        eng = mgr.workers[joiner].library.context(rec.key()).value["engine"]
        assert eng.generate(ps, max_new_tokens=5) == want
        decisions = mgr.fetch_history(rec)
        assert [(d.worker_id, d.source) for d in decisions] == [
            (joiner, FetchSource.PEER)]
        assert builds == [1] and mgr.stats()["peer_installs"] == 1
        if streamed:
            assert mgr.stats()["striping"]["chunks"] > 1
    finally:
        gate.set()
        mgr.shutdown()


# -------------------------------------------------------- the application --
TEMPLATES = (0, 2)
N_CLAIMS = 16


def test_serve_verdicts_match_reference_cli(tmp_path):
    """The port's ``verify_batch`` under a 2-worker PCMManager with a worker
    preempted mid-run gives, claim by claim, the tokens and verdicts of the
    reference CLI's path (``repro.launch.serve``) on the same weights,
    claims and templates, and the same accuracy per template."""
    cfg = jax_config("smollm2-1.7b")
    params = jax_build(cfg).init(jax.random.PRNGKey(0))
    JaxManager(str(tmp_path)).save(0, params)     # the CLI's weights
    jctx = jserve.build_context("smollm2-1.7b", 4, 128, 8)
    jtok = JaxTokenizer(cfg.vocab_size)
    want = {}
    for ti in TEMPLATES:
        claims = jfever.claim_batch(range(N_CLAIMS))
        prompts = [jtok.encode(jfever.render_prompt(
            c, jfever.PROMPT_CANDIDATES[ti])) for c in claims]
        outs = jctx["engine"].generate(prompts, max_new_tokens=2)
        want[ti] = (outs, [int((o[0] if o else -1) == JAX_LABELS[c.label])
                           for o, c in zip(outs, claims)])

    mgr = PCMManager(mode=ContextMode.FULL, n_workers=2)
    try:
        recipe = make_recipe("smollm2-1.7b.ctx", serve.build_context,
                             ("smollm2-1.7b", 4, 128, 8, None, "cpu",
                              str(tmp_path)))

        @context_app(recipe=recipe, manager=mgr, n_items=4)
        def verify_batch(indices, template):
            return serve.verify_claims(indices, template)

        futs = {ti: [] for ti in TEMPLATES}
        for b in range(N_CLAIMS // 4):
            for ti in TEMPLATES:
                futs[ti].append(verify_batch(
                    list(range(4 * b, 4 * b + 4)),
                    fever.PROMPT_CANDIDATES[ti]))
            if b == 1:
                mgr.preempt_worker(next(iter(mgr.workers)))
                mgr.add_worker()
        for ti in TEMPLATES:
            res = [f.result(timeout=300) for f in futs[ti]]
            outs = [o for r in res for o in r[0]]
            verdicts = [v for r in res for v in r[1]]
            assert outs == want[ti][0]
            assert verdicts == want[ti][1]
            assert np.mean(verdicts) == np.mean(want[ti][1])
        st = mgr.stats()
        assert st["builder_calls"] <= st["cold_invocations"] + 1
    finally:
        mgr.shutdown()


# ------------------------------------------------------- the kernel build --
def test_kernel_build_runs_once_across_threads(tmp_path, monkeypatch):
    """Worker threads that load their kernels at the same moment on an
    empty build directory run one build between them (one compiler per
    source, each writing its own temporary file) and all get loaded
    libraries. The compiler and the loader are stand-ins here; the card
    test of the same name builds for real."""
    import types
    from pathlib import Path

    from repro_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    compiles, tmp_names = [], set()

    class Compiler:
        def __init__(self, cmd, **kw):
            out = Path(cmd[cmd.index("-o") + 1])
            compiles.append(out)
            tmp_names.add(out.name)
            time.sleep(0.05)                  # a build takes a while
            out.write_bytes(b"kernel")
            self.returncode = 0

        def communicate(self):
            return "ptxas info", None

    def load(path):
        assert Path(path).read_bytes() == b"kernel"
        return types.SimpleNamespace(
            path=path, repro_cuda_error_string=types.SimpleNamespace())

    monkeypatch.setattr(build.subprocess, "Popen", Compiler)
    monkeypatch.setattr(build.ctypes, "CDLL", load)
    names = list(build.SOURCES) * 2
    start = threading.Barrier(len(names))
    got = {}

    def worker(i, name):
        start.wait()
        got[i] = (name, build.library(name))

    threads = [threading.Thread(target=worker, args=(i, n))
               for i, n in enumerate(names)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert len(compiles) == len(build.SOURCES)        # built once
    assert len(tmp_names) == len(build.SOURCES)
    assert all(".tmp" in n for n in tmp_names)
    assert len(got) == len(names)
    for name, lib in got.values():
        assert lib is build.library(name)
        assert lib.path == str(build.library_path(name))
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        build.library_path(n).name for n in build.SOURCES)


def test_launch_counts_lose_nothing_across_threads():
    """Worker threads launch kernels concurrently: every launch counts."""
    import sys

    from repro_torch.kernels import ops

    def launch():
        for _ in range(20_000):
            ops._launched("flash_decode")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ops.reset_launches()
        threads = [threading.Thread(target=launch) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert ops.LAUNCHES["flash_decode"] == 8 * 20_000
    finally:
        sys.setswitchinterval(interval)
        ops.reset_launches()
