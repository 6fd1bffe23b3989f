"""The port's streaming front door against the JAX reference's: open-loop
arrivals, the token bucket and the admission controller (quotas, SLO
order, DRR) on scripted sequences, the exactly-once TokenStream, live
sessions on a 2-worker port PCMManager streaming the JAX engine's greedy
tokens (slot cache and paged pool with a prefix key, megastep 1 and 4),
the reference's live cases (INTERACTIVE ahead of a backlog, an over-budget
tenant shed, a preemption mid-stream), and one turn sequence through both
packages' FrontDoor over their SimulatorBackend (tests/test_frontdoor.py's
counterparts, on the reduced SmolLM2 in f32 on the CPU)."""

import time
import types
import zlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.cluster.traces as jtraces  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro.serving as jserving  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.serving as tserving  # noqa: E402
from repro.configs import get_reduced_config as jax_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serving import InferenceEngine as JaxEngine  # noqa: E402
from repro_torch.cluster import traces  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.core import (ContextMode, FetchSource, PCMClient,  # noqa
                              PCMManager, SimulatorBackend, load_context,
                              make_recipe)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import (FrontDoor, InferenceEngine,  # noqa: E402
                                 SLOClass, ShedError, StreamError,
                                 TenantQuota, TokenStream)
from repro_torch.weights import from_jax_params  # noqa: E402

WAIT = 120                      # seconds: every wait on a stream is bounded


# ------------------------------------------------------- poisson arrivals --
@pytest.mark.parametrize("rate,duration,seed", [
    (5.0, 30.0, 4), (50.0, 40.0, 1), (20.0, 4.0, 0), (0.5, 100.0, 7),
    (1.0, 0.0, 0)])
def test_poisson_sessions_match_reference(rate, duration, seed):
    got = traces.poisson_sessions(rate, duration, seed=seed)
    assert got == jtraces.poisson_sessions(rate, duration, seed=seed)
    assert got == sorted(got) and all(0.0 <= t < duration for t in got)


def test_poisson_sessions_validation_matches_reference():
    for args in ((0.0, 10.0), (1.0, -1.0)):
        with pytest.raises(ValueError) as got:
            traces.poisson_sessions(*args)
        with pytest.raises(ValueError) as want:
            jtraces.poisson_sessions(*args)
        assert str(got.value) == str(want.value)


# ------------------------------------------------------ admission control --
def _pkg(serving):
    return types.SimpleNamespace(**{n: getattr(serving, n) for n in (
        "AdmissionController", "SLOClass", "ShedError", "TenantQuota",
        "TokenBucket", "TokenStream", "Turn")})


def _bucket_script(p):
    b = p.TokenBucket(rate=10.0, burst=20.0, now=0.0)
    out = []
    for n, now in ((20, 0.0), (1, 0.0), (10, 1.0), (5, 1.2), (3, 1.2),
                   (999, 1.5), (19.5, 4.0), (0.5, 4.0)):
        out.append((b.try_take(n, now), b.retry_after(n, now), b.level))
    inf = p.TokenBucket(rate=float("inf"), burst=1.0, now=0.0)
    out.append((inf.try_take(1e9, 0.0), inf.retry_after(1e9, 0.0)))
    return out


def test_token_bucket_matches_reference():
    got = _bucket_script(_pkg(tserving))
    assert got == _bucket_script(_pkg(jserving))
    assert got[0][0] and not got[1][0]
    assert got[5][1] is None                      # can never fit the burst


class _Script:
    """Records an admission script's decisions by the script's own turn
    labels (turn ids come from a per-package counter)."""

    def __init__(self, p, **kw):
        self.p = p
        self.ac = p.AdmissionController(**kw)
        self.log = []
        self.labels = {}

    def admit(self, label, tenant, now, cost=16, slo="BATCH", ctx="ctx",
              lane=0, session=None):
        p = self.p
        turn = p.Turn(session_id=session or f"{tenant}-s", tenant=tenant,
                      slo=getattr(p.SLOClass, slo), ctx_key=ctx, lane=lane,
                      prompt=[2] * (cost - 8), max_new_tokens=8,
                      stream=p.TokenStream(0))
        self.labels[id(turn)] = label
        try:
            self.ac.admit(turn, now)
            self.log.append(("admit", label))
        except p.ShedError as e:
            self.log.append(("shed", label, e.tenant, e.reason,
                             e.retry_after_seconds, str(e)))

    def claim(self, now, sel=None, n=1):
        for _ in range(n):
            t = self.ac.claim(sel, now)
            self.log.append(("claim", None if t is None
                             else self.labels[id(t)]))

    def result(self):
        return self.log, self.ac.stats()


def _script_quotas(p):
    s = _Script(p, default_quota=p.TenantQuota(max_queued_turns=3))
    s.ac.set_quota("cheap", p.TenantQuota(tokens_per_second=4.0,
                                          burst_tokens=40.0,
                                          max_queued_turns=4))
    for i, now in enumerate((0.0, 0.0, 0.5, 1.0, 1.0, 7.0, 7.0, 7.25)):
        s.admit(f"c{i}", "cheap", now, cost=16 + 4 * (i % 3))
    for i in range(5):
        s.admit(f"d{i}", "dflt", 0.5 * i)
    s.claim(8.0, n=3)
    s.admit("d5", "dflt", 8.0)
    s.ac.set_quota("cheap", p.TenantQuota(tokens_per_second=1.0,
                                          burst_tokens=100.0))
    s.admit("c8", "cheap", 9.0, cost=120)
    s.admit("c9", "cheap", 9.0, cost=24)
    s.claim(10.0, n=8)
    return s.result()


def _script_slo(p):
    s = _Script(p)
    for i in range(3):
        s.admit(f"b{i}", "bulk", 0.0, ctx="A", lane=i % 2)
    s.admit("i0", "person", 0.0, slo="INTERACTIVE", ctx="A", lane=1)
    s.admit("i1", "other", 0.0, slo="INTERACTIVE", ctx="B", lane=0)
    s.admit("b3", "bulk2", 0.0, ctx="B", lane=0)
    s.admit("i2", "person", 0.0, slo="INTERACTIVE", ctx="A", lane=0)
    s.claim(0.0, sel=("A", 0))
    s.claim(0.0, sel=("B", 0))
    s.claim(0.0)
    s.log.append(("pending", s.ac.pending_for(("A", 0)),
                  s.ac.pending_interactive(None)))
    s.claim(0.0, sel=("A", 1), n=2)
    s.claim(0.0, n=4)
    return s.result()


def _script_drr(p):
    s = _Script(p, drr_quantum=32.0)
    for i in range(8):
        s.admit(f"hog{i}", "hog", 0.0, cost=16)
    for i in range(4):
        s.admit(f"mid{i}", "mid", 0.0, cost=32)
    for i in range(3):
        s.admit(f"big{i}", "big", 0.0, cost=80)
    s.claim(0.0, n=6)
    s.admit("mouse0", "mouse", 0.0, cost=24)
    s.claim(0.0, n=12)
    return s.result()


def _script_cancel(p):
    s = _Script(p)
    for i in range(3):
        s.admit(f"x{i}", "t", 0.0, session="sx")
        s.admit(f"y{i}", "t", 0.0, session="sy",
                slo="INTERACTIVE" if i == 1 else "BATCH")
    s.claim(0.0)
    gone = s.ac.cancel_session("sy")
    s.log.append(("cancelled", sorted(s.labels[id(t)] for t in gone)))
    s.claim(0.0, n=4)
    return s.result()


@pytest.mark.parametrize("script", [_script_quotas, _script_slo,
                                    _script_drr, _script_cancel],
                         ids=["quotas", "slo", "drr", "cancel"])
def test_admission_script_matches_reference(script):
    got = script(_pkg(tserving))
    assert got == script(_pkg(jserving))
    log, stats = got
    claims = [e[1] for e in log if e[0] == "claim" and e[1]]
    assert len(claims) == len(set(claims)) == stats["claimed"]
    if script is _script_quotas:
        assert stats["shed"]["rate_limit"] >= 1
        assert stats["shed"]["queue_full"] >= 1
    if script is _script_slo:
        assert claims[:3] == ["i2", "i1", "i0"]
    if script is _script_drr:
        # the late light tenant is served within a DRR round, not after
        # the 15-turn backlog
        assert "mouse0" in claims[6:10]


# ----------------------------------------------------------- token stream --
def _stream_script(p):
    out = []

    def do(fn):
        try:
            out.append(("ok", fn()))
        except Exception as e:          # the outcome is what is compared
            out.append((type(e).__name__, str(e)))

    s = p.TokenStream(7)
    for i, tok in ((0, 4), (1, 5), (1, 5), (0, 4), (3, 9), (1, 6), (2, 1)):
        do(lambda i=i, tok=tok: s.push(i, tok))
    do(lambda: s.result(timeout=1))
    e = p.TokenStream(8)
    do(lambda: e.push(0, 3))
    e.finish(error=p.StreamError("pump died"))
    e.finish()
    do(lambda: e.result(timeout=1))
    do(lambda: list(e.tokens(timeout=1)))
    return out


def test_token_stream_matches_reference():
    got = _stream_script(types.SimpleNamespace(
        TokenStream=TokenStream, StreamError=StreamError))
    assert got == _stream_script(types.SimpleNamespace(
        TokenStream=jserving.TokenStream, StreamError=jserving.StreamError))
    assert [g[0] for g in got[:8]] == ["ok", "ok", "ok", "ok", "StreamError",
                                       "StreamError", "ok", "StreamError"]
    assert got[2] == got[3] == ("ok", False)      # a replay is dropped
    assert "arrived before" in got[4][1] and "diverged" in got[5][1]
    assert "diverged" in got[7][1]                # the first error stands
    assert got[-2:] == [("StreamError", "pump died")] * 2


def test_token_stream_iterates_and_times_out():
    s = TokenStream(0)
    s.push(0, 4)
    s.push(1, 5)
    s.finish()
    assert list(s.tokens(timeout=1)) == [4, 5] and s.done
    assert s.ttft_seconds >= 0 and s.token_count == 2
    with pytest.raises(TimeoutError):
        list(TokenStream(1).tokens(timeout=0.05))
    with pytest.raises(TimeoutError):
        TokenStream(2).result(timeout=0.05)


# ------------------------------------------------------------ live front --
SLOT = dict(slots=2, cache_len=64, prefill_buckets=(16,))
PAGED = dict(SLOT, paged=True, page_size=8, prefix_sharing=True)


@pytest.fixture(scope="module")
def smol():
    cfg = jax_config("smollm2-1.7b")
    jmodel = jax_build(cfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    tcfg = get_reduced_config("smollm2-1.7b")
    state = from_jax_params(jax.device_get(params), tcfg, "cpu")

    def tmodel():
        """A model of its own over the shared weights (no copy)."""
        return build_model(tcfg, device="cpu", params=state)

    return cfg, jmodel, params, tmodel


def _prompts(cfg, n, seed=0):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(8, cfg.vocab_size,
                             size=rng.randint(3, 14))) for _ in range(n)]


def _shared_prompts(cfg, n, seed=0):
    """n prompts behind one 18-token template (ends mid-page at 8)."""
    rng = np.random.RandomState(seed)
    head = list(rng.randint(8, cfg.vocab_size, size=18))
    return [head + list(rng.randint(8, cfg.vocab_size, size=3 + i % 5))
            for i in range(n)]


@pytest.fixture(scope="module")
def jax_tokens(smol):
    """The JAX engine's greedy tokens for every prompt set used below."""
    cfg, jmodel, params, _ = smol
    eng = JaxEngine(jmodel, params, megastep=4, **SLOT)
    return {"plain": eng.generate(_prompts(cfg, 6, seed=2),
                                  max_new_tokens=8),
            "shared": eng.generate(_shared_prompts(cfg, 6),
                                   max_new_tokens=8),
            "preempt": eng.generate(_prompts(cfg, 3, seed=10),
                                    max_new_tokens=24)}


def _recipe(tmodel, kw, builds, name="fd.engine"):
    def build():
        builds.append(1)
        return {"engine": InferenceEngine(tmodel(), device="cpu", **kw)}

    # the default (nonzero) footprint: a preempted worker's context
    # recovers by POOL/DISK, not by a rebuild
    return make_recipe(name, build)


def _engine_value(key):
    return load_context("engine").stats.as_dict()[key]


@pytest.mark.parametrize("pool", ["slot", "paged"])
@pytest.mark.parametrize("K", [1, 4])
def test_live_sessions_stream_reference_tokens(smol, jax_tokens, pool, K):
    """Tokens streamed through sessions on a 2-worker manager equal the
    JAX engine's greedy tokens; the builder runs once (one worker warms,
    the lane's pump serves there); on the paged pool the sessions that
    declare one template share one lane and hit its prefix cache."""
    cfg, _, _, tmodel = smol
    paged = pool == "paged"
    ps = _shared_prompts(cfg, 6) if paged else _prompts(cfg, 6, seed=2)
    want = jax_tokens["shared" if paged else "plain"]
    builds = []
    mgr = PCMManager(mode=ContextMode.FULL, n_workers=2)
    try:
        client = PCMClient(backend=mgr)
        ctx = client.context(_recipe(tmodel, dict(PAGED if paged else SLOT,
                                                  megastep=K), builds))
        ctx.warm_up(worker_ids=[sorted(mgr.workers)[0]])
        fd = client.frontdoor(lanes=2)
        key = "tmpl" if paged else None
        sessions = [client.session(ctx, tenant="acme", prefix_key=key,
                                   session_id=f"acme-{i}")
                    for i in range(3)]
        streams = [sessions[i % 3].submit(p, max_new_tokens=8)
                   for i, p in enumerate(ps)]
        outs = [list(s.tokens(timeout=WAIT)) for s in streams]
        for sess in sessions:
            sess.close()
        assert outs == want
        assert [s.result(timeout=WAIT) for s in streams] == want
        assert all(s.ttft_seconds is not None and s.ttft_seconds >= 0
                   for s in streams)
        assert builds == [1]
        st = fd.stats()
        assert st["turns_completed"] == 6
        assert st["admission"]["shed_rate"] == 0.0
        assert st["router"]["pump_errors"] == 0
        lanes = {s.lane for s in sessions}
        if paged:
            assert lanes == {zlib.crc32(b"tmpl") % 2}
            assert st["prefix"]["hits"] >= 1
            assert st["prefix"]["tokens_reused"] >= 16 * st["prefix"]["hits"]
            assert st["prefix"]["hits"] == client.submit(
                _engine_value, "prefix_hits",
                context=ctx).result(timeout=WAIT)
        else:
            assert lanes == {zlib.crc32(f"acme-{i}".encode()) % 2
                             for i in range(3)}
            assert st["prefix"]["hits"] == 0
    finally:
        mgr.shutdown()


def test_client_stream_and_session_one_shot(smol):
    cfg, _, _, tmodel = smol
    p = _prompts(cfg, 1, seed=6)[0]
    mgr = PCMManager(mode=ContextMode.FULL, n_workers=1)
    try:
        client = PCMClient(backend=mgr)
        ctx = client.context(_recipe(tmodel, dict(SLOT, megastep=4), []))
        toks = list(client.stream(p, context=ctx, max_new_tokens=5)
                    .tokens(timeout=WAIT))
        assert 1 <= len(toks) <= 5
        fd = client.frontdoor()
        assert isinstance(fd, FrontDoor) and client.frontdoor() is fd
        with pytest.raises(ValueError, match="already configured"):
            client.frontdoor(lanes=2)
        with client.session(ctx, tenant="t", slo=SLOClass.INTERACTIVE) as s:
            assert s.submit(p, max_new_tokens=5).result(timeout=WAIT) == toks
        with pytest.raises(RuntimeError, match="closed"):
            s.submit(p)
        too_long = client.stream(list(range(8, 80)), context=ctx)
        with pytest.raises(ValueError, match="exceeds cache"):
            too_long.result(timeout=WAIT)
        assert fd.stats()["sessions_open"] == 0
    finally:
        mgr.shutdown()


def test_interactive_mid_run_beats_saturated_batch_queue(smol):
    cfg, _, _, tmodel = smol
    ps = _prompts(cfg, 9, seed=4)
    mgr = PCMManager(mode=ContextMode.FULL, n_workers=1)
    try:
        client = PCMClient(backend=mgr)
        ctx = client.context(_recipe(tmodel, dict(SLOT, megastep=4), []))
        ctx.warm_up()
        bulk = client.session(ctx, tenant="bulk")
        batch = [bulk.submit(p, max_new_tokens=16) for p in ps[:8]]
        inter = client.session(ctx, tenant="person",
                               slo=SLOClass.INTERACTIVE
                               ).submit(ps[8], max_new_tokens=16)
        inter.result(timeout=WAIT)
        for b in batch:
            b.result(timeout=WAIT)
        assert inter.first_token_at < max(b.first_token_at for b in batch)
        assert all(len(b.result(timeout=5)) >= 1 for b in batch)
    finally:
        mgr.shutdown()


def test_over_budget_tenant_shed_live(smol):
    cfg, _, _, tmodel = smol
    ps = _prompts(cfg, 4, seed=8)
    mgr = PCMManager(mode=ContextMode.FULL, n_workers=1)
    try:
        client = PCMClient(backend=mgr)
        ctx = client.context(_recipe(tmodel, dict(SLOT, megastep=4), []))
        quota = TenantQuota(tokens_per_second=0.001,
                            burst_tokens=float(len(ps[0]) + 8),
                            max_queued_turns=8)
        client.frontdoor(quotas={"cheap": quota})
        sess = client.session(ctx, tenant="cheap")
        first = sess.submit(ps[0], max_new_tokens=8)
        with pytest.raises(ShedError) as e:
            for p in ps[1:]:
                sess.submit(p, max_new_tokens=8)
        assert e.value.reason == "rate_limit"
        assert e.value.retry_after_seconds > 0
        assert first.result(timeout=WAIT)
        assert client.frontdoor().stats()["admission"][
            "shed_by_tenant"]["cheap"] >= 1
    finally:
        mgr.shutdown()


def test_stream_survives_worker_preemption(smol, jax_tokens):
    """Mid-stream preemption: the zombie pump finishes its invocation, the
    requeued pump restores the context from the pool, and every stream
    ends with the JAX engine's tokens — no builder call, no kernel
    build."""
    cfg, _, _, tmodel = smol
    ps = _prompts(cfg, 3, seed=10)
    builds = []
    mgr = PCMManager(mode=ContextMode.FULL, n_workers=1)
    try:
        client = PCMClient(backend=mgr)
        rec = _recipe(tmodel, dict(SLOT, megastep=4), builds)
        ctx = client.context(rec)
        ctx.warm_up()
        assert builds == [1]
        compiles = client.submit(_engine_value, "compiles",
                                 context=ctx).result(timeout=WAIT)
        sess = client.session(ctx, tenant="durable")
        streams = [sess.submit(p, max_new_tokens=24) for p in ps]
        assert streams[0].result(timeout=WAIT) == jax_tokens["preempt"][0]
        mgr.preempt_worker(next(iter(mgr.workers)))
        deadline = time.monotonic() + 60
        while (mgr.snapshots.tier(rec.key()) is None
               and time.monotonic() < deadline):
            time.sleep(0.02)
        assert mgr.snapshots.tier(rec.key()) is not None
        mgr.add_worker()
        assert [s.result(timeout=WAIT) for s in streams] == \
            jax_tokens["preempt"]
        assert builds == [1]
        mgr.run_until_idle(timeout=60)
        assert any(d.source in (FetchSource.POOL, FetchSource.DISK)
                   for d in mgr.fetch_history(rec))
        assert client.submit(_engine_value, "compiles",
                             context=ctx).result(timeout=WAIT) == compiles
    finally:
        mgr.shutdown()


# ------------------------------------------------------ sim front door ----
def _sim_sequence(core, serving):
    """One turn sequence on a 2-worker SimulatorBackend behind a 2-lane
    front door: three tenants (one over budget), modeled time advanced
    between arrivals; returns every decision and modeled reading."""
    backend = core.SimulatorBackend(n_workers=2, profile="h100")
    client = core.PCMClient(backend=backend)
    ctx = client.context(core.ContextRecipe(name="fd.sim"))
    ctx.warm_up(worker_ids=sorted(backend.scheduler.workers)[:1])
    fd = client.frontdoor(lanes=2, quotas={"cheap": serving.TenantQuota(
        tokens_per_second=2.0, burst_tokens=48.0, max_queued_turns=4)})
    sessions = {
        "verify": client.session(ctx, tenant="verify", prefix_key="fv",
                                 session_id="verify-0"),
        "chat": client.session(ctx, tenant="chat", session_id="chat-0",
                               slo=serving.SLOClass.INTERACTIVE),
        "chat2": client.session(ctx, tenant="chat", session_id="chat-7",
                                slo=serving.SLOClass.INTERACTIVE),
        "cheap": client.session(ctx, tenant="cheap", session_id="cheap-3")}
    rng = np.random.RandomState(3)
    streams, sheds = [], []
    for i in range(24):
        name = ("verify", "chat", "chat2", "cheap")[rng.randint(4)]
        prompt = [2] * int(rng.randint(8, 40))
        try:
            streams.append(sessions[name].submit(prompt, max_new_tokens=8))
        except serving.ShedError as e:
            sheds.append((i, e.tenant, e.reason, e.retry_after_seconds))
        for _ in range(int(rng.randint(0, 3))):
            backend.step()
    for s in streams:
        s.result(timeout=WAIT)
    return dict(
        lanes={k: s.lane for k, s in sessions.items()}, sheds=sheds,
        results=[(s.sim_result.task_id, s.sim_result.worker_id,
                  s.sim_result.finished_at, s.sim_result.duration,
                  s.sim_result.warm, s.result(timeout=WAIT))
                 for s in streams],
        sources=[(d.worker_id, d.source.name, d.donor, d.t)
                 for d in backend.fetch_history()],
        admission=fd.stats()["admission"], now=backend.now)


def test_sim_front_door_matches_reference():
    got = _sim_sequence(tcore, tserving)
    assert got == _sim_sequence(jcore, jserving)
    assert got["sheds"] and got["results"]
    assert {r[-1] == [0] for r in got["results"]} == {True}
    assert len(set(got["lanes"].values())) == 2


def test_routing_lanes_sticky_and_parity_with_live(smol):
    """tests/test_frontdoor.py's live/sim routing case on the port: the
    same sticky lanes, admission counts and FetchSource set live and
    simulated."""
    cfg, _, _, tmodel = smol
    ps = _prompts(cfg, 4, seed=12)
    mgr = PCMManager(mode=ContextMode.FULL, n_workers=2)
    try:
        client = PCMClient(backend=mgr)
        ctx = client.context(_recipe(tmodel, dict(SLOT, megastep=4), []))
        ctx.warm_up()
        fd = client.frontdoor(lanes=2)
        live_lanes = []
        for i, p in enumerate(ps):
            with client.session(ctx, session_id=f"sess-{3 + i}",
                                tenant="acme") as sess:
                live_lanes.append(sess.lane)
                sess.submit(p, max_new_tokens=6).result(timeout=WAIT)
        live_sources = {d.source for d in mgr.fetch_history()}
        live_stats = fd.stats()["admission"]
    finally:
        mgr.shutdown()

    backend = SimulatorBackend(n_workers=2)
    sclient = PCMClient(backend=backend)
    sctx = sclient.context(make_recipe("fd.engine", lambda: {"v": 1}))
    sctx.warm_up()
    sfd = sclient.frontdoor(lanes=2)
    sim_lanes = []
    for i, p in enumerate(ps):
        with sclient.session(sctx, session_id=f"sess-{3 + i}",
                             tenant="acme") as sess:
            sim_lanes.append(sess.lane)
            sess.submit(p, max_new_tokens=6).result(timeout=WAIT)
    assert sim_lanes == live_lanes and len(set(live_lanes)) == 2
    assert {d.source for d in backend.fetch_history()} == live_sources
    sim_stats = sfd.stats()["admission"]
    assert (live_stats["admitted"], live_stats["shed"]) == \
        (sim_stats["admitted"], sim_stats["shed"])
