"""The port's InferenceEngine, slot cache and paged pool: greedy output
equal to the JAX engine's on the same weights and prompts (reduced
smollm2-1.7b, f32, CPU), and the reference's internal invariants
re-asserted inside the port: megastep parity, batching invariance, drain ==
continuous admission, offload/restore/continue bit for bit, paged ==
slot cache, prefix-shared == cold, and the page pool's bookkeeping
(tests/test_serving.py's paged tests, tests/test_prefix.py's engine
tests)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced_config as jax_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serving import InferenceEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.data import HashTokenizer, fever  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import (InferenceEngine, Request,  # noqa: E402
                                 RequestState)
from repro_torch.serving.sampler import sample  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

ENGINE = dict(slots=4, cache_len=64, prefill_buckets=(16, 32))


@pytest.fixture(scope="module")
def smol():
    jcfg = jax_config("smollm2-1.7b")
    jmodel = jax_build(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    tcfg = get_reduced_config("smollm2-1.7b")
    tmodel = build_model(tcfg, device="cpu", params=from_jax_params(
        jax.device_get(params), tcfg, "cpu"))
    return jmodel, params, tmodel


def prompts(n, seed=0, vocab=512):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(8, vocab, size=rng.randint(3, 14)))
            for _ in range(n)]


def fact_prompts(n_claims=8):
    tok = HashTokenizer(512)
    return [tok.encode(fever.render_prompt(c, t))
            for t in fever.PROMPT_CANDIDATES
            for c in fever.claim_batch(range(n_claims))]


def engine(model, **kw):
    return InferenceEngine(model, device="cpu", **{**ENGINE, **kw})


@pytest.fixture(scope="module")
def jax_greedy(smol):
    jmodel, params, _ = smol
    e = JaxEngine(jmodel, params, **ENGINE)
    pe = JaxEngine(jmodel, params, **ENGINE, megastep=4, paged=True,
                   page_size=8, prefix_sharing=False)
    return {"tokens8": e.generate(prompts(9), max_new_tokens=8),
            "facts": e.generate(fact_prompts(), max_new_tokens=1),
            "paged8": pe.generate(prompts(9), max_new_tokens=8)}


@pytest.mark.parametrize("K", [1, 4, 8])
def test_greedy_matches_reference_engine(smol, jax_greedy, K):
    out = engine(smol[2], megastep=K).generate(prompts(9), max_new_tokens=8)
    assert out == jax_greedy["tokens8"]


@pytest.mark.parametrize("K", [1, 4])
def test_fact_verification_matches_reference_engine(smol, jax_greedy, K):
    out = engine(smol[2], megastep=K).generate(fact_prompts(),
                                               max_new_tokens=1)
    assert out == jax_greedy["facts"]
    assert all(len(o) == 1 for o in out)


def _with_stops(model, ps, stop_tokens, K, max_new_tokens=12):
    eng = engine(model, megastep=K)
    reqs = [eng.submit(Request(prompt=list(p), max_new_tokens=max_new_tokens,
                               stop_tokens=stop_tokens)) for p in ps]
    eng.run_to_completion()
    return [r.generated for r in reqs], eng


def test_megastep_parity_greedy(smol):
    """Greedy outputs are identical for K in {1, 4}, including stop-token
    exits in the middle of a megastep on mixed-length prompts."""
    model = smol[2]
    ps = prompts(9, seed=7)
    base, _ = _with_stops(model, ps, (1,), 1)
    stop = next(t for out in base for t in out[1:])
    outs = {}
    for K in (1, 4):
        outs[K], eng = _with_stops(model, ps, (1, stop), K)
        assert eng.stats.decode_tokens == sum(len(o) - 1 for o in outs[K])
    assert outs[1] == outs[4]
    assert any(o[-1] == stop and len(o) < 12 for o in outs[1]), \
        "stop token never fired — test is vacuous"


def test_batching_invariance(smol):
    """A request's output does not depend on what shares its batch."""
    model = smol[2]
    ps = prompts(6, seed=3)
    multi = engine(model, slots=3, prefill_buckets=(16,)).generate(
        ps, max_new_tokens=5)
    solo = [engine(model, slots=1, prefill_buckets=(16,)).generate(
        [p], max_new_tokens=5)[0] for p in ps]
    assert multi == solo


@pytest.mark.parametrize("K", [1, 4])
def test_drain_and_continuous_admission_agree(smol, K):
    model = smol[2]
    ps = prompts(11, seed=5)
    cont = engine(model, megastep=K).generate(ps, max_new_tokens=7)
    drain = engine(model, megastep=K, admission="drain").generate(
        ps, max_new_tokens=7)
    assert cont == drain


def test_offload_restore_continue_bit_identical(smol):
    model = smol[2]
    ps = prompts(7, seed=11)
    ref = engine(model, megastep=4).generate(ps, max_new_tokens=9)

    eng = engine(model, megastep=4)
    reqs = [eng.submit(Request(prompt=list(p), max_new_tokens=9))
            for p in ps]
    eng.step()
    assert eng.active and eng.queue, "nothing in flight — test is vacuous"
    params_before = {n: p.clone() for n, p in model.named_parameters()}
    cache_before = {n: t.clone() for n, t in eng.cache.items()}
    host = eng.offload_device_state()
    assert eng.offloaded and eng.snapshot()["offloaded"]
    assert all(p.numel() == 0 for p in model.parameters())
    with pytest.raises(RuntimeError):
        eng.step()
    with pytest.raises(RuntimeError):
        eng.offload_device_state()
    eng.restore_device_state(host)
    for n, p in model.named_parameters():
        assert torch.equal(p, params_before[n])
    for n, t in eng.cache.items():
        assert torch.equal(t, cache_before[n])
    eng.run_to_completion()
    assert [r.generated for r in reqs] == ref
    assert eng.stats.compiles == 0


def test_masked_slots_cache_unchanged(smol):
    """Free slots' cache rows are bit-for-bit unchanged by megasteps."""
    eng = engine(smol[2], megastep=4)
    eng.generate(prompts(4, seed=2), max_new_tokens=3)
    before = {n: t.clone() for n, t in eng.cache.items()}
    eng.generate([prompts(1, seed=9)[0]], max_new_tokens=10)
    busy = 0  # the wave lands in the first free slot
    for n, t in eng.cache.items():
        for s in range(1, 4):
            assert torch.equal(t[:, s], before[n][:, s])
        assert not torch.equal(t[:, busy], before[n][:, busy])


def test_slot_reuse_stats_and_snapshot(smol):
    eng = engine(smol[2], slots=2, prefill_buckets=(16,))
    outs = eng.generate(prompts(7), max_new_tokens=3)
    assert len(outs) == 7 and all(1 <= len(o) <= 3 for o in outs)
    st = eng.snapshot()
    assert st["stats"]["completed"] == 7
    assert st["free_slots"] == 2 and st["active"] == 0
    assert st["capacity_bytes"] == 2 * 2 * 2 * 64 * 4 * 16 * 4
    assert st["stats"]["compiles"] == 0


def test_priority_queue_and_cancel(smol):
    eng = engine(smol[2], slots=1, prefill_buckets=(16,))
    a = eng.submit(Request(prompt=[5, 6, 7], max_new_tokens=4))
    b = eng.submit(Request(prompt=[8, 9], max_new_tokens=4))
    c = eng.submit(Request(prompt=[10, 11], max_new_tokens=4, priority=1))
    assert list(eng.queue) == [c, a, b]
    assert eng.cancel(b) and b.state.value == "cancelled"
    eng.step()                                  # admits c only
    assert c.slot == 0 and eng.active
    assert eng.cancel(c)
    assert not eng.active and eng.free_slots
    eng.run_to_completion()
    assert a.done and len(a.generated) == 4 and not eng.cancel(a)


def test_rejections(smol):
    model = smol[2]
    eng = engine(model, cache_len=16)
    with pytest.raises(ValueError):
        eng.submit(Request(prompt=list(range(99))))
    with pytest.raises(ValueError):
        eng.submit(Request(prompt=[3], stop_tokens=(1, 2, 3, 4, 5)))
    with pytest.raises(ValueError):
        InferenceEngine(model, device="cpu", paged=True, page_size=0)
    with pytest.raises(ValueError):
        InferenceEngine(model, device="cpu", admission="eager")


def test_keep_logits_and_streaming(smol):
    eng = engine(smol[2])
    seen = []
    r = eng.submit(Request(prompt=[2, 40, 41], max_new_tokens=5,
                           keep_logits=True,
                           on_token=lambda req, t, i: seen.append((i, t))))
    eng.run_to_completion()
    assert r.first_logits.shape == (smol[2].cfg.padded_vocab,)
    assert int(torch.argmax(r.first_logits[:smol[2].cfg.vocab_size])) == \
        r.generated[0]
    assert seen == list(enumerate(r.generated))


def test_sampler_greedy_masks_padded_vocab_and_inactive_rows():
    logits = torch.tensor([[0.0, 1.0, 5.0, 9.0], [2.0, 2.0, 1.0, 0.0],
                           [0.0, 3.0, 0.0, 0.0]])
    g = torch.Generator().manual_seed(0)
    toks = sample(logits, g, torch.zeros(3), vocab_size=3,
                  active=torch.tensor([True, True, False]),
                  fallback=torch.tensor([7, 7, 7], dtype=torch.int32))
    # row 0: index 3 is padding; row 1: a tie goes to the first index
    assert toks.tolist() == [2, 0, 7] and toks.dtype == torch.int32


def test_sampler_temperature_draws_the_softmax_distribution():
    """Temperature sampling cannot match jax.random.categorical token for
    token; it is held to the distribution instead."""
    n = 20000
    logits = torch.log(torch.tensor([[0.1, 0.2, 0.7]])).repeat(n, 1)
    g = torch.Generator().manual_seed(0)
    toks = sample(logits, g, torch.ones(n))
    freq = torch.bincount(toks.long(), minlength=3).float() / n
    assert torch.allclose(freq, torch.tensor([0.1, 0.2, 0.7]), atol=0.015)
    hot = sample(logits, g, torch.full((n,), 0.5))   # p^2, renormalised
    freq = torch.bincount(hot.long(), minlength=3).float() / n
    exp = torch.tensor([0.01, 0.04, 0.49]) / 0.54
    assert torch.allclose(freq, exp, atol=0.015)


@pytest.mark.parametrize("top_k", [0, 1, 5])
def test_sampler_top_k_matches_reference(top_k):
    """Seeded logits through both samplers: greedy rows give the
    reference's tokens for every top_k; top_k 1 makes a sampled row its
    argmax in both; top_k 5 draws the softmax over the 5 largest logits in
    both (the draws themselves differ: Gumbel-max against
    jax.random.categorical), within 0.015 of each frequency."""
    from repro.serving.sampler import sample as jax_sample
    rs = np.random.RandomState(3)
    logits = rs.standard_normal((6, 40)).astype(np.float32)
    logits[2, 7] = logits[2, 9] = logits[2].max() + 1.0   # a tie at the top
    temps = np.array([0, 0, 1, 1, 0.5, 2], np.float32)
    g = torch.Generator().manual_seed(0)
    ours = sample(torch.from_numpy(logits), g, torch.from_numpy(temps),
                  top_k, vocab_size=36).numpy()
    ref = np.asarray(jax_sample(jax.numpy.asarray(logits),
                                jax.random.PRNGKey(0),
                                jax.numpy.asarray(temps), top_k,
                                vocab_size=36))
    greedy = temps == 0
    assert (ours[greedy] == ref[greedy]).all()
    if top_k == 1:
        assert (ours == ref).all()
        assert (ours == logits[:, :36].argmax(-1)).all()
    if top_k == 5:
        n = 20000
        row = np.tile(logits[3], (n, 1))
        t = np.ones(n, np.float32)
        draws_t = sample(torch.from_numpy(row), g, torch.from_numpy(t), 5,
                         vocab_size=36).numpy()
        draws_j = np.asarray(jax_sample(jax.numpy.asarray(row),
                                        jax.random.PRNGKey(1),
                                        jax.numpy.asarray(t), 5,
                                        vocab_size=36))
        top = np.argsort(logits[3, :36])[-5:]
        p = np.exp(logits[3, top] - logits[3, top].max())
        p /= p.sum()
        for draws in (draws_t, draws_j):
            assert set(np.unique(draws)) == set(top)
            freq = np.array([(draws == i).mean() for i in top])
            assert np.allclose(freq, p, atol=0.015)


def test_request_takes_top_k_as_the_reference_does(smol):
    r = Request(prompt=[5, 9, 14], max_new_tokens=2, top_k=3)
    assert r.top_k == 3 and Request(prompt=[1]).top_k == 0
    eng = InferenceEngine(smol[2], device="cpu", **ENGINE)
    eng.submit(r)
    eng.run_to_completion()
    assert len(r.generated) == 2


# ----------------------------------------------------------- paged pool ----
def paged(model, **kw):
    """tests/test_serving.py's _paged_engine: unshared paged semantics
    (sharing keeps pages past a request's end, so it is off here)."""
    kw = {**ENGINE, "megastep": 4, "paged": True, "page_size": 8,
          "prefix_sharing": False, **kw}
    return InferenceEngine(model, device="cpu", **kw)


def shared_prompts(n, prefix_len=18, seed=0, vocab=512):
    """n prompts sharing a prefix that ends mid-page for page_size 8."""
    rng = np.random.RandomState(seed)
    prefix = list(rng.randint(8, vocab, size=prefix_len))
    return [prefix + list(rng.randint(8, vocab, size=3 + (i % 5)))
            for i in range(n)]


def sharing(model, *, on=True, slots=2, num_pages=None, megastep=4):
    """tests/test_prefix.py's paged_engine."""
    return InferenceEngine(model, device="cpu", slots=slots, cache_len=64,
                           prefill_buckets=(16,), megastep=megastep,
                           paged=True, page_size=8, num_pages=num_pages,
                           prefix_sharing=on)


@pytest.mark.parametrize("K", [1, 4])
def test_paged_greedy_matches_reference_paged_engine(smol, jax_greedy, K):
    eng = paged(smol[2], megastep=K)
    assert eng.snapshot()["decode_path"] == "paged"
    assert eng.generate(prompts(9), max_new_tokens=8) == jax_greedy["paged8"]
    assert eng._alloc.free_pages == eng.num_pages


@pytest.mark.parametrize("K", [1, 8])
def test_paged_vs_slot_greedy_parity(smol, K):
    """test_serving.py:363 — the paged pool generates the slot cache's
    greedy tokens, mid-stream stop-token exits included, and returns every
    page at the end."""
    model = smol[2]
    ps = prompts(9, seed=7)
    base, _ = _with_stops(model, ps, (1,), 1)
    stop = next(t for out in base for t in out[1:])
    want, _ = _with_stops(model, ps, (1, stop), K)
    pg = paged(model, megastep=K)
    assert pg._paged and pg.paged_fallback is None
    rs = [pg.submit(Request(prompt=list(p), max_new_tokens=12,
                            stop_tokens=(1, stop))) for p in ps]
    pg.run_to_completion()
    assert [r.generated for r in rs] == want
    assert any(r.generated[-1] == stop and len(r.generated) < 12
               for r in rs), "stop never fired — test is vacuous"
    assert pg.stats.decode_path == "paged"
    assert pg._alloc.free_pages == pg.num_pages
    assert pg._alloc.live_pages == 0


def test_paged_free_pages_untouched(smol):
    """test_serving.py:424 — pages nobody owns are bit for bit untouched by
    prefill and decode: masked writes land in TRASH."""
    pg = paged(smol[2], slots=2, cache_len=32, prefill_buckets=(16,),
               megastep=2)
    for t in pg.cache.values():
        t.fill_(3.25)
    req = pg.submit(Request(prompt=list(prompts(1, seed=11)[0]),
                            max_new_tokens=12))
    pg.step()
    owned = set(pg._alloc.owned(req.slot))
    assert owned, "request should hold pages mid-stream"
    pg.run_to_completion()
    untouched = sorted(set(range(pg.num_pages)) - owned)
    for t in pg.cache.values():
        assert bool((t[:, untouched] == 3.25).all())


def test_paged_pool_exhaustion_serializes_admission(smol):
    """test_serving.py:449 — when the pool cannot hold another lifetime
    reservation the queue head waits, and every request still completes
    with the unconstrained output."""
    model = smol[2]
    ps = prompts(4, seed=9)
    want = paged(model).generate(ps, max_new_tokens=8)
    tight = paged(model, num_pages=4)
    reqs = [tight.submit(Request(prompt=list(p), max_new_tokens=8))
            for p in ps]
    seen = 0
    while tight.has_work():
        tight.step()
        seen = max(seen, len(tight.active))
    assert [r.generated for r in reqs] == want
    assert seen == 1, "a 4-page pool must serialize admission"
    with pytest.raises(ValueError, match="pages"):
        tight.submit(Request(prompt=list(range(8, 48)), max_new_tokens=8))


def test_paged_capacity_vs_live_bytes(smol):
    """test_serving.py:471 — live_bytes is the exact live pages, up and
    back down to zero; capacity is the pool."""
    pg = paged(smol[2])
    s0 = pg.snapshot()
    assert s0["decode_path"] == "paged" and s0["live_bytes"] == 0
    # 2 layers x (k, v) x 32 pages x 8 tokens x 4 heads x 16 x 4 bytes
    assert s0["capacity_bytes"] == s0["cache_bytes"] == 2 * 2 * 32 * 8 * \
        4 * 16 * 4
    for p in prompts(2, seed=13):
        pg.submit(Request(prompt=list(p), max_new_tokens=8))
    pg.step()
    s1 = pg.snapshot()
    assert 0 < s1["live_bytes"] < s1["capacity_bytes"]
    assert s1["live_pages"] == pg._alloc.live_pages > 0
    assert pg.stats.live_pages > 0
    pg.run_to_completion()
    assert pg.snapshot()["live_bytes"] == 0


def test_hybrid_slot_live_bytes_match_reference(hy):
    """The slot cache's live_bytes pro-rates the K/V leaves only: the
    Mamba2 states (ssm, conv_x, conv_bc) count whole, as in the reference
    (kvcache.live_bytes), idle and with a 12-token prompt in flight."""
    jmodel, params, _, kern = hy
    ref = JaxEngine(jmodel, params, **ENGINE)
    eng = engine(kern)
    assert eng.snapshot()["live_bytes"] == ref.snapshot()["live_bytes"] \
        == 545792
    prompt = prompts(1, seed=21)[0] + list(range(8, 20))
    prompt = prompt[:12]
    assert len(prompt) == 12
    for e in (ref, eng):
        e.submit(Request(prompt=prompt, max_new_tokens=8))
        e.step()
    assert eng.snapshot()["live_bytes"] == ref.snapshot()["live_bytes"] \
        == 559104
    assert eng.snapshot()["live_bytes"] < eng.snapshot()["capacity_bytes"]


def test_seq_leaves_from_shapes_not_names(smol, hy):
    """Which leaves live_bytes pro-rates is read from the shapes, as the
    reference's seq_axes reads it: the K/V leaves of both models, no
    Mamba2 state, and a recurrent leaf of any name counts whole."""
    from repro_torch.serving import kvcache
    for model, want in ((smol[2], {"k", "v"}), (hy[3], {"k", "v"})):
        cache = model.init_cache(2, 16, torch.float32)
        assert kvcache.seq_leaves(model.init_cache, cache, 2, 16,
                                  torch.float32) == want

    def init_cache(batch, cache_len, dtype, device="cpu"):
        return {"kv": torch.zeros((3, batch, cache_len, 4), dtype=dtype,
                                  device=device),
                "cell": torch.zeros((3, batch, 16, 4), dtype=dtype,
                                    device=device)}
    cache = init_cache(2, 16, torch.float32)
    seq = kvcache.seq_leaves(init_cache, cache, 2, 16, torch.float32)
    assert seq == {"kv"}
    # half the tokens live: the sequence leaf halves, the state stays whole
    assert kvcache.live_bytes(cache, seq, 16, 32) == (3 * 2 * 16 * 4 * 4
                                                      * 3 // 2)


def _counting_reference(jmodel):
    """The reference model with a host counter on every decode step the
    megastep's while_loop runs (a debug callback inside the traced
    step)."""
    import dataclasses
    count = [0]

    def bump():
        count[0] += 1

    def decode_step(*args, **kw):
        jax.debug.callback(bump)
        return jmodel.decode_step(*args, **kw)
    return dataclasses.replace(jmodel, decode_step=decode_step), count


@pytest.mark.parametrize("queued", [False, True])
def test_megastep_stop_token_ends_loop_like_reference(smol, queued):
    """With K = 8, a request whose stop token comes at its first decode
    step ends the megastep after one step, as the reference's while_loop
    does; with a request queued under continuous admission, the first
    slot to stop ends it while another slot still decodes. The port's
    decode-step count equals the reference's, tokens too."""
    jmodel, params, model = smol
    ps = prompts(6, seed=17)
    firsts = engine(model).generate(ps, max_new_tokens=2)
    # a prompt whose first decode token differs from its prefill token
    i = next(i for i, f in enumerate(firsts) if f[0] != f[1])
    ps = [ps[i]] + ps[:i] + ps[i + 1:]
    first = firsts[i]
    stop = first[1]  # the token of the first decode step
    trace = ([(ps[0], (stop,))] if not queued else
             [(ps[0], (stop,)), (ps[1], ()), (ps[2], ())])
    cfg = dict(ENGINE, slots=2 if queued else 4, megastep=8)
    counted, ref_steps = _counting_reference(jmodel)
    ref = JaxEngine(counted, params, **cfg)
    ref_out = [ref.submit(Request(prompt=list(p), max_new_tokens=12,
                                  stop_tokens=st)) for p, st in trace]
    ref.run_to_completion()
    outs = {}
    for early in (True, False):
        eng = InferenceEngine(model, device="cpu", **cfg)
        if not early:  # the loop without its exit: the host-known cap only
            eng._keep_decoding = lambda *args: True
        reqs = [eng.submit(Request(prompt=list(p), max_new_tokens=12,
                                   stop_tokens=st)) for p, st in trace]
        eng.run_to_completion()
        outs[early] = ([r.generated for r in reqs], eng.stats.decode_steps)
    assert ref_out[0].generated == [first[0], stop]
    assert outs[True][0] == outs[False][0] == [r.generated for r in ref_out]
    assert outs[True][1] == ref_steps[0]
    # the host-known step cap alone would run more steps: not vacuous
    assert outs[False][1] > ref_steps[0]


def test_paged_offload_restore_midstream(smol):
    """test_serving.py:498 — the snapshot carries live pages only, and
    decode continues bit-identically."""
    model = smol[2]
    ps = prompts(6, seed=19)
    want = paged(model, slots=3).generate(ps, max_new_tokens=12)
    eng = paged(model, slots=3)
    for p in ps:
        eng.submit(Request(prompt=list(p), max_new_tokens=12))
    done = list(eng.step()) + list(eng.step())
    assert eng.active, "offload must happen mid-stream"
    cap = eng.snapshot()["capacity_bytes"]
    host = eng.offload_device_state()
    assert eng.offloaded
    live = sum(t.numel() * t.element_size() for t in host["cache"].values())
    assert 0 < live < cap, "the snapshot ships live pages only"
    assert host["_paged_live_ids"].size == eng._alloc.live_pages
    assert host["cache"]["k"].shape[1] == eng._alloc.live_pages
    eng.restore_device_state(host)
    done += eng.run_to_completion()
    got = [r.generated for r in sorted(done, key=lambda r: r.request_id)]
    assert got == want
    assert eng.stats.compiles == 0


@pytest.mark.parametrize("paged_pool", [True, False])
def test_template_export_and_clone_parity(smol, paged_pool):
    """test_serving.py:529 — a paged template ships no pages and an
    all-TRASH table; the restored clone generates what the donor does,
    builds nothing, and leaves the donor serving (both cache kinds)."""
    model = smol[2]
    ps = prompts(5, seed=23)
    donor = paged(model) if paged_pool else engine(model, megastep=4)
    want = donor.generate(ps, max_new_tokens=6)
    tpl = donor.export_template()
    if paged_pool:
        assert tpl["cache"]["k"].numel() == 0
        assert tpl["_paged_live_ids"].size == 0
        assert bool((tpl["page_table"] == donor.trash).all())
    clone = donor.clone_offloaded()
    assert clone.offloaded and clone.model is not donor.model
    clone.restore_device_state(tpl)
    assert clone.generate(ps, max_new_tokens=6) == want
    assert clone.stats.compiles == 0
    assert donor.generate(ps[:2], max_new_tokens=6) == want[:2]
    if paged_pool:
        assert clone._alloc.live_pages == 0


def test_paged_more_sessions_than_slot_capacity(smol):
    """test_serving.py:551 — at the pool bytes of a 2-slot slot cache the
    paged engine holds 8 short sessions at once."""
    model = smol[2]
    slot = engine(model, slots=2, prefill_buckets=(16,), megastep=4)
    pg = paged(model, slots=8, prefill_buckets=(16,), num_pages=16)
    assert pg.snapshot()["capacity_bytes"] == \
        slot.snapshot()["capacity_bytes"]
    for p in prompts(8, seed=29):
        pg.submit(Request(prompt=list(p), max_new_tokens=2))
    peak = 0
    while pg.has_work():
        pg.step()
        peak = max(peak, pg.stats.live_pages)
    assert peak >= 8 and pg.stats.completed == 8


# ------------------------------------------------------- prefix sharing ----
def test_shared_sessions_bit_identical_to_cold(smol):
    """test_prefix.py:164 — later sessions hit the cache, prefill only
    their tails and produce exactly the unshared engine's tokens; their
    first-token logits are bit for bit the cold prefill's."""
    model = smol[2]
    ps = shared_prompts(6)
    base = sharing(model, on=False)
    eng = sharing(model)
    assert eng.prefix_fallback is None, eng.prefix_fallback
    rb = [base.submit(Request(prompt=list(p), max_new_tokens=12,
                              keep_logits=True)) for p in ps]
    rs = [eng.submit(Request(prompt=list(p), max_new_tokens=12,
                             keep_logits=True)) for p in ps]
    base.run_to_completion()
    eng.run_to_completion()
    assert [r.generated for r in rs] == [r.generated for r in rb]
    for a, b in zip(rs, rb):
        assert torch.equal(a.first_logits, b.first_logits)
    assert eng.stats.prefix_hits >= 4
    assert eng.stats.prefix_tokens_reused >= 4 * 16
    assert sum(r.prefix_tokens for r in rs) == eng.stats.prefix_tokens_reused
    assert eng.stats.cow_copies >= 1
    assert eng.stats.prefill_tokens < base.stats.prefill_tokens / 2
    s = eng.snapshot()
    assert s["prefix_cache"]["hits"] == eng.stats.prefix_hits
    eng._alloc.check(eng._prefix_cache.pages())


def test_hit_mid_page_then_decode_matches_cold(smol):
    """A hit that ends mid-page, then 8 decoded tokens, against a cold run.
    The hit's fresh boundary page must hold the shared positions before
    the boundary as well as the tail: written in place, the tail alone
    would leave them stale and decode would read them."""
    model = smol[2]
    rng = np.random.RandomState(31)
    prefix = list(rng.randint(8, 512, size=21))         # 21 = 2 pages + 5
    a = prefix + list(rng.randint(8, 512, size=6))
    b = prefix + list(rng.randint(8, 512, size=4))
    want = sharing(model, on=False).generate([b], max_new_tokens=8)
    eng = sharing(model)
    eng.generate([a], max_new_tokens=8)
    shared = eng._prefix_cache.match(list(b))[1]      # a's first 3 pages
    r = eng.submit(Request(prompt=list(b), max_new_tokens=8))
    eng.step()
    assert r.prefix_tokens == 21 and eng.stats.cow_copies >= 1
    owned = eng._alloc.owned(r.slot)
    assert owned[:2] == shared[:2] and owned[2] != shared[2]
    for t in eng.cache.values():                  # positions 16..20
        assert torch.equal(t[:, owned[2], :5], t[:, shared[2], :5])
    eng.run_to_completion()
    assert [r.generated] == want and len(r.generated) == 8


def test_mixed_wave_cold_and_hit_rows(smol):
    """test_prefix.py:187 — a wave mixing hits with cold rows stays
    bit-identical."""
    model = smol[2]
    ps = shared_prompts(5, seed=3)
    want = sharing(model, on=False, slots=4).generate(ps, max_new_tokens=10)
    eng = sharing(model, slots=4)
    first = eng.submit(Request(prompt=list(ps[0]), max_new_tokens=10))
    eng.run_to_completion()
    rest = [eng.submit(Request(prompt=list(p), max_new_tokens=10))
            for p in ps[1:]]
    eng.run_to_completion()
    assert [first.generated] + [r.generated for r in rest] == want
    assert eng.stats.prefix_hits == 4


def test_offload_restore_carries_sharing(smol):
    """test_prefix.py:215 — a mid-stream offload of a sharing engine ships
    each shared page once with its refcount; the restore resumes
    bit-identically and the prefix cache keeps serving hits."""
    model = smol[2]
    ps = shared_prompts(4, seed=8)
    want = sharing(model).generate(ps, max_new_tokens=12)
    eng = sharing(model)
    reqs = [eng.submit(Request(prompt=list(p), max_new_tokens=12))
            for p in ps[:2]]
    eng.step()
    host = eng.offload_device_state()
    live = [int(p) for p in host["_paged_live_ids"]]
    assert len(set(live)) == len(live)
    assert any(int(r) > 1 for r in host["_paged_refcounts"])
    eng.restore_device_state(host)
    while eng.has_work():
        eng.step()
    later = [eng.submit(Request(prompt=list(p), max_new_tokens=12))
             for p in ps[2:]]
    eng.run_to_completion()
    assert [r.generated for r in reqs + later] == want
    assert eng.stats.prefix_hits >= 2
    eng._alloc.check(eng._prefix_cache.pages())


def test_cancel_releases_pages_and_pool_recovers(smol):
    """test_prefix.py:247 — cancelling queued and active requests returns
    every reserved page; the pool recovers to fully free."""
    eng = sharing(smol[2], on=False, num_pages=10)
    ps = shared_prompts(4, seed=11)
    for p in ps:
        eng.submit(Request(prompt=list(p), max_new_tokens=12))
    eng.step()
    assert len(eng.active) == 2 and len(eng.queue) == 2
    assert eng._alloc.free_pages == 0
    queued = next(iter(eng.queue))
    assert eng.cancel(queued) and queued.state is RequestState.CANCELLED
    held = eng._alloc.live_pages
    assert eng.cancel(next(iter(eng.active.values())))
    assert eng._alloc.live_pages < held
    eng.run_to_completion()
    assert eng._alloc.free_pages == 10 and eng._alloc.live_pages == 0
    assert len(eng.generate([ps[0]], max_new_tokens=12)[0]) >= 1
    assert eng._alloc.free_pages == 10


def test_cancel_with_sharing_keeps_cache_consistent(smol):
    """test_prefix.py:276 — cancelling a mid-flight hit keeps the refcount
    invariant; dropping the cache frees the pool; output unchanged."""
    model = smol[2]
    eng = sharing(model, num_pages=16)
    ps = shared_prompts(3, seed=13)
    eng.generate([ps[0]], max_new_tokens=8)
    r = eng.submit(Request(prompt=list(ps[1]), max_new_tokens=8))
    eng.step()
    assert eng.cancel(r)
    eng._alloc.check(eng._prefix_cache.pages())
    assert eng.drop_prefix_cache() > 0
    eng._alloc.check(eng._prefix_cache.pages())
    assert eng._alloc.free_pages == 16
    assert eng.generate([ps[2]], max_new_tokens=8) == \
        sharing(model, on=False).generate([ps[2]], max_new_tokens=8)


def test_sharing_resolution_rules(smol):
    """prefix_sharing resolves as the reference's does: off unless paged,
    off when the cache dtype differs from the compute dtype or the page
    size does not divide 1024."""
    model = smol[2]
    assert sharing(model).prefix_fallback is None
    assert "disabled" in sharing(model, on=False).prefix_fallback
    assert engine(model).prefix_fallback is None
    narrow = InferenceEngine(model, device="cpu", slots=2, cache_len=64,
                             paged=True, page_size=8,
                             cache_dtype=torch.bfloat16)
    assert narrow._prefix_cache is None and "dtype" in narrow.prefix_fallback
    odd = InferenceEngine(model, device="cpu", slots=2, cache_len=64,
                          paged=True, page_size=7)
    assert odd._prefix_cache is None and "1024" in odd.prefix_fallback
    short = InferenceEngine(model, device="cpu", slots=2, cache_len=8,
                            paged=True)
    assert not short._paged and short.paged_fallback


# ------------------------------------------------ DeepSeek: MLA + MoE -----
@pytest.fixture(scope="module")
def ds():
    """Reduced deepseek-v2-lite-16b (f32): the reference's model and
    params, and the port's model with the same weights, plain and with
    use_kernels (on the CPU: the kernels' plain versions)."""
    import dataclasses
    jcfg = jax_config("deepseek-v2-lite-16b")
    jmodel = jax_build(jcfg)
    params = jmodel.init(jax.random.PRNGKey(1))
    tcfg = get_reduced_config("deepseek-v2-lite-16b")
    plain = build_model(tcfg, device="cpu", params=from_jax_params(
        jax.device_get(params), tcfg, "cpu"))
    kern = build_model(dataclasses.replace(tcfg, use_kernels=True),
                       device="cpu", params=dict(plain.state_dict()))
    return jmodel, params, plain, kern


PAGED = dict(paged=True, page_size=8, prefix_sharing=False)


@pytest.fixture(scope="module")
def ds_jax_paged(ds):
    jmodel, params, _, _ = ds
    e = JaxEngine(jmodel, params, **ENGINE, megastep=4, **PAGED)
    return e.generate(prompts(9), max_new_tokens=8)


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("kernels", [False, True])
def test_deepseek_paged_greedy_matches_reference_engine(ds, ds_jax_paged, K,
                                                        kernels):
    model = ds[3] if kernels else ds[2]
    eng = engine(model, megastep=K, **PAGED)
    assert eng.stats.decode_path == "paged"
    assert eng.generate(prompts(9), max_new_tokens=8) == ds_jax_paged


@pytest.mark.parametrize("kernels", [False, True])
def test_deepseek_paged_equals_slot_cache(ds, kernels):
    """Port copy of test_serving.py::test_paged_mla_greedy_parity: the
    paged latent pool gives the slot cache's greedy output; on the plain
    route bit for bit, first-token logits included."""
    model = ds[3] if kernels else ds[2]
    ps = prompts(5, seed=3)
    kw = dict(slots=3, cache_len=32, prefill_buckets=(16,), megastep=4)

    def run(**extra):
        eng = InferenceEngine(model, device="cpu", **kw, **extra)
        reqs = [eng.submit(Request(prompt=list(p), max_new_tokens=5,
                                   keep_logits=True)) for p in ps]
        eng.run_to_completion()
        return eng, reqs

    slot, sr = run()
    pg, pr = run(paged=True, page_size=8)
    assert pg._paged and pg.stats.decode_path == "paged"
    assert [r.generated for r in sr] == [r.generated for r in pr]
    if not kernels:
        for a, b in zip(sr, pr):
            assert torch.equal(a.first_logits, b.first_logits)
    assert pg._alloc.free_pages == pg.num_pages


def test_deepseek_prefix_sharing_resolves_off_with_reason(ds):
    model = ds[2]
    eng = engine(model, paged=True, page_size=8)        # sharing requested
    assert eng._paged and eng._prefix_cache is None
    assert eng.prefix_fallback == (
        "model has no shared-prefix prefill (MoE capacity dropping and MLA "
        "recompression are sequence-dependent; SWA does not page)")
    assert eng.snapshot()["prefix_fallback"] == eng.prefix_fallback
    prefix = prompts(1, seed=4)[0] * 3
    ps = [prefix + p for p in prompts(4, seed=5)]
    assert eng.generate(ps, max_new_tokens=4) == engine(
        model, **PAGED).generate(ps, max_new_tokens=4)
    assert eng.stats.prefix_hits == 0


@pytest.mark.parametrize("paged", [False, True])
def test_deepseek_offload_restore_continue_bit_identical(ds, paged):
    """A DeepSeek context demoted in the middle of a stream (requests
    decoding and queued) and restored continues bit for bit: its MLA
    latents (or live latent pages), the MoE weights and the RNG."""
    model = ds[3]
    kw = dict(megastep=4, **(PAGED if paged else {}))
    ps = prompts(7, seed=11)
    ref = engine(model, **kw).generate(ps, max_new_tokens=9)
    eng = engine(model, **kw)
    reqs = [eng.submit(Request(prompt=list(p), max_new_tokens=9))
            for p in ps]
    eng.step()
    assert eng.active and eng.queue, "nothing in flight — test is vacuous"
    params_before = {n: p.clone() for n, p in model.named_parameters()}
    host = eng.offload_device_state()
    assert set(host["cache"]) == {"ckv", "krope"}
    assert all(p.numel() == 0 for p in model.parameters())
    eng.restore_device_state(host)
    for n, p in model.named_parameters():
        assert torch.equal(p, params_before[n])
    eng.run_to_completion()
    assert [r.generated for r in reqs] == ref


# ------------------------------------- Zamba2: Mamba2 + shared attention ---
@pytest.fixture(scope="module")
def hy():
    """Reduced zamba2-7b (f32, 13 layers: 2 groups of 6 + 1 tail, 8 SSM
    heads, shared attention of head dim 16): the reference's model and
    params and the port's model with the same weights, plain and with
    use_kernels (on the CPU: the kernels' plain versions)."""
    import dataclasses
    jcfg = jax_config("zamba2-7b")
    jmodel = jax_build(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    tcfg = get_reduced_config("zamba2-7b")
    plain = build_model(tcfg, device="cpu", params=from_jax_params(
        jax.device_get(params), tcfg, "cpu"))
    kern = build_model(dataclasses.replace(tcfg, use_kernels=True),
                       device="cpu", params=dict(plain.state_dict()))
    return jmodel, params, plain, kern


@pytest.fixture(scope="module")
def hy_jax_greedy(hy):
    jmodel, params, _, _ = hy
    e = JaxEngine(jmodel, params, **ENGINE)
    return {"tokens8": e.generate(prompts(9), max_new_tokens=8),
            "facts": e.generate(fact_prompts(4), max_new_tokens=1)}


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("kernels", [False, True])
def test_hybrid_greedy_matches_reference_engine(hy, hy_jax_greedy, K,
                                                kernels):
    model = hy[3] if kernels else hy[2]
    eng = engine(model, megastep=K)
    assert eng.stats.decode_path == "full"
    assert eng.generate(prompts(9), max_new_tokens=8) == \
        hy_jax_greedy["tokens8"]


def test_hybrid_fact_verification_matches_reference_engine(hy,
                                                           hy_jax_greedy):
    out = engine(hy[3], megastep=4).generate(fact_prompts(4),
                                             max_new_tokens=1)
    assert out == hy_jax_greedy["facts"]


def test_hybrid_paged_request_keeps_the_slot_cache(hy):
    """paged=True on a model with no paged decode falls back to the slot
    cache with the reference's reason, and prefix sharing with it."""
    model = hy[2]
    eng = engine(model, paged=True, page_size=8)
    assert not eng._paged and eng.stats.decode_path == "full"
    assert eng.paged_fallback == (
        "model has no paged decode path (SSM/xLSTM state and "
        "sliding-window ring buffers keep the slot cache)")
    assert eng.prefix_fallback == "engine is not paged: " + eng.paged_fallback
    assert eng.snapshot()["paged_fallback"] == eng.paged_fallback
    assert eng._cache_dtype == torch.float32
    assert eng.generate(prompts(5), max_new_tokens=6) == \
        engine(model).generate(prompts(5), max_new_tokens=6)


def test_hybrid_cache_dtype_reads_the_kv_leaves(hy):
    eng = engine(hy[2], cache_dtype=torch.bfloat16)
    assert eng._cache_dtype == torch.bfloat16
    assert eng.cache["ssm"].dtype == torch.float32
    assert eng.cache["conv_x"].dtype == torch.bfloat16


def test_hybrid_bucket_shorter_than_head_count(hy):
    """Prompts of at most 4 tokens go through a 4-token bucket, shorter
    than the 8 SSM heads: each admitted slot's states are written whole
    over a stale cache, so the output equals a fresh engine's."""
    model = hy[2]
    ps = [p[:4] for p in prompts(6, seed=5)]
    fresh = engine(model, prefill_buckets=(4, 16)).generate(
        ps, max_new_tokens=5)
    eng = engine(model, prefill_buckets=(4, 16))
    for t in eng.cache.values():
        t.normal_(generator=torch.Generator().manual_seed(7))
    st0 = eng.stats.prefill_batches
    assert eng.generate(ps, max_new_tokens=5) == fresh
    assert eng.stats.prefill_batches > st0


def test_hybrid_free_slots_state_unchanged_by_megastep(hy):
    """A free slot's SSM, conv and K/V rows are bit for bit unchanged by
    megasteps of the other slots."""
    eng = engine(hy[3], megastep=4)
    eng.generate(prompts(4, seed=2), max_new_tokens=3)
    before = {n: t.clone() for n, t in eng.cache.items()}
    eng.generate([prompts(1, seed=9)[0]], max_new_tokens=10)
    busy = 0  # the wave lands in the first free slot
    for n, t in eng.cache.items():
        for s in range(1, 4):
            assert torch.equal(t[:, s], before[n][:, s]), n
        assert not torch.equal(t[:, busy], before[n][:, busy]), n


def test_hybrid_offload_restore_continue_bit_identical(hy):
    """A hybrid context demoted mid-stream (requests decoding and queued)
    and restored continues bit for bit: its f32 SSM states, conv states,
    K/V, the f32 A_log/D/dt_bias and the RNG come back as they left."""
    model = hy[3]
    ps = prompts(7, seed=11)
    ref = engine(model, megastep=4).generate(ps, max_new_tokens=9)
    eng = engine(model, megastep=4)
    reqs = [eng.submit(Request(prompt=list(p), max_new_tokens=9))
            for p in ps]
    eng.step()
    assert eng.active and eng.queue, "nothing in flight — test is vacuous"
    cache_before = {n: t.clone() for n, t in eng.cache.items()}
    host = eng.offload_device_state()
    assert set(host["cache"]) == {"k", "v", "ssm", "conv_x", "conv_bc"}
    assert host["cache"]["ssm"].dtype == torch.float32
    assert all(p.numel() == 0 for p in model.parameters())
    eng.restore_device_state(host)
    for n, t in eng.cache.items():
        assert torch.equal(t, cache_before[n]) and t.dtype == \
            cache_before[n].dtype
    eng.run_to_completion()
    assert [r.generated for r in reqs] == ref
