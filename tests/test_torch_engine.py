"""The port's slot-cache InferenceEngine: greedy output equal to the JAX
engine's on the same weights and prompts (reduced smollm2-1.7b, f32, CPU),
and the reference's internal invariants re-asserted inside the port:
megastep parity, batching invariance, drain == continuous admission, and
offload/restore/continue bit for bit."""

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
from repro_torch.serving import InferenceEngine, Request  # noqa: E402
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
    return {"tokens8": e.generate(prompts(9), max_new_tokens=8),
            "facts": e.generate(fact_prompts(), max_new_tokens=1)}


@pytest.mark.parametrize("K", [1, 4])
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
    with pytest.raises(NotImplementedError):
        InferenceEngine(model, device="cpu", paged=True)
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
