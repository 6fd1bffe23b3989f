"""The port's dense GQA decoders (granite-3-2b, stablelm-12b,
nemotron-4-15b) and its sliding-window decoder (h2o-danube-1.8b) against
the JAX package, on the CPU, at reduced size (2 layers, d_model 64, f32):
the same numpy-seeded weights and inputs through both packages.

* Each architecture's logits and its weights' round trip through
  ``weights.from_jax_params``/``to_jax_params``; greedy tokens equal to
  the JAX ``InferenceEngine``'s at megastep 1 and 4 on the slot cache;
  for the three full-attention models the paged pool with prefix sharing
  equal to the reference's, paged equal to slot and shared equal to cold
  bit for bit.
* h2o-danube's ring buffers (window 32): prompts inside, across and over
  the window, padded waves, decodes that wrap the ring; the reference's
  prefill cache write (``repro.models.transformer._write_prefill_kv``)
  keeps the last window columns of the padded wave from column 0, so once
  a prompt or its wave is longer than the window a decode attends another
  key set than ``forward``. The port mirrors that, and
  ``test_danube_prefill_then_decode_matches_reference`` pins it case by
  case. The paged and prefix-sharing fallbacks with the reference's
  reasons, and ``live_bytes``.
* The plain kernels at head dims 80 (danube) and 160 (stablelm) against
  the reference's ``kernels/ref.py``, and one reduced model at each of
  those head dims end to end.
* One reduced-danube train step, and ``launch/serve.py --arch`` on each
  id.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced_config as jax_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serving import InferenceEngine as JaxEngine  # noqa: E402
from repro.train import OptimizerConfig as JaxOpt  # noqa: E402
from repro.train import init_state as jax_init_state  # noqa: E402
from repro.train import make_train_step as jax_train_step  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.decode_attention import \
    splitkv_decode_plain  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import InferenceEngine, Request  # noqa: E402
from repro_torch.train import (OptimizerConfig, init_state,  # noqa: E402
                               make_train_step, trainable)
from repro_torch.weights import from_jax_params, to_jax_params  # noqa: E402

FULL = ["granite-3-2b", "stablelm-12b", "nemotron-4-15b"]
ARCHS = FULL + ["h2o-danube-1.8b"]
DANUBE = "h2o-danube-1.8b"
# the fp32 tolerance of tests/test_kernels.py
TOL = {"float32": 2e-4, "bfloat16": 3e-2}
ENGINE = dict(slots=4, cache_len=64, prefill_buckets=(16, 32))
PAGED = dict(ENGINE, paged=True, page_size=8)


def build_pair(arch, **overrides):
    """(reference model, its params, the port's model on the same weights),
    reduced, on the CPU."""
    jm = jax_build(jax_config(arch, **overrides))
    params = jm.init(jax.random.PRNGKey(0))
    cfg = get_reduced_config(arch, **overrides)
    tm = build_model(cfg, device="cpu", params=from_jax_params(
        jax.device_get(params), cfg, "cpu"))
    return jm, params, tm


@pytest.fixture(scope="module")
def models():
    return {arch: build_pair(arch) for arch in ARCHS}


def prompts(n, seed=0, lo=3, hi=30):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(8, 512, size=rng.randint(lo, hi)))
            for _ in range(n)]


def shared_prompts(n, seed=4):
    """Few-shot-like prompts: one 24-token preamble (3 pages of 8), then
    3-12 tokens of each row's own."""
    rng = np.random.RandomState(seed)
    pre = list(rng.randint(8, 512, size=24))
    return [pre + list(rng.randint(8, 512, size=rng.randint(3, 13)))
            for _ in range(n)]


def engine(model, **kw):
    return InferenceEngine(model, device="cpu", **{**ENGINE, **kw})


def run_keeping_logits(eng, ps, max_new):
    reqs = [eng.submit(Request(prompt=list(p), max_new_tokens=max_new,
                               keep_logits=True)) for p in ps]
    eng.run_to_completion()
    return reqs


# ---------------------------------------------------------- the models ----
def test_registry_serves_the_four_and_refuses_qwen3_moe(monkeypatch):
    """The four are served; qwen3-moe's config is there to plan, and
    building it on a device of one H100's 80 GB is refused, for its
    size, before anything is allocated."""
    from repro_torch.models import registry
    for arch in ARCHS:
        assert get_config(arch).arch_id == arch
    qwen = get_config("qwen3-moe-235b-a22b")
    assert (qwen.moe.n_experts, qwen.moe.experts_per_token) == (128, 8)
    monkeypatch.setattr(registry, "_device_bytes", lambda dev: 80 * 10**9)
    with pytest.raises(ValueError, match="470 GB in bf16, more than the "
                                         "80 GB"):
        build_model(qwen, device="cpu")
    assert get_config(DANUBE).sliding_window == 4096
    assert get_config("stablelm-12b").resolved_head_dim == 160
    assert get_config(DANUBE).resolved_head_dim == 80
    cfg = get_config("nemotron-4-15b")
    assert cfg.n_heads // cfg.n_kv_heads == 6


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(models, arch):
    """Logits of a padded batch (lengths masking the keys past them)."""
    jm, params, tm = models[arch]
    toks = np.random.RandomState(1).randint(8, 512, size=(3, 50)).astype(
        np.int32)
    lengths = np.array([50, 33, 9], np.int32)
    jl, _ = jm.forward(params, {"tokens": jnp.asarray(toks),
                                "lengths": jnp.asarray(lengths)})
    tl = tm.forward(torch.from_numpy(toks), torch.from_numpy(lengths))
    rows = np.arange(50)[None, :] < lengths[:, None]
    err = np.abs(np.asarray(jl) - tl.numpy())[rows]
    assert float(err.max()) < TOL["float32"]


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_round_trip(models, arch):
    """from_jax_params then to_jax_params gives the reference's tree back:
    LayerNorm biases (stablelm, nemotron), the untied unembedding (danube,
    stablelm, nemotron), the tied table alone (granite)."""
    _, params, tm = models[arch]
    flat = dict(jax.tree_util.tree_flatten_with_path(
        jax.device_get(params))[0])
    back = to_jax_params(dict(tm.state_dict()), tm.cfg)
    back_flat = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), back))[0])
    assert set(back_flat) == set(flat)
    for path, leaf in flat.items():
        assert np.array_equal(np.asarray(leaf, np.float32),
                              back_flat[path]), path
    names = set(tm.state_dict())
    assert ("embed.unembed" in names) == (not tm.cfg.tie_embeddings)
    assert ("layers.0.ln1.bias" in names) == (tm.cfg.norm == "layernorm")


@pytest.fixture(scope="module")
def jax_greedy(models):
    out = {}
    for arch in ARCHS:
        jm, params, _ = models[arch]
        out[arch] = JaxEngine(jm, params, **ENGINE).generate(
            prompts(9), max_new_tokens=10)
    return out


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_matches_reference_engine(models, jax_greedy, arch, K):
    out = engine(models[arch][2], megastep=K).generate(prompts(9),
                                                       max_new_tokens=10)
    assert out == jax_greedy[arch]


@pytest.mark.parametrize("arch", FULL)
def test_paged_sharing_matches_reference(models, arch):
    """The paged pool with prefix sharing: the reference engine's tokens;
    the paged pool's and the slot cache's the same; the shared run's
    first-token logits bitwise the cold paged run's."""
    jm, params, tm = models[arch]
    ps = shared_prompts(8)
    want = JaxEngine(jm, params, **PAGED, megastep=4,
                     prefix_sharing=True).generate(ps, max_new_tokens=8)
    sh = engine(tm, **PAGED, megastep=4)
    assert sh.prefix_fallback is None and sh.stats.decode_path == "paged"
    shared = run_keeping_logits(sh, ps, 8)
    assert sh.stats.prefix_hits > 0
    cold = run_keeping_logits(engine(tm, **PAGED, megastep=4,
                                     prefix_sharing=False), ps, 8)
    slot = engine(tm, megastep=4).generate(ps, max_new_tokens=8)
    assert [r.generated for r in shared] == want
    assert [r.generated for r in cold] == slot == want
    for a, b in zip(shared, cold):
        assert torch.equal(a.first_logits, b.first_logits)


# ---------------------------------------------- the sliding-window ring ----
def _prefill_decode(jm, params, tm, lens, S, cache_len=64):
    """Both packages: prefill a wave of width S (rows right-padded to
    ``lens``), then one decode step of each row's greedy first token.
    Returns (reference decode logits, port decode logits, forward over
    the same S + 1 tokens at the new token)."""
    B = len(lens)
    rng = np.random.RandomState(S + sum(lens))
    toks = np.zeros((B, S), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.randint(8, 512, size=n)
    lengths = np.asarray(lens, np.int32)
    jcache = jm.init_cache(B, cache_len)
    jl, jcache = jm.prefill(params, jnp.asarray(toks), jnp.asarray(lengths),
                            jcache)
    first = np.asarray(jnp.argmax(jl[:, :512], axis=-1)).astype(np.int32)
    jd, _ = jm.decode_step(params, jnp.asarray(first)[:, None],
                           jnp.asarray(lengths), jcache)
    tcache = tm.init_cache(B, cache_len)
    tl = tm.prefill(torch.from_numpy(toks), torch.from_numpy(lengths),
                    tcache)
    assert np.array_equal(first, torch.argmax(tl[:, :512], -1).numpy())
    td = tm.decode_step(torch.from_numpy(first)[:, None],
                        torch.from_numpy(lengths), tcache)
    fwd = []
    for i, n in enumerate(lens):
        seq = np.concatenate([toks[i, :n], first[i:i + 1]])[None]
        fwd.append(tm.forward(torch.from_numpy(seq))[0, -1])
    return np.asarray(jd), td.numpy(), torch.stack(fwd).numpy()


# (row lengths, wave width S, the reference differs from forward): inside,
# at and over the window of 32 without padding, and the probe's padded waves
DANUBE_CASES = [([20], 20, False), ([32], 32, False), ([64], 64, False),
                ([40], 40, True), ([20, 48], 48, True), ([40, 48], 48, True)]


@pytest.mark.parametrize("lens,S,differs", DANUBE_CASES,
                         ids=["in-20", "at-32", "over-64", "over-40",
                              "20-in-wave-48", "40-in-wave-48"])
def test_danube_prefill_then_decode_matches_reference(models, lens, S,
                                                      differs):
    """Prefill then one decode step through the ring, against the reference
    at the same wave width: equal within the fp32 tolerance in every case.
    Where the reference's decode differs from ``forward`` over the same
    tokens (the first row of a wave that is longer than the window, not a
    multiple of it), the port's differs as much; elsewhere both equal
    ``forward``."""
    jd, td, fwd = _prefill_decode(*models[DANUBE], lens, S)
    assert float(np.abs(jd - td).max()) < TOL["float32"]
    gap_ref = float(np.abs(jd[0] - fwd[0]).max())
    gap_port = float(np.abs(td[0] - fwd[0]).max())
    if differs:
        assert gap_ref > 0.05
        assert abs(gap_ref - gap_port) < TOL["float32"]
    else:
        assert max(gap_ref, gap_port) < TOL["float32"]


def test_danube_ring_wraps_like_the_reference(models):
    """Greedy through the engine: prompts inside, across and over the
    window, one wave padded to 48 (rows of 20 and 40 in it), decodes long
    enough that every row's ring wraps, at megastep 1 and 4."""
    jm, params, tm = models[DANUBE]
    rng = np.random.RandomState(9)
    lens = [20, 40, 10, 45, 5, 31, 32, 33, 50]
    ps = [list(rng.randint(8, 512, size=n)) for n in lens]
    kw = dict(ENGINE, prefill_buckets=(16, 48))
    want = JaxEngine(jm, params, **kw).generate(ps, max_new_tokens=40)
    assert max(len(p) + len(o) for p, o in zip(ps, want)) > 64 - 2
    assert tm.init_cache(1, 64)["k"].shape[2] == 32
    for K in (1, 4):
        out = engine(tm, megastep=K, **kw).generate(ps, max_new_tokens=40)
        assert out == want


def test_danube_paged_and_prefix_fallbacks(models):
    jm, params, tm = models[DANUBE]
    ref_eng = JaxEngine(jm, params, **PAGED)
    eng = engine(tm, **PAGED)
    assert not eng._paged and eng.stats.decode_path == "full"
    assert eng.paged_fallback == ref_eng.paged_fallback == (
        "model has no paged decode path (SSM/xLSTM state and "
        "sliding-window ring buffers keep the slot cache)")
    assert eng.prefix_fallback == ref_eng.prefix_fallback == (
        "engine is not paged: " + eng.paged_fallback)
    assert tm.decode_paged is None and tm.prefill_shared is None
    assert eng.generate(prompts(5), max_new_tokens=6) == \
        engine(tm).generate(prompts(5), max_new_tokens=6)


def test_cache_that_does_not_page_is_refused_with_the_reference_reason(
        models):
    """A model that has a paged decode but whose cache leaves do not scale
    with cache_len (here granite's, capped as a ring would be) keeps the
    slot cache with the reference's ``pageable`` reason."""
    tm = models["granite-3-2b"][2]
    real = tm.init_cache

    def capped(batch, cache_len, dtype=None, device=None):
        return real(batch, min(cache_len, 32), dtype, device)
    tm.init_cache = capped
    try:
        eng = engine(tm, **PAGED)
    finally:
        del tm.init_cache
    assert not eng._paged
    assert eng.paged_fallback == (
        "cache leaves are not (batch, seq)-adjacent or do not scale with "
        "cache_len")


@pytest.mark.parametrize("cache_len", [64, 32])
def test_danube_live_bytes_match_reference(models, cache_len):
    """At cache_len 64 the ring (32 positions) does not scale with the
    cache length and counts whole; at cache_len 32 == window it does and
    is pro-rated by the live tokens, as in the reference."""
    jm, params, tm = models[DANUBE]
    kw = dict(ENGINE, cache_len=cache_len)
    ref_eng = JaxEngine(jm, params, **kw)
    eng = engine(tm, cache_len=cache_len)
    for e in (ref_eng, eng):
        e.submit(Request(prompt=prompts(1, seed=21)[0][:12],
                         max_new_tokens=8))
        e.step()
    snap = eng.snapshot()
    assert snap["live_bytes"] == ref_eng.snapshot()["live_bytes"]
    if cache_len == 64:
        assert snap["live_bytes"] == snap["capacity_bytes"]
    else:
        assert snap["live_bytes"] < snap["capacity_bytes"]


# ------------------------------------------- head dims 80 and 160, plain ----
def _both(seed, shape):
    x = np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - b.float().numpy())))


@pytest.mark.parametrize("D", [80, 160])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (8, 2), (12, 2)])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 64)])
def test_plain_flash_attention_wide_heads_match_reference(D, H, Hkv, causal,
                                                          window):
    B, S = 2, 160
    qj, qt = _both(0, (B, S, H, D))
    kj, kt = _both(1, (B, S, Hkv, D))
    vj, vt = _both(2, (B, S, Hkv, D))
    rep = H // Hkv

    def bh(x):  # (B, S, H, D) -> the reference's (B * H, S, D)
        return jnp.transpose(x, (0, 2, 1, 3)).reshape(-1, S, D)
    exp = jref.flash_attention_ref(bh(qj), bh(jnp.repeat(kj, rep, axis=2)),
                                   bh(jnp.repeat(vj, rep, axis=2)),
                                   causal=causal, window=window,
                                   scale=D ** -0.5)
    exp = jnp.transpose(exp.reshape(B, H, S, D), (0, 2, 1, 3))
    out = ref.flash_attention_ref(qt, kt, vt, causal=causal, window=window,
                                  scale=D ** -0.5)
    assert _err(exp, out) < TOL["float32"]


@pytest.mark.parametrize("D", [80, 160])
@pytest.mark.parametrize("H,Hkv,Skv", [(8, 2, 256), (12, 2, 300),
                                       (4, 4, 100)])
def test_plain_decodes_wide_heads_match_reference(D, H, Hkv, Skv):
    """flash_decode_ref, the split-and-combine arithmetic (splits of 256
    and of 64) and paged_decode_ref (pages of 7 over a scattered table),
    against the reference's plain decode."""
    B = 4
    qj, qt = _both(0, (B, H, D))
    kj, kt = _both(1, (B, Skv, Hkv, D))
    vj, vt = _both(2, (B, Skv, Hkv, D))
    lengths = np.array([Skv, 64, 65, 1], np.int32)
    exp = jref.flash_decode_ref(qj, kj, vj, jnp.asarray(lengths),
                                scale=D ** -0.5)
    lt = torch.from_numpy(lengths)
    assert _err(exp, ref.flash_decode_ref(qt, kt, vt, lt,
                                          scale=D ** -0.5)) < TOL["float32"]
    for split in (256, 64):
        out = splitkv_decode_plain(qt, kt, vt, lt, scale=D ** -0.5,
                                   split=split)
        assert _err(exp, out) < TOL["float32"]
    P = 7
    n = -(-Skv // P)
    perm = np.random.RandomState(3).permutation(B * n).astype(np.int32)
    pad = n * P - Skv
    kpad = np.pad(np.asarray(kj), ((0, 0), (0, pad), (0, 0), (0, 0)))
    vpad = np.pad(np.asarray(vj), ((0, 0), (0, pad), (0, 0), (0, 0)))
    kp = np.zeros((B * n + 1, P, Hkv, D), np.float32)
    vp = np.zeros_like(kp)
    kp[perm] = kpad.reshape(B * n, P, Hkv, D)
    vp[perm] = vpad.reshape(B * n, P, Hkv, D)
    pt = perm.reshape(B, n)
    jexp = jref.paged_decode_ref(qj, jnp.asarray(kp), jnp.asarray(vp),
                                 jnp.asarray(pt), jnp.asarray(lengths),
                                 scale=D ** -0.5)
    out = ref.paged_decode_ref(qt, torch.from_numpy(kp), torch.from_numpy(vp),
                               torch.from_numpy(pt), lt, scale=D ** -0.5)
    assert _err(jexp, out) < TOL["float32"]
    assert _err(exp, out) < TOL["float32"]


@pytest.mark.parametrize("arch,head_dim", [(DANUBE, 80),
                                           ("stablelm-12b", 160)])
def test_reduced_model_at_wide_head_dim_matches_reference(arch, head_dim):
    """A reduced model at head dim 80 or 160: logits and greedy tokens
    through the engine (danube's ring wrapping) against the reference."""
    jm, params, tm = build_pair(arch, head_dim=head_dim)
    toks = np.random.RandomState(2).randint(8, 512, size=(2, 40)).astype(
        np.int32)
    jl, _ = jm.forward(params, {"tokens": jnp.asarray(toks)})
    assert float(np.abs(np.asarray(jl) - tm.forward(
        torch.from_numpy(toks)).numpy()).max()) < TOL["float32"]
    ps = prompts(6, seed=8, hi=40)
    want = JaxEngine(jm, params, **ENGINE).generate(ps, max_new_tokens=24)
    assert engine(tm, megastep=4).generate(ps, max_new_tokens=24) == want


# ------------------------------------------------- training and the CLI ----
def test_danube_train_step_matches_reference(models):
    """One train step of the reduced danube (every layer windowed): the
    loss of the reference's make_train_step."""
    jm, params, _ = models[DANUBE]
    cfg = get_reduced_config(DANUBE)
    model = build_model(cfg, device="cpu", params=from_jax_params(
        jax.device_get(params), cfg, "cpu"))
    ocfg = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    toks = np.random.RandomState(1).randint(0, 512, size=(4, 48)).astype(
        np.int32)
    labels = toks.copy()
    labels[:, :5] = -100
    jstep = jax.jit(jax_train_step(jm, JaxOpt(**ocfg), accum_steps=1,
                                   ce_chunk=16))
    _, _, jmet = jstep(params, jax_init_state(params),
                       {"tokens": jnp.asarray(toks),
                        "labels": jnp.asarray(labels)})
    named = trainable(model)
    _, _, met = make_train_step(model, OptimizerConfig(**ocfg),
                                accum_steps=1, ce_chunk=16)(
        named, init_state(named), {"tokens": torch.from_numpy(toks),
                                   "labels": torch.from_numpy(labels)})
    assert abs(float(met["loss"]) - float(jmet["loss"])) < 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_each_arch(arch, capsys):
    serve.main(["--arch", arch, "--claims", "4", "--batch-size", "4",
                "--workers", "1", "--device", "cpu"])
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[serve] mode=full")]
    assert len(line) == 1 and "claims=4 accuracy=" in line[0]
    ctx = serve.build_context(arch, 2, 64, device="cpu")
    assert ctx["cfg"] == dataclasses.replace(get_reduced_config(arch))
    assert ctx["engine"].generate([[2, 5, 9]], max_new_tokens=2)
