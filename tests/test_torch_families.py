"""The port's last one-card model families against the JAX package, on the
CPU, at reduced size (f32): xLSTM-350M (8 blocks: 2 groups of an sLSTM
and 3 mLSTMs), Whisper-small (2 encoder and 2 decoder layers over 24
frames) and Llama-3.2-Vision-11B (10 layers: 2 groups of a gated cross
block and 5 self-attention layers over 12 patches, K/V heads cut to 2 so
the cross-attention is grouped). The same numpy-seeded weights and
frontend inputs go through both packages.

The vision model's gates are zero at init, so a fresh model's cross
blocks add nothing: every vision test sets both gates to 1.0 in the
reference's params before carrying them across, and
``test_vision_patches_move_the_logits`` witnesses that the patches reach
the logits.

* Each architecture: weights through ``from_jax_params``/
  ``to_jax_params``; ``forward`` logits with the frontend inputs;
  ``prefill`` then ``decode_step``; greedy tokens equal to the JAX
  ``InferenceEngine``'s at megastep 1 and 4 with ``extra`` of ``slots``
  rows; the paged fallback's reason; ``live_bytes``; a demote and
  restore mid-stream that continues the same.
* ``extra`` in the snapshot summary, the fingerprint and the wire recipe
  (a shell rebuilt from the recipe continues a demoted audio context the
  same); an ``extra`` that does not fit raises.
* Functions: ``mlstm_prefill``/``mlstm_decode``/``slstm_forward`` with
  padded rows, ``attend_cached_memory`` on both of the reference's plain
  branches and on the kernel route, the encoder's non-causal
  ``attend_prefill``, and the plain kernels at non-causal S != T against
  the reference's ``kernels/ref.py``.
* ``launch/serve.py --arch``: xLSTM serves the reference CLI's claims;
  Whisper with no frontend input fails at the first prefill in both.
"""

import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import CheckpointManager as JaxManager  # noqa: E402
from repro.configs import get_reduced_config as jax_config  # noqa: E402
from repro.data import fever as jfever  # noqa: E402
from repro.data.tokenizer import HashTokenizer as JaxTokenizer  # noqa
from repro.kernels import ref as jref  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.serving import InferenceEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model, extra_inputs  # noqa: E402
from repro_torch.models import input_specs, ssm  # noqa: E402
from repro_torch.models.registry import build_shell  # noqa: E402
from repro_torch.serving import InferenceEngine, Request  # noqa: E402
from repro_torch.serving.engine import engine_from_wire  # noqa: E402
from repro_torch.weights import from_jax_params, to_jax_params  # noqa: E402

ARCHS = ["xlstm-350m", "whisper-small", "llama-3.2-vision-11b"]
XLSTM, WHISPER, VISION = ARCHS
OVERRIDES = {VISION: dict(n_kv_heads=2)}
# the fp32 tolerance of tests/test_kernels.py
TOL = 2e-4
# the reference's CPU rehearsal: 2 slots, 32 positions, one bucket of 16
ENGINE = dict(slots=2, cache_len=32, prefill_buckets=(16,))
FALLBACK = ("model has no paged decode path (SSM/xLSTM state and "
            "sliding-window ring buffers keep the slot cache)")


def frontend(cfg, batch, seed=0):
    """The frontend stub's inputs for ``batch`` rows, from a seed: numpy
    arrays (the reference's and the port's ``extra`` hold the same)."""
    rng = np.random.RandomState(100 + seed)
    return {n: rng.standard_normal(t.shape).astype(np.float32)
            for n, t in extra_inputs(cfg, batch).items()}


def jx(extra):
    return {n: jnp.asarray(a) for n, a in extra.items()}


def tx(extra):
    return {n: torch.from_numpy(a) for n, a in extra.items()}


def build_pair(arch, use_kernels=False):
    """(reference model, its params (vision gates at 1.0), the port's
    model on the same weights, its config), reduced, on the CPU."""
    jm = jax_build(jax_config(arch, **OVERRIDES.get(arch, {})))
    params = jm.init(jax.random.PRNGKey(0))
    if arch == VISION:
        for gate in ("gate_attn", "gate_mlp"):
            params["cross"][gate] = jnp.ones_like(params["cross"][gate])
    cfg = get_reduced_config(arch, use_kernels=use_kernels,
                             **OVERRIDES.get(arch, {}))
    tm = build_model(cfg, device="cpu", params=from_jax_params(
        jax.device_get(params), cfg, "cpu"))
    return jm, params, tm, cfg


@pytest.fixture(scope="module")
def models():
    return {arch: build_pair(arch) for arch in ARCHS}


def prompts(n, seed=0, lo=3, hi=16):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(8, 512, size=rng.randint(lo, hi)))
            for _ in range(n)]


def engine(model, cfg, seed=0, **kw):
    ex = frontend(cfg, ENGINE["slots"], seed)
    return InferenceEngine(model, device="cpu", extra=tx(ex) or None,
                           **{**ENGINE, **kw})


def jax_engine(jm, params, cfg, seed=0, **kw):
    ex = frontend(cfg, ENGINE["slots"], seed)
    return JaxEngine(jm, params, extra=jx(ex) or None, **{**ENGINE, **kw})


# ---------------------------------------------------------- the models ----
def test_registry_builds_the_three(monkeypatch):
    """The three ids are served; a shell of qwen3-moe is refused for its
    size, even on a device of four H100s' 320 GB; the frontend inputs'
    shapes and a suite's specs, allocating nothing."""
    from repro_torch.models import registry
    for arch, family in zip(ARCHS, ("ssm", "audio", "vlm")):
        assert get_config(arch).family == family
    monkeypatch.setattr(registry, "_device_bytes", lambda dev: 320 * 10**9)
    with pytest.raises(ValueError, match="more than the 320 GB"):
        build_shell(get_config("qwen3-moe-235b-a22b"), device="cpu")
    w, v = get_config(WHISPER), get_config(VISION)
    assert {n: tuple(t.shape) for n, t in extra_inputs(w, 16).items()} == \
        {"frames": (16, 1500, 768)}
    assert {n: tuple(t.shape) for n, t in extra_inputs(v, 16).items()} == \
        {"patches": (16, 4100, 1280)}
    assert extra_inputs(get_config(XLSTM), 16) == {}
    spec = input_specs(v, SHAPES["prefill_32k"])
    assert spec["patches"].device.type == "meta"
    assert set(spec) == {"tokens", "lengths", "patches"}
    assert set(input_specs(v, SHAPES["decode_32k"])) == {"tokens",
                                                         "lengths"}


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_round_trip(models, arch):
    """from_jax_params then to_jax_params gives the reference's tree back:
    the doubly stacked leaves (xLSTM's mlstm (G, n_m, ...), the VLM's
    self_groups (G, every, ...)) and the f32 leaves (gate_bias, the
    sLSTM's bias, the gates) in f32."""
    _, params, tm, cfg = models[arch]
    flat = dict(jax.tree_util.tree_flatten_with_path(
        jax.device_get(params))[0])
    back = to_jax_params(dict(tm.state_dict()), cfg)
    back_flat = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), back))[0])
    assert set(back_flat) == set(flat)
    for path, leaf in flat.items():
        assert back_flat[path].shape == np.shape(leaf), path
        assert np.array_equal(np.asarray(leaf, np.float32),
                              back_flat[path]), path
    bf16 = dataclasses.replace(cfg, param_dtype="bfloat16")
    st = from_jax_params(jax.device_get(params), bf16, "cpu")
    f32 = {n for n, t in st.items() if t.dtype == torch.float32}
    want = {XLSTM: ("gate_bias", "core.bias"), WHISPER: (),
            VISION: ("gate_attn", "gate_mlp")}[arch]
    assert f32 == {n for n in st if n.endswith(want)} if want else not f32


def _forward(jm, params, tm, cfg, toks, lengths, use_frontend=True):
    ex = frontend(cfg, toks.shape[0]) if use_frontend else {}
    jl, _ = jm.forward(params, {"tokens": jnp.asarray(toks),
                                "lengths": jnp.asarray(lengths), **jx(ex)})
    kw = {"extra": tx(ex)} if ex else {}
    tl = tm.forward(torch.from_numpy(toks), torch.from_numpy(lengths), **kw)
    rows = np.arange(toks.shape[1])[None, :] < lengths[:, None]
    return float(np.abs(np.asarray(jl) - tl.numpy())[rows].max())


def _xlstm_groups(jm, params, tm, toks, lengths):
    """xLSTM's forward group by group from the reference's hidden states:
    the largest gap of each group's output and of the final logits, each
    computed by the port from the reference's input to it."""
    from repro.models.layers import apply_norm, embed, unembed
    jcfg, tree = jm.cfg, jax.tree_util.tree_map
    valid = np.arange(toks.shape[1])[None, :] < lengths[:, None]
    x = embed(params["embed"], jnp.asarray(toks), jcfg)
    gaps = []
    for g in range(tm.n_groups):
        y = tm._group(g, torch.from_numpy(np.array(x)),
                      torch.from_numpy(valid), False)[0]
        sp = tree(lambda a: a[g], params["slstm"])
        x = x + jssm.slstm_forward(sp["core"], apply_norm(sp["ln"], x, jcfg),
                                   jcfg, valid=jnp.asarray(valid))[0]
        for i in range(tm.n_m):
            mp = tree(lambda a: a[g, i], params["mlstm"])
            x = x + jssm.mlstm_prefill(
                mp["core"], apply_norm(mp["ln"], x, jcfg), jcfg,
                valid=jnp.asarray(valid))[0]
        gaps.append(float(np.abs(np.asarray(x) - y.numpy())[valid].max()))
    jl = unembed(params["embed"],
                 apply_norm(params["final_norm"], x, jcfg), jcfg)
    tl = tm._logits(tm.final_norm(torch.from_numpy(np.array(x))))
    gaps.append(float(np.abs(np.asarray(jl) - tl.numpy())[valid].max()))
    return gaps


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(models, arch):
    """Logits of a padded batch, the frontend inputs included. For xLSTM
    each group's output and the final logits, each from the reference's
    input to it: its whole-model f32 logits are ill-conditioned where a
    row starts (one ulp of noise in the embedding table alone moves the
    reference's own first-position logits by 4e-5, 20 times the other
    families' move), so rounding in some hundred ops of two libraries
    lands about TOL apart there; its end-to-end agreement is held by the
    prefill/decode and engine tests."""
    jm, params, tm, cfg = models[arch]
    toks = np.random.RandomState(1).randint(8, 512, size=(3, 32)).astype(
        np.int32)
    lengths = np.array([32, 21, 5], np.int32)
    if arch == XLSTM:
        assert max(_xlstm_groups(jm, params, tm, toks, lengths)) < TOL
    else:
        assert _forward(jm, params, tm, cfg, toks, lengths) < TOL


@pytest.mark.parametrize("arch", [WHISPER, VISION])
def test_kernel_route_matches_reference(models, arch):
    """With use_kernels (on the CPU the kernels' plain versions: the
    encoder's non-causal prefill, the cross-attention's prefill over the
    memory and its decode with n_valid = T), forward, prefill and decode
    logits still match the reference's plain path."""
    jm, params, plain, cfg = models[arch]
    cfg = dataclasses.replace(cfg, use_kernels=True)
    tm = build_model(cfg, device="cpu", params=dict(plain.state_dict()))
    toks = np.random.RandomState(2).randint(8, 512, size=(2, 16)).astype(
        np.int32)
    lengths = np.array([16, 7], np.int32)
    assert _forward(jm, params, tm, cfg, toks, lengths) < TOL
    assert max(_prefill_decode(jm, params, tm, cfg, toks, lengths)) < TOL


def _prefill_decode(jm, params, tm, cfg, toks, lengths, steps=2):
    """Both packages: prefill a padded wave, then ``steps`` decode steps
    of each row's greedy tokens; the largest logits gap of each call."""
    B = toks.shape[0]
    ex = frontend(cfg, B)
    jcache = jm.init_cache(B, 32, jnp.float32)
    jl, jcache = jm.prefill(params, jnp.asarray(toks), jnp.asarray(lengths),
                            jcache, extra=jx(ex))
    tcache = tm.init_cache(B, 32, torch.float32)
    kw = {"extra": tx(ex)} if ex else {}
    tl = tm.prefill(torch.from_numpy(toks), torch.from_numpy(lengths),
                    tcache, **kw)
    gaps = [float(np.abs(np.asarray(jl) - tl.numpy()).max())]
    lens = lengths.copy()
    for _ in range(steps):
        nxt = np.asarray(jnp.argmax(jl[:, :cfg.vocab_size], axis=-1),
                         np.int32)[:, None]
        jl, jcache = jm.decode_step(params, jnp.asarray(nxt),
                                    jnp.asarray(lens), jcache)
        tl = tm.decode_step(torch.from_numpy(nxt), torch.from_numpy(lens),
                            tcache)
        gaps.append(float(np.abs(np.asarray(jl) - tl.numpy()).max()))
        lens = lens + 1
    return gaps


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_reference(models, arch):
    jm, params, tm, cfg = models[arch]
    toks = np.random.RandomState(3).randint(8, 512, size=(3, 16)).astype(
        np.int32)
    lengths = np.array([16, 9, 2], np.int32)
    assert max(_prefill_decode(jm, params, tm, cfg, toks, lengths)) < TOL


@pytest.fixture(scope="module")
def jax_greedy(models):
    out = {}
    for arch in ARCHS:
        jm, params, _, cfg = models[arch]
        out[arch] = jax_engine(jm, params, cfg).generate(prompts(5),
                                                         max_new_tokens=8)
    return out


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_matches_reference_engine(models, jax_greedy, arch, K):
    """Five prompts over two slots (three waves): wave row i reads row i
    of ``extra`` in both engines."""
    _, _, tm, cfg = models[arch]
    out = engine(tm, cfg, megastep=K).generate(prompts(5), max_new_tokens=8)
    assert out == jax_greedy[arch]


def test_xlstm_remat_keeps_states_and_gradients(models):
    """xLSTM's ``forward_hidden(train=True)`` under remat "block" runs each
    group under ``torch.utils.checkpoint``: the same states and the same
    gradients as without it."""
    from repro_torch.train import trainable
    _, _, tm, cfg = models[XLSTM]
    toks = torch.from_numpy(np.random.RandomState(9).randint(
        8, 512, size=(2, 32)).astype(np.int32))
    lengths = torch.tensor([32, 11], dtype=torch.int32)
    out = []
    for remat in ("none", "block"):
        m = build_model(dataclasses.replace(cfg, remat=remat), device="cpu",
                        params={k: v.clone()
                                for k, v in tm.state_dict().items()})
        trainable(m)
        h, _ = m.forward_hidden(toks, lengths, train=True)
        h.square().mean().backward()
        out.append((h.detach(), m.mlstm[0].core.up.grad))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.allclose(out[0][1], out[1][1], rtol=0, atol=1e-6)


def test_vision_patches_move_the_logits(models):
    """The witness that cross-attention is exercised: other patches give
    other logits, by more than the tolerance."""
    jm, params, tm, cfg = models[VISION]
    toks = torch.from_numpy(np.random.RandomState(4).randint(
        8, 512, size=(2, 16)).astype(np.int32))
    a = tm.forward(toks, extra=tx(frontend(cfg, 2, seed=0)))
    b = tm.forward(toks, extra=tx(frontend(cfg, 2, seed=1)))
    assert float((a - b).abs().max()) > 100 * TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_falls_back_with_reference_reason(models, arch):
    jm, params, tm, cfg = models[arch]
    want = jax_engine(jm, params, cfg, paged=True)
    eng = engine(tm, cfg, paged=True)
    assert eng.paged_fallback == want.paged_fallback == FALLBACK
    assert eng.stats.decode_path == "full"
    assert eng.prefix_fallback == "engine is not paged: " + FALLBACK


@pytest.mark.parametrize("arch", ARCHS)
def test_live_bytes_match_reference(models, arch):
    """xLSTM's state has no sequence axis and counts whole; Whisper's and
    the VLM's self K/V are pro-rated by the live tokens and their cross
    K/V counted whole, as in the reference."""
    jm, params, tm, cfg = models[arch]
    kw = dict(cache_len=64, prefill_buckets=(16, 32))
    engs = (jax_engine(jm, params, cfg, **kw), engine(tm, cfg, **kw))
    for e in engs:
        e.submit(Request(prompt=prompts(1, seed=21)[0], max_new_tokens=8))
        e.step()
    snap = engs[1].snapshot()
    assert snap["live_bytes"] == engs[0].snapshot()["live_bytes"]
    if arch == XLSTM:
        assert snap["live_bytes"] == snap["capacity_bytes"]
    else:
        cross = sum(engs[1].cache[n].numel() * 4
                    for n in ("cross_k", "cross_v"))
        assert cross < snap["live_bytes"] < snap["capacity_bytes"]


@pytest.mark.parametrize("arch", ARCHS)
def test_demote_restore_continues(models, arch):
    """Demoted mid-stream (requests decoding and queued) and restored, a
    context continues as one that never left: weights, states, the cross
    K/V and ``extra`` come back as they left."""
    _, _, tm, cfg = models[arch]
    ps = prompts(5, seed=11)
    want = engine(tm, cfg, megastep=4).generate(ps, max_new_tokens=9)
    eng = engine(tm, cfg, megastep=4)
    reqs = [eng.submit(Request(prompt=list(p), max_new_tokens=9))
            for p in ps]
    eng.step()
    assert eng.active and eng.queue
    before = {n: t.clone() for n, t in eng.cache.items()}
    host = eng.offload_device_state()
    assert ("extra" in host) == (arch != XLSTM)
    assert eng.extra is None and all(p.numel() == 0
                                     for p in tm.parameters())
    eng.restore_device_state(host)
    for n, t in eng.cache.items():
        assert torch.equal(t, before[n]) and t.dtype == before[n].dtype
    eng.run_to_completion()
    assert [r.generated for r in reqs] == want


def test_extra_rides_in_snapshot_fingerprint_and_wire(models):
    """``extra`` shows in the snapshot summary and the fingerprint and
    rides in the wire recipe; a shell rebuilt from the recipe takes the
    donor's template (``extra`` in its device half) and serves as the
    donor does; a restore without ``extra`` is refused."""
    _, _, tm, cfg = models[WHISPER]
    ps = prompts(4, seed=5)
    eng = engine(tm, cfg, megastep=4)
    assert eng.snapshot()["extra"] == {"frames": [2, 24, 64]}
    assert engine(tm, cfg, seed=1).aot_fingerprint != eng.aot_fingerprint
    rec = eng.wire_recipe()
    assert rec["extra_b64"]
    template = eng.export_template()
    assert set(template["extra"]) == {"frames"}
    want = eng.generate(ps, max_new_tokens=6)
    shell = engine_from_wire(rec, device="cpu")
    assert shell.offloaded and shell.extra is None
    assert shell.aot_fingerprint == eng.aot_fingerprint
    with pytest.raises(ValueError, match="extra"):
        shell.restore_device_state({k: v for k, v in template.items()
                                    if k != "extra"})
    shell.restore_device_state(template)
    assert torch.equal(shell.extra["frames"], eng.extra["frames"])
    assert shell.generate(ps, max_new_tokens=6) == want


def test_extra_that_does_not_fit_raises(models):
    _, _, tm, cfg = models[WHISPER]
    ok = frontend(cfg, ENGINE["slots"])
    with pytest.raises(ValueError, match="one row per slot"):
        InferenceEngine(tm, device="cpu", **ENGINE,
                        extra=tx(frontend(cfg, 3)))
    with pytest.raises(ValueError, match="takes \\['frames'\\]"):
        InferenceEngine(tm, device="cpu", **ENGINE,
                        extra={"patches": torch.from_numpy(ok["frames"])})
    with pytest.raises(ValueError, match="takes none"):
        InferenceEngine(models[XLSTM][2], device="cpu", **ENGINE,
                        extra=tx(ok))
    eng = InferenceEngine(tm, device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="'frames'"):
        eng.generate([[2, 5]], max_new_tokens=2)
    assert eng.free_slots and not eng.active and len(eng.queue) == 1


# ----------------------------------------------------------- functions ----
def _module(cls, cfg, params):
    """A port module of ``cls`` holding the reference's params tree."""
    m = cls(cfg, "cpu")
    flat = {".".join(str(getattr(k, "key", k)) for k in path):
            torch.from_numpy(np.asarray(leaf, np.float32))
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jax.device_get(params))[0]}
    m.load_state_dict(flat, strict=True, assign=True)
    return m


def test_mlstm_and_slstm_match_reference():
    """mlstm_prefill (state and outputs; padded rows hold their state at
    the last valid step), mlstm_decode from that state, and slstm_forward
    over padded rows and then one cached step."""
    cfg = get_reduced_config(XLSTM)
    jcfg = jax_config(XLSTM)
    rng = np.random.RandomState(6)
    u = rng.standard_normal((3, 32, cfg.d_model)).astype(np.float32)
    valid = np.arange(32)[None, :] < np.array([32, 20, 3])[:, None]
    u1 = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    for jinit, cls in ((jssm.init_mlstm, ssm.MLSTM),
                       (jssm.init_slstm, ssm.SLSTM)):
        p = jinit(jax.random.PRNGKey(1), jcfg)
        m = _module(cls, cfg, p)
        if cls is ssm.MLSTM:
            jy, jst = jssm.mlstm_prefill(p, jnp.asarray(u), jcfg,
                                         return_state=True,
                                         valid=jnp.asarray(valid))
            ty, tst = ssm.mlstm_prefill(m, torch.from_numpy(u), cfg,
                                        return_state=True,
                                        valid=torch.from_numpy(valid))
            jy1, _ = jssm.mlstm_decode(p, jnp.asarray(u1), jcfg, jst)
            ty1, _ = ssm.mlstm_decode(m, torch.from_numpy(u1), cfg, tst)
        else:
            jy, jst = jssm.slstm_forward(p, jnp.asarray(u), jcfg,
                                         return_state=True,
                                         valid=jnp.asarray(valid))
            ty, tst = ssm.slstm_forward(m, torch.from_numpy(u), cfg,
                                        return_state=True,
                                        valid=torch.from_numpy(valid))
            jy1, _ = jssm.slstm_forward(p, jnp.asarray(u1), jcfg, cache=jst)
            ty1, _ = ssm.slstm_forward(m, torch.from_numpy(u1), cfg,
                                       cache=tst)
        for name, t in tst.items():
            assert np.abs(np.asarray(jst[name]) - t.numpy()).max() < TOL, \
                name
        rows = valid
        assert np.abs(np.asarray(jy) - ty.numpy())[rows].max() < TOL
        assert np.abs(np.asarray(jy1) - ty1.numpy()).max() < TOL


@pytest.mark.parametrize("S", [8, 300])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_attend_cached_memory_matches_reference(S, use_kernels):
    """Both of the reference's plain branches (the narrow grouped scoring
    up to 256 queries, the blockwise softmax above) with ragged memory
    lengths, and the kernel route (S = 1 on the decode kernel, longer S on
    the prefill kernel, not causal)."""
    jcfg = jax_config(VISION, n_kv_heads=2)
    cfg = get_reduced_config(VISION, n_kv_heads=2, use_kernels=use_kernels)
    p = jattn.init_attention(jax.random.PRNGKey(2), jcfg, cross=True)
    tp = types.SimpleNamespace(**{k: torch.from_numpy(np.asarray(v))
                                  for k, v in p.items()})
    rng = np.random.RandomState(7)
    mem = rng.standard_normal((3, 40, cfg.vision_dim)).astype(np.float32)
    mem_len = np.array([40, 17, 1], np.int32)
    for s in (S, 1):
        x = rng.standard_normal((3, s, cfg.d_model)).astype(np.float32)
        jk, jv = jattn.project_memory_kv(p, jnp.asarray(mem), jcfg)
        want = jattn.attend_cached_memory(p, jnp.asarray(x), jcfg, jk, jv,
                                          jnp.asarray(mem_len))
        tk, tv = attn.project_memory_kv(tp, torch.from_numpy(mem), cfg)
        got = attn.attend_cached_memory(tp, torch.from_numpy(x), cfg, tk,
                                        tv, torch.from_numpy(mem_len))
        assert np.abs(np.asarray(want) - got.numpy()).max() < TOL


@pytest.mark.parametrize("use_kernels", [False, True])
def test_encoder_attention_is_not_causal(use_kernels):
    """attend_prefill with causal=False (Whisper's encoder) matches the
    reference's, and differs from the causal call."""
    jcfg = jax_config(WHISPER)
    cfg = get_reduced_config(WHISPER, use_kernels=use_kernels)
    p = jattn.init_attention(jax.random.PRNGKey(3), jcfg)
    tp = types.SimpleNamespace(**{k: torch.from_numpy(np.asarray(v))
                                  for k, v in p.items()})
    x = np.random.RandomState(8).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    pos = np.arange(24, dtype=np.int32)
    want, _ = jattn.attend_prefill(p, jnp.asarray(x), jcfg,
                                   positions=jnp.asarray(pos), causal=False)
    got, _ = attn.attend_prefill(tp, torch.from_numpy(x), cfg,
                                 positions=torch.from_numpy(pos),
                                 causal=False)
    causal, _ = attn.attend_prefill(tp, torch.from_numpy(x), cfg,
                                    positions=torch.from_numpy(pos))
    assert np.abs(np.asarray(want) - got.numpy()).max() < TOL
    assert float((got - causal).abs().max()) > 100 * TOL


@pytest.mark.parametrize("S,T,H,Hkv,D", [(16, 12, 4, 2, 16),
                                          (40, 70, 8, 2, 64)])
def test_plain_kernels_non_causal_match_reference(S, T, H, Hkv, D):
    """The plain prefill kernel with S queries over T keys, not causal
    (the encoder's and the cross prefill's calls): against the reference
    kernel's oracle (``kernels/ref.py``, (BH, S, D) layout) over every key
    and against the reference's blockwise path with ragged kv_len; the
    plain decode over a memory at n_valid = T against the oracle."""
    rng = np.random.RandomState(S + T)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, S, H, D), (2, T, Hkv, D), (2, T, Hkv, D)))
    scale = D ** -0.5
    kf, vf = (np.repeat(a, H // Hkv, axis=2) for a in (k, v))

    def bh(a):
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(
            -1, a.shape[1], D))
    want = np.asarray(jref.flash_attention_ref(
        bh(q), bh(kf), bh(vf), causal=False, scale=scale)).reshape(
        2, H, S, D).transpose(0, 2, 1, 3)
    got = ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=False,
                                  scale=scale)
    assert np.abs(want - got.numpy()).max() < TOL
    kl = np.array([T, T // 2], np.int32)
    want = jattn.blockwise_attention(jnp.asarray(q), jnp.asarray(kf),
                                     jnp.asarray(vf), scale=scale,
                                     causal=False, kv_len=jnp.asarray(kl))
    got = ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=False,
                                  scale=scale, kv_len=torch.from_numpy(kl))
    assert np.abs(np.asarray(want) - got.numpy()).max() < TOL
    n = np.full(2, T, np.int32)
    want = jref.flash_decode_ref(jnp.asarray(q[:, 0]), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(n), scale=scale)
    got = ref.flash_decode_ref(torch.from_numpy(q[:, 0]), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(n),
                               scale=scale)
    assert np.abs(np.asarray(want) - got.numpy()).max() < TOL


# ------------------------------------------------------------ the CLI ----
def test_serve_cli_xlstm_matches_reference_cli(tmp_path, capsys):
    """The reference's CLI path and the port's ``verify_claims`` on the
    same weights (the reference's, through a checkpoint) give the same
    tokens and verdicts; ``--arch xlstm-350m --device cpu`` serves."""
    jcfg = jax_config(XLSTM)
    params = jax_build(jcfg).init(jax.random.PRNGKey(0))
    JaxManager(str(tmp_path)).save(0, params)
    jctx = jserve.build_context(XLSTM, 4, 128, 8)
    tok = JaxTokenizer(jcfg.vocab_size)
    template = jfever.PROMPT_CANDIDATES[0]
    claims = jfever.claim_batch(range(8))
    want = jctx["engine"].generate(
        [tok.encode(jfever.render_prompt(c, template)) for c in claims],
        max_new_tokens=2)
    ctx = serve.build_context(XLSTM, 4, 128, 8, device="cpu",
                              checkpoint=str(tmp_path))
    got = ctx["engine"].generate(
        [ctx["tokenizer"].encode(jfever.render_prompt(c, template))
         for c in claims], max_new_tokens=2)
    assert got == want
    serve.main(["--arch", XLSTM, "--claims", "4", "--batch-size", "4",
                "--workers", "1", "--device", "cpu"])
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[serve] mode=full")]
    assert len(line) == 1 and "claims=4 accuracy=" in line[0]


def test_serve_whisper_without_frontend_fails_at_first_prefill():
    """Neither CLI passes a frontend input: both packages build the
    context and fail at the first prefill, the port naming the input."""
    jctx = jserve.build_context(WHISPER, 2, 64, 8)
    with pytest.raises(TypeError):
        jctx["engine"].generate([[2, 5, 9]], max_new_tokens=2)
    ctx = serve.build_context(WHISPER, 2, 64, device="cpu")
    with pytest.raises(ValueError, match="'frames'"):
        ctx["engine"].generate([[2, 5, 9]], max_new_tokens=2)
