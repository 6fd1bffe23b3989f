"""The port's dense decoder against the JAX reference: the reduced
smollm2-1.7b (f32) initialised by the reference and carried across by
repro_torch.weights.from_jax_params; logits through forward, prefill,
decode_step, prefill_shared and decode_paged within 2e-4, with use_kernels
on and off."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced_config as jax_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serving import paged as jax_paged  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import paged  # noqa: E402
from repro_torch.weights import from_jax_params, init_params  # noqa: E402

TOL = 2e-4


@pytest.fixture(scope="module")
def jax_side():
    cfg = jax_config("smollm2-1.7b")
    params = jax_build(cfg).init(jax.random.PRNGKey(0))
    return cfg, params, jax.device_get(params)


def _pair(jax_side, use_kernels):
    jcfg, params, params_np = jax_side
    jcfg = dataclasses.replace(jcfg, use_kernels=use_kernels)
    tcfg = get_reduced_config("smollm2-1.7b", use_kernels=use_kernels)
    tmodel = build_model(tcfg, device="cpu",
                         params=from_jax_params(params_np, tcfg, "cpu"))
    return jax_build(jcfg), params, tmodel


def _toks(B, S, vocab, seed=1):
    return np.random.RandomState(seed).randint(0, vocab, size=(B, S)).astype(
        np.int32)


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a) - b.numpy())))


def test_weight_bridge_layouts(jax_side):
    jcfg, _, params_np = jax_side
    tcfg = get_reduced_config("smollm2-1.7b")
    state = from_jax_params(params_np, tcfg, "cpu")
    model = build_model(tcfg, device="cpu", params=state)
    assert set(state) == set(model.state_dict())
    L = tcfg.n_layers
    for i in range(L):
        np.testing.assert_array_equal(
            state[f"layers.{i}.attn.wq"].numpy(),
            params_np["layers"]["attn"]["wq"][i])
        np.testing.assert_array_equal(
            state[f"layers.{i}.mlp.down"].numpy(),
            params_np["layers"]["mlp"]["down"][i])
    assert state["layers.0.attn.wo"].shape == (
        tcfg.n_heads, tcfg.resolved_head_dim, tcfg.d_model)
    assert state["embed.tok"].shape == (tcfg.padded_vocab, tcfg.d_model)
    # the port's own init draws the same shapes and dtypes
    own = init_params(tcfg, torch.Generator().manual_seed(0),
                      torch.device("cpu"))
    assert {k: v.shape for k, v in own.items()} == \
        {k: v.shape for k, v in state.items()}


@pytest.mark.parametrize("use_kernels", [False, True])
def test_forward_matches_reference(jax_side, use_kernels):
    jm, params, tm = _pair(jax_side, use_kernels)
    toks = _toks(2, 16, tm.cfg.vocab_size)
    exp, _ = jm.forward(params, {"tokens": jnp.asarray(toks)})
    out = tm.forward(torch.from_numpy(toks))
    assert out.shape == (2, 16, tm.cfg.padded_vocab)
    assert _err(exp, out) < TOL


def test_forward_with_lengths_matches_reference(jax_side):
    jm, params, tm = _pair(jax_side, False)
    toks = _toks(2, 16, tm.cfg.vocab_size)
    lengths = np.array([16, 9], np.int32)
    exp, _ = jm.forward(params, {"tokens": jnp.asarray(toks),
                                 "lengths": jnp.asarray(lengths)})
    out = tm.forward(torch.from_numpy(toks), torch.from_numpy(lengths))
    assert _err(exp, out) < TOL


@pytest.mark.parametrize("use_kernels", [False, True])
def test_prefill_and_decode_match_reference(jax_side, use_kernels):
    jm, params, tm = _pair(jax_side, use_kernels)
    B, S, cache_len = 2, 16, 64
    toks = _toks(B, S, tm.cfg.vocab_size)
    lengths = np.array([10, 16], np.int32)
    jcache = jm.init_cache(B, cache_len, jnp.float32)
    exp, jcache = jm.prefill(params, jnp.asarray(toks), jnp.asarray(lengths),
                             jcache)
    tcache = tm.init_cache(B, cache_len, torch.float32)
    out = tm.prefill(torch.from_numpy(toks), torch.from_numpy(lengths),
                     tcache)
    assert _err(exp, out) < TOL
    # the cache holds the same K/V at every valid position
    jk = np.asarray(jcache["layers"][0])
    for b, n in enumerate(lengths):
        assert float(np.max(np.abs(jk[:, b, :n]
                                   - tcache["k"][:, b, :n].numpy()))) < TOL

    nxt = np.array([[5], [9]], np.int32)
    exp, jcache = jm.decode_step(params, jnp.asarray(nxt),
                                 jnp.asarray(lengths), jcache)
    out = tm.decode_step(torch.from_numpy(nxt), torch.from_numpy(lengths),
                         tcache)
    assert out.shape == (B, tm.cfg.padded_vocab)
    assert _err(exp, out) < TOL
    jv = np.asarray(jcache["layers"][1])
    for b, n in enumerate(lengths):
        assert float(np.max(np.abs(jv[:, b, n]
                                   - tcache["v"][:, b, n].numpy()))) < TOL


@pytest.mark.parametrize("use_kernels", [False, True])
def test_prefill_decode_matches_forward(use_kernels):
    """Port copy of test_models_consistency.test_prefill_decode_matches_
    forward, on the port's own init."""
    cfg = get_reduced_config("smollm2-1.7b", use_kernels=use_kernels)
    model = build_model(cfg, device="cpu", seed=0)
    B, S = 2, 16
    toks = torch.from_numpy(_toks(B, S, cfg.vocab_size)).long()
    full = model.forward(toks)
    cache = model.init_cache(B, 64, torch.float32)
    lengths = torch.tensor([10, 16], dtype=torch.int32) - 1
    lg = model.prefill(toks, lengths, cache)
    assert float((lg[0] - full[0, 8]).abs().max()) < 2e-3
    assert float((lg[1] - full[1, 14]).abs().max()) < 2e-3
    nxt = torch.stack([toks[0, 9], toks[1, 15]])[:, None]
    lg = model.decode_step(nxt, lengths, cache)
    assert float((lg[0] - full[0, 9]).abs().max()) < 2e-3
    assert float((lg[1] - full[1, 15]).abs().max()) < 2e-3


def _paged_pools(jm, NP, P, seed=3):
    """One numpy-seeded pool in both packages' layouts."""
    pool = jm.init_cache(NP + 1, P, jnp.float32)
    rng = np.random.RandomState(seed)
    pool = jax.tree_util.tree_map(lambda a: jnp.asarray(
        0.5 * rng.standard_normal(a.shape).astype(np.float32)), pool)
    tpool = {"k": torch.from_numpy(np.asarray(pool["layers"][0]).copy()),
             "v": torch.from_numpy(np.asarray(pool["layers"][1]).copy())}
    return pool, tpool


@pytest.mark.parametrize("use_kernels", [False, True])
def test_prefill_shared_and_decode_paged_match_reference(jax_side,
                                                         use_kernels):
    """Tail-only prefill over a paged pool (per-row starts, a mid-page
    start, a cold row with start 0), then one paged decode step with an
    inactive row: logits and the written K/V against the reference."""
    jm, params, tm = _pair(jax_side, use_kernels)
    NP, P, B, n, Tb = 12, 8, 3, 4, 8
    axes = {"layers": (1, 1)}
    pool, tpool = _paged_pools(jm, NP, P)
    pt = np.random.RandomState(4).permutation(NP)[:B * n].reshape(
        B, n).astype(np.int32)
    starts = np.array([5, 0, 16], np.int32)
    lengths = np.array([11, 8, 20], np.int32)
    toks = _toks(B, Tb, tm.cfg.vocab_size, seed=5)
    view = jax_paged.gather_view(pool, jnp.asarray(pt), axes)
    exp, new_view = jm.prefill_shared(params, jnp.asarray(toks),
                                      jnp.asarray(lengths),
                                      jnp.asarray(starts), view)
    out = tm.prefill_shared(torch.from_numpy(toks), torch.from_numpy(lengths),
                            torch.from_numpy(starts), tpool,
                            torch.from_numpy(pt))
    assert out.shape == (B, tm.cfg.padded_vocab)
    assert _err(exp, out) < TOL
    got_view = paged.gather_view(tpool, torch.from_numpy(pt))
    for j, name in enumerate(("k", "v")):
        assert _err(new_view["layers"][j], got_view[name]) < TOL

    pool = jax_paged.scatter_view(pool, new_view, jnp.asarray(pt), axes,
                                  None, NP)
    active = np.array([True, False, True])
    nxt = np.array([[3], [4], [5]], np.int32)
    before = tpool["k"].clone()
    exp, jpool = jm.decode_paged(params, jnp.asarray(nxt),
                                 jnp.asarray(lengths), pool,
                                 jnp.asarray(pt), jnp.asarray(active))
    out = tm.decode_paged(torch.from_numpy(nxt), torch.from_numpy(lengths),
                          tpool, torch.from_numpy(pt),
                          torch.from_numpy(active))
    assert float(np.max(np.abs(np.asarray(exp)[active]
                               - out.numpy()[active]))) < TOL
    # the active rows wrote position `lengths` of their own page; the
    # inactive row wrote only into TRASH
    for b in (0, 2):
        page, off = pt[b, lengths[b] // P], lengths[b] % P
        assert float(np.max(np.abs(
            np.asarray(jpool["layers"][0])[:, page, off]
            - tpool["k"][:, page, off].numpy()))) < TOL
    assert torch.equal(tpool["k"][:, :NP][:, pt[1]], before[:, :NP][:, pt[1]])


def test_paged_prefill_writes_only_through_tables():
    """A cold paged prefill writes each valid row's K/V into the pages its
    table names, and padding rows (all-TRASH tables) touch no page: the
    pool gathered through the tables equals a slot-cache prefill."""
    cfg = get_reduced_config("smollm2-1.7b")
    model = build_model(cfg, device="cpu", seed=0)
    NP, P = 10, 4
    pool = model.init_cache(NP + 1, P, torch.float32)
    for t in pool.values():
        t.normal_(generator=torch.Generator().manual_seed(3))
    before = {k: v.clone() for k, v in pool.items()}
    toks = torch.from_numpy(_toks(3, 8, cfg.vocab_size)).long()
    lengths = torch.tensor([8, 5, 0], dtype=torch.int32)
    pt = torch.tensor([[7, 2], [4, NP], [NP, NP]], dtype=torch.int32)
    lg = model.prefill(toks, lengths, pool, page_table=pt)
    ref_cache = model.init_cache(3, 8, torch.float32)
    ref_lg = model.prefill(toks, lengths, ref_cache)
    assert torch.equal(lg[:2], ref_lg[:2])
    view = paged.gather_view(pool, pt[:2])
    for name in ("k", "v"):
        assert torch.equal(view[name][:, 0], ref_cache[name][:, 0])
        assert torch.equal(view[name][:, 1, :4], ref_cache[name][:, 1, :4])
        untouched = [p for p in range(NP) if p not in (7, 2, 4)]
        assert torch.equal(pool[name][:, untouched],
                           before[name][:, untouched])


def test_prefill_writes_only_given_slots():
    """A padded wave writes its valid rows into their slots and nothing
    else: padding rows and other slots keep their cache bit for bit."""
    cfg = get_reduced_config("smollm2-1.7b")
    model = build_model(cfg, device="cpu", seed=0)
    cache = model.init_cache(4, 32, torch.float32)
    for t in cache.values():
        t.normal_(generator=torch.Generator().manual_seed(3))
    before = {k: v.clone() for k, v in cache.items()}
    toks = torch.from_numpy(_toks(4, 8, cfg.vocab_size)).long()
    lengths = torch.tensor([8, 5, 0, 0], dtype=torch.int32)
    model.prefill(toks, lengths, cache, slots=torch.tensor([3, 1]))
    ref_cache = model.init_cache(2, 32, torch.float32)
    model.prefill(toks[:2], lengths[:2], ref_cache)
    for name in ("k", "v"):
        for src, dst in ((0, 3), (1, 1)):
            assert torch.equal(cache[name][:, dst, :8],
                               ref_cache[name][:, src, :8])
        assert torch.equal(cache[name][:, dst, 8:], before[name][:, dst, 8:])
        for free in (0, 2):
            assert torch.equal(cache[name][:, free], before[name][:, free])


@pytest.mark.parametrize("use_kernels", [False, True])
def test_decode_inactive_rows_leave_cache_untouched(use_kernels):
    cfg = get_reduced_config("smollm2-1.7b", use_kernels=use_kernels)
    model = build_model(cfg, device="cpu", seed=0)
    cache = model.init_cache(3, 32, torch.float32)
    for t in cache.values():
        t.normal_(generator=torch.Generator().manual_seed(4))
    before = {k: v.clone() for k, v in cache.items()}
    toks = torch.tensor([[5], [6], [7]])
    lengths = torch.tensor([4, 0, 9], dtype=torch.int32)
    active = torch.tensor([True, False, True])
    lg = model.decode_step(toks, lengths, cache, active=active)
    assert torch.isfinite(lg).all()
    for name in ("k", "v"):
        assert torch.equal(cache[name][:, 1], before[name][:, 1])
        assert not torch.equal(cache[name][:, 0, 4], before[name][:, 0, 4])
        assert torch.equal(cache[name][:, 0, 5:], before[name][:, 0, 5:])


@pytest.mark.parametrize("variant", [
    dict(qk_norm=True), dict(norm="layernorm", activation="gelu"),
    dict(tie_embeddings=False, activation="squared_relu", n_kv_heads=2)])
def test_dense_variants_match_reference(variant):
    """The dense family's other switches (per-head q/k norm, LayerNorm,
    GELU and squared-ReLU MLPs, untied unembedding, GQA) through the bridge
    and forward/prefill/decode, against the reference."""
    jcfg = jax_config("smollm2-1.7b", **variant)
    tcfg = get_reduced_config("smollm2-1.7b", **variant)
    jm = jax_build(jcfg)
    params = jm.init(jax.random.PRNGKey(1))
    tm = build_model(tcfg, device="cpu", params=from_jax_params(
        jax.device_get(params), tcfg, "cpu"))
    toks = _toks(2, 12, tcfg.vocab_size, seed=2)
    exp, _ = jm.forward(params, {"tokens": jnp.asarray(toks)})
    assert _err(exp, tm.forward(torch.from_numpy(toks))) < TOL
    lengths = np.array([12, 7], np.int32)
    jcache = jm.init_cache(2, 32, jnp.float32)
    exp, jcache = jm.prefill(params, jnp.asarray(toks), jnp.asarray(lengths),
                             jcache)
    tcache = tm.init_cache(2, 32, torch.float32)
    out = tm.prefill(torch.from_numpy(toks), torch.from_numpy(lengths),
                     tcache)
    assert _err(exp, out) < TOL
    nxt = np.array([[3], [4]], np.int32)
    exp, _ = jm.decode_step(params, jnp.asarray(nxt), jnp.asarray(lengths),
                            jcache)
    out = tm.decode_step(torch.from_numpy(nxt), torch.from_numpy(lengths),
                         tcache)
    assert _err(exp, out) < TOL


def test_config_copy_matches_reference():
    """The port's ModelConfig is the reference's field for field: the same
    arch id gives the same fields and the same key() in both packages."""
    from repro.configs import get_config as jax_get
    from repro_torch.configs import get_config
    for full, red in ((jax_get("smollm2-1.7b"), get_config("smollm2-1.7b")),
                      (jax_config("smollm2-1.7b"),
                       get_reduced_config("smollm2-1.7b"))):
        assert dataclasses.asdict(full) == dataclasses.asdict(red)
        assert full.key() == red.key()


# ------------------------------------------------ DeepSeek: MLA + MoE -----
DS = "deepseek-v2-lite-16b"


@pytest.fixture(scope="module")
def ds_side():
    cfg = jax_config(DS)
    params = jax_build(cfg).init(jax.random.PRNGKey(1))
    return cfg, params, jax.device_get(params)


def _ds_pair(ds_side, use_kernels):
    jcfg, params, params_np = ds_side
    tcfg = get_reduced_config(DS, use_kernels=use_kernels)
    tmodel = build_model(tcfg, device="cpu",
                         params=from_jax_params(params_np, tcfg, "cpu"))
    return jax_build(jcfg), params, tmodel


def _to_port(jcache):
    """The reference's {"dense0": [(ckv, kr)], "layers": (ckv, kr)} as the
    port's {"ckv", "krope"} stacked over all layers in run order."""
    return {name: torch.from_numpy(np.concatenate(
        [np.asarray(jcache["dense0"][0][j])[None],
         np.asarray(jcache["layers"][j])]).copy())
        for j, name in enumerate(("ckv", "krope"))}


def test_deepseek_weight_bridge_layouts(ds_side):
    _, _, params_np = ds_side
    tcfg = get_reduced_config(DS)
    state = from_jax_params(params_np, tcfg, "cpu")
    model = build_model(tcfg, device="cpu", params=state)
    assert set(state) == set(model.state_dict())
    np.testing.assert_array_equal(state["dense0.0.mlp.up"].numpy(),
                                  params_np["dense0"][0]["mlp"]["up"])
    assert state["dense0.0.mlp.up"].shape == (tcfg.d_model,
                                              tcfg.moe.dense_d_ff)
    for i in range(tcfg.n_layers - 1):
        np.testing.assert_array_equal(
            state[f"layers.{i}.moe.experts.down"].numpy(),
            params_np["layers"]["moe"]["experts"]["down"][i])
        np.testing.assert_array_equal(
            state[f"layers.{i}.attn.w_uk"].numpy(),
            params_np["layers"]["attn"]["w_uk"][i])
    e = tcfg.moe
    assert state["layers.0.moe.shared.up"].shape == (
        tcfg.d_model, e.shared_d_ff * e.n_shared_experts)
    own = init_params(tcfg, torch.Generator().manual_seed(0),
                      torch.device("cpu"))
    assert {k: v.shape for k, v in own.items()} == \
        {k: v.shape for k, v in state.items()}
    assert model.prefill_shared is None
    assert len(model.blocks) == tcfg.n_layers


@pytest.mark.parametrize("use_kernels", [False, True])
def test_deepseek_forward_matches_reference(ds_side, use_kernels):
    jm, params, tm = _ds_pair(ds_side, use_kernels)
    toks = _toks(2, 14, tm.cfg.vocab_size, seed=6)
    lengths = np.array([14, 9], np.int32)
    exp, _ = jm.forward(params, {"tokens": jnp.asarray(toks),
                                 "lengths": jnp.asarray(lengths)})
    out = tm.forward(torch.from_numpy(toks), torch.from_numpy(lengths))
    assert out.shape == (2, 14, tm.cfg.padded_vocab)
    assert _err(np.asarray(exp)[0], out[0]) < TOL
    assert _err(np.asarray(exp)[1, :9], out[1, :9]) < TOL


@pytest.mark.parametrize("use_kernels", [False, True])
def test_deepseek_prefill_and_decode_match_reference(ds_side, use_kernels):
    """Slot-cache prefill (latents written at every valid position) and
    one decode step."""
    jm, params, tm = _ds_pair(ds_side, use_kernels)
    B, S, cache_len = 2, 16, 32
    toks = _toks(B, S, tm.cfg.vocab_size, seed=7)
    lengths = np.array([11, 16], np.int32)
    jcache = jm.init_cache(B, cache_len, jnp.float32)
    exp, jcache = jm.prefill(params, jnp.asarray(toks), jnp.asarray(lengths),
                             jcache)
    tcache = tm.init_cache(B, cache_len, torch.float32)
    assert set(tcache) == {"ckv", "krope"}
    out = tm.prefill(torch.from_numpy(toks), torch.from_numpy(lengths),
                     tcache)
    assert _err(exp, out) < TOL
    want = _to_port(jcache)
    for name in ("ckv", "krope"):
        for b, n in enumerate(lengths):
            assert _err(want[name][:, b, :n], tcache[name][:, b, :n]) < TOL
    nxt = np.array([[5], [9]], np.int32)
    exp, jcache = jm.decode_step(params, jnp.asarray(nxt),
                                 jnp.asarray(lengths), jcache)
    out = tm.decode_step(torch.from_numpy(nxt), torch.from_numpy(lengths),
                         tcache)
    assert _err(exp, out) < TOL
    want = _to_port(jcache)
    for b, n in enumerate(lengths):
        assert _err(want["ckv"][:, b, n], tcache["ckv"][:, b, n]) < TOL


@pytest.mark.parametrize("use_kernels", [False, True])
def test_deepseek_paged_prefill_and_decode_match_reference(ds_side,
                                                           use_kernels):
    """Prefill through page tables into the paged latent pool, then one
    paged decode step with an inactive row, against the reference's
    prefill and decode_paged; the latents land in the tables' pages."""
    jm, params, tm = _ds_pair(ds_side, use_kernels)
    NP, P, B, n = 12, 4, 3, 4
    toks = _toks(B, 12, tm.cfg.vocab_size, seed=8)
    lengths = np.array([10, 5, 12], np.int32)
    pt = np.random.RandomState(4).permutation(NP)[:B * n].reshape(
        B, n).astype(np.int32)
    jcache = jm.init_cache(B, n * P, jnp.float32)
    exp, jcache = jm.prefill(params, jnp.asarray(toks), jnp.asarray(lengths),
                             jcache)
    pool = tm.init_cache(NP + 1, P, torch.float32)
    out = tm.prefill(torch.from_numpy(toks), torch.from_numpy(lengths), pool,
                     page_table=torch.from_numpy(pt))
    assert _err(exp, out) < TOL
    view = paged.gather_view(pool, torch.from_numpy(pt))
    want = _to_port(jcache)
    for b, ln in enumerate(lengths):
        assert _err(want["krope"][:, b, :ln], view["krope"][:, b, :ln]) < TOL

    # the reference's pool: the same pages, in its own layout
    jpool = jm.init_cache(NP + 1, P, jnp.float32)
    tp = {k: v.numpy() for k, v in pool.items()}
    jpool = {"dense0": [(jnp.asarray(tp["ckv"][0]),
                         jnp.asarray(tp["krope"][0]))],
             "layers": (jnp.asarray(tp["ckv"][1:]),
                        jnp.asarray(tp["krope"][1:]))}
    active = np.array([True, False, True])
    nxt = np.array([[3], [4], [5]], np.int32)
    before = pool["ckv"].clone()
    exp, jpool = jm.decode_paged(params, jnp.asarray(nxt),
                                 jnp.asarray(lengths), jpool,
                                 jnp.asarray(pt), jnp.asarray(active))
    out = tm.decode_paged(torch.from_numpy(nxt), torch.from_numpy(lengths),
                          pool, torch.from_numpy(pt),
                          torch.from_numpy(active))
    assert float(np.max(np.abs(np.asarray(exp)[active]
                               - out.numpy()[active]))) < TOL
    got = _to_port(jpool)
    assert _err(got["ckv"][:, :NP], pool["ckv"][:, :NP]) < TOL
    assert torch.equal(pool["ckv"][:, pt[1]], before[:, pt[1]])


def test_deepseek_config_copy_matches_reference():
    from repro.configs import get_config as jax_get
    from repro_torch.configs import get_config
    for full, red in ((jax_get(DS), get_config(DS)),
                      (jax_config(DS), get_reduced_config(DS))):
        assert dataclasses.asdict(full) == dataclasses.asdict(red)
        assert full.key() == red.key()


# ------------------------------------- Zamba2: Mamba2 + shared attention ---
HY = "zamba2-7b"


@pytest.fixture(scope="module")
def hy_side():
    cfg = jax_config(HY)
    params = jax_build(cfg).init(jax.random.PRNGKey(0))
    return cfg, params, jax.device_get(params)


def _hy_pair(hy_side, use_kernels):
    jcfg, params, params_np = hy_side
    jcfg = dataclasses.replace(jcfg, use_kernels=use_kernels)
    tcfg = get_reduced_config(HY, use_kernels=use_kernels)
    tmodel = build_model(tcfg, device="cpu",
                         params=from_jax_params(params_np, tcfg, "cpu"))
    return jax_build(jcfg), params, tmodel


def _hy_state(jcache, name):
    """The reference's stacked (groups (G, every, ...), tail (T, ...))
    state leaf as the port's (n_layers, ...) one."""
    g = np.asarray(jcache["groups"][name])
    g = g.reshape((-1,) + g.shape[2:])
    return np.concatenate([g, np.asarray(jcache["tail"][name])])


def test_hybrid_weight_bridge_layouts(hy_side):
    _, _, params_np = hy_side
    tcfg = get_reduced_config(HY)
    state = from_jax_params(params_np, tcfg, "cpu")
    model = build_model(tcfg, device="cpu", params=state)
    assert set(state) == set(model.state_dict())
    every = tcfg.shared_attn_every
    assert tcfg.n_layers == 2 * every + 1
    for g in range(2):
        for i in range(every):
            np.testing.assert_array_equal(
                state[f"layers.{g * every + i}.mamba.w_zx"].numpy(),
                params_np["groups"]["mamba"]["w_zx"][g, i])
    np.testing.assert_array_equal(
        state[f"layers.{2 * every}.mamba.out_proj"].numpy(),
        params_np["tail"]["mamba"]["out_proj"][0])
    np.testing.assert_array_equal(state["shared_block.attn.wq"].numpy(),
                                  params_np["shared_block"]["attn"]["wq"])
    # the port's own init draws the same shapes; the SSM scalars stay f32
    # in a bf16 model, as the reference keeps them
    own = init_params(tcfg, torch.Generator().manual_seed(0),
                      torch.device("cpu"))
    assert {k: v.shape for k, v in own.items()} == \
        {k: v.shape for k, v in state.items()}
    bf = dataclasses.replace(tcfg, param_dtype="bfloat16")
    state = from_jax_params(params_np, bf, "cpu")
    assert state["layers.0.mamba.A_log"].dtype == torch.float32
    assert state["layers.0.mamba.dt_bias"].dtype == torch.float32
    assert state["layers.0.mamba.w_zx"].dtype == torch.bfloat16
    assert build_model(bf, device="cpu", params=state).layers[0].mamba \
        .D.dtype == torch.float32


def test_hybrid_full_width_parameter_count():
    """Full-width Zamba2-7B, built on the meta device: the reference's
    param_count() plus what it leaves out (norm scales, conv biases,
    dt_bias)."""
    from repro.configs import get_config as jax_get
    from repro_torch.configs import get_config
    from repro_torch.models import Hybrid
    cfg = get_config(HY)
    with torch.device("meta"):
        model = Hybrid(cfg, "meta")
    d, d_in, L = cfg.d_model, 2 * cfg.d_model, cfg.n_layers
    bc = 2 * cfg.ssm.n_groups * cfg.ssm.state_dim
    left_out = (L * (d + d_in) + 3 * d          # norm scales
                + L * (d_in + bc)               # conv biases
                + L * d_in // cfg.ssm.head_dim)  # dt_bias
    n = sum(p.numel() for p in model.parameters())
    assert n == jax_get(HY).param_count() + left_out == 6_788_341_584


@pytest.mark.parametrize("use_kernels", [False, True])
def test_hybrid_forward_matches_reference(hy_side, use_kernels):
    jm, params, tm = _hy_pair(hy_side, use_kernels)
    toks = _toks(2, 64, tm.cfg.vocab_size)
    lengths = np.array([64, 41], np.int32)
    for batch in ({}, {"lengths": lengths}):
        exp, _ = jm.forward(params, {"tokens": jnp.asarray(toks),
                                     **{k: jnp.asarray(v)
                                        for k, v in batch.items()}})
        out = tm.forward(torch.from_numpy(toks),
                         *(torch.from_numpy(v) for v in batch.values()))
        assert out.shape == (2, 64, tm.cfg.padded_vocab)
        assert _err(exp, out) < TOL


def test_hybrid_kernel_path_matches_reference_kernel_path(hy_side):
    """Port copy of test_models_consistency.test_kernel_path_matches_jnp
    for zamba2: with use_kernels the port (on the CPU: the kernels' plain
    versions) against the reference (its Pallas kernels in interpret mode)
    and against the port's plain path, within that test's 5e-3."""
    jm, params, tm = _hy_pair(hy_side, True)
    _, _, plain = _hy_pair(hy_side, False)
    toks = _toks(2, 128, tm.cfg.vocab_size, seed=2)
    exp, _ = jm.forward(params, {"tokens": jnp.asarray(toks)})
    out = tm.forward(torch.from_numpy(toks))
    assert _err(exp, out) < 5e-3
    assert float((out - plain.forward(torch.from_numpy(toks))).abs().max()) \
        < 5e-3


@pytest.mark.parametrize("use_kernels", [False, True])
def test_hybrid_prefill_and_decode_match_reference(hy_side, use_kernels):
    """A ragged prefill then three decode steps: logits, the shared
    block's K/V and every layer's SSM and conv states."""
    jm, params, tm = _hy_pair(hy_side, use_kernels)
    B, S, cache_len = 2, 32, 64
    toks = _toks(B, S, tm.cfg.vocab_size)
    lengths = np.array([20, 32], np.int32)
    jcache = jm.init_cache(B, cache_len, jnp.float32)
    exp, jcache = jm.prefill(params, jnp.asarray(toks), jnp.asarray(lengths),
                             jcache)
    tcache = tm.init_cache(B, cache_len, torch.float32)
    assert set(tcache) == {"k", "v", "ssm", "conv_x", "conv_bc"}
    assert tcache["ssm"].dtype == torch.float32
    out = tm.prefill(torch.from_numpy(toks), torch.from_numpy(lengths),
                     tcache)
    assert _err(exp, out) < TOL
    jk = np.asarray(jcache["attn"][0])
    for b, n in enumerate(lengths):
        assert float(np.max(np.abs(jk[:, b, :n]
                                   - tcache["k"][:, b, :n].numpy()))) < TOL
    for name in ("ssm", "conv_x", "conv_bc"):
        assert _err(_hy_state(jcache, name), tcache[name]) < 1e-3, name

    nxt = np.array([[5], [9]], np.int32)
    for _ in range(3):
        exp, jcache = jm.decode_step(params, jnp.asarray(nxt),
                                     jnp.asarray(lengths), jcache)
        out = tm.decode_step(torch.from_numpy(nxt),
                             torch.from_numpy(lengths), tcache)
        assert out.shape == (B, tm.cfg.padded_vocab)
        assert _err(exp, out) < TOL
        lengths = lengths + 1
    assert _err(_hy_state(jcache, "ssm"), tcache["ssm"]) < 1e-3


@pytest.mark.parametrize("use_kernels", [False, True])
def test_hybrid_prefill_decode_matches_forward(use_kernels):
    """Port copy of test_models_consistency.test_prefill_decode_matches_
    forward for zamba2, on the port's own init."""
    cfg = get_reduced_config(HY, use_kernels=use_kernels)
    model = build_model(cfg, device="cpu", seed=0)
    B, S = 2, 16
    toks = torch.from_numpy(_toks(B, S, cfg.vocab_size)).long()
    full = model.forward(toks)
    cache = model.init_cache(B, 64, torch.float32)
    lengths = torch.tensor([10, 16], dtype=torch.int32) - 1
    lg = model.prefill(toks, lengths, cache)
    assert float((lg[0] - full[0, 8]).abs().max()) < 2e-3
    assert float((lg[1] - full[1, 14]).abs().max()) < 2e-3
    nxt = torch.stack([toks[0, 9], toks[1, 15]])[:, None]
    lg = model.decode_step(nxt, lengths, cache)
    assert float((lg[0] - full[0, 9]).abs().max()) < 2e-3
    assert float((lg[1] - full[1, 15]).abs().max()) < 2e-3


def test_hybrid_prefill_writes_whole_state_rows_of_given_slots():
    """A wave whose bucket (4) is shorter than the SSM head count (8)
    writes its valid rows' states whole (every head) into their slots,
    and padding rows and other slots keep theirs bit for bit."""
    cfg = get_reduced_config(HY)
    model = build_model(cfg, device="cpu", seed=0)
    assert cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim == 8
    cache = model.init_cache(4, 32, torch.float32)
    for t in cache.values():
        t.normal_(generator=torch.Generator().manual_seed(3))
    before = {k: v.clone() for k, v in cache.items()}
    toks = torch.from_numpy(_toks(4, 4, cfg.vocab_size)).long()
    lengths = torch.tensor([4, 3, 0, 0], dtype=torch.int32)
    model.prefill(toks, lengths, cache, slots=torch.tensor([3, 1]))
    ref_cache = model.init_cache(2, 32, torch.float32)
    model.prefill(toks[:2], lengths[:2], ref_cache)
    for src, dst in ((0, 3), (1, 1)):
        for name in ("ssm", "conv_x", "conv_bc"):
            assert torch.equal(cache[name][:, dst], ref_cache[name][:, src])
        for name in ("k", "v"):
            assert torch.equal(cache[name][:, dst, :4],
                               ref_cache[name][:, src, :4])
    for name in cache:
        for free in (0, 2):
            assert torch.equal(cache[name][:, free], before[name][:, free])


def test_hybrid_decode_inactive_rows_leave_cache_untouched():
    cfg = get_reduced_config(HY)
    model = build_model(cfg, device="cpu", seed=0)
    cache = model.init_cache(3, 32, torch.float32)
    toks = torch.from_numpy(_toks(3, 8, cfg.vocab_size)).long()
    lengths = torch.tensor([8, 5, 7], dtype=torch.int32)
    model.prefill(toks, lengths, cache)
    before = {k: v.clone() for k, v in cache.items()}
    active = torch.tensor([True, False, True])
    model.decode_step(toks[:, :1], lengths, cache, active=active)
    for name in cache:
        assert torch.equal(cache[name][:, 1], before[name][:, 1]), name
        assert not torch.equal(cache[name][:, 0], before[name][:, 0]), name


def test_hybrid_config_copy_matches_reference():
    from repro.configs import get_config as jax_get
    from repro_torch.configs import get_config
    for full, red in ((jax_get(HY), get_config(HY)),
                      (jax_config(HY), get_reduced_config(HY))):
        assert dataclasses.asdict(full) == dataclasses.asdict(red)
        assert full.key() == red.key()
