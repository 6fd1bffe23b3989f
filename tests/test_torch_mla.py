"""The port's Multi-head Latent Attention (repro_torch.models.attention's
MLA functions) against the JAX reference's: blockwise prefill, absorbed
decode over the slot cache and over the paged latents (use_kernels on and
off), on the reduced deepseek-v2-lite-16b in f32 with numpy-seeded inputs
given to both packages; and a port copy of
tests/test_models_consistency.py::test_mla_decode_absorbed_matches_prefill_math."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced_config as jax_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import MLAAttention  # noqa: E402
from repro_torch.weights import _flatten  # noqa: E402

TOL = 2e-4
ARCH = "deepseek-v2-lite-16b"


@pytest.fixture(scope="module")
def mla_pair():
    jcfg = jax_config(ARCH)
    params = jattn.init_mla(jax.random.PRNGKey(0), jcfg)
    with torch.device("meta"):
        mod = MLAAttention(get_reduced_config(ARCH), "meta")
    mod.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                         for k, v in _flatten(jax.device_get(params)).items()},
                        strict=True, assign=True)
    return jcfg, params, mod


def _x(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a) - b.numpy())))


@pytest.mark.parametrize("kv_len", [None, [12, 5]])
def test_mla_prefill_matches_reference(mla_pair, kv_len):
    jcfg, params, mod = mla_pair
    cfg = get_reduced_config(ARCH)
    B, S = 2, 12
    x = _x((B, S, cfg.d_model), 1)
    kl = None if kv_len is None else np.array(kv_len, np.int32)
    y_j, (ckv_j, kr_j) = jattn.mla_prefill(
        params, jnp.asarray(x), jcfg, positions=jnp.arange(S),
        kv_len=None if kl is None else jnp.asarray(kl), return_kv=True)
    y, (ckv, kr) = attn.mla_prefill(
        mod, torch.from_numpy(x), cfg, positions=torch.arange(S),
        kv_len=None if kl is None else torch.from_numpy(kl))
    assert y.shape == (B, S, cfg.d_model)
    assert ckv.shape == (B, S, cfg.mla.kv_lora_rank)
    assert kr.shape == (B, S, cfg.mla.qk_rope_head_dim)
    rows = slice(None) if kl is None else slice(0, 5)   # valid in both rows
    assert _err(y_j[:, rows], y[:, rows]) < TOL
    assert _err(ckv_j, ckv) < TOL and _err(kr_j, kr) < TOL


def test_mla_prefill_chunks_agree(mla_pair):
    """Decompressing the latent a chunk at a time is the same attention
    as one chunk: 3 chunks of 8 against 1 of 24."""
    _, _, mod = mla_pair
    cfg = get_reduced_config(ARCH)
    x = torch.from_numpy(_x((2, 24, cfg.d_model), 2))
    pos = torch.arange(24)
    one, _ = attn.mla_prefill(mod, x, cfg, positions=pos)
    three, _ = attn.mla_prefill(mod, x, cfg, positions=pos, chunk=8)
    assert float((one - three).abs().max()) < 1e-5


def test_mla_decode_matches_reference(mla_pair):
    """Absorbed decode over the slot cache: the output and the latent row
    written at ``lengths``; an inactive row writes nothing."""
    jcfg, params, mod = mla_pair
    cfg = get_reduced_config(ARCH)
    B, Sc = 3, 16
    R, dr = cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim
    x = _x((B, 1, cfg.d_model), 3)
    ckv0, kr0 = _x((B, Sc, R), 4), _x((B, Sc, dr), 5)
    lengths = np.array([5, 0, 15], np.int32)
    y_j, ckv_j, kr_j = jattn.mla_decode(
        params, jnp.asarray(x), jcfg, cache_ckv=jnp.asarray(ckv0),
        cache_krope=jnp.asarray(kr0), lengths=jnp.asarray(lengths))
    ckv, kr = torch.from_numpy(ckv0.copy()), torch.from_numpy(kr0.copy())
    y = attn.mla_decode(mod, torch.from_numpy(x), cfg, cache_ckv=ckv,
                        cache_krope=kr, lengths=torch.from_numpy(lengths),
                        active=torch.tensor([True, False, True]))
    assert _err(np.asarray(y_j)[[0, 2]], y[[0, 2]]) < TOL
    for b in (0, 2):
        assert _err(np.asarray(ckv_j)[b], ckv[b]) < TOL
        assert _err(np.asarray(kr_j)[b], kr[b]) < TOL
    assert torch.equal(ckv[1], torch.from_numpy(ckv0[1]))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_paged_mla_decode_matches_reference(mla_pair, use_kernels):
    """Absorbed decode over paged latents (a scattered table, page 4, an
    inactive row): the output and the rows written through the table; the
    inactive row writes only into TRASH."""
    jcfg, params, mod = mla_pair
    cfg = get_reduced_config(ARCH, use_kernels=use_kernels)
    B, NP, P, n = 3, 14, 4, 4
    R, dr = cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim
    x = _x((B, 1, cfg.d_model), 6)
    ckv0, kr0 = _x((NP + 1, P, R), 7), _x((NP + 1, P, dr), 8)
    pt = np.random.RandomState(9).permutation(NP)[:B * n].reshape(
        B, n).astype(np.int32)
    lengths = np.array([9, 3, 15], np.int32)
    active = np.array([True, False, True])
    y_j, ckv_j, _ = jattn.paged_mla_decode(
        params, jnp.asarray(x), jcfg, ckv_pages=jnp.asarray(ckv0),
        krope_pages=jnp.asarray(kr0), page_table=jnp.asarray(pt),
        lengths=jnp.asarray(lengths), active=jnp.asarray(active))
    ckv, kr = torch.from_numpy(ckv0.copy()), torch.from_numpy(kr0.copy())
    y = attn.paged_mla_decode(
        mod, torch.from_numpy(x), cfg, ckv_pages=ckv, krope_pages=kr,
        page_table=torch.from_numpy(pt), lengths=torch.from_numpy(lengths),
        active=torch.from_numpy(active))
    assert _err(np.asarray(y_j)[active], y[torch.from_numpy(active)]) < TOL
    assert _err(np.asarray(ckv_j)[:NP], ckv[:NP]) < TOL
    assert torch.equal(ckv[pt[1]], torch.from_numpy(ckv0[pt[1]]))


def test_mla_decode_absorbed_matches_prefill_math():
    """Port copy of test_models_consistency's: absorbed-latent decode of
    the last token agrees with the blockwise MLA prefill's logits, on the
    port's own init (the reference's tolerance, 2e-3)."""
    cfg = get_reduced_config(ARCH)
    model = build_model(cfg, device="cpu", seed=0)
    B, S = 2, 12
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, size=(B, S))).long()
    full = model.forward(toks)
    cache = model.init_cache(B, 32, torch.float32)
    lengths = torch.full((B,), S - 1, dtype=torch.int32)
    model.prefill(toks[:, :S - 1], lengths, cache)
    lg = model.decode_step(toks[:, S - 1:], lengths, cache)
    assert float((lg - full[:, S - 1]).abs().max()) < 2e-3
