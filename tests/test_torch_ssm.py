"""The port's Mamba2 functions (repro_torch.models.ssm) and the SSD scan's
plain version against the JAX reference (repro.models.ssm,
repro.kernels.ref, and repro.kernels.ops.ssm_scan, whose Pallas kernel
runs in interpret mode on the CPU): the same numpy-seeded f32 inputs
through both, on the reduced zamba2-7b (d_model 64, 8 SSM heads of 16,
state 16, 2 groups, conv width 4, chunk 32).

Tolerances: 2e-4 max-abs for the model functions (f32, sums in another
order); the SSD scan within the reference's own 2e-3
(tests/test_kernels.py::test_ssd_scan_sweep)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced_config as jax_config  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

TOL = 2e-4
SCAN_TOL = 2e-3
ARCH = "zamba2-7b"


def _rand(seed, shape, scale=1.0):
    return (scale * np.random.RandomState(seed).standard_normal(shape)
            ).astype(np.float32)


def _log_decay(seed, shape):
    """A per-step log-decay <= 0, as Mamba2's -exp(A_log) * dt is."""
    return -np.logaddexp(_rand(seed, shape), 0.0).astype(np.float32)


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a) - b.detach().numpy())))


@pytest.fixture(scope="module")
def mamba():
    """The reference's init_mamba2 params for the reduced config (the
    zeroed A_log, D and dt_bias and the unit norm scale replaced by seeded
    values, so that they reach the comparison) and the port's Mamba2
    module holding the same arrays."""
    jcfg = jax_config(ARCH)
    p = jax.device_get(jax_ssm.init_mamba2(jax.random.PRNGKey(0), jcfg))
    H = p["A_log"].shape[0]
    p["A_log"] = _rand(11, (H,), 0.5)
    p["D"] = _rand(12, (H,))
    p["dt_bias"] = _rand(13, (H,), 0.5)
    p["conv_x_b"] = _rand(14, p["conv_x_b"].shape, 0.1)
    p["norm"]["scale"] = 1.0 + _rand(15, p["norm"]["scale"].shape, 0.1)
    tcfg = get_reduced_config(ARCH)
    mod = ssm.Mamba2(tcfg, "cpu")
    flat = {k: v for k, v in p.items() if k != "norm"}
    flat["norm.scale"] = p["norm"]["scale"]
    mod.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                         for k, v in flat.items()}, strict=True)
    return jcfg, jax.tree_util.tree_map(jnp.asarray, p), tcfg, mod


@pytest.mark.parametrize("with_state", [False, True])
def test_chunked_linear_attention_matches_reference(with_state):
    B, S, H, Dk, Dv, chunk = 2, 64, 3, 8, 16, 16
    q, k = _rand(0, (B, S, H, Dk)), _rand(1, (B, S, H, Dk))
    v, la = _rand(2, (B, S, H, Dv)), _log_decay(3, (B, S, H))
    s0 = _rand(4, (B, H, Dk, Dv)) if with_state else None
    ey, es = jax_ssm.chunked_linear_attention(
        *map(jnp.asarray, (q, k, v, la)), chunk,
        initial_state=None if s0 is None else jnp.asarray(s0))
    y, st = ssm.chunked_linear_attention(
        *_t(q, k, v, la), chunk,
        initial_state=None if s0 is None else torch.from_numpy(s0))
    assert y.shape == (B, S, H, Dv) and st.shape == (B, H, Dk, Dv)
    assert st.dtype == torch.float32
    assert _err(ey, y) < TOL and _err(es, st) < TOL


def test_chunked_linear_attention_keeps_the_chunk_assertion():
    x = torch.zeros((1, 48, 1, 4))
    with pytest.raises(AssertionError, match="not divisible"):
        ssm.chunked_linear_attention(x, x, x, torch.zeros((1, 48, 1)), 32)


def test_linear_attention_step_matches_reference():
    B, H, Dk, Dv = 3, 4, 8, 16
    state, q, k = _rand(0, (B, H, Dk, Dv)), _rand(1, (B, H, Dk)), \
        _rand(2, (B, H, Dk))
    v, a = _rand(3, (B, H, Dv)), np.exp(_log_decay(4, (B, H)))
    ey, es = jax_ssm.linear_attention_step(*map(jnp.asarray,
                                               (state, q, k, v, a)))
    y, st = ssm.linear_attention_step(*_t(state, q, k, v, a))
    assert _err(ey, y) < TOL and _err(es, st) < TOL


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    B, S, C, K = 2, 9, 12, 4
    x, w, b = _rand(0, (B, S, C)), _rand(1, (K, C)), _rand(2, (C,))
    st = _rand(3, (B, K - 1, C)) if with_state else None
    ey, es = jax_ssm._causal_conv(
        *map(jnp.asarray, (x, w, b)),
        state=None if st is None else jnp.asarray(st))
    y, ns = ssm._causal_conv(*_t(x, w, b),
                             state=None if st is None else
                             torch.from_numpy(st))
    assert _err(ey, y) < TOL
    assert _err(es, ns) == 0.0


def test_ragged_conv_state_matches_reference():
    B, S, C, K = 3, 10, 5, 4
    x = _rand(0, (B, S, C))
    valid = np.arange(S)[None, :] < np.array([10, 2, 6])[:, None]
    exp = jax_ssm._ragged_conv_state(jnp.asarray(x), K, jnp.asarray(valid))
    out = ssm._ragged_conv_state(torch.from_numpy(x), K,
                                 torch.from_numpy(valid))
    assert out.shape == (B, K - 1, C)
    assert _err(exp, out) == 0.0


@pytest.mark.parametrize("use_kernels", [False, True])
def test_mamba2_prefill_with_valid_matches_reference(mamba, use_kernels):
    """Ragged rows (lengths 20 and 32 of 32): the output and the three
    cache leaves. With use_kernels the reference runs its Pallas SSD
    kernel in interpret mode and the port the kernel's plain version."""
    jcfg, jp, tcfg, mod = mamba
    jcfg = dataclasses.replace(jcfg, use_kernels=use_kernels)
    tcfg = dataclasses.replace(tcfg, use_kernels=use_kernels)
    B, S = 2, 32
    u = _rand(20, (B, S, tcfg.d_model))
    valid = np.arange(S)[None, :] < np.array([20, 32])[:, None]
    eo, ec = jax_ssm.mamba2_prefill(jp, jnp.asarray(u), jcfg,
                                    return_state=True,
                                    valid=jnp.asarray(valid))
    out, cache = ssm.mamba2_prefill(mod, torch.from_numpy(u), tcfg,
                                    return_state=True,
                                    valid=torch.from_numpy(valid))
    assert out.shape == (B, S, tcfg.d_model)
    assert _err(eo, out) < TOL
    assert set(cache) == {"ssm", "conv_x", "conv_bc"}
    for name in cache:
        assert cache[name].shape == ec[name].shape
        assert _err(ec[name], cache[name]) < TOL, name
    assert cache["ssm"].dtype == torch.float32


def test_mamba2_decode_matches_reference(mamba):
    jcfg, jp, tcfg, mod = mamba
    B = 3
    u = _rand(30, (B, 1, tcfg.d_model))
    c = ssm.mamba2_init_cache(tcfg, B, torch.float32, "cpu")
    st = {n: _rand(31 + i, tuple(t.shape), 0.5)
          for i, (n, t) in enumerate(c.items())}
    eo, ec = jax_ssm.mamba2_decode(jp, jnp.asarray(u), jcfg,
                                   {n: jnp.asarray(a) for n, a in st.items()})
    out, cache = ssm.mamba2_decode(mod, torch.from_numpy(u), tcfg,
                                   {n: torch.from_numpy(a)
                                    for n, a in st.items()})
    assert _err(eo, out) < TOL
    for name in cache:
        assert _err(ec[name], cache[name]) < TOL, name


def test_mamba2_init_cache_matches_reference():
    tcfg = get_reduced_config(ARCH)
    exp = jax_ssm.mamba2_init_cache(jax_config(ARCH), 3, jnp.bfloat16)
    out = ssm.mamba2_init_cache(tcfg, 3, torch.bfloat16, "cpu")
    assert {n: tuple(t.shape) for n, t in out.items()} == \
        {n: tuple(t.shape) for n, t in exp.items()}
    assert out["ssm"].dtype == torch.float32
    assert out["conv_x"].dtype == torch.bfloat16


SWEEP = [(1, 128, 2, 16, 32, 32), (2, 256, 1, 64, 64, 128),
         (1, 64, 4, 8, 16, 64)]


def _scan_inputs(B, S, H, N, P):
    return (_rand(0, (B, S, H, N)), _rand(1, (B, S, H, N)),
            _rand(2, (B, S, H, P)), _log_decay(3, (B, S, H)))


def _bhs(a, B, S, H):
    return np.ascontiguousarray(np.swapaxes(a, 1, 2).reshape(
        B * H, S, -1))


@pytest.mark.parametrize("B,S,H,N,P,chunk", SWEEP)
def test_ssd_scan_ref_matches_reference_ref(B, S, H, N, P, chunk):
    """The port's sequential plain version against the reference's, in
    the reference's (BH, S, .) layout."""
    C, Bm, v, la = _scan_inputs(B, S, H, N, P)
    args = [_bhs(a, B, S, H) for a in (C, Bm, v, la[..., None])]
    ey, es = jax_ref.ssd_scan_ref(*map(jnp.asarray, args))
    y, st = ref.ssd_scan_ref(*_t(*args))
    assert _err(ey, y) < SCAN_TOL and _err(es, st) < SCAN_TOL


@pytest.mark.parametrize("B,S,H,N,P,chunk", SWEEP)
def test_ssm_scan_matches_reference_pallas(B, S, H, N, P, chunk):
    """ops.ssm_scan (on the CPU: the plain version) against the
    reference's ops.ssm_scan (its Pallas kernel, interpret mode)."""
    C, Bm, v, la = _scan_inputs(B, S, H, N, P)
    ey, es = jax_ops.ssm_scan(*map(jnp.asarray, (C, Bm, v, la)),
                              chunk=chunk)
    y, st = ops.ssm_scan(*_t(C, Bm, v, la), chunk=chunk)
    assert y.shape == (B, S, H, P) and st.shape == (B, H, N, P)
    assert y.dtype == st.dtype == torch.float32
    assert _err(ey, y) < SCAN_TOL and _err(es, st) < SCAN_TOL


@pytest.mark.parametrize("H,G", [(8, 2), (4, 1), (6, 6)])
def test_ssm_scan_group_bc_equals_per_head(H, G):
    """B and C given once per group (B, S, G, N), head h reading group
    h // (H // G) as the reference's jnp.repeat makes them: the same bits
    as the per-head call on the repeated copies, and the reference's
    ops.ssm_scan on those copies within its 2e-3."""
    B, S, N, P = 2, 40, 16, 16
    C, Bm = _rand(0, (B, S, G, N)), _rand(1, (B, S, G, N))
    v, la = _rand(2, (B, S, H, P)), _log_decay(3, (B, S, H))
    y, st = ops.ssm_scan(*_t(C, Bm, v, la))
    Ch, Bh = (np.repeat(a, H // G, axis=2) for a in (C, Bm))
    yh, sth = ops.ssm_scan(*_t(Ch, Bh, v, la))
    assert y.shape == (B, S, H, P) and st.shape == (B, H, N, P)
    assert torch.equal(y, yh) and torch.equal(st, sth)
    ey, es = jax_ops.ssm_scan(*map(jnp.asarray, (Ch, Bh, v, la)), chunk=8)
    assert _err(ey, y) < SCAN_TOL and _err(es, st) < SCAN_TOL


def test_ssm_scan_padded_row_final_state():
    """Right padding as _mamba2_core_inputs makes it (dt = 0: log_a = 0
    and v = 0): a row padded from 37 to 64 steps ends in the state of its
    37 valid steps, and its first 37 outputs are the unpadded row's."""
    B, S, H, N, P, n = 1, 64, 2, 16, 16, 37
    C, Bm, v, la = _scan_inputs(B, S, H, N, P)
    v[:, n:], la[:, n:] = 0.0, 0.0
    y, st = ops.ssm_scan(*_t(C, Bm, v, la))
    y0, st0 = ops.ssm_scan(*_t(*(np.ascontiguousarray(a[:, :n])
                                 for a in (C, Bm, v, la))))
    assert float((st - st0).abs().max()) < TOL
    assert float((y[:, :n] - y0).abs().max()) < TOL


@pytest.mark.parametrize("use_kernels", [False, True])
def test_mamba2_prefill_padded_row_matches_unpadded(mamba, use_kernels):
    """The same through mamba2_prefill: a row of 20 tokens padded to 32
    with ``valid`` leaves the SSM and conv states the unpadded row
    leaves."""
    _, _, tcfg, mod = mamba
    tcfg = dataclasses.replace(tcfg, use_kernels=use_kernels)
    u = torch.from_numpy(_rand(40, (1, 32, tcfg.d_model)))
    valid = torch.arange(32)[None, :] < 20
    _, padded = ssm.mamba2_prefill(mod, u, tcfg, return_state=True,
                                   valid=valid)
    _, alone = ssm.mamba2_prefill(mod, u[:, :20].contiguous(), tcfg,
                                  return_state=True)
    for name in padded:
        assert float((padded[name] - alone[name]).abs().max()) < TOL, name
