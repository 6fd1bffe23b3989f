"""The port's MoE FFN (repro_torch.models.moe) against the JAX reference's
single-device path (repro.models.moe, no mesh): routing ids and weights,
and ``apply_moe`` through both of the port's routes (the reference's
``_dense_moe``, and the dispatch sorted by expert with the grouped GEMM's
plain version) on the reduced deepseek-v2-lite-16b in f32, numpy-seeded
inputs given to both packages."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced_config as jax_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.transformer import MoE  # noqa: E402
from repro_torch.weights import _flatten  # noqa: E402

TOL = 2e-4
ARCH = "deepseek-v2-lite-16b"


def _pair(seed=0, **overrides):
    """JAX MoE params and the port's MoE module holding the same weights."""
    jcfg = jax_config(ARCH, **overrides)
    params = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    with torch.device("meta"):
        mod = MoE(get_reduced_config(ARCH, **overrides), "meta")
    state = {k: torch.from_numpy(np.array(v, np.float32))
             for k, v in _flatten(jax.device_get(params)).items()}
    mod.load_state_dict(state, strict=True, assign=True)
    return jcfg, params, mod


def _x(shape, seed=1):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def test_route_matches_reference():
    jcfg, params, mod = _pair()
    tcfg = get_reduced_config(ARCH)
    x = _x((40, jcfg.d_model))
    ids_j, w_j, aux_j = jmoe.route(params, jnp.asarray(x), jcfg)
    ids, w, aux = moe.route(mod, torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(np.asarray(ids_j), ids.numpy())
    assert float(np.max(np.abs(np.asarray(w_j) - w.numpy()))) < 1e-6
    assert abs(float(aux_j) - float(aux)) < 1e-6
    assert torch.allclose(w.sum(dim=-1), torch.ones(40))


def test_topk_ties_take_the_first_index():
    """Exactly tied probabilities: both packages pick the lowest index
    first, round after round."""
    probs = np.array([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25]],
                     np.float32)
    wj, idj = jmoe._topk_partitioned(jnp.asarray(probs), 3)
    w, ids = moe._topk_partitioned(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(np.asarray(idj), ids.numpy())
    np.testing.assert_array_equal(ids.numpy(), [[1, 2, 0], [0, 1, 2]])
    np.testing.assert_array_equal(np.asarray(wj), w.numpy())


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("variant", [{}, dict(activation="gelu")])
def test_apply_moe_matches_reference(use_kernels, variant):
    """apply_moe, shared experts included, against the reference's no-mesh
    apply_moe (its _dense_moe): the port's dense route and its sorted
    dispatch with the plain grouped GEMM."""
    jcfg, params, mod = _pair(**variant)
    tcfg = get_reduced_config(ARCH, use_kernels=use_kernels, **variant)
    x = _x((2, 13, jcfg.d_model), seed=2)
    exp, _ = jmoe.apply_moe(params, jnp.asarray(x), jcfg)
    out, _ = moe.apply_moe(mod, torch.from_numpy(x), tcfg)
    assert out.shape == x.shape
    assert float(np.max(np.abs(np.asarray(exp) - out.numpy()))) < TOL


def test_sorted_dispatch_equals_dense_route_and_drops_nothing():
    """The two routes give the same sum whatever the capacity factor (the
    reference's single-device path drops no token), a token routed to an
    expert no other token chose included, and the sorted route is
    deterministic: two runs, the same bits."""
    _, _, mod = _pair(seed=3)
    cfg = get_reduced_config(ARCH)
    x = torch.from_numpy(_x((1, 37, cfg.d_model), seed=4))
    ids, w, _ = moe.route(mod, x[0], cfg)
    counts = torch.bincount(ids.reshape(-1), minlength=cfg.moe.n_experts)
    assert int(counts.max()) > 37 * cfg.moe.experts_per_token \
        // cfg.moe.n_experts, "no expert above an even share: vacuous"
    dense = moe._dense_moe(mod, x[0], ids, w, cfg)
    kcfg = dataclasses.replace(cfg, use_kernels=True)
    first, _ = moe.apply_moe(mod, x, kcfg, capacity_factor=0.01)
    again, _ = moe.apply_moe(mod, x, kcfg, capacity_factor=0.01)
    assert torch.equal(first, again)
    assert float((first[0] - moe._shared(mod, x)[0] - dense).abs().max()) \
        < TOL


def test_sorted_dispatch_runs_the_grouped_gemm_per_projection():
    """The kernel route calls the grouped entry point three times (gate,
    up, down) over rows grouped by expert; on the CPU it is the plain
    version and launches nothing."""
    _, _, mod = _pair()
    cfg = get_reduced_config(ARCH, use_kernels=True)
    calls = []
    real = ops.grouped_gemm_segments

    def spy(x, counts, w):
        calls.append((tuple(x.shape), counts.clone(), tuple(w.shape)))
        return real(x, counts, w)

    x = torch.from_numpy(_x((3, 5, cfg.d_model), seed=5))
    before = dict(ops.LAUNCHES)
    ops.grouped_gemm_segments = spy
    try:
        moe.apply_moe(mod, x, cfg)
    finally:
        ops.grouped_gemm_segments = real
    assert ops.LAUNCHES == before
    N = 15 * cfg.moe.experts_per_token
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff
    assert [(c[0], c[2]) for c in calls] == [((N, d), (e, d, f)),
                                             ((N, d), (e, d, f)),
                                             ((N, f), (e, f, d))]
    assert all(int(c[1].sum()) == N for c in calls)
