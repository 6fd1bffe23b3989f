"""tests/test_torch_train.py's checks for xLSTM-350M, Whisper-small and
Llama-3.2-Vision-11B: the same functions, parametrised here over these
three families (``FAMILY_ARCHS``), in a file of their own so that the
test workers share the load. Whisper's and the VLM's batches carry their
frontend input (``frames``, ``patches``; ``family_batch``), which the
train step hands to ``forward_hidden``. The tolerances are that file's.

xLSTM's three train steps are held from the reference's state of each
step, not free-running (``test_xlstm_train_steps_match_reference_from_
each_state``): that file's docstring gives the readings.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import test_torch_train as base  # noqa: E402

ARCHS = base.FAMILY_ARCHS


@pytest.fixture(scope="module")
def families():
    return base.reference_models(ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
def test_size_helpers_match_reference(arch, full):
    base.test_size_helpers_match_reference(arch, full)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_and_aux_match_reference(families, arch):
    base.test_forward_hidden_and_aux_match_reference(families, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_value_and_no_gradient(families, arch):
    base.test_remat_changes_no_value_and_no_gradient(families, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference(families, arch):
    base.test_loss_and_every_gradient_match_reference(families, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_decay_mask_is_the_reference_ndim_test(families, arch):
    base.test_decay_mask_is_the_reference_ndim_test(families, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_updates_matches_reference(families, arch):
    base.test_apply_updates_matches_reference(families, arch)


@pytest.mark.parametrize("arch", ["whisper-small", "llama-3.2-vision-11b"])
@pytest.mark.parametrize("accum", [1, 2])
def test_three_train_steps_match_reference(families, arch, accum):
    base.test_three_train_steps_match_reference(families, arch, accum)


@pytest.mark.parametrize("accum", [1, 2])
def test_xlstm_train_steps_match_reference_from_each_state(families, accum):
    """xLSTM's three steps, each from the reference's parameters and
    moments of the step before: every loss within LOSS_TOL, every step's
    parameters within PARAM_TOL but for the outlier share, each outlier
    within 2 x lr (tests/test_torch_train.py's bounds)."""
    arch = "xlstm-350m"
    jm, params, _ = families[arch]
    cfg = base.get_reduced_config(arch)
    ocfg = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(base.jax_train_step(jm, base.JaxOpt(**ocfg),
                                        accum_steps=accum, ce_chunk=16))
    jp, jst = params, base.jax_init_state(params)

    def port(tree, **kw):
        return base.from_jax_params(jax.device_get(tree), cfg, "cpu", **kw)
    for i in range(3):
        model = base.build_model(cfg, device="cpu", params=port(jp))
        named = base.trainable(model)
        st = {"step": torch.tensor(int(jst["step"]), dtype=torch.int32),
              "mu": port(jst["mu"], dtype=torch.float32),
              "nu": port(jst["nu"], dtype=torch.float32)}
        step = base.make_train_step(model, base.OptimizerConfig(**ocfg),
                                    accum_steps=accum, ce_chunk=16)
        b = base.family_batch(cfg, B=4, S=32, seed=10 + i)
        named, st, met = step(named, st, base.as_torch(b))
        jp, jst, jmet = jstep(jp, jst, base.as_jax(b))
        assert abs(float(met["loss"]) - float(jmet["loss"])) < base.LOSS_TOL
        base.assert_params_close(named, port(jp), steps=1,
                                 lr=ocfg["peak_lr"])


@pytest.mark.parametrize("arch", ARCHS)
def test_to_jax_params_inverts_from_jax_params(families, arch):
    base.test_to_jax_params_inverts_from_jax_params(families, arch)
