"""Each function of repro_torch.models.layers against its JAX twin in
repro.models.layers, on the same numpy inputs (f32, CPU)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced_config as jax_config  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

TOL = 2e-5


def _x(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _close(a, b, tol=TOL):
    a = np.asarray(a, np.float32)
    b = b.float().numpy() if isinstance(b, torch.Tensor) else b
    assert a.shape == b.shape, (a.shape, b.shape)
    assert float(np.max(np.abs(a - b))) < tol


@pytest.fixture(scope="module")
def cfgs():
    return (jax_config("smollm2-1.7b"), get_reduced_config("smollm2-1.7b"))


def test_dtype_helpers(cfgs):
    jcfg, tcfg = cfgs
    assert tl.pdt(tcfg) == torch.float32 and tl.cdt(tcfg) == torch.float32
    full = dataclasses.replace(tcfg, param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    assert tl.pdt(full) == torch.bfloat16 and tl.cdt(full) == torch.bfloat16
    assert str(jl.pdt(jcfg)) == "float32"
    with pytest.raises(ValueError):
        tl.dt("float8_e4m3fn")


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_apply_norm(cfgs, norm):
    jcfg, tcfg = (dataclasses.replace(c, norm=norm) for c in cfgs)
    x = _x(0, (2, 5, 64), 3.0)
    scale = _x(1, (64,))
    bias = _x(2, (64,))
    p = {"scale": jnp.asarray(scale)}
    if norm == "layernorm":
        p["bias"] = jnp.asarray(bias)
    exp = jl.apply_norm(p, jnp.asarray(x), jcfg)
    out = tl.apply_norm(torch.from_numpy(x), torch.from_numpy(scale), tcfg,
                        torch.from_numpy(bias) if norm == "layernorm"
                        else None)
    _close(exp, out)


def test_apply_norm_keeps_bf16(cfgs):
    _, tcfg = cfgs
    x = torch.from_numpy(_x(0, (3, 64))).bfloat16()
    out = tl.apply_norm(x, torch.ones(64), tcfg)
    assert out.dtype == torch.bfloat16


def test_rms_norm_heads():
    x = _x(0, (2, 3, 4, 16))
    scale = _x(1, (16,))
    exp = jl.rms_norm_heads(jnp.asarray(x), jnp.asarray(scale), 1e-5)
    _close(exp, tl.rms_norm_heads(torch.from_numpy(x),
                                  torch.from_numpy(scale), 1e-5))


@pytest.mark.parametrize("tied", [True, False])
def test_embed_unembed_padded_vocab(cfgs, tied):
    jcfg, tcfg = (dataclasses.replace(c, tie_embeddings=tied, vocab_size=500)
                  for c in cfgs)
    assert tcfg.padded_vocab == 512
    tok = _x(0, (tcfg.padded_vocab, 64))
    unemb = _x(1, (64, tcfg.padded_vocab))
    ids = np.random.RandomState(2).randint(0, 500, size=(2, 7))
    p = {"tok": jnp.asarray(tok)}
    if not tied:
        p["unembed"] = jnp.asarray(unemb)
    e_j = jl.embed(p, jnp.asarray(ids), jcfg)
    e_t = tl.embed(torch.from_numpy(tok), torch.from_numpy(ids), tcfg)
    _close(e_j, e_t)
    lg_j = jl.unembed(p, e_j, jcfg)
    lg_t = tl.unembed(torch.from_numpy(tok), e_t, tcfg,
                      None if tied else torch.from_numpy(unemb))
    assert lg_t.shape == (2, 7, 512) and lg_t.dtype == torch.float32
    _close(lg_j, lg_t, 1e-4)


def test_rope_cos_sin_and_apply():
    pos = np.arange(9, dtype=np.int32)
    cj, sj = jl.rope_cos_sin(jnp.asarray(pos), 16, 130_000.0)
    ct, st = tl.rope_cos_sin(torch.from_numpy(pos), 16, 130_000.0)
    _close(cj, ct)
    _close(sj, st)
    x = _x(3, (2, 9, 4, 16))
    _close(jl.apply_rope(jnp.asarray(x), cj, sj),
           tl.apply_rope(torch.from_numpy(x), ct, st))


def test_rope_per_row_positions():
    """Decode's (B, 1) positions broadcast the same way in both."""
    pos = np.array([[3], [17]], np.int32)
    cj, sj = jl.rope_cos_sin(jnp.asarray(pos), 16, 10_000.0)
    ct, st = tl.rope_cos_sin(torch.from_numpy(pos), 16, 10_000.0)
    x = _x(4, (2, 1, 4, 16))
    _close(jl.apply_rope(jnp.asarray(x), cj, sj),
           tl.apply_rope(torch.from_numpy(x), ct, st))


def test_rope_rounds_like_the_reference_in_bf16():
    """cos/sin are cast to the activation dtype before multiplying."""
    pos = np.arange(40, dtype=np.int32)
    x = _x(5, (1, 40, 2, 64))
    cj, sj = jl.rope_cos_sin(jnp.asarray(pos), 64, 130_000.0)
    ct, st = tl.rope_cos_sin(torch.from_numpy(pos), 64, 130_000.0)
    exp = jl.apply_rope(jnp.asarray(x).astype(jnp.bfloat16), cj, sj)
    out = tl.apply_rope(torch.from_numpy(x).bfloat16(), ct, st)
    assert out.dtype == torch.bfloat16
    _close(exp.astype(jnp.float32), out.float(), 1e-2)


@pytest.mark.parametrize("activation", ["swiglu", "squared_relu", "gelu"])
def test_apply_mlp(cfgs, activation):
    jcfg, tcfg = (dataclasses.replace(c, activation=activation)
                  for c in cfgs)
    x = _x(0, (2, 5, 64))
    up, gate, down = _x(1, (64, 128), 0.1), _x(2, (64, 128), 0.1), \
        _x(3, (128, 64), 0.1)
    p = {"up": jnp.asarray(up), "down": jnp.asarray(down)}
    if activation == "swiglu":
        p["gate"] = jnp.asarray(gate)
    exp = jl.apply_mlp(p, jnp.asarray(x), jcfg)
    out = tl.apply_mlp(torch.from_numpy(x), torch.from_numpy(up),
                       torch.from_numpy(down), tcfg,
                       gate=(torch.from_numpy(gate)
                             if activation == "swiglu" else None))
    _close(exp, out, 1e-4)


def test_normal_init_scheme():
    g = torch.Generator().manual_seed(0)
    w = tl.normal_init((512, 256), 512, torch.float32, g,
                       torch.device("cpu"))
    assert abs(float(w.std()) - 512 ** -0.5) < 2e-3
    assert abs(float(w.mean())) < 2e-3
