"""The port's kernel entry points (repro_torch.kernels.ops) against the JAX
package's: on the CPU the port runs its kernels' plain versions, the
reference its Pallas kernels in interpret mode. Same shape and dtype sweeps
and tolerances as tests/test_kernels.py, plus the port's extensions
(per-row kv_len, GQA by head index) against the reference's blockwise
attention. The CUDA kernels themselves are held against the plain versions
on the card in tests/test_torch_cuda.py."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = {"float32": 2e-4, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(seed, shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _both(seed, shape, dtype):
    x = _np(seed, shape)
    return jnp.asarray(x).astype(JDT[dtype]), torch.from_numpy(x).to(
        TDT[dtype])


def _err(a_jax, b_torch):
    a = np.asarray(a_jax.astype(jnp.float32))
    b = b_torch.float().numpy()
    return float(np.max(np.abs(a - b)))


@pytest.mark.parametrize("B,S,H,D", [(1, 128, 2, 64), (2, 256, 4, 128),
                                     (1, 512, 1, 64)])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_reference(B, S, H, D, causal, window,
                                           dtype):
    qj, qt = _both(0, (B, S, H, D), dtype)
    kj, kt = _both(1, (B, S, H, D), dtype)
    vj, vt = _both(2, (B, S, H, D), dtype)
    scale = D ** -0.5
    exp = jops.flash_attention(qj, kj, vj, causal=causal, window=window,
                               scale=scale)
    out = ops.flash_attention(qt, kt, vt, causal=causal, window=window,
                              scale=scale)
    assert out.dtype == TDT[dtype] and out.shape == (B, S, H, D)
    assert _err(exp, out) < TOL[dtype]


@pytest.mark.parametrize("B,H,Hkv,D,Skv", [(2, 8, 2, 64, 256),
                                           (1, 4, 4, 128, 512),
                                           (3, 16, 1, 64, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_matches_reference(B, H, Hkv, D, Skv, dtype):
    qj, qt = _both(0, (B, H, D), dtype)
    kj, kt = _both(1, (B, Skv, Hkv, D), dtype)
    vj, vt = _both(2, (B, Skv, Hkv, D), dtype)
    lengths = np.array([max(1, 1 + 37 * i % Skv) for i in range(B)],
                       np.int32)
    exp = jops.flash_decode(qj, kj, vj, jnp.asarray(lengths),
                            scale=D ** -0.5, block_k=128)
    out = ops.flash_decode(qt, kt, vt, torch.from_numpy(lengths),
                           scale=D ** -0.5)
    assert _err(exp, out) < TOL[dtype]


def test_flash_decode_active_mask_and_empty_slots():
    """Inactive slots and slots of length 0 give exact zeros, as the
    reference kernel's do; active slots match it."""
    B, H, Hkv, D, Skv = 4, 8, 2, 64, 256
    qj, qt = _both(0, (B, H, D), "float32")
    kj, kt = _both(1, (B, Skv, Hkv, D), "float32")
    vj, vt = _both(2, (B, Skv, Hkv, D), "float32")
    lengths = np.array([100, 7, 0, 256], np.int32)
    active = np.array([True, False, True, True])
    exp = jops.flash_decode(qj, kj, vj, jnp.asarray(lengths),
                            scale=D ** -0.5, block_k=128,
                            active=jnp.asarray(active))
    out = ops.flash_decode(qt, kt, vt, torch.from_numpy(lengths),
                           scale=D ** -0.5, active=torch.from_numpy(active))
    assert _err(exp, out) < TOL["float32"]
    assert float(out[1].abs().max()) == 0.0
    assert float(out[2].abs().max()) == 0.0


@pytest.mark.parametrize("H,Hkv", [(4, 4), (8, 2), (4, 1)])
@pytest.mark.parametrize("window", [0, 16])
def test_flash_attention_kv_len_gqa_matches_blockwise(H, Hkv, window):
    """The port's extensions on valid rows: per-row kv_len (padded prefill
    waves) and GQA by head index, against the reference's blockwise
    attention over head-repeated K/V."""
    B, S, D = 3, 40, 16
    qj, qt = _both(0, (B, S, H, D), "float32")
    kj, kt = _both(1, (B, S, Hkv, D), "float32")
    vj, vt = _both(2, (B, S, Hkv, D), "float32")
    kv_len = np.array([40, 17, 1], np.int32)
    scale = D ** -0.5
    exp = jattn.blockwise_attention(
        qj, jattn._repeat_kv(kj, H), jattn._repeat_kv(vj, H), scale=scale,
        causal=True, window=window, kv_len=jnp.asarray(kv_len))
    out = ops.flash_attention(qt, kt, vt, causal=True, window=window,
                              scale=scale, kv_len=torch.from_numpy(kv_len))
    # valid rows: those that see at least one key
    q = np.arange(S)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(S, int)
    hi = np.minimum(q[None, :] + 1, kv_len[:, None])
    rows = hi > lo[None, :]                                       # (B, S)
    assert rows.sum() > B * S // 2
    a = np.asarray(exp)[rows]
    b = out.numpy()[rows]
    assert float(np.max(np.abs(a - b))) < TOL["float32"]
    # rows that see no key come out as zeros (the reference: a finite mean)
    assert float(np.abs(out.numpy()[~rows]).max(initial=0.0)) == 0.0


def test_cpu_tensors_launch_no_kernel():
    before = dict(ops.LAUNCHES)
    q = torch.randn(1, 8, 2, 64)
    ops.flash_attention(q, q, q, scale=0.125)
    ops.flash_decode(q[:, 0], q, q, torch.tensor([3], dtype=torch.int32))
    assert ops.LAUNCHES == before


def test_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.decode_attention import flash_decode_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    q = torch.randn(1, 8, 2, 64)
    with pytest.raises(ValueError):
        flash_attention_cuda(q, q, q, causal=True, window=0, scale=1.0)
    with pytest.raises(ValueError):
        flash_decode_cuda(q[:, 0], q, q, torch.tensor([3], dtype=torch.int32),
                          scale=1.0)
