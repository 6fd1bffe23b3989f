"""The port on the card: each hand-written CUDA kernel against its plain
PyTorch version, and the engine with kernels against the engine without.

Every test here needs an NVIDIA card and skips without one (the kernels
have no CPU mode). The file imports nothing of JAX, so it also runs where
JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import InferenceEngine  # noqa: E402

TOL = {"float32": 2e-4, "bfloat16": 3e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(seed, shape, dev, dtype):
    x = np.random.RandomState(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(dev, TDT[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,D,causal,window", [
    (2, 128, 4, 4, 64, True, 0), (2, 256, 8, 2, 128, True, 64),
    (2, 200, 4, 4, 64, False, 0), (3, 77, 4, 1, 64, True, 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_matches_plain(cuda, B, S, H, Hkv, D, causal,
                                            window, dtype):
    q = _rand(0, (B, S, H, D), cuda, dtype)
    k = _rand(1, (B, S, Hkv, D), cuda, dtype)
    v = _rand(2, (B, S, Hkv, D), cuda, dtype)
    kv_len = torch.tensor([S] + [max(1, S // (i + 2)) for i in range(B - 1)],
                          dtype=torch.int32, device=cuda)
    kw = dict(causal=causal, window=window, scale=D ** -0.5, kv_len=kv_len)
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, **kw)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    exp = ref.flash_attention_ref(q, k, v, **kw)
    assert float((out.float() - exp.float()).abs().max()) < TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,D,Skv", [(2, 8, 2, 64, 256),
                                           (1, 4, 4, 128, 512),
                                           (3, 16, 1, 64, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_decode_matches_plain(cuda, B, H, Hkv, D, Skv, dtype):
    q = _rand(0, (B, H, D), cuda, dtype)
    k = _rand(1, (B, Skv, Hkv, D), cuda, dtype)
    v = _rand(2, (B, Skv, Hkv, D), cuda, dtype)
    lengths = torch.tensor([0] + [Skv - 3 * i for i in range(B - 1)],
                           dtype=torch.int32, device=cuda)
    out = ops.flash_decode(q, k, v, lengths, scale=D ** -0.5)
    exp = ref.flash_decode_ref(q, k, v, lengths, scale=D ** -0.5)
    assert float((out.float() - exp.float()).abs().max()) < TOL[dtype]
    assert float(out[0].abs().max()) == 0.0


@pytest.mark.cuda
def test_cuda_engine_kernels_match_plain_and_restore(cuda):
    """Reduced smollm2 in f32: greedy output with the kernels equals the
    plain path's; a demoted and restored context continues identically
    and frees its device memory while demoted."""
    cfg = get_reduced_config("smollm2-1.7b", use_kernels=True)
    model = build_model(cfg, device=cuda, seed=0)
    plain = build_model(dataclasses.replace(cfg, use_kernels=False),
                        device=cuda, params=dict(model.state_dict()))
    rng = np.random.RandomState(0)
    ps = [list(rng.randint(8, cfg.vocab_size, size=rng.randint(3, 30)))
          for _ in range(9)]
    kw = dict(device=cuda, slots=4, cache_len=64, prefill_buckets=(16, 32),
              megastep=4)
    with_kernels = InferenceEngine(model, **kw).generate(ps, 8)
    assert with_kernels == InferenceEngine(plain, **kw).generate(ps, 8)

    eng = InferenceEngine(model, **kw)
    before = torch.cuda.memory_allocated()
    host = eng.offload_device_state()
    assert torch.cuda.memory_allocated() < before
    assert all(t.is_pinned() for t in host["params"].values())
    eng.restore_device_state(host)
    assert eng.generate(ps, 8) == with_kernels
