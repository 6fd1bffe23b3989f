"""The port on the card: each hand-written CUDA kernel against its plain
PyTorch version, and the engines (slot cache, paged pool with prefix
sharing, the reduced DeepSeek on the paged pool, the reduced Zamba2 hybrid
on the slot cache) with kernels against the same engines without.

Every test here needs an NVIDIA card and skips without one (the kernels
have no CPU mode). The file imports nothing of JAX, so it also runs where
JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""

import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import InferenceEngine, Request  # noqa: E402

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


def _gemm_tol(dtype, d, exp):
    """The reference's bound (tests/test_kernels.py:130-131, relative to the
    depth), capped at TOL[dtype] of the largest plain output: a bf16 output
    is within a few of its own rounding steps, and a tile of zeros or of
    another expert's weights is off by the output's whole size."""
    return min((5e-3 if dtype == "float32" else 1.0) * d ** 0.5,
               TOL[dtype] * float(exp.float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,D,causal,window", [
    (2, 128, 4, 4, 64, True, 0), (2, 256, 8, 2, 128, True, 64),
    (2, 200, 4, 4, 64, False, 0), (3, 77, 4, 1, 64, True, 0),
    (2, 160, 4, 4, 112, True, 0), (2, 50, 4, 2, 16, True, 0),
    (2, 70, 4, 2, 32, False, 0), (1, 20, 2, 2, 112, True, 8)])
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
                                           (3, 16, 1, 64, 100),
                                           (3, 8, 8, 112, 300)])
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


def _paged_pool(seed, B, npages, num_pages, page, Hkv, D, dev, dtype):
    """Random K and V pools of num_pages + 1 pages and a table giving each
    slot npages distinct pages, scattered across the pool."""
    rng = np.random.RandomState(seed)
    kp = _rand(seed + 1, (num_pages + 1, page, Hkv, D), dev, dtype)
    vp = _rand(seed + 2, (num_pages + 1, page, Hkv, D), dev, dtype)
    ids = rng.permutation(num_pages)[:B * npages].reshape(B, npages)
    return kp, vp, torch.as_tensor(ids.astype(np.int32), device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("page,npages", [(8, 4), (16, 2), (32, 3), (7, 5),
                                         (64, 16)])
@pytest.mark.parametrize("H,Hkv", [(8, 2), (32, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_paged_flash_decode_matches_plain(cuda, page, npages, H, Hkv,
                                               dtype):
    B, D = 4, 64
    kp, vp, pt = _paged_pool(1, B, npages, 2 * B * npages, page, Hkv, D,
                             cuda, dtype)
    q = _rand(0, (B, H, D), cuda, dtype)
    cap = npages * page
    lengths = torch.tensor([cap, (cap // 2) | 1, 1, 0], dtype=torch.int32,
                           device=cuda)
    before = ops.LAUNCHES["paged_flash_decode"]
    out = ops.paged_flash_decode(q, kp, vp, pt, lengths, scale=D ** -0.5)
    assert ops.LAUNCHES["paged_flash_decode"] == before + 1
    exp = ref.paged_decode_ref(q, kp, vp, pt, lengths, scale=D ** -0.5)
    assert float((out.float() - exp.float()).abs().max()) < TOL[dtype]
    assert float(out[3].abs().max()) == 0.0


@pytest.mark.cuda
def test_cuda_paged_flash_decode_table_slice_and_trash(cuda):
    """A column slice of a wider table is read through its row stride; a
    TRASH page past the live columns is never read; a table whose rows are
    not contiguous is refused."""
    B, H, Hkv, D, page, npages = 3, 8, 2, 64, 16, 6
    num_pages = 2 * B * npages
    kp, vp, pt = _paged_pool(5, B, npages, num_pages, page, Hkv, D, cuda,
                             "float32")
    q = _rand(0, (B, H, D), cuda, "float32")
    lengths = torch.tensor([20, 2 * page, 1], dtype=torch.int32, device=cuda)
    wide = torch.full((B, 2 * npages), num_pages, dtype=torch.int32,
                      device=cuda)
    wide[:, :npages] = pt
    kp[num_pages] = 1e4
    vp[num_pages] = 1e4
    sliced = wide[:, :3]
    assert not sliced.is_contiguous()
    out = ops.paged_flash_decode(q, kp, vp, sliced, lengths, scale=0.125)
    exp = ref.paged_decode_ref(q, kp, vp, pt[:, :3].contiguous(), lengths,
                               scale=0.125)
    assert float((out - exp).abs().max()) < TOL["float32"]
    with pytest.raises(ValueError):
        ops.paged_flash_decode(q, kp, vp, wide.t().contiguous().t()[:, :3],
                               lengths, scale=0.125)


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,D", [(4, 4, 64), (8, 2, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_q_offset_matches_plain(cuda, H, Hkv, D, dtype):
    """Tail rows at per-row query offsets over a longer K/V (the shared
    prefill), with kv_len, against the plain version."""
    B, S, T = 3, 40, 300
    q = _rand(0, (B, S, H, D), cuda, dtype)
    k = _rand(1, (B, T, Hkv, D), cuda, dtype)
    v = _rand(2, (B, T, Hkv, D), cuda, dtype)
    q_offset = torch.tensor([0, 77, 250], dtype=torch.int32, device=cuda)
    kv_len = torch.tensor([30, 117, 290], dtype=torch.int32, device=cuda)
    kw = dict(causal=True, scale=D ** -0.5, kv_len=kv_len, q_offset=q_offset)
    out = ops.flash_attention(q, k, v, **kw)
    exp = ref.flash_attention_ref(q, k, v, **kw)
    assert float((out.float() - exp.float()).abs().max()) < TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 112])
def test_cuda_flash_attention_tail_rows_bitwise_equal_whole_prompt(cuda, D):
    """The prefix-sharing contract of the bf16 (wgmma) route: tail rows
    prefilled at query offsets that are not multiples of the 64-key tile,
    in a bucket of 32 (rows past a prompt's end included), get the bits of
    the same rows of a whole-prompt call on the same K/V."""
    B, S, H = 4, 256, 8
    q, k, v = (_rand(i, (B, S, H, D), cuda, "bfloat16") for i in range(3))
    kl = torch.tensor([256, 200, 131, 97], dtype=torch.int32, device=cuda)
    kw = dict(causal=True, scale=D ** -0.5, kv_len=kl)
    whole = ops.flash_attention(q, k, v, **kw)
    for off in (1, 37, 100, 131, 200, 224):
        qo = torch.full((B,), off, dtype=torch.int32, device=cuda)
        tail = ops.flash_attention(q[:, off:off + 32].contiguous(), k, v,
                                   q_offset=qo, **kw)
        assert torch.equal(tail, whole[:, off:off + 32]), off
    exp = ref.flash_attention_ref(q, k, v, **kw)
    assert float((whole.float() - exp.float()).abs().max()) < TOL["bfloat16"]


def _slot_as_pages(ck, cv, page, npages, seed):
    """The slot cache's K/V (B, Skv, Hkv, D) laid out in a pool of pages
    scattered at random, each slot's table npages wide (its columns past
    Skv / page name the poisoned TRASH page, the pool's last)."""
    B, Skv, Hkv, D = ck.shape
    used = Skv // page
    total = B * used
    perm = torch.as_tensor(np.random.RandomState(seed).permutation(total),
                           device=ck.device)
    kp = torch.full((total + 1, page, Hkv, D), 1e4, dtype=ck.dtype,
                    device=ck.device)
    vp = kp.clone()
    kp[perm] = ck.reshape(total, page, Hkv, D)
    vp[perm] = cv.reshape(total, page, Hkv, D)
    pt = torch.full((B, npages), total, dtype=torch.int32, device=ck.device)
    pt[:, :used] = perm.reshape(B, used).to(torch.int32)
    return kp, vp, pt


@pytest.mark.cuda
@pytest.mark.parametrize("page,npages", [(64, 20), (16, 80), (7, 150)])
@pytest.mark.parametrize("H,Hkv,D", [(32, 32, 64), (32, 32, 112),
                                     (8, 2, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_decode_slot_and_paged_bitwise_equal(cuda, page, npages, H,
                                                  Hkv, D, dtype):
    """The slot cache (Skv 1024, or 1022 = 146 pages of 7) and a page table
    of another capacity (n * P = 1280, 1280, 1050) holding the same K/V
    give the same bits: both sum a slot's keys over the same fixed 256-key
    splits in the same order. Lengths on and next to split boundaries, a
    full cache, an empty slot."""
    Skv = 1024 if 1024 % page == 0 else (1024 // page) * page
    B = 8
    q = _rand(0, (B, H, D), cuda, dtype)
    ck = _rand(1, (B, Skv, Hkv, D), cuda, dtype)
    cv = _rand(2, (B, Skv, Hkv, D), cuda, dtype)
    kp, vp, pt = _slot_as_pages(ck, cv, page, npages, 3)
    assert npages * page != Skv
    lengths = torch.tensor([0, 1, 255, 256, 257, 512, 700, Skv],
                           dtype=torch.int32, device=cuda)
    slot = ops.flash_decode(q, ck, cv, lengths, scale=D ** -0.5)
    paged = ops.paged_flash_decode(q, kp, vp, pt, lengths, scale=D ** -0.5)
    assert torch.equal(slot, paged)
    exp = ref.flash_decode_ref(q, ck, cv, lengths, scale=D ** -0.5)
    assert float((slot.float() - exp.float()).abs().max()) < TOL[dtype]
    assert float(slot[0].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_decode_split_boundaries_and_determinism(cuda, dtype):
    """Lengths at split - 1, split, split + 1, two splits and a full cache
    against the plain version; empty and inactive slots exact zeros; two
    launches of either entry point give the same bits."""
    from repro_torch.kernels.decode_attention import DECODE_SPLIT as SP
    B, H, Hkv, D, Skv = 8, 16, 4, 64, 4 * SP
    q = _rand(4, (B, H, D), cuda, dtype)
    ck = _rand(5, (B, Skv, Hkv, D), cuda, dtype)
    cv = _rand(6, (B, Skv, Hkv, D), cuda, dtype)
    lengths = torch.tensor([SP - 1, SP, SP + 1, 2 * SP, Skv, 0, 3 * SP + 1,
                            SP], dtype=torch.int32, device=cuda)
    active = torch.tensor([True] * 7 + [False], device=cuda)
    kw = dict(scale=D ** -0.5, active=active)
    out = ops.flash_decode(q, ck, cv, lengths, **kw)
    exp = ref.flash_decode_ref(q, ck, cv, lengths, **kw)
    assert float((out.float() - exp.float()).abs().max()) < TOL[dtype]
    assert float(out[5:8:2].abs().max()) == 0.0
    assert torch.equal(out, ops.flash_decode(q, ck, cv, lengths, **kw))
    kp, vp, pt = _slot_as_pages(ck, cv, 32, Skv // 32 + 3, 7)
    paged = ops.paged_flash_decode(q, kp, vp, pt, lengths, scale=D ** -0.5)
    assert torch.equal(paged, ops.paged_flash_decode(q, kp, vp, pt, lengths,
                                                     scale=D ** -0.5))
    assert torch.equal(paged[:7], out[:7])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["narrow", "wide"])
@pytest.mark.parametrize("counts,d,f", [
    ([1, 2, 0, 1, 0, 0, 2, 1] * 8, 2048, 1408),        # a decode step
    ([5, 130, 3, 0, 200, 17, 0, 64], 1408, 2048),      # mid-tile segments
    ([40, 0, 77, 9], 1000, 200),                       # depth past 64 * k
    ([300, 1, 0, 129], 136, 1408)])
def test_cuda_grouped_gemm_both_shapes_match_plain(cuda, monkeypatch, shape,
                                                   counts, d, f):
    """Either tile shape, forced whatever (N, E) would choose, against the
    plain version: decode-shaped segments of 1-2 rows with empty experts,
    segments that start mid-tile, a depth no 64-deep k-slice divides read
    through the 3-D tensor map (zero-filled past d, not the next expert's
    weights), widths past the last 128-column strip. Output rows past
    sum(counts) keep a poisoned fill; two launches give the same bits."""
    from repro_torch.kernels import moe_gemm
    monkeypatch.setattr(moe_gemm, "gemm_shape", lambda N, E: shape)
    E, n = len(counts), sum(counts)
    N = n + 24
    x = _rand(0, (N, d), cuda, "bfloat16")
    w = _rand(1, (E, d, f), cuda, "bfloat16") * d ** -0.5
    cnt = torch.tensor(counts, dtype=torch.int32, device=cuda)
    out = torch.full((N, f), 7.0, dtype=torch.bfloat16, device=cuda)
    moe_gemm.grouped_gemm_segments_cuda(x, cnt, w, out=out)
    exp = ref.grouped_gemm_segments_ref(x[:n], cnt, w)
    err = float((out[:n].float() - exp.float()).abs().max())
    assert err <= _gemm_tol("bfloat16", d, exp)
    assert bool((out[n:] == 7.0).all())
    again = ops.grouped_gemm_segments(x, cnt, w)
    assert torch.equal(again[:n], out[:n])


@pytest.mark.cuda
def test_cuda_grouped_gemm_shape_choice_at_the_main_shapes(cuda):
    """The wrapper picks the narrow shape at a decode step (96 rows over 64
    experts) and the wide one at a fact-verification wave (3 072) and a
    prefill wave (49 152), from (N, E) alone."""
    from repro_torch.kernels.moe_gemm import gemm_shape
    assert [gemm_shape(n, 64) for n in (96, 3072, 49152)] == [
        "narrow", "wide", "wide"]


@pytest.mark.cuda
def test_cuda_paged_sharing_engine_kernels_match_plain(cuda):
    """Reduced smollm2 in f32, paged pool with prefix sharing: greedy output
    with the kernels equals the plain path's and the unshared engine's, the
    prefix cache hits, and every page comes back."""
    cfg = get_reduced_config("smollm2-1.7b", use_kernels=True)
    model = build_model(cfg, device=cuda, seed=0)
    plain = build_model(dataclasses.replace(cfg, use_kernels=False),
                        device=cuda, params=dict(model.state_dict()))
    rng = np.random.RandomState(0)
    prefix = list(rng.randint(8, cfg.vocab_size, size=21))
    ps = [prefix + list(rng.randint(8, cfg.vocab_size, size=3 + i % 5))
          for i in range(7)]
    kw = dict(device=cuda, slots=2, cache_len=64, prefill_buckets=(16, 32),
              megastep=4, paged=True, page_size=8)
    eng = InferenceEngine(model, **kw)
    with_kernels = eng.generate(ps, 10)
    assert eng.stats.prefix_hits >= 4 and eng.stats.cow_copies >= 1
    assert with_kernels == InferenceEngine(plain, **kw).generate(ps, 10)
    assert with_kernels == InferenceEngine(
        model, prefix_sharing=False, **kw).generate(ps, 10)
    eng._alloc.check(eng._prefix_cache.pages())
    eng.drop_prefix_cache()
    assert eng._alloc.free_pages == eng.num_pages


def _mla_pool(seed, B, npages, num_pages, page, R, Dr, dev, dtype):
    """Random latent and rope-key pools of num_pages + 1 pages and a table
    giving each slot npages distinct pages, scattered across the pool."""
    rng = np.random.RandomState(seed)
    ckv = _rand(seed + 1, (num_pages + 1, page, R), dev, dtype)
    kr = _rand(seed + 2, (num_pages + 1, page, Dr), dev, dtype)
    ids = rng.permutation(num_pages)[:B * npages].reshape(B, npages)
    return ckv, kr, torch.as_tensor(ids.astype(np.int32), device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("page,npages", [(8, 4), (16, 3), (7, 5), (64, 16)])
@pytest.mark.parametrize("H,R,Dr", [(8, 32, 16), (16, 512, 64), (5, 48, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_paged_mla_decode_matches_plain(cuda, page, npages, H, R, Dr,
                                             dtype):
    """The MLA kernel against its plain version: the reference's page sweep
    at its (H 8, R 32, Dr 16), DeepSeek-V2-Lite's (16, 512, 64) and an odd
    head count; page-boundary, mid-page, single-token and empty slots."""
    B = 4
    ckv, kr, pt = _mla_pool(1, B, npages, 2 * B * npages, page, R, Dr, cuda,
                            dtype)
    ql = _rand(0, (B, H, R), cuda, dtype)
    qr = _rand(3, (B, H, Dr), cuda, dtype)
    cap = npages * page
    lengths = torch.tensor([cap, (cap // 2) | 1, 1, 0], dtype=torch.int32,
                           device=cuda)
    scale = (R + Dr) ** -0.5
    before = ops.LAUNCHES["paged_mla_decode"]
    out = ops.paged_mla_decode(ql, qr, ckv, kr, pt, lengths, scale=scale)
    assert ops.LAUNCHES["paged_mla_decode"] == before + 1
    exp = ref.paged_mla_decode_ref(ql, qr, ckv, kr, pt, lengths, scale=scale)
    assert out.dtype == ql.dtype and out.shape == (B, H, R)
    assert float((out.float() - exp.float()).abs().max()) < TOL[dtype]
    assert float(out[3].abs().max()) == 0.0


@pytest.mark.cuda
def test_cuda_paged_mla_decode_table_slice_and_trash(cuda):
    """A column slice of a wider table is read through its row stride and
    a poisoned TRASH page past the live columns is never read."""
    B, H, R, Dr, page, npages = 3, 8, 64, 16, 16, 6
    num_pages = 2 * B * npages
    ckv, kr, pt = _mla_pool(5, B, npages, num_pages, page, R, Dr, cuda,
                            "float32")
    ql = _rand(0, (B, H, R), cuda, "float32")
    qr = _rand(1, (B, H, Dr), cuda, "float32")
    lengths = torch.tensor([20, 2 * page, 1], dtype=torch.int32, device=cuda)
    wide = torch.full((B, 2 * npages), num_pages, dtype=torch.int32,
                      device=cuda)
    wide[:, :npages] = pt
    ckv[num_pages] = 1e4
    kr[num_pages] = 1e4
    out = ops.paged_mla_decode(ql, qr, ckv, kr, wide[:, :3], lengths,
                               scale=0.1)
    exp = ref.paged_mla_decode_ref(ql, qr, ckv, kr, pt[:, :3].contiguous(),
                                   lengths, scale=0.1)
    assert float((out - exp).abs().max()) < TOL["float32"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_paged_mla_decode_two_head_groups(cuda, dtype):
    """H = 20: two 16-head groups a slot in bf16, the second holding 4
    heads (its zero query rows are never written); f32's head pairs."""
    B, H, R, Dr, page, npages = 3, 20, 512, 64, 64, 4
    ckv, kr, pt = _mla_pool(7, B, npages, 2 * B * npages, page, R, Dr, cuda,
                            dtype)
    ql = _rand(0, (B, H, R), cuda, dtype)
    qr = _rand(3, (B, H, Dr), cuda, dtype)
    lengths = torch.tensor([npages * page, 77, 1], dtype=torch.int32,
                           device=cuda)
    scale = (128 + Dr) ** -0.5
    out = ops.paged_mla_decode(ql, qr, ckv, kr, pt, lengths, scale=scale)
    exp = ref.paged_mla_decode_ref(ql, qr, ckv, kr, pt, lengths, scale=scale)
    assert out.shape == (B, H, R)
    assert float((out.float() - exp.float()).abs().max()) < TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_paged_mla_decode_every_split_live_and_deterministic(cuda,
                                                                  dtype):
    """One slot filling a 8 192-key table, so every split is live and each
    walks eight 64-key tiles through the double buffer, beside slots of
    length 0 and 1 in the same call; two calls give the same bits."""
    from repro_torch.kernels.decode_attention import mla_splits
    B, H, R, Dr, page, npages = 16, 16, 512, 64, 64, 128
    splits, keys = mla_splits(B, H, npages * page, 132)
    assert keys >= 8 * 64 and splits * keys >= npages * page
    ckv, kr, pt = _mla_pool(9, B, npages, B * npages, page, R, Dr, cuda,
                            dtype)
    ql = _rand(0, (B, H, R), cuda, dtype)
    qr = _rand(3, (B, H, Dr), cuda, dtype)
    lens = [npages * page, 0, 1] + np.random.RandomState(4).randint(
        2, npages * page, size=B - 3).tolist()
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    scale = (128 + Dr) ** -0.5
    out = ops.paged_mla_decode(ql, qr, ckv, kr, pt, lengths, scale=scale)
    again = ops.paged_mla_decode(ql, qr, ckv, kr, pt, lengths, scale=scale)
    exp = ref.paged_mla_decode_ref(ql, qr, ckv, kr, pt, lengths, scale=scale)
    assert float((out.float() - exp.float()).abs().max()) < TOL[dtype]
    assert float(out[1].abs().max()) == 0.0
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,d,f", [(2, 128, 256, 128), (8, 256, 128, 256),
                                     (4, 70, 1408, 200)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_grouped_gemm_matches_plain(cuda, E, C, d, f, dtype):
    """The reference's sweep (tests/test_kernels.py:121-131), plus a ragged
    row count with DeepSeek's expert depth 1408; its tolerance, capped by
    the output's size."""
    x = _rand(0, (E, C, d), cuda, dtype)
    w = _rand(1, (E, d, f), cuda, dtype)
    before = ops.LAUNCHES["grouped_gemm"]
    out = ops.grouped_gemm(x, w)
    assert ops.LAUNCHES["grouped_gemm"] == before + 1
    exp = ref.grouped_gemm_ref(x, w)
    assert out.shape == (E, C, f) and out.dtype == x.dtype
    err = float((out.float() - exp.float()).abs().max())
    assert err <= _gemm_tol(dtype, d, exp)


@pytest.mark.cuda
@pytest.mark.parametrize("counts,d,f", [
    ([3, 0, 1, 0, 70, 2, 0, 130], 2048, 1408),
    ([1] * 40 + [0] * 20 + [14, 0, 33, 9], 1408, 2048),
    ([5, 0, 0, 11], 104, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_grouped_gemm_segments_matches_plain(cuda, counts, d, f, dtype):
    """Rows grouped by expert with empty experts, DeepSeek's depths 2048
    and 1408, and a depth and width that no tile divides."""
    E, N = len(counts), sum(counts)
    x = _rand(0, (N, d), cuda, dtype)
    w = _rand(1, (E, d, f), cuda, dtype)
    cnt = torch.tensor(counts, dtype=torch.int32, device=cuda)
    before = ops.LAUNCHES["grouped_gemm_segments"]
    out = ops.grouped_gemm_segments(x, cnt, w)
    assert ops.LAUNCHES["grouped_gemm_segments"] == before + 1
    exp = ref.grouped_gemm_segments_ref(x, cnt, w)
    err = float((out.float() - exp.float()).abs().max())
    assert err <= _gemm_tol(dtype, d, exp)


@pytest.mark.cuda
def test_cuda_kernels_refuse_widths_not_multiple_of_8(cuda):
    """The MLA decode and the grouped GEMM stage whole 16-byte chunks: the
    wrappers refuse widths that are not multiples of 8 and unaligned
    pools instead of launching."""
    cnt = torch.tensor([2, 1], dtype=torch.int32, device=cuda)
    w = _rand(1, (2, 100, 40), cuda, "bfloat16")
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.grouped_gemm_segments(_rand(0, (3, 100), cuda, "bfloat16"), cnt,
                                  w)
    x = _rand(0, (3 * 104 + 1,), cuda, "bfloat16")[1:].view(3, 104)
    with pytest.raises(ValueError, match="aligned"):
        ops.grouped_gemm_segments(x, cnt, _rand(1, (2, 104, 40), cuda,
                                                "bfloat16"))
    ckv, kr, pt = _mla_pool(1, 2, 2, 4, 8, 20, 6, cuda, "float32")
    ql = _rand(0, (2, 3, 20), cuda, "float32")
    qr = _rand(3, (2, 3, 6), cuda, "float32")
    lengths = torch.tensor([5, 9], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.paged_mla_decode(ql, qr, ckv, kr, pt, lengths, scale=0.1)


@pytest.mark.cuda
def test_cuda_mla_bf16_widest_row_runs_and_wider_is_refused(cuda):
    """The bf16 MLA kernel stages two 64-key tiles of R + Dr values and q in
    shared memory: the widest row the library reports (at least
    DeepSeek's 512 + 64) launches and matches the plain version, one 8
    wider is refused by the wrapper."""
    from repro_torch.kernels.decode_attention import mla_max_width
    B, H, R, page, npages = 2, 16, 512, 16, 5
    width = mla_max_width(torch.bfloat16)
    assert width >= R + 64 and width % 8 == 0
    for Dr in (width - R, width - R + 8):
        ckv, kr, pt = _mla_pool(2, B, npages, 2 * B * npages, page, R, Dr,
                                cuda, "bfloat16")
        ql = _rand(0, (B, H, R), cuda, "bfloat16")
        qr = _rand(3, (B, H, Dr), cuda, "bfloat16")
        lengths = torch.tensor([npages * page, 37], dtype=torch.int32,
                               device=cuda)
        args = (ql, qr, ckv, kr, pt, lengths)
        if R + Dr > width:
            with pytest.raises(ValueError, match=f"above {width}"):
                ops.paged_mla_decode(*args, scale=0.05)
            continue
        out = ops.paged_mla_decode(*args, scale=0.05)
        exp = ref.paged_mla_decode_ref(*args, scale=0.05)
        assert float((out.float() - exp.float()).abs().max()) < TOL["bfloat16"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_mla_entry_refuses_splits_short_of_the_table(cuda, dtype):
    """The C entry itself refuses key ranges that do not cover the table
    (splits * split_keys < npages * page_size), before any launch, and
    takes the same call with one range more."""
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import (_DTYPES, _MLA_ARGTYPES,
                                                      _lib)
    B, H, R, Dr, page, npages = 2, 16, 32, 16, 16, 5  # 80 keys a slot
    ckv, kr, pt = _mla_pool(4, B, npages, 2 * B * npages, page, R, Dr, cuda,
                            dtype)
    ql = _rand(0, (B, H, R), cuda, dtype)
    qr = _rand(3, (B, H, Dr), cuda, dtype)
    lengths = torch.tensor([npages * page, 41], dtype=torch.int32,
                           device=cuda)
    lib = _lib("paged_mla_decode", _MLA_ARGTYPES)
    for splits in (1, 2):  # 64-key ranges: 64 keys short, 128 covering
        part = torch.empty((B, H, splits, R), dtype=torch.float32,
                           device=cuda)
        part_ml = torch.empty((B, H, splits, 2), dtype=torch.float32,
                              device=cuda)
        out = torch.empty_like(ql)
        code = lib.paged_mla_decode_fwd(
            ql.data_ptr(), qr.data_ptr(), ckv.data_ptr(), kr.data_ptr(),
            pt.data_ptr(), npages, npages, page, lengths.data_ptr(),
            part.data_ptr(), part_ml.data_ptr(), out.data_ptr(), B, H, R, Dr,
            0.1, splits, 64, _DTYPES[ql.dtype],
            torch.cuda.current_stream().cuda_stream)
        if splits == 1:
            assert code != 0
            continue
        build.check(lib, "paged_mla_decode", code)
        exp = ref.paged_mla_decode_ref(ql, qr, ckv, kr, pt, lengths,
                                       scale=0.1)
        assert float((out.float() - exp.float()).abs().max()) < TOL[dtype]


@pytest.mark.cuda
def test_cuda_deepseek_engine_kernels_match_plain(cuda):
    """Reduced deepseek-v2-lite in f32 on the paged pool: greedy output
    with the kernels (MLA decode, grouped GEMM) equals the plain path's
    and the slot cache's; sharing resolves off."""
    cfg = get_reduced_config("deepseek-v2-lite-16b", use_kernels=True)
    model = build_model(cfg, device=cuda, seed=0)
    plain = build_model(dataclasses.replace(cfg, use_kernels=False),
                        device=cuda, params=dict(model.state_dict()))
    rng = np.random.RandomState(0)
    ps = [list(rng.randint(8, cfg.vocab_size, size=rng.randint(3, 30)))
          for _ in range(9)]
    kw = dict(device=cuda, slots=4, cache_len=64, prefill_buckets=(16, 32),
              megastep=4)
    ops.reset_launches()
    eng = InferenceEngine(model, paged=True, page_size=8, **kw)
    with_kernels = eng.generate(ps, 8)
    assert ops.LAUNCHES["paged_mla_decode"] > 0
    assert ops.LAUNCHES["grouped_gemm_segments"] > 0
    assert eng.prefix_fallback.startswith("model has no shared-prefix")
    assert with_kernels == InferenceEngine(plain, paged=True, page_size=8,
                                           **kw).generate(ps, 8)
    assert with_kernels == InferenceEngine(plain, **kw).generate(ps, 8)


@pytest.mark.cuda
def test_cuda_deepseek_engine_bf16_kernels_match_plain(cuda):
    """Reduced deepseek-v2-lite in bf16, so the MoE layer runs the grouped
    GEMM's tensor-core body: the first-token logits of the paged engine
    with the kernels against the plain engine's. The MoE layer's input
    comes from the dense layer and the MLA prefill, which are plain torch
    in both engines, so both route every token alike and the logits differ
    only by the bf16 roundings of the expert outputs: held to 2e-2 of the
    largest plain logit (a few of its rounding steps), which an expert's
    output dropped or taken from another expert's weights exceeds."""
    cfg = get_reduced_config("deepseek-v2-lite-16b", use_kernels=True,
                             param_dtype="bfloat16",
                             compute_dtype="bfloat16")
    model = build_model(cfg, device=cuda, seed=0)
    plain = build_model(dataclasses.replace(cfg, use_kernels=False),
                        device=cuda, params=dict(model.state_dict()))
    rng = np.random.RandomState(1)
    ps = [list(rng.randint(8, cfg.vocab_size, size=rng.randint(3, 30)))
          for _ in range(12)]

    def first(m):
        eng = InferenceEngine(m, device=cuda, paged=True, page_size=8,
                              slots=4, cache_len=64, prefill_buckets=(16, 32))
        reqs = [eng.submit(Request(prompt=p, max_new_tokens=1,
                                   keep_logits=True)) for p in ps]
        eng.run_to_completion()
        return torch.stack([r.first_logits[:cfg.vocab_size] for r in reqs])

    ops.reset_launches()
    lk = first(model)
    assert ops.LAUNCHES["grouped_gemm_segments"] > 0
    lp = first(plain)
    assert torch.isfinite(lk).all()
    assert float((lk - lp).abs().max()) <= 2e-2 * float(lp.abs().max())


@pytest.mark.cuda
def test_cuda_deepseek_decode_step_makes_no_host_sync(cuda):
    """A paged decode step of the reduced deepseek-v2-lite with the kernels
    (the MLA decode; routing, sorted dispatch, the grouped GEMMs and the
    combine of every MoE layer) keeps every size on the device: the
    engine's one sync per megastep stays the only one."""
    cfg = get_reduced_config("deepseek-v2-lite-16b", use_kernels=True)
    model = build_model(cfg, device=cuda, seed=0)
    B, P, n = 4, 8, 4
    cache = model.init_cache(B * n + 1, P)
    table = torch.arange(B * n, dtype=torch.int32, device=cuda).reshape(B, n)
    lengths = torch.tensor([0, 5, 17, 31], dtype=torch.int32, device=cuda)
    tokens = torch.randint(8, cfg.vocab_size, (B, 1), device=cuda)
    active = torch.tensor([True, True, False, True], device=cuda)
    model.decode_paged(tokens, lengths, cache, table, active)  # builds
    torch.cuda.synchronize()
    ops.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits = model.decode_paged(tokens, lengths, cache, table, active)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(logits).all()
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers
    assert ops.LAUNCHES["paged_mla_decode"] == cfg.n_layers
    assert ops.LAUNCHES["grouped_gemm_segments"] == 3 * n_moe


def _ssd_inputs(seed, B, S, H, N, P, cuda):
    C = _rand(seed, (B, S, H, N), cuda, "float32")
    Bm = _rand(seed + 1, (B, S, H, N), cuda, "float32")
    v = _rand(seed + 2, (B, S, H, P), cuda, "float32")
    la = -torch.nn.functional.softplus(_rand(seed + 3, (B, S, H), cuda,
                                             "float32"))
    return C, Bm, v, la


def _ssd_plain(C, Bm, v, la):
    B, S, H, N = C.shape
    P = v.shape[-1]

    def bhs(t):
        return t.transpose(1, 2).reshape(B * H, S, t.shape[-1])
    y, st = ref.ssd_scan_ref(bhs(C), bhs(Bm), bhs(v), bhs(la[..., None]))
    return y.reshape(B, H, S, P).transpose(1, 2), st.reshape(B, H, N, P)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,N,P", [
    (1, 128, 2, 16, 32), (2, 256, 1, 64, 64), (1, 64, 4, 8, 16),
    (2, 100, 3, 16, 16), (16, 512, 112, 64, 64)])
def test_cuda_ssd_scan_matches_plain(cuda, B, S, H, N, P):
    """The reference's sweep shapes (tests/test_kernels.py), a ragged S and
    Zamba2's prefill wave (16 x 512, 112 heads, N = P = 64), within the
    reference's 2e-3 on outputs of size ~10-100."""
    C, Bm, v, la = _ssd_inputs(0, B, S, H, N, P, cuda)
    before = ops.LAUNCHES["ssm_scan"]
    y, st = ops.ssm_scan(C, Bm, v, la)
    assert ops.LAUNCHES["ssm_scan"] == before + 1
    ye, se = _ssd_plain(C, Bm, v, la)
    assert y.dtype == st.dtype == torch.float32
    assert float((y - ye).abs().max()) < 2e-3
    assert float((st - se).abs().max()) < 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,G,N,P", [
    (2, 100, 8, 2, 32, 16), (1, 64, 4, 1, 8, 64), (2, 70, 6, 3, 64, 32),
    (16, 512, 112, 2, 64, 64)])
def test_cuda_ssd_scan_group_bc_matches_plain(cuda, B, S, H, G, N, P):
    """B and C once per group (B, S, G, N) against the plain version on
    the repeated per-head copies, at the reference's 2e-3, and against the
    kernel's per-head call on those copies (Zamba2's wave: 112 heads over
    2 groups)."""
    C = _rand(0, (B, S, G, N), cuda, "float32")
    Bm = _rand(1, (B, S, G, N), cuda, "float32")
    v = _rand(2, (B, S, H, P), cuda, "float32")
    la = -torch.nn.functional.softplus(_rand(3, (B, S, H), cuda, "float32"))
    before = ops.LAUNCHES["ssm_scan"]
    y, st = ops.ssm_scan(C, Bm, v, la)
    assert ops.LAUNCHES["ssm_scan"] == before + 1
    Ch, Bh = (t.repeat_interleave(H // G, dim=2) for t in (C, Bm))
    ye, se = _ssd_plain(Ch, Bh, v, la)
    assert float((y - ye).abs().max()) < 2e-3
    assert float((st - se).abs().max()) < 2e-3
    yh, sth = ops.ssm_scan(Ch, Bh, v, la)
    assert float((y - yh).abs().max()) < 2e-3
    assert float((st - sth).abs().max()) < 2e-3


@pytest.mark.cuda
def test_cuda_ssd_scan_group_bc_padded_row_bitwise(cuda):
    """A row padded as Mamba2 pads (log_a = 0, v = 0) ends in its unpadded
    state bit for bit with B and C per group too."""
    B, S, H, G, N, P, n = 2, 100, 4, 2, 16, 32, 45
    C = _rand(4, (B, S, G, N), cuda, "float32")
    Bm = _rand(5, (B, S, G, N), cuda, "float32")
    v = _rand(6, (B, S, H, P), cuda, "float32")
    la = -torch.nn.functional.softplus(_rand(7, (B, S, H), cuda, "float32"))
    v[0, n:], la[0, n:] = 0.0, 0.0
    y, st = ops.ssm_scan(C, Bm, v, la)
    y0, st0 = ops.ssm_scan(*(t[:1, :n].contiguous() for t in (C, Bm, v, la)))
    assert torch.equal(st[0], st0[0])
    assert torch.equal(y[0, :n], y0[0])


@pytest.mark.cuda
def test_cuda_ssd_scan_padded_row_and_strided_inputs(cuda):
    """A row padded from 37 to 100 steps as Mamba2 pads (log_a = 0, v = 0)
    ends in its unpadded state bit for bit (the padded steps add exact
    zeros in the same tile order); inputs read through non-contiguous
    strides give the contiguous copies' result."""
    B, S, H, N, P, n = 2, 100, 3, 16, 32, 37
    C, Bm, v, la = _ssd_inputs(4, B, S, H, N, P, cuda)
    v[0, n:], la[0, n:] = 0.0, 0.0
    y, st = ops.ssm_scan(C, Bm, v, la)
    y0, st0 = ops.ssm_scan(*(t[:1, :n].contiguous() for t in (C, Bm, v, la)))
    assert torch.equal(st[0], st0[0])
    assert torch.equal(y[0, :n], y0[0])
    wide = torch.zeros((B, S, H, 2 * N), device=cuda)
    wide[..., N:] = C
    ys, sts = ops.ssm_scan(wide[..., N:], Bm, v.transpose(0, 1).contiguous()
                           .transpose(0, 1), la)
    assert torch.equal(ys, y) and torch.equal(sts, st)


@pytest.mark.cuda
def test_cuda_hybrid_engine_kernels_match_plain(cuda):
    """Reduced zamba2 in f32 on the slot cache: greedy output with the
    kernels (the SSD scan in every Mamba2 layer's prefill, the shared
    block's prefill and decode attention) equals the plain path's, and a
    paged request keeps the slot cache."""
    cfg = get_reduced_config("zamba2-7b", use_kernels=True)
    model = build_model(cfg, device=cuda, seed=0)
    plain = build_model(dataclasses.replace(cfg, use_kernels=False),
                        device=cuda, params=dict(model.state_dict()))
    rng = np.random.RandomState(0)
    ps = [list(rng.randint(8, cfg.vocab_size, size=rng.randint(3, 30)))
          for _ in range(9)]
    kw = dict(device=cuda, slots=4, cache_len=64, prefill_buckets=(16, 32),
              megastep=4)
    ops.reset_launches()
    eng = InferenceEngine(model, paged=True, **kw)
    assert eng.paged_fallback.startswith("model has no paged decode")
    with_kernels = eng.generate(ps, 8)
    waves = eng.stats.prefill_batches
    assert ops.LAUNCHES["ssm_scan"] == cfg.n_layers * waves
    assert ops.LAUNCHES["flash_attention"] == 2 * waves
    assert ops.LAUNCHES["flash_decode"] == 2 * eng.stats.decode_steps
    assert with_kernels == InferenceEngine(plain, **kw).generate(ps, 8)


@pytest.mark.cuda
def test_cuda_kernel_build_runs_once_across_threads(cuda, tmp_path,
                                                    monkeypatch):
    """Threads that load kernels at the same moment on an empty build
    directory run nvcc once per source between them, and every thread gets
    a library that answers."""
    import subprocess
    import threading

    from repro_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LIBS", {})
    popen, runs = subprocess.Popen, []

    def counted(cmd, **kw):
        runs.append(cmd[cmd.index("-o") + 1])
        return popen(cmd, **kw)

    monkeypatch.setattr(build.subprocess, "Popen", counted)
    names = list(build.SOURCES) * 2
    start = threading.Barrier(len(names))
    got, errors = {}, []

    def worker(i, name):
        try:
            start.wait()
            got[i] = (name, build.library(name))
        except BaseException as e:          # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i, n))
               for i, n in enumerate(names)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    assert not errors, errors
    assert len(runs) == len(build.SOURCES) == len(set(runs))
    for name, lib in got.values():
        assert lib is build.library(name)
        assert lib.repro_cuda_error_string(0)
    assert not list(tmp_path.glob("*.tmp*"))


@pytest.mark.cuda
@pytest.mark.parametrize("streamed", [False, True])
def test_cuda_runtime_round_trip(cuda, tmp_path, streamed):
    """Reduced smollm2 with the kernels through the PCM runtime on the
    card: DEVICE -> HOST_RAM -> LOCAL_DISK -> DEVICE with no builder call
    and no build, greedy tokens equal to the never-demoted engine's; then
    a worker preempted and a replacement that restores the context from
    the node pool with the same tokens."""
    from repro_torch.core import (ContextMode, Library, PCMManager,
                                  SnapshotPool, Tier, load_context,
                                  make_recipe)

    cfg = get_reduced_config("smollm2-1.7b", use_kernels=True)
    state = dict(build_model(cfg, device=cuda, seed=0).state_dict())
    rng = np.random.RandomState(0)
    ps = [list(rng.randint(8, cfg.vocab_size, size=rng.randint(3, 30)))
          for _ in range(6)]
    kw = dict(device=cuda, slots=4, cache_len=64, prefill_buckets=(16, 32),
              megastep=4)
    want = InferenceEngine(build_model(cfg, device=cuda, params=state),
                           **kw).generate(ps, 8)
    builds = []

    def build():
        builds.append(1)
        return {"engine": InferenceEngine(
            build_model(cfg, device=cuda, params=state), **kw)}

    rec = make_recipe("cuda-rt", build, host_bytes=0)
    pool = SnapshotPool(spill_dir=str(tmp_path))
    lib = Library("w0", snapshots=pool, streamed=streamed)
    eng = lib.ensure(rec).value["engine"]
    before = torch.cuda.memory_allocated()
    lib.demote(rec.key())
    assert torch.cuda.memory_allocated() < before
    assert pool.spill(rec.key())
    ctx = lib.ensure(rec)
    assert ctx.value["engine"] is eng and ctx.restore_seconds > 0
    assert eng.model.device.type == "cuda"
    ops.reset_launches()
    assert eng.generate(ps, 8) == want
    assert ops.LAUNCHES["flash_attention"] > 0
    assert ops.LAUNCHES["flash_decode"] > 0
    assert builds == [1] and eng.stats.compiles == 0

    mgr = PCMManager(mode=ContextMode.FULL, n_workers=1, streamed=streamed,
                     spill_dir=str(tmp_path / "pool"))
    try:
        mgr.warm_up(rec)
        mgr.preempt_worker(next(iter(mgr.workers)))
        deadline = time.monotonic() + 60
        while mgr.snapshots.tier(rec.key()) != Tier.HOST_RAM:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        mgr.add_worker()
        got = mgr.submit(lambda: load_context("engine").generate(ps, 8),
                         recipe=rec).result(timeout=120)
        assert got == want and len(builds) == 2
        assert mgr.stats()["context_restores"] == 1
    finally:
        mgr.shutdown()


@pytest.mark.cuda
def test_cuda_two_node_wire_round_trip(cuda):
    """Two node processes on the card: A builds the reduced smollm2-1.7b
    context with the kernels; B joins with ``--aot-cache`` at the build
    directory, bootstraps the context from A by PEER over the socket, and
    decodes bit-identically to A with zero nvcc runs (each kernel library
    a cache hit)."""
    import os
    import signal

    import torch_multihost_helpers as H
    from repro_torch.cluster import node
    from repro_torch.core import ContextMode, FetchSource, PCMManager
    from repro_torch.kernels import build

    build.build_all()
    cfg = dataclasses.replace(get_reduced_config("smollm2-1.7b"),
                              use_kernels=True)
    rec = H.engine_recipe(None, 4, name="cuda-wire", device="cuda", cfg=cfg)
    prompts = [[5, 9, 14, 200, 7], [11, 3, 60, 61, 62, 63, 64]]
    here = os.path.dirname(os.path.abspath(__file__))
    mgr = PCMManager(mode=ContextMode.FULL, n_workers=0,
                     chunk_bytes=64 << 10)
    procs = {}

    def spawn(wid):
        procs[wid] = node.spawn_node_process(
            addr, wid, extra_path=(here,), device="cuda",
            aot_cache=str(build.BUILD_DIR), heartbeat=0.2)
        mgr.wait_for_workers([wid], timeout=120)

    try:
        addr = mgr.listen(heartbeat=0.2)
        spawn("A")
        want, _, _ = mgr.submit(H.generate_task, args=(prompts,),
                                recipe=rec).result(timeout=300)
        spawn("B")
        futs = [mgr.submit(H.generate_task, args=(prompts, 6, 0.3),
                           recipe=rec) for _ in range(6)]
        res = [f.result(timeout=300) for f in futs]
        assert all(r[0] == want for r in res)
        on_b = [r[2] for r in res if r[1] == procs["B"].pid]
        assert on_b and all(s["compiles"] == 0 and s["aot_cache_hits"] == 2
                            for s in on_b)
        assert [(d.worker_id, d.source) for d in mgr.fetch_history(rec)] \
            == [("B", FetchSource.PEER)]
        assert mgr.workers["B"].library.builder_calls == 0
    finally:
        mgr.shutdown(timeout=30)
        for p in procs.values():
            if p.poll() is None:
                os.kill(p.pid, signal.SIGKILL)
            p.wait(timeout=30)


@pytest.mark.cuda
def test_cuda_frontdoor_session_streams_engine_tokens(cuda):
    """A front-door session on a warm card context (reduced smollm2-1.7b
    with the kernels, the paged pool with prefix sharing): each turn,
    served alone, streams the tokens a bare engine gives its prompt alone
    (so both form the same waves), later turns hit the template's prefix
    pages, and the engine's prefill and paged decode kernels launch."""
    from repro_torch.core import (ContextMode, PCMClient, PCMManager,
                                  make_recipe)

    cfg = get_reduced_config("smollm2-1.7b", use_kernels=True)
    state = dict(build_model(cfg, device=cuda, seed=0).state_dict())
    rng = np.random.RandomState(1)
    head = list(rng.randint(8, cfg.vocab_size, size=20))
    ps = [head + list(rng.randint(8, cfg.vocab_size, size=3 + i))
          for i in range(4)]
    kw = dict(device=cuda, slots=4, cache_len=64, prefill_buckets=(16, 32),
              megastep=4, paged=True, page_size=8)
    bare = InferenceEngine(build_model(cfg, device=cuda, params=state), **kw)
    assert bare.prefix_fallback is None, bare.prefix_fallback
    want = [bare.generate([p], 8)[0] for p in ps]
    builds = []

    def build():
        builds.append(1)
        return {"engine": InferenceEngine(
            build_model(cfg, device=cuda, params=state), **kw)}

    mgr = PCMManager(mode=ContextMode.FULL, n_workers=1)
    try:
        client = PCMClient(backend=mgr)
        ctx = client.context(make_recipe("cuda-fd", build, host_bytes=0))
        ctx.warm_up()
        ops.reset_launches()
        with client.session(ctx, tenant="t", prefix_key="head") as sess:
            got = [sess.submit(p, max_new_tokens=8).result(timeout=120)
                   for p in ps]
        assert got == want
        assert ops.LAUNCHES["flash_attention"] > 0
        assert ops.LAUNCHES["paged_flash_decode"] > 0
        assert builds == [1]
        assert client.frontdoor().stats()["prefix"]["hits"] >= 1
    finally:
        mgr.shutdown()
