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

from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.kernels import dense_gemm, ops, ref  # noqa: E402
from repro_torch.models import build_model, extra_inputs  # noqa: E402
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
    (2, 70, 4, 2, 32, False, 0), (1, 20, 2, 2, 112, True, 8),
    # H2O-Danube's head dim 80 (its window), StableLM's 160, groups 1, 4
    # and Nemotron's 6
    (3, 200, 4, 4, 80, True, 0), (3, 200, 8, 2, 80, True, 48),
    (3, 200, 12, 2, 80, True, 0), (3, 200, 4, 4, 160, True, 48),
    (3, 200, 8, 2, 160, True, 0), (3, 200, 12, 2, 160, True, 48),
    (2, 130, 12, 2, 128, True, 0)])
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
                                           (3, 8, 8, 112, 300),
                                           (3, 8, 2, 80, 300),
                                           (3, 12, 2, 80, 4096),
                                           (2, 8, 2, 160, 256),
                                           (3, 12, 2, 160, 300),
                                           (2, 12, 2, 128, 512)])
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
@pytest.mark.parametrize("B,H,Hkv,D,Skv", [(3, 8, 2, 64, 600),
                                           (2, 12, 2, 80, 300),
                                           (2, 8, 8, 112, 260)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_decode_lse_and_key_ranges(cuda, B, H, Hkv, D, Skv,
                                              dtype):
    """``return_lse``: the output's bits are the same as without it, the
    log-sum-exp matches the plain version's (-inf at the same slots: a
    length-0 slot and an inactive one), and the cache cut into 3 key
    ranges, one kernel call each over its own valid keys (some empty),
    merged by ``combine_partials`` matches one whole-cache call."""
    from repro_torch.models.attention import combine_partials
    q = _rand(0, (B, H, D), cuda, dtype)
    k = _rand(1, (B, Skv, Hkv, D), cuda, dtype)
    v = _rand(2, (B, Skv, Hkv, D), cuda, dtype)
    lengths = torch.tensor([0, Skv, 7][:B], dtype=torch.int32, device=cuda)
    active = torch.tensor([True, True, False][:B], device=cuda)
    kw = dict(scale=D ** -0.5, active=active)
    whole = ops.flash_decode(q, k, v, lengths, **kw)
    out, lse = ops.flash_decode(q, k, v, lengths, return_lse=True, **kw)
    _, want = ref.flash_decode_ref(q, k, v, lengths, return_lse=True, **kw)
    assert torch.equal(out, whole)
    assert torch.equal(torch.isneginf(lse), torch.isneginf(want))
    live = torch.isfinite(want)
    assert float((lse[live] - want[live]).abs().max()) < 2e-4
    cuts = [0, Skv // 3, 2 * Skv // 3, Skv]
    outs, lses = [], []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        n = torch.clamp(lengths - lo, 0, hi - lo).to(torch.int32)
        o, l = ops.flash_decode(q, k[:, lo:hi].contiguous(),
                                v[:, lo:hi].contiguous(), n,
                                return_lse=True, **kw)
        outs.append(o)
        lses.append(l)
    got = combine_partials(torch.stack(outs), torch.stack(lses),
                           lambda t: t.amax(0), lambda t: t.sum(0))
    assert bool(torch.isfinite(got).all())
    assert float((got - whole.float()).abs().max()) < TOL[dtype]


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
@pytest.mark.parametrize("H,Hkv,D", [(4, 4, 64), (8, 2, 128), (8, 2, 80),
                                     (12, 2, 80), (8, 2, 160), (12, 2, 160)])
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
@pytest.mark.parametrize("D", [64, 80, 112, 160])
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
                                     (8, 2, 128), (8, 2, 80), (12, 2, 80),
                                     (8, 2, 160), (12, 2, 160)])
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
        # flash_attention, flash_decode and dense_gemm (the prefill
        # linear)
        assert on_b and all(s["compiles"] == 0 and s["aot_cache_hits"] == 3
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


# ------------------------------------------------------------- training ----
def _grad_calls(dev):
    """Each ops entry point with small inputs on ``dev``, one of them
    requiring a gradient: the refusal comes before any launch, so the
    shapes need only be plausible."""
    def t(*shape, dtype=torch.bfloat16, grad=False):
        return torch.zeros(shape, dtype=dtype, device=dev,
                           requires_grad=grad)
    i32 = dict(dtype=torch.int32)
    lengths = torch.full((1,), 8, dtype=torch.int32, device=dev)
    table = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    return {
        "flash_attention": lambda: ops.flash_attention(
            t(1, 16, 2, 64, grad=True), t(1, 16, 2, 64), t(1, 16, 2, 64)),
        "flash_decode": lambda: ops.flash_decode(
            t(1, 2, 64), t(1, 32, 2, 64, grad=True), t(1, 32, 2, 64),
            lengths),
        "paged_flash_decode": lambda: ops.paged_flash_decode(
            t(1, 2, 64), t(3, 16, 2, 64), t(3, 16, 2, 64, grad=True), table,
            lengths),
        "paged_mla_decode": lambda: ops.paged_mla_decode(
            t(1, 16, 512, grad=True), t(1, 16, 64), t(3, 64, 512),
            t(3, 64, 64), table, lengths),
        "grouped_gemm": lambda: ops.grouped_gemm(
            t(2, 8, 64), t(2, 64, 32, grad=True)),
        "grouped_gemm_segments": lambda: ops.grouped_gemm_segments(
            t(8, 64, grad=True), t(2, **i32), t(2, 64, 32)),
        "prefill_linear": lambda: ops.prefill_linear(
            t(8, 64), t(64, 32, grad=True)),
        "ssm_scan": lambda: ops.ssm_scan(
            t(1, 16, 2, 16, dtype=torch.float32),
            t(1, 16, 2, 16, dtype=torch.float32),
            t(1, 16, 2, 16, dtype=torch.float32, grad=True),
            t(1, 16, 2, dtype=torch.float32)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flash_attention", "flash_decode",
                                  "paged_flash_decode", "paged_mla_decode",
                                  "grouped_gemm", "grouped_gemm_segments",
                                  "prefill_linear", "ssm_scan"])
def test_cuda_kernels_refuse_inputs_that_require_grad(cuda, name):
    """The kernels are forward-only: a call that autograd would carry
    through raises, names the kernel and launches nothing."""
    before = dict(ops.LAUNCHES)
    with pytest.raises(RuntimeError, match=f"{name}: .*forward-only"):
        _grad_calls(cuda)[name]()
    assert ops.LAUNCHES == before


@pytest.mark.cuda
def test_cuda_train_steps_match_the_cpu(cuda):
    """Two f32 train steps of the reduced smollm2 from the same seeded
    weights and batches on the card and on the CPU: losses within 1e-5,
    parameters within 1e-5 but 2 in 1 000 elements, those within 2 x
    steps x lr (tests/test_torch_train.py gives the reason)."""
    from repro_torch.data import PipelineConfig, batches
    from repro_torch.train import (OptimizerConfig, init_state,
                                   make_train_step, trainable)
    from repro_torch.train.trainstep import to_device
    from repro_torch.weights import init_params
    cfg = get_reduced_config("smollm2-1.7b")
    init = init_params(cfg, torch.Generator().manual_seed(0),
                       torch.device("cpu"))
    ocfg = OptimizerConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    data = batches(PipelineConfig(batch_size=8, seq_len=32,
                                  vocab_size=cfg.vocab_size), 0)
    bs = [next(data) for _ in range(2)]
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        model = build_model(cfg, device=dev, params={
            k: v.clone() for k, v in init.items()})
        named = trainable(model)
        st = init_state(named)
        step = make_train_step(model, ocfg, accum_steps=2, ce_chunk=16)
        losses = []
        for b in bs:
            named, st, m = step(named, st, to_device(b, dev))
            losses.append(float(m["loss"]))
        runs[dev.type] = (losses, named)
    assert max(abs(a - b) for a, b in zip(runs["cuda"][0],
                                          runs["cpu"][0])) < 1e-5
    d = torch.cat([(runs["cuda"][1][k].detach().cpu()
                    - runs["cpu"][1][k].detach()).abs().flatten()
                   for k in sorted(runs["cpu"][1])])
    assert int((d >= 1e-5).sum()) <= 2e-3 * d.numel()
    assert float(d.max()) < 2 * 2 * ocfg.peak_lr


@pytest.mark.cuda
def test_cuda_training_refuses_the_kernels(cuda):
    from repro_torch.train import OptimizerConfig, make_train_step
    model = build_model(get_reduced_config("smollm2-1.7b", use_kernels=True),
                        device=cuda)
    with pytest.raises(ValueError, match="plain path"):
        make_train_step(model, OptimizerConfig())


@pytest.mark.cuda
@pytest.mark.parametrize("arch,head_dim", [("h2o-danube-1.8b", 80),
                                           ("stablelm-12b", 160),
                                           ("nemotron-4-15b", 16)])
def test_cuda_dense_engines_kernels_match_plain(cuda, arch, head_dim):
    """Reduced danube (window 32, its ring buffers wrapping), stablelm and
    nemotron (12 heads over 2: group 6) in f32 at the head dims of their
    kernels: greedy output with the kernels equals the plain path's."""
    over = dict(use_kernels=True, head_dim=head_dim)
    if arch == "nemotron-4-15b":
        over.update(n_heads=12, n_kv_heads=2)
    cfg = get_reduced_config(arch, **over)
    model = build_model(cfg, device=cuda, seed=0)
    plain = build_model(dataclasses.replace(cfg, use_kernels=False),
                        device=cuda, params=dict(model.state_dict()))
    rng = np.random.RandomState(0)
    ps = [list(rng.randint(8, cfg.vocab_size, size=rng.randint(3, 30)))
          for _ in range(9)]
    kw = dict(device=cuda, slots=4, cache_len=96, prefill_buckets=(16, 32),
              megastep=4)
    with_kernels = InferenceEngine(model, **kw).generate(ps, 40)
    assert with_kernels == InferenceEngine(plain, **kw).generate(ps, 40)


def _memory_tol(exp, dtype):
    """Attention over a memory of T keys: the output's scale falls as
    1/sqrt(T), so bf16 is held to 2e-2 of the largest plain output (a few
    bf16 steps of it; chip_smoke.py's CROSS_REL_TOL), not TOL's 3e-2."""
    if dtype == "bfloat16":
        return 2e-2 * float(exp.float().abs().max())
    return TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,Hkv,D", [
    # Whisper's encoder (S == T, no kv_len) and its cross prefill over the
    # frames, the VLM's over the patches (group 4), and T not a multiple of
    # the 64-key tile; a memory shorter than one tile
    (2, 150, 150, 12, 12, 64), (2, 70, 150, 12, 12, 64),
    (2, 130, 410, 8, 2, 128), (2, 40, 30, 4, 1, 64),
    (2, 33, 200, 4, 4, 16)])
@pytest.mark.parametrize("kv_len", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_not_causal_over_a_memory(cuda, B, S, T, H, Hkv,
                                                       D, kv_len, dtype):
    """The prefill kernel not causal, S queries over T keys (the encoder's
    and the cross-attention prefill's calls), with kv_len = T per row or a
    ragged one, against the plain version."""
    q = _rand(10, (B, S, H, D), cuda, dtype)
    k = _rand(11, (B, T, Hkv, D), cuda, dtype)
    v = _rand(12, (B, T, Hkv, D), cuda, dtype)
    kl = (torch.tensor([T] + [max(1, T // (i + 2)) for i in range(B - 1)],
                       dtype=torch.int32, device=cuda) if kv_len else None)
    kw = dict(causal=False, scale=D ** -0.5, kv_len=kl)
    out = ops.flash_attention(q, k, v, **kw)
    exp = ref.flash_attention_ref(q, k, v, **kw)
    assert float((out.float() - exp.float()).abs().max()) \
        < _memory_tol(exp, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,D,Skv", [(12, 12, 64, 150), (8, 2, 128, 410),
                                         (32, 8, 128, 4100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_decode_over_a_whole_memory(cuda, H, Hkv, D, Skv, dtype):
    """The decode kernel over a cross-attention memory: n_valid = Skv for
    every row, an inactive row zeros; the same kernel with the last 4 keys
    unread must fail the bound."""
    q = _rand(13, (3, H, D), cuda, dtype)
    ck = _rand(14, (3, Skv, Hkv, D), cuda, dtype)
    cv = _rand(15, (3, Skv, Hkv, D), cuda, dtype)
    n = torch.full((3,), Skv, dtype=torch.int32, device=cuda)
    act = torch.tensor([True, False, True], device=cuda)
    out = ops.flash_decode(q, ck, cv, n, scale=D ** -0.5, active=act)
    exp = ref.flash_decode_ref(q, ck, cv, n, scale=D ** -0.5, active=act)
    tol = _memory_tol(exp, dtype)
    assert float((out.float() - exp.float()).abs().max()) < tol
    assert not out[1].any()
    short = ops.flash_decode(q, ck, cv, n - 4, scale=D ** -0.5, active=act)
    assert float((short.float() - exp.float()).abs().max()) > tol


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm-350m", "whisper-small",
                                  "llama-3.2-vision-11b"])
def test_cuda_family_engines_kernels_match_plain(cuda, arch):
    """Reduced xLSTM, Whisper and the VLM (gates at 1.0, 8 heads over 2)
    in f32 with their frontend inputs: greedy output through the kernels
    equals the plain path's, at megastep 1 and 4."""
    over = dict(use_kernels=True)
    if arch == "llama-3.2-vision-11b":
        over.update(n_heads=8, n_kv_heads=2)
    cfg = get_reduced_config(arch, **over)
    model = build_model(cfg, device=cuda, seed=0)
    for blk in getattr(model, "cross", ()):
        if hasattr(blk, "gate_attn"):
            blk.gate_attn.fill_(1.0)
            blk.gate_mlp.fill_(1.0)
    plain = build_model(dataclasses.replace(cfg, use_kernels=False),
                        device=cuda, params=dict(model.state_dict()))
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    extra = {n: torch.randn(t.shape, generator=gen, device=cuda)
             for n, t in extra_inputs(cfg, 4).items()} or None
    rng = np.random.RandomState(0)
    ps = [list(rng.randint(8, cfg.vocab_size, size=rng.randint(3, 30)))
          for _ in range(9)]
    kw = dict(device=cuda, slots=4, cache_len=96, prefill_buckets=(32,),
              extra=extra)
    want = InferenceEngine(plain, megastep=4, **kw).generate(ps, 40)
    for K in (1, 4):
        assert InferenceEngine(model, megastep=K, **kw).generate(ps, 40) \
            == want


# the kernels each family launches after a mid-stream restore: the decode
# steps of the requests that were decoding, and the prefill wave of those
# that were queued
FAMILY_PCM = {
    "deepseek-v2-lite-16b": (dict(paged=True, page_size=8),
                             ("paged_mla_decode", "grouped_gemm_segments")),
    "zamba2-7b": ({}, ("ssm_scan", "flash_attention", "flash_decode")),
    "llama-3.2-vision-11b": ({}, ("flash_attention", "flash_decode"))}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(FAMILY_PCM))
def test_cuda_family_demote_midstream_continues_bit_for_bit(cuda, arch):
    """Reduced DeepSeek on the paged pool, Zamba2 and the VLM (gates at
    1.0, 8 heads over 2) in f32 with the kernels, demoted in the middle of
    a stream (requests decoding and queued) and restored on the card: the
    device memory of the weights and the cache is freed, every cache leaf
    (a paged pool's live pages), per-slot state and ``extra`` tensor comes
    back bit for bit, the rest decodes as the engine did with no demote,
    and the family's kernels launch after the restore."""
    from repro_torch.serving import paged as paging

    kw, kernels = FAMILY_PCM[arch]
    over = dict(use_kernels=True)
    if arch == "llama-3.2-vision-11b":
        over.update(n_heads=8, n_kv_heads=2)
    cfg = get_reduced_config(arch, **over)
    model = build_model(cfg, device=cuda, seed=0)
    for blk in getattr(model, "cross", ()):
        blk.gate_attn.fill_(1.0)
        blk.gate_mlp.fill_(1.0)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    extra = {n: torch.randn(t.shape, generator=gen, device=cuda)
             for n, t in extra_inputs(cfg, 4).items()} or None
    rng = np.random.RandomState(0)
    ps = [list(rng.randint(8, cfg.vocab_size, size=rng.randint(3, 30)))
          for _ in range(9)]
    eng = InferenceEngine(model, device=cuda, slots=4, cache_len=64,
                          prefill_buckets=(16, 32), megastep=4, extra=extra,
                          **kw)
    want = eng.generate(ps, 12)
    reqs = [eng.submit(Request(prompt=p, max_new_tokens=12)) for p in ps]
    eng.step()
    assert eng.active and eng.queue
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    capacity = eng.snapshot()["capacity_bytes"]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    host = eng.offload_device_state()
    assert before - torch.cuda.memory_allocated() >= weights + capacity
    eng.restore_device_state(host)
    cache = eng.cache
    if eng._paged:
        cache = paging.gather_live(eng.cache, torch.as_tensor(
            host["_paged_live_ids"], device=cuda))
    pairs = [(cache[n], t) for n, t in host["cache"].items()]
    pairs += [(getattr(eng, n), host[n]) for n in eng._state_fields]
    pairs += [(eng.extra[n], t) for n, t in host.get("extra", {}).items()]
    for dev, h in pairs:
        assert dev.dtype == h.dtype and torch.equal(dev, h.to(cuda))
    ops.reset_launches()
    eng.run_to_completion()
    assert [r.generated for r in reqs] == want
    assert all(ops.LAUNCHES[k] > 0 for k in kernels), ops.LAUNCHES


@pytest.mark.cuda
def test_cuda_xlstm_matches_cpu(cuda):
    """The reduced xLSTM in f32 on the card against the CPU on the same
    weights: a padded wave over two mLSTM chunks prefilled, then 4 decode
    steps, every call's logits within TOL."""
    cfg = get_reduced_config("xlstm-350m")
    cpu = build_model(cfg, device="cpu", seed=0)
    card = build_model(cfg, device=cuda, params=dict(cpu.state_dict()))
    S = 2 * cfg.ssm.chunk
    toks = torch.as_tensor(np.random.RandomState(7).randint(
        8, cfg.vocab_size, size=(3, S)), dtype=torch.int32)
    lens = torch.tensor([S, 20, 3], dtype=torch.int32)
    caches = [m.init_cache(3, S + 8, torch.float32) for m in (cpu, card)]
    want = cpu.prefill(toks, lens, caches[0])
    got = card.prefill(toks.to(cuda), lens.to(cuda), caches[1])
    assert float((got.cpu() - want).abs().max()) < TOL["float32"]
    for _ in range(4):
        nxt = want[:, :cfg.vocab_size].argmax(-1).to(torch.int32)[:, None]
        lens = lens + 1
        want = cpu.decode_step(nxt, lens, caches[0])
        got = card.decode_step(nxt.to(cuda), lens.to(cuda), caches[1])
        assert float((got.cpu() - want).abs().max()) < TOL["float32"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_expert_parallel_ffn_kernel_matches_plain(cuda, dtype):
    """One expert shard's capacity pass (the expert-parallel MoE's
    ``_local_expert_pass``) with its three GEMMs on ``grouped_gemm``'s
    (E_loc, C, d) form against the same pass on batched matmuls: 4 of 8
    experts (the second shard), a capacity low enough to drop
    assignments, the drops the same."""
    from types import SimpleNamespace
    from repro_torch.models import moe as moe_lib
    cfg = get_reduced_config("deepseek-v2-lite-16b", param_dtype=dtype,
                             compute_dtype=dtype)
    T, d, f, E, k = 256, cfg.d_model, cfg.moe.d_ff, 8, 2
    x = _rand(0, (T, d), cuda, dtype)
    probs = torch.softmax(_rand(1, (T, E), cuda, "float32"), dim=-1)
    w, ids = torch.topk(probs, k, dim=-1)
    experts = SimpleNamespace(**{n: _rand(2 + i, shape, cuda, dtype)
                                 * shape[1] ** -0.5 for i, (n, shape) in
                                 enumerate((("up", (4, d, f)),
                                            ("gate", (4, d, f)),
                                            ("down", (4, f, d))))})
    cap = moe_lib._capacity(T // 2, cfg)          # below T * k / E
    before = ops.LAUNCHES["grouped_gemm"]
    with torch.no_grad():
        got = moe_lib._local_expert_pass(x, ids, w, experts, cfg, 4, 1, cap,
                                         use_kernels=True)
        assert ops.LAUNCHES["grouped_gemm"] == before + 3
        exp = moe_lib._local_expert_pass(x, ids, w, experts, cfg, 4, 1, cap,
                                         use_kernels=False)
    dropped = moe_lib.capacity_slots(ids, w, 4, 1, cap)[2]
    assert int(dropped.sum()) > 0
    assert float((got.float() - exp.float()).abs().max()) <= \
        _gemm_tol(dtype, f, exp)


@pytest.mark.cuda
def test_cuda_one_rank_mesh_prefill_matches_unsharded_kernels(cuda,
                                                              tmp_path):
    """The prefill cell of ``launch.steps`` on a one-rank NCCL mesh (1, 1)
    with the kernels against the unsharded kernel path on the same
    weights: the same local ops, so the same logits, and the prefill
    kernel launched inside the cell."""
    import torch.distributed as dist
    from repro_torch.configs.shapes import ShapeSuite
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    cfg = get_reduced_config("smollm2-1.7b", param_dtype="bfloat16",
                             compute_dtype="bfloat16", use_kernels=True)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1, 1)
        fn, args, _ = steps.build_cell(cfg, ShapeSuite("p", "prefill", 64, 4),
                                       mesh)
        params = steps.materialize(
            args, mesh, torch.Generator(cuda).manual_seed(0))[0]
        model = build_model(cfg, device=cuda, params={
            n: p.full_tensor() for n, p in params.items()})
        toks = torch.as_tensor(np.random.RandomState(3).randint(
            8, cfg.vocab_size, size=(4, 64)), dtype=torch.int32,
            device=cuda)
        lens = torch.tensor([64, 40, 9, 64], dtype=torch.int32, device=cuda)
        with torch.no_grad():
            want = model.prefill(toks, lens, model.init_cache(4, 64))
            ops.reset_launches()
            got, _ = fn(params, toks, lens, model.init_cache(4, 64))
            assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
        assert torch.equal(got.full_tensor(), want)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_live_elastic_sweep_shares_one_model(cuda):
    """The live example (``repro_torch.examples.opportunistic_serving``)
    on the card, reduced bf16 config with the kernels, its rq3 trace ten
    times faster than the wall clock: workers whose engines share the one
    model are preempted while the others serve, every task completes with
    the first tokens of a bare engine over the same model, and the kernels
    ran."""
    from repro_torch.data import fever
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.examples import opportunistic_serving as live
    cfg = get_reduced_config("smollm2-1.7b", param_dtype="bfloat16",
                             compute_dtype="bfloat16", use_kernels=True)
    model = live.build_verifier(cfg, device="cuda")
    n_tasks = 120
    bare = InferenceEngine(model, device="cuda", **live.ENGINE_KW)
    tok = HashTokenizer(cfg.vocab_size)
    want = []
    for idx in live.task_claims(n_tasks):
        cl = fever.claim_batch(idx)
        gen = bare.generate([tok.encode(fever.render_prompt(c)) for c in cl],
                            max_new_tokens=1)
        want.append([o[0] for o in gen])
    del bare
    assert len({t for ts in want for t in ts}) > 1, "vacuous: one token"
    ops.reset_launches()
    got = live.live_elastic("rq3", n_tasks, device="cuda", model=model,
                            time_scale=10)
    assert got["tokens"] == want
    assert got["preemptions"] >= 1 and got["failed"] == 0
    assert got["completed"] == n_tasks
    assert ops.LAUNCHES["flash_attention"] > 0


# ------------------------------------------------ the prefill linear ------
def _dense_linears(arch):
    """(K, N, w K-major) of every linear a prefill wave of the dense
    decoder ``arch`` runs at full size: q and o, k and v (narrower under
    GQA), up and gate, down, the unembedding (tok K-major when tied)."""
    cfg = get_config(arch)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {(d, cfg.n_heads * hd, False), (d, cfg.n_kv_heads * hd, False),
            (cfg.n_heads * hd, d, False), (d, cfg.d_ff, False),
            (cfg.d_ff, d, False),
            (d, cfg.padded_vocab, bool(cfg.tie_embeddings))}


# every prefill linear of the dense decoders: SmolLM2-1.7B's first, under
# their old names, then Granite's, StableLM's, Nemotron's and Danube's
LINEAR_SHAPES = {"qkvo": (2048, 2048, False), "up_gate": (2048, 8192, False),
                 "down": (8192, 2048, False), "unembed": (2048, 49152, True)}
LINEAR_SHAPES.update({
    f"{name} {K}->{N}{' K-major' if km else ''}": (K, N, km)
    for name, arch in (("granite", "granite-3-2b"),
                       ("stablelm", "stablelm-12b"),
                       ("nemotron", "nemotron-4-15b"),
                       ("danube", "h2o-danube-1.8b"))
    for K, N, km in sorted(_dense_linears(arch))
    if (K, N, km) not in LINEAR_SHAPES.values()})


def _crand(seed, shape, dev, dtype):
    """Standard normals drawn on the card from ``seed`` (a full-size
    unembedding is too large to draw on the host)."""
    gen = torch.Generator(dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev).to(TDT[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,w_kmajor", [
    (37, 64, 96, False), (37, 64, 96, True), (1, 2048, 2048, False),
    (200, 2048, 256, True), (300, 104, 40, False), (512, 8192, 2048, False),
    (16, 2048, 49152, True), (129, 2048, 8192, False)] + [
    (300, K, N, km) for K, N, km in list(LINEAR_SHAPES.values())[4:]])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_prefill_linear_matches_plain(cuda, M, K, N, w_kmajor, dtype):
    """The prefill linear against its plain version (``torch.matmul`` in
    the compute dtype), both weight layouts, ragged row and column counts
    and every prefill shape of the dense decoders, within the grouped
    GEMM's tolerance."""
    x = _crand(0, (M, K), cuda, dtype)
    w = _crand(1, (N, K) if w_kmajor else (K, N), cuda, dtype) * K ** -0.5
    before = ops.LAUNCHES["prefill_linear"]
    out = ops.prefill_linear(x, w, w_kmajor=w_kmajor)
    assert ops.LAUNCHES["prefill_linear"] == before + 1
    exp = ref.prefill_linear_ref(x, w, w_kmajor)
    assert out.shape == (M, N) and out.dtype == x.dtype
    err = float((out.float() - exp.float()).abs().max())
    assert err <= _gemm_tol(dtype, K, exp)
    x3 = _crand(2, (2, 3, 2 * K), cuda, dtype)[:, :, K:]  # not contiguous
    out3 = ops.prefill_linear(x3, w, w_kmajor=w_kmajor)
    assert torch.equal(out3, ops.prefill_linear(
        x3.reshape(6, K).contiguous(), w, w_kmajor=w_kmajor).reshape(
            2, 3, N))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", sorted(LINEAR_SHAPES))
def test_cuda_prefill_linear_row_bits_do_not_depend_on_row_count(
        cuda, shape, dtype):
    """One row's output bits, bitwise, whatever the call's row count (1,
    8, 16, 100, 127, 128, 129, 512, 2048, 8192, and the plan's switches:
    the most rows it sums across blocks and one more, the fewest rows
    whose blocks take 128 columns and one row tile fewer) and
    wherever the row sits in it (first, middle, last), at each prefill
    shape of the dense decoders: the property a shared-prefix prefill
    needs to give a cold prefill's bits (cuBLAS's down projection does not
    have it). The two forms of the split sum (across blocks, inside one)
    agree bit for bit, and so do blocks of 64 and 128 columns."""
    K, N, kmaj = LINEAR_SHAPES[shape]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    sw = dense_gemm.switch_rows(K, N, sms)
    two = dense_gemm.wide_block_rows(K, N, sms)
    counts = sorted({1, 8, 16, 100, 127, 128, 129, 512, 2048, 8192}
                    | ({sw, sw + 1} if sw else set())
                    | {M for M in (two - 128, two) if 0 < M <= 8192})
    w = _crand(1, (N, K) if kmaj else (K, N), cuda, dtype) * K ** -0.5
    gen = torch.Generator(cuda).manual_seed(3)
    x = torch.randn((max(counts), K), generator=gen,
                    device=cuda).to(TDT[dtype])
    probe = torch.randn((1, K), generator=gen, device=cuda).to(TDT[dtype])
    want = ops.prefill_linear(probe, w, w_kmajor=kmaj)[0]
    differ = []
    for M in counts:
        for at in sorted({0, M // 2, M - 1}):
            xm = x[:M].clone()
            xm[at] = probe[0]
            got = ops.prefill_linear(xm, w, w_kmajor=kmaj)[at]
            if not torch.equal(got, want):
                differ.append((M, at))
    assert not differ, f"{shape}: the row's bits differ at (M, row) {differ}"


@pytest.mark.cuda
def test_cuda_grouped_gemm_wide_and_narrow_tiles_one_row(cuda):
    """A reading, not a check: one row of an expert's segment through the
    grouped GEMM's wide tiles and through its narrow (swap-AB) tiles, at
    DeepSeek's gate/up and down shapes. Printed; the MoE keeps whichever
    ``gemm_shape`` picks (ROADMAP.md records the answer)."""
    from repro_torch.kernels.moe_gemm import grouped_gemm_segments_cuda
    counts = [1, 0, 3, 17, 0, 2] + [1] * 58
    cnt = torch.tensor(counts, dtype=torch.int32, device=cuda)
    readings = {}
    for d, f in ((2048, 1408), (1408, 2048)):
        x = _rand(0, (sum(counts), d), cuda, "bfloat16")
        w = _rand(1, (len(counts), d, f), cuda, "bfloat16") * d ** -0.5
        wide = grouped_gemm_segments_cuda(x, cnt, w, shape="wide")
        narrow = grouped_gemm_segments_cuda(x, cnt, w, shape="narrow")
        readings[f"{d}->{f}"] = dict(
            bitwise=bool(torch.equal(wide, narrow)),
            rows_differ=int((wide != narrow).any(dim=1).sum()),
            max_diff=float((wide.float() - narrow.float()).abs().max()))
        exp = ref.grouped_gemm_segments_ref(x, cnt, w)
        for out in (wide, narrow):
            assert float((out.float() - exp.float()).abs().max()) <= \
                _gemm_tol("bfloat16", d, exp)
    print(f"\ngrouped_gemm wide vs narrow tiles: {readings}")


def _smol_full_width(cuda, n_layers):
    """Full-width SmolLM2-1.7B (its prefill shapes, where cuBLAS's split-K
    showed) at ``n_layers`` layers, bf16, the kernels on, seeded."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("smollm2-1.7b"), use_kernels=True,
                              n_layers=n_layers)
    return build_model(cfg, device=cuda, seed=0)


def _shared_vs_cold(model, prompts, kw, first, max_new=8):
    """``prompts[:first]`` then the rest through a sharing pool and a
    cold one: (prefix hits, each pool's requests)."""
    runs = {}
    for on in (True, False):
        eng = InferenceEngine(model, **dict(kw, prefix_sharing=on))
        reqs = []
        for batch in (prompts[:first], prompts[first:]):
            reqs += [eng.submit(Request(prompt=list(p),
                                        max_new_tokens=max_new,
                                        keep_logits=True)) for p in batch]
            eng.run_to_completion()
        runs[on] = (eng.stats.prefix_hits, reqs)
    return runs[True][0], runs[True][1], runs[False][1]


@pytest.mark.cuda
def test_cuda_quickstart_shared_prefix_matches_cold(cuda):
    """Quickstart's shared-prefix section (8 sessions over its 23-token
    template, pages of 8) at full width with the kernels: its tokens, and
    a replay's first-token logits, bit for bit a cold pool's (a tail wave
    of 8 x 16 rows against cold waves of 8 x 64)."""
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.examples import quickstart as qs
    model = _smol_full_width(cuda, 4)
    tok = HashTokenizer(model.cfg.vocab_size)
    r = qs.prefix_sharing(model, tok, "cuda")
    assert r["prefix_hits"] > 0
    kw = dict(qs.paged_kw(model.cfg), device=cuda)
    cold = InferenceEngine(model, **dict(kw, prefix_sharing=False))
    assert cold.generate(r["prompts"], max_new_tokens=8) == r["tokens"]
    hits, shared, cold_reqs = _shared_vs_cold(model, r["prompts"], kw,
                                              first=1)
    assert hits > 0
    assert [q.generated for q in shared] == [q.generated for q in cold_reqs]
    for a, b in zip(shared, cold_reqs):
        assert torch.equal(a.first_logits, b.first_logits)


@pytest.mark.cuda
@pytest.mark.parametrize("page_size,prefix_len", [
    (8, 21), (8, 37), (64, 77), (64, 130), (64, 200)])
def test_cuda_shared_prefix_prefill_bitwise_cold(cuda, page_size,
                                                 prefix_len):
    """Tail waves over a shared prefix whose length is no multiple of the
    page (8, 64) or of the prefill kernel's 64-query tile, at full width
    with the kernels: every session's tokens and first-token logits are
    the cold pool's bit for bit (the prefill linear and the attention's
    tail rows at ``q_offset`` both give a row its cold bits)."""
    model = _smol_full_width(cuda, 2)
    rng = np.random.RandomState(prefix_len)
    prefix = list(rng.randint(8, model.cfg.vocab_size, size=prefix_len))
    ps = [prefix + list(rng.randint(8, model.cfg.vocab_size,
                                    size=2 + 5 * i)) for i in range(9)]
    kw = dict(device=cuda, slots=8, cache_len=512, prefill_buckets=(32, 256),
              megastep=4, paged=True, page_size=page_size,
              cache_dtype=torch.bfloat16)
    hits, shared, cold = _shared_vs_cold(model, ps, kw, first=1, max_new=4)
    assert hits >= 8
    assert [q.generated for q in shared] == [q.generated for q in cold]
    for a, b in zip(shared, cold):
        assert torch.equal(a.first_logits, b.first_logits)


@pytest.mark.cuda
def test_cuda_last_demote_frees_the_parameters(cuda):
    """The last engine's demote still frees at least the parameters'
    device bytes; a builder over the released model brings them back and
    decodes as before; the demoted engine restored beside it fills a
    shell of its own and continues the same."""
    model = _smol_full_width(cuda, 2)
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    kw = dict(device=cuda, slots=4, cache_len=64, prefill_buckets=(16,),
              megastep=4, cache_dtype=torch.bfloat16)
    ps = [[5, 9, 14, 200, 7], [11, 3, 60, 61, 62, 63, 64]]
    a = InferenceEngine(model, **kw)
    want = a.generate(ps, max_new_tokens=6)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    host = a.offload_device_state()
    torch.cuda.synchronize()
    assert before - torch.cuda.memory_allocated() >= nbytes
    b = InferenceEngine(model, **kw)
    assert b.generate(ps, max_new_tokens=6) == want
    a.restore_device_state(host)
    assert a.model is not model
    assert a.generate(ps, max_new_tokens=6) == want


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_cuda_demote_pins_arenas_of_its_own(cuda, paged):
    """Full-width SmolLM2 at 2 layers, demoted with requests decoding and
    queued: every tensor it ships is page-locked and PyTorch's caching
    host allocator allocates nothing; a restore whose host copy is dropped
    right after the call brings every leaf back bit for bit, and so does
    an engine built over the released model right after an earlier
    demote; no arena is left once the snapshots are gone."""
    import gc

    from repro_torch import hostmem
    from repro_torch.checkpoint.io import tree_leaves
    from repro_torch.serving import paged as paging

    def image(eng):
        cache = eng.cache
        if eng._paged:
            cache = paging.gather_live(eng.cache, torch.as_tensor(
                eng._alloc.live_ids(), dtype=torch.int64, device=cuda))
        return ([p.clone() for p in eng.model.parameters()]
                + [t.clone() for t in cache.values()]
                + [getattr(eng, n).clone() for n in eng._state_fields])

    def allocated():
        return torch.cuda.host_memory_stats()["allocated_bytes.current"]

    model = _smol_full_width(cuda, 2)
    kw = dict(device=cuda, slots=4, cache_len=512, prefill_buckets=(128,),
              megastep=4, cache_dtype=torch.bfloat16, paged=paged)
    rng = np.random.RandomState(0)
    ps = [list(rng.randint(8, 49152, size=rng.randint(20, 120)))
          for _ in range(6)]
    eng = InferenceEngine(model, **kw)
    want = eng.generate(ps, max_new_tokens=8)
    reqs = [eng.submit(Request(prompt=p, max_new_tokens=8)) for p in ps]
    eng.step()
    assert eng.active and eng.queue
    gc.collect()
    live0 = hostmem.live()
    before = image(eng)
    torch.cuda.synchronize()
    alloc0 = allocated()
    host = eng.offload_device_state()
    leaves = [t for t in tree_leaves(host) if isinstance(t, torch.Tensor)]
    assert allocated() == alloc0
    assert all(t.is_pinned() for t in leaves)
    assert len({t.untyped_storage().data_ptr() for t in leaves}) == 2
    assert hostmem.live()["pinned_bytes"] - live0["pinned_bytes"] == sum(
        {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
         for t in leaves}.values())
    del leaves
    eng.restore_device_state(host)
    del host                    # the last views: the arenas go with them
    assert hostmem.live() == live0
    for a, b in zip(image(eng), before):
        assert a.dtype == b.dtype and torch.equal(a, b)
    eng.run_to_completion()
    assert [r.generated for r in reqs] == want

    params = [p.clone() for p in model.parameters()]
    host = eng.offload_device_state()
    twin = InferenceEngine(model, **kw)
    for a, b in zip(model.parameters(), params):
        assert torch.equal(a, b)
    assert twin.generate(ps, max_new_tokens=8) == want
    del host
    assert hostmem.live() == live0
