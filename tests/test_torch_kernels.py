"""The port's kernel entry points (repro_torch.kernels.ops) against the JAX
package's: on the CPU the port runs its kernels' plain versions, the
reference its Pallas kernels in interpret mode. Same shape and dtype sweeps
and tolerances as tests/test_kernels.py, plus the port's extensions
(per-row kv_len, GQA by head index) against the reference's blockwise
attention, per-row query offsets against the reference's blockwise
attention with a (B,) q_offset, the paged decode and the paged MLA decode
against the reference's paged kernels, the grouped expert GEMM against the
reference's, and the grouped GEMM over rows sorted by expert against
per-expert einsum. The CUDA kernels themselves are held against the plain
versions on the card in tests/test_torch_cuda.py."""

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


def _paged_setup(seed, B, npages, num_pages, page, Hkv, D, dtype):
    """Random pools (NP+1, page, Hkv, D) and a table giving each slot
    ``npages`` distinct pages, as tests/test_kernels.py's _paged_setup."""
    rng = np.random.RandomState(seed)
    kj, kt = _both(seed, (num_pages + 1, page, Hkv, D), dtype)
    vj, vt = _both(seed + 50, (num_pages + 1, page, Hkv, D), dtype)
    pt = rng.permutation(num_pages)[:B * npages].reshape(B, npages).astype(
        np.int32)
    return kj, kt, vj, vt, pt


@pytest.mark.parametrize("page,npages", [(8, 4), (16, 2), (32, 3), (7, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_flash_decode_matches_reference(page, npages, dtype):
    """tests/test_kernels.py's paged sweep: the port's paged decode against
    the reference's Pallas kernel in interpret mode (page 7 included)."""
    B, H, Hkv, D = 3, 8, 2, 64
    kj, kt, vj, vt, pt = _paged_setup(1, B, npages, 2 * B * npages, page,
                                      Hkv, D, dtype)
    qj, qt = _both(0, (B, H, D), dtype)
    cap = npages * page
    lengths = np.array([cap, (cap // 2) | 1, 1][:B], np.int32)
    exp = jops.paged_flash_decode(qj, kj, vj, jnp.asarray(pt),
                                  jnp.asarray(lengths), scale=D ** -0.5)
    out = ops.paged_flash_decode(qt, kt, vt, torch.from_numpy(pt),
                                 torch.from_numpy(lengths), scale=D ** -0.5)
    assert out.dtype == TDT[dtype] and out.shape == (B, H, D)
    assert _err(exp, out) < TOL[dtype]


def test_paged_flash_decode_inactive_slot_and_trash_poison():
    """A slot of length 0 gets exact zeros (the reference: finite garbage);
    columns past a slot's live pages that name a poisoned TRASH page change
    nothing."""
    B, H, Hkv, D, page, npages = 2, 4, 2, 64, 8, 4
    num_pages = 2 * B * npages
    kj, kt, vj, vt, pt = _paged_setup(5, B, npages, num_pages, page, Hkv, D,
                                      "float32")
    qj, qt = _both(0, (B, H, D), "float32")
    lengths = np.array([11, 2 * page], np.int32)     # 2 live pages each
    pt_trash = pt.copy()
    pt_trash[:, 2:] = num_pages
    kt_p, vt_p = kt.clone(), vt.clone()
    kt_p[num_pages] = 1e4
    vt_p[num_pages] = 1e4
    exp = jops.paged_flash_decode(qj, kj, vj, jnp.asarray(pt),
                                  jnp.asarray(lengths), scale=D ** -0.5)
    out = ops.paged_flash_decode(qt, kt_p, vt_p, torch.from_numpy(pt_trash),
                                 torch.from_numpy(lengths), scale=D ** -0.5)
    assert _err(exp, out) < TOL["float32"]
    empty = ops.paged_flash_decode(qt, kt, vt, torch.from_numpy(pt),
                                   torch.tensor([13, 0], dtype=torch.int32),
                                   scale=D ** -0.5)
    assert float(empty[1].abs().max()) == 0.0


@pytest.mark.parametrize("H,Hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("kernel", [False, True])
def test_q_offset_rows_match_reference_blockwise(H, Hkv, kernel):
    """Per-row query offsets (the shared-prefix tail prefill): tail rows at
    positions q_offset[b] + i over a longer K/V, masked to kv_len, through
    the port's blockwise attention and its kernel's plain version, against
    the reference's blockwise attention with a (B,) q_offset."""
    from repro_torch.models import attention as tattn
    B, S, T, D = 3, 12, 48, 16
    qj, qt = _both(0, (B, S, H, D), "float32")
    kj, kt = _both(1, (B, T, Hkv, D), "float32")
    vj, vt = _both(2, (B, T, Hkv, D), "float32")
    q_offset = np.array([0, 9, 33], np.int32)
    kv_len = np.array([12, 21, 40], np.int32)     # row 2 has padding rows
    scale = D ** -0.5
    exp = jattn.blockwise_attention(
        qj, jattn._repeat_kv(kj, H), jattn._repeat_kv(vj, H), scale=scale,
        causal=True, q_offset=jnp.asarray(q_offset),
        kv_len=jnp.asarray(kv_len))
    qo, kl = torch.from_numpy(q_offset), torch.from_numpy(kv_len)
    if kernel:
        out = ops.flash_attention(qt, kt, vt, causal=True, scale=scale,
                                  kv_len=kl, q_offset=qo)
    else:
        out = tattn.blockwise_attention(
            qt, tattn._repeat_kv(kt, H), tattn._repeat_kv(vt, H),
            scale=scale, causal=True, q_offset=qo, kv_len=kl)
    # every row sees key 0, so every row is valid in both
    assert _err(exp, out) < TOL["float32"]


@pytest.mark.parametrize("page,npages", [(8, 4), (16, 3), (7, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_mla_decode_matches_reference(page, npages, dtype):
    """tests/test_kernels.py's MLA sweep: the port's paged MLA decode
    against the reference's Pallas kernel in interpret mode."""
    B, H, R, Dr = 3, 8, 32, 16
    num_pages = 2 * B * npages
    cj, ct = _both(7, (num_pages + 1, page, R), dtype)
    kj, kt = _both(8, (num_pages + 1, page, Dr), dtype)
    pt = np.random.RandomState(7).permutation(num_pages)[:B * npages]
    pt = pt.reshape(B, npages).astype(np.int32)
    qlj, qlt = _both(0, (B, H, R), dtype)
    qrj, qrt = _both(1, (B, H, Dr), dtype)
    cap = npages * page
    lengths = np.array([cap, (cap // 2) | 1, 1][:B], np.int32)
    scale = (R + Dr) ** -0.5
    exp = jops.paged_mla_decode(qlj, qrj, cj, kj, jnp.asarray(pt),
                                jnp.asarray(lengths), scale=scale)
    out = ops.paged_mla_decode(qlt, qrt, ct, kt, torch.from_numpy(pt),
                               torch.from_numpy(lengths), scale=scale)
    assert out.dtype == TDT[dtype] and out.shape == (B, H, R)
    assert _err(exp, out) < TOL[dtype]


@pytest.mark.parametrize("B,H,max_keys", [
    (16, 16, 1024), (4, 16, 35), (3, 16, 1024), (1, 5, 56), (64, 16, 64),
    (16, 16, 16 * 2048)])
def test_mla_key_splits_cover_the_table(B, H, max_keys):
    """The MLA kernel's key ranges: whole 64-key tiles (so whole tiles of
    the f32 route's 32 too), at most 64, every range starting inside the
    table, together covering it; about two (slot, head group of 16, range)
    blocks an SM where the table has the tiles."""
    from repro_torch.kernels.decode_attention import mla_splits
    splits, keys = mla_splits(B, H, max_keys, 132)
    assert keys % 64 == 0 and 1 <= splits <= 64
    assert (splits - 1) * keys < max_keys <= splits * keys
    tiles = -(-max_keys // 64)
    groups = -(-H // 16)
    blocks = B * groups * splits
    assert blocks >= min(2 * 132, B * groups * min(tiles, 64)) // 2


@pytest.mark.parametrize("length", [0, 1, 255, 256, 257, 511, 512, 700,
                                    1023, 1024])
def test_decode_splits_cover_each_length_at_fixed_keys(length):
    """The GQA decode kernels' key ranges: split s is keys [256 s, 256 s +
    256) cut at the length, together covering [0, length) exactly once,
    each starting inside the scratch of every capacity that holds the
    length, the same ranges for a slot cache of 1024 keys and page tables
    of other capacities (17 pages of 64, 7 of 160, 1 of 1024)."""
    from repro_torch.kernels.decode_attention import (DECODE_SPLIT,
                                                      decode_splits)
    assert DECODE_SPLIT == 256
    ranges = [(lo, min(lo + DECODE_SPLIT, length))
              for lo in range(0, length, DECODE_SPLIT)]
    assert sum(hi - lo for lo, hi in ranges) == length
    assert all(lo == 256 * s and hi == min(lo + 256, length) and lo < hi
               for s, (lo, hi) in enumerate(ranges))
    for cap in (1024, 17 * 64, 7 * 160, 1024 * 1):
        if length <= cap:
            assert len(ranges) <= decode_splits(cap)
            assert (decode_splits(cap) - 1) * 256 < cap <= \
                decode_splits(cap) * 256
    assert decode_splits(1024) == 4 and decode_splits(17 * 64) == 5


@pytest.mark.parametrize("N,E,shape", [
    (96, 64, "narrow"), (1, 64, "narrow"), (1024, 64, "narrow"),
    (1025, 64, "wide"), (3072, 64, "wide"), (49152, 64, "wide"),
    (12, 4, "narrow"), (4 * 256, 4, "wide")])
def test_grouped_gemm_tile_shape_from_rows_and_experts(N, E, shape):
    """The bf16 GEMM's tile shape is a function of (N, E) alone: narrow
    (swap-AB) while the experts average at most 16 rows, as at a decode
    step (16 tokens x 6 choices over 64 experts), else wide, as at the
    fact-verification (3 072 rows) and prefill (49 152) waves."""
    from repro_torch.kernels.moe_gemm import NARROW_MAX_ROWS, gemm_shape
    assert NARROW_MAX_ROWS == 16
    assert gemm_shape(N, E) == shape


@pytest.mark.parametrize("B,H,Hkv,D,Skv,split", [
    (3, 8, 2, 64, 600, 256), (3, 8, 2, 64, 600, 16), (2, 4, 4, 112, 300, 64),
    (4, 16, 1, 32, 128, 32), (2, 4, 1, 16, 70, 7)])
def test_split_kv_arithmetic_matches_reference(B, H, Hkv, D, Skv, split):
    """The decode kernels' split-and-combine algebra in plain torch (f32):
    per-split (m, l, unnormalised sum), weighed by exp(m_s - max m) in
    split order, against the reference's flash_decode in interpret mode,
    with empty slots, lengths on and next to a split boundary and a full
    cache."""
    from repro_torch.kernels.decode_attention import splitkv_decode_plain
    qj, qt = _both(0, (B, H, D), "float32")
    kj, kt = _both(1, (B, Skv, Hkv, D), "float32")
    vj, vt = _both(2, (B, Skv, Hkv, D), "float32")
    lengths = np.array([Skv, split, split + 1, 0][:B], np.int32)
    exp = jops.flash_decode(qj, kj, vj, jnp.asarray(lengths),
                            scale=D ** -0.5, block_k=Skv)
    out = splitkv_decode_plain(qt, kt, vt, torch.from_numpy(lengths),
                               scale=D ** -0.5, split=split)
    assert _err(exp, out) < TOL["float32"]
    if B > 3:
        assert float(out[3].abs().max()) == 0.0


def test_split_kv_paged_and_slot_sum_the_same_ranges():
    """A slot's keys laid out in the slot cache and scattered over pages
    of a table with another capacity give the same split-and-combine
    result bit for bit (the plain rendition over the gathered rows), and
    match the reference's paged kernel."""
    from repro_torch.kernels.decode_attention import splitkv_decode_plain
    B, H, Hkv, D, page, npages = 2, 4, 2, 64, 16, 40      # table: 640 keys
    Skv = 512
    kj, kt, vj, vt, pt = _paged_setup(3, B, npages, B * npages, page, Hkv,
                                      D, "float32")
    qj, qt = _both(0, (B, H, D), "float32")
    lengths = np.array([Skv, 257], np.int32)
    flat = torch.from_numpy(pt).long().reshape(-1)
    k_rows = kt[flat].reshape(B, npages * page, Hkv, D)
    v_rows = vt[flat].reshape(B, npages * page, Hkv, D)
    ln = torch.from_numpy(lengths)
    paged = splitkv_decode_plain(qt, k_rows, v_rows, ln, scale=D ** -0.5)
    slot = splitkv_decode_plain(qt, k_rows[:, :Skv].contiguous(),
                                v_rows[:, :Skv].contiguous(), ln,
                                scale=D ** -0.5)
    assert torch.equal(paged, slot)
    exp = jops.paged_flash_decode(qj, kj, vj, jnp.asarray(pt),
                                  jnp.asarray(lengths), scale=D ** -0.5)
    assert _err(exp, paged) < TOL["float32"]


def test_paged_mla_decode_inactive_slot_and_trash_poison():
    """A slot of length 0 gets exact zeros (the reference kernel: finite);
    columns past a slot's live pages that name a poisoned TRASH page change
    nothing."""
    B, H, R, Dr, page, npages = 2, 4, 32, 16, 8, 4
    num_pages = 2 * B * npages
    cj, ct = _both(9, (num_pages + 1, page, R), "float32")
    kj, kt = _both(10, (num_pages + 1, page, Dr), "float32")
    pt = np.random.RandomState(9).permutation(num_pages)[:B * npages]
    pt = pt.reshape(B, npages).astype(np.int32)
    qlj, qlt = _both(0, (B, H, R), "float32")
    qrj, qrt = _both(1, (B, H, Dr), "float32")
    scale = (R + Dr) ** -0.5
    lengths = np.array([9, 0], np.int32)
    exp = jops.paged_mla_decode(qlj, qrj, cj, kj, jnp.asarray(pt),
                                jnp.asarray(lengths), scale=scale)
    assert bool(jnp.all(jnp.isfinite(exp)))
    out = ops.paged_mla_decode(qlt, qrt, ct, kt, torch.from_numpy(pt),
                               torch.from_numpy(lengths), scale=scale)
    assert _err(exp[:1], out[:1]) < TOL["float32"]
    assert float(out[1].abs().max()) == 0.0
    lengths = np.array([11, 2 * page], np.int32)      # 2 live pages each
    pt_trash = pt.copy()
    pt_trash[:, 2:] = num_pages
    ct_p, kt_p = ct.clone(), kt.clone()
    ct_p[num_pages] = 1e4
    kt_p[num_pages] = 1e4
    exp = jops.paged_mla_decode(qlj, qrj, cj, kj, jnp.asarray(pt),
                                jnp.asarray(lengths), scale=scale)
    out = ops.paged_mla_decode(qlt, qrt, ct_p, kt_p,
                               torch.from_numpy(pt_trash),
                               torch.from_numpy(lengths), scale=scale)
    assert _err(exp, out) < TOL["float32"]


@pytest.mark.parametrize("E,C,d,f", [(2, 128, 256, 128), (8, 256, 128, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_gemm_matches_reference(E, C, d, f, dtype):
    """tests/test_kernels.py's grouped GEMM sweep and tolerance, against the
    reference's Pallas kernel in interpret mode."""
    xj, xt = _both(0, (E, C, d), dtype)
    wj, wt = _both(1, (E, d, f), dtype)
    exp = jops.grouped_gemm(xj, wj)
    out = ops.grouped_gemm(xt, wt)
    assert out.dtype == TDT[dtype] and out.shape == (E, C, f)
    assert _err(exp, out) < (5e-3 if dtype == "float32" else 1.0) * d ** 0.5


@pytest.mark.parametrize("counts,d,f", [
    ([3, 0, 1, 0, 7, 2, 0, 5], 64, 48),
    ([2, 0, 0, 4], 1408, 32),
    ([0, 5, 0], 48, 1408)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_gemm_segments_matches_einsum(counts, d, f, dtype):
    """Rows grouped by expert, empty experts included, DeepSeek's expert
    depth 1408 as contraction and as width: each expert's segment is its
    rows times its weights, as the reference's per-expert einsum computes
    it; the uniform-segment case is ops.grouped_gemm."""
    E, N = len(counts), sum(counts)
    xj, xt = _both(2, (N, d), dtype)
    wj, wt = _both(3, (E, d, f), dtype)
    out = ops.grouped_gemm_segments(xt, torch.tensor(counts,
                                                     dtype=torch.int32), wt)
    assert out.shape == (N, f) and out.dtype == TDT[dtype]
    lo = 0
    tol = (5e-3 if dtype == "float32" else 1.0) * d ** 0.5
    for e, n in enumerate(counts):
        exp = jnp.einsum("cd,df->cf", xj[lo:lo + n].astype(jnp.float32),
                         wj[e].astype(jnp.float32)).astype(JDT[dtype])
        if n:
            assert _err(exp, out[lo:lo + n]) < tol
        lo += n
    xu = xt[:4 * 3].reshape(4, 3, d) if N >= 12 else None
    if xu is not None and E >= 4:
        uni = ops.grouped_gemm(xu, wt[:4])
        seg = ops.grouped_gemm_segments(
            xu.reshape(12, d), torch.full((4,), 3, dtype=torch.int32),
            wt[:4])
        assert torch.equal(uni.reshape(12, f), seg)


def test_cpu_tensors_launch_no_kernel():
    before = dict(ops.LAUNCHES)
    q = torch.randn(1, 8, 2, 64)
    one = torch.tensor([3], dtype=torch.int32)
    table = torch.tensor([[0]], dtype=torch.int32)
    ops.flash_attention(q, q, q, scale=0.125)
    ops.flash_decode(q[:, 0], q, q, one)
    ops.paged_flash_decode(q[:, 0], q, q, table, one)
    ops.paged_mla_decode(q[:, 0], q[:, 0, :, :8], q[0], q[0, :, :, :8],
                         table, one)
    w = torch.randn(8, 64, 16)
    ops.grouped_gemm(q[0], w)
    ops.grouped_gemm_segments(q[0, :, 0], torch.full((8,), 1,
                                                     dtype=torch.int32), w)
    assert ops.LAUNCHES == before


def test_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.decode_attention import (flash_decode_cuda,
                                                      paged_flash_decode_cuda,
                                                      paged_mla_decode_cuda)
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.moe_gemm import (grouped_gemm_cuda,
                                              grouped_gemm_segments_cuda)
    q = torch.randn(1, 8, 2, 64)
    one = torch.tensor([3], dtype=torch.int32)
    table = torch.tensor([[0]], dtype=torch.int32)
    with pytest.raises(ValueError):
        flash_attention_cuda(q, q, q, causal=True, window=0, scale=1.0)
    with pytest.raises(ValueError):
        flash_decode_cuda(q[:, 0], q, q, one, scale=1.0)
    with pytest.raises(ValueError):
        paged_flash_decode_cuda(q[:, 0], q, q, table, one, scale=1.0)
    with pytest.raises(ValueError):
        paged_mla_decode_cuda(q[:, 0], q[:, 0, :, :8], q[0], q[0, :, :, :8],
                              table, one, scale=1.0)
    with pytest.raises(ValueError):
        grouped_gemm_cuda(q[0], q[0].transpose(1, 2))
    with pytest.raises(ValueError):
        grouped_gemm_segments_cuda(q[0, 0], one, q[0].transpose(1, 2))
