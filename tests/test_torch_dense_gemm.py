"""The prefill linear's plan and wrapper (``repro_torch.kernels.dense_gemm``)
on the CPU: the plan is a pure function of (K, N) whose chunks tile K in
whole 64-deep k-slices, its items at a 128-row wave cover the card at
every prefill linear of the registry's decoders, the plain model of its
split order gives a row the same bits whatever the row count and agrees
with ``torch.matmul``, the wrapper refuses what the kernel does not take,
and ``ops.prefill_linear`` on the CPU is ``torch.matmul`` bit for bit and
agrees with the reference's XLA product. The kernel itself runs in
``tests/test_torch_cuda.py`` on the card."""

import inspect

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.configs.registry import ALL_ARCHS  # noqa: E402
from repro_torch.kernels import dense_gemm as dg  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

H100_SMS = 132
DECODERS = tuple(a for a in ALL_ARCHS
                 if get_config(a).family in ("dense", "moe"))


def prefill_shapes(cfg):
    """(K, N, w K-major) of every linear one prefill wave of ``cfg``'s
    ``Transformer`` runs: the attention's projections (MLA's q and out),
    the MLP's (a MoE's leading dense layers and shared experts), the
    unembedding (tok read K-major when tied)."""
    d, H = cfg.d_model, cfg.n_heads
    if cfg.attention == "mla":
        m = cfg.mla
        shapes = {(d, H * (m.qk_nope_head_dim + m.qk_rope_head_dim)),
                  (H * m.v_head_dim, d)}
    else:
        hd = cfg.resolved_head_dim
        shapes = {(d, H * hd), (d, cfg.n_kv_heads * hd), (H * hd, d)}
    if cfg.moe.enabled:
        e = cfg.moe
        widths = ([e.dense_d_ff] if e.first_dense_layers else []) + (
            [(e.shared_d_ff or e.d_ff) * e.n_shared_experts]
            if e.n_shared_experts else [])
    else:
        widths = [cfg.d_ff]
    for f in widths:
        shapes |= {(d, f), (f, d)}
    shapes = {(K, N, False) for K, N in shapes}
    return shapes | {(d, cfg.padded_vocab, bool(cfg.tie_embeddings))}


def covered_sms(K, N, rows=128, sms=H100_SMS):
    """The SMs that the plan's blocks at ``rows`` rows reach."""
    return min(items(K, N, rows, sms), sms)


def items(K, N, rows=128, sms=H100_SMS):
    """The kernel's blocks (work items) for ``rows`` rows: the tiles, each
    ``split`` items on the across route."""
    p = dg.dense_gemm_plan(K, N)
    tiles = -(-rows // p.tile_rows) * -(-N // dg.block_cols(p, rows, N, sms))
    return tiles * (p.split if dg.across(p, rows, N, sms) else 1)


class Recorder:
    """Stands on ``ops.prefill_linear``: records (K, N, w K-major) and
    runs the plain version."""

    def __init__(self):
        self.shapes = set()

    def __call__(self, x, w, *, w_kmajor=False):
        N, K = w.shape if w_kmajor else w.shape[::-1]
        self.shapes.add((K, N, w_kmajor))
        return ref.prefill_linear_ref(x, w, w_kmajor)


# -------------------------------------------------------------- the plan --
def test_plan_reads_k_and_n_alone(monkeypatch):
    """``dense_gemm_plan`` reads K and N and nothing else: no M, no SM
    count, no device (a query of the card would raise here), the same plan
    on every call; SmolLM2's down projection takes three chunks of 43
    k-slices on 64-column accumulators."""
    assert list(inspect.signature(dg.dense_gemm_plan).parameters) == [
        "K", "N"]

    def no_card(*a, **k):
        raise AssertionError("the plan queried the card")
    monkeypatch.setattr(torch.cuda, "get_device_properties", no_card)
    monkeypatch.setattr(torch.cuda, "device_count", no_card)
    a = dg.dense_gemm_plan(8192, 2048)
    assert a == dg.dense_gemm_plan(8192, 2048)
    assert (a.tile_rows, a.tile_cols, a.split, a.chunk) == (
        128, 64, 3, 43 * dg.SLICE)


@pytest.mark.parametrize("K,N", [
    (2048, 2048), (8192, 2048), (2048, 8192), (2048, 49152), (2048, 512),
    (104, 40), (64, 96), (13824, 5120), (2560, 640), (10944, 2048),
    (24, 8), (2048, 256), (6912, 2560), (24576, 6144), (4104, 1024)])
def test_plan_chunks_tile_k_in_whole_slices(K, N):
    """The chunks run from 0 to K without a gap or an overlap; the chunk
    depth is a multiple of the 64-deep k-slice, so each chunk starts on a
    k-slice and ends on one (or at K); none is empty; there are ``split``
    of them, at most MAX_SPLIT."""
    p = dg.dense_gemm_plan(K, N)
    assert p.chunk % dg.SLICE == 0 and p.chunk > 0
    assert len(p.chunks) == p.split and 1 <= p.split <= dg.MAX_SPLIT
    assert p.chunks[0][0] == 0 and p.chunks[-1][1] == K
    for (lo, hi), (nxt, _) in zip(p.chunks, p.chunks[1:] + ((K, K),)):
        assert lo % dg.SLICE == 0 and lo < hi and hi == nxt
        assert hi - lo == p.chunk or hi == K


@pytest.mark.parametrize("K,N", [(2048, 2048), (2048, 8192), (8192, 2048)])
def test_plan_fills_the_card_at_128_rows(K, N):
    """At 128 rows SmolLM2's three projection shapes give at least 96
    work items on the H100's 132 SMs (the grouped GEMM's one-group route
    gave 16 at N = 2048)."""
    assert items(K, N) >= 96


def test_route_switches_once_with_rows():
    """The across-block route holds up to ``switch_rows`` rows and the
    inside-block route from the next row tile on, at every shape; a plan
    of one chunk is always inside."""
    for K, N in ((2048, 2048), (8192, 2048), (2560, 2560), (2048, 512)):
        p = dg.dense_gemm_plan(K, N)
        sw = dg.switch_rows(K, N, H100_SMS)
        assert sw >= 128
        for M in (1, 127, 128, sw - 1, sw):
            assert dg.across(p, M, N, H100_SMS)
        for M in (sw + 1, sw + 128, 8192, 65536):
            assert not dg.across(p, M, N, H100_SMS)
    for K, N in ((2048, 49152), (2048, 8192)):
        one = dg.dense_gemm_plan(K, N)
        assert one.split == 1 and not dg.across(one, 16, N, H100_SMS)
        assert dg.switch_rows(K, N, H100_SMS) == 0


def test_block_width_follows_rows_not_bits():
    """A block of a 64-column plan takes 64 columns while the call's tiles
    are few and 128 once 128-column tiles fill the card; the across route
    keeps the plan's, and a 128-column plan takes 128 always. The plan,
    which fixes the chunks, is the same at every row count."""
    p = dg.dense_gemm_plan(2048, 2048)
    assert [dg.block_cols(p, M, 2048, H100_SMS)
            for M in (1, 128, 512, 1024, 8192)] == [64, 64, 64, 64, 128]
    assert dg.wide_block_rows(2048, 2048, H100_SMS) == 1152
    wide = dg.dense_gemm_plan(2560, 2560)
    assert wide.tile_cols == 128
    assert {dg.block_cols(wide, M, 2560, H100_SMS)
            for M in (1, 128, 8192)} == {128}
    assert dg.wide_block_rows(2560, 2560, H100_SMS) == 0


# ---------------------------------------------- the plain split order -----
SPLIT_SHAPES = [(256, 64, False), (320, 72, True), (200, 136, False),
                (1000, 40, False)]


@pytest.mark.parametrize("K,N,kmaj", SPLIT_SHAPES)
def test_split_order_gives_a_row_its_bits_whatever_m(K, N, kmaj):
    """The plain model of the kernel's split order (``split_matmul_ref``:
    f32 partials over the plan's chunks, summed in chunk order) gives one
    row the same bits among 1, 16, 127, 128, 129 and 300 rows, first,
    middle or last; its plan splits K (the point of the model)."""
    assert dg.dense_gemm_plan(K, N).split > 1
    rng = np.random.RandomState(K + N)
    x = torch.from_numpy(rng.standard_normal((300, K)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((N, K) if kmaj else (K, N))
                          / np.sqrt(K)).astype(np.float32))
    probe = torch.from_numpy(rng.standard_normal(K).astype(np.float32))
    want = dg.split_matmul_ref(probe[None], w, kmaj)[0]
    for M in (1, 16, 127, 128, 129, 300):
        for at in sorted({0, M // 2, M - 1}):
            xm = x[:M].clone()
            xm[at] = probe
            assert torch.equal(dg.split_matmul_ref(xm, w, kmaj)[at], want), \
                (M, at)


@pytest.mark.parametrize("K,N,kmaj", SPLIT_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_order_agrees_with_matmul(K, N, kmaj, dtype):
    """The split order is another summation order of the same product: in
    f32 within f32 rounding of ``torch.matmul`` (1e-5 relative to the
    products' scale, K up to 1000 terms); in bf16 (f32 sums, one rounding
    to bf16) within one bf16 ulp of the f32 product."""
    rng = np.random.RandomState(3 * K + N)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((37, K)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((N, K) if kmaj else (K, N))
                          / np.sqrt(K)).astype(np.float32))
    x, w = x.to(dt), w.to(dt)
    got = dg.split_matmul_ref(x, w, kmaj)
    assert got.dtype == dt and got.shape == (37, N)
    want = torch.matmul(x.float(), (w.t() if kmaj else w).float())
    err = float((got.float() - want).abs().max())
    if dtype == "float32":
        assert err <= 1e-5 * float(want.abs().max())
    else:
        assert err <= 2 ** -7 * float(want.abs().max())


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_shapes_are_the_linears_a_wave_runs(arch):
    """``prefill_shapes`` names exactly the (K, N, layout) that one
    prefill wave of the reduced dense decoder sends to
    ``ops.prefill_linear``; a MoE decoder's prefill sends none (it keeps
    ``torch.matmul``: ``Transformer._row_invariant``)."""
    cfg = get_reduced_config(arch, use_kernels=True)
    model = build_model(cfg, device="cpu", seed=0)
    rec = Recorder()
    mp = pytest.MonkeyPatch()
    mp.setattr(ops, "prefill_linear", rec)
    try:
        tokens = torch.randint(1, cfg.vocab_size, (2, 8))
        lengths = torch.tensor([8, 5], dtype=torch.int32)
        with torch.no_grad():
            model.prefill(tokens, lengths, model.init_cache(2, 16))
    finally:
        mp.undo()
    moe = cfg.family == "moe"
    assert rec.shapes == (set() if moe else prefill_shapes(cfg))


@pytest.mark.parametrize("arch", DECODERS)
def test_plan_covers_the_card_at_a_tail_wave(arch):
    """At 128 rows every prefill linear of the full-size decoder reaches
    at least 64 of the H100's 132 SMs (the grouped GEMM's route reached 16
    at SmolLM2's 2048 -> 2048 and 8192 -> 2048), the clusters of each
    tile fit the card at once, and no plan takes more chunks than the
    most items it can reach need: where three quarters of the card is
    reached, one chunk fewer does not reach it."""
    for K, N, _ in prefill_shapes(get_config(arch)):
        p = dg.dense_gemm_plan(K, N)
        nt = -(-N // p.tile_cols)
        assert covered_sms(K, N) >= 64, (K, N)
        assert p.split == 1 or nt <= dg.CLUSTERS_AT_ONCE[p.split], (K, N)
        if p.split > 1 and 4 * nt * p.split >= 3 * H100_SMS:
            assert 4 * nt * (p.split - 1) < 3 * H100_SMS, (K, N)


# ----------------------------------------------------------- the wrapper --
def _pair(M=8, K=64, N=32, dtype=torch.bfloat16, kmajor=False):
    x = torch.zeros((M, K), dtype=dtype)
    w = torch.zeros((N, K) if kmajor else (K, N), dtype=dtype)
    return x, w


def test_wrapper_refuses_cpu_tensors():
    x, w = _pair()
    with pytest.raises(ValueError, match="CUDA"):
        dg.dense_gemm_cuda(x, w)


@pytest.mark.parametrize("case", ["dtype", "mixed", "rank", "contract",
                                  "kmajor_contract", "contiguous",
                                  "multiple", "empty_k", "aligned"])
def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch, case):
    """Every input the kernel cannot take raises before a launch (the
    device check is passed over so that the others run on the CPU)."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    x, w = _pair()
    err = ValueError
    if case == "dtype":
        x, w = _pair(dtype=torch.float16)
        err = TypeError
    elif case == "mixed":
        w = w.float()
        err = TypeError
    elif case == "rank":
        x = x[0]
    elif case == "contract":
        w = torch.zeros((48, 32), dtype=torch.bfloat16)
    elif case == "kmajor_contract":
        with pytest.raises(ValueError, match="contract"):
            dg.dense_gemm_cuda(x, w, w_kmajor=True)
        return
    elif case == "contiguous":
        w = torch.zeros((32, 64), dtype=torch.bfloat16).t()
    elif case == "multiple":
        x, w = _pair(K=60, N=32)
    elif case == "empty_k":
        x, w = _pair(K=0, N=32)
    elif case == "aligned":
        x = torch.zeros(8 * 64 + 1, dtype=torch.bfloat16)[1:].view(8, 64)
    with pytest.raises(err):
        dg.dense_gemm_cuda(x, w)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("K,N,kmaj,M", [
    (8192, 2048, False, 128), (8192, 2048, False, 8192),
    (2048, 2048, False, 1152), (2048, 49152, True, 16),
    (6912, 2560, False, 129)])
def test_wrapper_passes_the_plan_it_computes(monkeypatch, dtype, K, N, kmaj,
                                             M):
    """The kernel takes its plan and route from the wrapper, as integers:
    ``launch_plan``'s split, chunk (in k-slices), block columns and route,
    which are ``dense_gemm_plan``'s, ``block_cols``' and ``across``'; one
    C call a launch, on x's rows in place, the output in its final shape.
    (The device check and the card's SM count are stood in for, so that
    the call runs on the CPU against a recording library.)"""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(dg, "_sms", lambda dev: H100_SMS)
    monkeypatch.setattr(dg, "_stream", lambda dev: 0)
    calls = []

    class Lib:
        def dense_gemm_fwd(self, *args):
            calls.append(args)
            return 0
    monkeypatch.setattr(dg, "_lib", Lib)
    dt = getattr(torch, dtype)
    x = torch.zeros((2, M // 2, K) if M % 2 == 0 else (M, K), dtype=dt)
    w = torch.zeros((N, K) if kmaj else (K, N), dtype=dt)
    out = dg.dense_gemm_cuda(x, w, w_kmajor=kmaj)
    assert out.shape == x.shape[:-1] + (N,) and out.dtype == dt
    (args,) = calls
    p = dg.dense_gemm_plan(K, N)
    want = (p.split, p.chunk // dg.SLICE, dg.block_cols(p, M, N, H100_SMS),
            int(dg.across(p, M, N, H100_SMS)))
    assert dg.launch_plan(M, K, N, H100_SMS) == want
    assert args[:3] == (x.data_ptr(), w.data_ptr(), out.data_ptr())
    assert args[3:] == (M, K, N, dg._DTYPES[dt], int(kmaj)) + want + (
        H100_SMS, 0)


# ------------------------------------------------------ the plain version --
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w_kmajor", [False, True])
def test_prefill_linear_on_cpu_is_matmul(dtype, w_kmajor):
    """On the CPU ``ops.prefill_linear`` is ``torch.matmul`` bit for bit,
    launches nothing, and (in f32) agrees with the reference's XLA
    product of the same numpy inputs."""
    rng = np.random.RandomState(7)
    dt = getattr(torch, dtype)
    xn = rng.standard_normal((3, 40, 128)).astype(np.float32)
    wn = (rng.standard_normal((136, 128) if w_kmajor else (128, 136))
          .astype(np.float32) / np.sqrt(128))
    x, w = torch.from_numpy(xn).to(dt), torch.from_numpy(wn).to(dt)
    before = dict(ops.LAUNCHES)
    got = ops.prefill_linear(x, w, w_kmajor=w_kmajor)
    assert torch.equal(got, torch.matmul(x, w.t() if w_kmajor else w))
    assert ops.LAUNCHES == before
    if dtype == "float32":
        want = np.asarray(jnp.matmul(xn, wn.T if w_kmajor else wn))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
