"""The prefill's row-invariant linears (``models.layers.linear`` inside
``row_invariant_linears``, ``kernels.ops.prefill_linear``) on the CPU.

On the card a cuBLAS GEMM picks its algorithm by shape, so a row could get
other bits in a shared-prefix tail wave than in a cold wave; the port's
prefill sends every projection, MLP GEMM and the unembedding through one
kernel whose rows do not depend on the row count. Here, where the kernel
cannot run, the route is recorded by putting a recorder on
``ops.prefill_linear`` (which runs the plain version): ``Transformer.prefill``
and ``prefill_shared`` send every linear through it once, decode,
``forward`` and training never do, the plain version is ``torch.matmul``
bit for bit, the engine with the route gives the JAX engine's tokens on
the same bridged weights (reduced smollm2-1.7b), and shared == cold holds
(a guard: the CPU's matmul is row-invariant already)."""

import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import get_reduced_config as jax_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serving import InferenceEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import build_model, layers  # noqa: E402
from repro_torch.serving import InferenceEngine, Request  # noqa: E402
from repro_torch.train import (OptimizerConfig, init_state,  # noqa: E402
                               make_train_step, trainable)
from repro_torch.weights import from_jax_params  # noqa: E402

ENGINE = dict(slots=4, cache_len=64, prefill_buckets=(16, 32), megastep=4)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def bridged():
    jcfg = jax_config("smollm2-1.7b")
    jmodel = jax_build(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, params, jax.device_get(params)


def model_of(bridged, dtype="float32", use_kernels=True):
    cfg = get_reduced_config("smollm2-1.7b", param_dtype=dtype,
                             compute_dtype=dtype, use_kernels=use_kernels)
    return build_model(cfg, device="cpu",
                       params=from_jax_params(bridged[2], cfg, "cpu"))


def prompts(n, seed=0, vocab=512):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(8, vocab, size=rng.randint(3, 14)))
            for _ in range(n)]


class Recorder:
    """Stands on ``ops.prefill_linear``: records each call's weight
    (storage pointer, layout) and runs the plain version."""

    def __init__(self):
        self.calls = []

    def __call__(self, x, w, *, w_kmajor=False):
        self.calls.append((w.data_ptr(), tuple(w.shape), w_kmajor))
        return ref.prefill_linear_ref(x, w, w_kmajor)


@pytest.fixture
def recorder(monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(ops, "prefill_linear", rec)
    return rec


def linear_weights(model):
    """Every weight one prefill's linears read, once each: per layer wq,
    wk, wv, wo, up, gate, down, then the tied unembedding's tok."""
    want = []
    for blk in model.blocks:
        want += [blk.attn.wq, blk.attn.wk, blk.attn.wv, blk.attn.wo,
                 blk.mlp.up, blk.mlp.gate, blk.mlp.down]
    return sorted([w.data_ptr() for w in want] + [model.embed.tok.data_ptr()])


# ------------------------------------------------------ the plain version --
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("w_kmajor", [False, True])
def test_plain_version_is_matmul_bit_for_bit(dtype, w_kmajor):
    """``ref.prefill_linear_ref`` and ``ops.prefill_linear`` on the CPU
    equal ``torch.matmul`` bit for bit, at 2-D and 3-D x."""
    rng = np.random.RandomState(3)
    dt = DTYPES[dtype]
    x = torch.from_numpy(rng.standard_normal((2, 37, 64))).to(dt)
    w = torch.from_numpy(rng.standard_normal((96, 64) if w_kmajor
                                             else (64, 96))).to(dt)
    want = torch.matmul(x, w.t() if w_kmajor else w)
    before = dict(ops.LAUNCHES)
    for xx, ww in ((x, want), (x[0], want[0])):
        assert torch.equal(ref.prefill_linear_ref(xx, w, w_kmajor), ww)
        assert torch.equal(ops.prefill_linear(xx, w, w_kmajor=w_kmajor), ww)
    assert ops.LAUNCHES == before   # the plain version launches nothing


# ------------------------------------------------------------- the route --
def test_prefill_sends_every_linear_through_the_entry(bridged, recorder):
    """One prefill wave calls the entry once for every projection, MLP
    GEMM and the unembedding, and nowhere else."""
    model = model_of(bridged)
    eng = InferenceEngine(model, device="cpu", **ENGINE)
    eng.generate(prompts(3), max_new_tokens=1)
    assert eng.stats.prefill_batches == 1
    assert sorted(c[0] for c in recorder.calls) == linear_weights(model)
    assert [c[2] for c in recorder.calls].count(True) == 1   # tok, K-major
    assert len(recorder.calls) == 7 * model.cfg.n_layers + 1


def test_prefill_shared_sends_every_linear_through_the_entry(bridged,
                                                             recorder,
                                                             monkeypatch):
    """A shared-prefix tail wave (``prefill_shared``) calls the entry for
    every linear of the tail, as a cold wave does; the decode steps after
    both call it never."""
    model = model_of(bridged)
    seen = {}

    def track(name):
        inner = getattr(model, name)

        def wrapped(*a, **kw):
            n0 = len(recorder.calls)
            out = inner(*a, **kw)
            seen.setdefault(name, []).append(recorder.calls[n0:])
            return out
        monkeypatch.setattr(model, name, wrapped)

    for name in ("prefill", "prefill_shared", "decode_paged"):
        track(name)
    eng = InferenceEngine(model, device="cpu", **dict(
        ENGINE, paged=True, page_size=8))
    ps = shared_prompts(6)
    eng.generate(ps[:1], max_new_tokens=2)          # cold: the template
    eng.generate(ps[1:], max_new_tokens=4)          # tails over it
    assert eng.stats.prefix_hits >= 4
    want = linear_weights(model)
    assert seen["prefill"] and seen["prefill_shared"]
    for calls in seen["prefill"] + seen["prefill_shared"]:
        assert sorted(c[0] for c in calls) == want
    assert seen["decode_paged"] and not any(seen["decode_paged"])


def test_decode_forward_and_training_never_route(bridged, recorder):
    """Decode steps (slot cache and pool), ``forward`` (with and without
    gradients) and a train step keep ``torch.matmul``."""
    model = model_of(bridged)
    eng = InferenceEngine(model, device="cpu", **ENGINE)
    eng.generate(prompts(2), max_new_tokens=1)
    n_prefill = len(recorder.calls)
    assert n_prefill == 7 * model.cfg.n_layers + 1
    cache = model.init_cache(2, 32)
    toks = torch.tensor([[5, 9, 11, 13], [7, 8, 9, 0]], dtype=torch.int32)
    lens = torch.tensor([4, 3], dtype=torch.int32)
    with torch.no_grad():
        model.prefill(toks, lens, cache)
        n_prefill = len(recorder.calls)
        model.decode_step(toks[:, :1], lens, cache)
        model.forward(toks, lens)
    assert len(recorder.calls) == n_prefill
    named = trainable(model)
    model.forward(toks, lens).float().square().mean().backward()
    assert len(recorder.calls) == n_prefill
    assert all(p.grad is not None for p in named.values())
    plain = model_of(bridged, use_kernels=False)
    named = trainable(plain)
    rng = np.random.RandomState(0)
    tok = torch.from_numpy(rng.randint(8, 512, size=(2, 17)).astype(
        np.int32))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    make_train_step(plain, OptimizerConfig(), ce_chunk=8)(
        named, init_state(named), batch)
    assert len(recorder.calls) == n_prefill


def test_route_scope_is_thread_local_and_outermost_decides(bridged,
                                                           recorder):
    """Another thread does not see this thread's scope; an outer
    ``row_invariant_linears(False)`` keeps a kernel model's prefill on
    ``torch.matmul``; fake tensors (the dry-run) never route."""
    x, w = torch.ones(3, 8), torch.ones(8, 16)
    seen = []
    with layers.row_invariant_linears(True):
        layers.linear(x, w)
        t = threading.Thread(target=lambda: seen.append(
            layers.linear(x, w)))
        t.start()
        t.join()
        with layers.row_invariant_linears(False):   # inner: no effect
            layers.linear(x, w)
    assert len(recorder.calls) == 2 and len(seen) == 1
    layers.linear(x, w)
    assert len(recorder.calls) == 2
    model = model_of(bridged)
    cache = model.init_cache(1, 16)
    with torch.no_grad(), layers.row_invariant_linears(False):
        model.prefill(torch.tensor([[5, 6, 7]], dtype=torch.int32),
                      torch.tensor([3], dtype=torch.int32), cache)
    assert len(recorder.calls) == 2
    with FakeTensorMode(), layers.row_invariant_linears(True):
        out = layers.linear(torch.empty(4, 8), torch.empty(8, 16))
    assert out.shape == (4, 16) and len(recorder.calls) == 2


# ------------------------------------------------- against the reference --
@pytest.mark.parametrize("paged", [False, True])
def test_routed_engine_matches_reference_engine(bridged, paged):
    """The engine with the route on (kernels on, plain versions on the
    CPU) gives the JAX engine's greedy tokens on the same weights."""
    kw = dict(ENGINE, paged=paged, page_size=8, prefix_sharing=False)
    want = JaxEngine(bridged[0], bridged[1], **kw).generate(
        prompts(7, seed=5), max_new_tokens=6)
    got = InferenceEngine(model_of(bridged), device="cpu", **kw).generate(
        prompts(7, seed=5), max_new_tokens=6)
    assert got == want


# --------------------------------------------------------- shared == cold --
def shared_prompts(n, prefix_len=21, tail=3, seed=0, vocab=512):
    """n prompts behind one shared prefix (mid-page for pages of 8), tails
    of ``tail`` to ``tail + 4`` tokens."""
    rng = np.random.RandomState(seed)
    prefix = list(rng.randint(8, vocab, size=prefix_len))
    return [prefix + list(rng.randint(8, vocab, size=tail + (i % 5)))
            for i in range(n)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("tail", [1, 5, 11])
def test_shared_equals_cold_through_the_route(bridged, recorder, dtype,
                                              tail):
    """Prefix-shared tail waves and cold waves, both through the route:
    the same tokens and first-token logits bit for bit, at three tail
    lengths, in f32 and bf16."""
    model = model_of(bridged, dtype)
    kw = dict(ENGINE, paged=True, page_size=8,
              cache_dtype=DTYPES[dtype])
    ps = shared_prompts(6, tail=tail, seed=tail)
    runs = {}
    for on in (True, False):
        eng = InferenceEngine(model, device="cpu",
                              **dict(kw, prefix_sharing=on))
        reqs = [eng.submit(Request(prompt=list(p), max_new_tokens=5,
                                   keep_logits=True)) for p in ps[:1]]
        eng.run_to_completion()
        reqs += [eng.submit(Request(prompt=list(p), max_new_tokens=5,
                                    keep_logits=True)) for p in ps[1:]]
        eng.run_to_completion()
        runs[on] = (eng.stats.prefix_hits, reqs)
    assert runs[True][0] >= 4 and runs[False][0] == 0
    assert [r.generated for r in runs[True][1]] == \
        [r.generated for r in runs[False][1]]
    for a, b in zip(runs[True][1], runs[False][1]):
        assert torch.equal(a.first_logits, b.first_logits)
    assert recorder.calls
