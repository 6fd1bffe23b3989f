"""The port's host tier for a demoted context (``repro_torch.hostmem``).

A demote or a template export copies the engine's device state into two
arenas of host memory that the port owns: one for the parameters (which a
released model keeps) and one for the rest. Every tensor leaf is a view of
one of them, and each arena holds exactly its views' bytes rounded up to
the alignment. The snapshot and ``SnapshotPool`` count each arena once by
its bytes, and an arena is freed as soon as its last view goes: the
state's on a spill, all of them after a take, a restore and a drop, the
parameters' when an engine is built over the released model. Reduced
SmolLM2 on the CPU, where the arenas are plain memory (the card's
page-locked case is in ``tests/test_torch_cuda.py``), one slot engine and
one paged engine; a demote/restore round trip still decodes the JAX
engine's greedy tokens.
"""

import gc

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced_config as jax_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serving import InferenceEngine as JaxEngine  # noqa: E402
from repro_torch import hostmem  # noqa: E402
from repro_torch.checkpoint.io import tree_leaves  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.core import (Library, SnapshotPool, Tier,  # noqa: E402
                              make_recipe)
from repro_torch.core.context import (export_context,  # noqa: E402
                                      materialize, restore_context)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import InferenceEngine, Request  # noqa: E402
from repro_torch.serving import paged as paging  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

KINDS = {"slot": dict(slots=2, cache_len=64, prefill_buckets=(16,),
                      megastep=4),
         "paged": dict(slots=4, cache_len=64, prefill_buckets=(16,),
                       megastep=4, paged=True, page_size=8)}
NEW = 8


@pytest.fixture(scope="module")
def bridged():
    jmodel = jax_build(jax_config("smollm2-1.7b"))
    params = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, params, from_jax_params(
        jax.device_get(params), get_reduced_config("smollm2-1.7b"), "cpu")


def prompts(n=5, seed=11):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(8, 512, size=rng.randint(3, 14)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def jax_tokens(bridged):
    jmodel, params, _ = bridged
    return {kind: JaxEngine(jmodel, params, **kw).generate(
                prompts(), max_new_tokens=NEW)
            for kind, kw in KINDS.items()}


def fresh_model(bridged):
    """A port model over a copy of the bridged weights (a demote releases
    them in place)."""
    return build_model(get_reduced_config("smollm2-1.7b"), device="cpu",
                       params={n: t.clone() for n, t in bridged[2].items()})


def in_flight(eng):
    """``prompts()`` submitted and one step taken: some decoding, some
    queued."""
    reqs = [eng.submit(Request(prompt=list(p), max_new_tokens=NEW))
            for p in prompts()]
    eng.step()
    assert eng.active and eng.queue
    return reqs


def tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def arenas(tree):
    """{storage address: bytes} of the tensors in ``tree``."""
    return {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for t in tensors(tree)}


def aligned(ts):
    """The bytes of an arena holding ``ts``: each one's rounded up to the
    alignment."""
    return sum(-(-t.numel() * t.element_size() // hostmem.ALIGN)
               * hostmem.ALIGN for t in ts)


def live():
    """``hostmem.live()``, with no garbage collection first: an arena is
    freed when its last view goes, not when a cycle is collected."""
    return hostmem.live()


def split(host):
    """A demote's or an export's host copy -> (its parameters' arena, the
    other arena), each {address: bytes}, after checking each part's
    tensors are views of exactly one arena of their aligned bytes."""
    params = list(host["params"].values())
    rest = tensors({k: v for k, v in host.items() if k != "params"})
    out = []
    for part in (params, rest):
        got = arenas(part)
        assert len(got) == 1 and list(got.values()) == [aligned(part)]
        out.append(got)
    assert out[0].keys() != out[1].keys()
    return out


def device_image(eng):
    """Clones of what a demote ships: parameters, the cache (a paged pool's
    live pages) and the per-slot state."""
    cache = eng.cache
    if eng._paged:
        cache = paging.gather_live(eng.cache, torch.as_tensor(
            eng._alloc.live_ids(), dtype=torch.int64))
    return {"params": {n: p.clone()
                       for n, p in eng.model.named_parameters()},
            "cache": {n: t.clone() for n, t in cache.items()},
            **{n: getattr(eng, n).clone() for n in eng._state_fields}}


# ---------------------------------------------------------- the arena ----
def test_arena_views_share_one_storage_freed_with_the_last():
    before = live()
    parts = {"a": torch.arange(7, dtype=torch.bfloat16),
             "b": {"c": torch.ones(3, 5, dtype=torch.int64),
                   "d": torch.tensor([True, False, True]),
                   "e": torch.zeros((0, 4), dtype=torch.float32),
                   "f": torch.tensor(2.5, dtype=torch.float64)}}
    host = hostmem.host_copy(parts, pinned=False)
    views = tensors(host)
    assert [v.dtype for v in views] == [t.dtype for t in tensors(parts)]
    assert all(torch.equal(v, t) and v.shape == t.shape
               for v, t in zip(views, tensors(parts)))
    assert all(v.data_ptr() % hostmem.ALIGN == 0 for v in views)
    assert arenas(host) == {views[0].untyped_storage().data_ptr():
                            aligned(views)}
    assert not any(v.is_pinned() for v in views)
    now = live()
    assert now["arenas"] == before["arenas"] + 1
    assert now["bytes"] == before["bytes"] + aligned(views)
    assert now["pinned_bytes"] == before["pinned_bytes"]
    keep = host["b"]["c"]
    del host, views
    assert live()["arenas"] == before["arenas"] + 1   # one view still held
    assert int(keep.sum()) == 15
    del keep
    assert live() == before


class FakeCudart:
    """``torch.cuda.cudart()`` of a card whose registrations answer
    ``err``."""

    def __init__(self, err):
        self.err, self.registered, self.unregistered = err, [], []

    def cudaHostRegister(self, ptr, size, flags):
        self.registered.append((ptr, size, flags))
        return self.err

    def cudaHostUnregister(self, ptr):
        self.unregistered.append(ptr)
        return 0

    def cudaGetErrorString(self, err):
        return "out of memory"


def test_pinned_arena_registers_and_unregisters(monkeypatch):
    fake = FakeCudart(0)
    monkeypatch.setattr(torch.cuda, "cudart", lambda: fake)
    before = live()
    view = hostmem.host_copy(torch.arange(1000, dtype=torch.int32),
                             pinned=True)
    ((ptr, size, _),) = fake.registered
    assert ptr == view.data_ptr() and size == 4096 == aligned([view])
    assert live()["pinned_bytes"] == before["pinned_bytes"] + 4096
    del view
    assert fake.unregistered == [ptr] and live() == before


def test_pinning_that_fails_raises_naming_the_bytes(monkeypatch):
    """No fallback: a registration the card refuses raises, and nothing is
    left allocated or counted."""
    fake = FakeCudart(2)
    monkeypatch.setattr(torch.cuda, "cudart", lambda: fake)
    before = live()
    with pytest.raises(RuntimeError, match="could not pin 4096 bytes"):
        hostmem.host_copy({"x": torch.ones(1000)}, pinned=True)
    assert live() == before and fake.unregistered == []


# ------------------------------------------------- the engine's demote ----
@pytest.mark.parametrize("kind", list(KINDS))
def test_demote_holds_two_arenas_freed_after_restore(bridged, jax_tokens,
                                                     kind):
    """Every tensor the demote ships is a view of the parameters' arena or
    of the other one, holding the device state bit for bit; the restore
    copies them back and, the host copy dropped, frees both; the context
    continues with the JAX engine's greedy tokens."""
    eng = InferenceEngine(fresh_model(bridged), device="cpu", **KINDS[kind])
    reqs = in_flight(eng)
    want = device_image(eng)
    before = live()
    host = eng.offload_device_state()
    params, rest = split(host)
    assert set(host) >= {"_rng", *want}
    assert all(got.dtype == w.dtype and torch.equal(got, w)
               for name, t in want.items()
               for got, w in zip(tensors(host[name]), tensors(t)))
    now = live()
    assert now["arenas"] == before["arenas"] + 2
    assert now["bytes"] == before["bytes"] + sum(params.values()) + sum(
        rest.values())
    assert not any(t.is_pinned() for t in tensors(host))
    eng.restore_device_state(host)
    # the engine holds copies, not views of the arenas
    assert not set(arenas({n: getattr(eng, n) for n in eng._state_fields})
                   ) & (params.keys() | rest.keys())
    del host
    assert live() == before
    eng.run_to_completion()
    assert [r.generated for r in reqs] == jax_tokens[kind]


@pytest.mark.parametrize("kind", list(KINDS))
def test_pool_counts_each_arena_once(bridged, jax_tokens, kind, tmp_path):
    """Through a ``Library`` over a ``SnapshotPool``: the snapshot and the
    pool count each arena once (the parameters' also while the released
    model keeps them); a spill frees the state's arena and leaves the
    parameters' counted; an engine built over the released model frees
    that one; the restore from disk continues with the JAX engine's
    tokens."""
    pool = SnapshotPool(spill_dir=str(tmp_path))
    lib = Library("w0", snapshots=pool)
    model = fresh_model(bridged)
    rec = make_recipe(f"arena {kind}", lambda: {"engine": InferenceEngine(
        model, device="cpu", **KINDS[kind])}, host_bytes=0)
    eng = lib.ensure(rec).value["engine"]
    reqs = in_flight(eng)
    before = live()
    snap = lib.demote(rec.key())
    host = snap.host_state["c0"]
    params, rest = split(host)
    assert model._released_params is host["params"]
    small = sum(a.nbytes for a in tree_leaves(host)
                if isinstance(a, (np.ndarray, np.generic)))
    assert snap.nbytes == sum(params.values()) + sum(rest.values()) + small
    st = pool.stats()
    assert st["host_used_bytes"] == snap.nbytes
    assert st["released_param_bytes"] == st["pinned_host_bytes"] == 0
    del host

    assert pool.spill(rec.key()) and pool.tier(rec.key()) == Tier.LOCAL_DISK
    st = pool.stats()
    assert st["host_used_bytes"] == st["released_param_bytes"] == sum(
        params.values())
    assert live() == dict(before, arenas=before["arenas"] + 1,
                          bytes=before["bytes"] + sum(params.values()))

    twin = InferenceEngine(model, device="cpu", **KINDS[kind])
    assert pool.stats()["host_used_bytes"] == 0 and live() == before
    assert twin.generate(prompts(), max_new_tokens=NEW) == jax_tokens[kind]

    assert lib.ensure(rec).value["engine"] is eng and not eng.offloaded
    eng.run_to_completion()
    assert [r.generated for r in reqs] == jax_tokens[kind]
    assert live() == before


def test_take_then_restore_frees_every_arena(bridged, jax_tokens, tmp_path):
    """A snapshot taken from the pool: the pool still counts the
    parameters the released model keeps; the restore takes them back and,
    the snapshot dropped, no arena is left."""
    pool = SnapshotPool(spill_dir=str(tmp_path))
    lib = Library("w0", snapshots=pool)
    model = fresh_model(bridged)
    rec = make_recipe("arena take", lambda: {"engine": InferenceEngine(
        model, device="cpu", **KINDS["slot"])}, host_bytes=0)
    eng = lib.ensure(rec).value["engine"]
    reqs = in_flight(eng)
    before = live()
    lib.demote(rec.key())
    snap = pool.take(rec.key())
    params, _ = split(snap.host_state["c0"])
    assert pool.stats()["host_used_bytes"] == sum(params.values())
    ctx = restore_context(snap)
    assert ctx.value["engine"] is eng and snap.host_state == {}
    del snap
    assert pool.stats()["host_used_bytes"] == 0 and live() == before
    eng.run_to_completion()
    assert [r.generated for r in reqs] == jax_tokens["slot"]


@pytest.mark.parametrize("kind", list(KINDS))
def test_template_export_holds_two_arenas(bridged, jax_tokens, kind):
    """``export_template`` (through ``export_context``, the PEER donor
    side) ships the weights in one arena and a pristine engine's state in
    another, counted once each in the snapshot's ``nbytes``; restored into
    the twin and dropped, both are freed, and the twin decodes as a fresh
    engine does."""
    model = fresh_model(bridged)
    ctx = materialize(make_recipe(f"arena export {kind}", lambda: {
        "engine": InferenceEngine(model, device="cpu", **KINDS[kind])}))
    donor = ctx.value["engine"]
    donor.generate(prompts(3, seed=5), max_new_tokens=2)
    before = live()
    snap = export_context(ctx)
    host = snap.host_state["c0"]
    params, rest = split(host)
    small = sum(a.nbytes for a in tree_leaves(host)
                if isinstance(a, (np.ndarray, np.generic)))
    assert snap.nbytes == sum(params.values()) + sum(rest.values()) + small
    for n, p in model.named_parameters():
        assert torch.equal(host["params"][n], p)
    assert live()["arenas"] == before["arenas"] + 2
    del host
    twin = restore_context(snap).value["engine"]
    del snap
    assert live() == before
    assert twin is not donor
    assert twin.generate(prompts(), max_new_tokens=NEW) == jax_tokens[kind]
