"""Pervasive Context Management for the model families whose device state
differs most from a dense decoder's, through the port's runtime on the
CPU, against the JAX package (reduced configs, f32, the same bridged
weights): DeepSeek-V2-Lite's MLA latent and rope pages (paged pool) or
rows (slot cache) and its experts, Zamba2's f32 SSM and conv states beside
the shared block's K/V, and the VLM's cross-attention K/V over its patches
and ``extra``.

* Each family: a context is built by a ``Library`` over a ``SnapshotPool``,
  served until requests are decoding and queued, demoted mid-stream,
  spilled to LOCAL_DISK and promoted again by a ``streamed=True`` library
  (stages ``disk`` and ``h2d``, no builder call). Its cache leaves, per-slot
  state and ``extra`` come back bit for bit, and it continues with the
  JAX engine's greedy tokens, at megastep 1 and 4.
* The pool's host budget counts the parameters' arena a released model
  keeps in host RAM (``InferenceEngine.offload_device_state`` releases
  the last engine's model in place): once with the HOST_RAM snapshot that
  holds them, still after its spill, and enough to spill the LRU
  snapshot.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced_config as jax_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serving import InferenceEngine as JaxEngine  # noqa: E402
from repro_torch import hostmem  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.core import (Library, SnapshotPool, Tier,  # noqa: E402
                              make_recipe)
from repro_torch.models import build_model, extra_inputs  # noqa: E402
from repro_torch.serving import InferenceEngine, Request  # noqa: E402
from repro_torch.serving import paged as paging  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

DEEPSEEK, ZAMBA, VISION = ("deepseek-v2-lite-16b", "zamba2-7b",
                           "llama-3.2-vision-11b")
# the VLM's K/V heads cut to 2, so its cross-attention is grouped
OVERRIDES = {VISION: dict(n_kv_heads=2)}
ENGINE = dict(slots=2, cache_len=32, prefill_buckets=(16,))
PAGED = dict(paged=True, page_size=8, prefix_sharing=False)
FAMILIES = {"deepseek-paged": (DEEPSEEK, PAGED),
            "deepseek-slot": (DEEPSEEK, {}), "zamba2": (ZAMBA, {}),
            "vision": (VISION, {})}
NEW = 9


def prompts(n=5, seed=11):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(8, 512, size=rng.randint(3, 16)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def bridged():
    """{arch: (the port's config with the kernels (on the CPU their plain
    versions), its state dict bridged from the reference's params, the
    frontend inputs as numpy, the reference model and params)}; the VLM's
    gates at 1.0, or its cross blocks add nothing."""
    out = {}
    for arch in (DEEPSEEK, ZAMBA, VISION):
        over = OVERRIDES.get(arch, {})
        jm = jax_build(jax_config(arch, **over))
        params = jm.init(jax.random.PRNGKey(0))
        if arch == VISION:
            for gate in ("gate_attn", "gate_mlp"):
                params["cross"][gate] = jnp.ones_like(params["cross"][gate])
        cfg = get_reduced_config(arch, use_kernels=True, **over)
        rng = np.random.RandomState(3)
        extra = {n: rng.standard_normal(t.shape).astype(np.float32)
                 for n, t in extra_inputs(cfg, ENGINE["slots"]).items()}
        out[arch] = (cfg, from_jax_params(jax.device_get(params), cfg, "cpu"),
                     extra, jm, params)
    return out


@pytest.fixture(scope="module")
def jax_tokens(bridged):
    """The reference engine's greedy tokens for ``prompts()``, per family
    (the paged pool's from the reference's paged engine)."""
    out = {}
    for family, (arch, kw) in FAMILIES.items():
        _, _, extra, jm, params = bridged[arch]
        eng = JaxEngine(jm, params, megastep=4, **ENGINE, **kw,
                        extra={n: jnp.asarray(a) for n, a in extra.items()}
                        or None)
        out[family] = eng.generate(prompts(), max_new_tokens=NEW)
    return out


def device_image(eng):
    """Clones of what a demote ships and a restore must bring back: the
    cache (a paged pool's live pages), the per-slot state and ``extra``."""
    cache = eng.cache
    if eng._paged:
        cache = paging.gather_live(eng.cache, torch.as_tensor(
            eng._alloc.live_ids(), dtype=torch.int64))
    out = {f"cache/{n}": t.clone() for n, t in cache.items()}
    out.update({n: getattr(eng, n).clone() for n in eng._state_fields})
    out.update({f"extra/{n}": t.clone()
                for n, t in (eng.extra or {}).items()})
    return out


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_midstream_demote_through_disk_continues_as_reference(
        bridged, jax_tokens, family, K, tmp_path):
    arch, kw = FAMILIES[family]
    cfg, state, extra, _, _ = bridged[arch]
    builds = []

    def build():
        builds.append(1)
        return {"engine": InferenceEngine(
            build_model(cfg, device="cpu", params=state), device="cpu",
            megastep=K, **ENGINE, **kw,
            extra={n: torch.from_numpy(a) for n, a in extra.items()}
            or None)}

    pool = SnapshotPool(spill_dir=str(tmp_path))
    lib = Library("w0", snapshots=pool, streamed=True)
    rec = make_recipe(f"pcm-{family}-{K}", build, host_bytes=0)
    eng = lib.ensure(rec).value["engine"]
    assert eng._paged == bool(kw)
    reqs = [eng.submit(Request(prompt=list(p), max_new_tokens=NEW))
            for p in prompts()]
    eng.step()                                     # prefill + one megastep
    assert eng.queue and all(0 < len(r.generated) < NEW
                             for r in eng.active.values())
    before = device_image(eng)
    lib.demote(rec.key())
    assert eng.offloaded and all(p.numel() == 0
                                 for p in eng.model.parameters())
    assert pool.spill(rec.key()) and pool.tier(rec.key()) == Tier.LOCAL_DISK
    ctx = lib.ensure(rec)
    assert ctx.value["engine"] is eng and builds == [1]
    assert set(ctx.stage_seconds) == {"disk", "h2d"}
    assert not list(tmp_path.iterdir())            # the spill was consumed
    after = device_image(eng)
    assert set(after) == set(before)
    for name, t in before.items():
        assert after[name].dtype == t.dtype and torch.equal(after[name], t), \
            name
    if arch == ZAMBA:
        assert after["cache/ssm"].dtype == torch.float32
    while eng.has_work():
        eng.step()
    assert [r.generated for r in reqs] == jax_tokens[family]


# ------------------------------------ the pool's host budget, released ----


class HostState:
    """An offloadable component of 8028 bytes of host state, with no
    model behind it."""

    def __init__(self):
        self.weights = torch.arange(1000, dtype=torch.float64)
        self.ids = np.arange(7, dtype=np.int32)

    def offload_device_state(self):
        state = {"weights": self.weights, "ids": self.ids}
        self.weights = self.ids = None
        return state

    def restore_device_state(self, host_state):
        self.weights, self.ids = host_state["weights"], host_state["ids"]


@pytest.fixture(scope="module")
def smol_state():
    cfg = get_reduced_config("smollm2-1.7b")
    return cfg, dict(build_model(cfg, device="cpu", seed=0).state_dict())


def engine_recipe(smol_state, name):
    """A context of one engine over a model of its own (the last engine
    over it: its demote releases the parameters in place), and the bytes
    of the host arena its demote copies the parameters into (each one's
    bytes rounded up to the arena's alignment)."""
    cfg, state = smol_state
    model = build_model(cfg, device="cpu", params=state)
    weights = sum(-(-p.numel() * p.element_size() // hostmem.ALIGN)
                  * hostmem.ALIGN for p in model.parameters())
    return make_recipe(name, lambda: {"engine": InferenceEngine(
        model, device="cpu", **ENGINE)}, host_bytes=0), model, weights


def test_pool_counts_released_parameters_once(smol_state, tmp_path):
    pool = SnapshotPool(spill_dir=str(tmp_path))
    lib = Library("w0", snapshots=pool)
    rec, model, weights = engine_recipe(smol_state, "released")
    lib.ensure(rec).value["engine"].generate(prompts(3), max_new_tokens=3)
    snap = lib.demote(rec.key())
    assert all(p.numel() == 0 for p in model.parameters())
    assert model._released_params is snap.host_state["c0"]["params"]
    st = pool.stats()
    # the released parameters are the HOST_RAM snapshot's own: once
    assert st["host_used_bytes"] == snap.nbytes > weights
    assert st["released_param_bytes"] == 0
    assert pool.spill(rec.key())
    st = pool.stats()
    # spilled: the KV store and the slot state left host RAM, the
    # parameters did not (the model keeps them)
    assert st["disk_used_bytes"] == snap.nbytes
    assert st["host_used_bytes"] == st["released_param_bytes"] == weights
    lib.ensure(rec)             # restored into its model, which drops them
    assert "_released_params" not in model.__dict__
    assert pool.stats()["host_used_bytes"] == 0


def test_pool_spills_lru_for_released_parameters(smol_state, tmp_path):
    """A host budget exceeded only through a released model's parameters
    (its own snapshot on disk) spills the LRU HOST_RAM snapshot, as a
    snapshot of their size at HOST_RAM would make it, and no more."""
    rec, _, weights = engine_recipe(smol_state, "pinned")
    small = 8028
    pool = SnapshotPool(host_bytes=weights + small + 100,
                        spill_dir=str(tmp_path))
    lib = Library("w0", snapshots=pool)
    lib.ensure(rec)
    lib.demote(rec.key())
    # over the budget by its KV store and slot state: it spills itself,
    # which frees those and leaves the parameters in host RAM
    assert pool.tier(rec.key()) == Tier.LOCAL_DISK
    assert pool.stats()["host_used_bytes"] == weights
    recs = [make_recipe(n, HostState, host_bytes=0) for n in ("b", "c")]
    for r in recs:
        lib.ensure(r)
    lib.demote(recs[0].key())
    assert pool.tier(recs[0].key()) == Tier.HOST_RAM
    assert pool.stats()["host_used_bytes"] == weights + small
    lib.demote(recs[1].key())                     # over by the released
    assert pool.tier(recs[0].key()) == Tier.LOCAL_DISK
    assert pool.tier(recs[1].key()) == Tier.HOST_RAM
    st = pool.stats()
    assert st["spills"] == 2 and st["lost"] == 0
    assert st["host_used_bytes"] == weights + small <= pool.host_bytes
