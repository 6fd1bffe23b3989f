"""The port's sharding plans against the reference's, with no processes:
``make_rules``, ``param_specs``, ``cache_specs`` and ``batch_specs`` of
``repro_torch.launch.sharding`` over the meta-device model equal
``repro.launch.sharding``'s over ``jax.eval_shape`` parameters, entry for
entry, for every architecture (Qwen3-MoE included), every shape suite and
four shape-only meshes; the reference's own rule checks
(tests/test_sharding_launch.py) in the port; ``shard``, ``placements``
and the mesh constructors' refusals.

A port parameter has no stacked layer axis, so its spec is held to the
trailing entries of the reference leaf it comes from (whose leading,
stacked entries are all None); parameters are matched by their path with
the layer indices taken out (the hybrid's ``groups``/``tail`` stacks are
the port's ``layers``). A port cache leaf stacks every layer on its first
axis; the reference stacks some leaves on one or two axes and keeps
others per layer, so cache leaves are matched by their per-layer shape.
"""

import math
import re
from functools import lru_cache

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ALL_ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import get_config as jax_full_config  # noqa: E402
from repro.launch import sharding as jshp  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import input_specs as jax_input_specs  # noqa: E402
from repro_torch.configs import ALL_ARCHS, ALL_SHAPES, SHAPES  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import sharding as shp  # noqa: E402
from repro_torch.models import input_specs  # noqa: E402
from repro_torch.models import sharding  # noqa: E402
from repro_torch.models.layers import dt  # noqa: E402
from repro_torch.models.registry import abstract_model  # noqa: E402


class FakeMesh:
    """Shape-only stand-in so rule logic is testable without 256 ranks."""

    def __init__(self, shape):
        self.shape = shape


class NamedFakeMesh:
    """A shape-only stand-in with a DeviceMesh's names and sizes."""

    def __init__(self, shape):
        self.mesh_dim_names = tuple(shape)
        self.shape = tuple(shape.values())
        self.ndim = len(shape)

    def size(self, i):
        return self.shape[i]


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x4": {"data": 2, "model": 4},
          "2x2": {"data": 2, "model": 2}}


def _norm(entry):
    """A spec entry compared by its axes: ("data",) is "data" (a
    ``PartitionSpec`` keeps a one-axis tuple as the bare name)."""
    if isinstance(entry, (list, tuple)):
        return entry[0] if len(entry) == 1 else tuple(entry)
    return entry


def _key(path: str, family: str) -> str:
    """A parameter's path with its layer indices taken out: the name both
    packages share for every layer's copy of it."""
    parts = [p for p in re.split(r"[./]", path) if not p.isdigit()]
    if family == "hybrid" and parts[0] in ("groups", "tail"):
        parts[0] = "layers"
    return ".".join(parts)


@lru_cache(maxsize=None)
def _ref_params(arch):
    model = jax_build(jax_full_config(arch))
    return model, jax.eval_shape(model.init, jax.random.PRNGKey(0))


@lru_cache(maxsize=None)
def _port_model(arch):
    return abstract_model(get_config(arch))


@lru_cache(maxsize=None)
def _ref_cache(arch, suite_name):
    model, _ = _ref_params(arch)
    s = SHAPES[suite_name]
    dtype = jnp.dtype(jax_full_config(arch).kv_cache_dtype)
    return jax.eval_shape(
        lambda: model.init_cache(s.global_batch, s.seq_len, dtype))


@lru_cache(maxsize=None)
def _port_cache(arch, suite_name):
    cfg, s = get_config(arch), SHAPES[suite_name]
    return _port_model(arch).init_cache(s.global_batch, s.seq_len,
                                        dt(cfg.kv_cache_dtype),
                                        device="meta")


def _by_key(flat, family):
    """{shared name: {(trailing shape, trailing spec)}} of (path, shape,
    spec) triples, the spec's leading stacked entries checked None."""
    out = {}
    for path, shape, spec, rank in flat:
        lead, tail = spec[:len(spec) - rank], spec[len(spec) - rank:]
        assert all(e is None for e in lead), (path, spec)
        out.setdefault(_key(path, family), set()).add(
            (tuple(shape[len(shape) - rank:]), tail))
    return out


def _ref_flat(tree, specs):
    paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    out = []
    for (path, leaf), spec in zip(paths, leaves):
        entries = tuple(_norm(e) for e in spec)
        entries += (None,) * (len(leaf.shape) - len(entries))
        out.append(("/".join(jshp._pp(p) for p in path), leaf.shape,
                    entries))
    return out


def test_registries_name_the_same_architectures():
    assert set(ALL_ARCHS) == set(JAX_ARCHS)
    assert [s.name for s in ALL_SHAPES] == list(SHAPES)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("suite_name", list(SHAPES))
@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_plans_equal_the_reference(arch, suite_name, mesh_name):
    """Rules, parameter specs, cache specs and batch specs of one (arch,
    suite, mesh) cell, entry for entry."""
    cfg, jcfg = get_config(arch), jax_full_config(arch)
    suite = SHAPES[suite_name]
    mesh = FakeMesh(MESHES[mesh_name])
    rules = shp.make_rules(cfg, mesh, suite)
    jrules = jshp.make_rules(jcfg, mesh, suite)
    assert {k: _norm(v) for k, v in rules.items()} == \
        {k: _norm(v) for k, v in jrules.items()}

    # parameters: the port's names and shapes against the reference's
    # paths, trailing entries equal
    _, p_abs = _ref_params(arch)
    jspecs = jshp.param_specs(p_abs, jcfg, mesh, jrules)
    model = _port_model(arch)
    specs = shp.param_specs(model, cfg, mesh, rules)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert set(specs) == set(shapes)
    port = _by_key([(n, shapes[n], tuple(_norm(e) for e in specs[n]),
                     len(shapes[n]))
                    for n in specs], cfg.family)
    ports_rank = {_key(n, cfg.family): len(s) for n, s in shapes.items()}
    ref = _by_key([(p, s, e, ports_rank[_key(p, cfg.family)])
                   for p, s, e in _ref_flat(p_abs, jspecs)], cfg.family)
    assert port == ref

    # caches: per-layer shapes and their specs
    B, S = suite.global_batch, suite.seq_len
    jc = _ref_cache(arch, suite_name)
    jcs = jshp.cache_specs(jc, jcfg, mesh, jrules, B, S)
    cache = _port_cache(arch, suite_name)
    cs = shp.cache_specs(cache, cfg, mesh, rules, B, S)
    port_c = {}
    for n, leaf in cache.items():
        port_c.setdefault(tuple(leaf.shape[1:]), set()).add(
            tuple(_norm(e) for e in cs[n][1:]))
    ref_c = {}
    for _, shape, spec in _ref_flat(jc, jcs):
        for tail_shape in port_c:
            r = len(tail_shape)
            if tuple(shape[len(shape) - r:]) == tail_shape:
                ref_c.setdefault(tail_shape, set()).add(spec[len(spec) - r:])
    assert port_c == ref_c

    # batches
    bs = shp.batch_specs(input_specs(cfg, suite), rules)
    jbs = jshp.batch_specs(jax_input_specs(jcfg, suite), jrules)
    assert {k: tuple(_norm(e) for e in v) for k, v in bs.items()} == \
        {k: tuple(_norm(e) for e in v) + (None,) * (len(bs[k]) - len(v))
         for k, v in jbs.items()}


# ------------------------------------- tests/test_sharding_launch.py's ----
def test_rules_divisibility_whisper():
    mesh = FakeMesh({"data": 16, "model": 16})
    rules = shp.make_rules(get_config("whisper-small"), mesh,
                           SHAPES["prefill_32k"])
    assert "heads" not in rules          # 12 heads do not shard 16-way
    assert rules.get("d_ff") == "model"  # 3072 does
    assert rules.get("vocab") == "model"


def test_rules_experts_qwen():
    mesh = FakeMesh({"data": 16, "model": 16})
    rules = shp.make_rules(get_config("qwen3-moe-235b-a22b"), mesh,
                           SHAPES["train_4k"])
    assert rules.get("experts") == "model"
    assert rules.get("heads") == "model"


def test_rules_batch_axes():
    mesh = FakeMesh({"pod": 2, "data": 16, "model": 16})
    r = shp.make_rules(get_config("stablelm-12b"), mesh, SHAPES["train_4k"])
    assert tuple(r["batch"]) == ("pod", "data")
    r = shp.make_rules(get_config("zamba2-7b"), mesh, SHAPES["long_500k"])
    assert "batch" not in r              # batch 1 cannot shard
    assert tuple(r["kv_seq"]) == ("pod", "model")


@pytest.mark.parametrize("arch", ["stablelm-12b", "whisper-small",
                                  "qwen3-moe-235b-a22b", "zamba2-7b",
                                  "deepseek-v2-lite-16b", "xlstm-350m"])
def test_param_specs_always_divisible(arch):
    """Every sharded parameter dim divides by its mesh extent."""
    cfg = get_config(arch)
    mesh = FakeMesh({"data": 16, "model": 16})
    rules = shp.make_rules(cfg, mesh, SHAPES["train_4k"])
    model = _port_model(arch)
    specs = shp.param_specs(model, cfg, mesh, rules)
    n_sharded = 0
    for name, p in model.named_parameters():
        assert len(specs[name]) == p.dim()
        for size, entry in zip(p.shape, specs[name]):
            if entry is None:
                continue
            n_sharded += 1
            ext = math.prod(mesh.shape[a] for a in
                            ((entry,) if isinstance(entry, str) else entry))
            assert size % ext == 0, (arch, name, p.shape, specs[name])
    assert n_sharded > 0 or arch == "xlstm-350m"


def test_qwen3_plan_fits_one_card_a_rank():
    """Under the (16, 16) plan Qwen3-MoE's 470 GB of bf16 weights come to
    under 80 GB a rank: experts 8 a rank, heads and vocab 16-way."""
    cfg = get_config("qwen3-moe-235b-a22b")
    mesh = FakeMesh({"data": 16, "model": 16})
    rules = shp.make_rules(cfg, mesh, SHAPES["train_4k"])
    model = _port_model("qwen3-moe-235b-a22b")
    specs = shp.param_specs(model, cfg, mesh, rules)
    total = sum(p.numel() * p.element_size() for p in model.parameters())
    per_rank = shp.bytes_per_rank(model, specs, mesh)
    assert total > 470e9 and per_rank < 80e9
    assert specs["layers.0.moe.experts.up"] == ("model", None, None)
    assert 128 // mesh.shape["model"] == 8


# ------------------------------------------------------ shard, placements --
def test_shard_noop_without_mesh():
    x = torch.ones((4, 8))
    assert sharding.shard(x, "batch", None) is x
    with sharding.sharding_rules(None, {"batch": "data"}):
        assert sharding.shard(x, "batch", None) is x
    with sharding.sharding_rules(NamedFakeMesh({"data": 2}), {}):
        assert sharding.shard(x, "batch", None) is x


def test_shard_raises_on_a_rank_mismatch():
    x = torch.ones((4, 8))
    with sharding.sharding_rules(NamedFakeMesh({"data": 2, "model": 2}),
                                 {"batch": "data"}):
        with pytest.raises(ValueError, match="rank 2 array got 3"):
            sharding.shard(x, "batch", None, None)


def test_logical_to_spec_drops_used_axes_and_places():
    from torch.distributed.tensor import Replicate, Shard
    mesh = NamedFakeMesh({"pod": 2, "data": 2, "model": 2})
    rules = {"batch": ("pod", "data"), "heads": "model",
             "kv_seq": ("pod", "model")}
    with sharding.sharding_rules(mesh, rules):
        spec = sharding.logical_to_spec(("batch", "kv_seq", "heads", None))
        assert spec == (("pod", "data"), "model", None, None)
        assert sharding.placements(spec, mesh) == (Shard(0), Shard(0),
                                                   Shard(1))
        assert sharding.axis_size("batch") == 4
        assert sharding.axis_size("vocab") == 1
    assert sharding.placements((None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    assert sharding.same_layout((Shard(0), Replicate()),
                                (Replicate(), Replicate()),
                                NamedFakeMesh({"data": 1, "model": 2}))
    assert not sharding.same_layout((Shard(0), Replicate()),
                                    (Replicate(), Replicate()),
                                    NamedFakeMesh({"data": 2, "model": 2}))


def test_production_mesh_refuses_a_small_world():
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        tmesh.make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        tmesh.make_host_mesh(2, 2, device_type="cpu")
