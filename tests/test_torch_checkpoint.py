"""The port's checkpoint IO against the JAX reference's: each package reads
the other's files bit for bit (f32, int32 and bf16 leaves, plain and
chunked), the two write byte-identical payloads and manifests, a flipped
byte is caught and named, the CheckpointManager cases of
tests/test_checkpoint.py hold in the port, and a reduced SmolLM2 params
tree saved by the reference's CheckpointManager serves in the port with
the reference's logits and greedy tokens."""

import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import CheckpointManager as JaxManager  # noqa: E402
from repro.checkpoint import io as jio  # noqa: E402
from repro.configs import get_reduced_config as jax_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serving import InferenceEngine as JaxEngine  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint import io as tio  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.launch.serve import load_params  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import InferenceEngine  # noqa: E402

TOL = 2e-4      # fp32 logits, tests/test_kernels.py


def _values(seed=0):
    rng = np.random.RandomState(seed)
    return {"a": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal((20, 4, 2)).astype(np.float32),
            "ids": rng.randint(-50, 50, size=(20,)).astype(np.int32),
            "s": np.float32(rng.standard_normal())}


def jax_tree(v):
    return {"a": jnp.asarray(v["a"]),
            "b": {"c": jnp.asarray(v["b"], jnp.bfloat16),
                  "d": [jnp.int32(3), jnp.asarray(v["ids"])]},
            "e": jnp.asarray(v["s"], jnp.bfloat16),
            "f": (jnp.asarray(v["b"]),)}


def torch_tree(v):
    return {"a": torch.from_numpy(v["a"]),
            "b": {"c": torch.from_numpy(v["b"]).to(torch.bfloat16),
                  "d": [torch.tensor(3, dtype=torch.int32),
                        torch.from_numpy(v["ids"])]},
            "e": torch.tensor(v["s"]).to(torch.bfloat16),
            "f": (torch.from_numpy(v["b"]),)}


CHUNKINGS = {"plain": None,
             "chunked": {"b": 8, "f": {"rows": 3, "axis": 1},
                         "a": {"rows": 4, "axis": 0}}}


def _bits(x):
    """A leaf's raw bytes with its dtype name, whichever package it is
    from."""
    if isinstance(x, torch.Tensor):
        return tio.dtype_name(x), tio.to_numpy(x).tobytes()
    a = np.asarray(x)
    return str(a.dtype), a.tobytes()


def _leaves(tree):
    return [leaf for _, leaf in tio.tree_flatten(tree)[0]]


@pytest.mark.parametrize("chunking", sorted(CHUNKINGS))
def test_port_reads_reference_checkpoint_bit_equal(tmp_path, chunking):
    v = _values()
    path = str(tmp_path / "ck")
    jio.save_pytree(jax_tree(v), path, extra_meta={"step": 7},
                    chunk_rows=CHUNKINGS[chunking])
    got, meta = tio.load_pytree(path, like=torch_tree(v))
    assert meta["step"] == 7
    want = jax.tree_util.tree_leaves(jax_tree(v))
    assert [_bits(x) for x in _leaves(got)] == [_bits(x) for x in want]
    assert got["b"]["c"].dtype == torch.bfloat16
    assert isinstance(got["f"], tuple)
    nested, _ = tio.load_pytree(path)
    assert _bits(nested["b"]["d"]["[1]"]) == _bits(v["ids"])
    assert _bits(nested["e"]) == _bits(jax_tree(v)["e"])


@pytest.mark.parametrize("chunking", sorted(CHUNKINGS))
def test_reference_reads_port_checkpoint_bit_equal(tmp_path, chunking):
    v = _values(1)
    path = str(tmp_path / "ck")
    tio.save_pytree(torch_tree(v), path, extra_meta={"step": 3},
                    chunk_rows=CHUNKINGS[chunking])
    got, meta = jio.load_pytree(path, like=jax_tree(v))
    assert meta["step"] == 3
    assert [_bits(x) for x in jax.tree_util.tree_leaves(got)] == \
        [_bits(x) for x in _leaves(torch_tree(v))]
    assert str(got["b"]["c"].dtype) == "bfloat16"
    if chunking == "chunked":
        for key, n in (("b/c", 3), ("f/[0]", 2)):
            jc, jspec = jio.load_chunks(path, key)
            tc, tspec = tio.load_chunks(path, key)
            assert jspec == tspec and len(jc) == len(tc) == n
            assert [_bits(x) for x in jc] == [_bits(x) for x in tc]


@pytest.mark.parametrize("chunking", sorted(CHUNKINGS))
def test_manifests_and_payloads_are_identical(tmp_path, chunking):
    v = _values(2)
    jio.save_pytree(jax_tree(v), str(tmp_path / "j"),
                    chunk_rows=CHUNKINGS[chunking])
    tio.save_pytree(torch_tree(v), str(tmp_path / "t"),
                    chunk_rows=CHUNKINGS[chunking])
    man = [json.loads((tmp_path / d / "manifest.json").read_text())
           for d in ("j", "t")]
    for field in ("keys", "dtypes", "shapes", "chunks", "entry_sha256",
                  "nbytes", "sha256"):
        assert man[0][field] == man[1][field], field
    assert man[0]["dtypes"]["b/c"] == "bfloat16"
    assert (tmp_path / "j" / "arrays.npz").read_bytes() == \
        (tmp_path / "t" / "arrays.npz").read_bytes()
    jm, jp = jio.pack_tree(jax_tree(v), chunk_bytes=64)
    tm, tp = tio.pack_tree(torch_tree(v), chunk_bytes=64)
    assert jm == tm and jp == tp
    back = tio.unpack_tree(jm, jp)
    assert _bits(back["b/c"]) == _bits(torch_tree(v)["b"]["c"])


@pytest.mark.parametrize("chunking", sorted(CHUNKINGS))
def test_flipped_byte_raises_naming_the_entry(tmp_path, chunking):
    v = _values(3)
    path = str(tmp_path / "ck")
    tio.save_pytree(torch_tree(v), path, chunk_rows=CHUNKINGS[chunking])
    entry = "b/c#chunk00001" if chunking == "chunked" else "b/c"
    offset, size = tio._npz_raw_members(os.path.join(path, "arrays.npz"))[
        entry]
    with open(os.path.join(path, "arrays.npz"), "r+b") as f:
        f.seek(offset + size - 1)        # the entry's last data byte
        byte = f.read(1)[0]
        f.seek(offset + size - 1)
        f.write(bytes([byte ^ 0xFF]))
    assert not tio.is_valid(path)
    with pytest.raises(tio.ChunkCorruptionError, match="'b/c'") as err:
        list(tio.iter_entries(path))
    assert ("chunk 1 " if chunking == "chunked" else "chunk 0 ") in \
        str(err.value)
    with pytest.raises(jio.ChunkCorruptionError, match="'b/c'"):
        list(jio.iter_entries(path))
    with pytest.raises(FileNotFoundError):
        tio.load_pytree(path)


def _manager_case(kind, d):
    """The CheckpointManager cases of tests/test_checkpoint.py, on the
    port: rotation + latest, an invalid latest skipped, restore_or_init."""
    def state(x):
        return {"x": torch.tensor(float(x))}

    if kind == "rotation_and_latest":
        m = CheckpointManager(d, keep=2)
        for s in (10, 20, 30, 40):
            m.save(s, state(s))
        assert m.steps() == [30, 40]
        restored, _ = m.restore(like=state(0))
        assert float(restored["x"]) == 40.0
    elif kind == "skips_invalid_latest":
        m = CheckpointManager(d, keep=5)
        m.save(10, state(10))
        m.save(20, state(20))
        with open(os.path.join(d, "step_0000000020", "arrays.npz"),
                  "w") as f:
            f.write("partial")
        assert m.latest_step() == 10
        restored, _ = m.restore(like=state(0))
        assert float(restored["x"]) == 10.0
    else:
        m = CheckpointManager(d)
        restored, step = m.restore_or_init(state(-1))
        assert step == 0 and float(restored["x"]) == -1
        m.save(5, state(5))
        restored, step = m.restore_or_init(state(-1))
        assert step == 5 and float(restored["x"]) == 5
        # the reference's manager resumes from the port's checkpoint
        jstate, jstep = JaxManager(d).restore_or_init(
            {"x": jnp.float32(-1)})
        assert jstep == 5 and float(jstate["x"]) == 5.0


@pytest.mark.parametrize("kind", ["rotation_and_latest",
                                  "skips_invalid_latest", "restore_or_init"])
def test_checkpoint_manager_cases(tmp_path, kind):
    _manager_case(kind, str(tmp_path))


def _prompts(n, seed=0, vocab=512):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(8, vocab, size=rng.randint(3, 14)))
            for _ in range(n)]


def test_reference_checkpoint_serves_in_the_port(tmp_path):
    jcfg = jax_config("smollm2-1.7b")
    jmodel = jax_build(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    JaxManager(str(tmp_path)).save(100, params)

    tcfg = get_reduced_config("smollm2-1.7b")
    tmodel = build_model(tcfg, device="cpu",
                         params=load_params(str(tmp_path), tcfg,
                                            torch.device("cpu")))
    toks = np.random.RandomState(0).randint(8, 512, size=(2, 12)) \
        .astype(np.int32)
    exp, _ = jmodel.forward(params, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        out = tmodel.forward(torch.from_numpy(toks))
    err = float(np.max(np.abs(np.asarray(exp, np.float32)
                              - out.float().numpy())))
    assert err < TOL, err

    kw = dict(slots=4, cache_len=64, prefill_buckets=(16, 32))
    want = JaxEngine(jmodel, params, **kw).generate(_prompts(6),
                                                    max_new_tokens=6)
    got = InferenceEngine(tmodel, device="cpu", **kw).generate(
        _prompts(6), max_new_tokens=6)
    assert got == want
