"""The port's roofline (``repro_torch.launch.roofline``) and perf harness
overrides against the reference's: the same analytic FLOPs and bytes for
every (arch, shape) of the full configs, the same rows and table from the
same artifacts once the port's H100 constants are swapped for the
reference's v5e ones, and the same ``--set`` parsing."""

import json

import pytest

torch = pytest.importorskip("torch")

from repro.configs import ALL_ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch import roofline as ref_roofline  # noqa: E402
from repro_torch.configs import ALL_ARCHS, SHAPES, get_config  # noqa: E402
from repro_torch.launch import perf, roofline  # noqa: E402


def test_registries_match():
    assert set(ALL_ARCHS) == set(REF_ARCHS)
    assert set(SHAPES) == set(REF_SHAPES)


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
@pytest.mark.parametrize("shape", sorted(REF_SHAPES))
def test_analytic_terms_equal_the_reference(arch, shape):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    suite, ref_suite = SHAPES[shape], REF_SHAPES[shape]
    assert roofline.model_flops(cfg, suite) == \
        ref_roofline.model_flops(ref_cfg, ref_suite)
    assert roofline.analytic_min_bytes(cfg, suite) == \
        ref_roofline.analytic_min_bytes(ref_cfg, ref_suite)


def test_h100_constants_and_chips():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.ICI_BW == 50e9
    for mesh, n in ref_roofline.CHIPS.items():
        assert roofline.chips(mesh) == n
    assert roofline.chips("1x1") == 1


def _artifacts():
    """Synthetic dry-run artifacts of every kind ``cell_roofline`` and
    ``format_table`` tell apart."""
    full = {"arch": "granite-3-2b", "shape": "decode_32k", "mesh": "16x16",
            "kind": "decode", "ok": True,
            "cost_unrolled": {"flops": 2.345e12, "bytes_accessed": 7.5e14},
            "collectives": {"extrapolated_total_bytes": 2.1e10,
                            "by_kind": {"all-gather": 2.0e10,
                                        "all-reduce": 1.0e9}}}
    train = dict(full, arch="stablelm-12b", shape="train_4k", kind="train",
                 mesh="2x16x16",
                 cost_unrolled={"flops": 3.1e18, "bytes_accessed": 2e16},
                 collectives={"extrapolated_total_bytes": 4e9,
                              "by_kind": {"all-reduce": 4e9}})
    prefill = dict(full, arch="deepseek-v2-lite-16b", shape="prefill_32k",
                   kind="prefill",
                   cost_unrolled={"flops": 1.8e16, "bytes_accessed": 1e15},
                   collectives={"extrapolated_total_bytes": 2.2e10,
                                "by_kind": {"all-reduce": 2.2e10}})
    long = dict(full, arch="zamba2-7b", shape="long_500k",
                cost_unrolled={"flops": 1.7e12, "bytes_accessed": 1e13})
    xlstm = dict(full, arch="xlstm-350m", mesh="2x16x16",
                 collectives={"extrapolated_total_bytes": 8e5,
                              "by_kind": {"all-gather": 8e5}})
    gate = {"arch": "whisper-small", "shape": "train_4k", "mesh": "16x16",
            "kind": "train", "ok": True}
    skip = {"arch": "stablelm-12b", "shape": "long_500k", "mesh": "16x16",
            "kind": "decode", "ok": True, "skipped": True,
            "skip_reason": "full-attention arch: 500k decode would hold a "
                           "quadratic-cost KV cache"}
    fail = {"arch": "qwen3-moe-235b-a22b", "shape": "train_4k",
            "mesh": "16x16", "kind": "train", "ok": False,
            "error": "RuntimeError: something went wrong in the cell"}
    return {"full": full, "train": train, "prefill": prefill, "long": long,
            "xlstm": xlstm, "gate": gate, "skip": skip, "fail": fail}


@pytest.fixture
def v5e(monkeypatch):
    """The port's roofline with the reference's TPU v5e constants."""
    monkeypatch.setattr(roofline, "PEAK_FLOPS", ref_roofline.PEAK_FLOPS)
    monkeypatch.setattr(roofline, "HBM_BW", ref_roofline.HBM_BW)
    monkeypatch.setattr(roofline, "ICI_BW", ref_roofline.ICI_BW)


@pytest.mark.parametrize("name", sorted(_artifacts()))
def test_cell_roofline_equals_the_reference_at_v5e(v5e, name):
    art = _artifacts()[name]
    assert roofline.cell_roofline(art) == ref_roofline.cell_roofline(art)


def test_cell_roofline_uses_the_h100():
    art = _artifacts()["prefill"]
    row = roofline.cell_roofline(art)
    assert row["compute_s"] == pytest.approx(1.8e16 / (256 * 989e12))
    assert row["collective_s"] == pytest.approx(2.2e10 / 50e9)
    assert row["step_seconds_bound"] == max(
        row["compute_s"], row["memory_s"], row["collective_s"])


def test_load_and_format_table_equal_the_reference(v5e, tmp_path):
    for name, art in _artifacts().items():
        (tmp_path / f"{name}.json").write_text(json.dumps(art))
    rows = roofline.load_table(str(tmp_path))
    assert rows == ref_roofline.load_table(str(tmp_path))
    assert roofline.format_table(rows) == ref_roofline.format_table(rows)
    assert len(roofline.format_table(rows).splitlines()) == 2 + len(rows)


@pytest.mark.parametrize("pairs", [
    [], ["kv_update=mask"], ["use_kernels=1"], ["capacity_factor=1.25"],
    ["n_layers=4", "remat=full"], ["rope_theta=1e6"], ["name=a=b"]])
def test_parse_overrides_equals_the_reference(pairs):
    assert perf.parse_overrides(pairs) == _reference_parse(pairs)


def _reference_parse(pairs):
    """The reference's ``parse_overrides``, read from its source: importing
    ``repro.launch.perf`` would set XLA_FLAGS in this process."""
    import ast
    from pathlib import Path
    src = (Path(ref_roofline.__file__).parent / "perf.py").read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef)
              and n.name == "parse_overrides")
    scope: dict = {}
    exec(compile(ast.Module([fn], []), "perf.py", "exec"), scope)
    return scope["parse_overrides"](pairs)
