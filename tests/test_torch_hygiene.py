"""Boundaries of the PyTorch port: it imports nothing of JAX, of the JAX
package or of ``ml_dtypes`` (the card's machine has no JAX), and its entry
points refuse to run on the CPU unless asked to."""

import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import InferenceEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "repro", "ml_dtypes"), \
            f"{path.name} imports {name}"


def test_port_file_list_is_complete():
    names = {p.name for p in PORT_FILES}
    assert {"engine.py", "attention.py", "transformer.py", "moe.py",
            "ops.py", "moe_gemm.py", "build.py", "weights.py", "ssm.py",
            "hybrid.py", "ssm_scan.py", "chip_smoke.py", "io.py",
            "context.py", "scheduler.py", "manager.py", "serve.py",
            "wire.py", "transport.py", "node.py", "devices.py", "events.py",
            "traces.py", "simulator.py", "session.py",
            "frontdoor.py", "pipeline.py", "shapes.py", "optimizer.py",
            "trainstep.py", "loop.py", "train.py", "granite_3_2b.py",
            "h2o_danube_1_8b.py", "stablelm_12b.py",
            "nemotron_4_15b.py", "xlstm.py", "encdec.py", "vision.py",
            "xlstm_350m.py", "whisper_small.py",
            "llama32_vision_11b.py", "dryrun.py", "hlo.py", "roofline.py",
            "perf.py"} <= names


def test_every_kernel_has_its_source():
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").exists()
        assert build.library_path(name) == build.library_path(name)
        assert build.library_path(name).parent == build.BUILD_DIR


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced_config("smollm2-1.7b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg, device="cuda")
    model = build_model(cfg, device="cpu")
    assert model.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(model, paged=True)
    eng = InferenceEngine(model, device="cpu", slots=1, cache_len=16)
    assert eng.device.type == "cpu"
    eng = InferenceEngine(model, device="cpu", slots=1, cache_len=16,
                          paged=True, page_size=4)
    assert eng.device.type == "cpu" and eng.page_table.device.type == "cpu"


def test_engine_refuses_a_model_on_another_device():
    model = build_model(get_reduced_config("smollm2-1.7b"), device="cpu")
    with pytest.raises(ValueError):
        InferenceEngine(model, device="meta")


def test_unported_architectures_name_their_slice(monkeypatch):
    """Every reference id has its config; the one architecture no card
    holds is refused where it would be allocated (here a device of one
    H100's 80 GB), saying why and naming the sharded path that plans it
    instead."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    monkeypatch.setattr(registry, "_device_bytes", lambda dev: 80 * 10**9)
    qwen = get_config("qwen3-moe-235b-a22b")
    with pytest.raises(ValueError, match="launch.steps"):
        build_model(qwen, device="cpu")
    with pytest.raises(ValueError, match="does not fit one card"):
        build_model(qwen, device="cpu")
    with pytest.raises(KeyError):
        get_config("no-such-model")
    assert get_config("deepseek-v2-lite-16b").family == "moe"
    assert get_config("zamba2-7b").family == "hybrid"
    assert get_config("xlstm-350m").family == "ssm"
    assert get_config("whisper-small").family == "audio"
    assert get_config("llama-3.2-vision-11b").family == "vlm"


def test_runtime_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.build_context("smollm2-1.7b", 2, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--claims", "4"])
    ctx = serve.build_context("smollm2-1.7b", 2, 32, device="cpu")
    assert ctx["engine"].device.type == "cpu"
