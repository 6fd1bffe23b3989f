"""The port's dry-run (``repro_torch.launch.{mesh,hlo,dryrun,perf}``) on the
CPU, over fake tensors on fake worlds of a few ranks: the collective
counter's bytes by kind, rank 0's memory, FLOPs on one rank against
``FlopCounterMode`` over the unsharded model, ``run_cell`` on a 2 x 4
world for a reduced arch of each family (DeepSeek's MLA train and prefill
cells among them), the probes' per-layer bytes against the measured
total, the skip records against the reference's, and the kernel entry
points refusing fake tensors."""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES,  # noqa: E402
                                 get_config, get_reduced_config)
from repro_torch.configs.shapes import ShapeSuite  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun, hlo, perf, steps  # noqa: E402
from repro_torch.launch.mesh import (fake_world, make_host_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.launch.sharding import make_rules  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# the reference's test_small_mesh_end_to_end config: heads shard 4 ways
GRANITE = dict(n_heads=8, n_kv_heads=4, head_dim=16, d_model=128, d_ff=256,
               vocab_size=512, vocab_pad_to=128)


# --------------------------------------------------------------- mesh ------
def test_fake_world_builds_the_production_meshes():
    with fake_world(256, "cpu") as n:
        assert n == 256 and dist.get_backend() == "fake"
        mesh = make_production_mesh(device_type="cpu")
        assert tuple(mesh.shape) == (16, 16)
        assert mesh.mesh_dim_names == ("data", "model")
    assert not dist.is_initialized()
    with fake_world(512, "cpu"):
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        assert tuple(mesh.shape) == (2, 16, 16)
    assert not dist.is_initialized()


def test_fake_world_refuses_a_second_group_and_a_missing_card(monkeypatch):
    with fake_world(4, "cpu"):
        with pytest.raises(RuntimeError, match="'fake', 4 ranks"):
            with fake_world(4, "cpu"):
                pass
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with fake_world(4, "cuda"):
            pass
    assert not dist.is_initialized()


# ------------------------------------------------------- collectives -------
def _mesh4():
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", (4,), mesh_dim_names=("x",))


def test_collective_bytes_by_kind_on_a_fake_mesh():
    """Known redistributions on 4 ranks, each sized by its result: a
    gather of an (8, 16) f32 Shard(0) (512 bytes received), a Partial
    reduced to Replicate (128), a Partial reduced to Shard(0) (32, the
    shard), an all-to-all of 64 bytes; wait_tensor is not counted."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import (Partial, Replicate, Shard,
                                          distribute_tensor)
    with fake_world(4, "cpu"):
        mesh = _mesh4()
        with FakeTensorMode(allow_non_fake_inputs=True):
            x = distribute_tensor(torch.randn(8, 16), mesh, [Shard(0)])
            xs1 = distribute_tensor(torch.randn(8, 16), mesh, [Shard(1)])
            w = distribute_tensor(torch.randn(16, 4), mesh, [Shard(0)])
            loc = torch.randn(16)

            def fn():
                a = x.redistribute(mesh, [Replicate()])
                p = xs1 @ w                                    # Partial
                assert p.placements == (Partial(),)
                r = p.redistribute(mesh, [Replicate()])
                s = (xs1 @ w).redistribute(mesh, [Shard(0)])
                t = funcol.all_to_all_single(loc, None, None, mesh)
                return a, r, s, t
            _, c = hlo.run_counted(fn, ())
    assert hlo.collective_bytes(c) == {
        "all-gather": 512, "all-reduce": 128, "reduce-scatter": 32,
        "all-to-all": 64, "total": 512 + 128 + 32 + 64}
    assert hlo.count_ops(c.log, "all_gather_into_tensor") == 1
    assert hlo.count_ops(c.log, "wait_tensor") == 0
    assert hlo.count_ops(c.log, "aten.mm") == 2


def test_a_partial_reduced_inside_an_ops_dispatch_is_counted():
    """relu of a Partial: DTensor all-reduces it inside relu's own
    dispatch, which a plain dispatch mode never sees; the counter does,
    and counts the local matmul at the shard's shape."""
    from torch.distributed.tensor import Shard, distribute_tensor
    with fake_world(4, "cpu"):
        mesh = _mesh4()
        with FakeTensorMode(allow_non_fake_inputs=True):
            xs1 = distribute_tensor(torch.randn(8, 16), mesh, [Shard(1)])
            w = distribute_tensor(torch.randn(16, 4), mesh, [Shard(0)])
            _, c = hlo.run_counted(lambda: torch.relu(xs1 @ w), ())
    assert hlo.collective_bytes(c) == {"all-reduce": 8 * 4 * 4,
                                       "total": 8 * 4 * 4}
    assert c.flops == 2 * 8 * 4 * 4             # (8, 4) @ (4, 4) on rank 0
    assert hlo.cost_stats(c, 4) == {"flops": 4.0 * c.flops,
                                    "bytes_accessed": 4.0 * c.bytes_accessed,
                                    "flops_per_rank": float(c.flops)}


def test_counts_do_not_depend_on_the_sharding_cache():
    """DTensor propagates a new op signature once on global fake tensors;
    the counter pauses there, so a cold and a warm run count alike."""
    from torch.distributed.tensor import Shard, distribute_tensor
    with fake_world(4, "cpu"):
        mesh = _mesh4()
        with FakeTensorMode(allow_non_fake_inputs=True):
            a = distribute_tensor(torch.randn(24, 40), mesh, [Shard(1)])
            b = distribute_tensor(torch.randn(40, 12), mesh, [Shard(0)])
            cold = hlo.run_counted(lambda: torch.tanh(a @ b), ())[1]
            warm = hlo.run_counted(lambda: torch.tanh(a @ b), ())[1]
    assert cold.flops == warm.flops == 2 * 24 * 10 * 12
    assert cold.log == warm.log
    assert cold.bytes_accessed == warm.bytes_accessed


def test_memory_stats_follow_storage_lifetimes():
    x = torch.zeros(1024)                                        # 4 KiB

    def fn(x):
        y = x * 2                       # +4 KiB
        z = y + 1                       # +4 KiB: peak 8 KiB
        del y
        v = z.view(32, 32)              # a view makes nothing
        return v.sum(0)                 # +128 B, the output
    _, c = hlo.run_counted(fn, (x,))
    mem = hlo.memory_stats(c)
    assert mem["argument_size_in_bytes"] == 4096
    assert mem["output_size_in_bytes"] == 128
    assert c.peak_bytes == 8192
    assert mem["temp_size_in_bytes"] == 8192 - 128
    assert mem["peak_size_in_bytes"] == 4096 + 8192


# ------------------------------------------------ one rank vs unsharded ----
def _unsharded_flops(cfg, kind, state, B, S):
    from repro_torch.models import build_model
    from repro_torch.train import trainable
    from repro_torch.train.optimizer import OptimizerConfig, init_state
    from repro_torch.train.trainstep import make_train_step
    if kind == "train":
        cfg = dataclasses.replace(cfg, remat="full")
    model = build_model(cfg, device="cpu", params=state)
    toks = torch.randint(0, cfg.vocab_size, (B, S))
    with FlopCounterMode(display=False) as fc:
        if kind == "train":
            named = trainable(model)
            step = make_train_step(model, OptimizerConfig(), accum_steps=1,
                                   ce_chunk=16)
            step(named, init_state(named),
                 {"tokens": toks, "labels": toks.clone()})
        else:
            cache = model.init_cache(B, S, torch.bfloat16, device="cpu")
            with torch.no_grad():
                if kind == "prefill":
                    model.prefill(toks, torch.full((B,), S,
                                                   dtype=torch.int32), cache)
                else:
                    model.decode_step(toks[:, :1], torch.full(
                        (B,), S - 1, dtype=torch.int32), cache)
    return fc.get_total_flops()


@pytest.mark.parametrize("arch,kind", [
    ("granite-3-2b", "train"), ("granite-3-2b", "prefill"),
    ("granite-3-2b", "decode"), ("zamba2-7b", "prefill"),
    ("xlstm-350m", "decode")])
def test_one_rank_flops_equal_flop_counter_over_the_unsharded_model(
        arch, kind):
    """On a 1-rank world every DTensor op is the unsharded op: the dry-run
    over fake tensors counts what FlopCounterMode counts over the
    unsharded reduced model on real tensors, and no collective bytes."""
    cfg = get_reduced_config(arch)
    B, S = 4, 32
    suite = ShapeSuite("t", kind, S, B)
    kw = ({"ce_chunk": 16, "accum_steps": 1, "remat": "full"}
          if kind == "train" else {})
    with fake_world(1, "cpu"):
        mesh = make_host_mesh(1, 1, device_type="cpu")
        rules = make_rules(cfg, mesh, suite)
        fake, _ = dryrun.count_cell(cfg, suite, mesh, rules, **kw)
        fn, args, _ = steps.build_cell(cfg, suite, mesh, rules=rules, **kw)
        real = steps.materialize(args, mesh, torch.Generator().manual_seed(0))
        state = {n: p.full_tensor().detach().clone()
                 for n, p in real[0].items()}
    want = _unsharded_flops(cfg, kind, state, B, S)
    assert fake.flops == want > 0
    assert hlo.collective_bytes(fake).get("total", 0) == 0


# ------------------------------------------------------- run_cell ----------
CELLS = {
    "granite_train": ("granite-3-2b", "train", GRANITE),
    "deepseek_train": ("deepseek-v2-lite-16b", "train", {}),
    "deepseek_prefill": ("deepseek-v2-lite-16b", "prefill", {}),
    "qwen3_decode": ("qwen3-moe-235b-a22b", "decode", {}),
    "zamba2_prefill": ("zamba2-7b", "prefill", {}),
    "xlstm_decode": ("xlstm-350m", "decode", {}),
    "whisper_prefill": ("whisper-small", "prefill", {}),
    "vlm_prefill": ("llama-3.2-vision-11b", "prefill", {}),
    "danube_decode": ("h2o-danube-1.8b", "decode", {}),
}
UNIFORM = ("granite_train", "deepseek_train", "deepseek_prefill",
           "qwen3_decode", "danube_decode")


def _run(name, tmp_path, **kw):
    arch, kind, over = CELLS[name]
    cfg = get_reduced_config(arch, **over)
    suite = ShapeSuite(f"small_{kind}", kind, 64, 8)
    return cfg, dryrun.run_cell(arch, suite.name, False, tmp_path,
                                device="cpu", cfg=cfg, suite=suite,
                                mesh_shape=(2, 4), **kw)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_small_mesh_run_cell(name, tmp_path):
    """run_cell on a 2 x 4 fake world (the reference's
    test_small_mesh_end_to_end mesh) for a reduced arch of each family:
    the cell runs, fits, counts FLOPs, and moves collective bytes, which
    the probes extrapolate where every layer is alike. The DeepSeek cells
    failed under fake tensors before MLA's prefill core ran
    in a local region."""
    cfg, r = _run(name, tmp_path)
    assert r["ok"], r.get("traceback")
    assert r["mesh"] == "2x4" and r["fits"]
    assert r["cost_unrolled"]["flops"] == 8 * r["cost_unrolled"][
        "flops_per_rank"] > 0
    assert r["memory_analysis"]["argument_size_in_bytes"] > 0
    coll = r["collectives"]
    assert coll["extrapolated_total_bytes"] > 0
    assert sum(coll["by_kind"].values()) == coll["extrapolated_total_bytes"]
    saved = json.loads(next(tmp_path.glob("*.json")).read_text())
    assert saved["ok"] and saved["collectives"] == json.loads(
        json.dumps(coll))
    if name in UNIFORM:
        # every layer alike: base + per_layer * n_layers from the 1- and
        # 2-unit probes is the full run's collective total
        assert coll["per_layer_bytes"] > 0
        assert coll["base_bytes"] + coll["per_layer_bytes"] * \
            cfg.n_layers == coll["extrapolated_total_bytes"] == \
            coll["probe_total_bytes"]


def test_gate_only_and_a_recorded_failure(tmp_path, monkeypatch):
    _, r = _run("granite_train", tmp_path / "gate", gate_only=True)
    assert r["ok"] and "cost_unrolled" not in r and "collectives" not in r
    assert r["memory_analysis"]["peak_size_in_bytes"] > 0

    def broken(*a, **k):
        raise RuntimeError("planted")
    monkeypatch.setattr(dryrun, "count_cell", broken)
    _, r = _run("granite_train", tmp_path / "fail")
    assert not r["ok"] and r["error"] == "RuntimeError: planted"
    assert "Traceback" in r["traceback"]
    assert dryrun.main(["--arch", "granite-3-2b", "--shape", "decode_32k",
                        "--device", "cpu", "--out",
                        str(tmp_path / "cli")]) == 1


def test_skip_records_are_the_references(tmp_path):
    """Every assigned (arch x shape) that skips, through both packages'
    run_cell: the same records (the reference's in a subprocess, as its
    module sets XLA_FLAGS at import)."""
    cells = [(a, s) for a in ASSIGNED_ARCHS for s in SHAPES
             if dryrun.skip_reason(get_config(a), SHAPES[s])]
    assert len(cells) >= 5
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    code = textwrap.dedent(f"""
        import json
        from pathlib import Path
        from repro.launch.dryrun import run_cell
        print(json.dumps([run_cell(a, s, mp, Path({str(ref_dir)!r}))
                          for a, s in {cells!r} for mp in (False, True)]))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    got = [dryrun.run_cell(a, s, mp, port_dir, device="cpu")
           for a, s in cells for mp in (False, True)]
    assert got == want
    assert sorted(p.name for p in port_dir.iterdir()) == \
        sorted(p.name for p in ref_dir.iterdir())


# ---------------------------------------------- kernels refuse fakes ------
ENTRY_POINTS = {
    "flash_attention": lambda t: ops.flash_attention(t, t, t),
    "flash_decode": lambda t: ops.flash_decode(t, t, t, t),
    "paged_flash_decode": lambda t: ops.paged_flash_decode(t, t, t, t, t),
    "paged_mla_decode": lambda t: ops.paged_mla_decode(t, t, t, t, t, t),
    "grouped_gemm": lambda t: ops.grouped_gemm(t, t),
    "grouped_gemm_segments": lambda t: ops.grouped_gemm_segments(t, t, t),
    "ssm_scan": lambda t: ops.ssm_scan(t, t, t, t),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_kernel_entry_points_refuse_fake_tensors(name, device):
    """A fake tensor on cuda would reach a ctypes launch with a fake
    data_ptr; on the CPU it would run the plain version unasked. Both
    raise, naming the plain path, and launch nothing. FakeTensorMode
    makes cuda tensors without a card, so this runs on the CPU."""
    before = dict(ops.LAUNCHES)
    with FakeTensorMode():
        t = torch.empty(2, 4, 2, 8, device=device)
        assert t.device.type == device
        with pytest.raises(RuntimeError, match=r"use_kernels=False"):
            ENTRY_POINTS[name](t)
    assert ops.LAUNCHES == before


def test_perf_with_kernels_is_refused(tmp_path, capsys):
    """perf --set use_kernels=1 records the entry point's refusal and
    exits non-zero; it never runs a kernel on a fake tensor."""
    rc = perf.main(["--arch", "granite-3-2b", "--shape", "decode_32k",
                    "--tag", "kernels", "--set", "use_kernels=1",
                    "--device", "cpu", "--out", str(tmp_path)])
    assert rc == 1
    art = json.loads((tmp_path / "granite-3-2b__decode_32k__kernels.json")
                     .read_text())
    assert not art["ok"] and "use_kernels=False" in art["error"]
    assert art["overrides"] == {"use_kernels": 1}
    assert "FAIL: RuntimeError: flash_decode: a fake tensor" in \
        capsys.readouterr().out
