"""Multi-pod dry-run: run every (arch x shape x mesh) cell once over fake
tensors on a fake world of ranks and record the roofline's raw material.

Port of ``repro.launch.dryrun``. Where the reference forces 512 host
devices, lowers and compiles each cell, the port starts a fake process
group of 256 ranks (16x16) or 512 (2x16x16) with this process as rank 0
(``launch.mesh.fake_world``), builds the cell's step on the production
mesh (``launch.steps.build_cell``), makes its arguments with
``materialize``'s seeded init under ``FakeTensorMode`` and runs the step
once in eager mode under ``launch.hlo``'s counter. A fake world allocates
nothing and runs no collective: the counts are of what rank 0 would run
on its shards. The cell runs the plain path: a kernel entry point refuses
a fake tensor (``kernels.ops``).

Per cell a JSON artifact holds:
  * gate: the PRODUCTION form (train: remat ``full``, 4 microbatches,
    ``ce_chunk`` 512) ran (``ok``), with rank 0's ``memory_analysis`` and
    ``fits`` in one H100's 80 GB (the counterpart of compile success and
    ``memory_analysis()``), and ``cost_scanned`` / ``collectives_scanned_
    body``, the same run's counts;
  * analysis: ``cost_unrolled``, FLOPs and pre-fusion bytes summed over
    the ranks (``hlo.cost_stats``) of a second run with 1 microbatch and
    ``ce_chunk = seq_len`` (a serving cell's analysis form is its
    production form, so its one run gives both);
  * collectives: rank 0's collective bytes by kind and in total from the
    analysis run (``extrapolated_total_bytes``, ``by_kind``), and
    ``per_layer_bytes`` / ``base_bytes`` from two shallow probes of 1 and
    2 pattern units (``steps.probe_config``), so that ``base + per_layer
    * n_layers`` can be held to the measured total.

The reference's ``_analysis_mode`` (``set_layer_unroll``,
``set_full_chunk``) and ``hlo_while_count`` have no counterpart: XLA
counts a while body once, so the reference unrolls layers and attention
chunks and extrapolates collectives from probes; the port's layers,
microbatches and attention chunks are Python loops that run, and are
counted, every time.

Resumable: existing JSONs are skipped unless --force.

Usage:
  python -m repro_torch.launch.dryrun --arch stablelm-12b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multipod] [--gate-only]
  ... --device cpu     (the default is cuda: fake tensors on the card)
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs import (ALL_ARCHS, ASSIGNED_ARCHS, SHAPES,
                                 get_config)
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeSuite, shapes_for, skip_reason
from repro_torch.launch import hlo
from repro_torch.launch.mesh import (fake_world, make_host_mesh,
                                     make_production_mesh)
from repro_torch.launch.sharding import make_rules
from repro_torch.launch.steps import (build_cell, materialize, pattern_unit,
                                      probe_config)

DEFAULT_OUT = Path("experiments/dryrun_torch")
HBM_BYTES = 80e9          # one H100 SXM5: 80 GB of HBM3 (datasheet)
CE_CHUNK = 512


def cell_name(arch: str, shape: str, multipod: bool) -> str:
    return f"{arch}__{shape}__{'pod2' if multipod else 'pod1'}"


def _train_kw(suite: ShapeSuite, analysis: bool) -> dict:
    if suite.kind != "train":
        return {}
    if analysis:        # one pass over the whole batch, one CE chunk
        return {"ce_chunk": suite.seq_len, "remat": "full",
                "accum_steps": 1}
    return {"ce_chunk": CE_CHUNK, "remat": "full", "accum_steps": 4}


def count_cell(cfg: ModelConfig, suite: ShapeSuite, mesh, rules,
               **kw) -> Tuple[hlo.Counter, float]:
    """Build the cell, make its arguments over fake tensors on ``mesh``
    and run it once under a counter -> (counter, seconds)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.time()
    fn, args, _ = build_cell(cfg, suite, mesh, rules=rules, **kw)
    gen = torch.Generator(device=mesh.device_type).manual_seed(0)
    with FakeTensorMode(allow_non_fake_inputs=True):
        real = materialize(args, mesh, gen)
        _, counter = hlo.run_counted(fn, real)
    return counter, time.time() - t0


def probe_collectives(cfg: ModelConfig, suite: ShapeSuite, mesh, rules,
                      total: Dict[str, int], train_kw=None) -> dict:
    """The artifact's ``collectives``: ``total`` (rank 0's bytes by kind
    of the full analysis run) as ``extrapolated_total_bytes`` and
    ``by_kind``, and the per-layer and base bytes of two shallow probes
    (1 and 2 pattern units). ``train_kw`` overrides the analysis form's
    train settings (``perf``)."""
    unit = pattern_unit(cfg)
    out = {"pattern_unit": unit}
    kw = _train_kw(suite, analysis=True)
    if kw:
        kw.update(train_kw or {})
        kw.update(accum_steps=1, ce_chunk=suite.seq_len)
    per_probe = {}
    for units in (1, 2):
        pcfg = probe_config(cfg, units)
        counter, secs = count_cell(pcfg, suite, mesh, rules, **kw)
        per_probe[units] = {"layers": pcfg.n_layers,
                            "bytes": hlo.collective_bytes(counter),
                            "seconds": round(secs, 2)}
    l1, l2 = per_probe[1]["layers"], per_probe[2]["layers"]
    b1 = per_probe[1]["bytes"].get("total", 0)
    b2 = per_probe[2]["bytes"].get("total", 0)
    per_layer = max(0.0, (b2 - b1) / max(1, l2 - l1))
    base = max(0.0, b1 - per_layer * l1)
    out.update(probes=per_probe, per_layer_bytes=per_layer,
               base_bytes=base,
               extrapolated_total_bytes=float(total.get("total", 0)),
               probe_total_bytes=base + per_layer * cfg.n_layers,
               by_kind={k: float(v) for k, v in sorted(total.items())
                        if k != "total"})
    return out


def run_cell(arch: str, shape: str, multipod: bool, out_dir: Path,
             gate_only: bool = False, force: bool = False,
             device: str = "cuda", cfg: Optional[ModelConfig] = None,
             suite: Optional[ShapeSuite] = None,
             mesh_shape: Optional[Tuple[int, int]] = None) -> dict:
    """One cell's artifact, written to ``out_dir`` and returned; a failure
    is recorded in it (``error``, ``traceback``), never raised. ``cfg``,
    ``suite`` and ``mesh_shape`` (a (data, model) host mesh in place of
    the production one) are for tests: a reduced config on a small fake
    world."""
    out_dir.mkdir(parents=True, exist_ok=True)
    out_file = out_dir / f"{cell_name(arch, shape, multipod)}.json"
    if out_file.exists() and not force:
        return json.loads(out_file.read_text())

    cfg = cfg or get_config(arch)
    suite = suite or SHAPES[shape]
    dims = mesh_shape or ((2, 16, 16) if multipod else (16, 16))
    result = {"arch": arch, "shape": shape, "mesh": "x".join(map(str, dims)),
              "kind": suite.kind, "ok": False}

    reason = skip_reason(cfg, suite)
    if reason:
        result.update(ok=True, skipped=True, skip_reason=reason)
        out_file.write_text(json.dumps(result, indent=1))
        return result
    result["device"] = device

    world = math.prod(dims)
    try:
        with fake_world(world, device):
            mesh = (make_host_mesh(*mesh_shape, device_type=device)
                    if mesh_shape else
                    make_production_mesh(multi_pod=multipod,
                                         device_type=device))
            rules = make_rules(cfg, mesh, suite)
            result["rules"] = {k: list(v) if isinstance(v, tuple) else v
                               for k, v in rules.items()}
            # ---- gate: the production form ------------------------------
            gate, secs = count_cell(cfg, suite, mesh, rules,
                                    **_train_kw(suite, analysis=False))
            result["gate_seconds"] = round(secs, 2)
            mem = hlo.memory_stats(gate)
            result["memory_analysis"] = mem
            result["fits"] = mem["peak_size_in_bytes"] <= HBM_BYTES
            result["cost_scanned"] = hlo.cost_stats(gate, world)
            result["collectives_scanned_body"] = hlo.collective_bytes(gate)

            if not gate_only:
                # ---- analysis: one microbatch, one CE chunk ------------
                analysis = gate
                if suite.kind == "train":
                    analysis, secs = count_cell(
                        cfg, suite, mesh, rules,
                        **_train_kw(suite, analysis=True))
                    result["analysis_seconds"] = round(secs, 2)
                result["cost_unrolled"] = hlo.cost_stats(analysis, world)
                # ---- collectives: the total, and two shallow probes ----
                result["collectives"] = probe_collectives(
                    cfg, suite, mesh, rules,
                    hlo.collective_bytes(analysis))
        result["ok"] = True
    except Exception as e:  # record the failure; the matrix keeps going
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc(limit=12)
    out_file.write_text(json.dumps(result, indent=1))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ALL_ARCHS))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="run every assigned (arch x shape) cell")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--gate-only", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of the fake tensors and the mesh")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)

    cells = []
    if args.all:
        for arch in ASSIGNED_ARCHS:
            cfg = get_config(arch)
            for suite in shapes_for(cfg):
                cells.append((arch, suite.name))
            for suite in (set(SHAPES.values()) - set(shapes_for(cfg))):
                cells.append((arch, suite.name))  # records the skip
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all) required")
        cells = [(args.arch, args.shape)]

    meshes = ([False, True] if args.both_meshes
              else [args.multipod])
    failed = 0
    for arch, shape in cells:
        for mp in meshes:
            t0 = time.time()
            r = run_cell(arch, shape, mp, out_dir,
                         gate_only=args.gate_only, force=args.force,
                         device=args.device)
            status = ("SKIP" if r.get("skipped")
                      else "OK" if r.get("ok") else "FAIL")
            failed += status == "FAIL"
            print(f"[{status:4s}] {cell_name(arch, shape, mp):60s} "
                  f"{time.time() - t0:7.1f}s "
                  f"{r.get('error', '')[:80]}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
