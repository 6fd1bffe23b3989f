"""Perf-iteration harness: run one cell under config overrides over fake
tensors and report the roofline-term deltas against a recorded baseline.

Port of ``repro.launch.perf``; the cell runs as the dry-run runs it
(``launch.dryrun``: a fake world of 256 or 512 ranks, rank 0's counts).

  python -m repro_torch.launch.perf --arch granite-3-2b \\
      --shape decode_32k --set kv_update=mask --tag mask_update \\
      --baseline experiments/dryrun_torch/granite-3-2b__decode_32k__pod1.json

Artifacts land in experiments/perf_torch/<arch>__<shape>__<tag>.json.
``--set use_kernels=1`` is refused by the kernels' entry points (a fake
tensor has no data for a kernel): the harness counts the plain path.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import traceback
from pathlib import Path

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import hlo
from repro_torch.launch.dryrun import count_cell, probe_collectives
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.launch.sharding import make_rules

OUT = Path("experiments/perf_torch")


def parse_overrides(pairs):
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        out[k] = v
    return out


def run(arch: str, shape: str, tag: str, overrides: dict,
        train_kw: dict, multipod: bool = False, device: str = "cuda",
        out_dir: Path = OUT) -> dict:
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg = dataclasses.replace(get_config(arch), **overrides)
    suite = SHAPES[shape]
    result = {"arch": arch, "shape": shape, "tag": tag,
              "overrides": overrides, "train_kw": train_kw,
              "device": device, "ok": False}
    dims = (2, 16, 16) if multipod else (16, 16)
    world = math.prod(dims)
    try:
        with fake_world(world, device):
            mesh = make_production_mesh(multi_pod=multipod,
                                        device_type=device)
            rules = make_rules(cfg, mesh, suite)
            kw = dict(train_kw) if suite.kind == "train" else {}
            gate, secs = count_cell(cfg, suite, mesh, rules, **kw)
            result["gate_seconds"] = round(secs, 2)
            result["memory_analysis"] = hlo.memory_stats(gate)

            analysis = gate
            if suite.kind == "train":
                kw_a = dict(kw, ce_chunk=suite.seq_len, accum_steps=1)
                analysis, _ = count_cell(cfg, suite, mesh, rules, **kw_a)
            result["cost_unrolled"] = hlo.cost_stats(analysis, world)
            result["collectives"] = probe_collectives(
                cfg, suite, mesh, rules, hlo.collective_bytes(analysis),
                train_kw={"remat": train_kw.get("remat", "full")})
        result["ok"] = True
    except Exception as e:
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc(limit=10)
    out_file = out_dir / f"{arch}__{shape}__{tag}.json"
    out_file.write_text(json.dumps(result, indent=1))
    return result


def _readings(art: dict) -> dict:
    """An artifact's (a run's or a dry-run's) readings that the summary
    compares: collective bytes a rank, FLOPs and pre-fusion bytes summed
    over the ranks, rank 0's temporary bytes."""
    return {"coll": art.get("collectives", {}).get(
                "extrapolated_total_bytes", 0),
            "flops": art.get("cost_unrolled", {}).get("flops", 0),
            "bytes": art.get("cost_unrolled", {}).get("bytes_accessed", 0),
            "temp": art.get("memory_analysis", {}).get(
                "temp_size_in_bytes", 0)}


def deltas(result: dict, baseline: dict) -> dict:
    """Each reading's change against the baseline's, in percent (where
    the baseline's is nonzero)."""
    now, was = _readings(result), _readings(baseline)
    return {k: 100 * (now[k] - was[k]) / was[k] for k in now if was[k]}


def summarize(result: dict, baseline: dict = None):
    if not result.get("ok"):
        print("FAIL:", result.get("error"))
        return
    r = _readings(result)
    line = (f"{result['arch']} {result['shape']} [{result['tag']}]: "
            f"coll={r['coll'] / 1e9:.2f}GB flops={r['flops']:.3e} "
            f"bytes={r['bytes']:.3e} temp={r['temp'] / 1e9:.1f}GB")
    if baseline and baseline.get("ok"):
        d = deltas(result, baseline)
        line += "  (" + ", ".join(f"{k} {v:+.1f}%"
                                  for k, v in d.items()) + ")"
    print(line)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--tag", required=True)
    ap.add_argument("--set", nargs="*", default=[],
                    help="ModelConfig overrides k=v")
    ap.add_argument("--accum", type=int, default=4)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--baseline", default=None,
                    help="dry-run artifact to diff against")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of the fake tensors and the mesh")
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    overrides = parse_overrides(args.set)
    train_kw = {"accum_steps": args.accum, "remat": args.remat,
                "ce_chunk": 512}
    result = run(args.arch, args.shape, args.tag, overrides, train_kw,
                 args.multipod, args.device, Path(args.out))
    baseline = None
    if args.baseline:
        baseline = json.loads(Path(args.baseline).read_text())
    summarize(result, baseline)
    return 0 if result.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
