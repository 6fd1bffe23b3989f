"""Roofline derivation from dry-run artifacts, with the H100's constants.

Port of ``repro.launch.roofline``, the arithmetic as it is. Per (arch x
shape x mesh) cell:
  compute term    = FLOPs / (chips * peak_FLOP/s)
  memory term     = min_HBM_bytes / (chips * HBM_bw)     [analytic floor]
                    (the counted pre-fusion bytes recorded as an upper
                    bound)
  collective term = collective_bytes_per_device / link_bw

FLOPs are the dry-run's ``cost_unrolled`` (summed over the ranks:
``launch.hlo.cost_stats``), divided by the chip count. Collective bytes
are rank 0's (``collectives.extrapolated_total_bytes``, per device as the
reference's are). The memory floor is analytic: weights read once per
step + KV/state traffic + batch IO.

Hardware: one NVIDIA H100 SXM5 a rank (datasheet figures, below). The
artifacts of both packages read alike: ``cell_roofline`` takes the chip
count from the mesh string's product (256 for ``16x16``, 512 for
``2x16x16``, 1 for a one-card cell).
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, Optional

from repro_torch.configs import SHAPES, get_config

# NVIDIA H100 Tensor Core GPU datasheet, SXM5 column: dense BF16 989.4
# TFLOP/s (1 979 with 2:4 sparsity, not used here)
PEAK_FLOPS = 989e12
# same datasheet: HBM3, 3.35 TB/s
HBM_BW = 3.35e12
# per-GPU network: one 400 Gb/s ConnectX-7 NDR port per GPU, as a DGX H100
# has (DGX H100 user guide): 50 GB/s. Each axis of the production meshes
# spans 16 ranks, more than the 8 GPUs of one NVLink domain, so the
# inter-node link sets the pace. NVLink 4 within a node, 450 GB/s per
# direction (datasheet: 900 GB/s both ways), is unused for that reason.
ICI_BW = 50e9


def chips(mesh: str) -> int:
    """Ranks of a mesh string: the product of its ``x``-separated dims."""
    return math.prod(int(d) for d in mesh.split("x"))


def model_flops(cfg, suite) -> float:
    """MODEL_FLOPS: 6*N*D for train, 2*N_active*D forward-only for serving."""
    n = cfg.active_param_count()
    if suite.kind == "train":
        tokens = suite.global_batch * suite.seq_len
        return 6.0 * n * tokens
    if suite.kind == "prefill":
        tokens = suite.global_batch * suite.seq_len
        return 2.0 * n * tokens
    tokens = suite.global_batch  # one new token per sequence
    return 2.0 * n * tokens


def analytic_min_bytes(cfg, suite) -> float:
    """Fusion-independent minimum HBM traffic per step (whole cluster)."""
    dtype = 2  # bf16
    weights = cfg.param_count() * dtype
    if suite.kind == "train":
        # fwd+bwd read weights twice-ish + grads + opt state touch (f32)
        weight_traffic = 2 * weights + cfg.param_count() * (2 + 4 + 4 + 4)
        act = suite.global_batch * suite.seq_len * cfg.d_model * dtype
        act_traffic = act * cfg.n_layers * 4  # saved residuals + recompute IO
        return weight_traffic + act_traffic
    kv_token = cfg.kv_bytes_per_token(1 if "8" in cfg.kv_cache_dtype
                                      else 2)
    if suite.kind == "prefill":
        act = suite.global_batch * suite.seq_len * cfg.d_model * dtype
        kv_write = suite.global_batch * suite.seq_len * kv_token
        # blockwise attention re-reads KV per query chunk: O(S/C) passes
        kv_reread = kv_write * max(1, suite.seq_len // 1024) * 0.5
        return weights + act * cfg.n_layers * 2 + kv_write + kv_reread
    # decode: read all weights + full KV/state once per token
    window = cfg.sliding_window or suite.seq_len
    kv_dtype_bytes = 1 if "8" in cfg.kv_cache_dtype else 2
    kv = (suite.global_batch * min(window, suite.seq_len) *
          cfg.kv_bytes_per_token(kv_dtype_bytes))
    ssm_state = 0.0
    if cfg.family in ("ssm", "hybrid"):
        # recurrent state read+write (f32)
        from repro_torch.models.ssm import mamba2_dims, mlstm_dims
        if cfg.family == "hybrid":
            _, m_heads, _ = mamba2_dims(cfg)
            ssm_state = (suite.global_batch * m_heads * cfg.ssm.state_dim *
                         cfg.ssm.head_dim * 4 * cfg.n_layers * 2)
        else:
            _, hd = mlstm_dims(cfg)
            per = cfg.n_heads * hd * (hd + 1) * 4
            ssm_state = suite.global_batch * per * cfg.n_layers * 2
    return weights + kv + ssm_state


def cell_roofline(artifact: Dict, suite=None) -> Optional[Dict]:
    """The roofline row of a dry-run artifact; ``suite`` for a cell whose
    shape is not one of ``SHAPES`` (a one-card cell of ``chip_smoke``)."""
    if artifact.get("skipped") or not artifact.get("ok"):
        return None
    cfg = get_config(artifact["arch"])
    suite = suite or SHAPES[artifact["shape"]]
    n_chips = chips(artifact["mesh"])

    gate_only = "cost_unrolled" not in artifact
    hlo_flops = artifact.get("cost_unrolled", {}).get("flops")
    if hlo_flops is None:  # gate-only runs: fall back to analytic
        hlo_flops = model_flops(cfg, suite)
    compute_s = hlo_flops / (n_chips * PEAK_FLOPS)

    min_bytes = analytic_min_bytes(cfg, suite)
    memory_s = min_bytes / (n_chips * HBM_BW)

    coll = artifact.get("collectives", {})
    coll_bytes = coll.get("extrapolated_total_bytes", 0.0)
    collective_s = coll_bytes / ICI_BW  # already per-device

    mf = model_flops(cfg, suite)
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    useful = mf / (n_chips * PEAK_FLOPS)
    return {
        "arch": artifact["arch"], "shape": artifact["shape"],
        "mesh": artifact["mesh"], "kind": artifact["kind"],
        "gate_only": gate_only,
        "hlo_flops": hlo_flops, "model_flops": mf,
        "flops_ratio": mf / hlo_flops if hlo_flops else 0.0,
        "min_hbm_bytes": min_bytes,
        "hlo_bytes_prefusion": artifact.get("cost_unrolled", {}).get(
            "bytes_accessed"),
        "collective_bytes": coll_bytes,
        "collective_by_kind": coll.get("by_kind", {}),
        **{k: v for k, v in terms.items()},
        "dominant": dominant,
        "roofline_fraction": useful / bound if bound else 0.0,
        "step_seconds_bound": bound,
    }


def load_table(dry_dir: str = "experiments/dryrun_torch") -> list:
    rows = []
    for f in sorted(Path(dry_dir).glob("*.json")):
        art = json.loads(f.read_text())
        row = cell_roofline(art)
        if row is None:
            rows.append({"arch": art["arch"], "shape": art["shape"],
                         "mesh": art.get("mesh"),
                         "skipped": art.get("skipped", False),
                         "error": art.get("error"),
                         "skip_reason": art.get("skip_reason")})
        else:
            rows.append(row)
    return rows


def format_table(rows: list) -> str:
    hdr = (f"{'arch':24s} {'shape':12s} {'mesh':8s} {'comp_ms':>9s} "
           f"{'mem_ms':>9s} {'coll_ms':>9s} {'dominant':>12s} "
           f"{'MF/HLO':>7s} {'roofline':>9s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        if r.get("skipped"):
            lines.append(f"{r['arch']:24s} {r['shape']:12s} "
                         f"{r.get('mesh') or '':8s} SKIP "
                         f"({(r.get('skip_reason') or '')[:60]})")
            continue
        if r.get("error"):
            lines.append(f"{r['arch']:24s} {r['shape']:12s} "
                         f"{r.get('mesh') or '':8s} FAIL "
                         f"{r['error'][:60]}")
            continue
        if r.get("gate_only"):
            lines.append(
                f"{r['arch']:24s} {r['shape']:12s} {r['mesh']:8s} "
                f"GATE-ONLY (compile+memory pass; analysis on 16x16)")
            continue
        lines.append(
            f"{r['arch']:24s} {r['shape']:12s} {r['mesh']:8s} "
            f"{r['compute_s'] * 1e3:9.2f} {r['memory_s'] * 1e3:9.2f} "
            f"{r['collective_s'] * 1e3:9.2f} "
            f"{r['dominant'].replace('_s', ''):>12s} "
            f"{r['flops_ratio']:7.2f} {r['roofline_fraction']:9.3f}")
    return "\n".join(lines)


if __name__ == "__main__":
    print(format_table(load_table()))
