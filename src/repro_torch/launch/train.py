"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

Port of ``repro.launch.train``, with the same flags and ``--device``
(``cuda``, the default: the card; ``cpu`` only when asked for). Runs real
steps on the device with the reduced config of ``--arch`` (the full one
with ``--full-config``). The reference's ``--production-lower`` path
(lowering against a TPU mesh) has no counterpart here.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.data import PipelineConfig, batches
from repro_torch.device import resolve
from repro_torch.models import build_model
from repro_torch.train import LoopConfig, OptimizerConfig, train


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--task", choices=("fact", "synthetic"), default="fact")
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (not reduced) architecture config")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    cfg = (get_config(args.arch) if args.full_config
           else get_reduced_config(args.arch))
    model = build_model(cfg, device=dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[train] arch={args.arch} params~{cfg.param_count()/1e6:.1f}M "
          f"(config {'full' if args.full_config else 'reduced'}) "
          f"device={name}")

    pcfg = PipelineConfig(batch_size=args.batch_size, seq_len=args.seq_len,
                          vocab_size=cfg.vocab_size, task=args.task)
    ocfg = OptimizerConfig(peak_lr=args.lr, warmup_steps=max(
        5, args.steps // 20), total_steps=args.steps)
    lcfg = LoopConfig(total_steps=args.steps,
                      checkpoint_every=args.checkpoint_every,
                      log_every=max(1, args.steps // 20),
                      accum_steps=args.accum,
                      ce_chunk=min(512, args.seq_len))
    out = train(model, lambda s: batches(pcfg, s), ocfg, lcfg,
                checkpoint_dir=args.checkpoint_dir)
    losses = [r.loss for r in out["records"]]
    if losses:
        print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"over {len(losses)} steps")


if __name__ == "__main__":
    main()
