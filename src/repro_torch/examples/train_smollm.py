"""End-to-end training script: train a reduced SmolLM2-class model on the
synthetic FEVER LM task for a few hundred steps with checkpoint/restart.

Port of ``examples/train_smollm.py``, with the same flags, defaults and
printed lines, plus ``--device``. Kill it at any point and re-run — it
resumes from the newest valid checkpoint (the no-warning-preemption
training story); the checkpoints are in the reference's layout, so either
package resumes the other's.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_smollm \\
          --steps 300 [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Dict

from repro_torch.configs import get_reduced_config
from repro_torch.data import PipelineConfig, batches
from repro_torch.device import resolve
from repro_torch.models import build_model
from repro_torch.train import LoopConfig, OptimizerConfig, train


def smollm_config(d_model: int = 128):
    """The reduced SmolLM2-family config at width ``d_model`` (~100M
    parameters at 768)."""
    return get_reduced_config("smollm2-1.7b", d_model=d_model,
                              n_heads=max(4, d_model // 32),
                              n_kv_heads=max(4, d_model // 32),
                              head_dim=32, d_ff=d_model * 4,
                              vocab_size=8192, vocab_pad_to=256)


def train_run(steps: int, batch_size: int, seq_len: int,
              checkpoint_dir: str, cfg=None, device: str = "cuda") -> Dict:
    """Train ``cfg`` (default ``smollm_config()``) for ``steps`` steps in
    ``checkpoint_dir``, resuming from its newest checkpoint. Prints the
    reference's lines; returns the step records and the trained
    weights."""
    cfg = cfg if cfg is not None else smollm_config()
    model = build_model(cfg, device=device)
    print(f"[example] training {cfg.param_count() / 1e6:.1f}M-param "
          f"smollm2-family model for {steps} steps "
          f"(checkpoints -> {checkpoint_dir})")

    pcfg = PipelineConfig(batch_size=batch_size, seq_len=seq_len,
                          vocab_size=cfg.vocab_size, task="fact")
    ocfg = OptimizerConfig(peak_lr=1e-3, warmup_steps=steps // 10,
                           total_steps=steps)
    lcfg = LoopConfig(total_steps=steps,
                      checkpoint_every=max(25, steps // 10),
                      log_every=max(10, steps // 30),
                      ce_chunk=min(64, seq_len))
    out = train(model, lambda s: batches(pcfg, s), ocfg, lcfg,
                checkpoint_dir=checkpoint_dir)
    records = out["records"]
    if records:
        median = sorted(r.seconds for r in records)[len(records) // 2]
        print(f"[example] loss {records[0].loss:.3f} -> "
              f"{records[-1].loss:.3f}; median step "
              f"{median * 1e3:.0f} ms")
    else:
        print("[example] nothing to do (already trained to "
              f"{steps} steps — delete {checkpoint_dir} to rerun)")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--checkpoint-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_smollm_ckpt"))
    ap.add_argument("--d-model", type=int, default=128,
                    help="width of the reduced model (~100M at 768)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    resolve(args.device)
    return train_run(args.steps, args.batch_size, args.seq_len,
                     args.checkpoint_dir, smollm_config(args.d_model),
                     args.device)


if __name__ == "__main__":
    main()
