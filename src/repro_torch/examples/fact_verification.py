"""Prompt-for-Fact end-to-end: the paper's application, miniaturized.

Port of ``examples/fact_verification.py``, with the same flags, defaults
and printed lines, plus ``--device``:

1. TRAIN a reduced SmolLM2-class verifier on synthetic FEVER claims for a
   few hundred steps (real PyTorch training with checkpoint/restart).
2. SERVE it through Pervasive Context Management: sweep claims under each
   prompt template, measure verification accuracy per prompt (that is the
   Prompt-for-Fact objective), with full-context reuse across tasks.

Training runs the plain path (the kernels have no backward), so a config
with ``use_kernels`` trains a copy with the kernels off and serves the
trained weights with them on.

Run:  PYTHONPATH=src python -m repro_torch.examples.fact_verification \\
          [--steps 300] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time
from typing import Dict

from repro_torch.configs import get_reduced_config
from repro_torch.core import (ContextMode, PCMManager, context_app,
                              load_context, make_recipe)
from repro_torch.data import PipelineConfig, batches, fever
from repro_torch.data.tokenizer import LABEL_TOKENS, HashTokenizer
from repro_torch.device import resolve
from repro_torch.models import build_model
from repro_torch.serving import InferenceEngine
from repro_torch.train import LoopConfig, OptimizerConfig, train

# each worker's engine (the reference's knobs)
ENGINE_KW = dict(slots=8, cache_len=64, prefill_buckets=(32,))


def train_verifier(steps: int, ckpt_dir: str, cfg=None,
                   device: str = "cuda"):
    """Train ``cfg`` (default the reduced SmolLM2-1.7B) with the kernels
    off; returns the config and the trained weights (a state dict on
    ``device``)."""
    cfg = cfg if cfg is not None else get_reduced_config("smollm2-1.7b")
    model = build_model(dataclasses.replace(cfg, use_kernels=False),
                        device=device)
    pcfg = PipelineConfig(batch_size=16, seq_len=32,
                          vocab_size=cfg.vocab_size, task="fact")
    ocfg = OptimizerConfig(peak_lr=2e-3, warmup_steps=max(5, steps // 10),
                           total_steps=steps)
    lcfg = LoopConfig(total_steps=steps, checkpoint_every=max(50, steps // 4),
                      log_every=max(10, steps // 10), ce_chunk=32)
    out = train(model, lambda s: batches(pcfg, s), ocfg, lcfg,
                checkpoint_dir=ckpt_dir)
    print(f"[train] loss {out['records'][0].loss:.3f} -> "
          f"{out['records'][-1].loss:.3f}")
    return cfg, dict(model.state_dict())


def sweep(cfg, params, claims: int, batch_size: int,
          device: str = "cuda") -> Dict:
    """Serve ``params`` (``cfg``'s weights) through a 2-worker FULL
    PCMManager whose context builder closes over one model, and verify
    claims 0 .. ``claims`` - 1 under every template of
    ``fever.PROMPT_CANDIDATES``. Prints the reference's lines; returns
    the claims correct per template, the best template, the seconds and
    the manager's stats."""
    model = build_model(cfg, device=device, params=params)

    def load_model():
        engine = InferenceEngine(model, device=device, **ENGINE_KW)
        engine.generate([[2, 5]], max_new_tokens=1)
        return {"engine": engine,
                "tokenizer": HashTokenizer(cfg.vocab_size)}

    mgr = PCMManager(mode=ContextMode.FULL, n_workers=2)
    recipe = make_recipe("pff.verifier", load_model)

    @context_app(recipe=recipe, manager=mgr, n_items=batch_size)
    def verify_batch(template, indices):
        engine = load_context("engine")
        tok = load_context("tokenizer")
        claim_list = fever.claim_batch(indices)
        prompts = [tok.encode(fever.render_prompt(c, template))
                   for c in claim_list]
        outs = engine.generate(prompts, max_new_tokens=1)
        return [int(o[0] == LABEL_TOKENS[c.label])
                for o, c in zip(outs, claim_list)]

    # Prompt-for-Fact: find the best verification prompt
    print(f"[serve] sweeping {len(fever.PROMPT_CANDIDATES)} prompts x "
          f"{claims} claims under PCM (full-context)")
    t0 = time.monotonic()
    best, correct = None, []
    try:
        for pi, template in enumerate(fever.PROMPT_CANDIDATES):
            futs = []
            for b in range(0, claims, batch_size):
                idx = list(range(b, min(b + batch_size, claims)))
                futs.append(verify_batch(template, idx))
            correct.append(sum(sum(f.result()) for f in futs))
            acc = correct[-1] / claims
            print(f"  prompt[{pi}] acc={acc:.3f}  ({template[:48]!r}...)")
            if best is None or acc > best[1]:
                best = (pi, acc)
        dt = time.monotonic() - t0
        st = mgr.stats()
    finally:
        mgr.shutdown()
    return dict(correct=correct, best=best, seconds=dt, stats=st)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--claims", type=int, default=96)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    resolve(args.device)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        cfg, params = train_verifier(args.steps, ckpt_dir,
                                     device=args.device)
        out = sweep(cfg, params, args.claims, args.batch_size, args.device)
    best, st = out["best"], out["stats"]
    print(f"[serve] best prompt: #{best[0]} (acc {best[1]:.3f}) — "
          f"{out['seconds']:.1f}s total; context built "
          f"{st['cold_invocations']}x, reused {st['warm_invocations']}x")
    return out


if __name__ == "__main__":
    main()
