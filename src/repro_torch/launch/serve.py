"""Serving launcher: PCM-managed fact-verification inference.

``python -m repro_torch.launch.serve --arch smollm2-1.7b --claims 64``
(on the card; ``--device cpu`` runs it on the CPU)

Port of ``repro.launch.serve``, with the same flags and the same
``verify_batch``. Builds the model context via a PCM ContextRecipe
(weights + engine + loaded kernels), submits claim-verification tasks
through the context-aware scheduler, and reports throughput and context
amortization. ``--preempt-after N`` preempts a worker after the N-th batch
and adds a replacement, which restores the context from the node snapshot
pool instead of rebuilding it.

The model is the reduced config of ``--arch`` unless a caller passes its
own (``build_context``'s ``cfg``). Its weights are the port's seeded init,
or, with ``--checkpoint DIR``, the latest checkpoint under ``DIR`` written
by either package's ``CheckpointManager``: the port's state dict as it is,
or the reference's params tree through ``weights.from_jax_params`` (how a
verifier the reference trained reaches the port).
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_reduced_config
from repro_torch.core import (ContextMode, PCMManager, context_app,
                              load_context, make_recipe)
from repro_torch.data import HashTokenizer, fever
from repro_torch.data.tokenizer import LABEL_TOKENS
from repro_torch.device import resolve
from repro_torch.models import build_model
from repro_torch.serving import InferenceEngine
from repro_torch.weights import from_jax_params


def load_params(checkpoint: str, cfg, device: torch.device):
    """The latest checkpoint under ``checkpoint`` as the port's state dict
    on ``device``: a port state dict (flat dotted names) as it is, a
    reference params tree (nested by module) through
    ``weights.from_jax_params``."""
    tree, _ = CheckpointManager(checkpoint).restore(like=None)
    if all("." in k for k in tree):
        return {k: v.to(device) for k, v in tree.items()}
    return from_jax_params(tree, cfg, device)


def build_context(arch: str, slots: int, cache_len: int, megastep: int = 8,
                  cfg=None, device: str = "cuda",
                  checkpoint: Optional[str] = None,
                  prefill_buckets: Sequence[int] = (32, 64),
                  cache_dtype: torch.dtype = torch.float32):
    """The paper's ``load_model``: expensive, runs once per worker.

    Builds ``cfg`` (default: the reduced config of ``arch``) on ``device``
    with the seeded init or the checkpoint's weights, and a slot-cache
    engine over it. Materialization warms the engine's kernels
    (``warm_executables``), so their load lands here — in the context
    build — and never on the task hot path. ``build_stages`` holds the
    seconds of each stage: reading the checkpoint onto the device, the
    model, the engine."""
    cfg = cfg if cfg is not None else get_reduced_config(arch)
    dev = resolve(device)
    t0 = time.monotonic()
    params = load_params(checkpoint, cfg, dev) if checkpoint else None
    t1 = time.monotonic()
    model = build_model(cfg, device=dev, params=params, seed=0)
    t2 = time.monotonic()
    engine = InferenceEngine(model, device=dev, slots=slots,
                             cache_len=cache_len,
                             prefill_buckets=tuple(prefill_buckets),
                             megastep=megastep, cache_dtype=cache_dtype)
    stages = {"checkpoint_s": t1 - t0, "model_s": t2 - t1,
              "engine_s": time.monotonic() - t2}
    tok = HashTokenizer(cfg.vocab_size)
    return {"engine": engine, "tokenizer": tok, "cfg": cfg,
            "build_stages": stages}


def verify_claims(indices: Sequence[int], template: str,
                  max_new_tokens: int = 2
                  ) -> Tuple[List[List[int]], List[int]]:
    """In a PCM task: verify claims ``indices`` with prompt ``template``
    on the held context. Returns each claim's generated tokens and its
    verdict (1 when the first token is the claim's label token)."""
    engine = load_context("engine")
    tok = load_context("tokenizer")
    claims = fever.claim_batch(indices)
    prompts = [tok.encode(fever.render_prompt(c, template)) for c in claims]
    outs = engine.generate(prompts, max_new_tokens=max_new_tokens)
    preds = [o[0] if o else -1 for o in outs]
    golds = [LABEL_TOKENS[c.label] for c in claims]
    return outs, [int(p == g) for p, g in zip(preds, golds)]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """The CLI; returns each batch's generated tokens and verdicts, the
    claims correct, the sweep's seconds and the manager's stats (what it
    prints)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm2-1.7b")
    ap.add_argument("--claims", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--mode", choices=("agnostic", "partial", "full"),
                    default="full")
    ap.add_argument("--prompt", type=int, default=0,
                    help="prompt template index (Prompt-for-Fact sweep)")
    ap.add_argument("--preempt-after", type=int, default=0,
                    help="preempt a worker after N tasks (demo)")
    ap.add_argument("--megastep", type=int, default=8,
                    help="tokens generated per fused decode dispatch "
                         "(K=1 matches the classic per-token loop)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--checkpoint", default=None,
                    help="directory of a CheckpointManager whose latest "
                         "checkpoint holds the weights (default: seeded "
                         "init)")
    args = ap.parse_args(argv)

    resolve(args.device)
    mode = ContextMode(args.mode)
    mgr = PCMManager(mode=mode, n_workers=args.workers)
    recipe = make_recipe(f"{args.arch}.ctx", build_context,
                         (args.arch, 4, 128, args.megastep, None,
                          args.device, args.checkpoint))
    template = fever.PROMPT_CANDIDATES[args.prompt]

    @context_app(recipe=recipe, manager=mgr, n_items=args.batch_size)
    def verify_batch(indices):
        return verify_claims(indices, template)

    try:
        t0 = time.monotonic()
        futs = []
        n_batches = (args.claims + args.batch_size - 1) // args.batch_size
        for b in range(n_batches):
            idx = list(range(b * args.batch_size,
                             min((b + 1) * args.batch_size, args.claims)))
            futs.append(verify_batch(idx))
            if args.preempt_after and b == args.preempt_after:
                victim = next(iter(mgr.workers))
                print(f"[serve] preempting {victim}")
                mgr.preempt_worker(victim)
                mgr.add_worker()

        tokens, verdicts = zip(*(f.result() for f in futs))
        correct = sum(sum(v) for v in verdicts)
        dt = time.monotonic() - t0
        st = mgr.stats()
        print(f"[serve] mode={args.mode} claims={args.claims} "
              f"accuracy={correct / max(1, args.claims):.3f} "
              f"wall={dt:.1f}s cold={st['cold_invocations']} "
              f"warm={st['warm_invocations']} "
              f"context_build={st['context_build_seconds']:.1f}s "
              f"restores={st['context_restores']} "
              f"builder_calls={st['builder_calls']}")
    finally:
        mgr.shutdown()
    return {"tokens": list(tokens), "verdicts": list(verdicts),
            "correct": correct, "wall_s": dt, "stats": st}


if __name__ == "__main__":
    main()
