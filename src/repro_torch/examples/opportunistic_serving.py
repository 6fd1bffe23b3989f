"""Opportunistic cluster serving: the paper's RQ3/RQ4 regimes on the LIVE
elastic runtime — real inference on the card, workers joining and leaving
under a capacity trace, and peer-to-peer context bootstrap from warm
donors — or, with ``--backend sim``, the same regimes as the
cluster-scale deterministic discrete-event simulation.

Port of ``examples/opportunistic_serving.py``, with the same flags,
defaults and printed lines, plus ``--device``.

Run:  PYTHONPATH=src python -m repro_torch.examples.opportunistic_serving \\
          [--backend live|sim] [--trace rq3|rq4] [--tasks N] [--device cpu]

The live run compresses the paper's trace timeline (``rq3``: 1 GPU
preempted per minute; ``rq4``: capacity ramping up from scarcity) onto a
laptop-scale pool: an :class:`~repro_torch.core.ElasticRunner` reconciles
the worker pool against the trace on a background thread while
``client.map`` drains a FEVER claim-verification sweep. Joiners bootstrap
their context down the FetchSource ladder — peer-to-peer from a warm donor
when one has a free fanout slot, else from the node snapshot pool, else
the builder — so the sweep keeps its throughput through churn without
re-paying startup. The pool's ``a10`` and ``titan-x-pascal`` profiles are
labels that size each worker's store: every worker is a thread, and every
worker's engine sits on the one card.

The context builder closes over ONE model, as the reference's does, so
every engine the builder makes reads the same parameters; a preempted
worker's demote leaves them to the engines still serving
(``InferenceEngine.offload_device_state``).
"""

from __future__ import annotations

import argparse
import threading
import time
from typing import Dict, List, Optional

from repro_torch.cluster import CostModel, simulate_sweep, traces
from repro_torch.core import (ContextMode, ContextRecipe, ElasticRunner,
                              PCMClient, PCMManager, load_context,
                              make_recipe)
from repro_torch.device import resolve

# each live worker's engine (the reference's knobs)
ENGINE_KW = dict(slots=4, cache_len=64, prefill_buckets=(32,), megastep=4)
CLAIMS_PER_TASK = 8


def simulated_cluster(trace: str):
    """Fig. 8/9 at full scale (567-GPU census, deterministic DES)."""
    recipe = ContextRecipe(name="smollm2-pff")
    cost = CostModel()
    if trace == "rq3":
        print("== simulated: aggressive preemption (1 GPU/min from "
              "t=900s) ==")
        for mode in (ContextMode.PARTIAL, ContextMode.FULL):
            r = simulate_sweep(mode, traces.rq3_aggressive_preemption(),
                               recipe, 150_000, 100, cost=cost, until=4_000)
            print(f"  {mode.value:8s}: {r.total_inferences:7d} inferences "
                  f"completed, {r.preemptions} preemptions "
                  f"(paper: partial 46k, full 62.9k)")
        return
    print("== simulated: opportunistic scale-out to 186 GPUs ==")
    r = simulate_sweep(ContextMode.FULL, traces.rq4_high_capacity(), recipe,
                       150_000, 100, cost=cost)
    print(f"  full-context finished 150k inferences in {r.end_time:.0f}s "
          f"(paper: 783s) using up to "
          f"{max(n for _, n in r.worker_samples)} GPUs; "
          f"{r.p2p_transfers} P2P bootstraps vs {r.fs_transfers} from "
          "the shared FS")


def build_verifier(cfg=None, device: str = "cuda"):
    """The live run's model: ``cfg`` (default the reduced SmolLM2-1.7B) on
    ``device`` with the port's seeded init."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import build_model
    cfg = cfg if cfg is not None else get_reduced_config("smollm2-1.7b")
    return build_model(cfg, device=device, seed=0)


def engine_recipe(model, device: str = "cuda",
                  builds: Optional[List[Dict]] = None):
    """The context recipe: every builder call wraps ``model`` in a fresh
    engine (``ENGINE_KW``). ``builds``, when given, gets a record of each
    builder call: the thread (a worker's) it ran on and the kernel builds
    of its engine (``stats.compiles``)."""
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.serving import InferenceEngine

    def load_model():
        engine = InferenceEngine(model, device=device, **ENGINE_KW)
        if builds is not None:
            builds.append({"thread": threading.current_thread().name,
                           "compiles": engine.stats.compiles})
        return {"engine": engine, "tok": HashTokenizer(model.cfg.vocab_size)}

    return make_recipe("live.verifier", load_model, host_bytes=0)


def live_trace(name: str):
    """The paper traces, time-compressed onto a 4-GPU live pool: one
    trace second per wall second, but with the paper's minutes-scale
    events pulled into the first seconds of the run."""
    pool = ["a10", "a10", "titan-x-pascal", "titan-x-pascal"]
    if name == "rq3":
        # depletion regime: full pool up front, 1 GPU reclaimed every 2.5s
        # from t=3s down to a single survivor (floor=1: unlike the paper's
        # full depletion, the demo must drain its queue)
        return traces.rq3_aggressive_preemption(start_at=3.0, period=2.5,
                                                pool=pool, floor=1)
    # scarcity regime: start with 1 GPU, one more every 3s up to 4 —
    # joiners bootstrap P2P from whoever is already warm
    return traces.rq4_low_capacity(ramp_every=3.0, start=1, cap=4,
                                   pool=pool)


def task_claims(n_tasks: int) -> List[List[int]]:
    """The sweep's tasks: claims 8b .. 8b + 7 for task b."""
    return [list(range(b * CLAIMS_PER_TASK, (b + 1) * CLAIMS_PER_TASK))
            for b in range(n_tasks)]


def verify(indices):
    """One task: verify claims ``indices`` on the held context -> each
    claim's first generated token (``verdicts`` reads them)."""
    from repro_torch.data import fever
    engine = load_context("engine")
    tok = load_context("tok")
    outs = engine.generate(
        [tok.encode(fever.render_prompt(c))
         for c in fever.claim_batch(indices)], max_new_tokens=1)
    return [o[0] for o in outs]


def verdicts(tokens, indices) -> List[int]:
    """1 for each claim of ``indices`` whose first token is its label."""
    from repro_torch.data import fever
    from repro_torch.data.tokenizer import LABEL_TOKENS
    return [int(t == LABEL_TOKENS[c.label])
            for t, c in zip(tokens, fever.claim_batch(indices))]


def live_elastic(trace: str, n_tasks: int, cfg=None, device: str = "cuda",
                 model=None, time_scale: float = 1.0) -> Dict:
    """Real models under the real trace: the elastic factory joins and
    preempts live workers while the claim sweep drains. ``model``
    (default ``build_verifier(cfg, device)``) is the one model every
    engine wraps; ``time_scale`` runs the trace that many times faster
    than the wall clock (``ElasticRunner``). Prints the reference's lines
    and returns what they print, with each task's first tokens and
    verdicts, the builder calls, the task invocations (a preempted one's
    first run included) and the preempted tasks."""
    print(f"== live: elastic pool under the {trace} trace ==")
    if model is None:
        model = build_verifier(cfg, device)
    builds: List[Dict] = []
    recipe = engine_recipe(model, device, builds)
    mgr = PCMManager(mode=ContextMode.FULL, n_workers=0)
    client = PCMClient(backend=mgr)
    runner = ElasticRunner(mgr, live_trace(trace), reconcile_every=0.25,
                           time_scale=time_scale)

    t0 = time.monotonic()
    runner.start()
    try:
        batch = client.map(verify, task_claims(n_tasks),
                           context=client.context(recipe), timeout=900)
        tokens = batch.gather()
        judged = [verdicts(t, idx)
                  for t, idx in zip(tokens, task_claims(n_tasks))]
        total = sum(sum(r) for r in judged)
    finally:
        runner.stop()
        wall = time.monotonic() - t0
        st = mgr.stats()
        mgr.shutdown()
    sources = [d.source.value for d in mgr.fetch_history()]
    tasks = mgr.scheduler.tasks.values()
    claims = n_tasks * CLAIMS_PER_TASK
    print(f"  {claims} claims verified ({total} correct) in "
          f"{wall:.1f}s through {runner.joins} joins / "
          f"{runner.preemptions} preemptions "
          f"({claims / wall:.1f} claims/s)")
    print(f"  context acquisitions: {st['builder_calls']} builds, "
          f"{st['peer_installs']} peer transfers, "
          f"{st['context_restores']} pool restores "
          f"(ladder decisions: {sources})")
    return dict(claims=claims, correct=total, tokens=tokens,
                verdicts=judged,
                wall_s=wall, claims_per_s=claims / wall,
                joins=runner.joins, preemptions=runner.preemptions,
                builder_calls=st["builder_calls"],
                peer_installs=st["peer_installs"],
                context_restores=st["context_restores"], sources=sources,
                builds=builds,
                invocations=st["cold_invocations"] + st["warm_invocations"],
                requeued=sorted(t.task_id for t in tasks if t.attempts),
                failed=len(mgr.scheduler.failed),
                completed=st["completed"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", choices=("live", "sim"), default="live")
    ap.add_argument("--trace", choices=("rq3", "rq4"), default="rq4")
    ap.add_argument("--tasks", type=int, default=12,
                    help="live mode: number of 8-claim tasks")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    resolve(args.device)
    if args.backend == "sim":
        simulated_cluster(args.trace)
    else:
        live_elastic(args.trace, args.tasks, device=args.device)


if __name__ == "__main__":
    main()
