"""Quickstart: the PCMClient session API, on the card.

Port of ``examples/quickstart.py``, with the same sections and printed
lines, plus ``--device``. The reference's docstring is the tour of the
API; in short:

The paper's Fig. 5 transformation, session-style: an expensive
``load_model`` context builder is declared ONCE as a first-class
ContextHandle, decoupled from cheap ``infer_model`` tasks submitted in
bulk. The context (weights, the slot KV cache, the per-slot decode state
and the loaded kernels) is built once per worker and reused by every
later task, including after a no-warning preemption. Inference inside the
context runs as fused decode *megasteps*: one engine step generates up to
K tokens across all slots before the host syncs.

The SAME workload function (``run_workload``) runs against two backends:
the LIVE backend (``PCMManager``: worker threads with mailboxes, real
inference on the card) and the SIMULATOR backend (modeled placement and
timing, no model built). The sections of ``main``, each a function that
returns the counts it prints:

  1. ``live_client``         the context declared, warmed on 2 workers, a
                             claim sweep;
  2. ``preempt_and_restore`` a worker preempted with no warning (its tasks
                             requeue), then the context demoted to host
                             memory and restored with no builder call;
  3. ``peer_bootstrap``      a cold joiner fetching the context by striped
                             PEER transfer from warm donors;
  4. ``front_door``          streaming sessions, and an over-budget tenant
                             shed with an explicit ``ShedError``;
  5. ``paged_kv``            the paged KV cache: eight sessions through a
                             pool of two slots' bytes;
  6. ``prefix_sharing``      copy-on-write prefix sharing: one prefill per
                             shared template;
  7. ``multi_host``          a worker PROCESS (``repro_torch.cluster.node``)
                             joined over the socket transport, building,
                             demoting over the wire and restoring there;
  8. ``simulator``           the same workload on modeled cluster time.

The node process of section 7 imports ``load_model`` by its module path,
``repro_torch.examples.quickstart``: no extra import path is needed.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List

from repro_torch.configs import get_reduced_config
from repro_torch.core import (ContextMode, PCMClient, PCMManager,
                              SimulatorBackend, load_context, make_recipe)
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.device import resolve
from repro_torch.models import build_model
from repro_torch.models.layers import cdt
from repro_torch.serving import (InferenceEngine, Request, ShedError,
                                 SLOClass, TenantQuota)

ARCH = "smollm2-1.7b"
CONTEXT_NAME = "smollm2.verifier"
# the context's engine: 4 slots, megastep 8 (the reference's knobs;
# ``engine_kw`` adds the cache dtype)
ENGINE_KW = dict(slots=4, cache_len=64, prefill_buckets=(16, 32),
                 megastep=8)
# the paged pool of sections 5 and 6: eight slots over TWO contiguous
# slots' bytes (``paged_kw`` adds the cache dtype)
PAGED_KW = dict(slots=8, cache_len=64, prefill_buckets=(16,), megastep=8,
                paged=True, page_size=8, num_pages=2 * (64 // 8))
TEMPLATE = ("you are a fact checker given a claim answer supported or "
            "refuted with a short justification here is the claim to verify")


def engine_kw(cfg) -> Dict:
    """``ENGINE_KW`` with the cache in ``cfg``'s compute dtype: the decode
    kernels take q and K/V of one dtype. At the reduced f32 config it is
    the engine's default f32, as in the reference."""
    return dict(ENGINE_KW, cache_dtype=cdt(cfg))


def paged_kw(cfg) -> Dict:
    """``PAGED_KW`` with the pool in ``cfg``'s compute dtype, as
    ``engine_kw``; prefix sharing needs it as well (a bf16 model's f32
    pool would round shared K/V where a whole prefill does not)."""
    return dict(PAGED_KW, cache_dtype=cdt(cfg))


# ---- 1. the context builder (the paper's `load_model`) --------------------
def load_model(arch: str, device: str = "cuda", cfg=None):
    """What is RESIDENT in this context: the weights, the slot KV cache,
    the per-slot decode state and, because PCM materialization calls
    ``engine.warm_executables()``, the loaded kernel libraries. Tasks
    against a warm context build nothing and allocate nothing on the hot
    path. ``cfg`` defaults to ``arch``'s reduced config.

    ``megastep=8``: each engine step generates up to 8 tokens per active
    slot; the host syncs once per megastep (a (slots, 8) token block)
    instead of once per token. Larger K amortizes more dispatch and sync
    overhead (throughput) but admits queued requests at coarser
    boundaries (latency); greedy outputs are identical for every K."""
    print(f"  [context] building {arch} (the expensive one-time startup)...")
    cfg = cfg if cfg is not None else get_reduced_config(arch)
    model = build_model(cfg, device=device, seed=0)
    engine = InferenceEngine(model, device=device, **engine_kw(cfg))
    return {"engine": engine, "tokenizer": HashTokenizer(cfg.vocab_size)}


# ---- 2. the inference task (the paper's `infer_model`) --------------------
def infer_model(texts):
    engine = load_context("engine")
    tok = load_context("tokenizer")
    prompts = [tok.encode(t) for t in texts]
    return engine.generate(prompts, max_new_tokens=4)


def context(client: PCMClient, device: str = "cuda", cfg=None):
    """The quickstart's context handle: ``load_model(ARCH, device[,
    cfg])`` under the name ``CONTEXT_NAME``."""
    args = (ARCH, device) if cfg is None else (ARCH, device, cfg)
    return client.context(load_model, *args, name=CONTEXT_NAME)


# ---- 3. one workload, any backend -----------------------------------------
def run_workload(client: PCMClient, claims, batch_size=4,
                 device: str = "cuda", cfg=None):
    """Declare the context, warm it, sweep the claims. Identical code for
    the live runtime and the dry-run simulator."""
    ctx = context(client, device, cfg)
    ctx.warm_up()            # materialize off the task critical path
    with ctx:                # pinned for the block: survives mode eviction
        batch = client.map(infer_model, claims, batch_size=batch_size,
                           context=ctx)
        results = batch.gather(timeout=600)
    tiers = {w: t.name for w, t in ctx.residency().items()}
    return results, tiers


def live_client(claims: List[str], device: str = "cuda", cfg=None):
    """Section 1: a 2-worker live client runs the workload. Returns the
    client (the later sections reuse it) and the counts printed."""
    print("== live backend: real PyTorch inference ==")
    client = PCMClient(mode=ContextMode.FULL, n_workers=2)
    t0 = time.monotonic()
    results, tiers = run_workload(client, claims, device=device, cfg=cfg)
    st = client.stats()
    print(f"verified {sum(len(r) for r in results)} claims in "
          f"{time.monotonic() - t0:.2f}s")
    print(f"context prewarmed on {len(tiers)} workers "
          f"({st['cold_invocations']} cold invocations, "
          f"{st['warm_invocations']} warm); residency: {tiers}")
    return client, dict(results=results, tiers=tiers,
                        cold=st["cold_invocations"],
                        warm=st["warm_invocations"],
                        builder_calls=st["builder_calls"])


def preempt_and_restore(client: PCMClient, claims: List[str],
                        device: str = "cuda", cfg=None) -> Dict:
    """Section 2: the warm worker dies with no warning and its tasks
    requeue elsewhere; then the context leaves the device (a host-RAM
    snapshot in the node pool) and comes back at restore cost, with no
    builder rerun and no kernel build."""
    victim = client.workers[0]
    print(f"preempting worker {victim} (no warning)...")
    client.backend.preempt_worker(victim)
    ctx = context(client, device, cfg)
    more = client.map(infer_model, claims[:4], batch_size=2, context=ctx)
    requeued = 0
    for fut in more.as_completed(timeout=600):
        if fut.result() is None:
            raise RuntimeError("a requeued task returned nothing")
        requeued += 1
    print("requeued tasks completed on the surviving warm worker.")

    calls0 = client.stats()["builder_calls"]
    demoted = ctx.demote()                       # DEVICE -> HOST_RAM
    tier = ctx.snapshot_tier().name
    print(f"demoted context off {len(demoted)} worker(s); snapshot tier: "
          f"{tier}")
    t0 = time.monotonic()
    fut = client.submit(infer_model, claims[:2], context=ctx)
    if fut.result(timeout=600) is None:
        raise RuntimeError("the restored context returned nothing")
    st = client.stats()
    print(f"restored + ran in {time.monotonic() - t0:.2f}s "
          f"({st['context_restores']} restore(s), builder ran "
          f"{st['builder_calls']}x total — cold build took "
          f"{st['context_build_seconds']:.1f}s)")
    return dict(victim=victim, requeued_completed=requeued,
                demoted=len(demoted), snapshot_tier=tier,
                restores=st["context_restores"],
                builds_during_restore=st["builder_calls"] - calls0,
                builder_calls=st["builder_calls"])


def peer_bootstrap(client: PCMClient, claims: List[str],
                   device: str = "cuda", cfg=None) -> Dict:
    """Section 3: a cold joiner bootstraps the context by striping
    verified chunks from warm donors (and the node snapshot pool)
    instead of waiting on one monolithic export."""
    print("== streamed restores: striped peer bootstrap ==")
    ctx = context(client, device, cfg)
    joiner = client.backend.add_worker()
    deadline = time.monotonic() + 120
    while not client.backend.fetch_history():       # keep demand pending
        batch = client.map(infer_model, claims[:6], batch_size=2,
                           context=ctx)
        for fut in batch.as_completed(timeout=600):
            if fut.result() is None:
                raise RuntimeError("a task returned nothing")
        if time.monotonic() > deadline:
            break
    st = client.stats()
    stripes = st["striping"]
    hist = client.backend.fetch_history()
    how = hist[-1].source.value if hist else "warm"
    print(f"worker {joiner} joined cold and fetched the context via "
          f"{how}: {stripes['stripes']} stripe(s), {stripes['chunks']} "
          f"verified chunks, {stripes['lane_failures']} lane failures, "
          f"{stripes['degrades']} degrades — builder still ran "
          f"{st['builder_calls']}x total, serving never paused")
    return dict(joiner=joiner, source=how, striping=dict(stripes),
                builder_calls=st["builder_calls"])


def front_door(client: PCMClient, vocab_size: int, device: str = "cuda",
               cfg=None) -> Dict:
    """Section 4: an interactive tenant streams token by token; a
    rate-limited tenant hits explicit backpressure instead of degrading
    everyone else."""
    print("== streaming sessions: the front door ==")
    ctx = context(client, device, cfg)
    tok = HashTokenizer(vocab_size)
    client.frontdoor(quotas={"freeloader": TenantQuota(
        tokens_per_second=0.1, burst_tokens=24.0, max_queued_turns=4)})
    with client.session(ctx, tenant="acme",
                        slo=SLOClass.INTERACTIVE) as sess:
        stream = sess.submit(tok.encode("what is the capital of nowhere"),
                             max_new_tokens=8)
        toks = [t for t in stream]               # arrives per megastep
        print(f"streamed {len(toks)} tokens, ttft "
              f"{stream.ttft_seconds * 1e3:.1f}ms")
    sheds = []
    with client.session(ctx, tenant="freeloader") as cheap:
        cheap.submit(tok.encode("one is fine"), max_new_tokens=8).result(
            timeout=600)
        try:
            cheap.submit(tok.encode("two is too many"), max_new_tokens=8)
        except ShedError as e:
            sheds.append(e.reason)
            print(f"over-budget tenant shed: {e.reason} "
                  f"(retry after {e.retry_after_seconds:.0f}s)")
    return dict(streamed=toks, ttft_s=stream.ttft_seconds, sheds=sheds)


def paged_kv(model, tok: HashTokenizer, device: str = "cuda") -> Dict:
    """Section 5: the same engine API over the paged pool, sessions
    bounded by live tokens instead of slots x cache_len, and snapshots
    that ship only the pages requests own. Returns the counts printed,
    the prompts, each session's tokens and the engine."""
    print("== paged KV cache: more sessions per GPU, live-byte snapshots ==")
    paged = InferenceEngine(model, device=device, **paged_kw(model.cfg))
    prompts = [tok.encode(f"short question {i}") for i in range(8)]
    reqs = [paged.submit(Request(prompt=p, max_new_tokens=8))
            for p in prompts]
    peak = 0
    while paged.has_work():
        paged.step()
        peak = max(peak, paged.stats.live_pages)
    snap = paged.snapshot()
    print(f"{paged.stats.completed} sessions through a "
          f"{snap['capacity_bytes']} byte pool (2 contiguous slots' "
          f"worth), peak {peak} live pages; snapshots ship live bytes "
          f"only ({snap['live_bytes']} idle vs {snap['capacity_bytes']} "
          "allocated)")
    return dict(completed=paged.stats.completed, peak_pages=peak,
                capacity_bytes=snap["capacity_bytes"],
                live_bytes=snap["live_bytes"], prompts=prompts,
                tokens=[r.generated for r in reqs], engine=paged)


def prefix_sharing(model, tok: HashTokenizer, device: str = "cuda") -> Dict:
    """Section 6: copy-on-write prefix sharing, one prefill per shared
    template (the fact-verification shape: one shared preamble, a
    per-claim tail). Returns the counts printed, the prompts, each
    session's tokens and the engine."""
    print("== prefix sharing: one prefill per shared prompt template ==")
    template = tok.encode(TEMPLATE)
    shared = InferenceEngine(model, device=device, **paged_kw(model.cfg))
    prompts = [template + tok.encode(f"claim {i}") for i in range(8)]
    reqs = [shared.submit(Request(prompt=p, max_new_tokens=8))
            for p in prompts]
    shared.run_to_completion()
    stp = shared.stats
    print(f"{stp.completed} sessions over a {len(template)}-token shared "
          f"template: {stp.prefix_hits} prefix hits, "
          f"{stp.prefix_tokens_reused} prompt tokens served from shared "
          f"pages, {stp.cow_copies} copy-on-write page copies, only "
          f"{stp.prefill_tokens} tokens actually prefilled")
    return dict(completed=stp.completed, prefix_hits=stp.prefix_hits,
                prefix_tokens_reused=stp.prefix_tokens_reused,
                cow_copies=stp.cow_copies,
                prefill_tokens=stp.prefill_tokens, prompts=prompts,
                tokens=[r.generated for r in reqs], engine=shared)


def multi_host(claims: List[str], device: str = "cuda") -> Dict:
    """Section 7: a worker that is a PROCESS joins the pool over the
    socket transport. The context builder must be importable BY NAME in
    the node process (pickle by reference): ``load_model`` is, as
    ``repro_torch.examples.quickstart.load_model``. Contexts cross the
    wire as chunked-sha256 blobs, and the node loads the kernels from
    the build directory instead of building them again."""
    print("== multi-host: a worker process over the socket transport ==")
    from repro_torch.cluster.node import spawn_node_process
    # this module by its name, also when it runs as __main__: the node
    # process resolves the builder and the task by that name
    from repro_torch.examples import quickstart as qs
    mh = PCMManager(mode=ContextMode.FULL, n_workers=0)
    node_proc = None
    try:
        addr = mh.listen()
        node_proc = spawn_node_process(addr, "node-1", device=device)
        mh.wait_for_workers(["node-1"], timeout=180)
        recipe = make_recipe("smollm2.verifier.mh", qs.load_model,
                             (ARCH, device))
        mh.warm_up(recipe)           # builds IN the node process
        out = mh.submit(qs.infer_model, args=(claims[:2],),
                        recipe=recipe).result(timeout=600)
        if out is None:
            raise RuntimeError("the node's task returned nothing")
        mh.demote_context(recipe)    # snapshot crosses the wire -> pool
        t0 = time.monotonic()
        out = mh.submit(qs.infer_model, args=(claims[:2],),
                        recipe=recipe).result(timeout=600)
        mir = mh.workers["node-1"].library
        print(f"node-1 (pid {node_proc.pid}) built once "
              f"({mir.builder_calls}x), demoted over the wire, then "
              f"restored + ran in {time.monotonic() - t0:.2f}s "
              f"({mir.restores} restore(s), sources "
              f"{[s.name for s in mir.fetch_sources]})")
        res = dict(builder_calls=mir.builder_calls, restores=mir.restores,
                   sources=[s.name for s in mir.fetch_sources],
                   tokens=out)
    finally:
        mh.shutdown(timeout=60)
        if node_proc is not None:
            node_proc.terminate()
            node_proc.wait(timeout=60)
    return res


def simulator() -> Dict:
    """Section 8: the same workload on the simulator backend, modeled
    cluster time on 8 A10s; no model is built."""
    print("== simulator backend: same workload, modeled cluster time ==")
    sim = PCMClient(backend=SimulatorBackend(n_workers=8, profile="a10",
                                             mode=ContextMode.FULL))
    sim_claims = [f"claim {i}" for i in range(800)]
    results, tiers = run_workload(sim, sim_claims, batch_size=50)
    st = sim.stats()
    print(f"modeled {sum(r.n_items for r in results)} inferences on 8xA10 "
          f"in {st['now']:.0f} simulated seconds "
          f"({st['warm_starts']} warm / {st['cold_starts']} cold starts, "
          f"{st['p2p_transfers']} P2P bootstraps)")
    return dict(inferences=sum(r.n_items for r in results),
                simulated_s=st["now"], warm_starts=st["warm_starts"],
                cold_starts=st["cold_starts"],
                p2p_transfers=st["p2p_transfers"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    device = str(resolve(args.device))
    claims = [f"claim number {i} about the capital of somewhere"
              for i in range(12)]
    out = {}
    client, out["live"] = live_client(claims, device)
    try:
        out["restore"] = preempt_and_restore(client, claims, device)
        out["peer"] = peer_bootstrap(client, claims, device)
        cfg = get_reduced_config(ARCH)
        out["front_door"] = front_door(client, cfg.vocab_size, device)
    finally:
        client.shutdown()
    tok = HashTokenizer(cfg.vocab_size)
    model = build_model(cfg, device=device, seed=0)
    out["paged"] = paged_kv(model, tok, device)
    out["prefix"] = prefix_sharing(model, tok, device)
    out["multi_host"] = multi_host(claims, device)
    out["simulator"] = simulator()
    return out


if __name__ == "__main__":
    main()
