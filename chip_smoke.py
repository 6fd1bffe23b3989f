#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card, end to end.

Run from the root of a checkout:  python3 chip_smoke.py [--out report.json]

With --faults it runs phases 1-2 and then only the comparisons of phases
6 and 7, with no fault and with each fault of PlantFault planted in the
kernel engine of its model at run time: the readings behind the routing
bounds and the logits tolerances. It exits 0 when the sound run passes
and every fault is caught, and prints no ok line.

Phases (any failure exits non-zero; no phase swallows an exception):
  1. card     - the card's name and power limit, torch and CUDA versions;
  2. build    - nvcc builds the hand-written kernels from csrc/;
  3. kernels  - each kernel against its plain PyTorch version on the card,
                at the main-path shapes and a few sweep shapes (the paged
                decode over scattered pages, page sizes 7 and 16, GQA, a
                poisoned TRASH page; the prefill with per-row query
                offsets, whose bf16 tail rows must equal a whole-prompt
                call's bit for bit; the paged MLA decode at
                DeepSeek-V2-Lite's shape and at pages of 7 and 16; the
                grouped expert GEMM at the
                reference's sweep and over rows sorted by expert at the
                decode, prefill and fact-verification (e) dispatches; the
                slot and paged decode on the same K/V, which must give the
                same bits; the SSD scan at Zamba2's prefill waves with B
                and C per group (as its Mamba2 layers call it) and per
                head, the reference's sweep and a padded row; the prefill
                and decode
                attention at Zamba2's head dim 112; the prefill at head
                dim 80 with H2O-Danube's 4096-token window over an 8 x
                8192 wave, at head dim 160 and at GQA group 6, the decode
                at head dim 80 over a full 4096-key ring, at 160 and at
                group 6, the paged decode at 160, bitwise the slot
                kernel's, and f32 checks at 80 and 160; the prefill not
                causal at Whisper's encoder (16 x 1500 frames) and at the
                cross-attention prefill over a memory (512 queries over
                Llama-3.2-Vision's 4100 patch keys, 256 over Whisper's
                1500 frames), the decode over both memories at n_valid =
                Skv), with times beside the
                least time the card could take (bound_ms), the achieved
                TB/s or TFLOP/s, and a PyTorch library call computing the
                same function where there is one (every kernel and its
                library call timed as device time, replayed from a CUDA
                graph, and also as eager launches);
  4. serve    - full-width SmolLM2-1.7B (seeded random weights, bf16)
                with the kernels: (a) fact verification, 4 prompt templates
                x 64 claims, one token each, and (b) 16 long prompts of
                64-500 tokens, 64 new tokens each, through the slot-cache
                engine; (c) mix (b) through the paged pool; (d) few-shot
                fact verification, 64 claims behind one shared 448-token
                preamble, 8 new tokens each, through the paged pool with
                prefix sharing and without it. Each path runs with the
                launch counts set to 0 and must show its kernels ran; (a)-
                (c) through use_kernels=False engines over the same
                weights must agree; (c) must give (b)'s tokens and (d)'s
                shared run its cold run's, first-token logits bitwise;
                (b) and (c) served again at 32 new tokens, three times
                with the megastep's per-step stop-flag read and three
                without, alternating, for its cost in decode tok/s;
                torch.profiler over (b);
  5. pcm      - a context's cold build, its demote to pinned host memory
                and its restore, after which (b) decodes identically; then
                the paged sharing engine of (d) demoted (weights and live
                pages only), restored and run on (d) again (every wave
                hits, same tokens), and a template of it cloned into a
                twin that serves (c) with the same tokens and no build;
  5b. runtime - full-width SmolLM2-1.7B through the PCM runtime
                (repro_torch.core): the seeded weights written with the
                port's CheckpointManager; a 2-worker PCMManager whose
                workers build their context with launch/serve.py's
                build_context from that checkpoint (slot cache, 16 slots,
                256 tokens, bf16 cache); fact verification, 4 templates x
                64 claims in batches of 16, two new tokens each, through
                context_app, with worker 0 preempted after 4 batches and a
                replacement added; then one context DEVICE -> HOST_RAM ->
                LOCAL_DISK -> DEVICE, streamed, and one more batch. Prints
                claims/s against a bare engine's, each worker's cold build,
                the fetch_log, builder calls, restore and stage seconds and
                the bytes moved; every claim's tokens must equal the bare
                engine's, the replacement must come from the pool or a
                peer, the builder may run only for the workers that built
                cold, and the kernels must launch;
  5c. multihost - the same mix from two worker node processes on the card
                (python -m repro_torch.cluster.node, a CUDA context each)
                joined to PCMManager.listen() over loopback, from 5b's
                checkpoint: node A builds the context cold and serves the
                first 4 batches; node B joins with --aot-cache at the
                build directory and bootstraps the 4.2 GB context from A
                by PEER over the socket (striped, sha256-verified chunks)
                while A serves the other 12; a steady sweep of the 16 on
                both nodes (claims/s against 5b's bare engine); a sweep
                during which A is killed with SIGKILL, its task requeued to
                B. Every batch's tokens and verdicts must equal the bare
                engine's, B must build nothing (each kernel library a
                cache hit) and each task's kernel launches, counted in its
                node, must match its waves and decode steps;
  5d. frontdoor - full-width SmolLM2-1.7B sessions through the streaming
                front door (repro_torch.serving.frontdoor) over a 2-worker
                in-process PCMManager whose workers build the paged pool
                with prefix sharing (phase 4 (d)'s knobs) from 5b's
                checkpoint, two lanes: (1) 16 mix (d) turns on one session
                under the template's prefix key, every stream equal to a
                bare engine replaying the waves the pump formed (a plain
                generate of the 16 is compared for the record); (2) open-
                loop sessions (traces.poisson_sessions, 20/s for 4 s) of
                three tenants: verify (BATCH, mix (d), prefix key), chat
                (INTERACTIVE, mix (b), 32 new tokens) and cheap (BATCH,
                under a quota that sheds), each turn completed with the
                replay's tokens or shed with a reason; TTFT p50/p99 by SLO
                class, streamed tokens/s, prefix reuse, no builder call and
                no kernel build after warm-up; (3) the pool cut to one
                worker, three chat turns, that worker preempted once the
                first has streamed, a replacement that takes the context
                from the pool, every stream the replay's tokens; (4) step
                2's turns through a FrontDoor over the SimulatorBackend on
                modeled time: the same lanes, admissions, sheds and fetch
                sources. Steps 1-3 each run with the launch counts at 0
                and must launch what their waves and decode steps call
                for;
  5e. train   - the port's training path (repro_torch.train, plain
                PyTorch under autograd, as the reference trains without
                its kernels): (1) full-width, full-depth SmolLM2-1.7B
                (seeded bf16 weights, f32 AdamW moments, remat "block")
                trained 6 steps on data/pipeline.py's fact task, 16 x 128
                tokens a step in two microbatches, CE in chunks of 64, no
                checkpoint: every loss finite and the last below the
                first; step time, tokens/s, peak memory and the 6ND share
                of the bf16 peak; (2) the reduced SmolLM2 in f32, three
                steps from the same seeded weights and batches on the
                card and on the CPU, losses and parameters held together;
                (3) full width at depth 2: four steps with checkpoints at
                3 and 4 (the reference's layout), then train(total_steps=
                6) in that directory, which must resume at step 5 with an
                uninterrupted run's losses; (4) step 1's verifier served
                on the slot cache through the kernels and on the plain
                path, mix (a) (4 templates x 64 claims, one token), with
                the launch counts at 0: phase 4's comparison (logits
                within LOGIT_TOL, tokens equal wherever the margin
                exceeds it), flash_attention launched 24 x the waves,
                each template's verification accuracy; and a
                flash_attention call on a tensor that requires grad must
                raise;
  6. deepseek - full-width DeepSeek-V2-Lite-16B (MLA + MoE, 27 layers,
                15.7 B parameters, seeded random bf16 weights drawn on the
                card) on the paged pool with the kernels: (e) fact
                verification, 4 templates x 64 claims, one token each, and
                (f) mix (b)'s 16 long prompts, 64 new tokens each, each with
                the launch counts set to 0 (the paged MLA decode and the
                grouped GEMM must run), against a use_kernels=False engine
                over the same weights: greedy agreement, the first-token
                logits gap and the routing decisions that differed. Its
                demote/restore (31 GB of pinned host memory) is left to the
                CPU tests; then torch.profiler over (f) on the kernel
                engine;
  7. zamba2   - full-width Zamba2-7B (81 Mamba2 layers and one shared
                attention block applied 13 times, 6.79 B parameters,
                seeded random bf16 weights drawn on the card) on the slot
                cache with the kernels (a paged request falls back to it):
                (g) fact verification, 4 templates x 64 claims, one token
                each, and (h) mix (b)'s 16 long prompts, 64 new tokens each,
                each with the launch counts set to 0 (the SSD scan in every
                Mamba2 layer's prefill, the prefill and decode attention at
                head dim 112 in every application of the shared block),
                against a use_kernels=False engine over the same weights:
                the first-token logits gap and greedy agreement, and the
                same in f32 with the depth cut to 7 layers; the plain
                engine again with its attention rounding P to bf16 before
                P.V, as the kernel does (a witness of what that rounding
                adds to the gap); (h) served again with the stop-flag
                read off and on, as (b); then
                torch.profiler over (h)'s prompts at 16 new tokens. Its
                demote/restore (about 19 GB of pinned host memory) is left
                to the CPU tests;
  8. dense    - the dense GQA decoders Granite-3-2B, StableLM-12B (head
                dim 160) and Nemotron-4-15B (GQA group 6) and the
                sliding-window decoder H2O-Danube-1.8B (head dim 80, a
                4096-token window), one at a time, at full width and a
                quarter of their depth (DENSE_DEPTH), seeded random bf16
                weights drawn on the card, with the kernels: mixes (a) and
                (b) on the slot cache; for the three full-attention models
                (c) on the paged pool, which must give (b)'s tokens, and
                (d) with prefix sharing on and off, whose first-token
                logits must be bitwise equal; for Danube a paged request
                that must keep the slot cache with the reference's
                reasons, a long mix (8 prompts of 3 000-6 000 tokens in one
                8192 wave, 64 new tokens, its 4096-position rings
                wrapping), and the first decode step of prompts inside the
                window against a plain forward. Each path runs with the
                launch counts at 0 and must launch what its waves and
                decode steps call for, and is held against a
                use_kernels=False engine over the same weights (phase 4's
                comparison at LOGIT_TOL);
  9. families - xLSTM-350M (sLSTM + mLSTM, no attention), Whisper-small
                (encoder-decoder) and Llama-3.2-Vision-11B (gated cross-
                attention image layers, their gates set to 1.0: zero at
                init, they would add nothing), one at a time, at full
                width and depth, seeded random bf16 weights drawn on the
                card, the frontend inputs (Whisper's 16 x 1500 frames,
                the VLM's 16 x 4100 patches) drawn from a seed as the
                engine's extra, on the slot cache (a paged request must
                fall back with the reference's reason): mixes (a) and (b)
                with the launch counts at 0 (Whisper and the VLM launch
                the prefill kernel for every self- and cross-attention and
                encoder layer of a wave and the decode kernel for every
                self- and cross-attention of a step; xLSTM launches
                nothing), against a use_kernels=False engine over the
                same weights (phase 4's comparison at LOGIT_TOL); (b) at
                megastep 1, whose tokens must equal megastep 8's; xLSTM
                and Whisper demoted to host and restored, after which (b)
                decodes the same; the VLM's patches must move its logits
                by more than LOGIT_TOL.
 10. sharded  - the sharded path (launch/steps.py) over a one-rank NCCL
                mesh (1, 1) of ("data", "model"), started from a
                FileStore: SmolLM2-1.7B's train cell (16 x 128 tokens, 2
                microbatches, remat "block") 3 steps against the unsharded
                train step from the same weights and batches (losses
                within 1e-5); its prefill cell (16 x 512 into a cache of
                1024) against the unsharded kernel path (LOGIT_TOL) and 16
                greedy steps of its decode cell, tokens equal; each cell
                with the launch counts at 0 (flash_attention, flash_decode);
                DeepSeek-V2-Lite-16B's prefill cell (16 x 256) under the
                experts rule, the expert-parallel MoE on the grouped GEMM
                (capacity 768 at the reference's prefill factor 2.0), then
                its first MoE layer's capacity pass at the config's 1.25
                (capacity 480) on the kernel against the plain pass, the
                dropped assignments counted, and the grouped GEMM timed at
                (64, 480, 2048) x (64, 2048, 1408) beside a padded bmm and
                its bound; Qwen3-MoE-235B planned on a (16, 16) shape-only
                mesh on the meta device (bytes of weights a rank).
 11. dryrun   - (1) python -m repro_torch.launch.dryrun on the card
                (--device cuda: fake CUDA tensors on a fake world of 256
                or 512 ranks, nothing allocated, no collective run), one
                subprocess a cell, all started together: DeepSeek-V2-
                Lite prefill_32k (MLA, the expert-parallel MoE), Granite
                decode_32k, Zamba2 long_500k, Qwen3-MoE-235B decode_32k,
                xLSTM decode_32k on 2x16x16, Whisper train_4k
                --gate-only; every cell ok; the roofline table of their
                artifacts (H100 constants) and perf.py's line for
                Granite decode_32k --set kv_update=mask against its
                artifact; (2) SmolLM2's prefill (16 x 512 into a cache
                of 1024) and train (16 x 128, 2 microbatches) cells of
                phase 10 on a one-rank mesh, plain path, over fake
                tensors in a fake world and over real ones in an NCCL
                world: FLOPs and collective bytes equal, the dry-run's
                peak bytes within DRYRUN_MEM_* of max_memory_allocated's
                rise, the device time (median of 5) beside the
                roofline's step_seconds_bound.

The line before the last is the card's name and power limit as nvidia-smi
gives them; the last line is {"ok": true, "device": {...}}. Needs one CUDA
card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa
from repro_torch.configs.shapes import SHAPES, ShapeSuite  # noqa: E402
from repro_torch.cluster import traces  # noqa: E402
from repro_torch.cluster.node import spawn_node_process  # noqa: E402
from repro_torch.core import (ContextMode, PCMClient, PCMManager,  # noqa
                              SimulatorBackend, Tier, context_app,
                              load_context, make_recipe)
from repro_torch.data import (HashTokenizer, PipelineConfig,  # noqa: E402
                              batches, fever)
from repro_torch.data.tokenizer import BOS, LABEL_TOKENS  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels.moe_gemm import gemm_shape  # noqa: E402
from repro_torch.launch import hlo, roofline  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import sharding as shp  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import attention as attn_lib  # noqa: E402
from repro_torch.models import build_model, extra_inputs  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models.registry import abstract_model  # noqa: E402
from repro_torch.serving import (InferenceEngine, Request,  # noqa: E402
                                 ShedError, SLOClass, TenantQuota)
from repro_torch.train import (LoopConfig, OptimizerConfig,  # noqa: E402
                               init_state, make_train_step, train,
                               trainable)
from repro_torch.train.trainstep import to_device  # noqa: E402
from repro_torch.weights import init_params  # noqa: E402

# kernel-vs-plain tolerances, max-abs (tests/test_kernels.py:16)
TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
# first-token logits, kernel engine vs plain engine, both bf16, max-abs: the
# two differ only in the order of f32 sums inside attention, which can flip
# the last bit of a bf16 attention output; 24 layers carry such flips to
# the logits, whose bf16 step at magnitude 4-8 is 0.03. Eight such steps.
LOGIT_TOL = 0.25
# DeepSeek, the same comparison on requests whose prefill routed every token
# to the same experts in both engines, held to SmolLM2's bound. Readings
# (chip_smoke.py --faults, H100): 0.0 sound; with a fault planted, every
# request's routing differed and the gap over all requests was 0.62-0.98.
DS_LOGIT_TOL = 0.25
# Routing is discrete: last-bit differences flip a token's choice where its
# 6th and 7th expert probabilities nearly tie, and a flip moves its hidden
# state by a whole expert's output, so requests with a flip are counted and
# not held to DS_LOGIT_TOL. The share of (token, layer) decisions that
# differ is bounded instead, between the readings of the sound run and of
# the planted faults (--faults, H100): prefill 0 sound, 22-35 % with the
# grouped GEMM dropping one expert; decode 0.68-0.79 % sound (the MLA kernel
# returns bf16 latents where the plain path keeps f32), 2.5 % with the MLA
# kernel reading one key too few, 1.6 % with the dropped expert.
PREFILL_ROUTE_DIFF_MAX = 0.05
DECODE_ROUTE_DIFF_MAX = 0.015
# DeepSeek-V2-Lite's tensors: the reference's param_count() (15 706 357 760)
# plus the 126 464 norm scales it leaves out
DS_PARAMS = 15_706_484_224
# Zamba2-7B's: the reference's param_count() (6 786 849 504) plus the
# 881 664 norm scales, 601 344 conv biases and 9 072 dt_bias it leaves out
ZAMBA_PARAMS = 6_788_341_584
# Zamba2's first-token logits, kernel engine vs plain engine, both bf16,
# max-abs over every request: the kernel path keeps the SSD scan's y in f32
# where the plain chunked path rounds it to bf16 (the reference's two paths
# do the same), in each of 81 layers. Readings (--faults, H100): 1.14 (g)
# and 1.56 (h) sound; 5.78 (h) with the state not carried from tile to
# tile, 6.28-6.61 with each step's own input left out.
ZAMBA_LOGIT_TOL = 3.0
# the same comparison in f32 at full width, the depth cut to one group and
# the tail (7 layers), where only the order of f32 sums differs
ZAMBA_F32_LOGIT_TOL = 2e-3
# one H100 SXM (NVIDIA data sheet): HBM bytes/s, dense bf16 tensor FLOP/s,
# and the SSD scan's rate: f32-accurate products in 3xTF32, three TF32
# tensor-core MMAs each (TF32 peak 495 TFLOP/s), the route its kernel takes
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
TF32X3_FLOPS = 495e12 / 3
# the SSD scan against its plain version, max-abs: the reference's own bound
# (tests/test_kernels.py::test_ssd_scan_sweep) on outputs of size ~10-100
SSD_TOL = 2e-3
# phase 3's rows over a memory (the encoder, the cross prefill and decode),
# bf16, max-abs as a share of the largest plain output: over T keys of
# standard-normal K/V an output's scale falls as 1/sqrt(T) (std about
# sqrt(e / T), 0.026 at T 4100), so TOL's 3e-2 is as large as a typical
# output there and would pass a kernel that drops keys. 2e-2 of the largest
# output is a few bf16 steps of it. Each row also runs the kernel with the
# last partial 64-key tile dropped and requires that to fail this bound.
CROSS_REL_TOL = 2e-2
TILE_KEYS = 64

ENGINE_KW = dict(slots=16, cache_len=1024, prefill_buckets=(32, 128, 512),
                 megastep=8, cache_dtype=torch.bfloat16)
# the paged pool: 64-token pages, the default num_pages (16 slots x 16
# pages = 256, the slot cache's bytes)
PAGED_KW = dict(ENGINE_KW, paged=True, page_size=64)
PREAMBLE_LEN = 448                       # 7 pages of 64


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in one
    CUDA graph, replayed three times between CUDA events, the fastest
    replay over ``iters``. The host's launch gaps do not count, which is
    what separates a kernel of a few tens of microseconds from the Python
    around its launch."""
    fn()
    sync()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(3):
        start.record()
        graph.replay()
        end.record()
        sync()
        best = min(best, start.elapsed_time(end) / iters)
    del graph
    return best


def rate(nbytes, flops, ms, by):
    """The achieved rate of a call that took ``ms``, in the unit of what
    bounds it: TB/s of its least bytes, or TFLOP/s of its operations."""
    if by == "bytes":
        return f"{nbytes / ms / 1e9:.2f} TB/s"
    return f"{flops / ms / 1e9:.1f} TFLOP/s"


def randn(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to("cuda", dtype)


# ------------------------------------------------------------- 1. card ----
def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    return smi


# ------------------------------------------------------------ 2. build ----
def phase_build() -> dict:
    info = build.build_all()
    log(f"[build] built {info['built'] or 'nothing (on disk)'} in "
        f"{info['seconds']:.2f} s")
    for name, report in info["ptxas"].items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    return info


# ---------------------------------------------------------- 3. kernels ----
def attention_bound(B, S, H, Hkv, D, kv_len, causal, window, elt,
                    q_offset=None):
    """Least bytes and FLOPs of prefill attention on these inputs: q read
    and out written once, only the K/V rows below kv_len read once, 4*D
    FLOPs per visible (query, key) pair (query row i of batch row b at
    position q_offset[b] + i)."""
    pairs = 0
    offs = np.zeros(B, int) if q_offset is None else np.asarray(q_offset)
    for n, off in zip(kv_len, offs):
        q = off + np.arange(S)
        hi = np.minimum(q + 1, n) if causal else np.full(S, n)
        lo = np.maximum(0, q - window + 1) if window else np.zeros(S, int)
        pairs += int(np.maximum(0, hi - lo).sum())
    flops = 4.0 * D * H * pairs
    nbytes = (2 * B * S * H * D + 2 * int(np.sum(kv_len)) * Hkv * D) * elt
    nbytes += 4 * B * (1 if q_offset is None else 2)
    return nbytes, flops


def decode_bound(B, H, Hkv, D, lengths, elt, page=0):
    """Least bytes and FLOPs of one decode step: q read and out written
    once, each live key's K/V row read once (and, paged, each live page's
    table entry), 4*D FLOPs per (head, live key)."""
    live = int(np.sum(lengths))
    nbytes = (2 * B * H * D + 2 * live * Hkv * D) * elt + 4 * B
    if page:
        nbytes += 4 * int(np.sum(-(-np.asarray(lengths) // page)))
    flops = 4.0 * D * H * live
    return nbytes, flops


def bound_ms(nbytes, flops, peak=BF16_FLOPS):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / peak * 1e3
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def mla_bound(B, H, R, Dr, lengths, page, elt):
    """Least bytes and FLOPs of one MLA decode step: q_lat, q_rope read and
    the latent output written once, each live key's latent and rope rows
    and its page's table entry read once, 2 (R + Dr) + 2 R FLOPs per
    (head, live key)."""
    live = int(np.sum(lengths))
    nbytes = (B * H * (2 * R + Dr) + live * (R + Dr)) * elt + 4 * B
    nbytes += 4 * int(np.sum(-(-np.asarray(lengths) // page)))
    return nbytes, 2.0 * H * live * (2 * R + Dr)


def gemm_bound(counts, d, f, elt):
    """Least bytes and FLOPs of the grouped GEMM on these segments: x read
    and out written once, only the chosen experts' weights read once, 2 d f
    FLOPs per row."""
    N, used = int(np.sum(counts)), int(np.count_nonzero(counts))
    nbytes = (N * d + used * d * f + N * f) * elt + 4 * len(counts)
    return nbytes, 2.0 * N * d * f


def ssd_bound(B, S, H, N, P, G=None):
    """Least bytes and FLOPs of the SSD scan: C and B (per group when G is
    given, else per head), v and log_a read and y written once, the final
    state written once (all f32), and the sequential form's 4 N P FLOPs per
    (step, head): the state's decay and outer-product update and the
    output's dot products."""
    G = H if G is None else G
    nbytes = 4 * (B * S * (2 * G * N + H * (2 * P + 1)) + B * H * N * P)
    return nbytes, 4.0 * N * P * B * S * H


def check(name, err, dtype, extra="", tol=None):
    tol = TOL[dtype] if tol is None else tol
    ok = err <= tol
    log(f"[kernels] {name}: max_abs_err {err:.3e} (tol {tol:g}) "
        f"{'ok' if ok else 'FAIL'} {extra}")
    if not ok:
        raise AssertionError(f"{name}: error {err} above tolerance {tol}")
    return err


def planted_tail(name, fault_err, tol, tail):
    """A check's witness: the kernel run with its last ``tail`` keys (the
    partial tile) dropped must fail the bound the sound run passed."""
    caught = fault_err > tol
    log(f"[kernels] {name} with the last {tail} keys dropped: max_abs_err "
        f"{fault_err:.3e} (tol {tol:.3e}) {'caught' if caught else 'MISSED'}")
    if not caught:
        raise AssertionError(f"{name}: the check cannot see {tail} dropped "
                             f"keys ({fault_err} <= {tol})")
    return fault_err


def attn_times(label, kernel, library, plain, nbytes, flops, iters):
    """The prefill kernel's and its SDPA yardstick's device time (a CUDA
    graph of ``iters`` calls) and eager time, logged beside the bound."""
    bms, by = bound_ms(nbytes, flops)
    row = dict(ms=device_ms(kernel, iters=iters),
               eager_ms=time_ms(kernel, iters=iters), plain_ms=plain,
               library_ms=device_ms(library, iters=iters),
               library_eager_ms=time_ms(library, iters=iters), bound_ms=bms,
               bound_by=by)
    log(f"[kernels] flash_attention {label}: kernel {row['ms']:.4f} ms "
        f"({rate(nbytes, flops, row['ms'], by)}; eager launches "
        f"{row['eager_ms']:.4f} ms), plain {plain:.4f} ms, SDPA "
        f"{row['library_ms']:.4f} ms (eager {row['library_eager_ms']:.4f}), "
        f"bound {bms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.3f} GFLOP)")
    return row


def attn_prefix_parity() -> None:
    """The bf16 prefill kernel's prefix-sharing contract: tail rows
    prefilled at a query offset (a bucket of 32, offsets that are not
    multiples of the 64-key tile) get the bits of the same rows of a
    whole-prompt call on the same K/V, at head dims 64, 80, 112 and 160."""
    gen = np.random.RandomState(5)
    B, S, H = 4, 256, 32
    kl = torch.tensor([256, 200, 131, 97], dtype=torch.int32, device="cuda")
    for D in (64, 80, 112, 160):
        q, k, v = (randn(gen, (B, S, H, D), torch.bfloat16)
                   for _ in range(3))
        kw = dict(causal=True, scale=D ** -0.5, kv_len=kl)
        whole = ops.flash_attention(q, k, v, **kw)
        for off in (37, 100, 131, 200):
            qo = torch.full((B,), off, dtype=torch.int32, device="cuda")
            tail = ops.flash_attention(q[:, off:off + 32].contiguous(), k, v,
                                       q_offset=qo, **kw)
            if not torch.equal(tail, whole[:, off:off + 32]):
                raise AssertionError(f"flash_attention D {D}: tail rows at "
                                     f"q_offset {off} differ from the whole "
                                     f"prompt's")
    sync()
    log("[kernels] flash_attention bf16 tails at q_offset 37/100/131/200 "
        "(bucket 32) bitwise equal to the whole prompt's rows, D 64, 80, 112 "
        "and 160")


def phase_kernels() -> dict:
    rng = np.random.RandomState(0)
    rows = {}

    # --- flash_attention ---------------------------------------------------
    def attn_case(B, S, T, H, Hkv, D, dtype, causal, window, kv_len,
                  q_offset=None, gen=rng):
        q = randn(gen, (B, S, H, D), dtype)
        k = randn(gen, (B, T, Hkv, D), dtype)
        v = randn(gen, (B, T, Hkv, D), dtype)
        kl = (None if kv_len is None else
              torch.tensor(kv_len, dtype=torch.int32, device="cuda"))
        scale = D ** -0.5
        kw = dict(causal=causal, window=window, scale=scale, kv_len=kl)
        if q_offset is not None:
            kw["q_offset"] = torch.tensor(q_offset, dtype=torch.int32,
                                          device="cuda")
        out = ops.flash_attention(q, k, v, **kw)
        sync()
        exp = ref.flash_attention_ref(q, k, v, **kw)
        err = float((out.float() - exp.float()).abs().max())
        assert torch.isfinite(out).all(), "non-finite attention output"
        return q, k, v, kl, kw, err

    B, S, H, D = 16, 512, 32, 64
    kv_len = rng.randint(1, S + 1, size=B)
    kv_len[:2] = (1, S)
    q, k, v, kl, kw, err = attn_case(B, S, S, H, H, D, torch.bfloat16, True,
                                     0, kv_len.tolist())
    main_err = check("flash_attention main (16,512,32,64) bf16 causal "
                     "ragged kv_len", err, torch.bfloat16)
    plain = time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw), iters=3)
    pos = torch.arange(S, device="cuda")
    mask = ((pos[None, :] <= pos[:, None])[None]
            & (pos[None, None, :] < kl[:, None, None]))[:, None]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    nbytes, flops = attention_bound(B, S, H, H, D, kv_len, True, 0, 2)
    row = attn_times("main", lambda: ops.flash_attention(q, k, v, **kw),
                     lambda: torch.nn.functional.scaled_dot_product_attention(
                         qt, kt, vt, attn_mask=mask, scale=kw["scale"]),
                     plain, nbytes, flops, iters=20)
    rows["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:92",
        max_abs_err=main_err, **row)
    del q, k, v, mask, qt, kt, vt

    *_, err = attn_case(2, 256, 256, 8, 2, 128, torch.float32, True, 64, None)
    check("flash_attention GQA (2,256,8/2,128) f32 window 64", err,
          torch.float32)
    *_, err = attn_case(2, 200, 200, 4, 4, 64, torch.float32, False, 0,
                        [200, 77])
    check("flash_attention ragged S 200 non-causal f32 kv_len [200,77]", err,
          torch.float32)

    # per-row query offsets: the shared-prefix tail prefill of mix (d), 16
    # tails of a 32 bucket at offsets ~450 over a 512-position page view
    # (its own generator, so that the other cases draw what they drew
    # before this case existed)
    B, S, T = 16, 32, 512
    rng_off = np.random.RandomState(1)
    offs = rng_off.randint(440, 466, size=B)
    offs[:2] = (0, 449)
    kv_len = offs + rng_off.randint(1, S + 1, size=B)
    kv_len[0] = S
    q, k, v, kl, kw, err = attn_case(B, S, T, H, H, D, torch.bfloat16, True,
                                     0, kv_len.tolist(), offs.tolist(),
                                     gen=rng_off)
    off_err = check("flash_attention q_offset (16,32 over 512,32,64) bf16 "
                    "tails at offsets 0..465", err, torch.bfloat16)
    plain = time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw))
    qpos = kw["q_offset"][:, None] + torch.arange(S, device="cuda")[None]
    kpos = torch.arange(T, device="cuda")
    mask = ((kpos[None, None, :] <= qpos[:, :, None])
            & (kpos[None, None, :] < kl[:, None, None]))[:, None]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    nbytes, flops = attention_bound(B, S, H, H, D, kv_len, True, 0, 2,
                                    q_offset=offs)
    rows["flash_attention"]["q_offset"] = dict(
        max_abs_err=off_err,
        **attn_times("q_offset", lambda: ops.flash_attention(q, k, v, **kw),
                     lambda: torch.nn.functional.scaled_dot_product_attention(
                         qt, kt, vt, attn_mask=mask, scale=kw["scale"]),
                     plain, nbytes, flops, iters=50))
    del q, k, v, mask, qt, kt, vt
    attn_prefix_parity()
    *_, err = attn_case(3, 40, 300, 8, 2, 128, torch.float32, True, 0,
                        [30, 117, 290], [0, 77, 250], gen=rng_off)
    check("flash_attention q_offset GQA (3,40 over 300,8/2,128) f32", err,
          torch.float32)

    # --- flash_decode ------------------------------------------------------
    def dec_case(B, H, Hkv, D, Skv, dtype, lengths, active=None):
        q = randn(rng, (B, H, D), dtype)
        ck = randn(rng, (B, Skv, Hkv, D), dtype)
        cv = randn(rng, (B, Skv, Hkv, D), dtype)
        ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        act = (None if active is None else
               torch.tensor(active, dtype=torch.bool, device="cuda"))
        kw = dict(scale=D ** -0.5, active=act)
        out = ops.flash_decode(q, ck, cv, ln, **kw)
        sync()
        exp = ref.flash_decode_ref(q, ck, cv, ln, **kw)
        err = float((out.float() - exp.float()).abs().max())
        zero = torch.as_tensor(lengths, device="cuda") == 0
        if act is not None:
            zero |= ~act
        if zero.any() and float(out[zero].abs().max()) != 0.0:
            raise AssertionError("flash_decode: empty slots are not exact "
                                 "zeros")
        return q, ck, cv, ln, kw, err

    B, H, D, Skv = 16, 32, 64, 1024
    lengths = rng.randint(2, Skv, size=B)
    lengths[:3] = (0, 1, Skv)
    dec_lengths = lengths
    q, ck, cv, ln, kw, err = dec_case(B, H, H, D, Skv, torch.bfloat16,
                                      lengths.tolist())
    main_err = check("flash_decode main (16,32,64) Skv 1024 bf16 lengths "
                     "with 0/1/1024", err, torch.bfloat16)
    ms = device_ms(lambda: ops.flash_decode(q, ck, cv, ln, **kw), iters=50)
    eager = time_ms(lambda: ops.flash_decode(q, ck, cv, ln, **kw), iters=50)
    plain = time_ms(lambda: ref.flash_decode_ref(q, ck, cv, ln, **kw))
    pos = torch.arange(Skv, device="cuda")
    mask = (pos[None, :] < ln[:, None])[:, None, None, :]
    qt, kt, vt = q[:, :, None], ck.transpose(1, 2), cv.transpose(1, 2)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=kw["scale"])
    lib = device_ms(sdpa, iters=50)
    lib_eager = time_ms(sdpa, iters=50)
    nbytes, flops = decode_bound(B, H, H, D, lengths, 2)
    bms, by = bound_ms(nbytes, flops)
    log(f"[kernels] flash_decode main: kernel {ms:.4f} ms "
        f"({rate(nbytes, flops, ms, by)}; eager launches {eager:.4f} ms), "
        f"plain "
        f"{plain:.4f} ms, SDPA {lib:.4f} ms (eager {lib_eager:.4f}), bound "
        f"{bms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, {flops / 1e9:.3f} GFLOP)")
    rows["flash_decode"] = dict(
        name="flash_decode", route="cuda",
        source="src/repro_torch/csrc/flash_decode.cu",
        replaces="src/repro/kernels/decode_attention.py:111",
        max_abs_err=main_err, ms=ms, plain_ms=plain, bound_ms=bms,
        bound_by=by, library_ms=lib, eager_ms=eager,
        library_eager_ms=lib_eager)
    # the same K/V laid out in scattered 64-key pages behind a table of 20
    # pages (a capacity of 1280, not the slot cache's 1024): the paged
    # kernel sums each slot's keys over the same 256-key splits in the same
    # order, so it must give the slot kernel's bits
    P, n = 64, 20
    perm = torch.as_tensor(np.random.RandomState(5).permutation(
        B * (Skv // P)), device="cuda")
    kp = torch.full((B * (Skv // P) + 1, P, H, D), 1e4, dtype=ck.dtype,
                    device="cuda")
    vp = kp.clone()
    kp[perm] = ck.reshape(-1, P, H, D)
    vp[perm] = cv.reshape(-1, P, H, D)
    pt = torch.full((B, n), B * (Skv // P), dtype=torch.int32, device="cuda")
    pt[:, :Skv // P] = perm.reshape(B, -1).to(torch.int32)
    same = torch.equal(ops.flash_decode(q, ck, cv, ln, **kw),
                       ops.paged_flash_decode(q, kp, vp, pt, ln,
                                              scale=kw["scale"]))
    log(f"[kernels] flash_decode vs paged_flash_decode on the same K/V "
        f"(slot cache 1024, table of 20 pages of 64): bitwise equal: {same}")
    if not same:
        raise AssertionError("flash_decode and paged_flash_decode differ on "
                             "the same K/V")
    rows["flash_decode"]["paged_bitwise_equal"] = same
    del q, ck, cv, mask, qt, kt, vt, kp, vp

    *_, err = dec_case(3, 16, 1, 64, 128, torch.float32,
                       [1 + 37 * i % 128 for i in range(3)])
    check("flash_decode (3,16/1,64) Skv 128 f32", err, torch.float32)
    *_, err = dec_case(4, 8, 2, 64, 256, torch.float32, [100, 7, 200, 256],
                       active=[True, False, True, False])
    check("flash_decode active mask (4,8/2,64) Skv 256 f32", err,
          torch.float32, "(inactive rows exact zeros)")

    # --- paged_flash_decode -----------------------------------------------
    def paged_case(B, H, Hkv, D, P, n, num_pages, dtype, lengths,
                   poison=False):
        """Pools of num_pages + 1 pages (the last is TRASH), each slot's
        live pages scattered over the pool, columns past them TRASH."""
        q = randn(rng, (B, H, D), dtype)
        kp = randn(rng, (num_pages + 1, P, Hkv, D), dtype)
        vp = randn(rng, (num_pages + 1, P, Hkv, D), dtype)
        if poison:
            kp[num_pages] = 1e4
            vp[num_pages] = 1e4
        pt = np.full((B, n), num_pages, np.int32)
        ids = iter(rng.permutation(num_pages))
        for b, ln in enumerate(lengths):
            for j in range(-(-ln // P)):
                pt[b, j] = next(ids)
        pt = torch.as_tensor(pt, device="cuda")
        ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        kw = dict(scale=D ** -0.5)
        out = ops.paged_flash_decode(q, kp, vp, pt, ln, **kw)
        sync()
        exp = ref.paged_decode_ref(q, kp, vp, pt, ln, **kw)
        err = float((out.float() - exp.float()).abs().max())
        zero = ln == 0
        if zero.any() and float(out[zero].abs().max()) != 0.0:
            raise AssertionError("paged_flash_decode: empty slots are not "
                                 "exact zeros")
        if not torch.isfinite(out).all():
            raise AssertionError("paged_flash_decode: non-finite output")
        return q, kp, vp, pt, ln, kw, err

    # the flash_decode main case's lengths, so the two kernels do the same
    # work and differ only by the page-table indirection
    B, H, D, P, n = 16, 32, 64, 64, 16
    lengths = dec_lengths
    q, kp, vp, pt, ln, kw, err = paged_case(B, H, H, D, P, n, 256,
                                            torch.bfloat16, lengths.tolist())
    main_err = check("paged_flash_decode main (16,32,64) P 64 n 16 bf16 "
                     "lengths with 0/1/1024, scattered pages", err,
                     torch.bfloat16)
    ms = device_ms(lambda: ops.paged_flash_decode(q, kp, vp, pt, ln, **kw),
                   iters=50)
    eager = time_ms(lambda: ops.paged_flash_decode(q, kp, vp, pt, ln, **kw),
                    iters=50)
    plain = time_ms(lambda: ref.paged_decode_ref(q, kp, vp, pt, ln, **kw))
    pos = torch.arange(n * P, device="cuda")
    mask = (pos[None, :] < ln[:, None])[:, None, None, :]
    flat = pt.reshape(-1).long()

    def library():
        kk = kp.index_select(0, flat).reshape(B, n * P, H, D).transpose(1, 2)
        vv = vp.index_select(0, flat).reshape(B, n * P, H, D).transpose(1, 2)
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], kk, vv, attn_mask=mask, scale=kw["scale"])
    lib = device_ms(library, iters=50)
    lib_eager = time_ms(library, iters=50)
    nbytes, flops = decode_bound(B, H, H, D, lengths, 2, page=P)
    bms, by = bound_ms(nbytes, flops)
    log(f"[kernels] paged_flash_decode main: kernel {ms:.4f} ms "
        f"({rate(nbytes, flops, ms, by)}; eager launches {eager:.4f} ms), "
        f"plain {plain:.4f} ms, gather+SDPA {lib:.4f} ms (eager "
        f"{lib_eager:.4f}), bound {bms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.3f} GFLOP)")
    rows["paged_flash_decode"] = dict(
        name="paged_flash_decode", route="cuda",
        source="src/repro_torch/csrc/paged_flash_decode.cu",
        replaces="src/repro/kernels/decode_attention.py:216",
        max_abs_err=main_err, ms=ms, plain_ms=plain, bound_ms=bms,
        bound_by=by, library_ms=lib, eager_ms=eager,
        library_eager_ms=lib_eager)
    del q, kp, vp, mask

    for P, n, dtype, (H, Hkv), lens in (
            (7, 5, torch.float32, (8, 2), [35, 17, 1, 0]),
            (16, 4, torch.float32, (32, 8), [64, 33, 0, 5]),
            (16, 6, torch.bfloat16, (16, 2), [96, 50, 16, 0])):
        *_, err = paged_case(4, H, Hkv, 64, P, n, 6 * n, dtype, lens,
                             poison=True)
        check(f"paged_flash_decode P {P} n {n} ({H}/{Hkv} heads) "
              f"{str(dtype)[6:]} lengths {lens}, poisoned TRASH", err, dtype)
    rows.update(phase_kernels_mla_moe())
    rows.update(phase_kernels_ssd())
    phase_kernels_d112(rows)
    phase_kernels_wide(rows)
    phase_kernels_cross(rows)
    return rows


def route_counts(gen, tokens, k=6, experts=64):
    """Rows per expert of ``tokens`` tokens each choosing k distinct
    experts uniformly (a random router's spread)."""
    counts = np.zeros(experts, np.int64)
    for _ in range(tokens):
        counts[gen.choice(experts, size=k, replace=False)] += 1
    return counts


def phase_kernels_mla(gen) -> dict:
    """Phase 3's paged MLA decode: DeepSeek-V2-Lite's decode shape in bf16
    against the plain version (max-abs error, the share of bf16 outputs
    equal to the plain version's, two calls giving the same bits), its
    device time and gather + SDPA's, then pages of 7 and 16 in f32 over a
    poisoned TRASH page."""
    def mla_case(B, H, R, Dr, P, n, num_pages, dtype, lengths, scale,
                 poison=False):
        ql = randn(gen, (B, H, R), dtype)
        qr = randn(gen, (B, H, Dr), dtype)
        ckv = randn(gen, (num_pages + 1, P, R), dtype)
        kr = randn(gen, (num_pages + 1, P, Dr), dtype)
        if poison:
            ckv[num_pages] = 1e4
            kr[num_pages] = 1e4
        pt = np.full((B, n), num_pages, np.int32)
        ids = iter(gen.permutation(num_pages))
        for b, ln in enumerate(lengths):
            for j in range(-(-ln // P)):
                pt[b, j] = next(ids)
        pt = torch.as_tensor(pt, device="cuda")
        ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        args = (ql, qr, ckv, kr, pt, ln)
        out = ops.paged_mla_decode(*args, scale=scale)
        sync()
        exp = ref.paged_mla_decode_ref(*args, scale=scale)
        err = float((out.float() - exp.float()).abs().max())
        zero = ln == 0
        if zero.any() and float(out[zero].abs().max()) != 0.0:
            raise AssertionError("paged_mla_decode: empty slots are not "
                                 "exact zeros")
        if not torch.isfinite(out).all():
            raise AssertionError("paged_mla_decode: non-finite output")
        return args, err, out, exp

    # DeepSeek-V2-Lite's decode: 16 slots, 16 heads, latent 512, rope 64,
    # 16 pages of 64 per slot scattered over a 256-page pool
    B, H, R, Dr, P, n = 16, 16, 512, 64, 64, 16
    lengths = gen.randint(2, n * P, size=B)
    lengths[:3] = (0, 1, n * P)
    scale = (128 + 64) ** -0.5
    args, err, out, exp = mla_case(B, H, R, Dr, P, n, 256, torch.bfloat16,
                                   lengths.tolist(), scale)
    main_err = check("paged_mla_decode main (16,16,512+64) P 64 n 16 bf16 "
                     "lengths with 0/1/1024, scattered pages", err,
                     torch.bfloat16)
    live = lengths > 0
    equal = float((out[live] == exp[live]).float().mean())
    again = ops.paged_mla_decode(*args, scale=scale)
    if not torch.equal(again, out):
        raise AssertionError("paged_mla_decode: two calls on the same "
                             "inputs gave different bits")
    del out, exp, again

    def kernel():
        return ops.paged_mla_decode(*args, scale=scale)
    ms = device_ms(kernel, iters=50)
    eager = time_ms(kernel, iters=50)
    plain = time_ms(lambda: ref.paged_mla_decode_ref(*args, scale=scale))
    ql, qr, ckv, kr, pt, ln = args
    pos = torch.arange(n * P, device="cuda")
    mask = (pos[None, :] < ln[:, None])[:, None, None, :]
    flat = pt.reshape(-1).long()

    def library():
        c = ckv.index_select(0, flat).reshape(B, 1, n * P, R)
        k = torch.cat([c, kr.index_select(0, flat).reshape(B, 1, n * P, Dr)],
                      dim=-1)
        q = torch.cat([ql, qr], dim=-1)[:, :, None]
        return torch.nn.functional.scaled_dot_product_attention(
            q, k.expand(B, H, n * P, R + Dr), c.expand(B, H, n * P, R),
            attn_mask=mask, scale=scale)
    lib = device_ms(library, iters=50)
    lib_eager = time_ms(library, iters=50)
    nbytes, flops = mla_bound(B, H, R, Dr, lengths, P, 2)
    bms, by = bound_ms(nbytes, flops)
    log(f"[kernels] paged_mla_decode main: kernel {ms:.4f} ms "
        f"({rate(nbytes, flops, ms, by)}; eager launches {eager:.4f} ms), "
        f"plain {plain:.4f} ms, gather+SDPA {lib:.4f} ms (eager "
        f"{lib_eager:.4f}), bound {bms:.4f} ms ({by}: {nbytes / 1e6:.2f} MB, "
        f"{flops / 1e9:.3f} GFLOP); bf16 outputs equal to the plain "
        f"version's {100 * equal:.3f} %, two calls bitwise equal")
    row = dict(
        name="paged_mla_decode", route="cuda",
        source="src/repro_torch/csrc/paged_mla_decode.cu",
        replaces="src/repro/kernels/decode_attention.py:308",
        max_abs_err=main_err, ms=ms, plain_ms=plain, bound_ms=bms,
        bound_by=by, library_ms=lib, eager_ms=eager,
        library_eager_ms=lib_eager, equal_share=equal)
    del args, ql, qr, ckv, kr, mask
    for P, n, lens in ((7, 5, [35, 17, 1, 0]), (16, 4, [64, 33, 0, 5])):
        _, err, _, _ = mla_case(4, 16, 512, 64, P, n, 6 * n, torch.float32,
                                lens, scale, poison=True)
        check(f"paged_mla_decode P {P} n {n} (16,512+64) f32 lengths {lens}, "
              f"poisoned TRASH", err, torch.float32)
    return row


def phase_kernels_mla_moe() -> dict:
    """Phase 3 for the DeepSeek path's kernels, on their own generator (the
    earlier cases draw what they drew before these existed)."""
    gen = np.random.RandomState(2)
    rows = {"paged_mla_decode": phase_kernels_mla(gen)}

    # --- grouped_gemm -------------------------------------------------------
    def gemm_tol(dtype, d, exp):
        # tests/test_kernels.py:130-131's bound, relative to the contraction
        # depth, capped at TOL[dtype] of the largest plain output: a bf16
        # output is within a few of its own rounding steps, while a tile of
        # zeros or of another expert's weights is off by the output's size
        return min((5e-3 if dtype == torch.float32 else 1.0) * d ** 0.5,
                   TOL[dtype] * float(exp.float().abs().max()))

    for E, C, d, f in ((2, 128, 256, 128), (8, 256, 128, 256)):
        for dtype in (torch.float32, torch.bfloat16):
            x = randn(gen, (E, C, d), dtype)
            w = randn(gen, (E, d, f), dtype)
            out = ops.grouped_gemm(x, w)
            sync()
            exp = ref.grouped_gemm_ref(x, w)
            err = float((out.float() - exp.float()).abs().max())
            check(f"grouped_gemm ({E},{C},{d}) x ({E},{d},{f}) "
                  f"{str(dtype)[6:]}", err, dtype,
                  tol=gemm_tol(dtype, d, exp))

    cases = {}
    # a decode step (16 tokens), a prefill wave (16 x 512) and, drawn last
    # so that the first two draw what they drew before it existed, the
    # fact-verification wave of mix (e) (16 x 32)
    for phase, tokens in (("decode", 16), ("prefill", 16 * 512),
                          ("wave", 16 * 32)):
        counts = route_counts(gen, tokens)
        N = int(counts.sum())
        cnt = torch.as_tensor(counts.astype(np.int32), device="cuda")
        for proj, d, f in (("gate/up", 2048, 1408), ("down", 1408, 2048)):
            x = randn(gen, (N, d), torch.bfloat16)
            w = randn(gen, (64, d, f), torch.bfloat16) * d ** -0.5
            out = ops.grouped_gemm_segments(x, cnt, w)
            sync()
            exp = ref.grouped_gemm_segments_ref(x, cnt, w)
            err = float((out.float() - exp.float()).abs().max())
            label = (f"grouped_gemm_segments {phase} {N} rows over 64 "
                     f"experts ({int((counts == 0).sum())} empty), "
                     f"{proj} {d}->{f} bf16")
            check(label, err, torch.bfloat16,
                  tol=gemm_tol(torch.bfloat16, d, exp))
            iters = 50 if phase == "decode" else 10
            ms = device_ms(lambda: ops.grouped_gemm_segments(x, cnt, w),
                           iters=iters)
            eager = time_ms(lambda: ops.grouped_gemm_segments(x, cnt, w),
                            iters=iters)
            plain = time_ms(lambda: ref.grouped_gemm_segments_ref(x, cnt, w),
                            iters=3)
            cmax = int(counts.max())
            xp = torch.zeros((64, cmax, d), dtype=x.dtype, device="cuda")
            lo = 0
            for e, c in enumerate(counts.tolist()):
                xp[e, :c] = x[lo:lo + c]
                lo += c
            lib = device_ms(lambda: torch.bmm(xp, w), iters=iters)
            lib_eager = time_ms(lambda: torch.bmm(xp, w), iters=iters)
            nbytes, flops = gemm_bound(counts, d, f, 2)
            bms, by = bound_ms(nbytes, flops)
            shape = gemm_shape(N, len(counts))
            log(f"[kernels] {label}: {shape} tiles, kernel {ms:.4f} ms "
                f"({rate(nbytes, flops, ms, by)}; eager launches "
                f"{eager:.4f} ms), plain {plain:.4f} ms, padded bmm "
                f"({64}x{cmax} rows) {lib:.4f} ms (eager {lib_eager:.4f}), "
                f"bound {bms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, "
                f"{flops / 1e9:.1f} GFLOP), max_abs_err {err:.3e}")
            cases[f"{phase} {proj}"] = dict(
                rows=N, empty_experts=int((counts == 0).sum()), d=d, f=f,
                shape=shape, max_abs_err=err, ms=ms, eager_ms=eager,
                plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
                library_eager_ms=lib_eager, achieved=rate(nbytes, flops, ms,
                                                          by))
            del x, w, out, exp, xp
    main = cases["prefill gate/up"]
    rows["grouped_gemm"] = dict(
        name="grouped_gemm", route="cuda",
        source="src/repro_torch/csrc/grouped_gemm.cu",
        replaces="src/repro/kernels/moe_gemm.py:48",
        **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms")},
        cases=cases)
    return rows


def phase_kernels_ssd() -> dict:
    """Phase 3 for the hybrid's SSD scan, on its own generator: Zamba2's
    prefill waves (16 rows of 512 steps for (h), of 32 for (g): 112 heads,
    N = P = 64), the reference's sweep shapes (tests/test_kernels.py), and
    a row padded as Mamba2 pads (dt = 0), whose final state must equal the
    unpadded row's bit for bit. Times: the kernel, its plain version (the
    sequential scan) and the port's chunked form (the use_kernels=False
    path); no single PyTorch call computes a decayed scan, so no library
    time."""
    from repro_torch.models.ssm import chunked_linear_attention
    gen = np.random.RandomState(3)

    def inputs(B, S, H, N, P, G=None):
        G = H if G is None else G
        la = -torch.nn.functional.softplus(randn(gen, (B, S, H),
                                                 torch.float32))
        return (randn(gen, (B, S, G, N), torch.float32),
                randn(gen, (B, S, G, N), torch.float32),
                randn(gen, (B, S, H, P), torch.float32), la)

    def per_head(C, Bm, v, la):
        rep = v.shape[2] // C.shape[2]
        return (C.repeat_interleave(rep, dim=2),
                Bm.repeat_interleave(rep, dim=2), v, la)

    def plain(C, Bm, v, la):
        C, Bm, v, la = per_head(C, Bm, v, la)
        B, S, H, N = C.shape
        P = v.shape[-1]

        def bhs(t):
            return t.transpose(1, 2).reshape(B * H, S, t.shape[-1])
        y, st = ref.ssd_scan_ref(bhs(C), bhs(Bm), bhs(v), bhs(la[..., None]))
        return y.reshape(B, H, S, P).transpose(1, 2), st.reshape(B, H, N, P)

    # Zamba2's waves with B and C per group (2 groups of 56 heads, as its
    # Mamba2 layers call the kernel) and per head; both bounds beside each
    cases = {}
    for label, shape, timed in (
            ("main (h) wave, B/C per group (16,512,112,64,64; G 2)",
             (16, 512, 112, 64, 64, 2), True),
            ("(g) wave, B/C per group (16,32,112,64,64; G 2)",
             (16, 32, 112, 64, 64, 2), True),
            ("(h) wave, B/C per head (16,512,112,64,64)",
             (16, 512, 112, 64, 64), True),
            ("(g) wave, B/C per head (16,32,112,64,64)",
             (16, 32, 112, 64, 64), True),
            ("sweep (1,128,2,16,32)", (1, 128, 2, 16, 32), False),
            ("sweep (2,256,1,64,64)", (2, 256, 1, 64, 64), False),
            ("sweep (1,64,4,8,16)", (1, 64, 4, 8, 16), False),
            ("sweep B/C per group (2,100,8,32,16; G 2)",
             (2, 100, 8, 32, 16, 2), False)):
        args = inputs(*shape)
        y, st = ops.ssm_scan(*args)
        sync()
        ye, se = plain(*args)
        if not (torch.isfinite(y).all() and torch.isfinite(st).all()):
            raise AssertionError(f"ssd_scan {label}: non-finite output")
        err = max(float((y - ye).abs().max()), float((st - se).abs().max()))
        check(f"ssd_scan {label} f32 (y and final state)", err,
              torch.float32, tol=SSD_TOL)
        nbytes, flops = ssd_bound(*shape)
        bms, by = bound_ms(nbytes, flops, TF32X3_FLOPS)
        case = dict(shape=shape, max_abs_err=err, bound_ms=bms, bound_by=by)
        if len(shape) == 6:  # per group: the per-head reads' bound beside
            nb_h, _ = ssd_bound(*shape[:5])
            case["per_head_bound_ms"] = bound_ms(nb_h, flops, TF32X3_FLOPS)[0]
        if timed:
            case["ms"] = device_ms(lambda: ops.ssm_scan(*args), iters=10)
            case["eager_ms"] = time_ms(lambda: ops.ssm_scan(*args))
            case["plain_ms"] = time_ms(lambda: plain(*args), iters=2,
                                       warmup=1)
            case["chunked_ms"] = time_ms(
                lambda: chunked_linear_attention(*per_head(*args), 256),
                iters=3, warmup=1)
            extra = (f", per-head bound {case['per_head_bound_ms']:.4f} ms"
                     if "per_head_bound_ms" in case else "")
            log(f"[kernels] ssd_scan {label}: kernel {case['ms']:.4f} ms "
                f"({rate(nbytes, flops, case['ms'], by)}; eager launches "
                f"{case['eager_ms']:.4f} ms), plain {case['plain_ms']:.4f} "
                f"ms, chunked torch (the plain engine's path) "
                f"{case['chunked_ms']:.4f} ms, bound {bms:.4f} ms ({by}: "
                f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP at "
                f"{TF32X3_FLOPS / 1e12:.0f} TFLOP/s, 3xTF32){extra}")
        cases[label] = case
        del args, y, st, ye, se

    # right padding as _mamba2_core_inputs makes it: log_a = 0, v = 0
    C, Bm, v, la = inputs(1, 512, 112, 64, 64)
    n = 300
    v[:, n:], la[:, n:] = 0.0, 0.0
    y, st = ops.ssm_scan(C, Bm, v, la)
    y0, st0 = ops.ssm_scan(*(t[:, :n].contiguous() for t in (C, Bm, v, la)))
    sync()
    same = torch.equal(st, st0) and torch.equal(y[:, :n], y0)
    log(f"[kernels] ssd_scan padded row (512 steps, {n} valid) vs unpadded: "
        f"final state and outputs bitwise equal: {same}")
    if not same:
        raise AssertionError("ssd_scan: a padded row's final state differs "
                             "from the unpadded row's")
    main = cases["main (h) wave, B/C per group (16,512,112,64,64; G 2)"]
    return {"ssd_scan": dict(
        name="ssd_scan", route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssm_scan.py:78",
        **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by")},
        library_ms=None, cases=cases)}


def phase_kernels_d112(rows) -> None:
    """Phase 3 for head dim 112, the shape of Zamba2's shared attention
    block (32 MHA heads of 3584 / 32), on its own generator: the prefill
    kernel over a (h) wave with ragged kv_len and the decode kernel over a
    1024-slot cache, in bf16 with times, and both in f32."""
    gen = np.random.RandomState(4)
    B, S, H, D, Skv = 16, 512, 32, 112, 1024
    q = randn(gen, (B, S, H, D), torch.bfloat16)
    k = randn(gen, (B, S, H, D), torch.bfloat16)
    v = randn(gen, (B, S, H, D), torch.bfloat16)
    kv_len = gen.randint(1, S + 1, size=B)
    kv_len[:2] = (1, S)
    kl = torch.as_tensor(kv_len.astype(np.int32), device="cuda")
    kw = dict(causal=True, window=0, scale=D ** -0.5, kv_len=kl)
    out = ops.flash_attention(q, k, v, **kw)
    sync()
    want = ref.flash_attention_ref(q, k, v, **kw)
    err = check("flash_attention D 112 (16,512,32,112) bf16 causal ragged "
                "kv_len", float((out.float() - want.float()).abs().max()),
                torch.bfloat16)
    # the witness: the same rows with P rounded to bf16 as the kernel
    # rounds it, beside the plain version (which keeps P in f32)
    wit = p_bf16_attention(q, k, v, **kw)
    witness = {}
    for name, other in (("plain", want), ("p_bf16", wit)):
        d = (out.float() - other.float()).abs()
        witness[f"kernel_vs_{name}"] = dict(
            max_abs_err=float(d.max()), mean_abs_err=float(d.mean()),
            bitwise_equal_share=float((out == other).float().mean()))
    d = (wit.float() - want.float()).abs()
    witness["p_bf16_vs_plain"] = dict(
        max_abs_err=float(d.max()), mean_abs_err=float(d.mean()),
        bitwise_equal_share=float((wit == want).float().mean()))
    log(f"[kernels] flash_attention D 112 bf16, P rounded to bf16 (witness): "
        f"{json.dumps(witness)}")
    del want, wit, d
    pos = torch.arange(S, device="cuda")
    mask = ((pos[None, :] <= pos[:, None])[None]
            & (pos[None, None, :] < kl[:, None, None]))[:, None]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    nbytes, flops = attention_bound(B, S, H, H, D, kv_len, True, 0, 2)
    rows["flash_attention"]["d112"] = dict(
        max_abs_err=err, p_bf16_witness=witness,
        **attn_times("D 112", lambda: ops.flash_attention(q, k, v, **kw),
                     lambda: torch.nn.functional.scaled_dot_product_attention(
                         qt, kt, vt, attn_mask=mask, scale=kw["scale"]),
                     time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw),
                             iters=3), nbytes, flops, iters=20))
    del q, k, v, out, mask, qt, kt, vt

    q = randn(gen, (B, H, D), torch.bfloat16)
    ck = randn(gen, (B, Skv, H, D), torch.bfloat16)
    cv = randn(gen, (B, Skv, H, D), torch.bfloat16)
    lengths = gen.randint(2, Skv, size=B)
    lengths[:3] = (0, 1, Skv)
    ln = torch.as_tensor(lengths.astype(np.int32), device="cuda")
    dk = dict(scale=D ** -0.5)
    out = ops.flash_decode(q, ck, cv, ln, **dk)
    sync()
    err = check("flash_decode D 112 (16,32,112) Skv 1024 bf16 lengths with "
                "0/1/1024", float((out.float() - ref.flash_decode_ref(
                    q, ck, cv, ln, **dk).float()).abs().max()),
                torch.bfloat16)
    if float(out[0].abs().max()) != 0.0:
        raise AssertionError("flash_decode D 112: an empty slot is not zeros")
    mask = (torch.arange(Skv, device="cuda")[None, :]
            < ln[:, None])[:, None, None, :]
    qt, kt, vt = q[:, :, None], ck.transpose(1, 2), cv.transpose(1, 2)
    nbytes, flops = decode_bound(B, H, H, D, lengths, 2)
    bms, by = bound_ms(nbytes, flops)
    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=dk["scale"])
    rows["flash_decode"]["d112"] = case = dict(
        max_abs_err=err,
        ms=device_ms(lambda: ops.flash_decode(q, ck, cv, ln, **dk),
                     iters=50),
        eager_ms=time_ms(lambda: ops.flash_decode(q, ck, cv, ln, **dk),
                         iters=50),
        plain_ms=time_ms(lambda: ref.flash_decode_ref(q, ck, cv, ln, **dk)),
        library_ms=device_ms(sdpa, iters=50),
        library_eager_ms=time_ms(sdpa, iters=50), bound_ms=bms, bound_by=by)
    log(f"[kernels] flash_decode D 112: kernel {case['ms']:.4f} ms "
        f"({rate(nbytes, flops, case['ms'], by)}; eager launches "
        f"{case['eager_ms']:.4f} ms), plain {case['plain_ms']:.4f} ms, SDPA "
        f"{case['library_ms']:.4f} ms (eager {case['library_eager_ms']:.4f}), "
        f"bound {bms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.3f} GFLOP)")
    del q, ck, cv, out, mask, qt, kt, vt

    # f32 at D 112: the prefill with GQA and query offsets, the decode with
    # an active mask
    q = randn(gen, (3, 40, 8, D), torch.float32)
    k = randn(gen, (3, 300, 2, D), torch.float32)
    v = randn(gen, (3, 300, 2, D), torch.float32)
    kw = dict(causal=True, window=0, scale=D ** -0.5,
              kv_len=torch.tensor([30, 117, 290], dtype=torch.int32,
                                  device="cuda"),
              q_offset=torch.tensor([0, 77, 250], dtype=torch.int32,
                                    device="cuda"))
    check("flash_attention D 112 q_offset GQA (3,40 over 300,8/2,112) f32",
          float((ops.flash_attention(q, k, v, **kw)
                 - ref.flash_attention_ref(q, k, v, **kw)).abs().max()),
          torch.float32)
    q = randn(gen, (4, 8, D), torch.float32)
    ck = randn(gen, (4, 256, 2, D), torch.float32)
    cv = randn(gen, (4, 256, 2, D), torch.float32)
    ln = torch.tensor([100, 7, 200, 256], dtype=torch.int32, device="cuda")
    dk = dict(scale=D ** -0.5, active=torch.tensor([True, False, True, True],
                                                   device="cuda"))
    check("flash_decode D 112 active mask (4,8/2,112) Skv 256 f32",
          float((ops.flash_decode(q, ck, cv, ln, **dk)
                 - ref.flash_decode_ref(q, ck, cv, ln, **dk)).abs().max()),
          torch.float32)


def plain_attention_rows(q, k, v, kw, rows=512):
    """``ref.flash_attention_ref`` over slices of ``rows`` query rows, each
    at its offset: the plain version at a length whose whole (S, T) score
    matrix would not fit the card (S 8192: 68 GB of f32 scores at B 8)."""
    B, S = q.shape[:2]
    base = kw.get("q_offset")
    outs = []
    for i in range(0, S, rows):
        off = torch.full((B,), i, dtype=torch.int32, device=q.device)
        if base is not None:
            off = off + base
        outs.append(ref.flash_attention_ref(q[:, i:i + rows].contiguous(), k,
                                            v, **dict(kw, q_offset=off)))
    return torch.cat(outs, dim=1)


def attn_mask(S, T, kl, window=0):
    """The (B, 1, S, T) boolean mask of causal (and windowed) attention over
    keys below kl: SDPA's way to compute the same function."""
    qp = torch.arange(S, device="cuda")[:, None]
    kp = torch.arange(T, device="cuda")[None, :]
    m = kp <= qp
    if window:
        m = m & (qp - kp < window)
    return (m[None] & (kp[None] < kl[:, None, None]))[:, None]


def wide_prefill_row(label, gen, B, S, H, Hkv, D, kv_len, window=0,
                     iters=20, chunked=False):
    """One timed phase-3 row of the prefill kernel at a dense decoder's
    shape: bf16, causal (windowed when ``window``), ragged kv_len; held
    against the plain version (query-row slices when ``chunked``), beside
    SDPA and the bound."""
    q = randn(gen, (B, S, H, D), torch.bfloat16)
    k = randn(gen, (B, S, Hkv, D), torch.bfloat16)
    v = randn(gen, (B, S, Hkv, D), torch.bfloat16)
    kl = torch.as_tensor(np.asarray(kv_len, np.int32), device="cuda")
    kw = dict(causal=True, window=window, scale=D ** -0.5, kv_len=kl)
    out = ops.flash_attention(q, k, v, **kw)
    sync()

    def plain():
        return (plain_attention_rows(q, k, v, kw) if chunked
                else ref.flash_attention_ref(q, k, v, **kw))
    err = check(f"flash_attention {label} ({B},{S},{H}/{Hkv},{D}) bf16 "
                f"causal{f' window {window}' if window else ''} ragged "
                f"kv_len", float((out.float() - plain().float()).abs().max()),
                torch.bfloat16)
    plain_ms = time_ms(plain, iters=1, warmup=1)
    mask = attn_mask(S, S, kl, window)
    qt = q.transpose(1, 2)
    # SDPA with enable_gqa takes no mask but on its math route, whose (B,
    # H, S, S) f32 scores at S 8192 do not fit: there it gets K/V repeated
    # to H heads (the repeat outside the timed call)
    if chunked:
        kt = k.repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
        vt = v.repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
        gqa = False
    else:
        kt, vt, gqa = k.transpose(1, 2), v.transpose(1, 2), H != Hkv

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=kw["scale"], enable_gqa=gqa)
    nbytes, flops = attention_bound(B, S, H, Hkv, D, kv_len, True, window, 2)
    row = dict(max_abs_err=err, shape=[B, S, H, Hkv, D], window=window,
               **attn_times(label, lambda: ops.flash_attention(q, k, v, **kw),
                            sdpa, plain_ms, nbytes, flops, iters))
    if chunked:
        row["library_note"] = "SDPA over K/V repeated to H heads"
    del q, k, v, out, mask, qt, kt, vt
    gc.collect()
    torch.cuda.empty_cache()
    return row


def wide_decode_row(label, gen, B, H, Hkv, D, Skv, lengths, paged=0,
                    memory=False):
    """One timed phase-3 row of the slot decode kernel (and with ``paged``
    = P, of the paged one over the same K/V in scattered pages of P, which
    must give the slot kernel's bits), bf16, beside SDPA and the bound.
    With ``memory`` (a whole cross-attention memory, ``lengths`` = Skv) the
    row is held to CROSS_REL_TOL of the largest output, and the kernel with
    the last partial tile's keys dropped must fail that bound."""
    q = randn(gen, (B, H, D), torch.bfloat16)
    ck = randn(gen, (B, Skv, Hkv, D), torch.bfloat16)
    cv = randn(gen, (B, Skv, Hkv, D), torch.bfloat16)
    ln = torch.as_tensor(np.asarray(lengths, np.int32), device="cuda")
    dk = dict(scale=D ** -0.5)
    slot = ops.flash_decode(q, ck, cv, ln, **dk)
    sync()
    want = ref.flash_decode_ref(q, ck, cv, ln, **dk)
    name = "paged_flash_decode" if paged else "flash_decode"
    call = lambda: ops.flash_decode(q, ck, cv, ln, **dk)  # noqa: E731
    plain = lambda: ref.flash_decode_ref(q, ck, cv, ln, **dk)  # noqa: E731
    mask = (torch.arange(Skv, device="cuda")[None, :]
            < ln[:, None])[:, None, None, :]
    qt, kt, vt = q[:, :, None], ck.transpose(1, 2), cv.transpose(1, 2)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=dk["scale"],
            enable_gqa=H != Hkv)
    out, extra = slot, {}
    if paged:
        P = paged
        n = Skv // P
        perm = torch.as_tensor(gen.permutation(B * n), device="cuda")
        kp = torch.full((B * n + 1, P, Hkv, D), 1e4, dtype=ck.dtype,
                        device="cuda")
        vp = kp.clone()
        kp[perm] = ck.reshape(-1, P, Hkv, D)
        vp[perm] = cv.reshape(-1, P, Hkv, D)
        pt = perm.reshape(B, n).to(torch.int32)
        out = ops.paged_flash_decode(q, kp, vp, pt, ln, **dk)
        same = torch.equal(out, slot)
        log(f"[kernels] {name} {label} vs flash_decode on the same K/V "
            f"(pages of {P}): bitwise equal: {same}")
        if not same:
            raise AssertionError(f"{name} {label}: paged and slot decode "
                                 f"differ")
        extra["paged_bitwise_equal"] = same
        call = lambda: ops.paged_flash_decode(q, kp, vp, pt, ln,  # noqa
                                              **dk)
        plain = lambda: ref.paged_decode_ref(q, kp, vp, pt, ln, **dk)  # noqa
        flat = pt.reshape(-1).long()

        def library():
            kk = kp.index_select(0, flat).reshape(B, Skv, Hkv, D)
            vv = vp.index_select(0, flat).reshape(B, Skv, Hkv, D)
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kk.transpose(1, 2), vv.transpose(1, 2), attn_mask=mask,
                scale=dk["scale"], enable_gqa=H != Hkv)
    tol = (CROSS_REL_TOL * float(want.float().abs().max()) if memory
           else None)
    err = check(f"{name} {label} ({B},{H}/{Hkv},{D}) Skv {Skv} bf16",
                float((out.float() - want.float()).abs().max()),
                torch.bfloat16, tol=tol)
    if memory:
        tail = Skv % TILE_KEYS or TILE_KEYS
        short = ops.flash_decode(q, ck, cv, ln - tail, **dk)
        extra.update(tol=tol, dropped_tail_keys=tail, dropped_tail_err=(
            planted_tail(f"{name} {label}",
                         float((short.float() - want.float()).abs().max()),
                         tol, tail)))
    nbytes, flops = decode_bound(B, H, Hkv, D, lengths, 2, page=paged)
    bms, by = bound_ms(nbytes, flops)
    row = dict(max_abs_err=err, shape=[B, H, Hkv, D, Skv],
               ms=device_ms(call, iters=50), eager_ms=time_ms(call, iters=50),
               plain_ms=time_ms(plain), library_ms=device_ms(library,
                                                             iters=50),
               library_eager_ms=time_ms(library, iters=50), bound_ms=bms,
               bound_by=by, **extra)
    log(f"[kernels] {name} {label}: kernel {row['ms']:.4f} ms "
        f"({rate(nbytes, flops, row['ms'], by)}; eager launches "
        f"{row['eager_ms']:.4f} ms), plain {row['plain_ms']:.4f} ms, "
        f"{'gather+' if paged else ''}SDPA {row['library_ms']:.4f} ms "
        f"(eager {row['library_eager_ms']:.4f}), bound {bms:.4f} ms ({by}: "
        f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)")
    return row


def phase_kernels_wide(rows) -> None:
    """Phase 3 at the dense decoders' shapes, on its own generator: the
    prefill kernel at head dim 80 with H2O-Danube's 4096-token window over
    its long mix's 8192-token wave, at head dim 160 (StableLM-12B) and at
    GQA group 6 (Nemotron-4-15B); the decode kernel at head dim 80 over a
    full 4096-key ring, at 160 and at group 6; the paged decode at 160
    (bitwise the slot kernel's); all in bf16 with times, and f32 checks of
    both kernels at 80 and 160 with groups 4 and 6."""
    gen = np.random.RandomState(6)
    pre, dec = {}, {}
    kl = gen.randint(3000, 6001, size=8)
    pre["d80_window"] = wide_prefill_row(
        "D 80 window 4096", gen, 8, 8192, 32, 8, 80, kl, window=4096,
        iters=5, chunked=True)
    for key, label, (H, Hkv, D) in (("d160", "D 160", (32, 8, 160)),
                                    ("g6", "G 6", (48, 8, 128))):
        kl = gen.randint(1, 513, size=16)
        kl[:2] = (1, 512)
        pre[key] = wide_prefill_row(label, gen, 16, 512, H, Hkv, D, kl)
    ring = np.full(16, 4096)
    dec["d80_ring"] = wide_decode_row("D 80 ring 4096 full", gen, 16, 32, 8,
                                      80, 4096, ring)
    lengths = gen.randint(2, 1024, size=16)
    lengths[:3] = (0, 1, 1024)
    dec["d160"] = wide_decode_row("D 160", gen, 16, 32, 8, 160, 1024,
                                  lengths)
    dec["g6"] = wide_decode_row("G 6", gen, 16, 48, 8, 128, 1024, lengths)
    paged = wide_decode_row("D 160", gen, 16, 32, 8, 160, 1024, lengths,
                            paged=64)
    rows["flash_attention"]["wide"] = pre
    rows["flash_decode"]["wide"] = dec
    rows["paged_flash_decode"]["wide"] = {"d160": paged}

    # f32 (the CUDA-core routes): prefill with GQA, a window and query
    # offsets; decode with groups 4 and 6 and an active mask
    for D in (80, 160):
        for H, Hkv in ((8, 2), (12, 2)):
            q = randn(gen, (3, 40, H, D), torch.float32)
            k = randn(gen, (3, 300, Hkv, D), torch.float32)
            v = randn(gen, (3, 300, Hkv, D), torch.float32)
            kw = dict(causal=True, window=64, scale=D ** -0.5,
                      kv_len=torch.tensor([30, 117, 290], dtype=torch.int32,
                                          device="cuda"),
                      q_offset=torch.tensor([0, 77, 250], dtype=torch.int32,
                                            device="cuda"))
            check(f"flash_attention D {D} q_offset window 64 GQA (3,40 over "
                  f"300,{H}/{Hkv},{D}) f32",
                  float((ops.flash_attention(q, k, v, **kw)
                         - ref.flash_attention_ref(q, k, v, **kw)).abs()
                        .max()), torch.float32)
            q = randn(gen, (4, H, D), torch.float32)
            ck = randn(gen, (4, 256, Hkv, D), torch.float32)
            cv = randn(gen, (4, 256, Hkv, D), torch.float32)
            ln = torch.tensor([100, 7, 200, 256], dtype=torch.int32,
                              device="cuda")
            dk = dict(scale=D ** -0.5,
                      active=torch.tensor([True, False, True, True],
                                          device="cuda"))
            check(f"flash_decode D {D} active mask (4,{H}/{Hkv},{D}) Skv 256 "
                  f"f32",
                  float((ops.flash_decode(q, ck, cv, ln, **dk)
                         - ref.flash_decode_ref(q, ck, cv, ln, **dk)).abs()
                        .max()), torch.float32)


def cross_prefill_row(label, gen, B, S, T, H, Hkv, D, kv_len=True,
                      iters=10):
    """One timed phase-3 row of the prefill kernel, bf16, NOT causal: S
    queries over T keys (Whisper's encoder at S = T = 1500 with no
    kv_len; the cross-attention prefill over a memory of T keys with
    ``kv_len = T`` per row, as ``attend_cached_memory`` calls it), held
    against the plain version, beside SDPA (no mask) and the bound."""
    q = randn(gen, (B, S, H, D), torch.bfloat16)
    k = randn(gen, (B, T, Hkv, D), torch.bfloat16)
    v = randn(gen, (B, T, Hkv, D), torch.bfloat16)
    kl = (torch.full((B,), T, dtype=torch.int32, device="cuda") if kv_len
          else None)
    kw = dict(causal=False, scale=D ** -0.5, kv_len=kl)
    out = ops.flash_attention(q, k, v, **kw)
    sync()

    def plain():
        return ref.flash_attention_ref(q, k, v, **kw)
    name = (f"flash_attention {label} ({B},{S} over {T},{H}/{Hkv},{D}) bf16 "
            f"not causal{', kv_len = T' if kv_len else ''}")
    want = plain().float()
    tol = CROSS_REL_TOL * float(want.abs().max())
    err = check(name, float((out.float() - want).abs().max()),
                torch.bfloat16, tol=tol)
    tail = T % TILE_KEYS or TILE_KEYS
    short = ops.flash_attention(q, k, v, **dict(kw, kv_len=torch.full(
        (B,), T - tail, dtype=torch.int32, device="cuda")))
    fault = planted_tail(name, float((short.float() - want).abs().max()),
                         tol, tail)
    del want, short
    plain_ms = time_ms(plain, iters=1, warmup=1)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, scale=kw["scale"], enable_gqa=H != Hkv)
    nbytes, flops = attention_bound(B, S, H, Hkv, D, [T] * B, False, 0, 2)
    if not kv_len:
        nbytes -= 4 * B
    row = dict(max_abs_err=err, tol=tol, dropped_tail_keys=tail,
               dropped_tail_err=fault, shape=[B, S, T, H, Hkv, D],
               **attn_times(label, lambda: ops.flash_attention(q, k, v, **kw),
                            sdpa, plain_ms, nbytes, flops, iters))
    del q, k, v, out, qt, kt, vt
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_kernels_cross(rows) -> None:
    """Phase 3 at the audio and vision models' shapes, on its own
    generator: the prefill kernel not causal, at Whisper-small's encoder
    (16 x 1500 frames, 12/12 heads of 64) and at the cross-attention
    prefill over a memory (16 x 512 queries over Llama-3.2-Vision's 4100
    patch keys, 32/8 heads of 128; 16 x 256 over Whisper's 1500 frames,
    12/12 of 64); the decode kernel over both memories with n_valid =
    Skv. Neither 1500 nor 4100 is a multiple of the 64-key tile: each row
    is held to CROSS_REL_TOL and must catch its last partial tile dropped."""
    gen = np.random.RandomState(9)
    pre = {"encoder": cross_prefill_row("whisper encoder", gen, 16, 1500,
                                        1500, 12, 12, 64, kv_len=False),
           "vision": cross_prefill_row("vision cross prefill", gen, 16, 512,
                                       4100, 32, 8, 128),
           "audio": cross_prefill_row("whisper cross prefill", gen, 16, 256,
                                      1500, 12, 12, 64)}
    dec = {"vision": wide_decode_row("vision cross memory", gen, 16, 32, 8,
                                     128, 4100, np.full(16, 4100),
                                     memory=True),
           "audio": wide_decode_row("whisper cross memory", gen, 16, 12, 12,
                                    64, 1500, np.full(16, 1500),
                                    memory=True)}
    rows["flash_attention"]["cross"] = pre
    rows["flash_decode"]["cross"] = dec


# ------------------------------------------------------------ 4. serve ----
def fact_prompts(vocab: int = 49_152):
    tok = HashTokenizer(vocab)
    claims = fever.claim_batch(range(64))
    return [tok.encode(fever.render_prompt(c, t))
            for t in fever.PROMPT_CANDIDATES for c in claims]


def long_prompts(vocab: int):
    rng = np.random.RandomState(0)
    lens = rng.randint(64, 501, size=16)
    return [rng.randint(8, vocab, size=int(n)).tolist() for n in lens]


def fewshot_prompts(tok):
    """Mix (d), few-shot fact verification: claims 64-127, each rendered
    with DEFAULT_PROMPT behind one shared preamble of exactly 448 tokens
    (7 pages): BOS, a run of seeded tokens standing for the task's
    instructions, then 16 labelled claims (0-15) rendered with
    DEFAULT_PROMPT and each followed by its label token."""
    shots = []
    for c in fever.claim_batch(range(16)):
        shots += tok.encode(fever.render_prompt(c), add_bos=False)
        shots.append(LABEL_TOKENS[c.label])
    fill = PREAMBLE_LEN - 1 - len(shots)
    if fill < 0:
        raise AssertionError(f"16 shots take {len(shots)} tokens")
    rng = np.random.RandomState(1)
    preamble = [BOS] + rng.randint(8, tok.vocab_size, size=fill).tolist() \
        + shots
    return [preamble + tok.encode(fever.render_prompt(c), add_bos=False)
            for c in fever.claim_batch(range(64, 128))]


def serve(engine, prompts, max_new, label):
    st0 = dict(engine.stats.as_dict())
    reqs = [engine.submit(Request(prompt=list(p), max_new_tokens=max_new,
                                  keep_logits=True)) for p in prompts]
    sync()
    t0 = time.monotonic()
    engine.run_to_completion()
    sync()
    wall = time.monotonic() - t0
    st = engine.stats.as_dict()
    d = {k: st[k] - st0[k] for k in ("prefill_tokens", "decode_tokens",
                                     "prefill_batches", "decode_steps",
                                     "decode_seconds", "prefix_hits",
                                     "cow_copies")}
    prefill_s = wall - d["decode_seconds"]
    rates = dict(requests=len(reqs), wall_s=wall,
                 requests_per_s=len(reqs) / wall,
                 prefill_tokens=d["prefill_tokens"],
                 prefill_tok_per_s=d["prefill_tokens"] / prefill_s,
                 decode_tokens=d["decode_tokens"],
                 decode_tok_per_s=(d["decode_tokens"] / d["decode_seconds"]
                                   if d["decode_seconds"] else None),
                 prefill_waves=d["prefill_batches"],
                 decode_steps=d["decode_steps"],
                 ttft_s=float(np.mean([r.ttft_seconds for r in reqs])))
    if engine.stats.decode_path == "paged":
        rates.update(prefix_hits=d["prefix_hits"], cow_copies=d["cow_copies"])
    log(f"[serve] {label}: {json.dumps(rates)}")
    for r in reqs:
        lg = r.first_logits
        if lg is None or lg.shape != (engine.cfg.padded_vocab,) \
                or not torch.isfinite(lg).all():
            raise AssertionError(f"{label}: bad first-token logits")
        if not 1 <= len(r.generated) <= max_new:
            raise AssertionError(f"{label}: {len(r.generated)} tokens")
    return reqs, rates


def serve_rounds(engine, prompts, max_new, label, size=16):
    """Mix (d) in rounds of one wave each (16 slots): the first round of
    a fresh sharing engine is cold, the later ones hit its prefix cache."""
    reqs, rounds = [], []
    for i in range(0, len(prompts), size):
        r, rates = serve(engine, prompts[i:i + size], max_new,
                         f"{label} round {i // size + 1}")
        reqs += r
        rounds.append(rates)
    return reqs, rounds


def expected_launches(engine, waves, steps):
    """What one path of ``waves`` prefill waves and ``steps`` decode steps
    launches. Dense GQA: each layer launches the prefill kernel once per
    wave and its engine's decode kernel once per step. xLSTM: nothing
    (its blocks are torch, as the reference's are XLA). Whisper and the
    VLM: each attention, self or cross (and Whisper's encoder layers),
    the prefill kernel once per wave and, decoder side, the decode kernel
    once per step. Zamba2 (slot
    cache): each Mamba2 layer the SSD scan once per wave (its decode step
    is torch, as the reference's is XLA), each application of the shared
    block the prefill kernel once per wave and the decode kernel once per
    step. DeepSeek (paged):
    each layer the MLA decode kernel once per step (its prefill is torch,
    as the reference's is XLA), each MoE layer the grouped GEMM three
    times (gate, up, down) per wave and per step. Nothing else launches.
    Returns (expected counts, the kernels that must have run)."""
    cfg = engine.cfg
    expect = {name: 0 for name in ops.LAUNCHES}
    if cfg.family == "ssm":
        return expect, []
    if cfg.family in ("audio", "vlm"):
        # Whisper: the encoder's layers and each decoder layer's self- and
        # cross-attention prefill once per wave, each decoder layer's
        # self- and cross-attention decode once per step; the VLM: every
        # self-attention layer and cross block likewise
        if cfg.family == "audio":
            n_pre, n_dec = cfg.n_encoder_layers + 2 * cfg.n_layers, \
                2 * cfg.n_layers
        else:
            n_pre = n_dec = cfg.n_layers + cfg.n_layers // cfg.cross_attn_every
        expect["flash_attention"] = n_pre * waves
        expect["flash_decode"] = n_dec * steps
        return expect, ["flash_attention"] + (["flash_decode"] if steps
                                              else [])
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.shared_attn_every
        expect["ssm_scan"] = cfg.n_layers * waves
        expect["flash_attention"] = n_attn * waves
        expect["flash_decode"] = n_attn * steps
        return expect, ["ssm_scan", "flash_attention"] + (
            ["flash_decode"] if steps else [])
    if cfg.attention == "mla":
        n_moe = cfg.n_layers - cfg.moe.first_dense_layers
        expect["paged_mla_decode"] = cfg.n_layers * steps
        expect["grouped_gemm_segments"] = 3 * n_moe * (waves + steps)
        must = ["grouped_gemm_segments"] + (["paged_mla_decode"] if steps
                                            else [])
        return expect, must
    decode_kernel = ("paged_flash_decode"
                     if engine.stats.decode_path == "paged"
                     else "flash_decode")
    expect["flash_attention"] = cfg.n_layers * waves
    expect[decode_kernel] = cfg.n_layers * steps
    return expect, ["flash_attention", decode_kernel]


def run_path(engine, label, fn):
    """Drive one main path with every launch count set to 0 just before,
    and hold the counts read just after against the path
    (``expected_launches``)."""
    st0 = dict(engine.stats.as_dict())
    ops.reset_launches()
    out = fn()
    launches = dict(ops.LAUNCHES)
    st = engine.stats.as_dict()
    expect, must = expected_launches(
        engine, st["prefill_batches"] - st0["prefill_batches"],
        st["decode_steps"] - st0["decode_steps"])
    log(f"[serve] {label} launches {launches}; expected {expect}")
    if launches != expect or any(launches[k] <= 0 for k in must):
        raise AssertionError(f"{label}: kernel launch counts do not match "
                             f"the path")
    return out, launches


def tokens(reqs):
    return [r.generated for r in reqs]


def stop_flag_cost(engine, prompts, ref_tokens, label, max_new=32):
    """The megastep reads the device's stop flag on the host after each
    decode step (``InferenceEngine._keep_decoding``). On the warmed engine,
    serve the mix at ``max_new`` tokens six times, alternating with that
    read and without it (the loop then runs its host-known step count):
    with, without, without, with, with, without; each side's median decode
    tok/s. The runs with the read also time it on the host: the share of
    decode time the host spends blocked in it bounds what dropping it
    could save. The tokens must be the main run's first ``max_new``."""
    want = [t[:max_new] for t in ref_tokens]
    read = type(engine)._keep_decoding
    blocked = {"s": 0.0, "reads": 0, "decode_s": 0.0}

    def timed_read(*args):
        t0 = time.perf_counter()
        go = read(*args)
        blocked["s"] += time.perf_counter() - t0
        blocked["reads"] += 1
        return go

    runs = {"with_flag_read": [], "without_flag_read": []}
    steps = set()
    for with_read in (True, False, False, True, True, False):
        key = "with_flag_read" if with_read else "without_flag_read"
        engine._keep_decoding = (timed_read if with_read
                                 else lambda *args: True)
        try:
            reqs, r = serve(engine, prompts, max_new,
                            f"{label} {key.replace('_', ' ')}")
        finally:
            del engine._keep_decoding
        if tokens(reqs) != want:
            raise AssertionError(f"{label}: the stop-flag read changed the "
                                 f"tokens")
        runs[key].append(r["decode_tok_per_s"])
        steps.add(r["decode_steps"])
        if with_read:
            blocked["decode_s"] += r["decode_tokens"] / r["decode_tok_per_s"]
    out = {k: dict(decode_tok_per_s=v, median=float(np.median(v)))
           for k, v in runs.items()}
    out.update(decode_steps=sorted(steps),
               median_cost=1.0 - (out["with_flag_read"]["median"]
                                  / out["without_flag_read"]["median"]),
               blocked_s=blocked["s"], reads=blocked["reads"],
               blocked_share=blocked["s"] / blocked["decode_s"])
    log(f"[serve] {label} decode tok/s at {max_new} new tokens with the "
        f"per-step stop-flag read {runs['with_flag_read']} (median "
        f"{out['with_flag_read']['median']:.1f}), without "
        f"{runs['without_flag_read']} (median "
        f"{out['without_flag_read']['median']:.1f}): medians differ by "
        f"{100 * out['median_cost']:.1f} %; the host blocked in "
        f"{blocked['reads']} reads for {1e3 * blocked['s']:.1f} ms "
        f"({1e6 * blocked['s'] / max(1, blocked['reads']):.0f} us a read), "
        f"{100 * out['blocked_share']:.2f} % of those runs' decode time; "
        f"decode steps {out['decode_steps']}")
    return out


def p_bf16_attention(q, k, v, *, scale, causal, window=0, q_offset=0,
                     kv_len=None, chunk=None):
    """The bf16 prefill kernel's arithmetic in plain torch, with
    ``models.attention.blockwise_attention``'s signature (``chunk`` is
    ignored): 64-key tiles from position 0, the online softmax in f32, P
    rounded to bf16 before P.V as the kernel's wgmma takes it, the
    normaliser summed from the unrounded P. A witness of what the rounding
    of P adds to the kernel-vs-plain gap, not a kernel's plain version."""
    B, S, H, D = q.shape
    T = k.shape[1]
    dev = q.device
    if isinstance(q_offset, torch.Tensor) and q_offset.dim() == 1:
        qp = q_offset.long()[:, None] + torch.arange(S, device=dev)
    else:
        qp = (torch.arange(S, device=dev) + q_offset)[None]     # (1|B, S)
    qf = q.float() * scale
    acc = torch.zeros((B, S, H, D), dtype=torch.float32, device=dev)
    m = torch.full((B, S, H), ref.NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, S, H), dtype=torch.float32, device=dev)
    for t0 in range(0, T, 64):
        kp = torch.arange(t0, min(t0 + 64, T), device=dev)
        s = torch.einsum("bshd,bthd->bsht", qf, k[:, t0:t0 + 64].float())
        vis = torch.ones(qp.shape + kp.shape, dtype=torch.bool, device=dev)
        if causal:
            vis = vis & (kp <= qp[..., None])
        if window:
            vis = vis & (qp[..., None] - kp < window)
        if kv_len is not None:
            vis = vis & (kp < kv_len.long()[:, None, None])
        vis = vis[:, :, None, :]                              # (B, S, 1, t)
        s = torch.where(vis, s, ref.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(vis, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.where(m_new == m, 1.0, torch.exp(m - m_new))
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bsht,bthd->bshd", p.to(torch.bfloat16).float(),
            v[:, t0:t0 + 64].float())
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def compare_dense(label, kern, plain, vocab, tol, phase="zamba2"):
    """Kernel engine vs plain engine on one mix of a dense-path model (no
    routing): the first-token logits gap over every request, held to
    ``tol``, and the greedy first tokens, which must agree where the plain
    logits' top-2 margin exceeds it. Returns the readings with a list of
    failures (empty when sound)."""
    gap, checked, agree = 0.0, 0, 0
    for rk, rp in zip(kern, plain):
        lk, lp = rk.first_logits[:vocab], rp.first_logits[:vocab]
        gap = max(gap, float((lk - lp).abs().max()))
        top2 = torch.topk(lp, 2).values
        if float(top2[0] - top2[1]) > tol:
            checked += 1
            agree += int(rk.generated[0] == rp.generated[0])
    out = dict(requests=len(kern), logits_gap=gap,
               logits_max=max(float(rp.first_logits[:vocab].abs().max())
                              for rp in plain),
               first_tokens_checked=checked, first_tokens_agree=agree,
               first_tokens_equal=sum(rk.generated[0] == rp.generated[0]
                                      for rk, rp in zip(kern, plain)),
               identical_sequences=sum(rk.generated == rp.generated
                                       for rk, rp in zip(kern, plain)),
               failures=[])
    if gap > tol:
        out["failures"].append(f"logits gap {gap} > {tol}")
    if agree != checked:
        out["failures"].append("first tokens disagree")
    log(f"[{phase}] {label} kernels vs plain: {json.dumps(out)} (logits tol "
        f"{tol})")
    return out


def compare(label, kern, plain, vocab):
    """``compare_dense`` for SmolLM2's mixes, held to LOGIT_TOL; raises on
    a failure and returns the logits gap."""
    out = compare_dense(label, kern, plain, vocab, LOGIT_TOL, phase="serve")
    if out["failures"]:
        raise AssertionError(f"{label}: {out['failures']}")
    return out["logits_gap"]


def profile_mix(engine, prompts, max_new, label) -> dict:
    """Device busy share and the heaviest kernels of one run of a mix,
    under torch.profiler (whose own host cost lowers the share a little).
    It traces the device alone: the host's op events add nothing to these
    readings and slow the profiler's processing of a long run."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    t_all = time.monotonic()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        engine.generate(prompts, max_new_tokens=max_new)
        sync()
        wall = time.monotonic() - t0
    kernels = [(e.self_device_time_total, e.key, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels) / 1e6
    top = [dict(kernel=k[1][:80], ms=k[0] / 1e3, calls=k[2])
           for k in kernels[:8]]
    # the port's own kernels, wherever they rank
    ours = [dict(kernel=k[1][:80], ms=k[0] / 1e3, calls=k[2])
            for k in kernels if "repro::" in k[1]]
    out = dict(wall_s=wall, device_busy_s=busy, busy_share=busy / wall,
               top=top, ours=ours, pass_s=time.monotonic() - t_all)
    log(f"[profile] {label}: {json.dumps(out)}")
    return out


def free(*engines) -> None:
    """Hand the engines' KV stores back to the card before the next engine
    takes its own (each holds 3.2 GB at these shapes)."""
    for e in engines:
        e.cache = None
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve() -> dict:
    cfg = dataclasses.replace(get_config("smollm2-1.7b"), use_kernels=True)
    model = build_model(cfg, device="cuda", seed=0)
    plain_model = build_model(dataclasses.replace(cfg, use_kernels=False),
                              device="cuda", params=dict(model.state_dict()))
    engine = InferenceEngine(model, device="cuda", **ENGINE_KW)
    log(f"[serve] smollm2-1.7b full width: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {sum(p.numel() for p in model.parameters())} "
        f"params bf16; engine {ENGINE_KW}; paged {PAGED_KW}")
    facts, longs = fact_prompts(), long_prompts(cfg.vocab_size)
    # warm the allocator and cuBLAS outside the counted runs
    engine.generate([[2, 5]], max_new_tokens=2)
    out = {"launches": {}}

    # (a) + (b): the slot cache
    (fk, rates_a, lk, rates_b), out["launches"]["ab"] = run_path(
        engine, "(a)+(b) slot cache", lambda: (
            *serve(engine, facts, 1, "(a) fact verification"),
            *serve(engine, longs, 64, "(b) long prompts")))
    plain = InferenceEngine(plain_model, device="cuda", **ENGINE_KW)
    fp, _ = serve(plain, facts, 1, "(a) plain path")
    lp, _ = serve(plain, longs, 64, "(b) plain path")
    out.update(rates_a=rates_a, rates_b=rates_b,
               logits_err_a=compare("(a)", fk, fp, cfg.vocab_size),
               logits_err_b=compare("(b)", lk, lp, cfg.vocab_size),
               long_tokens=tokens(lk))
    out["stop_flag_b"] = stop_flag_cost(engine, longs, tokens(lk), "(b)")
    out["profile_b"] = profile_mix(engine, longs, 64,
                                   "(b) SmolLM2 slot cache kernels")
    free(plain, engine)

    # (c): mix (b) through the paged pool
    pg = InferenceEngine(model, device="cuda", prefix_sharing=False,
                         **PAGED_KW)
    pg.generate([[2, 5]], max_new_tokens=2)
    (ck, rates_c), out["launches"]["c"] = run_path(
        pg, "(c) paged pool", lambda: serve(pg, longs, 64, "(c) paged pool"))
    same = tokens(ck) == tokens(lk)
    log(f"[serve] (c) paged tokens identical to the slot cache's (b): "
        f"{same}")
    if not same:
        raise AssertionError("(c): the paged pool decodes differently from "
                             "the slot cache")
    out["stop_flag_c"] = stop_flag_cost(pg, longs, tokens(ck), "(c)")
    plain_pg = InferenceEngine(plain_model, device="cuda",
                               prefix_sharing=False, **PAGED_KW)
    cp, _ = serve(plain_pg, longs, 64, "(c) plain path")
    out.update(rates_c=rates_c,
               logits_err_c=compare("(c)", ck, cp, cfg.vocab_size),
               paged_tokens=tokens(ck))
    free(plain_pg, pg)

    # (d): few-shot fact verification, with and without prefix sharing
    fs = fewshot_prompts(HashTokenizer(cfg.vocab_size))
    sh = InferenceEngine(model, device="cuda", **PAGED_KW)
    if sh.prefix_fallback is not None:
        raise AssertionError(f"(d): sharing is off: {sh.prefix_fallback}")
    sh.generate([[2, 5]], max_new_tokens=2)
    sh.drop_prefix_cache()
    (dk, rounds), out["launches"]["d"] = run_path(
        sh, "(d) prefix sharing", lambda: serve_rounds(sh, fs, 8,
                                                       "(d) sharing"))
    cold = InferenceEngine(model, device="cuda", prefix_sharing=False,
                           **PAGED_KW)
    dc, cold_rounds = serve_rounds(cold, fs, 8, "(d) no sharing")
    free(cold)
    hits = sum(r["prefix_hits"] for r in rounds)
    cows = sum(r["cow_copies"] for r in rounds)
    computed = sum(r["prefill_tokens"] for r in rounds)
    computed_cold = sum(r["prefill_tokens"] for r in cold_rounds)
    gap = max(float((a.first_logits - b.first_logits).abs().max())
              for a, b in zip(dk, dc))
    same_first = sum(a.generated[0] == b.generated[0] for a, b in zip(dk, dc))
    same = tokens(dk) == tokens(dc)
    ttft_cold = rounds[0]["ttft_s"]
    ttft_hit = float(np.mean([r["ttft_s"] for r in rounds[1:]]))
    log(f"[serve] (d) prompts {min(map(len, fs))}-{max(map(len, fs))} "
        f"tokens; prefix hits {hits}, COW copies {cows}; prefill tokens "
        f"computed {computed} vs {computed_cold} cold "
        f"({computed / computed_cold:.3f}x); TTFT cold wave "
        f"{ttft_cold * 1e3:.1f} ms, hit waves {ttft_hit * 1e3:.1f} ms "
        f"({ttft_cold / ttft_hit:.2f}x)")
    log(f"[serve] (d) shared vs cold: tokens identical {same}; first tokens "
        f"equal {same_first}/{len(fs)}; first-token logits max-abs gap "
        f"{gap:.6f} ({'bitwise equal' if gap == 0 else 'not bitwise'})")
    sh._alloc.check(sh._prefix_cache.pages())
    held = sum(len(sh._alloc.owned(s)) for s in range(sh.slots))
    log(f"[serve] (d) after the run: refcounts check out; slot-held pages "
        f"{held}; live pages {sh._alloc.live_pages} = prefix-cache pages "
        f"{len(sh._prefix_cache.pages())}")
    if not same or gap != 0.0:
        raise AssertionError("(d): shared prefill decodes differently from "
                             "cold prefill (tokens or first-token logits)")
    if hits < 48 or cows < 1 or computed > 0.35 * computed_cold or held:
        raise AssertionError("(d): prefix sharing did not do its work")
    out.update(rounds_d=rounds, rounds_d_cold=cold_rounds, prefix_hits=hits,
               cow_copies=cows, prefill_tokens_d=computed,
               prefill_tokens_d_cold=computed_cold, ttft_cold_s=ttft_cold,
               ttft_hit_s=ttft_hit, logits_gap_d=gap,
               fewshot_tokens=tokens(dk))
    out["sharing_engine"] = sh
    out["fewshot"] = fs
    out["longs"] = longs
    return out


# -------------------------------------------------------------- 5. pcm ----
def phase_pcm(long_tokens) -> dict:
    cfg = dataclasses.replace(get_config("smollm2-1.7b"), use_kernels=True)
    sync()
    t0 = time.monotonic()
    model = build_model(cfg, device="cuda", seed=0)
    engine = InferenceEngine(model, device="cuda", **ENGINE_KW)
    engine.generate([[2, 5]], max_new_tokens=1)
    sync()
    cold_s = time.monotonic() - t0

    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    cache_bytes = engine.snapshot()["capacity_bytes"]
    before = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    host = engine.offload_device_state()
    offload_s = time.monotonic() - t0
    freed = before - torch.cuda.memory_allocated()
    moved = sum(t.numel() * t.element_size() for t in host["params"].values())
    moved += sum(t.numel() * t.element_size() for t in host["cache"].values())
    log(f"[pcm] cold build (init + engine + first request) {cold_s:.3f} s; "
        f"offload {offload_s:.3f} s, {moved / 1e9:.3f} GB to pinned host; "
        f"device memory freed {freed / 1e9:.3f} GB (weights "
        f"{weight_bytes / 1e9:.3f} + cache {cache_bytes / 1e9:.3f})")
    if freed < weight_bytes + cache_bytes:
        raise AssertionError("offload did not free the weights and cache")

    t0 = time.monotonic()
    engine.restore_device_state(host)
    restore_s = time.monotonic() - t0
    log(f"[pcm] restore {restore_s:.3f} s "
        f"({moved / restore_s / 1e9:.2f} GB/s); compiles after restore "
        f"{engine.stats.compiles}")
    outs = engine.generate(long_prompts(cfg.vocab_size), max_new_tokens=64)
    same = outs == long_tokens
    log(f"[pcm] (b) after restore identical to the serve phase: {same}")
    if not same:
        raise AssertionError("restored context decodes differently")
    free(engine)
    return dict(cold_build_s=cold_s, offload_s=offload_s,
                restore_s=restore_s, bytes_moved=moved, freed_bytes=freed,
                cache_bytes=cache_bytes)


def phase_pcm_paged(eng, fewshot, fewshot_tokens, longs, paged_tokens,
                    slot_cache_bytes) -> dict:
    """Demote the sharing engine of (d): only the weights and the live
    pages move. Restore it, run (d) again (every wave hits its own prefix
    cache) and then clone a template of it into a twin that serves (c)."""
    snap = eng.snapshot()
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in eng.model.parameters())
    before = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    host = eng.offload_device_state()
    offload_s = time.monotonic() - t0
    freed = before - torch.cuda.memory_allocated()
    pages = sum(t.numel() * t.element_size() for t in host["cache"].values())
    moved = pages + sum(t.numel() * t.element_size()
                        for t in host["params"].values())
    log(f"[pcm] paged sharing engine: offload {offload_s:.3f} s, "
        f"{moved / 1e9:.3f} GB to pinned host = weights "
        f"{weight_bytes / 1e9:.3f} + {snap['live_pages']} live pages of "
        f"{eng.num_pages} {pages / 1e9:.3f} GB (the slot cache ships "
        f"{slot_cache_bytes / 1e9:.3f} GB); device memory freed "
        f"{freed / 1e9:.3f} GB")
    if pages != snap["live_bytes"] or moved != weight_bytes + pages:
        raise AssertionError("paged offload moved more than the weights "
                             "and the live pages")
    if freed < weight_bytes + snap["capacity_bytes"]:
        raise AssertionError("paged offload did not free the weights and "
                             "the pool")
    t0 = time.monotonic()
    eng.restore_device_state(host)
    restore_s = time.monotonic() - t0
    log(f"[pcm] paged restore {restore_s:.3f} s "
        f"({moved / restore_s / 1e9:.2f} GB/s)")
    st0 = eng.stats.as_dict()
    again, rounds = serve_rounds(eng, fewshot, 8, "(d) after restore")
    hits = eng.stats.prefix_hits - st0["prefix_hits"]
    same = tokens(again) == fewshot_tokens
    log(f"[pcm] (d) after restore: prefix hits {hits}/{len(fewshot)}, "
        f"tokens identical {same}")
    if not same or hits != len(fewshot):
        raise AssertionError("restored sharing engine decodes differently "
                             "or misses its prefix cache")

    t0 = time.monotonic()
    tpl = eng.export_template()
    clone = eng.clone_offloaded()
    clone.restore_device_state(tpl)
    clone_s = time.monotonic() - t0
    tpl_pages = sum(t.numel() for t in tpl["cache"].values())
    outs = clone.generate(longs, max_new_tokens=64)
    same = outs == paged_tokens
    log(f"[pcm] template export + clone + restore {clone_s:.3f} s "
        f"({tpl_pages} page elements shipped); clone builds "
        f"{clone.stats.compiles}; (c) on the clone identical: {same}")
    if not same or clone.stats.compiles or tpl_pages:
        raise AssertionError("the template clone differs, ships pages or "
                             "builds kernels")
    free(clone, eng)
    return dict(offload_s=offload_s, restore_s=restore_s, bytes_moved=moved,
                page_bytes=pages, live_pages=snap["live_pages"],
                freed_bytes=freed, rounds_after_restore=rounds,
                clone_s=clone_s)


# ---------------------------------------------------------- 5b. runtime ----
# the runtime mix: the engine each worker builds (slot cache, 16 slots,
# 0.8 GB of bf16 cache) and fact verification as launch/serve.py runs it:
# 4 templates x 64 claims in batches of 16, two new tokens each
RUNTIME_KW = dict(slots=16, cache_len=256, prefill_buckets=(32, 128),
                  megastep=8, cache_dtype=torch.bfloat16)
RUNTIME_BATCH = 16


def runtime_batches():
    """(template, claim indices) of each batch, in submission order."""
    return [(t, list(range(i, i + RUNTIME_BATCH)))
            for t in fever.PROMPT_CANDIDATES
            for i in range(0, 64, RUNTIME_BATCH)]


def phase_runtime() -> dict:
    """Full-width SmolLM2-1.7B through the PCM runtime: the seeded weights
    written with the port's CheckpointManager, a 2-worker PCMManager whose
    workers build their context with ``launch/serve.build_context`` from
    that checkpoint, the fact-verification sweep through ``context_app``
    with worker 0 preempted after the first 4 batches and a replacement
    added, then one context taken DEVICE -> HOST_RAM -> LOCAL_DISK ->
    DEVICE (streamed) and one more batch. Every claim's two tokens must
    equal a bare engine's on the same weights and prompts, the replacement
    must bootstrap from the pool or a peer, and the builder may run only
    for the workers that built cold."""
    cfg = dataclasses.replace(get_config("smollm2-1.7b"), use_kernels=True)
    tmp = tempfile.TemporaryDirectory(prefix="runtime_smoke_")
    ckdir, spill = Path(tmp.name) / "ckpt", Path(tmp.name) / "pool"
    model = build_model(cfg, device="cuda", seed=0)
    t0 = time.monotonic()
    CheckpointManager(str(ckdir)).save(0, dict(model.state_dict()))
    ckpt_s = time.monotonic() - t0
    ckpt_bytes = sum(f.stat().st_size for f in ckdir.rglob("*"))
    log(f"[runtime] seeded weights written with CheckpointManager: "
        f"{ckpt_bytes / 1e9:.3f} GB in {ckpt_s:.3f} s")

    # the bare engine: the same batches, one generate each, as a task runs
    batches = runtime_batches()
    tok = HashTokenizer(cfg.vocab_size)

    def prompts_of(template, idx):
        return [tok.encode(fever.render_prompt(c, template))
                for c in fever.claim_batch(idx)]

    bare = InferenceEngine(model, device="cuda", **RUNTIME_KW)
    bare.generate([[2, 5]], max_new_tokens=2)
    sync()
    t0 = time.monotonic()
    want = [bare.generate(prompts_of(t, idx), max_new_tokens=2)
            for t, idx in batches]
    sync()
    bare_s = time.monotonic() - t0
    free(bare)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    bare_rate = len(batches) * RUNTIME_BATCH / bare_s
    log(f"[runtime] bare engine: {len(batches) * RUNTIME_BATCH} claims in "
        f"{bare_s:.3f} s = {bare_rate:.1f} claims/s")

    ops.reset_launches()
    t_phase = time.monotonic()
    mgr = PCMManager(mode=ContextMode.FULL, n_workers=2,
                     spill_dir=str(spill))
    try:
        recipe = make_recipe(
            "smollm2-1.7b.ctx", serve_cli.build_context,
            ("smollm2-1.7b", RUNTIME_KW["slots"], RUNTIME_KW["cache_len"],
             RUNTIME_KW["megastep"], cfg, "cuda", str(ckdir),
             RUNTIME_KW["prefill_buckets"], RUNTIME_KW["cache_dtype"]))

        @context_app(recipe=recipe, manager=mgr, n_items=RUNTIME_BATCH)
        def verify_batch(indices, template):
            return serve_cli.verify_claims(indices, template)

        # both workers build cold, at the same moment (each loads the
        # checkpoint; their threads load the kernel libraries together)
        t0 = time.monotonic()
        mgr.warm_up(recipe)
        warm_s = time.monotonic() - t0
        first = next(iter(mgr.workers))
        t0 = time.monotonic()
        futs = [verify_batch(idx, t) for t, idx in batches]
        for f in futs[:4]:
            f.result(timeout=600)
        t_four = time.monotonic() - t0
        victim = mgr.workers[first]
        mgr.preempt_worker(first)
        victim.join(300)                # its context is in the pool now
        retire_s = time.monotonic() - t0 - t_four
        joiner = mgr.add_worker()
        log(f"[runtime] both workers built in {warm_s:.3f} s; 4 batches "
            f"done at {t_four:.3f} s; {first} preempted and retired (its "
            f"context demoted to the pool) in {retire_s:.3f} s while "
            f"{len(mgr.workers) - 1} worker served; {joiner} added")
        got = [f.result(timeout=600) for f in futs]
        sweep_s = time.monotonic() - t0
        claims = len(batches) * RUNTIME_BATCH
        rate_rt = claims / sweep_s
        same = [g[0] for g in got] == want
        accuracy = {t[:24]: float(np.mean([v for (tt, _), g in
                                           zip(batches, got) if tt == t
                                           for v in g[1]]))
                    for t in fever.PROMPT_CANDIDATES}
        st = mgr.stats()
        fetches = [(d.worker_id, d.source.name, d.donor,
                    d.degraded_from.name if d.degraded_from else None)
                   for d in mgr.fetch_history(recipe)]
        workers = {w.worker_id: dict(
            tasks=len(w.library.records),
            builder_calls=w.library.builder_calls,
            build_stages=[w.library.context(k).value["build_stages"]
                          for k in w.library.resident_keys],
            build_s=w.library.build_seconds_total,
            restores=w.library.restores,
            restore_s=w.library.restore_seconds_total,
            peer_installs=w.library.peer_installs,
            peer_install_s=w.library.peer_install_seconds)
            for w in mgr._spawned}
        log(f"[runtime] sweep: {claims} claims in {sweep_s:.3f} s = "
            f"{rate_rt:.1f} claims/s (bare engine {bare_rate:.1f}, "
            f"{rate_rt / bare_rate:.3f}x); tokens identical to the bare "
            f"engine: {same}; accuracy per template {accuracy}")
        log(f"[runtime] fetch_log {fetches}")
        log(f"[runtime] workers {json.dumps(workers)}")
        log(f"[runtime] stats: builder calls {st['builder_calls']}, cold "
            f"invocations {st['cold_invocations']}, warm "
            f"{st['warm_invocations']}, restores {st['context_restores']}, "
            f"peer installs {st['peer_installs']}, striping "
            f"{st['striping']}")
        built = sum(1 for w in workers.values() if w["builder_calls"])
        joined = [f for f in fetches if f[0] == joiner]
        if not same:
            raise AssertionError("runtime: tokens differ from the bare "
                                 "engine's")
        if not joined or joined[0][1] not in ("POOL", "PEER") or \
                workers[joiner]["builder_calls"]:
            raise AssertionError(f"runtime: the replacement did not "
                                 f"bootstrap from the pool or a peer: "
                                 f"{joined}")
        if st["builder_calls"] != built or any(
                w["builder_calls"] > 1 for w in workers.values()):
            raise AssertionError("runtime: the builder ran more often than "
                                 "the workers that built cold")

        # the same sweep again on the two warm workers, no preemption:
        # the runtime's own cost against the bare engine
        t0 = time.monotonic()
        steady = [f.result(timeout=600) for f in
                  [verify_batch(idx, t) for t, idx in batches]]
        steady_s = time.monotonic() - t0
        rate_steady = claims / steady_s
        log(f"[runtime] steady sweep on 2 warm workers: {claims} claims in "
            f"{steady_s:.3f} s = {rate_steady:.1f} claims/s "
            f"({rate_steady / bare_rate:.3f}x the bare engine); tokens "
            f"identical {[g[0] for g in steady] == want}")
        if [g[0] for g in steady] != want:
            raise AssertionError("runtime: the steady sweep's tokens differ")

        # one context through the disk: the other worker retires (its copy
        # goes to the pool), the replacement demotes to LOCAL_DISK, and the
        # next batch restores it streamed
        retiring = [w for wid, w in mgr.workers.items() if wid != joiner]
        for w in retiring:
            mgr.preempt_worker(w.worker_id)
        for w in retiring:                  # its demotion has landed
            w.join(300)
        eng = mgr.workers[joiner].library.context(recipe.key()) \
            .value["engine"]
        compiles0 = eng.stats.compiles
        calls0 = mgr.stats()["builder_calls"]
        t0 = time.monotonic()
        mgr.demote_context(recipe, tier=Tier.LOCAL_DISK,
                           worker_ids=[joiner])
        demote_s = time.monotonic() - t0
        snap = mgr.snapshots.peek(recipe.key())
        if snap is None or mgr.snapshots.tier(recipe.key()) != \
                Tier.LOCAL_DISK:
            raise AssertionError("runtime: the context is not on disk")
        spill_bytes = mgr.snapshots.stats()["disk_used_bytes"]
        t, idx = batches[-1]
        again = verify_batch(idx, t).result(timeout=600)
        ctx = mgr.workers[joiner].library.context(recipe.key())
        eng = ctx.value["engine"]
        same_rt = again[0] == want[-1]
        stage = {k: [int(v[0]), float(v[1])]
                 for k, v in ctx.stage_seconds.items()}
        log(f"[runtime] disk round trip: demote + spill {demote_s:.3f} s "
            f"({snap.nbytes / 1e9:.3f} GB snapshot, "
            f"{spill_bytes / 1e9:.3f} GB on disk); streamed restore "
            f"{ctx.restore_seconds:.3f} s, stages {stage} (cold build "
            f"{workers[first]['build_s']:.3f} s); tokens identical "
            f"{same_rt}; compiles {eng.stats.compiles}; builder calls "
            f"{mgr.stats()['builder_calls'] - calls0} new")
        if not same_rt or not ctx.restored or eng.stats.compiles != \
                compiles0 or mgr.stats()["builder_calls"] != calls0 or \
                set(stage) != {"disk", "h2d"}:
            raise AssertionError("runtime: the disk round trip decoded "
                                 "differently, built or did not stream")
    finally:
        mgr.shutdown()
    launches = dict(ops.LAUNCHES)
    phase_s = time.monotonic() - t_phase
    log(f"[runtime] launches {launches}; phase {phase_s:.1f} s")
    if launches["flash_attention"] <= 0 or launches["flash_decode"] <= 0:
        raise AssertionError("runtime: the prefill or decode kernel never "
                             "launched")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(checkpoint_s=ckpt_s, checkpoint_bytes=ckpt_bytes,
                warm_up_s=warm_s, four_batches_s=t_four,
                retire_s=retire_s, bare_s=bare_s, bare_claims_per_s=bare_rate,
                sweep_s=sweep_s, claims_per_s=rate_rt,
                steady_s=steady_s, steady_claims_per_s=rate_steady,
                accuracy=accuracy, fetch_log=fetches, workers=workers,
                stats={k: st[k] for k in (
                    "builder_calls", "cold_invocations", "warm_invocations",
                    "context_restores", "peer_installs", "striping")},
                disk=dict(demote_spill_s=demote_s, snapshot_bytes=snap.nbytes,
                          spill_bytes=spill_bytes,
                          restore_s=ctx.restore_seconds,
                          stage_seconds=stage),
                phase_s=phase_s, launches={"runtime": launches},
                # for the multihost phase, popped by main: the checkpoint
                # (cleaned up after that phase), the recipe's arguments
                # and the bare engine's tokens and rate
                handoff=dict(tmp=tmp, ckdir=str(ckdir), cfg=cfg,
                             batches=batches, want=want,
                             bare_rate=bare_rate))


# -------------------------------------------------------- 5c. multihost ----
MULTIHOST_LIBRARIES = 2          # flash_attention and flash_decode


def multihost_task(indices, template):
    """A task of the multihost phase, run in a worker node process:
    ``launch/serve.verify_claims`` on the node's held context, with the
    node's pid, its engine's build counters, and the prefill waves, decode
    steps and kernel launches (``ops.LAUNCHES`` deltas) the task made."""
    eng = load_context("engine")
    st0 = eng.stats.as_dict()
    l0 = dict(ops.LAUNCHES)
    outs, verdicts = serve_cli.verify_claims(indices, template)
    st = eng.stats.as_dict()
    return dict(pid=os.getpid(), tokens=outs, verdicts=verdicts,
                waves=st["prefill_batches"] - st0["prefill_batches"],
                steps=st["decode_steps"] - st0["decode_steps"],
                launches={k: v - l0[k] for k, v in ops.LAUNCHES.items()},
                compiles=st["compiles"],
                aot_cache_hits=st["aot_cache_hits"])


def phase_multihost(handoff) -> dict:
    """Full-width SmolLM2-1.7B in two worker node processes on the one
    card (``python -m repro_torch.cluster.node``, each with a CUDA context
    of its own), joined to ``PCMManager.listen()`` over loopback, from the
    runtime phase's checkpoint: node A builds the context cold and serves
    mix (a)'s first 4 batches; node B joins with ``--aot-cache`` at the
    build directory and bootstraps the context from A by PEER over the
    socket while A serves the other 12; a steady sweep of the 16 batches
    on both; a sweep during which A is killed with SIGKILL (its task
    requeues to B). Every batch's tokens and verdicts must equal the bare
    engine's, B must build nothing (each library a cache hit), and every
    task's kernel launches must match its waves and steps."""
    mh = importlib.import_module("chip_smoke")     # tasks pickle by name
    cfg, batches, want = handoff["cfg"], handoff["batches"], handoff["want"]
    bare_rate = handoff["bare_rate"]
    want_verdicts = [[int((o[0] if o else -1) == LABEL_TOKENS[c.label])
                      for o, c in zip(outs, fever.claim_batch(idx))]
                     for outs, (_, idx) in zip(want, batches)]
    shape = types.SimpleNamespace(
        cfg=cfg, stats=types.SimpleNamespace(decode_path="full"))
    recipe = make_recipe(
        "smollm2-1.7b.ctx", serve_cli.build_context,
        ("smollm2-1.7b", RUNTIME_KW["slots"], RUNTIME_KW["cache_len"],
         RUNTIME_KW["megastep"], cfg, "cuda", handoff["ckdir"],
         RUNTIME_KW["prefill_buckets"], RUNTIME_KW["cache_dtype"]))
    results = []                    # every task result, in arrival order

    def check(label, got, which):
        for res, i in zip(got, which):
            results.append(res)
            expect, _ = expected_launches(shape, res["waves"], res["steps"])
            if res["tokens"] != want[i] or res["verdicts"] != \
                    want_verdicts[i]:
                raise AssertionError(f"multihost {label}: batch {i} differs "
                                     f"from the bare engine")
            if res["launches"] != expect:
                raise AssertionError(
                    f"multihost {label}: batch {i} launched "
                    f"{res['launches']}, its path {expect}")

    def sweep(label, which, timeout=600):
        futs = [mgr.submit(mh.multihost_task, args=(batches[i][1],
                                                    batches[i][0]),
                           recipe=recipe, n_items=RUNTIME_BATCH)
                for i in which]
        return futs, lambda: check(label, [f.result(timeout=timeout)
                                           for f in futs], which)

    ops.reset_launches()
    t_phase = time.monotonic()
    mgr = PCMManager(mode=ContextMode.FULL, n_workers=0)
    procs = {}

    def spawn(wid):
        t0 = time.monotonic()
        procs[wid] = spawn_node_process(
            mgr.address, wid, device="cuda", aot_cache=str(build.BUILD_DIR),
            extra_path=(str(ROOT),))
        mgr.wait_for_workers([wid], timeout=180)
        return time.monotonic() - t0

    try:
        mgr.listen(heartbeat=1.0, lost_after=60.0)
        join_a = spawn("nodeA")
        t0 = time.monotonic()
        mgr.warm_up(recipe, worker_ids=["nodeA"])
        build_s = time.monotonic() - t0
        t0 = time.monotonic()
        _, done = sweep("first 4 batches on A", range(4))
        done()
        four_s = time.monotonic() - t0
        log(f"[multihost] node A joined in {join_a:.3f} s, built the "
            f"context cold in {build_s:.3f} s, served 4 batches in "
            f"{four_s:.3f} s")

        join_b = spawn("nodeB")
        t_submit = mgr.now
        futs, done = sweep("PEER sweep", range(4, 16))
        peer_bytes, deadline = 0, time.monotonic() + 600
        while mgr.residency(recipe).get("nodeB") != Tier.DEVICE:
            if time.monotonic() > deadline:
                raise AssertionError("multihost: node B never became warm")
            with mgr._lock:
                for sf in mgr._stripes.values():
                    if sf.receiver_id == "nodeB":
                        peer_bytes = max(peer_bytes, sf.buffer.nbytes)
            time.sleep(0.005)
        t_warm = mgr.now
        done()
        fetches = [(d.worker_id, d.source.name, d.donor, d.t)
                   for d in mgr.fetch_history(recipe)]
        peer = [f for f in fetches if f[0] == "nodeB"]
        striping = dict(mgr.stats()["striping"])
        mirror_b = mgr.workers["nodeB"].library
        if not peer or peer[0][1] != "PEER" or peer[0][2] != "nodeA" or \
                mirror_b.builder_calls:
            raise AssertionError(f"multihost: node B did not bootstrap from "
                                 f"A by PEER: {fetches}")
        peer_s = t_warm - peer[0][3]
        how = "striped chunks" if striping["stripes"] else "one wire blob"
        on_b = [r for r in results if r["pid"] == procs["nodeB"].pid]
        log(f"[multihost] node B joined in {join_b:.3f} s and took the "
            f"context from A by PEER as {how}: {peer_bytes / 1e9:.3f} GB "
            f"in {peer_s:.3f} s from the decision "
            f"({peer_bytes / 1e9 / peer_s:.3f} GB/s; striping {striping}; "
            f"B restored it in {mirror_b.peer_install_seconds:.3f} s); B "
            f"served {len(on_b)} of 12 batches, decision at "
            f"{peer[0][3] - t_submit:.3f} s after the submit")

        t0 = time.monotonic()
        _, done = sweep("steady sweep", range(16))
        done()
        steady_s = time.monotonic() - t0
        claims = len(batches) * RUNTIME_BATCH
        steady_rate = claims / steady_s
        per_node = {w: sum(1 for r in results[-16:] if r["pid"] == p.pid)
                    for w, p in procs.items()}
        log(f"[multihost] steady sweep on 2 warm nodes: {claims} claims in "
            f"{steady_s:.3f} s = {steady_rate:.1f} claims/s "
            f"({steady_rate / bare_rate:.3f}x the bare engine's "
            f"{bare_rate:.1f}); batches per node {per_node}")
        on_b = [r for r in results if r["pid"] == procs["nodeB"].pid]
        if not on_b or any(r["compiles"] or r["aot_cache_hits"] !=
                           MULTIHOST_LIBRARIES for r in on_b):
            raise AssertionError(
                f"multihost: node B served nothing, built or missed the "
                f"cache: "
                f"{[(r['compiles'], r['aot_cache_hits']) for r in on_b]}")

        t0 = time.monotonic()
        futs, done = sweep("kill sweep", range(16))

        def a_running():
            with mgr._lock:
                return sum(f.done for f in futs) >= 4 and any(
                    e[0] == "nodeA" for e in mgr.scheduler.running.values())

        deadline = time.monotonic() + 300
        while not a_running():
            if time.monotonic() > deadline:
                raise AssertionError("multihost: node A ran no task after "
                                     "the sweep's fourth result")
            time.sleep(0.002)
        n_done = sum(f.done for f in futs)
        os.kill(procs["nodeA"].pid, signal.SIGKILL)
        kill_at = time.monotonic() - t0
        done()
        kill_s = time.monotonic() - t0
        attempts = [mgr.lookup_task(f.task_id).attempts for f in futs]
        a_gone = "nodeA" not in mgr.workers
        log(f"[multihost] kill sweep: node A killed with SIGKILL at "
            f"{kill_at:.3f} s with {n_done} of 16 batches done; the sweep "
            f"finished at {kill_s:.3f} s; requeued tasks "
            f"{sum(a > 0 for a in attempts)}; A left the pool: {a_gone}")
        if not a_gone or max(attempts) < 1:
            raise AssertionError("multihost: the killed node's task was "
                                 "not requeued")
        st = mgr.stats()
    finally:
        mgr.shutdown(timeout=60)
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        for p in procs.values():
            p.wait(timeout=60)
    launches = {}
    for wid, p in procs.items():
        mine = [r["launches"] for r in results if r["pid"] == p.pid]
        launches[wid] = {k: sum(m[k] for m in mine) for k in ops.LAUNCHES}
        if launches[wid]["flash_attention"] <= 0 or \
                launches[wid]["flash_decode"] <= 0:
            raise AssertionError(f"multihost: {wid} never launched the "
                                 f"prefill or decode kernel")
    phase_s = time.monotonic() - t_phase
    log(f"[multihost] launches per node {launches}; phase {phase_s:.1f} s")
    return dict(join_a_s=join_a, join_b_s=join_b, build_s=build_s,
                four_batches_s=four_s, peer_s=peer_s, peer_bytes=peer_bytes,
                peer_how=how, striping=striping,
                peer_restore_s=mirror_b.peer_install_seconds,
                fetch_log=[f[:3] for f in fetches],
                steady_s=steady_s, steady_claims_per_s=steady_rate,
                steady_vs_bare=steady_rate / bare_rate,
                batches_per_node=per_node, kill_at_s=kill_at,
                kill_sweep_s=kill_s, requeued=sum(a > 0 for a in attempts),
                stats={k: st[k] for k in ("builder_calls",
                                          "cold_invocations",
                                          "warm_invocations",
                                          "peer_installs", "striping")},
                phase_s=phase_s, launches=launches)


# -------------------------------------------------------- 5d. frontdoor ----
# the open-loop arrivals of the front-door phase (about 80 sessions of one
# turn each), the tenants' shares of them, each tenant's new tokens, and
# the over-budget tenant's quota: its refill over the 4 s of arrivals is 4
# tokens, far below one turn's cost (about 40-70), so which of its turns
# shed does not hang on when the host thread wakes for an arrival, and the
# simulator, on modeled time, must shed the same ones
FD_ARRIVALS = dict(rate=20.0, duration=4.0, seed=0)
FD_TENANTS = ("verify", "chat", "cheap")
FD_SHARES = (0.45, 0.35, 0.20)
FD_NEW = {"verify": 8, "chat": 32, "cheap": 8}
FD_CHEAP_QUOTA = dict(tokens_per_second=1.0, burst_tokens=240.0)
FD_PREFIX = "fact-verify"
FD_BURST = 16


def frontdoor_context(cfg, checkpoint):
    """The front-door phase's context, built once per worker: SmolLM2-1.7B
    read from the runtime phase's checkpoint onto the card, behind the
    paged pool with prefix sharing at phase 4 (d)'s knobs."""
    dev = torch.device("cuda")
    model = build_model(cfg, device=dev,
                        params=serve_cli.load_params(checkpoint, cfg, dev))
    return {"engine": InferenceEngine(model, device=dev, **PAGED_KW)}


def engine_compiles():
    """A task: the kernel builds of the worker's engine."""
    return load_context("engine").stats.compiles


class WaveLog:
    """While open, records on each engine it wraps every request that is
    submitted and every ``step()``, in order, so that a bare engine fed the
    same submissions between the same steps forms the same prefill waves
    and decode megasteps (``replay``)."""

    def __init__(self, engines):
        self.engines = list(engines)
        self.events = []
        for eng in self.engines:
            self._wrap(eng)

    def _wrap(self, eng):
        submit, step, key = eng.submit, eng.step, id(eng)

        def logged_submit(req):
            out = submit(req)
            self.events.append((key, req))
            return out

        def logged_step():
            self.events.append((key, None))
            return step()

        eng.submit, eng.step = logged_submit, logged_step

    def close(self):
        for eng in self.engines:
            del eng.submit, eng.step

    def served(self):
        """The engines that stepped, in the order they first did."""
        ids = list(dict.fromkeys(k for k, r in self.events if r is None))
        return [next(e for e in self.engines if id(e) == k) for k in ids]

    def replay(self, bare, eng) -> dict:
        """Feed ``eng``'s submissions and steps to ``bare``; returns each
        recorded request id's tokens from the replay."""
        out = {}
        for key, req in self.events:
            if key != id(eng):
                continue
            if req is None:
                bare.step()
            else:
                out[req.request_id] = bare.submit(Request(
                    prompt=list(req.prompt),
                    max_new_tokens=req.max_new_tokens,
                    temperature=req.temperature,
                    stop_tokens=tuple(req.stop_tokens),
                    priority=req.priority))
        if bare.has_work():
            raise AssertionError("frontdoor: the replay left work behind")
        return {k: r.generated for k, r in out.items()}


def fd_turns(fewshot, longs, facts):
    """Step 2's turn sequence: (arrival s, tenant, session id, prompt).
    verify sends mix (d)'s claims past the burst's, chat mix (b)'s long
    prompts, cheap mix (a)'s fact-verification prompts."""
    arrivals = traces.poisson_sessions(**FD_ARRIVALS)
    who = np.random.RandomState(5).choice(len(FD_TENANTS),
                                          size=len(arrivals), p=FD_SHARES)
    pools = {"verify": fewshot[FD_BURST:], "chat": longs, "cheap": facts}
    seen = {t: 0 for t in FD_TENANTS}
    turns = []
    for i, (t, k) in enumerate(zip(arrivals, who)):
        tenant = FD_TENANTS[k]
        pool = pools[tenant]
        turns.append((t, tenant, f"{tenant}-{i}",
                      pool[seen[tenant] % len(pool)]))
        seen[tenant] += 1
    return turns


def fd_submit(client, ctx, tenant, session_id, prompt):
    """One turn of step 2 (live or in its simulator replay) through an
    ephemeral session of its tenant: chat INTERACTIVE, the others BATCH,
    verify under the template's prefix key. Returns (lane, the stream or
    the ShedError)."""
    slo = SLOClass.INTERACTIVE if tenant == "chat" else SLOClass.BATCH
    sess = client.session(ctx, tenant=tenant, slo=slo, session_id=session_id,
                          prefix_key=FD_PREFIX if tenant == "verify"
                          else None)
    try:
        return sess.lane, sess.submit(prompt, max_new_tokens=FD_NEW[tenant])
    except ShedError as e:
        return sess.lane, e
    finally:
        sess.close()


def ttft_by_class(streams):
    """TTFT p50 and p99 (seconds, on the front door's clock) and the
    sample count of each SLO class over (tenant, stream) pairs."""
    out = {}
    for c in ("interactive", "batch"):
        xs = [s.ttft_seconds for tn, s in streams
              if (tn == "chat") == (c == "interactive")]
        out[c] = dict(n=len(xs),
                      p50_s=float(np.percentile(xs, 50)) if xs else None,
                      p99_s=float(np.percentile(xs, 99)) if xs else None)
    return out


def phase_frontdoor(handoff) -> dict:
    """Full-width SmolLM2-1.7B sessions through the front door
    (``repro_torch.serving.frontdoor``) over a 2-worker in-process
    PCMManager whose workers build the paged sharing engine from the
    runtime phase's checkpoint, with two lanes: (1) a burst of 16 mix (d)
    turns on one session under the template's prefix key, whose streams
    must equal a bare engine replaying the waves the pump formed; (2)
    open-loop sessions of three tenants (Poisson arrivals), each turn
    completed with the replay's tokens or shed with a reason, with TTFT by
    SLO class, streamed tokens/s and prefix reuse, no builder call and no
    kernel build after warm-up; (3) three chat turns with the pump's
    worker preempted mid-stream and the context back from the pool on a
    replacement, every stream the replay's tokens; (4) step 2's turns
    through a FrontDoor over the SimulatorBackend, whose lanes, admissions,
    sheds and fetch sources must be the live run's. Steps 1-3 each run
    with the launch counts set to 0 and must launch what their waves and
    decode steps call for."""
    cfg, ckdir = handoff["cfg"], handoff["ckdir"]
    tok = HashTokenizer(cfg.vocab_size)
    fewshot = fewshot_prompts(tok)
    longs = long_prompts(cfg.vocab_size)
    turns = fd_turns(fewshot, longs, fact_prompts(cfg.vocab_size))
    shape = types.SimpleNamespace(
        cfg=cfg, stats=types.SimpleNamespace(decode_path="paged"))
    quotas = {"cheap": TenantQuota(**FD_CHEAP_QUOTA)}
    t_phase = time.monotonic()
    # the bare engine that replays the pumps' waves: the checkpoint's
    # weights are the seeded init's (the runtime phase wrote them)
    bare = InferenceEngine(build_model(cfg, device="cuda", seed=0),
                           device="cuda", **PAGED_KW)
    recipe = make_recipe("smollm2-1.7b.frontdoor", frontdoor_context,
                         (cfg, ckdir))
    out = {"launches": {}}
    mgr = PCMManager(mode=ContextMode.FULL, n_workers=2)
    try:
        client = PCMClient(backend=mgr)
        ctx = client.context(recipe)
        t0 = time.monotonic()
        ctx.warm_up()
        out["warm_up_s"] = time.monotonic() - t0
        fd = client.frontdoor(lanes=2, quotas=quotas)
        engines = [w.library.context(recipe.key()).value["engine"]
                   for w in mgr.workers.values()]
        if any(e.prefix_fallback is not None for e in engines):
            raise AssertionError("frontdoor: prefix sharing is off")
        calls0 = mgr.stats()["builder_calls"]
        compiles0 = [e.stats.compiles for e in engines]

        def path(label, fn):
            """Drive one step with the counts at 0 and the waves recorded
            on both engines; its launches must match its waves and steps."""
            waves_log = WaveLog(engines)
            st0 = [e.stats.as_dict() for e in engines]
            ops.reset_launches()
            try:
                res = fn()
                mgr.run_until_idle(timeout=300)
            finally:
                waves_log.close()
            launches = dict(ops.LAUNCHES)
            waves = sum(e.stats.prefill_batches - s["prefill_batches"]
                        for e, s in zip(engines, st0))
            steps = sum(e.stats.decode_steps - s["decode_steps"]
                        for e, s in zip(engines, st0))
            expect, must = expected_launches(shape, waves, steps)
            log(f"[frontdoor] {label}: {waves} prefill waves, {steps} "
                f"decode steps; launches {launches}; expected {expect}")
            if launches != expect or any(launches[k] <= 0 for k in must):
                raise AssertionError(f"frontdoor {label}: kernel launch "
                                     f"counts do not match the path")
            out["launches"][label] = launches
            return res, waves_log

        def held(label, streams, want):
            got = [s.result(timeout=300) for s in streams]
            same = got == [want[s.request.request_id] for s in streams]
            log(f"[frontdoor] {label}: streams equal the bare engine's "
                f"replay of the pumps' waves: {same}")
            if not same:
                raise AssertionError(f"frontdoor {label}: streamed tokens "
                                     f"differ from the replay")
            return got

        # 1. parity burst: one session, one lane, one pump
        burst = fewshot[:FD_BURST]

        def run_burst():
            with client.session(ctx, tenant="verify", session_id="burst",
                                prefix_key=FD_PREFIX) as sess:
                streams = [sess.submit(p, max_new_tokens=FD_NEW["verify"])
                           for p in burst]
            for s in streams:
                s.result(timeout=300)
            return streams

        burst_streams, log1 = path("burst", run_burst)
        first, = log1.served()
        burst_tokens = held("(1) burst", burst_streams,
                            log1.replay(bare, first))

        # 2. open-loop sessions of three tenants
        st0 = fd.stats()
        live_lanes, sheds = {}, []

        def run_open_loop():
            streams, lag = [], 0.0
            t_start = time.monotonic()
            for t, tenant, sid, prompt in turns:
                delay = t_start + t - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                lag = max(lag, time.monotonic() - t_start - t)
                lane, res = fd_submit(client, ctx, tenant, sid, prompt)
                live_lanes[sid] = lane
                if isinstance(res, ShedError):
                    sheds.append((sid, res.tenant, res.reason,
                                  res.retry_after_seconds))
                else:
                    streams.append((tenant, res))
            for _, s in streams:
                s.result(timeout=300)
            return streams, lag, time.monotonic() - t_start

        (streams2, lag, wall2), log2 = path("open_loop", run_open_loop)
        st = fd.stats()
        adm, adm0 = st["admission"], st0["admission"]
        admitted = adm["admitted"] - adm0["admitted"]
        shed = {k: v - adm0["shed"].get(k, 0) for k, v in adm["shed"].items()}
        shed_by_tenant = {k: v - adm0["shed_by_tenant"].get(k, 0)
                          for k, v in adm["shed_by_tenant"].items()}
        ntok = sum(s.token_count for _, s in streams2)
        span = max(s.finished_at for _, s in streams2) - \
            min(s.created_at for _, s in streams2)
        prefix = {k: st["prefix"][k] - st0["prefix"][k] for k in st["prefix"]}
        builder_calls = mgr.stats()["builder_calls"] - calls0
        compiles = [e.stats.compiles - c for e, c in zip(engines, compiles0)]
        live_sources = sorted({d.source.name for d in mgr.fetch_history()})
        step2 = dict(arrivals=len(turns), completed=len(streams2),
                     admitted=admitted, shed=shed,
                     shed_by_tenant=shed_by_tenant,
                     shed_rate=len(sheds) / len(turns),
                     ttft=ttft_by_class(streams2), streamed_tokens=ntok,
                     streamed_tok_per_s=ntok / span, span_s=span,
                     wall_s=wall2, max_arrival_lag_s=lag, prefix=prefix,
                     pumps_submitted=st["router"]["pumps_submitted"] -
                     st0["router"]["pumps_submitted"],
                     pump_errors=st["router"]["pump_errors"],
                     builder_calls_after_warm_up=builder_calls,
                     compiles_after_warm_up=compiles,
                     fetch_sources=live_sources)
        log(f"[frontdoor] (2) open loop: {json.dumps(step2)}")
        # the bare engine replays each engine's waves: the burst's engine
        # first (its prefix cache carries on from step 1), then the other
        # from an empty cache, as that engine started
        want2 = {}
        for eng in sorted(log2.served(), key=lambda e: e is not first):
            if eng is not first:
                bare.drop_prefix_cache()
            want2.update(log2.replay(bare, eng))
        held("(2) open loop", [s for _, s in streams2], want2)
        if len(streams2) + len(sheds) != len(turns) or \
                len(streams2) != admitted or set(shed) != {"rate_limit"} \
                or st["router"]["pump_errors"] or builder_calls or \
                any(compiles) or prefix["hits"] <= 0:
            raise AssertionError("frontdoor (2): a turn was lost, the quota "
                                 "did not shed, a pump failed, the context "
                                 "was rebuilt or no prefix was reused")
        out["open_loop"] = step2

        # 3. preemption mid-stream on one worker, the shape of the
        # reference's test_stream_survives_worker_preemption: the other
        # worker retires first (a second warm worker would take the
        # requeued pump with no fetch); the engines' prefix caches are
        # dropped while idle, so the bare engine replays each from empty
        for e in engines:
            e.drop_prefix_cache()
        other = sorted(mgr.workers)[1]
        retiring = mgr.workers[other]
        mgr.preempt_worker(other)
        retiring.join(300)
        victim_id = next(iter(mgr.workers))
        compiles3 = client.submit(engine_compiles,
                                  context=ctx).result(timeout=300)
        calls3 = mgr.stats()["builder_calls"]
        t3 = {}

        def run_preempt():
            with client.session(ctx, tenant="chat", session_id="chat-durable",
                                slo=SLOClass.INTERACTIVE) as sess:
                streams = [sess.submit(p, max_new_tokens=FD_NEW["chat"])
                           for p in longs[:3]]
            # mid-stream: the first turn's first tokens are out (its prefill
            # wave), its decode is not done
            deadline = time.monotonic() + 300
            while streams[0].token_count == 0:
                if time.monotonic() > deadline:
                    raise AssertionError("frontdoor (3): no token streamed")
                time.sleep(0.001)
            victim = mgr.workers[victim_id]
            t3["tokens_at_preemption"] = [s.token_count for s in streams]
            t0 = time.monotonic()
            mgr.preempt_worker(victim_id)
            victim.join(300)                 # retired: demoted to the pool
            t3["retire_s"] = time.monotonic() - t0
            if mgr.snapshots.tier(recipe.key()) is None:
                raise AssertionError("frontdoor (3): no snapshot in the pool")
            t3["replacement"] = mgr.add_worker()
            for s in streams:
                s.result(timeout=300)
            return streams

        streams3, log3 = path("preempt", run_preempt)
        want3 = {}
        for eng in log3.served():
            bare.drop_prefix_cache()
            want3.update(log3.replay(bare, eng))
        held("(3) preemption", streams3, want3)
        fetches = [(d.worker_id, d.source.name, d.donor)
                   for d in mgr.fetch_history(recipe)]
        back = [f for f in fetches if f[0] == t3["replacement"]]
        compiles_after = client.submit(engine_compiles,
                                       context=ctx).result(timeout=300)
        new_calls = mgr.stats()["builder_calls"] - calls3
        step3 = dict(t3, fetch_log=fetches,
                     attempts=[s.attempts for s in streams3],
                     builder_calls=new_calls, compiles_before=compiles3,
                     compiles_after=compiles_after)
        log(f"[frontdoor] (3) preemption: {json.dumps(step3)}")
        if not back or back[0][1] not in ("POOL", "DISK") or new_calls or \
                compiles_after != compiles3:
            raise AssertionError("frontdoor (3): the context did not come "
                                 "back from the pool, or was rebuilt")
        out["preempt"] = step3
    finally:
        mgr.shutdown()

    # a plain generate of the burst from an empty cache, for the record:
    # where it differs, a finding about wave composition, not a failure
    bare.drop_prefix_cache()
    plain = bare.generate(burst, max_new_tokens=FD_NEW["verify"])
    out["burst_equals_plain_generate"] = plain == burst_tokens
    log(f"[frontdoor] (1) burst tokens equal a plain generate of the 16 "
        f"prompts: {plain == burst_tokens} "
        f"({sum(a == b for a, b in zip(plain, burst_tokens))}/16 turns)")
    free(bare, *engines)
    del bare, engines, mgr, client, ctx
    gc.collect()
    torch.cuda.empty_cache()

    # 4. step 2's turns through the simulator, on modeled time
    sim = SimulatorBackend(n_workers=2, profile="h100")
    sclient = PCMClient(backend=sim)
    sctx = sclient.context(recipe)
    sctx.warm_up()
    sfd = sclient.frontdoor(lanes=2, quotas=quotas)
    sim_lanes, sim_sheds, sim_streams = {}, [], []
    for t, tenant, sid, prompt in turns:
        sim.loop.run(until=t)
        lane, res = fd_submit(sclient, sctx, tenant, sid, prompt)
        sim_lanes[sid] = lane
        if isinstance(res, ShedError):
            sim_sheds.append(sid)
        else:
            sim_streams.append((tenant, res))
    for _, s in sim_streams:
        s.result(timeout=60)
    sadm = sfd.stats()["admission"]
    sim_sources = sorted({d.source.name for d in sim.fetch_history()})
    step4 = dict(lanes_equal=sim_lanes == live_lanes,
                 admitted=sadm["admitted"], shed=sadm["shed"],
                 shed_by_tenant=sadm["shed_by_tenant"],
                 same_turns_shed=sim_sheds == [s[0] for s in sheds],
                 fetch_sources=sim_sources,
                 modeled=dict(end_s=max(s.sim_result.finished_at
                                        for _, s in sim_streams),
                              ttft=ttft_by_class(sim_streams)))
    log(f"[frontdoor] (4) simulator replay: lanes equal "
        f"{step4['lanes_equal']}; admitted {sadm['admitted']} (live "
        f"{admitted}), shed {sadm['shed']} (live {shed}); the same turns "
        f"shed {step4['same_turns_shed']}; fetch sources {sim_sources} "
        f"(live {live_sources}); modeled seconds, not measured: "
        f"{json.dumps(step4['modeled'])}")
    if not step4["lanes_equal"] or sadm["admitted"] != admitted or \
            sadm["shed"] != shed or sadm["shed_by_tenant"] != \
            shed_by_tenant or not step4["same_turns_shed"] or \
            sim_sources != live_sources:
        raise AssertionError("frontdoor (4): the simulator's decisions "
                             "differ from the live run's")
    out["simulator"] = step4
    out["phase_s"] = time.monotonic() - t_phase
    log(f"[frontdoor] phase {out['phase_s']:.1f} s")
    return out


# ------------------------------------------------------------ 5e. train ----
# the fact task of data/pipeline.py: 16 rows of 128 tokens a step, two
# microbatches of 8, cross-entropy in chunks of 64
TRAIN_DATA = dict(batch_size=16, seq_len=128, task="fact")
TRAIN_LOOP = dict(accum_steps=2, ce_chunk=64)
# the reference's OptimizerConfig defaults (peak 3e-4 after 100 warmup
# steps): its first 6 steps run at 3e-6 to 1.8e-5. Without the warmup
# (1e-4 or 3e-4 from step 1) AdamW's first sign-like steps are coherent
# across each 2 048-wide matrix, and the loss spiked after step 2 (on
# one H100)
TRAIN_OPT = dict()
TRAIN_STEPS = 6
# the card's f32 steps against the CPU's (reduced SmolLM2, three steps),
# max-abs: losses 1e-5; parameters 1e-5 for all but 2 in 1 000 elements,
# and those within 2 x steps x lr (tests/test_torch_train.py says why:
# AdamW's eps turns last-bit gradient differences into lr-sized moves on
# elements whose gradient is near 1e-8)
TRAIN_LOSS_TOL = 1e-5
TRAIN_PARAM_TOL = 1e-5
TRAIN_OUTLIER_SHARE = 2e-3
# a resumed run's losses against an uninterrupted run's, bf16 at full
# width: the checkpoint holds the bf16 parameters and the f32 moments
# exactly, so the two runs differ only where the card's reductions are not
# deterministic
RESUME_LOSS_TOL = 1e-3


def fact_data(cfg, **overrides):
    pcfg = PipelineConfig(**{**TRAIN_DATA, "vocab_size": cfg.vocab_size,
                             **overrides})
    return lambda s: batches(pcfg, s)


def params_gap(a, b):
    """(elements further apart than TRAIN_PARAM_TOL, all elements, the
    largest gap) between two state dicts of equal keys."""
    over = n = 0
    worst = 0.0
    for k in a:
        d = (a[k].detach().float().cpu() - b[k].detach().float().cpu()).abs()
        over += int((d >= TRAIN_PARAM_TOL).sum())
        n += d.numel()
        worst = max(worst, float(d.max()))
    return over, n, worst


def profile_step(model, out, cfg) -> dict:
    """One more train step of step 1's model under torch.profiler (the
    device alone), on the batch after the last; the weights are put back
    afterwards, so the verifier served is the TRAIN_STEPS-step one.
    Returns the step's wall time, the device's busy time and share, and
    the heaviest kernels."""
    from torch.profiler import ProfilerActivity, profile
    named, opt_state = out["params"], out["opt"]
    keep = {n: p.detach().clone() for n, p in named.items()}
    step_fn = make_train_step(model, OptimizerConfig(**TRAIN_OPT),
                              **TRAIN_LOOP)
    batch = to_device(next(fact_data(cfg)(TRAIN_STEPS)), torch.device(
        "cuda"))
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        _, _, m = step_fn(named, opt_state, batch)
        float(m["loss"])
        wall = time.monotonic() - t0
    with torch.no_grad():
        for n, p in named.items():
            p.copy_(keep[n])
    kernels = sorted(((e.self_device_time_total, e.key, e.count)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0), reverse=True)
    busy = sum(k[0] for k in kernels) / 1e6
    res = dict(wall_s=wall, device_busy_s=busy, busy_share=busy / wall,
               kernel_launches=sum(k[2] for k in kernels),
               top=[dict(kernel=k[1][:80], ms=k[0] / 1e3, calls=k[2])
                    for k in kernels[:8]])
    log(f"[train] (1) profiled step {TRAIN_STEPS + 1}: {json.dumps(res)}")
    return res


def train_full_width(cfg) -> tuple:
    """Step 1: full-width, full-depth SmolLM2-1.7B trained TRAIN_STEPS
    steps on the fact task, no checkpoint; then one step profiled."""
    model = build_model(cfg, device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    sync()
    torch.cuda.reset_peak_memory_stats()
    out = train(model, fact_data(cfg), OptimizerConfig(**TRAIN_OPT),
                LoopConfig(total_steps=TRAIN_STEPS, log_every=1,
                           **TRAIN_LOOP),
                log_fn=lambda m: log(f"[train] (1) {m}"))
    peak = torch.cuda.max_memory_allocated()
    losses = [r.loss for r in out["records"]]
    step_s = float(np.median([r.seconds for r in out["records"][1:]]))
    tokens = TRAIN_DATA["batch_size"] * TRAIN_DATA["seq_len"]
    flops_6nd = 6 * cfg.param_count() * tokens
    res = dict(params=n_params, param_count=cfg.param_count(),
               losses=losses, step_s=[r.seconds for r in out["records"]],
               median_step_s=step_s, tokens_per_step=tokens,
               tokens_per_s=tokens / step_s, peak_mem_gb=peak / 1e9,
               tflop_6nd_per_step=flops_6nd / 1e12,
               share_of_bf16_peak_6nd=flops_6nd / step_s / BF16_FLOPS)
    log(f"[train] (1) smollm2-1.7b full width, {cfg.n_layers} layers, "
        f"{n_params} params bf16, f32 moments, remat {cfg.remat}, batch "
        f"{TRAIN_DATA['batch_size']} x {TRAIN_DATA['seq_len']}, accum "
        f"{TRAIN_LOOP['accum_steps']}, CE chunk {TRAIN_LOOP['ce_chunk']}: "
        f"losses {[round(x, 4) for x in losses]}; median step (2-"
        f"{TRAIN_STEPS}) {step_s * 1e3:.1f} ms, {tokens / step_s:.0f} "
        f"tokens/s, peak memory {peak / 1e9:.2f} GB, 6ND "
        f"{flops_6nd / 1e12:.1f} TFLOP a step = "
        f"{100 * res['share_of_bf16_peak_6nd']:.1f} % of the 989 TFLOP/s "
        f"bf16 peak (a reading, not a limit)")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train (1): losses {losses} are not finite "
                             f"and falling")
    res["profile"] = profile_step(model, out, cfg)
    trained = {n: p.detach() for n, p in out["params"].items()}
    return trained, res


def train_card_vs_cpu() -> dict:
    """Step 2: the reduced SmolLM2 in f32, three steps from the same
    seeded weights and batches on the card and on the CPU."""
    cfg = get_reduced_config("smollm2-1.7b")
    init = init_params(cfg, torch.Generator().manual_seed(0),
                       torch.device("cpu"))
    ocfg = OptimizerConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    data = fact_data(cfg, batch_size=8, seq_len=32)(0)
    batches_ = [next(data) for _ in range(3)]
    runs = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, device=dev, params={
            k: v.clone() for k, v in init.items()})
        named = trainable(model)
        st = init_state(named)
        step = make_train_step(model, ocfg, accum_steps=2, ce_chunk=16)
        losses = []
        for b in batches_:
            named, st, m = step(named, st, to_device(b, torch.device(dev)))
            losses.append(float(m["loss"]))
        runs[dev] = (losses, named)
    loss_gap = max(abs(a - b) for a, b in zip(runs["cuda"][0],
                                               runs["cpu"][0]))
    over, n, worst = params_gap(runs["cuda"][1], runs["cpu"][1])
    res = dict(losses_cuda=runs["cuda"][0], losses_cpu=runs["cpu"][0],
               loss_gap=loss_gap, params_over_tol=over, params=n,
               params_max_gap=worst)
    log(f"[train] (2) reduced smollm2 f32, card vs CPU, 3 steps: "
        f"{json.dumps(res)} (losses within {TRAIN_LOSS_TOL}; parameters "
        f"within {TRAIN_PARAM_TOL} but {TRAIN_OUTLIER_SHARE} of them, "
        f"those within {2 * 3 * ocfg.peak_lr})")
    if loss_gap >= TRAIN_LOSS_TOL or over > TRAIN_OUTLIER_SHARE * n or \
            worst >= 2 * 3 * ocfg.peak_lr:
        raise AssertionError("train (2): the card's steps differ from the "
                             "CPU's")
    return res


def train_resume(cfg) -> dict:
    """Step 3: full width at depth 2, four steps with checkpoint_every 3,
    which saves at 3 and 4, then train(total_steps=6) in the same
    directory, which must resume at step 5 and give an uninterrupted
    6-step run's losses. The resumed run saves every 4 steps, so only its
    final save (6) writes: at 3 it would save 6 twice (the reference's
    double save), 13 s more."""
    dcfg = dataclasses.replace(cfg, n_layers=2)
    ocfg = OptimizerConfig(**TRAIN_OPT)
    with tempfile.TemporaryDirectory(prefix="train_resume_") as d:
        def run(total, ckdir, every, logs=None):
            return train(build_model(dcfg, device="cuda", seed=0),
                         fact_data(dcfg), ocfg,
                         LoopConfig(total_steps=total, checkpoint_every=every,
                                    log_every=100, **TRAIN_LOOP),
                         checkpoint_dir=ckdir,
                         log_fn=(logs.append if logs is not None
                                 else lambda _: None))
        t0 = time.monotonic()
        first = run(4, d, 3)
        saved = CheckpointManager(d).steps()
        nbytes = sum(f.stat().st_size for f in Path(d).rglob("*.npz"))
        save_s = time.monotonic() - t0
        logs = []
        t0 = time.monotonic()
        resumed = run(6, d, 4, logs)
        resume_s = time.monotonic() - t0
    whole = run(6, None, 3)
    got = [(r.step, r.loss) for r in resumed["records"]]
    want = [(r.step, r.loss) for r in whole["records"][4:]]
    gap = max(abs(a[1] - b[1]) for a, b in zip(got, want))
    res = dict(params=dcfg.param_count(), first_losses=[
        r.loss for r in first["records"]], saved_steps=saved,
        checkpoint_gb=nbytes / len(saved) / 1e9, resume_log=logs,
        resumed=got,
        uninterrupted=want, loss_gap=gap, first_run_s=save_s,
        resumed_run_s=resume_s)
    log(f"[train] (3) resume at full width, depth 2: {json.dumps(res)} "
        f"(losses within {RESUME_LOSS_TOL})")
    if saved != [3, 4] or logs != ["[loop] resumed from step 4"] or \
            [s for s, _ in got] != [5, 6] or gap > RESUME_LOSS_TOL:
        raise AssertionError("train (3): the resumed run is not the "
                             "uninterrupted one")
    return res


def train_serve(cfg, trained) -> dict:
    """Step 4: the verifier of step 1 served through the kernels against
    the plain path: mix (a) on the slot cache, one token each."""
    kcfg = dataclasses.replace(cfg, use_kernels=True, remat="none")
    kern = InferenceEngine(build_model(kcfg, device="cuda", params=trained),
                           device="cuda", **ENGINE_KW)
    plain = InferenceEngine(build_model(dataclasses.replace(
        kcfg, use_kernels=False), device="cuda", params=trained),
        device="cuda", **ENGINE_KW)
    facts = fact_prompts(cfg.vocab_size)
    kern.generate([[2, 5]], max_new_tokens=1)
    st0 = dict(kern.stats.as_dict())
    ops.reset_launches()
    kreqs, rates = serve(kern, facts, 1, "(4) trained verifier, kernels")
    # the counts read just after the path, before anything else launches
    launches = dict(ops.LAUNCHES)
    waves = kern.stats.as_dict()["prefill_batches"] - st0["prefill_batches"]
    preqs, _ = serve(plain, facts, 1, "(4) trained verifier, plain")
    expect = {k: 0 for k in launches}
    expect["flash_attention"] = cfg.n_layers * waves
    # phase 4's comparison: the logits within LOGIT_TOL, the tokens equal
    # wherever the plain logits' top-2 margin exceeds it. The trained
    # verifier's label logits nearly tie on some claims, and there the
    # kernel's bf16 rounding may pick the other label (on one H100: gap
    # 0.084, 2 of 256 first tokens differ, none past the margin)
    cmp = compare_dense("(4) trained verifier", kreqs, preqs,
                        cfg.vocab_size, LOGIT_TOL, phase="train")
    golds = [LABEL_TOKENS[c.label] for c in fever.claim_batch(range(64))]
    acc = {}
    for t, template in enumerate(fever.PROMPT_CANDIDATES):
        got = [r.generated[0] for r in kreqs[64 * t:64 * (t + 1)]]
        acc[t] = sum(g == y for g, y in zip(got, golds)) / 64
        log(f"[train] (4) prompt[{t}] acc={acc[t]:.3f}  "
            f"({template[:48]!r}...)")
    q = torch.zeros((1, 16, 2, 64), device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    before = dict(ops.LAUNCHES)
    try:
        ops.flash_attention(q, q.detach(), q.detach(), scale=0.125)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    res = dict(requests=len(kreqs), waves=waves, launches=launches,
               expected=expect, compare=cmp, accuracy=acc, rates=rates,
               grad_refusal=refused)
    log(f"[train] (4) launches {launches}, expected {expect}; a "
        f"grad-requiring flash_attention call: "
        f"{'raised: ' + refused if refused else 'ran'}")
    free(kern, plain)
    if cmp["failures"]:
        raise AssertionError(f"train (4): {cmp['failures']}")
    if launches != expect or waves <= 0:
        raise AssertionError("train (4): kernel launch counts do not match "
                             "the path")
    if refused is None or "flash_attention" not in refused or \
            ops.LAUNCHES != before:
        raise AssertionError("train (4): a kernel ran on an input that "
                             "requires a gradient")
    return res


def phase_train() -> dict:
    """The port's training path on the card (``repro_torch.train``): (1)
    full-width SmolLM2-1.7B trained on the fact task; (2) the reduced
    model's f32 steps on the card against the CPU's; (3) a checkpointed
    run at full width and depth 2 resumed in its directory against an
    uninterrupted one; (4) step 1's verifier served through the kernels
    against the plain path, with the launch counts set to 0 and checked,
    and a kernel call on a grad-requiring input refused."""
    t_phase = time.monotonic()
    cfg = dataclasses.replace(get_config("smollm2-1.7b"), remat="block")
    trained, full = train_full_width(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    out = {"full": full, "card_vs_cpu": train_card_vs_cpu(),
           "resume": train_resume(cfg)}
    out["serve"] = train_serve(cfg, trained)
    out["launches"] = {"serve": out["serve"]["launches"]}
    del trained
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.monotonic() - t_phase
    log(f"[train] phase {out['phase_s']:.1f} s")
    return out


# --------------------------------------------------------- 6. deepseek ----
class RouteLog:
    """Records every MoE routing decision while active: for each call of
    ``route`` (one per MoE layer per wave or decode step; ``ep_route``, the
    expert-parallel path's, with ``name="ep_route"``), each token's chosen
    experts in ascending order, on the device."""

    def __init__(self, name: str = "route"):
        self.calls = []
        self.name = name
        self._route = getattr(moe_lib, name)

    def __enter__(self):
        def logged(*args):
            out = self._route(*args)
            self.calls.append(out[0].sort(dim=1).values)
            return out
        setattr(moe_lib, self.name, logged)
        return self

    def __exit__(self, *exc):
        setattr(moe_lib, self.name, self._route)


def compare_routed(label, kern, plain, log_k, log_p, cfg, slots):
    """Kernel engine vs plain engine on one mix, with the routing
    decisions that differed counted: the first-token logits of requests
    whose prefill routed every token alike in both are held to
    DS_LOGIT_TOL, and their greedy first tokens must agree where the
    plain logits' top-2 margin exceeds it; decode steps are compared on
    slots whose input tokens still agree."""
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers
    if [c.shape for c in log_k.calls] != [c.shape for c in log_p.calls]:
        raise AssertionError(f"{label}: the engines routed different "
                             f"batches")
    # group the calls into waves (T = slots x bucket) and decode steps
    # (T = slots), n_moe calls each, in the order the engine ran them
    groups = [(log_k.calls[i:i + n_moe], log_p.calls[i:i + n_moe])
              for i in range(0, len(log_k.calls), n_moe)]
    waves = [g for g in groups if g[0][0].shape[0] != slots]
    steps = [g for g in groups if g[0][0].shape[0] == slots]
    pre_diff = pre_all = dec_diff = dec_all = 0
    routed_alike = []
    for w, (ck, cp) in enumerate(waves):
        diff = torch.stack([(a != b).any(dim=1) for a, b in zip(ck, cp)])
        bucket = diff.shape[1] // slots
        diff = diff.reshape(n_moe, slots, bucket)
        for i, r in enumerate(kern[w * slots:(w + 1) * slots]):
            n = len(r.prompt)
            pre_diff += int(diff[:, i, :n].sum())
            pre_all += n_moe * n
            routed_alike.append(not bool(diff[:, i, :n].any()))
    for j, (ck, cp) in enumerate(steps):
        rows = [rk.slot for rk, rp in zip(kern, plain)
                if rk.generated[:j + 1] == rp.generated[:j + 1]]
        if not rows:
            continue
        rows = torch.tensor(rows, device="cuda")
        for a, b in zip(ck, cp):
            dec_diff += int((a[rows] != b[rows]).any(dim=1).sum())
            dec_all += n_moe * len(rows)
    err, checked, agree = 0.0, 0, 0
    for rk, rp, alike in zip(kern, plain, routed_alike):
        if not alike:
            continue
        lk, lp = rk.first_logits[:cfg.vocab_size], rp.first_logits[
            :cfg.vocab_size]
        err = max(err, float((lk - lp).abs().max()))
        top2 = torch.topk(lp, 2).values
        if float(top2[0] - top2[1]) > DS_LOGIT_TOL:
            checked += 1
            agree += int(rk.generated[0] == rp.generated[0])
    gap_all = max(float((rk.first_logits - rp.first_logits).abs().max())
                  for rk, rp in zip(kern, plain))
    same_first = sum(rk.generated[0] == rp.generated[0]
                     for rk, rp in zip(kern, plain))
    same_seq = sum(rk.generated == rp.generated for rk, rp in zip(kern,
                                                                   plain))
    failures = []
    if err > DS_LOGIT_TOL:
        failures.append(f"logits error {err} > {DS_LOGIT_TOL}")
    if agree != checked:
        failures.append("first tokens disagree")
    for phase, n_diff, n_all, bound in (
            ("prefill", pre_diff, pre_all, PREFILL_ROUTE_DIFF_MAX),
            ("decode", dec_diff, dec_all, DECODE_ROUTE_DIFF_MAX)):
        if n_diff > bound * max(n_all, 1):
            failures.append(f"{phase} routing differs in {n_diff}/{n_all} "
                            f"decisions, above {bound}")
    out = dict(requests=len(kern), routed_alike=sum(routed_alike),
               prefill_route_diff=pre_diff, prefill_route_decisions=pre_all,
               prefill_route_share=pre_diff / max(pre_all, 1),
               decode_route_diff=dec_diff, decode_route_decisions=dec_all,
               decode_route_share=dec_diff / max(dec_all, 1),
               logits_err_routed_alike=err, logits_gap_all=gap_all,
               first_tokens_checked=checked, first_tokens_agree=agree,
               first_tokens_equal=same_first, identical_sequences=same_seq,
               failures=failures)
    log(f"[deepseek] {label} kernels vs plain: {json.dumps(out)} (logits "
        f"tol {DS_LOGIT_TOL} on requests routed alike; routing-difference "
        f"bounds {PREFILL_ROUTE_DIFF_MAX} prefill, {DECODE_ROUTE_DIFF_MAX} "
        f"decode)")
    return out


def phase_deepseek() -> dict:
    """Full-width DeepSeek-V2-Lite-16B on the paged pool: (e) and (f) with
    the kernels, each path's launches checked, against a use_kernels=False
    engine over the same weights."""
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                              use_kernels=True)
    sync()
    t0 = time.monotonic()
    model = build_model(cfg, device="cuda", seed=0)
    sync()
    init_s = time.monotonic() - t0
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    plain_model = build_model(dataclasses.replace(cfg, use_kernels=False),
                              device="cuda", params=dict(model.state_dict()))
    eng = InferenceEngine(model, device="cuda", **PAGED_KW)
    log(f"[deepseek] deepseek-v2-lite-16b full width: {cfg.n_layers} layers "
        f"({cfg.moe.first_dense_layers} dense, d_ff {cfg.moe.dense_d_ff}), "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads, MLA latent "
        f"{cfg.mla.kv_lora_rank} + rope {cfg.mla.qk_rope_head_dim}, "
        f"{cfg.moe.n_experts} experts top-{cfg.moe.experts_per_token} of "
        f"d_ff {cfg.moe.d_ff} + {cfg.moe.n_shared_experts} shared; "
        f"{n_params} params, {weight_bytes / 1e9:.3f} GB bf16, drawn on the "
        f"card in {init_s:.2f} s; pool "
        f"{eng.snapshot()['capacity_bytes'] / 1e9:.3f} GB; engine {PAGED_KW}")
    if n_params != DS_PARAMS:
        raise AssertionError(f"deepseek: {n_params} parameters, expected "
                             f"{DS_PARAMS}")
    log(f"[deepseek] prefix_fallback: {eng.prefix_fallback}")
    if eng.prefix_fallback is None or "MoE" not in eng.prefix_fallback \
            or "MLA" not in eng.prefix_fallback:
        raise AssertionError("deepseek: prefix sharing did not resolve off "
                             "naming MoE and MLA")
    facts = fact_prompts(cfg.vocab_size)
    longs = long_prompts(cfg.vocab_size)
    eng.generate([[2, 5]], max_new_tokens=2)
    out = {"params": n_params, "weight_bytes": weight_bytes,
           "init_s": init_s, "prefix_fallback": eng.prefix_fallback,
           "launches": {}}

    with RouteLog() as rk_e:
        (ek, rates_e), out["launches"]["e"] = run_path(
            eng, "(e) DeepSeek fact verification",
            lambda: serve(eng, facts, 1, "(e) DeepSeek fact verification"))
    with RouteLog() as rk_f:
        (fk, rates_f), out["launches"]["f"] = run_path(
            eng, "(f) DeepSeek long prompts",
            lambda: serve(eng, longs, 64, "(f) DeepSeek long prompts"))
    plain = InferenceEngine(plain_model, device="cuda", **PAGED_KW)
    plain.generate([[2, 5]], max_new_tokens=2)
    with RouteLog() as rp_e:
        ep, rates_e_plain = serve(plain, facts, 1, "(e) plain path")
    with RouteLog() as rp_f:
        fp, rates_f_plain = serve(plain, longs, 64, "(f) plain path")
    free(plain)
    out.update(rates_e=rates_e, rates_f=rates_f, rates_e_plain=rates_e_plain,
               rates_f_plain=rates_f_plain,
               compare_e=compare_routed("(e)", ek, ep, rk_e, rp_e, cfg,
                                        eng.slots),
               compare_f=compare_routed("(f)", fk, fp, rk_f, rp_f, cfg,
                                        eng.slots))
    del rk_e, rk_f, rp_e, rp_f
    for mix in ("e", "f"):
        if out[f"compare_{mix}"]["failures"]:
            raise AssertionError(f"deepseek ({mix}) kernels vs plain: "
                                 f"{out[f'compare_{mix}']['failures']}")
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["profile_f"] = profile_mix(eng, longs, 64,
                                   "(f) DeepSeek long prompts, kernel engine")
    free(eng)
    return out


def zamba2_f32_check(label, facts, longs) -> dict:
    """Zamba2 at full width in f32, the depth cut to one group and the tail
    (7 layers), the kernel engine against the plain one on 64 of (g)'s
    prompts (four 32-step waves) and (h)'s 16 (one 512-step wave: eight of
    the SSD kernel's tiles), one token each: where bf16 rounding is out of
    the way, the first-token logits agree to the order of f32 sums."""
    cfg = dataclasses.replace(get_config("zamba2-7b"), n_layers=7,
                              param_dtype="float32",
                              compute_dtype="float32", use_kernels=True)
    model = build_model(cfg, device="cuda", seed=1)
    plain = build_model(dataclasses.replace(cfg, use_kernels=False),
                        device="cuda", params=dict(model.state_dict()))
    kw = dict(ENGINE_KW, cache_dtype=torch.float32)
    reqs = {}
    for name, m in (("kernels", model), ("plain", plain)):
        eng = InferenceEngine(m, device="cuda", **kw)
        reqs[name], _ = serve(eng, facts[:64] + longs, 1,
                              f"{label} f32 7 layers, {name}")
        free(eng)
    return compare_dense(f"{label} f32 7 layers", reqs["kernels"],
                         reqs["plain"], cfg.vocab_size, ZAMBA_F32_LOGIT_TOL)


def phase_zamba2() -> dict:
    """Full-width Zamba2-7B (81 Mamba2 layers, the shared attention block
    13 times; seeded random bf16 weights drawn on the card) on the slot
    cache with the kernels: (g) fact verification, 4 templates x 64
    claims, one token each (16 waves of the 32 bucket), and (h) mix (b)'s
    16 long prompts, 64 new tokens each (one 512-bucket wave, then 63
    decode steps), each with the launch counts set to 0, against a
    use_kernels=False engine over the same weights, and the two engines
    again in f32 at 7 layers (``zamba2_f32_check``); torch.profiler over
    (h)'s prompts at 16 new tokens."""
    cfg = dataclasses.replace(get_config("zamba2-7b"), use_kernels=True)
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.monotonic()
    model = build_model(cfg, device="cuda", seed=0)
    sync()
    init_s = time.monotonic() - t0
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    plain_model = build_model(dataclasses.replace(cfg, use_kernels=False),
                              device="cuda", params=dict(model.state_dict()))
    eng = InferenceEngine(model, device="cuda", paged=True, **ENGINE_KW)
    cache = {n: (tuple(t.shape), str(t.dtype)[6:], t.numel()
                 * t.element_size()) for n, t in eng.cache.items()}
    log(f"[zamba2] zamba2-7b full width: {cfg.n_layers} Mamba2 layers (d_in "
        f"{cfg.ssm.expand * cfg.d_model}, {cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim} "
        f"heads of {cfg.ssm.head_dim}, state {cfg.ssm.state_dim}, "
        f"{cfg.ssm.n_groups} groups), the shared block {eng.model.n_groups} "
        f"times ({cfg.n_heads} heads of {cfg.resolved_head_dim}, d_ff "
        f"{cfg.d_ff}); {n_params} params, {weight_bytes / 1e9:.3f} GB bf16, "
        f"drawn on the card in {init_s:.2f} s; cache {json.dumps(cache)}; "
        f"engine {ENGINE_KW}")
    if n_params != ZAMBA_PARAMS:
        raise AssertionError(f"zamba2: {n_params} parameters, expected "
                             f"{ZAMBA_PARAMS}")
    log(f"[zamba2] paged=True resolves to the slot cache: "
        f"{eng.paged_fallback}; prefix_fallback: {eng.prefix_fallback}")
    if eng.stats.decode_path != "full" or eng.paged_fallback is None \
            or "no paged decode" not in eng.paged_fallback:
        raise AssertionError("zamba2: a paged request did not keep the slot "
                             "cache")
    facts = fact_prompts(cfg.vocab_size)
    longs = long_prompts(cfg.vocab_size)
    eng.generate([[2, 5]], max_new_tokens=2)
    out = {"params": n_params, "weight_bytes": weight_bytes,
           "init_s": init_s, "cache": cache,
           "paged_fallback": eng.paged_fallback, "launches": {}}
    (gk, rates_g), out["launches"]["g"] = run_path(
        eng, "(g) Zamba2 fact verification",
        lambda: serve(eng, facts, 1, "(g) Zamba2 fact verification"))
    (hk, rates_h), out["launches"]["h"] = run_path(
        eng, "(h) Zamba2 long prompts",
        lambda: serve(eng, longs, 64, "(h) Zamba2 long prompts"))
    out["stop_flag_h"] = stop_flag_cost(eng, longs, tokens(hk), "(h)")
    plain = InferenceEngine(plain_model, device="cuda", **ENGINE_KW)
    plain.generate([[2, 5]], max_new_tokens=2)
    gp, rates_g_plain = serve(plain, facts, 1, "(g) plain path")
    hp, rates_h_plain = serve(plain, longs, 64, "(h) plain path")
    # the witness: the plain engine with P rounded to bf16 as the kernel
    # rounds it; its first-token logits against the kernel engine's
    saved = attn_lib.blockwise_attention
    attn_lib.blockwise_attention = p_bf16_attention
    try:
        gw, _ = serve(plain, facts, 1, "(g) plain path, P in bf16")
        hw, _ = serve(plain, longs, 1, "(h) plain path, P in bf16")
    finally:
        attn_lib.blockwise_attention = saved
    free(plain)
    out["p_bf16_witness"] = {
        mix: {k: w[k] for k in ("logits_gap", "first_tokens_equal")}
        for mix, w in (("g", compare_dense("(g) P in bf16", gk, gw,
                                           cfg.vocab_size, ZAMBA_LOGIT_TOL)),
                       ("h", compare_dense("(h) P in bf16", hk, hw,
                                           cfg.vocab_size, ZAMBA_LOGIT_TOL)))}
    out.update(rates_g=rates_g, rates_h=rates_h, rates_g_plain=rates_g_plain,
               rates_h_plain=rates_h_plain,
               compare_g=compare_dense("(g)", gk, gp, cfg.vocab_size,
                                       ZAMBA_LOGIT_TOL),
               compare_h=compare_dense("(h)", hk, hp, cfg.vocab_size,
                                       ZAMBA_LOGIT_TOL))
    out["compare_f32"] = zamba2_f32_check("(g)+(h)", facts, longs)
    for mix in ("g", "h", "f32"):
        if out[f"compare_{mix}"]["failures"]:
            raise AssertionError(f"zamba2 ({mix}) kernels vs plain: "
                                 f"{out[f'compare_{mix}']['failures']}")
    # 16 new tokens, not (h)'s 64: at 64 the pass took 270-415 s of trace
    # processing on the H100 hosts, and the run aims to end within half its
    # 1200 s limit
    out["profile_h"] = profile_mix(eng, longs, 16,
                                   "(h) Zamba2 kernels, 16 new tokens")
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    log(f"[zamba2] peak device memory {out['peak_memory_bytes'] / 1e9:.2f} "
        f"GB")
    free(eng)
    return out


# ------------------------------------------------------------ 8. dense ----
DENSE_ARCHS = ("granite-3-2b", "h2o-danube-1.8b", "stablelm-12b",
               "nemotron-4-15b")
# each at full width and a quarter of its depth (40, 24, 40 and 32
# layers): the whole script must end inside its 1200 s on a slow host too
# (a run at full depth took 1247.8 s there, every phase 1.2-1.6x as long
# as on the hosts of earlier runs), and depth only repeats layers whose
# shapes the kernels already see
DENSE_DEPTH = {"granite-3-2b": 10, "h2o-danube-1.8b": 6, "stablelm-12b": 10,
               "nemotron-4-15b": 8}
# H2O-Danube's long mix: 8 prompts of 3 000-6 000 tokens in one wave of
# the 8192 bucket, past its 4096-token window, so the prefill kernel skips
# the key tiles below the window and the ring buffer of 4096 wraps
DANUBE_LONG_KW = dict(ENGINE_KW, slots=8, cache_len=8192)
# the plain engine's blockwise attention holds (B, S, H, 1024) f32 scores,
# about 1 GB a row at S 8192: two rows a wave
DANUBE_LONG_PLAIN_SLOTS = 2


def window_prompts(vocab: int):
    rng = np.random.RandomState(3)
    lens = rng.randint(3000, 6001, size=8)
    return [rng.randint(8, vocab, size=int(n)).tolist() for n in lens]


def danube_in_window(model, plain_model, prompts) -> dict:
    """The sliding-window semantics where the reference is right: prompts
    that fit the window, in a wave padded to 512 (not past the window),
    prefilled and decoded one step through the kernels; the first decode
    step's logits against a plain ``forward`` over each prompt and its
    first token."""
    cfg = model.cfg
    # prompts and wave inside the window (at full width mix (b)'s prompts
    # and its 512 bucket are, whole)
    prompts = [p[:cfg.sliding_window - 1] for p in prompts]
    B, S = len(prompts), min(512, cfg.sliding_window)
    toks = torch.zeros((B, S), dtype=torch.int32, device="cuda")
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.as_tensor(p, device="cuda")
    lens = torch.as_tensor([len(p) for p in prompts], dtype=torch.int32,
                           device="cuda")
    cache = model.init_cache(B, 1024, torch.bfloat16)
    first = torch.argmax(model.prefill(toks, lens, cache)[:, :cfg.vocab_size],
                         dim=-1).to(torch.int32)
    dec = model.decode_step(first[:, None], lens, cache)[:, :cfg.vocab_size]
    gap = 0.0
    for i, p in enumerate(prompts):
        seq = torch.as_tensor(p + [int(first[i])], device="cuda")[None]
        fwd = plain_model.forward(seq)[0, -1, :cfg.vocab_size]
        gap = max(gap, float((dec[i].float() - fwd.float()).abs().max()))
    out = dict(prompts=B, lengths=lens.tolist(), wave=S,
               cache_positions=int(cache["k"].shape[2]), logits_gap=gap)
    log(f"[dense] h2o-danube-1.8b in-window prefill + decode step (kernels) "
        f"vs plain forward: {json.dumps(out)} (tol {LOGIT_TOL})")
    if gap > LOGIT_TOL:
        raise AssertionError(f"danube: in-window decode logits differ from "
                             f"forward by {gap}")
    return out


def dense_arch(arch) -> dict:
    """One dense decoder at full width and ``DENSE_DEPTH`` layers (seeded
    random bf16 weights drawn on the card) through the kernels, against a
    plain engine
    over the same weights: (a) and (b) on the slot cache; for the full-
    attention models (c) on the paged pool and (d) with prefix sharing on
    and off; for H2O-Danube the long mix instead, the paged and prefix
    fallbacks and the in-window check."""
    t_arch = time.monotonic()
    cfg = dataclasses.replace(get_config(arch), use_kernels=True,
                              n_layers=DENSE_DEPTH[arch])
    window = cfg.sliding_window if cfg.attention == "sliding_window" else 0
    sync()
    t0 = time.monotonic()
    model = build_model(cfg, device="cuda", seed=0)
    sync()
    init_s = time.monotonic() - t0
    n_params = sum(p.numel() for p in model.parameters())
    n_norm = (2 * cfg.n_layers + 1) * cfg.d_model * (
        2 if cfg.norm == "layernorm" else 1)
    log(f"[dense] {arch} full width: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} (head dim "
        f"{cfg.resolved_head_dim}), d_ff {cfg.d_ff} {cfg.activation}, "
        f"{cfg.norm}, vocab {cfg.vocab_size}, window {window}; {n_params} "
        f"params ({cfg.param_count()} by param_count() + {n_norm} norm "
        f"params), {2 * n_params / 1e9:.2f} GB bf16, drawn on the card in "
        f"{init_s:.2f} s")
    if n_params != cfg.param_count() + n_norm:
        raise AssertionError(f"{arch}: {n_params} parameters")
    plain_model = build_model(dataclasses.replace(cfg, use_kernels=False),
                              device="cuda", params=dict(model.state_dict()))
    facts, longs = fact_prompts(cfg.vocab_size), long_prompts(cfg.vocab_size)
    out = {"params": n_params, "init_s": init_s, "launches": {},
           "compare": {}}
    eng = InferenceEngine(model, device="cuda", paged=bool(window),
                          **ENGINE_KW)
    if window:
        out.update(paged_fallback=eng.paged_fallback,
                   prefix_fallback=eng.prefix_fallback)
        log(f"[dense] {arch} paged=True keeps the slot cache: "
            f"{eng.paged_fallback}; prefix_fallback: {eng.prefix_fallback}")
        if eng.stats.decode_path != "full" or eng.paged_fallback != (
                "model has no paged decode path (SSM/xLSTM state and "
                "sliding-window ring buffers keep the slot cache)") \
                or eng.prefix_fallback != ("engine is not paged: "
                                           + eng.paged_fallback):
            raise AssertionError(f"{arch}: paged request did not fall back "
                                 f"with the reference's reasons")
    eng.generate([[2, 5]], max_new_tokens=2)
    (ak, rates_a, bk, rates_b), out["launches"]["ab"] = run_path(
        eng, f"{arch} (a)+(b) slot cache", lambda: (
            *serve(eng, facts, 1, f"{arch} (a) fact verification"),
            *serve(eng, longs, 64, f"{arch} (b) long prompts")))
    free(eng)
    out.update(rates_a=rates_a, rates_b=rates_b)
    plain = InferenceEngine(plain_model, device="cuda", **ENGINE_KW)
    ap, _ = serve(plain, facts, 1, f"{arch} (a) plain path")
    bp, _ = serve(plain, longs, 64, f"{arch} (b) plain path")
    out["compare"]["a"] = compare_dense(f"{arch} (a)", ak, ap, cfg.vocab_size,
                                        LOGIT_TOL, phase="dense")
    out["compare"]["b"] = compare_dense(f"{arch} (b)", bk, bp, cfg.vocab_size,
                                        LOGIT_TOL, phase="dense")
    if not window:
        pg = InferenceEngine(model, device="cuda", prefix_sharing=False,
                             **PAGED_KW)
        pg.generate([[2, 5]], max_new_tokens=2)
        (ck, out["rates_c"]), out["launches"]["c"] = run_path(
            pg, f"{arch} (c) paged pool",
            lambda: serve(pg, longs, 64, f"{arch} (c) paged pool"))
        free(pg)
        out["paged_equals_slot"] = tokens(ck) == tokens(bk)
        log(f"[dense] {arch} (c) paged tokens identical to the slot cache's "
            f"(b): {out['paged_equals_slot']}")
        if not out["paged_equals_slot"]:
            raise AssertionError(f"{arch} (c): the paged pool decodes "
                                 f"differently from the slot cache")
        plain_pg = InferenceEngine(plain_model, device="cuda",
                                   prefix_sharing=False, **PAGED_KW)
        cp, _ = serve(plain_pg, longs, 64, f"{arch} (c) plain path")
        free(plain_pg)
        out["compare"]["c"] = compare_dense(f"{arch} (c)", ck, cp,
                                            cfg.vocab_size, LOGIT_TOL,
                                            phase="dense")
        fs = fewshot_prompts(HashTokenizer(cfg.vocab_size))
        sh = InferenceEngine(model, device="cuda", **PAGED_KW)
        if sh.prefix_fallback is not None:
            raise AssertionError(f"{arch} (d): sharing is off: "
                                 f"{sh.prefix_fallback}")
        sh.generate([[2, 5]], max_new_tokens=2)
        sh.drop_prefix_cache()
        (dk, rounds), out["launches"]["d"] = run_path(
            sh, f"{arch} (d) prefix sharing",
            lambda: serve_rounds(sh, fs, 8, f"{arch} (d) sharing"))
        free(sh)
        cold = InferenceEngine(model, device="cuda", prefix_sharing=False,
                               **PAGED_KW)
        dc, _ = serve_rounds(cold, fs, 8, f"{arch} (d) no sharing")
        free(cold)
        hits = sum(r["prefix_hits"] for r in rounds)
        gap = max(float((a.first_logits - b.first_logits).abs().max())
                  for a, b in zip(dk, dc))
        same = tokens(dk) == tokens(dc)
        out.update(rounds_d=rounds, prefix_hits=hits, shared_vs_cold_gap=gap,
                   shared_equals_cold=same)
        log(f"[dense] {arch} (d) prefix hits {hits}; shared vs cold: tokens "
            f"identical {same}, first-token logits max-abs gap {gap}")
        if not same or gap != 0.0 or hits < 48:
            raise AssertionError(f"{arch} (d): shared prefill differs from "
                                 f"cold prefill or did not hit")
        dp, _ = serve(plain, fs, 8, f"{arch} (d) plain path")
        out["compare"]["d"] = compare_dense(f"{arch} (d)", dk, dp,
                                            cfg.vocab_size, LOGIT_TOL,
                                            phase="dense")
    free(plain)
    if window:
        lw = window_prompts(cfg.vocab_size)
        el = InferenceEngine(model, device="cuda", **DANUBE_LONG_KW)
        ring = tuple(el.cache["k"].shape)
        el.generate([[2, 5]], max_new_tokens=2)
        (lk, out["rates_long"]), out["launches"]["long"] = run_path(
            el, f"{arch} long mix", lambda: serve(
                el, lw, 64, f"{arch} long mix ({min(map(len, lw))}-"
                            f"{max(map(len, lw))} tokens)"))
        free(el)
        pl = InferenceEngine(plain_model, device="cuda", **dict(
            DANUBE_LONG_KW, slots=DANUBE_LONG_PLAIN_SLOTS))
        lp, _ = serve(pl, lw, 64, f"{arch} long mix plain path")
        free(pl)
        out["long_cache_shape"] = ring
        log(f"[dense] {arch} long mix cache k {ring} (ring of "
            f"{ring[2]} positions under cache_len "
            f"{DANUBE_LONG_KW['cache_len']})")
        out["compare"]["long"] = compare_dense(
            f"{arch} long mix", lk, lp, cfg.vocab_size, LOGIT_TOL,
            phase="dense")
        out["in_window"] = danube_in_window(model, plain_model, longs[:4])
    for mix, c in out["compare"].items():
        if c["failures"]:
            raise AssertionError(f"{arch} ({mix}) kernels vs plain: "
                                 f"{c['failures']}")
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    del model, plain_model
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.monotonic() - t_arch
    log(f"[dense] {arch}: {out['seconds']:.1f} s; (a) "
        f"{rates_a['requests_per_s']:.1f} requests/s; (b) decode "
        f"{rates_b['decode_tok_per_s']:.1f} tok/s; peak device memory "
        f"{out['peak_memory_bytes'] / 1e9:.2f} GB")
    return out


def phase_dense() -> dict:
    """Phase 8: the dense GQA decoders and the sliding-window decoder, one
    model resident at a time."""
    out = {"launches": {}}
    for arch in DENSE_ARCHS:
        torch.cuda.reset_peak_memory_stats()
        out[arch] = res = dense_arch(arch)
        for path, counts in res["launches"].items():
            out["launches"][f"{arch} {path}"] = counts
    return out


# --------------------------------------------------------- 9. families ----
FAMILY_ARCHS = ("xlstm-350m", "whisper-small", "llama-3.2-vision-11b")
# the vision model's cross-block gates, zero at init (as in the released
# model), so that a fresh model's image layers add nothing: set to this
FAMILY_GATE = 1.0


def frontend_extra(cfg, slots, seed) -> dict:
    """The frontend stub's inputs of ``slots`` rows (``frames`` (16, 1500,
    768) for Whisper, ``patches`` (16, 4100, 1280) for the VLM; none for
    xLSTM), standard normal from ``seed``, drawn on the card in bf16."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return {n: torch.randn(t.shape, generator=gen, device="cuda").to(
        torch.bfloat16) for n, t in extra_inputs(cfg, slots).items()}


def vision_witness(model, extra, other) -> dict:
    """Patches reach the logits: one wave of 16 x 32 tokens prefilled
    through the kernels with the engine's patches and with other patches
    from another seed; the logits must move by more than LOGIT_TOL."""
    cfg = model.cfg
    rng = np.random.RandomState(4)
    toks = torch.as_tensor(rng.randint(8, cfg.vocab_size, size=(16, 32)),
                           dtype=torch.int32, device="cuda")
    lens = torch.full((16,), 32, dtype=torch.int32, device="cuda")
    outs = []
    for ex in (extra, other):
        cache = model.init_cache(16, 64, torch.bfloat16)
        outs.append(model.prefill(toks, lens, cache, extra=ex)
                    [:, :cfg.vocab_size].float())
        del cache
    move = float((outs[0] - outs[1]).abs().max())
    log(f"[families] vision witness: other patches move the first-token "
        f"logits by {move:.4f} (must exceed {LOGIT_TOL})")
    if move <= LOGIT_TOL:
        raise AssertionError("vision: the patches do not reach the logits")
    return dict(logits_move=move)


def family_arch(arch) -> dict:
    """One of the last model families at full width and depth (seeded
    random bf16 weights drawn on the card; the vision gates set to
    FAMILY_GATE) through the kernels on the slot cache, with its frontend
    inputs from a seed as the engine's ``extra``: mixes (a) and (b) with
    the launch counts at 0 (Whisper and the VLM must launch both attention
    kernels, xLSTM none), against a plain engine over the same weights
    (phase 4's comparison at LOGIT_TOL); (b) again at megastep 1, whose
    tokens must equal megastep 8's; the paged request's fallback; for
    xLSTM and Whisper a demote to host and a restore after which (b)
    decodes the same; for the VLM the witness that the patches reach the
    logits."""
    t_arch = time.monotonic()
    cfg = dataclasses.replace(get_config(arch), use_kernels=True)
    sync()
    t0 = time.monotonic()
    model = build_model(cfg, device="cuda", seed=0)
    if cfg.family == "vlm":
        for blk in model.cross:
            blk.gate_attn.fill_(FAMILY_GATE)
            blk.gate_mlp.fill_(FAMILY_GATE)
    sync()
    init_s = time.monotonic() - t0
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[families] {arch} full width: family {cfg.family}, {cfg.n_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.n_heads} heads over "
        f"{cfg.n_kv_heads}, vocab {cfg.vocab_size}; {n_params} params "
        f"allocated ({cfg.param_count()} by param_count()), "
        f"{2 * n_params / 1e9:.2f} GB bf16, drawn on the card in "
        f"{init_s:.2f} s")
    plain_model = build_model(dataclasses.replace(cfg, use_kernels=False),
                              device="cuda", params=dict(model.state_dict()))
    extra = frontend_extra(cfg, ENGINE_KW["slots"], seed=1)
    kw = dict(ENGINE_KW, extra=extra or None)
    facts, longs = fact_prompts(cfg.vocab_size), long_prompts(cfg.vocab_size)
    out = {"params": n_params, "param_count": cfg.param_count(),
           "init_s": init_s, "launches": {}, "compare": {},
           "extra": {n: list(t.shape) for n, t in extra.items()}}
    eng = InferenceEngine(model, device="cuda", paged=True, **kw)
    out.update(paged_fallback=eng.paged_fallback)
    if eng.stats.decode_path != "full" or eng.paged_fallback != (
            "model has no paged decode path (SSM/xLSTM state and "
            "sliding-window ring buffers keep the slot cache)"):
        raise AssertionError(f"{arch}: paged request did not fall back "
                             f"with the reference's reason")
    eng.generate([[2, 5]], max_new_tokens=2)
    (ak, rates_a, bk, rates_b), out["launches"]["ab"] = run_path(
        eng, f"{arch} (a)+(b) slot cache", lambda: (
            *serve(eng, facts, 1, f"{arch} (a) fact verification"),
            *serve(eng, longs, 64, f"{arch} (b) long prompts")))
    out.update(rates_a=rates_a, rates_b=rates_b,
               cache_bytes=eng.snapshot()["capacity_bytes"])
    one = InferenceEngine(model, device="cuda", **dict(kw, megastep=1))
    b1, _ = serve(one, longs, 64, f"{arch} (b) megastep 1")
    free(one)
    out["megastep1_equals_8"] = tokens(b1) == tokens(bk)
    log(f"[families] {arch} (b) tokens at megastep 1 identical to megastep "
        f"8's: {out['megastep1_equals_8']}")
    if not out["megastep1_equals_8"]:
        raise AssertionError(f"{arch}: megastep 1 and 8 decode differently")
    plain = InferenceEngine(plain_model, device="cuda", **kw)
    ap, _ = serve(plain, facts, 1, f"{arch} (a) plain path")
    bp, _ = serve(plain, longs, 64, f"{arch} (b) plain path")
    free(plain)
    del plain, plain_model
    gc.collect()
    out["compare"]["a"] = compare_dense(f"{arch} (a)", ak, ap, cfg.vocab_size,
                                        LOGIT_TOL, phase="families")
    out["compare"]["b"] = compare_dense(f"{arch} (b)", bk, bp, cfg.vocab_size,
                                        LOGIT_TOL, phase="families")
    if cfg.family == "vlm":
        out["witness"] = vision_witness(model, extra, frontend_extra(
            cfg, ENGINE_KW["slots"], seed=2))
    else:
        t0 = time.monotonic()
        host = eng.offload_device_state()
        sync()
        demote_s = time.monotonic() - t0
        mem = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        eng.restore_device_state(host)
        sync()
        restore_s = time.monotonic() - t0
        host_bytes = sum(t.numel() * t.element_size()
                         for part in ("params", "cache", "extra")
                         for t in host.get(part, {}).values())
        del host
        again, _ = serve(eng, longs, 64, f"{arch} (b) after demote/restore")
        same = tokens(again) == tokens(bk)
        out["pcm"] = dict(demote_s=demote_s, restore_s=restore_s,
                          host_bytes=host_bytes,
                          device_bytes_while_demoted=mem,
                          b_identical_after_restore=same)
        log(f"[families] {arch} demote {demote_s:.3f} s, restore "
            f"{restore_s:.3f} s, {host_bytes / 1e9:.2f} GB on the host "
            f"(device memory while demoted {mem / 1e9:.2f} GB); (b) after "
            f"the restore identical: {same}")
        if not same:
            raise AssertionError(f"{arch}: (b) decodes differently after "
                                 f"demote/restore")
    free(eng)
    for mix, c in out["compare"].items():
        if c["failures"]:
            raise AssertionError(f"{arch} ({mix}) kernels vs plain: "
                                 f"{c['failures']}")
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    del model, extra
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.monotonic() - t_arch
    log(f"[families] {arch}: {out['seconds']:.1f} s; (a) "
        f"{rates_a['requests_per_s']:.1f} requests/s; (b) decode "
        f"{rates_b['decode_tok_per_s']:.1f} tok/s; peak device memory "
        f"{out['peak_memory_bytes'] / 1e9:.2f} GB")
    return out


def xlstm_card_vs_cpu() -> dict:
    """xLSTM on the card held to the CPU: its kernel and plain engines run
    the same torch code (it launches no kernel), so ``family_arch`` only
    compares the card with itself. Here the reduced config in f32, the
    same seeded weights and a padded wave (two mLSTM chunks, ragged
    lengths) are prefilled, then decoded for 8 steps (each row's greedy
    token from the CPU's logits) on the card and on the CPU; every call's
    logits must agree within TOL[f32]."""
    cfg = get_reduced_config("xlstm-350m")
    cpu = build_model(cfg, device="cpu", seed=0)
    card = build_model(cfg, device="cuda", params=dict(cpu.state_dict()))
    rng = np.random.RandomState(7)
    S = 2 * cfg.ssm.chunk
    toks = torch.as_tensor(rng.randint(8, cfg.vocab_size, size=(4, S)),
                           dtype=torch.int32)
    lens = torch.tensor([S, S - 23, 17, 3], dtype=torch.int32)
    caches = [m.init_cache(4, S + 8, torch.float32) for m in (cpu, card)]
    with torch.no_grad():
        want = cpu.prefill(toks, lens, caches[0])
        got = card.prefill(toks.cuda(), lens.cuda(), caches[1])
        gaps = [float((got.cpu() - want).abs().max())]
        for _ in range(8):
            nxt = want[:, :cfg.vocab_size].argmax(-1).to(torch.int32)[:, None]
            lens = lens + 1
            want = cpu.decode_step(nxt, lens, caches[0])
            got = card.decode_step(nxt.cuda(), lens.cuda(), caches[1])
            gaps.append(float((got.cpu() - want).abs().max()))
    scale = float(want.abs().max())
    tol = TOL[torch.float32]
    log(f"[families] xlstm-350m reduced f32, card vs CPU: prefill then 8 "
        f"decode steps, largest logits gap per call "
        f"{[f'{g:.2e}' for g in gaps]} (tol {tol:g}; logits up to "
        f"{scale:.2f})")
    if max(gaps) >= tol:
        raise AssertionError(f"xlstm-350m: card and CPU logits differ by "
                             f"{max(gaps)}")
    del card, caches
    torch.cuda.empty_cache()
    return dict(gaps=gaps, tol=tol, logits_max=scale)


def phase_families() -> dict:
    """Phase 9: xLSTM-350M, Whisper-small and Llama-3.2-Vision-11B, one
    model resident at a time; then the reduced xLSTM on the card against
    the CPU."""
    t0 = time.monotonic()
    out = {"launches": {}}
    for arch in FAMILY_ARCHS:
        torch.cuda.reset_peak_memory_stats()
        out[arch] = res = family_arch(arch)
        for path, counts in res["launches"].items():
            out["launches"][f"{arch} {path}"] = counts
    out["xlstm_card_vs_cpu"] = xlstm_card_vs_cpu()
    out["seconds"] = time.monotonic() - t0
    return out


# ---------------------------------------------------------- 10. sharded ----
SHARDED_TRAIN = ShapeSuite("sharded_train", "train", 128, 16)
SHARDED_PREFILL = ShapeSuite("sharded_prefill", "prefill", 512, 16)
SHARDED_DECODE = ShapeSuite("sharded_decode", "decode", 1024, 16)
SHARDED_DECODE_STEPS = 16
DS_SHARDED_PREFILL = ShapeSuite("ds_sharded_prefill", "prefill", 256, 16)
# the sharded train cell against the unsharded train step from the same
# weights and batches: on a one-rank mesh every op is the same local op,
# so the gap should be 0; held to the card-vs-CPU step's loss bound
SHARDED_LOSS_TOL = TRAIN_LOSS_TOL


def sharded_train(mesh) -> dict:
    """(1) SmolLM2-1.7B's train cell (16 x 128 tokens, 2 microbatches,
    remat "block", CE chunks of 64) for 3 steps against the unsharded
    make_train_step from the same seeded weights and batches."""
    cfg = dataclasses.replace(get_config("smollm2-1.7b"), remat="block")
    fn, args, rules = steps.build_cell(cfg, SHARDED_TRAIN, mesh,
                                       accum_steps=2, ce_chunk=64)
    params, opt, _ = steps.materialize(
        args, mesh, torch.Generator("cuda").manual_seed(0))
    model = build_model(cfg, device="cuda", params={
        n: p.full_tensor().detach().clone() for n, p in params.items()})
    named = trainable(model)
    st = init_state(named)
    step = make_train_step(model, OptimizerConfig(**TRAIN_OPT),
                           accum_steps=2, ce_chunk=64)
    data = fact_data(cfg)(0)
    losses, secs = [], []
    for _ in range(3):
        batch = to_device(next(data), torch.device("cuda"))
        sync()
        t = time.monotonic()
        params, opt, met = fn(params, opt, batch)
        sync()
        secs.append(time.monotonic() - t)
        named, st, rmet = step(named, st, batch)
        losses.append((float(met["loss"]), float(rmet["loss"])))
    gap = max(abs(a - b) for a, b in losses)
    pgap = max(float((params[n].detach().full_tensor().float()
                      - named[n].detach().float()).abs().max())
               for n in named)
    log(f"[sharded] (1) train cell, rules {rules}: losses (cell, "
        f"unsharded) {[(round(a, 6), round(b, 6)) for a, b in losses]}, "
        f"largest loss gap {gap:.3e} (predicted 0, bound "
        f"{SHARDED_LOSS_TOL:g}), parameters' largest gap {pgap:.3e}; cell "
        f"step seconds {[round(x, 3) for x in secs]}")
    if gap > SHARDED_LOSS_TOL or not all(np.isfinite(losses).ravel()):
        raise AssertionError(f"sharded train: losses {losses}")
    del params, opt, model, named, st
    return dict(rules={k: str(v) for k, v in rules.items()}, losses=losses,
                loss_gap=gap, param_gap=pgap, step_s=secs)


def sharded_serve(mesh) -> dict:
    """(2) SmolLM2-1.7B's prefill cell with the kernels, 16 x 512 tokens
    of mixed lengths into a cache of 1024, against the unsharded kernel
    path; (3) 16 greedy steps of the decode cell over that cache against
    the unsharded decode_step. Each cell runs with the launch counts at
    0."""
    cfg = dataclasses.replace(get_config("smollm2-1.7b"), use_kernels=True)
    fn_p, args_p, _ = steps.build_cell(cfg, SHARDED_PREFILL, mesh)
    fn_d, _, rules_d = steps.build_cell(cfg, SHARDED_DECODE, mesh)
    params = steps.materialize(
        args_p, mesh, torch.Generator("cuda").manual_seed(0))[0]
    model = build_model(cfg, device="cuda", params={
        n: p.full_tensor() for n, p in params.items()})
    B, S, C = 16, SHARDED_PREFILL.seq_len, SHARDED_DECODE.seq_len
    gen = torch.Generator("cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device="cuda", dtype=torch.int32)
    lens = torch.randint(S // 2, S + 1, (B,), generator=gen, device="cuda",
                         dtype=torch.int32)
    cache = model.init_cache(B, C, torch.bfloat16)
    rcache = model.init_cache(B, C, torch.bfloat16)
    out = {"launches": {}}
    with torch.no_grad():
        want = model.prefill(toks, lens, rcache)
        ops.reset_launches()
        logits, cache = fn_p(params, toks, lens, cache)
        sync()
        out["launches"]["prefill"] = launched = dict(ops.LAUNCHES)
        gap = float((logits.full_tensor().float() - want.float()).abs().max())
        log(f"[sharded] (2) prefill cell 16 x {S} (lengths {int(lens.min())}-"
            f"{int(lens.max())}): logits gap {gap:.3e} (LOGIT_TOL "
            f"{LOGIT_TOL}), launches {launched}")
        if gap > LOGIT_TOL or launched["flash_attention"] <= 0:
            raise AssertionError(f"sharded prefill: gap {gap}, launches "
                                 f"{launched}")
        out["prefill_gap"] = gap
        t_ref = t_got = want.argmax(-1)
        launched = dict.fromkeys(ops.LAUNCHES, 0)
        same, steps_s = True, []
        for _ in range(SHARDED_DECODE_STEPS):
            ops.reset_launches()            # the cell's launches only
            sync()
            t = time.monotonic()
            lg, cache = fn_d(params, t_got[:, None], lens, cache)
            sync()
            steps_s.append(time.monotonic() - t)
            launched = {k: launched[k] + v for k, v in ops.LAUNCHES.items()}
            t_got = lg.full_tensor().argmax(-1)
            t_ref = model.decode_step(t_ref[:, None], lens, rcache).argmax(-1)
            same &= bool(torch.equal(t_ref, t_got))
            lens = lens + 1
        out["launches"]["decode"] = launched
        log(f"[sharded] (3) decode cell, rules {rules_d}: "
            f"{SHARDED_DECODE_STEPS} greedy steps over a cache of {C}, "
            f"tokens equal to the unsharded decode's: {same}; launches "
            f"{launched}; median step {1e3 * float(np.median(steps_s)):.1f} "
            f"ms (host clock)")
        if not same or launched["flash_decode"] <= 0:
            raise AssertionError(f"sharded decode: tokens equal {same}, "
                                 f"launches {launched}")
    out.update(decode_tokens_equal=same, decode_step_s=steps_s)
    del params, model, cache, rcache
    return out


def drops_by_count(ids: torch.Tensor, capacity: int) -> set:
    """The (token, expert) assignments past an expert's ``capacity``,
    counted expert by expert over ``ids`` (T, k) in token order, as the
    reference's test does: a plain count, independent of
    ``moe.capacity_slots``."""
    ids = ids.cpu().numpy()
    out = set()
    for e in np.unique(ids):
        toks = np.nonzero((ids == e).any(axis=1))[0]
        out.update((int(t), int(e)) for t in toks[capacity:])
    return out


def ep_reference(p, x: torch.Tensor, cfg, capacity: int) -> torch.Tensor:
    """The expert-parallel MoE's output (shared experts aside) computed
    another way: the single-device routing (``moe.route``, the iterative
    top-k), the assignments past each expert's ``capacity`` found by a
    plain count (``drops_by_count``), then every expert on every token,
    weighted by the token's kept routing weight for it, summed in f32.
    x (T, d) -> (T, d) f32. ``p`` is the MoE layer (DTensor parameters of
    a one-rank mesh: their local tensors are the whole values)."""
    E = cfg.moe.n_experts
    ex = p.experts
    plain = types.SimpleNamespace(
        router=p.router.full_tensor(),
        experts=types.SimpleNamespace(
            up=ex.up.full_tensor(), down=ex.down.full_tensor(),
            gate=None if ex.gate is None else ex.gate.full_tensor()))
    ids, w, _ = moe_lib.route(plain, x, cfg)
    w_te = torch.zeros(x.shape[0], E, device=x.device).scatter_(1, ids, w)
    for t, e in drops_by_count(ids, capacity):
        w_te[t, e] = 0.0
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(E):
        y = moe_lib._expert_ffn(plain.experts, x[None], cfg,
                                slice(e, e + 1))[0]
        out += y.float() * w_te[:, e, None]
    return out


def sharded_deepseek(mesh) -> dict:
    """(4) DeepSeek-V2-Lite-16B's prefill cell (16 x 256) under the
    experts rule: the expert-parallel MoE on the grouped GEMM's (E, C, d)
    form, launch counts at 0. Every MoE layer's dropped assignments are
    held to a plain per-expert count, and its output to ``ep_reference``
    on the same input; the end-to-end routing against the unsharded
    kernel path (which never drops) is reported. Then the first MoE
    layer's capacity pass at the config's capacity factor on the kernel
    against the plain pass, and the kernel timed at that shape."""
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                              use_kernels=True)
    fn, args, rules = steps.build_cell(cfg, DS_SHARDED_PREFILL, mesh)
    real = steps.materialize(args, mesh, torch.Generator("cuda").manual_seed(0))
    B, S = 16, DS_SHARDED_PREFILL.seq_len
    gen = torch.Generator("cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device="cuda", dtype=torch.int32)
    lens = torch.full((B,), S, dtype=torch.int32, device="cuda")
    seen, layers, moe_io = [], [], []
    orig, ep_orig = moe_lib._local_expert_pass, moe_lib._expert_parallel

    def record(x_flat, ids, w, experts, cfg_, n_local, shard_idx, capacity,
               use_kernels=None):
        if not seen:
            seen.append((x_flat, ids, w, experts, n_local, shard_idx,
                         capacity))
        layers.append((ids, moe_lib.capacity_slots(
            ids, w, n_local, shard_idx, capacity)[2], n_local, shard_idx,
            capacity))
        return orig(x_flat, ids, w, experts, cfg_, n_local, shard_idx,
                    capacity, use_kernels)

    def record_io(p, x, cfg_, cf):
        y, aux = ep_orig(p, x, cfg_, cf)
        d = x.shape[-1]
        moe_io.append((p, x.full_tensor().reshape(-1, d),
                       y.full_tensor().reshape(-1, d)))
        return y, aux
    moe_lib._local_expert_pass = record
    moe_lib._expert_parallel = record_io
    try:
        ops.reset_launches()
        with RouteLog("ep_route") as log_cell:
            logits, _ = fn(real[0], toks, lens, real[3])
        sync()
    finally:
        moe_lib._local_expert_pass = orig
        moe_lib._expert_parallel = ep_orig
    launched = dict(ops.LAUNCHES)
    lg = logits.full_tensor()
    drops, errs = [], []
    with torch.no_grad():
        for (ids_l, dropped, n_local, idx, cap), (p, x, y) in zip(layers,
                                                                 moe_io):
            lo = idx * n_local
            counted = {(t, e) for t, e in drops_by_count(ids_l, cap)
                       if lo <= e < lo + n_local}
            slots = {(int(t), lo + int(e))
                     for t, e in dropped.nonzero().tolist()}
            if slots != counted:
                raise AssertionError(
                    f"capacity {cap}, MoE layer {len(drops)}: capacity_slots"
                    f" drops {len(slots)} assignments, a plain count "
                    f"{len(counted)}")
            drops.append(len(slots))
            want = ep_reference(p, x, cfg, cap)
            errs.append((float((y.float() - want).abs().max()),
                         TOL[torch.bfloat16] * float(want.abs().max())))
        # the unsharded kernel path never drops: where the cell dropped,
        # its routing parts from the cell's (reported, not bounded)
        model = build_model(cfg, device="cuda", params={   # shares weights
            n: p.full_tensor() for n, p in real[0].items()})
        with RouteLog() as log_plain:
            want = model.prefill(toks, lens,
                                 model.init_cache(B, S, torch.bfloat16))
        sync()
    diff = torch.stack([(a != b).any(dim=1) for a, b in
                        zip(log_cell.calls, log_plain.calls)])  # (L, T)
    by_layer = [round(float(v), 5) for v in diff.float().mean(dim=1)]
    gap = float((lg.float() - want.float()).abs().max())
    x_flat, ids, w, experts, n_local, idx, cap_cell = seen[0]
    worst = max(range(len(errs)), key=lambda i: errs[i][0] / errs[i][1])
    log(f"[sharded] (4) deepseek prefill cell 16 x {S}, rules {rules}: "
        f"capacity {cap_cell} at prefill's factor 2.0 (the reference's), "
        f"dropped assignments by MoE layer {drops} (each equal to a plain "
        f"count); each MoE layer's output against ep_reference on its "
        f"input: largest error {errs[worst][0]:.3e} (layer {worst}, tol "
        f"{errs[worst][1]:.3e}); launches {launched}; against the "
        f"unsharded kernel path (no drops): routing decisions that differ "
        f"by MoE layer {by_layer}, logits' largest gap {gap:.3e}")
    if (not torch.isfinite(lg).all() or launched["grouped_gemm"] <= 0
            or len(moe_io) != cfg.n_layers - cfg.moe.first_dense_layers
            or any(e > t for e, t in errs) or by_layer[0] != 0.0):
        raise AssertionError(
            f"sharded deepseek prefill: layer errors {errs}, first MoE "
            f"layer's routing differs in {by_layer[0]}, launches "
            f"{launched}")
    del model, want, layers, moe_io
    T = x_flat.shape[0]
    res = {"launches": {"deepseek prefill": launched}, "capacity_cell":
           cap_cell, "tokens": T, "drops_by_layer": drops,
           "layer_errors": errs, "route_diff_by_layer": by_layer,
           "logits_gap_unsharded": gap}
    with torch.no_grad():
        for label, cap in (("cell", cap_cell),
                           ("config", moe_lib._capacity(T, cfg))):
            dropped = moe_lib.capacity_slots(ids, w, n_local, idx, cap)[2]
            kern = orig(x_flat, ids, w, experts, cfg, n_local, idx, cap,
                        use_kernels=True)
            plain = orig(x_flat, ids, w, experts, cfg, n_local, idx, cap,
                         use_kernels=False)
            sync()
            err = float((kern.float() - plain.float()).abs().max())
            tol = min(1.0 * cfg.moe.d_ff ** 0.5,
                      TOL[torch.bfloat16] * float(plain.float().abs().max()))
            n_drop = int(dropped.sum())
            share = float(dropped.any(dim=1).float().mean())
            counted = drops_by_count(ids, cap)
            check(f"expert-parallel pass, capacity {cap} ({label}), kernel "
                  f"vs plain", err, torch.bfloat16, tol=tol,
                  extra=f"({n_drop} dropped (token, expert) assignments of "
                        f"{T * cfg.moe.experts_per_token}, {100 * share:.2f}"
                        f" % of tokens with a drop; {len(counted)} by a "
                        f"plain count)")
            slots = {(int(t), idx * n_local + int(e))
                     for t, e in dropped.nonzero().tolist()}
            if slots != counted:
                raise AssertionError(
                    f"capacity {cap}: capacity_slots drops {len(slots)} "
                    f"assignments, the plain count {len(counted)}, "
                    f"{len(slots ^ counted)} differ")
            res[f"capacity_{label}"] = dict(capacity=cap, max_abs_err=err,
                                            tol=tol, dropped=n_drop,
                                            dropped_by_count=len(counted),
                                            token_share=share)
        cap = res["capacity_config"]["capacity"]
        tok = moe_lib.capacity_slots(ids, w, n_local, idx, cap)[0]
        xt = x_flat.index_select(0, tok).reshape(n_local, cap, -1)
        wt = experts.up
        E, C, d, f = n_local, cap, xt.shape[-1], wt.shape[-1]
        got = ops.grouped_gemm(xt, wt)
        exp = ref.grouped_gemm_ref(xt, wt)
        sync()
        err = float((got.float() - exp.float()).abs().max())
        check(f"grouped_gemm ({E},{C},{d}) x ({E},{d},{f}) capacity form",
              err, torch.bfloat16,
              tol=min(d ** 0.5, TOL[torch.bfloat16]
                      * float(exp.float().abs().max())))
        ms = device_ms(lambda: ops.grouped_gemm(xt, wt), iters=20)
        lib = device_ms(lambda: torch.bmm(xt, wt), iters=20)
        plain_ms = time_ms(lambda: ref.grouped_gemm_ref(xt, wt), iters=3)
        nbytes = 2 * (E * C * d + E * d * f + E * C * f)
        flops = 2.0 * E * C * d * f
        bms, by = bound_ms(nbytes, flops)
    log(f"[sharded] grouped_gemm capacity form ({E},{C},{d}) x ({E},{d},"
        f"{f}) bf16: kernel {ms:.4f} ms ({rate(nbytes, flops, ms, by)}), "
        f"padded bmm {lib:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} "
        f"GFLOP), max_abs_err {err:.3e}")
    res["gemm_capacity_form"] = dict(
        shape=[E, C, d, f], ms=ms, library_ms=lib, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, max_abs_err=err,
        achieved=rate(nbytes, flops, ms, by))
    del real, logits, seen
    return res


def qwen3_plan() -> dict:
    """(5) Qwen3-MoE-235B planned on a (16, 16) shape-only mesh, on the
    meta device: the rules and each rank's bytes of weights."""
    cfg = get_config("qwen3-moe-235b-a22b")
    mesh = types.SimpleNamespace(shape={"data": 16, "model": 16})
    rules = shp.make_rules(cfg, mesh, SHAPES["train_4k"])
    model = abstract_model(cfg)
    specs = shp.param_specs(model, cfg, mesh, rules)
    total = sum(p.numel() * p.element_size() for p in model.parameters())
    per_rank = shp.bytes_per_rank(model, specs, mesh)
    log(f"[sharded] (5) qwen3-moe-235b on (data 16, model 16), rules "
        f"{rules}: {total / 1e9:.1f} GB of bf16 weights, "
        f"{per_rank / 1e9:.2f} GB a rank under the plan "
        f"({cfg.moe.n_experts // 16} experts a rank); nothing allocated")
    return dict(rules={k: str(v) for k, v in rules.items()},
                weight_bytes=total, bytes_per_rank=per_rank)


def phase_sharded() -> dict:
    """Phase 10: the sharded path over a one-rank NCCL mesh (1, 1) of
    ("data", "model"): SmolLM2's train, prefill and decode cells from
    launch/steps.py, DeepSeek's expert-parallel prefill cell, Qwen3's
    plan."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.TemporaryDirectory()
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp.name, "store"), 1),
        rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1, 1)
        log(f"[sharded] mesh {mesh}")
        out = {"launches": {}}
        out["train"] = sharded_train(mesh)
        gc.collect()
        torch.cuda.empty_cache()
        serve_res = sharded_serve(mesh)
        out["launches"].update(serve_res.pop("launches"))
        out["serve"] = serve_res
        gc.collect()
        torch.cuda.empty_cache()
        ds = sharded_deepseek(mesh)
        out["launches"].update(ds.pop("launches"))
        out["deepseek"] = ds
        gc.collect()
        torch.cuda.empty_cache()
        out["qwen3"] = qwen3_plan()
    finally:
        dist.destroy_process_group()
        tmp.cleanup()
    out["seconds"] = time.monotonic() - t0
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[sharded] phase {out['seconds']:.1f} s, peak device memory "
        f"{out['peak_mem_gb']:.2f} GB")
    return out


# ----------------------------------------------------------- 11. dryrun ----
# the dry-run's cells as users run them (python -m repro_torch.launch.dryrun
# on the card), one subprocess each, all started together; dropped from
# the end of this list when the phase outgrows its budget
DRYRUN_CELLS = (
    ("deepseek-v2-lite-16b", "prefill_32k", ()),
    ("granite-3-2b", "decode_32k", ()),
    ("zamba2-7b", "long_500k", ()),
    ("qwen3-moe-235b-a22b", "decode_32k", ()),
    ("xlstm-350m", "decode_32k", ("--multipod",)),
    ("whisper-small", "train_4k", ("--gate-only",)),
)
DRYRUN_PERF = ("granite-3-2b", "decode_32k", "kv_update=mask")
DRYRUN_TIMEOUT = 400        # s, one subprocess
# the fake run's peak bytes against max_memory_allocated's rise over the
# same cell on the card, as predicted before the first run (PERF.md): within
# 10 % of the rise plus 64 MiB (the allocator's 512-byte rounding and
# scratch that no op reports, such as cuBLAS's workspace)
DRYRUN_MEM_REL = 0.10
DRYRUN_MEM_ABS = 64 * 2 ** 20
ONE_CARD_ITERS = 5


def dryrun_cmd(module, *flags):
    return [sys.executable, "-m", f"repro_torch.launch.{module}",
            "--device", "cuda", *flags]


def dryrun_cells(tmp, meanwhile) -> tuple:
    """(1) The dry-run cells of DRYRUN_CELLS, each a subprocess on the
    card, all started together; ``meanwhile()`` runs in this process
    while they do (work that times nothing); perf.py over DRYRUN_PERF
    against the decode artifact as soon as that cell is done; then the
    roofline table of the artifacts -> (readings, meanwhile's result)."""
    out_dir = os.path.join(tmp, "dryrun_torch")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p_arch, p_shape, p_set = DRYRUN_PERF

    def start(name, cmd):
        outf = open(os.path.join(tmp, f"{len(procs)}.log"), "w+")
        procs[name] = (subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=outf,
                                        stderr=subprocess.STDOUT),
                       outf, time.monotonic())

    procs, secs, lines = {}, {}, {}
    try:
        for arch, shape, flags in DRYRUN_CELLS:
            start(f"{arch} {shape}", dryrun_cmd(
                "dryrun", "--arch", arch, "--shape", shape, "--out",
                out_dir, "--force", *flags))
        during = meanwhile()
        deadline = time.monotonic() + DRYRUN_TIMEOUT
        while len(secs) < len(procs):
            if time.monotonic() > deadline:
                raise AssertionError(f"dryrun: still running after "
                                     f"{DRYRUN_TIMEOUT} s: "
                                     f"{sorted(set(procs) - set(secs))}")
            for name, (proc, outf, t0) in list(procs.items()):
                if name in secs or proc.poll() is None:
                    continue
                secs[name] = time.monotonic() - t0
                outf.seek(0)
                text = outf.read()
                kept = [ln for ln in text.splitlines()
                        if not ln.startswith("[rank0]:W")]
                lines[name] = kept[-1] if kept else ""
                log(f"[dryrun] (1) {name}: {lines[name]} (subprocess "
                    f"{secs[name]:.1f} s, rc {proc.returncode})")
                if proc.returncode != 0:
                    raise AssertionError(f"dryrun {name}: rc "
                                         f"{proc.returncode}\n"
                                         f"{text[-4000:]}")
                if name == f"{p_arch} {p_shape}":
                    start("perf", dryrun_cmd(
                        "perf", "--arch", p_arch, "--shape", p_shape,
                        "--set", p_set, "--tag", "mask_update",
                        "--baseline", os.path.join(
                            out_dir, f"{p_arch}__{p_shape}__pod1.json"),
                        "--out", os.path.join(tmp, "perf_torch")))
            time.sleep(0.2)
    finally:
        for proc, outf, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            outf.close()
    arts = {p.name: json.loads(p.read_text())
            for p in sorted(Path(out_dir).glob("*.json"))}
    for name, art in arts.items():
        if not art.get("ok"):
            raise AssertionError(f"dryrun {name}: {art.get('error')}")
        mem = art["memory_analysis"]
        log(f"[dryrun] (1) {name}: rank 0 peak "
            f"{mem['peak_size_in_bytes'] / 1e9:.2f} GB (arguments "
            f"{mem['argument_size_in_bytes'] / 1e9:.2f} GB), fits "
            f"{art['fits']}; FLOPs {art.get('cost_unrolled', {}).get('flops')}"
            f", collective bytes a rank "
            f"{art.get('collectives', {}).get('by_kind')}")
    table = roofline.format_table(roofline.load_table(out_dir))
    log("[dryrun] (1) the roofline of the cells on the H100 (PEAK "
        f"{roofline.PEAK_FLOPS:g} FLOP/s, HBM {roofline.HBM_BW:g} B/s, link "
        f"{roofline.ICI_BW:g} B/s):\n{table}")
    return dict(seconds=secs, artifacts=arts, table=table,
                perf=lines.pop("perf")), during


def one_card_cells(mesh):
    """The two SmolLM2 cells of phase 10 on a (1, 1) mesh, plain path:
    name -> (fn, make, suite); make() gives the cell's arguments (drawn
    on the card, or fake under FakeTensorMode)."""
    cfg = get_config("smollm2-1.7b")
    fn_p, args_p, _ = steps.build_cell(cfg, SHARDED_PREFILL, mesh)
    B, S, C = 16, SHARDED_PREFILL.seq_len, SHARDED_DECODE.seq_len

    def make_prefill():
        gen = torch.Generator("cuda").manual_seed(1)
        params = steps.materialize(args_p, mesh, gen)[0]
        toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                             device="cuda", dtype=torch.int32)
        lens = torch.full((B,), S, dtype=torch.int32, device="cuda")
        cache = fn_p.model.init_cache(B, C, torch.bfloat16, device="cuda")
        return params, toks, lens, cache
    tcfg = dataclasses.replace(cfg, remat="block")
    fn_t, args_t, _ = steps.build_cell(tcfg, SHARDED_TRAIN, mesh,
                                       accum_steps=2, ce_chunk=64)

    def make_train():
        return steps.materialize(args_t, mesh,
                                 torch.Generator("cuda").manual_seed(0))
    return {"prefill": (fn_p, make_prefill, SHARDED_PREFILL),
            "train": (fn_t, make_train, SHARDED_TRAIN)}


def one_card_fake() -> dict:
    """Each one-card cell once over fake tensors in a fake world of one
    rank, as the dry-run runs a cell -> name -> counter."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.mesh import fake_world, make_host_mesh
    out = {}
    with fake_world(1, "cuda"):
        mesh = make_host_mesh(1, 1)
        for name, (fn, make, _) in one_card_cells(mesh).items():
            with FakeTensorMode(allow_non_fake_inputs=True):
                _, out[name] = hlo.run_counted(fn, make())
    return out


def one_card_counts(fake) -> dict:
    """(2) The one-card cells with real tensors on the card in a one-rank
    NCCL world: counted as the fake runs were (FLOPs and collective bytes
    must be equal), max_memory_allocated's rise beside the fake run's
    peak, and the device time (median of ONE_CARD_ITERS) beside the
    roofline's bound."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    tmp = tempfile.TemporaryDirectory()
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp.name, "store"), 1),
        rank=0, world_size=1)
    res = {}
    try:
        mesh = make_host_mesh(1, 1)
        for name, (fn, make, suite) in one_card_cells(mesh).items():
            args = make()
            sync()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _, real = hlo.run_counted(fn, args)
            sync()
            rise = torch.cuda.max_memory_allocated() - base
            f = fake[name]
            coll = (hlo.collective_bytes(f), hlo.collective_bytes(real))
            ms = []
            for _ in range(ONE_CARD_ITERS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(*args)
                end.record()
                sync()
                ms.append(start.elapsed_time(end))
            med = float(np.median(ms))
            art = {"arch": "smollm2-1.7b", "shape": suite.name,
                   "mesh": "1x1", "kind": suite.kind, "ok": True,
                   "cost_unrolled": hlo.cost_stats(real, 1),
                   "collectives": {"extrapolated_total_bytes": float(
                       coll[1].get("total", 0)), "by_kind": {}}}
            row = roofline.cell_roofline(art, suite)
            bound_ms = 1e3 * row["step_seconds_bound"]
            tol = DRYRUN_MEM_REL * rise + DRYRUN_MEM_ABS
            log(f"[dryrun] (2) smollm2-1.7b {name} ({suite.global_batch} x "
                f"{suite.seq_len}), one rank: FLOPs fake {f.flops} real "
                f"{real.flops}; collective bytes fake {coll[0]} real "
                f"{coll[1]}; peak bytes, dry-run {f.peak_bytes} (the real "
                f"run's tracker {real.peak_bytes}) vs max_memory_allocated "
                f"rise {rise} (gap {f.peak_bytes - rise:+d}, tolerance "
                f"{tol:.0f}); device time median {med:.2f} ms of "
                f"{[round(x, 2) for x in ms]}, roofline bound {bound_ms:.2f}"
                f" ms ({row['dominant']}), bound/measured "
                f"{bound_ms / med:.3f}")
            if f.flops != real.flops or coll[0] != coll[1] or \
                    coll[1].get("total", 0) != 0 or f.flops <= 0:
                raise AssertionError(f"one-card {name}: counts differ")
            if abs(f.peak_bytes - rise) > tol:
                raise AssertionError(f"one-card {name}: peak {f.peak_bytes}"
                                     f" vs rise {rise}")
            res[name] = dict(flops=f.flops, collective_bytes=coll[1],
                             fake_peak=f.peak_bytes, real_peak=real.peak_bytes,
                             rise=rise, device_ms=ms, median_ms=med,
                             bound_ms=bound_ms, dominant=row["dominant"],
                             fraction=bound_ms / med)
            del args
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        tmp.cleanup()
    return res


def phase_dryrun() -> dict:
    """Phase 11: the dry-run, the roofline and perf.py as users run them
    (the one-card cells' fake runs meanwhile), then the one-card cells'
    counts held against the card."""
    t0 = time.monotonic()
    tmp = tempfile.TemporaryDirectory()
    try:
        out, fake = dryrun_cells(tmp.name, one_card_fake)
    finally:
        tmp.cleanup()
    t1 = time.monotonic()
    out["one_card"] = one_card_counts(fake)
    out["one_card_seconds"] = time.monotonic() - t1
    out["seconds"] = time.monotonic() - t0
    log(f"[dryrun] phase {out['seconds']:.1f} s ((2)'s real runs "
        f"{out['one_card_seconds']:.1f} s)")
    return out


class PlantFault:
    """For --faults: breaks one kernel entry point at run time (the code
    stays as it is) while active. ``gemm_drop_expert`` zeroes the grouped
    GEMM's output rows of expert 0, as if that expert's tiles were
    dropped; ``mla_drop_newest`` hands the MLA decode kernel each slot's
    length less one, so the new token's own key goes unread (both
    DeepSeek's). ``ssd_drop_carry`` runs the SSD scan on each 64-step tile
    of the sequence on its own, as if the state were not carried from tile
    to tile; ``ssd_drop_diagonal`` leaves each step's own input out of its
    output (y_t misses (C_t . B_t) v_t), as a causal mask of t < s would
    (both Zamba2's)."""

    DEEPSEEK = ("gemm_drop_expert", "mla_drop_newest")
    ZAMBA2 = ("ssd_drop_carry", "ssd_drop_diagonal")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self._saved = gemm, mla, scan = (ops.grouped_gemm_segments,
                                         ops.paged_mla_decode, ops.ssm_scan)
        if self.name == "gemm_drop_expert":
            def broken_gemm(x, counts, w):
                out = gemm(x, counts, w)
                rows = torch.arange(out.shape[0], device=out.device)
                return out.masked_fill((rows < counts[0])[:, None], 0)
            ops.grouped_gemm_segments = broken_gemm
        elif self.name == "mla_drop_newest":
            def broken_mla(*args, scale):
                *head, lengths = args
                return mla(*head, torch.clamp(lengths - 1, min=0),
                           scale=scale)
            ops.paged_mla_decode = broken_mla
        elif self.name == "ssd_drop_carry":
            def broken_scan(C, B, v, log_a, chunk=128):
                parts = [scan(*(t[:, s0:s0 + 64] for t in (C, B, v, log_a)))
                         for s0 in range(0, C.shape[1], 64)]
                return (torch.cat([y for y, _ in parts], dim=1),
                        parts[-1][1])
            ops.ssm_scan = broken_scan
        elif self.name == "ssd_drop_diagonal":
            def broken_scan(C, B, v, log_a, chunk=128):
                y, state = scan(C, B, v, log_a)
                own = (C.float() * B.float()).sum(-1, keepdim=True)
                own = own.repeat_interleave(v.shape[2] // C.shape[2], dim=2)
                return y - own * v.float(), state
            ops.ssm_scan = broken_scan
        return self

    def __exit__(self, *exc):
        (ops.grouped_gemm_segments, ops.paged_mla_decode,
         ops.ssm_scan) = self._saved


def phase_faults() -> dict:
    """--faults: phase 6's comparison of the kernel engine with the plain
    engine on (e) and (f), and phase 7's on (g), (h) and in f32, read
    with no fault and with each PlantFault planted in the kernel engine of
    its model; every engine is fresh, so each run assigns the slots alike.
    These readings set the routing bounds, DS_LOGIT_TOL, ZAMBA_LOGIT_TOL
    and ZAMBA_F32_LOGIT_TOL. Returns {fault: {mix: reading}}."""
    out = {"none": {}}
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                              use_kernels=True)
    model = build_model(cfg, device="cuda", seed=0)
    plain_model = build_model(dataclasses.replace(cfg, use_kernels=False),
                              device="cuda", params=dict(model.state_dict()))
    facts = fact_prompts(cfg.vocab_size)
    longs = long_prompts(cfg.vocab_size)

    def run(m, label):
        eng = InferenceEngine(m, device="cuda", **PAGED_KW)
        eng.generate([[2, 5]], max_new_tokens=2)
        with RouteLog() as log_e:
            e, _ = serve(eng, facts, 1, f"(e) {label}")
        with RouteLog() as log_f:
            f, _ = serve(eng, longs, 64, f"(f) {label}")
        slots = eng.slots
        free(eng)
        return e, f, log_e, log_f, slots

    ep, fp, rp_e, rp_f, _ = run(plain_model, "plain path")
    for fault in ("none",) + PlantFault.DEEPSEEK:
        with PlantFault(fault):
            ek, fk, rk_e, rk_f, slots = run(model, f"fault {fault}")
        out.setdefault(fault, {}).update(
            e=compare_routed(f"(e) fault {fault}", ek, ep, rk_e, rp_e, cfg,
                             slots),
            f=compare_routed(f"(f) fault {fault}", fk, fp, rk_f, rp_f, cfg,
                             slots))
        del rk_e, rk_f
    del model, plain_model, rp_e, rp_f
    gc.collect()
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(get_config("zamba2-7b"), use_kernels=True)
    model = build_model(cfg, device="cuda", seed=0)
    plain_model = build_model(dataclasses.replace(cfg, use_kernels=False),
                              device="cuda", params=dict(model.state_dict()))
    facts = fact_prompts(cfg.vocab_size)
    longs = long_prompts(cfg.vocab_size)

    def run_z(m, label):
        eng = InferenceEngine(m, device="cuda", **ENGINE_KW)
        eng.generate([[2, 5]], max_new_tokens=2)
        g, _ = serve(eng, facts, 1, f"(g) {label}")
        h, _ = serve(eng, longs, 64, f"(h) {label}")
        free(eng)
        return g, h

    gp, hp = run_z(plain_model, "plain path")
    for fault in ("none",) + PlantFault.ZAMBA2:
        with PlantFault(fault):
            gk, hk = run_z(model, f"fault {fault}")
        out.setdefault(fault, {}).update(
            g=compare_dense(f"(g) fault {fault}", gk, gp, cfg.vocab_size,
                            ZAMBA_LOGIT_TOL),
            h=compare_dense(f"(h) fault {fault}", hk, hp, cfg.vocab_size,
                            ZAMBA_LOGIT_TOL))
    del model, plain_model
    gc.collect()
    torch.cuda.empty_cache()
    for fault in ("none",) + PlantFault.ZAMBA2:
        with PlantFault(fault):
            out[fault]["f32"] = zamba2_f32_check(f"fault {fault}", facts,
                                                 longs)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full report as JSON here")
    ap.add_argument("--faults", action="store_true",
                    help="instead of the smoke run: read the comparisons "
                         "of phases 6 and 7 with no fault and with each "
                         "planted fault (PlantFault); exits 0 when the "
                         "sound run passes and every fault is caught")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()
    if args.faults:
        report = {"card": phase_card(), "build": {
            k: v for k, v in phase_build().items() if k != "ptxas"}}
        report["faults"] = readings = phase_faults()
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(report, indent=1))
        failed = {k: any(m["failures"] for m in r.values())
                  for k, r in readings.items()}
        print(json.dumps({"check_failed": failed}), flush=True)
        caught = not failed.pop("none") and all(failed.values())
        return 0 if caught else 1

    def phase_done(name):
        log(f"[time] {name} done at {time.monotonic() - t_start:.1f} s")

    smi = phase_card()
    report = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    report["build"] = {k: v for k, v in phase_build().items()
                       if k != "ptxas"}
    phase_done("build")
    rows = phase_kernels()
    phase_done("kernels")
    serve_out = phase_serve()
    phase_done("serve")
    sharing = serve_out.pop("sharing_engine")
    fewshot, longs = serve_out.pop("fewshot"), serve_out.pop("longs")
    report["serve"] = serve_out
    report["pcm"] = phase_pcm(serve_out.pop("long_tokens"))
    report["pcm_paged"] = phase_pcm_paged(
        sharing, fewshot, serve_out.pop("fewshot_tokens"), longs,
        serve_out.pop("paged_tokens"), report["pcm"]["cache_bytes"])
    phase_done("pcm")
    del sharing
    gc.collect()
    torch.cuda.empty_cache()
    report["runtime"] = phase_runtime()
    phase_done("runtime")
    handoff = report["runtime"].pop("handoff")
    report["multihost"] = phase_multihost(handoff)
    phase_done("multihost")
    report["frontdoor"] = phase_frontdoor(handoff)
    handoff["tmp"].cleanup()
    del handoff
    phase_done("frontdoor")
    gc.collect()
    torch.cuda.empty_cache()
    report["train"] = phase_train()
    phase_done("train")
    report["deepseek"] = phase_deepseek()
    phase_done("deepseek")
    gc.collect()
    torch.cuda.empty_cache()
    report["zamba2"] = phase_zamba2()
    phase_done("zamba2")
    gc.collect()
    torch.cuda.empty_cache()
    report["dense"] = phase_dense()
    phase_done("dense")
    gc.collect()
    torch.cuda.empty_cache()
    report["families"] = phase_families()
    phase_done("families")
    gc.collect()
    torch.cuda.empty_cache()
    report["sharded"] = phase_sharded()
    phase_done("sharded")
    gc.collect()
    torch.cuda.empty_cache()
    report["dryrun"] = phase_dryrun()
    phase_done("dryrun")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # a kernel's launches on the main paths, summed over its entry points
    entries = {"grouped_gemm": ("grouped_gemm", "grouped_gemm_segments"),
               "ssd_scan": ("ssm_scan",)}
    runs = [run for phase in (serve_out, report["runtime"],
                              report["multihost"], report["frontdoor"],
                              report["train"], report["deepseek"],
                              report["zamba2"], report["dense"],
                              report["families"], report["sharded"])
            for run in phase["launches"].values()]
    kernels = []
    for name, row in rows.items():
        row = dict(row, launches=sum(run[e] for run in runs
                                     for e in entries.get(name, (name,))))
        kernels.append({k: row[k] for k in keys})
    report["kernels"] = kernels
    report["flash_attention_q_offset"] = rows["flash_attention"]["q_offset"]
    report["grouped_gemm_cases"] = rows["grouped_gemm"]["cases"]
    report["ssd_scan_cases"] = rows["ssd_scan"]["cases"]
    report["d112"] = {k: rows[k]["d112"]
                      for k in ("flash_attention", "flash_decode")}
    report["wide"] = {k: rows[k]["wide"] for k in (
        "flash_attention", "flash_decode", "paged_flash_decode")}
    report["cross"] = {k: rows[k]["cross"] for k in (
        "flash_attention", "flash_decode")}
    if any(k["launches"] <= 0 for k in kernels):
        raise AssertionError("a kernel of the path never launched")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
