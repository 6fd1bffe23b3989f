#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card, end to end.

Run from the root of a checkout:  python3 chip_smoke.py [--out report.json]

Phases (any failure exits non-zero; no phase swallows an exception):
  1. card     - the card's name and power limit, torch and CUDA versions;
  2. build    - nvcc builds the hand-written kernels from csrc/;
  3. kernels  - each kernel against its plain PyTorch version on the card,
                at the main-path shapes and a few sweep shapes, with times
                beside the least time the card could take (bound_ms) and
                a PyTorch library call computing the same function;
  4. serve    - full-width SmolLM2-1.7B (seeded random weights, bf16)
                through the slot-cache InferenceEngine with the kernels:
                (a) fact verification, 4 prompt templates x 64 claims,
                one token each; (b) 16 long prompts of 64-500 tokens, 64
                new tokens each. Launch counts must show both kernels ran;
                the same mixes through a use_kernels=False engine over the
                same weights must agree; torch.profiler then reads the
                device busy share and heaviest kernels of each mix;
  5. pcm      - a context's cold build, its demote to pinned host memory
                and its restore, after which (b) decodes identically.

The line before the last is the card's name and power limit as nvidia-smi
gives them; the last line is {"ok": true, "device": {...}}. Needs one CUDA
card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import HashTokenizer, fever  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import InferenceEngine, Request  # noqa: E402

# kernel-vs-plain tolerances, max-abs (tests/test_kernels.py:16)
TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
# first-token logits, kernel engine vs plain engine, both bf16, max-abs: the
# two differ only in the order of f32 sums inside attention, which can flip
# the last bit of a bf16 attention output; 24 layers carry such flips to
# the logits, whose bf16 step at magnitude 4-8 is 0.03. Eight such steps.
LOGIT_TOL = 0.25
# one H100 SXM (NVIDIA data sheet): HBM bytes/s, dense bf16 tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

ENGINE_KW = dict(slots=16, cache_len=1024, prefill_buckets=(32, 128, 512),
                 megastep=8, cache_dtype=torch.bfloat16)


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
def attention_bound(B, S, H, Hkv, D, kv_len, causal, window, elt):
    """Least bytes and FLOPs of prefill attention on these inputs: q read
    and out written once, only the K/V rows below kv_len read once, 4*D
    FLOPs per visible (query, key) pair."""
    pairs = 0
    q = np.arange(S)
    for n in kv_len:
        hi = np.minimum(q + 1, n) if causal else np.full(S, n)
        lo = np.maximum(0, q - window + 1) if window else np.zeros(S, int)
        pairs += int(np.maximum(0, hi - lo).sum())
    flops = 4.0 * D * H * pairs
    nbytes = (2 * B * S * H * D + 2 * int(np.sum(kv_len)) * Hkv * D) * elt
    nbytes += 4 * B
    return nbytes, flops


def decode_bound(B, H, Hkv, D, lengths, elt):
    live = int(np.sum(lengths))
    nbytes = (2 * B * H * D + 2 * live * Hkv * D) * elt + 4 * B
    flops = 4.0 * D * H * live
    return nbytes, flops


def bound_ms(nbytes, flops):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / BF16_FLOPS * 1e3
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def check(name, err, dtype, extra=""):
    tol = TOL[dtype]
    ok = err <= tol
    log(f"[kernels] {name}: max_abs_err {err:.3e} (tol {tol:g}) "
        f"{'ok' if ok else 'FAIL'} {extra}")
    if not ok:
        raise AssertionError(f"{name}: error {err} above tolerance {tol}")
    return err


def phase_kernels() -> dict:
    rng = np.random.RandomState(0)
    rows = {}

    # --- flash_attention ---------------------------------------------------
    def attn_case(B, S, T, H, Hkv, D, dtype, causal, window, kv_len):
        q = randn(rng, (B, S, H, D), dtype)
        k = randn(rng, (B, T, Hkv, D), dtype)
        v = randn(rng, (B, T, Hkv, D), dtype)
        kl = (None if kv_len is None else
              torch.tensor(kv_len, dtype=torch.int32, device="cuda"))
        scale = D ** -0.5
        kw = dict(causal=causal, window=window, scale=scale, kv_len=kl)
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
    ms = time_ms(lambda: ops.flash_attention(q, k, v, **kw))
    plain = time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw), iters=3)
    pos = torch.arange(S, device="cuda")
    mask = ((pos[None, :] <= pos[:, None])[None]
            & (pos[None, None, :] < kl[:, None, None]))[:, None]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, scale=kw["scale"]))
    nbytes, flops = attention_bound(B, S, H, H, D, kv_len, True, 0, 2)
    bms, by = bound_ms(nbytes, flops)
    log(f"[kernels] flash_attention main: kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, SDPA {lib:.4f} ms, bound {bms:.4f} ms ({by}: "
        f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
    rows["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:92",
        max_abs_err=main_err, ms=ms, plain_ms=plain, bound_ms=bms,
        bound_by=by, library_ms=lib)
    del q, k, v, mask, qt, kt, vt

    *_, err = attn_case(2, 256, 256, 8, 2, 128, torch.float32, True, 64, None)
    check("flash_attention GQA (2,256,8/2,128) f32 window 64", err,
          torch.float32)
    *_, err = attn_case(2, 200, 200, 4, 4, 64, torch.float32, False, 0,
                        [200, 77])
    check("flash_attention ragged S 200 non-causal f32 kv_len [200,77]", err,
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
    q, ck, cv, ln, kw, err = dec_case(B, H, H, D, Skv, torch.bfloat16,
                                      lengths.tolist())
    main_err = check("flash_decode main (16,32,64) Skv 1024 bf16 lengths "
                     "with 0/1/1024", err, torch.bfloat16)
    ms = time_ms(lambda: ops.flash_decode(q, ck, cv, ln, **kw), iters=50)
    plain = time_ms(lambda: ref.flash_decode_ref(q, ck, cv, ln, **kw))
    pos = torch.arange(Skv, device="cuda")
    mask = (pos[None, :] < ln[:, None])[:, None, None, :]
    qt, kt, vt = q[:, :, None], ck.transpose(1, 2), cv.transpose(1, 2)
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, scale=kw["scale"]), iters=50)
    nbytes, flops = decode_bound(B, H, H, D, lengths, 2)
    bms, by = bound_ms(nbytes, flops)
    log(f"[kernels] flash_decode main: kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, SDPA {lib:.4f} ms, bound {bms:.4f} ms ({by}: "
        f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)")
    rows["flash_decode"] = dict(
        name="flash_decode", route="cuda",
        source="src/repro_torch/csrc/flash_decode.cu",
        replaces="src/repro/kernels/decode_attention.py:111",
        max_abs_err=main_err, ms=ms, plain_ms=plain, bound_ms=bms,
        bound_by=by, library_ms=lib)
    del q, ck, cv, mask, qt, kt, vt

    *_, err = dec_case(3, 16, 1, 64, 128, torch.float32,
                       [1 + 37 * i % 128 for i in range(3)])
    check("flash_decode (3,16/1,64) Skv 128 f32", err, torch.float32)
    *_, err = dec_case(4, 8, 2, 64, 256, torch.float32, [100, 7, 200, 256],
                       active=[True, False, True, False])
    check("flash_decode active mask (4,8/2,64) Skv 256 f32", err,
          torch.float32, "(inactive rows exact zeros)")
    return rows


# ------------------------------------------------------------ 4. serve ----
def fact_prompts():
    tok = HashTokenizer(49_152)
    claims = fever.claim_batch(range(64))
    return [tok.encode(fever.render_prompt(c, t))
            for t in fever.PROMPT_CANDIDATES for c in claims]


def long_prompts(vocab: int):
    rng = np.random.RandomState(0)
    lens = rng.randint(64, 501, size=16)
    return [rng.randint(8, vocab, size=int(n)).tolist() for n in lens]


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
                                     "decode_seconds")}
    prefill_s = wall - d["decode_seconds"]
    rates = dict(requests=len(reqs), wall_s=wall,
                 requests_per_s=len(reqs) / wall,
                 prefill_tokens=d["prefill_tokens"],
                 prefill_tok_per_s=d["prefill_tokens"] / prefill_s,
                 decode_tokens=d["decode_tokens"],
                 decode_tok_per_s=(d["decode_tokens"] / d["decode_seconds"]
                                   if d["decode_seconds"] else None),
                 prefill_waves=d["prefill_batches"],
                 decode_steps=d["decode_steps"])
    log(f"[serve] {label}: {json.dumps(rates)}")
    for r in reqs:
        lg = r.first_logits
        if lg is None or lg.shape != (engine.cfg.padded_vocab,) \
                or not torch.isfinite(lg).all():
            raise AssertionError(f"{label}: bad first-token logits")
        if not 1 <= len(r.generated) <= max_new:
            raise AssertionError(f"{label}: {len(r.generated)} tokens")
    return reqs, rates


def compare(label, kern, plain, vocab):
    err, checked, agree = 0.0, 0, 0
    for rk, rp in zip(kern, plain):
        lk, lp = rk.first_logits[:vocab], rp.first_logits[:vocab]
        err = max(err, float((lk - lp).abs().max()))
        top2 = torch.topk(lp, 2).values
        if float(top2[0] - top2[1]) > LOGIT_TOL:
            checked += 1
            agree += int(rk.generated[0] == rp.generated[0])
    same_seq = sum(rk.generated == rp.generated
                   for rk, rp in zip(kern, plain))
    log(f"[serve] {label} kernels vs plain: first-token logits max_abs_err "
        f"{err:.4f} (tol {LOGIT_TOL}); greedy first tokens agree on "
        f"{agree}/{checked} rows with a top-2 margin above tol; identical "
        f"sequences {same_seq}/{len(kern)}")
    if err > LOGIT_TOL:
        raise AssertionError(f"{label}: logits error {err} > {LOGIT_TOL}")
    if agree != checked:
        raise AssertionError(f"{label}: first tokens disagree")
    return err


def profile_mix(engine, prompts, max_new, label) -> dict:
    """Device busy share and the heaviest kernels of one run of a mix,
    under torch.profiler (whose own host cost lowers the share a little)."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
    out = dict(wall_s=wall, device_busy_s=busy, busy_share=busy / wall,
               top=top)
    log(f"[profile] {label}: {json.dumps(out)}")
    return out


def phase_serve() -> dict:
    cfg = dataclasses.replace(get_config("smollm2-1.7b"), use_kernels=True)
    model = build_model(cfg, device="cuda", seed=0)
    engine = InferenceEngine(model, device="cuda", **ENGINE_KW)
    log(f"[serve] smollm2-1.7b full width: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {sum(p.numel() for p in model.parameters())} "
        f"params bf16; engine {ENGINE_KW}")
    facts, longs = fact_prompts(), long_prompts(cfg.vocab_size)
    # warm the allocator and cuBLAS outside the counted run
    engine.generate([[2, 5]], max_new_tokens=2)

    ops.reset_launches()
    st0 = dict(engine.stats.as_dict())
    fk, rates_a = serve(engine, facts, 1, "(a) fact verification")
    lk, rates_b = serve(engine, longs, 64, "(b) long prompts")
    launches = dict(ops.LAUNCHES)
    st = engine.stats.as_dict()
    waves = st["prefill_batches"] - st0["prefill_batches"]
    steps = st["decode_steps"] - st0["decode_steps"]
    expect = {"flash_attention": cfg.n_layers * waves,
              "flash_decode": cfg.n_layers * steps}
    log(f"[serve] launches {launches}; expected {expect} "
        f"(n_layers x prefill waves, n_layers x decode steps)")
    if any(launches[k] <= 0 for k in launches) or launches != expect:
        raise AssertionError("kernel launch counts do not match the path")

    plain_model = build_model(dataclasses.replace(cfg, use_kernels=False),
                              device="cuda", params=dict(model.state_dict()))
    plain = InferenceEngine(plain_model, device="cuda", **ENGINE_KW)
    fp, _ = serve(plain, facts, 1, "(a) plain path")
    lp, _ = serve(plain, longs, 64, "(b) plain path")
    err_a = compare("(a)", fk, fp, cfg.vocab_size)
    err_b = compare("(b)", lk, lp, cfg.vocab_size)
    out = dict(rates_a=rates_a, rates_b=rates_b, launches=launches,
               expected_launches=expect, logits_err_a=err_a,
               logits_err_b=err_b, long_tokens=[r.generated for r in lk])
    out["profile_a"] = profile_mix(engine, facts, 1, "(a) kernels")
    out["profile_b"] = profile_mix(engine, longs, 64, "(b) kernels")
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
    return dict(cold_build_s=cold_s, offload_s=offload_s,
                restore_s=restore_s, bytes_moved=moved, freed_bytes=freed)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full report as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_card()
    report = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    report["build"] = {k: v for k, v in phase_build().items()
                       if k != "ptxas"}
    rows = phase_kernels()
    report["serve"] = phase_serve()
    gc.collect()
    torch.cuda.empty_cache()
    report["pcm"] = phase_pcm(report["serve"].pop("long_tokens"))
    kernels = [dict(row, launches=report["serve"]["launches"][name])
               for name, row in rows.items()]
    report["kernels"] = kernels
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
