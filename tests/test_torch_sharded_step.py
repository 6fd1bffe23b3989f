"""The sharded path on four gloo ranks of a (2, 2) ("data", "model") CPU
mesh, each case held against the unsharded port (which the other
``test_torch_*`` files hold against the reference) within the fp32
tolerance of tests/test_kernels.py, 2e-4, and the expert-parallel MoE
against the reference's own ``shard_map`` on a 4-device CPU mesh.

One pool of four worker processes (``_worker``, started with
``python -c``) runs every case once for the module; each rank writes what
it measured to a JSON file and the tests read them. The process group
starts from a file store in a temp dir (no TCP port, so concurrent test
workers cannot collide). The reference's MoE runs once, in a subprocess
with ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (as
tests/test_sharding_launch.py's ``test_small_mesh_end_to_end``), started
alongside the pool; it writes its inputs (numpy, seed 0), outputs and
dropped assignments to an ``.npz`` the workers wait for.

Cases (reduced configs in f32, caches f32, token ids and lengths from
numpy seeds):
- smollm2 and granite with GQA (8 heads over 4 KV heads, so each rank's
  4 query heads read a slice of 2 KV heads): forward logits;
- granite: the prefill cell, then 8 greedy decode steps through the decode
  cell (its cache sharded on kv_seq), tokens identical to the unsharded
  decode's;
- smollm2: 3 steps of the train cell with 2 microbatches, each loss
  within 1e-5 of the unsharded ``make_train_step``'s and the parameters
  after it by tests/test_torch_train.py's AdamW bound; DeepSeek (the
  expert-parallel MoE at capacity factor E / k, where nothing drops) and
  granite with one K/V head (K/V replicated over the model axis): the
  same, 3 steps of one microbatch;
- the gradients of one backward pass of smollm2, DeepSeek, Zamba2 (B and
  C replicated over the model axis) and granite with one K/V head, every
  parameter's against the unsharded one's. These see what AdamW's
  scale-blind update hides: a local region's gradient for an input each
  rank reads only in part must be summed over the ranks (``Partial``),
  and one summed twice is off by a factor. Zamba2's 13 layers are held by
  their gradients only: its forward already differs by 4.7e-5 (sums in
  another order over 13 layers), and free-running AdamW steps turn that
  into sign flips of near-zero gradients (a reading: after 3 steps 1444
  of 501 368 parameters 1e-5 or more apart, the step-2 loss 6.3e-5);
- Zamba2: forward logits (Mamba2 heads sharded, the scan in a local
  region); Whisper with 3 heads (not divisible by the model axis: heads
  replicated) and the VLM (4 heads, sharded; gates 1) with their frontend
  inputs;
- DeepSeek: the prefill cell (MLA, the expert-parallel MoE at prefill's
  capacity factor 2.0, where nothing is dropped) against the unsharded
  prefill;
- the expert-parallel MoE of a reduced DeepSeek layer at capacity factor
  0.5 (8 slots an expert for a shard's 64 tokens, so assignments drop):
  output and aux loss against the reference's, the dropped (token,
  expert) sets identical, and the witness: the dense single-device path
  differs by more than the tolerance, so a port that took it quietly
  would fail.
"""

import json
import os
import subprocess
import sys
import tempfile
import textwrap
import time
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-4                 # fp32, tests/test_kernels.py
LOSS_TOL = 1e-5            # tests/test_torch_train.py
PARAM_TOL, OUTLIER_SHARE = 1e-5, 2e-3
WORLD = 4
B, S = 4, 32
MOE_CF = 0.5

REFERENCE_MOE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import get_reduced_config
    from repro.configs.shapes import ShapeSuite
    from repro.launch.sharding import make_rules
    from repro.models.moe import apply_moe, _capacity
    from repro.models.sharding import sharding_rules

    out = sys.argv[1]
    cfg = get_reduced_config("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=%(cf)r))
    rs = np.random.RandomState(0)
    d, E, f = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff
    fs = cfg.moe.shared_d_ff * cfg.moe.n_shared_experts
    Bx, Sx = %(B)d, %(S)d

    def w(*shape):
        return (rs.standard_normal(shape) * shape[-2] ** -0.5).astype(
            np.float32)
    p = {"router": w(d, E),
         "experts": {"up": w(E, d, f), "gate": w(E, d, f),
                     "down": w(E, f, d)},
         "shared": {"up": w(d, fs), "gate": w(d, fs), "down": w(fs, d)}}
    x = rs.standard_normal((Bx, Sx, d)).astype(np.float32)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))
    rules = make_rules(cfg, mesh, ShapeSuite("t", "train", Sx, Bx))
    with mesh, sharding_rules(mesh, rules):
        y, aux = jax.jit(lambda p, x: apply_moe(p, x, cfg))(p, x)
    # the dropped assignments of the reference's routing (lax.top_k of
    # each data shard's tokens, per-expert slots in token order)
    probs = jax.nn.softmax(jnp.asarray(x.reshape(Bx * Sx, d)) @ p["router"])
    ids = np.asarray(jax.lax.top_k(probs, cfg.moe.experts_per_token)[1])
    T = Bx * Sx // 2
    cap = _capacity(T, cfg)
    drops = []
    for lo in (0, T):
        seen = np.zeros(E, int)
        for t in range(lo, lo + T):
            for e in ids[t]:
                if seen[e] >= cap:
                    drops.append((t, int(e)))
                seen[e] += 1
    np.savez(out + ".tmp.npz", x=x, y=np.asarray(y), aux=float(aux),
             drops=np.array(drops, np.int64).reshape(-1, 2), cap=cap,
             router=p["router"], up=p["experts"]["up"],
             gate=p["experts"]["gate"], down=p["experts"]["down"],
             s_up=p["shared"]["up"], s_gate=p["shared"]["gate"],
             s_down=p["shared"]["down"])
    os.replace(out + ".tmp.npz", out)
""") % {"cf": MOE_CF, "B": B, "S": S}


# ------------------------------------------------------ the worker side ----
def _err(a, b) -> float:
    a = a.full_tensor() if hasattr(a, "full_tensor") else a
    b = b.full_tensor() if hasattr(b, "full_tensor") else b
    return float((a.float() - b.float()).abs().max())


def _whole(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _tokens(seed, vocab, shape=(B, S)):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, vocab, size=shape).astype(np.int32))


LENGTHS = torch.tensor([S, 20, 7, S], dtype=torch.int32)


def _pair(cfg, mesh, suite, seed=0, gates=False):
    """(unsharded model, the same weights as DTensor parameters placed by
    the rules, the rules)."""
    from repro_torch.launch import sharding as shp
    from repro_torch.models import build_model
    ref = build_model(cfg, device="cpu", seed=seed)
    if gates:
        for c in ref.cross:
            c.gate_attn.fill_(1.0)
            c.gate_mlp.fill_(1.0)
    model = build_model(cfg, device="cpu", params={
        k: v.clone() for k, v in ref.state_dict().items()})
    rules = shp.make_rules(cfg, mesh, suite)
    shp.distribute_params(model, mesh, shp.param_specs(model, cfg, mesh,
                                                       rules))
    return ref, model, rules


def _case_forward(mesh, arch, overrides=None, extra=None, gates=False):
    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.shapes import ShapeSuite
    from repro_torch.launch import sharding as shp
    from repro_torch.models import extra_inputs
    from repro_torch.models.sharding import on_mesh
    cfg = get_reduced_config(arch, **(overrides or {}))
    ref, model, rules = _pair(cfg, mesh, ShapeSuite("p", "prefill", S, B),
                              gates=gates)
    toks = _tokens(1, cfg.vocab_size)
    args, kw = (toks, LENGTHS), {}
    if extra:
        shape = extra_inputs(cfg, B)[extra].shape
        kw = {extra: torch.from_numpy(np.random.RandomState(2).standard_normal(
            tuple(shape)).astype(np.float32))}
    with torch.no_grad():
        want = ref.forward(*args, kw) if kw else ref.forward(*args)
        with on_mesh(mesh, rules):
            sargs = (shp.distribute(toks, mesh, ("data", None)),
                     shp.distribute(LENGTHS, mesh, ("data",)))
            skw = {k: shp.distribute(v, mesh, ("data", None, None))
                   for k, v in kw.items()}
            got = model.forward(*sargs, skw) if kw else model.forward(*sargs)
    return {"err": _err(got, want), "heads": "heads" in rules,
            "sharded_params": sum(
                any(not pl.is_replicate() for pl in p.placements)
                for p in model.parameters())}


GQA = dict(n_heads=8, n_kv_heads=4, head_dim=16, d_model=128, d_ff=256,
           kv_cache_dtype="float32")

# the train cases: (arch, overrides) by name
TRAIN_ARCHS = {
    "smollm2": ("smollm2-1.7b", {}),
    "deepseek": ("deepseek-v2-lite-16b", {}),
    "zamba2": ("zamba2-7b", {}),
    "granite_kv_replicated": ("granite-3-2b", dict(GQA, n_kv_heads=1)),
}
# the ones that also run 3 train-cell steps, beside smollm2's
TRAIN_CELLS = ["deepseek", "granite_kv_replicated"]


def _case_serve(mesh):
    """granite GQA: the prefill cell, then 8 greedy steps of the decode
    cell, against the unsharded prefill and decode_step."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.shapes import ShapeSuite
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    cfg = get_reduced_config("granite-3-2b", **GQA)
    fn_p, args_p, rules_p = steps.build_cell(
        cfg, ShapeSuite("p", "prefill", S, B), mesh)
    fn_d, args_d, rules_d = steps.build_cell(
        cfg, ShapeSuite("d", "decode", S, B), mesh)
    real = steps.materialize(args_p, mesh, torch.Generator().manual_seed(0))
    params, cache = real[0], real[3]
    ref = build_model(cfg, device="cpu", params={
        n: p.full_tensor().clone() for n, p in params.items()})
    rcache = ref.init_cache(B, S, torch.float32, device="cpu")
    toks = _tokens(3, cfg.vocab_size, (B, 16))
    lens = torch.tensor([16, 9, 3, 16], dtype=torch.int32)
    out = {"kv_seq": rules_d.get("kv_seq"), "decode_err": 0.0,
           "tokens_equal": True}
    with torch.no_grad():
        want = ref.prefill(toks, lens, rcache)
        logits, cache = fn_p(params, toks, lens, cache)
        out["prefill_err"] = _err(logits, want)
        out["placements"] = str(logits.placements)
        t_ref = t_got = want.argmax(-1)
        for _ in range(8):
            want = ref.decode_step(t_ref[:, None], lens, rcache)
            logits, cache = fn_d(params, t_got[:, None], lens, cache)
            got = logits.full_tensor()
            out["decode_err"] = max(out["decode_err"], _err(got, want))
            t_ref, t_got = want.argmax(-1), got.argmax(-1)
            out["tokens_equal"] &= bool(torch.equal(t_ref, t_got))
            lens = lens + 1
    out["cache_err"] = max(_err(cache[n], rcache[n]) for n in rcache)
    out["cache_placements"] = str(cache["k"].placements)
    return out


def _case_deepseek_prefill(mesh):
    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.shapes import ShapeSuite
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    cfg = get_reduced_config("deepseek-v2-lite-16b",
                             kv_cache_dtype="float32")
    fn, args, rules = steps.build_cell(cfg, ShapeSuite("p", "prefill", S, B),
                                       mesh)
    real = steps.materialize(args, mesh, torch.Generator().manual_seed(0))
    ref = build_model(cfg, device="cpu", params={
        n: p.full_tensor().clone() for n, p in real[0].items()})
    rcache = ref.init_cache(B, S, torch.float32, device="cpu")
    toks = _tokens(4, cfg.vocab_size)
    with torch.no_grad():
        want = ref.prefill(toks, LENGTHS, rcache)
        logits, cache = fn(real[0], toks, LENGTHS, real[3])
    return {"err": _err(logits, want), "experts": rules.get("experts"),
            "cache_err": max(_err(cache[n], rcache[n]) for n in rcache)}


def _train_cfg(arch):
    """The reduced config of a train case: DeepSeek's capacity factor at
    E / k, so an expert's slots hold every token of a shard and nothing
    drops (the unsharded path drops nothing either)."""
    import dataclasses
    from repro_torch.configs import get_reduced_config
    arch, over = TRAIN_ARCHS[arch]
    cfg = get_reduced_config(arch, **over)
    if cfg.moe.n_experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts
            / cfg.moe.experts_per_token))
    return cfg


def _train_batch(cfg, seed):
    toks = _tokens(seed, cfg.vocab_size)
    labels = toks.clone()
    labels[:, :5] = -100
    return {"tokens": toks, "labels": labels}


def _case_grads(mesh, arch):
    """One backward pass of the loss, sharded against unsharded: the
    loss and every parameter's gradient (its whole value), the error of
    each over the larger of 1 and the gradient's largest element."""
    from repro_torch.configs.shapes import ShapeSuite
    from repro_torch.launch import sharding as shp
    from repro_torch.models.sharding import on_mesh
    from repro_torch.train import make_loss_fn, trainable
    cfg = _train_cfg(arch)
    ref, model, rules = _pair(cfg, mesh, ShapeSuite("t", "train", S, B))
    batch = _train_batch(cfg, 20)
    named_ref, named = trainable(ref), trainable(model)
    loss_ref, _ = make_loss_fn(ref, ce_chunk=16)(batch)
    loss_ref.backward()
    with on_mesh(mesh, rules):
        sbatch = {k: shp.distribute(v, mesh, ("data", None))
                  for k, v in batch.items()}
        loss, _ = make_loss_fn(model, ce_chunk=16)(sbatch)
        loss.backward()
    errs = {}
    for n, p in named_ref.items():
        want = p.grad if p.grad is not None else torch.zeros_like(p)
        g = named[n].grad
        got = g.full_tensor() if g is not None else torch.zeros_like(want)
        errs[n] = float((got - want).abs().max()) / max(
            1.0, float(want.abs().max()))
    worst = max(errs, key=errs.get)
    return {"loss_err": abs(float(_whole(loss)) - float(loss_ref)),
            "grad_err": errs[worst], "worst": worst,
            "placements": sorted({str(named[n].grad.placements)
                                  for n in named
                                  if named[n].grad is not None})}


def _case_train(mesh, arch="smollm2", accum_steps=2):
    from repro_torch.configs.shapes import ShapeSuite
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.train import (OptimizerConfig, init_state,
                                   make_train_step, trainable)
    import dataclasses
    cfg = dataclasses.replace(_train_cfg(arch), remat="block")
    ocfg = OptimizerConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    fn, args, _ = steps.build_cell(cfg, ShapeSuite("t", "train", S, B), mesh,
                                   accum_steps=accum_steps, ce_chunk=16,
                                   opt_cfg=ocfg)
    params, opt, _ = steps.materialize(args, mesh,
                                       torch.Generator().manual_seed(0))
    ref = build_model(cfg, device="cpu", params={
        n: p.full_tensor().clone() for n, p in params.items()})
    named = trainable(ref)
    st = init_state(named)
    step = make_train_step(ref, ocfg, accum_steps=accum_steps, ce_chunk=16)
    losses = []
    for i in range(3):
        batch = _train_batch(cfg, 10 + i)
        params, opt, met = fn(params, opt, batch)
        named, st, rmet = step(named, st, batch)
        losses.append((float(met["loss"]), float(rmet["loss"])))
    diffs = torch.cat([(params[n].full_tensor() - named[n].detach()
                        ).abs().flatten() for n in named])
    mu = {n: m for n, m in opt["mu"].items() if "layers.0." in n}
    return {"losses": losses, "param_max": float(diffs.max()),
            "param_over": int((diffs >= PARAM_TOL).sum()),
            "param_n": diffs.numel(), "lr": ocfg.peak_lr,
            "moments_sharded": sorted({str(m.placements)
                                       for m in mu.values()})}


def _case_moe(mesh, npz_path):
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.shapes import ShapeSuite
    from repro_torch.launch import sharding as shp
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import sharding
    from repro_torch.models.transformer import MoE
    deadline = time.time() + 300
    while not os.path.exists(npz_path):
        if time.time() > deadline:
            raise TimeoutError("the reference's MoE wrote no .npz")
        time.sleep(0.2)
    z = np.load(npz_path)
    cfg = get_reduced_config("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=MOE_CF))
    names = {"router": "router", "experts.up": "up", "experts.gate": "gate",
             "experts.down": "down", "shared.up": "s_up",
             "shared.gate": "s_gate", "shared.down": "s_down"}
    dense = MoE(cfg, "cpu")
    dense.load_state_dict({k: torch.from_numpy(z[v]) for k, v in
                           names.items()}, assign=True)
    m = MoE(cfg, "cpu")
    m.load_state_dict({k: torch.from_numpy(z[v]).clone() for k, v in
                       names.items()}, assign=True)
    x = torch.from_numpy(z["x"])
    rules = shp.make_rules(cfg, mesh, ShapeSuite("t", "train", S, B))
    shp.distribute_params(m, mesh, shp.param_specs(m, cfg, mesh, rules))
    with torch.no_grad():
        y_dense, _ = moe_lib.apply_moe(dense, x, cfg)
        with sharding.on_mesh(mesh, rules):
            xs = shp.distribute(x, mesh, ("data", None, None))
            y, aux = moe_lib.apply_moe(m, xs, cfg)
            # this rank's dropped assignments, by the port's routing
            xl = xs.to_local().reshape(-1, cfg.d_model)
            n_local = cfg.moe.n_experts // sharding.axis_size("experts")
            shard_idx = sharding.axis_index("experts")
            ids, w, _ = moe_lib.ep_route(xl, m.router.full_tensor(), cfg)
            cap = moe_lib._capacity(xl.shape[0], cfg)
            _, _, dropped = moe_lib.capacity_slots(ids, w, n_local,
                                                   shard_idx, cap)
            t0 = sharding.axis_index("batch") * xl.shape[0]
            mine = [(t0 + int(t), shard_idx * n_local + int(e))
                    for t, e in dropped.nonzero().tolist()]
    every = [None] * WORLD
    dist.all_gather_object(every, mine)
    drops = sorted({tuple(d) for part in every for d in part})
    ref_drops = sorted(tuple(int(v) for v in d) for d in z["drops"])
    return {"err": _err(y, torch.from_numpy(z["y"])),
            "aux_err": abs(float(aux.full_tensor()) - float(z["aux"])),
            "witness": _err(y_dense, torch.from_numpy(z["y"])),
            "drops": len(drops), "drops_equal": drops == ref_drops,
            "cap": cap, "ref_cap": int(z["cap"])}


def _worker(rank: int, store: str, out_dir: str, npz_path: str) -> None:
    """One rank of the pool: every case, results to ``rank{r}.json``."""
    from datetime import timedelta

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=120))
    mesh = make_host_mesh(2, 2, device_type="cpu")
    cases = {
        "forward_smollm2": lambda: _case_forward(mesh, "smollm2-1.7b"),
        "forward_granite_gqa": lambda: _case_forward(
            mesh, "granite-3-2b", GQA),
        "serve_granite_gqa": lambda: _case_serve(mesh),
        "train_smollm2": lambda: _case_train(mesh),
        **{f"grads_{a}": (lambda a=a: _case_grads(mesh, a))
           for a in TRAIN_ARCHS},
        **{f"train_{a}": (lambda a=a: _case_train(mesh, a, accum_steps=1))
           for a in TRAIN_CELLS},
        "forward_zamba2": lambda: _case_forward(mesh, "zamba2-7b"),
        "forward_whisper_3_heads": lambda: _case_forward(
            mesh, "whisper-small", dict(n_heads=3, n_kv_heads=3),
            extra="frames"),
        "forward_vlm": lambda: _case_forward(
            mesh, "llama-3.2-vision-11b", extra="patches", gates=True),
        "prefill_deepseek": lambda: _case_deepseek_prefill(mesh),
        "moe_expert_parallel": lambda: _case_moe(mesh, npz_path),
    }
    results = {}
    for name, case in cases.items():
        t = time.time()
        try:
            results[name] = case()
        except Exception:
            results[name] = {"error": traceback.format_exc()}
        results[name]["seconds"] = time.time() - t
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    dist.destroy_process_group()


# --------------------------------------------------------- the test side ----
@pytest.fixture(scope="module")
def results():
    """Every case's results on every rank: [rank] -> {case: {...}}."""
    tmp = tempfile.mkdtemp(prefix="sharded_step_")
    npz = os.path.join(tmp, "reference_moe.npz")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")])
    env.pop("JAX_PLATFORMS", None)
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, "-c", REFERENCE_MOE, npz],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)]
    store = os.path.join(tmp, "store")
    for rank in range(WORLD):
        code = (f"import test_torch_sharded_step as t; "
                f"t._worker({rank}, {store!r}, {tmp!r}, {npz!r})")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        log[-3000:] for log in logs)
    out = []
    for rank in range(WORLD):
        with open(os.path.join(tmp, f"rank{rank}.json")) as f:
            out.append(json.load(f))
    return out


def _case(results, name):
    per_rank = [r[name] for r in results]
    for r in per_rank:
        assert "error" not in r, r["error"]
    return per_rank


@pytest.mark.parametrize("name", ["forward_smollm2", "forward_granite_gqa",
                                  "forward_zamba2", "forward_vlm"])
def test_forward_logits_match_unsharded(results, name):
    for r in _case(results, name):
        assert r["err"] < TOL, r
        assert r["heads"] and r["sharded_params"] > 0


def test_whisper_heads_replicated_where_the_rules_say_so(results):
    for r in _case(results, "forward_whisper_3_heads"):
        assert r["err"] < TOL, r
        assert not r["heads"]          # 3 heads on a 2-way model axis


def test_prefill_and_greedy_decode_match_unsharded(results):
    for r in _case(results, "serve_granite_gqa"):
        assert r["kv_seq"] == "model"
        assert r["prefill_err"] < TOL and r["decode_err"] < TOL, r
        assert r["tokens_equal"], r
        assert r["cache_err"] < TOL, r
        assert "Shard(dim=1)" in r["cache_placements"], r   # kv_seq


def test_train_steps_match_unsharded(results):
    for r in _case(results, "train_smollm2"):
        for got, want in r["losses"]:
            assert abs(got - want) < LOSS_TOL, r["losses"]
        assert r["param_over"] <= OUTLIER_SHARE * r["param_n"], r
        assert r["param_max"] < 2 * 3 * r["lr"], r
        assert any("Shard" in m for m in r["moments_sharded"]), r


@pytest.mark.parametrize("arch", TRAIN_CELLS)
def test_train_cells_match_unsharded(results, arch):
    """The expert-parallel MoE and attention over one K/V head that every
    rank reads whole: 3 train-cell steps (one microbatch, the gradient
    cases' shapes) against the unsharded step."""
    for r in _case(results, f"train_{arch}"):
        for got, want in r["losses"]:
            assert abs(got - want) < LOSS_TOL, r["losses"]
        assert r["param_over"] <= OUTLIER_SHARE * r["param_n"], r
        assert r["param_max"] < 2 * 3 * r["lr"], r


@pytest.mark.parametrize("arch", list(TRAIN_ARCHS))
def test_gradients_match_unsharded(results, arch):
    """Every parameter's gradient of one backward pass, summed over the
    ranks that each hold a share of it (a replicated input of a local
    region read in part by each rank), within the fp32 tolerance of its
    scale. AdamW's update is nearly blind to a gradient's scale, so the
    train steps alone would not see a gradient counted twice."""
    for r in _case(results, f"grads_{arch}"):
        assert r["loss_err"] < LOSS_TOL, r
        assert r["grad_err"] < TOL, r


def test_deepseek_prefill_cell_matches_unsharded(results):
    """At prefill's capacity factor 2.0 no assignment drops, so the
    expert-parallel prefill equals the dense one."""
    for r in _case(results, "prefill_deepseek"):
        assert r["experts"] == "model"
        assert r["err"] < TOL and r["cache_err"] < TOL, r


def test_expert_parallel_moe_matches_reference_shard_map(results):
    for r in _case(results, "moe_expert_parallel"):
        assert r["cap"] == r["ref_cap"] == 8
        assert r["err"] < TOL and r["aux_err"] < TOL, r
        assert r["drops"] > 0 and r["drops_equal"], r


def test_dense_path_witness_differs(results):
    """The same inputs through the dense single-device path: farther from
    the reference's expert-parallel output than the tolerance."""
    for r in _case(results, "moe_expert_parallel"):
        assert r["witness"] > 100 * TOL, r
