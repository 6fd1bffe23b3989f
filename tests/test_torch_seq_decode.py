"""The sequence-sharded decode: a decode cache split on ``kv_seq`` stays on
its ranks, each rank attends over its own key range, and the ranks'
outputs are merged by ``models.attention.combine_partials`` over
all-reduces (``models.sharding.all_reduce``).

One pool of four gloo ranks of a (2, 2) ("data", "model") CPU mesh (as
tests/test_torch_sharded_step.py's, started the same way) runs each case
once for the module: the unsharded port's prefill of 16-token prompts,
its cache placed as the decode cell places it, then 8 greedy steps of the
decode cell (whose rules put ``kv_seq`` on the model axis: two key ranges
a row) against the unsharded ``decode_step`` on the same weights, in f32
(caches f32): tokens identical, logits within tests/test_kernels.py's
fp32 tolerance 2e-4, caches within it after the steps and still placed
on their ranks (the (L, B, S, ...) leaves ``Shard(dim=1)`` on data,
``Shard(dim=2)`` on model). The prefill cell is
tests/test_torch_sharded_step.py's.

- Danube with a ring of 16 positions (8 a rank): rows of lengths 16, 9,
  3 and 14 write across the boundary of the two key ranges and wrap;
- DeepSeek's slot-cache ``mla_decode`` over the latent cache;
- Zamba2's shared attention block between its Mamba2 layers;
- Granite with ``kv_update="mask"`` against ``"scatter"``: the same bits
  (logits and caches).

``combine_partials`` is also held on its own, in plain torch: a cache cut
into 1 to 4 key ranges, some of them empty for some rows, merged, against
``flash_decode_ref`` over the whole cache, and its log-sum-exp against
``torch.logsumexp`` of the masked scores.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-4                 # fp32, tests/test_kernels.py
WORLD = 4
B, S, STEPS = 4, 32, 8
PROMPT = 16

# (arch, config overrides, prompt lengths) by case name
CASES = {
    "danube_ring": ("h2o-danube-1.8b", dict(sliding_window=16),
                    [16, 9, 3, 14]),
    "deepseek_mla": ("deepseek-v2-lite-16b", {}, [16, 9, 3, 16]),
    "zamba2_shared": ("zamba2-7b", {}, [16, 9, 3, 16]),
    "granite_scatter": ("granite-3-2b", {}, [16, 9, 3, 16]),
    "granite_mask": ("granite-3-2b", dict(kv_update="mask"),
                     [16, 9, 3, 16]),
}


# ------------------------------------------------------ the worker side ----
def _whole(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _err(a, b) -> float:
    return float((_whole(a).float() - _whole(b).float()).abs().max())


def _case(mesh, arch, over, lens):
    """The unsharded port's prefill of the prompts, its cache placed as
    the decode cell places it, then STEPS greedy steps of the decode cell
    against the unsharded ``decode_step``; returns the gaps, the tokens
    and the sharded run's logits and caches (kept for the
    mask-vs-scatter case)."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.shapes import ShapeSuite
    from repro_torch.launch import sharding as shp
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    cfg = get_reduced_config(arch, kv_cache_dtype="float32", **over)
    fn_d, args_d, rules_d = steps.build_cell(
        cfg, ShapeSuite("d", "decode", S, B), mesh)
    params = steps.materialize(args_d, mesh,
                               torch.Generator().manual_seed(0))[0]
    ref = build_model(cfg, device="cpu", params={
        n: p.full_tensor().clone() for n, p in params.items()})
    rcache = ref.init_cache(B, S, torch.float32, device="cpu")
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, size=(B, PROMPT)).astype(np.int32))
    lens = torch.tensor(lens, dtype=torch.int32)
    out = {"kv_seq": rules_d.get("kv_seq"), "decode_err": 0.0,
           "tokens_equal": True}
    logits_seen = []
    with torch.no_grad():
        t_ref = t_got = ref.prefill(toks, lens, rcache).argmax(-1)
        cache = {n: shp.distribute(c.clone(), mesh, args_d.specs[3][n])
                 for n, c in rcache.items()}
        for _ in range(STEPS):
            want = ref.decode_step(t_ref[:, None], lens, rcache)
            logits, cache = fn_d(params, t_got[:, None], lens, cache)
            got = logits.full_tensor()
            logits_seen.append(got)
            out["decode_err"] = max(out["decode_err"], _err(got, want))
            t_ref, t_got = want.argmax(-1), got.argmax(-1)
            out["tokens_equal"] &= bool(torch.equal(t_ref, t_got))
            lens = lens + 1
    names = [n for n in rcache if n in ("k", "v", "ckv", "krope")]
    out["cache_err"] = max(_err(cache[n], rcache[n]) for n in rcache)
    out["cache_placements"] = sorted({str(cache[n].placements)
                                      for n in names})
    out["lengths"] = lens.tolist()
    return out, torch.stack(logits_seen), {n: _whole(cache[n])
                                           for n in rcache}


def _worker(rank: int, store: str, out_dir: str) -> None:
    """One rank of the pool: every case, results to ``rank{r}.json``."""
    from datetime import timedelta

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=120))
    mesh = make_host_mesh(2, 2, device_type="cpu")
    results, kept = {}, {}
    for name, (arch, over, lens) in CASES.items():
        t = time.time()
        try:
            results[name], logits, caches = _case(mesh, arch, over, lens)
            kept[name] = (logits, caches)
        except Exception:
            results[name] = {"error": traceback.format_exc()}
        results[name]["seconds"] = time.time() - t
    if "granite_mask" in kept and "granite_scatter" in kept:
        (lm, cm), (ls, cs) = kept["granite_mask"], kept["granite_scatter"]
        results["mask_vs_scatter"] = {
            "logits_equal": bool(torch.equal(lm, ls)),
            "caches_equal": all(torch.equal(cm[n], cs[n]) for n in cs)}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    dist.destroy_process_group()


# --------------------------------------------------------- the test side ----
@pytest.fixture(scope="module")
def results():
    """Every case's results on every rank: [rank] -> {case: {...}}."""
    tmp = tempfile.mkdtemp(prefix="seq_decode_")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")])
    env["OMP_NUM_THREADS"] = "1"
    store = os.path.join(tmp, "store")
    procs = []
    for rank in range(WORLD):
        code = (f"import test_torch_seq_decode as t; "
                f"t._worker({rank}, {store!r}, {tmp!r})")
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


def _per_rank(results, name):
    per_rank = [r[name] for r in results]
    for r in per_rank:
        assert "error" not in r, r["error"]
    return per_rank


@pytest.mark.parametrize("name", ["danube_ring", "deepseek_mla",
                                  "zamba2_shared", "granite_mask"])
def test_sequence_sharded_decode_matches_unsharded(results, name):
    for r in _per_rank(results, name):
        assert r["kv_seq"] == "model"
        assert r["decode_err"] < TOL, r
        assert r["tokens_equal"], r
        assert r["cache_err"] < TOL, r
        # the (L, B, S, ...) leaves: batch on data, the keys on model
        assert r["cache_placements"] == ["(Shard(dim=1), Shard(dim=2))"], r


def test_ring_wraps_across_the_two_key_ranges(results):
    """Ring 16 over two ranks of 8: the rows end past the ring (they
    wrapped) and the row of length 3 and the row of length 9 each wrote
    on both ranks."""
    arch, over, lens = CASES["danube_ring"]
    ring, half = over["sliding_window"], over["sliding_window"] // 2
    for r in _per_rank(results, "danube_ring"):
        assert r["lengths"] == [n + STEPS for n in lens]
        assert max(r["lengths"]) > ring
        for n in (9, 3):
            slots = {(n + i) % ring for i in range(STEPS)}
            assert min(slots) < half <= max(slots)


def test_kv_update_mask_and_scatter_give_the_same_bits(results):
    for r in _per_rank(results, "mask_vs_scatter"):
        assert r["logits_equal"] and r["caches_equal"], r


# ------------------------------------------- combine_partials, plain ------
@pytest.mark.parametrize("ranges", [1, 2, 3, 4])
def test_combine_partials_over_key_ranges_matches_the_whole_cache(ranges):
    """A (B, T, Hkv, D) cache cut into ``ranges`` key ranges; each range's
    output and log-sum-exp from ``flash_decode_ref`` over its own valid
    keys (a prefix of the row's), merged, against one call over the
    whole cache. Rows of length 0 (no key anywhere: zeros, no NaN), 1
    and short ones leave later ranges empty."""
    from repro_torch.kernels import ref
    from repro_torch.models.attention import combine_partials
    rs = np.random.RandomState(ranges)
    Bq, T, H, Hkv, D = 6, 48, 8, 2, 16
    q = torch.from_numpy(rs.standard_normal((Bq, H, D)).astype(np.float32))
    k = torch.from_numpy(rs.standard_normal((Bq, T, Hkv, D))
                         .astype(np.float32))
    v = torch.from_numpy(rs.standard_normal((Bq, T, Hkv, D))
                         .astype(np.float32))
    lengths = torch.tensor([0, 1, 5, 17, 40, 48], dtype=torch.int32)
    scale = D ** -0.5
    want, want_lse = ref.flash_decode_ref(q, k, v, lengths, scale=scale,
                                          return_lse=True)
    cuts = np.linspace(0, T, ranges + 1).astype(int)
    outs, lses = [], []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        n = torch.clamp(lengths - int(lo), 0, int(hi - lo))
        o, lse = ref.flash_decode_ref(q, k[:, lo:hi].contiguous(),
                                      v[:, lo:hi].contiguous(), n,
                                      scale=scale, return_lse=True)
        outs.append(o)
        lses.append(lse)
    lse = torch.stack(lses)
    if ranges > 1:
        assert bool(torch.isneginf(lse[-1, :3]).all())     # empty ranges
    got = combine_partials(torch.stack(outs), lse, lambda t: t.amax(0),
                           lambda t: t.sum(0))
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) < TOL
    assert bool((got[0] == 0).all())                 # the empty row
    # the merged log-sum-exp is the whole cache's
    merged = torch.logsumexp(lse, dim=0)
    assert torch.equal(torch.isneginf(merged), torch.isneginf(want_lse))
    live = torch.isfinite(want_lse)
    assert float((merged[live] - want_lse[live]).abs().max()) < TOL


def test_flash_decode_ref_lse_is_logsumexp_of_the_masked_scores():
    from repro_torch.kernels import ref
    rs = np.random.RandomState(7)
    Bq, T, H, Hkv, D = 3, 20, 4, 4, 8
    q = torch.from_numpy(rs.standard_normal((Bq, H, D)).astype(np.float32))
    k = torch.from_numpy(rs.standard_normal((Bq, T, Hkv, D))
                         .astype(np.float32))
    lengths = torch.tensor([20, 0, 7], dtype=torch.int32)
    active = torch.tensor([True, True, False])
    out, lse = ref.flash_decode_ref(q, k, k, lengths, scale=0.3,
                                    active=active, return_lse=True)
    plain = ref.flash_decode_ref(q, k, k, lengths, scale=0.3, active=active)
    assert torch.equal(out, plain)          # the output's bits unchanged
    s = torch.einsum("bhd,bthd->bht", q, k) * 0.3
    want = torch.logsumexp(s[0], dim=-1)
    assert float((lse[0] - want).abs().max()) < 1e-5
    assert bool(torch.isneginf(lse[1:]).all())   # length 0, inactive
