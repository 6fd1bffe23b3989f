"""The port's paged pool (repro_torch.serving.paged) against the JAX
package's: the host-side PageAllocator and PrefixCache driven through one
seeded random sequence of admit, COW, close and evict operations in both
packages (return values and refcounts equal after every operation), and the
device helpers against their JAX twins on numpy-seeded pools."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.serving import paged as jpaged  # noqa: E402
from repro_torch.serving import paged  # noqa: E402

# the reference's pool pytree is {"layers": (k, v)} with the page axis at 1
AXES = {"layers": (1, 1)}


def _pools(seed, L=2, NP=10, P=4, Hkv=2, D=8):
    rng = np.random.RandomState(seed)
    k = rng.standard_normal((L, NP + 1, P, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((L, NP + 1, P, Hkv, D)).astype(np.float32)
    jax_pool = {"layers": (jnp.asarray(k), jnp.asarray(v))}
    port_pool = {"k": torch.from_numpy(k.copy()),
                 "v": torch.from_numpy(v.copy())}
    return jax_pool, port_pool


def _same(jax_pool, port_pool, pages=None):
    for j, name in enumerate(("k", "v")):
        a = np.asarray(jax_pool["layers"][j])
        b = port_pool[name].numpy()
        if pages is not None:
            a, b = a[:, pages], b[:, pages]
        np.testing.assert_array_equal(a, b)


def _ops(seed, n_ops=300, P=4, pool=32):
    """One seeded sequence of pool operations, as plain data."""
    rng = np.random.RandomState(seed)
    templates = [list(rng.randint(0, 50, size=rng.randint(6, 20)))
                 for _ in range(4)]
    ops = []
    for _ in range(n_ops):
        op = rng.randint(4)
        if op == 0:
            t = templates[rng.randint(len(templates))]
            ops.append(("admit", list(t) + list(
                rng.randint(0, 50, size=rng.randint(1, 6)))))
        else:
            ops.append(({1: "cow", 2: "close", 3: "evict"}[op],
                        int(rng.randint(1 << 30))))
    return ops


def _drive(mod, ops, P=4, POOL=32):
    """Run ``ops`` through one package's PageAllocator and PrefixCache;
    returns the trace of every observable result, checking the refcount
    invariant after each operation."""
    alloc = mod.PageAllocator(POOL, P)
    cache = mod.PrefixCache(P)
    live = {}
    next_slot = 0
    trace = []
    for kind, arg in ops:
        if kind == "admit":
            prompt = arg
            n_total = mod.pages_for(len(prompt), P)
            hit = cache.match(prompt)
            start, shared = (0, []) if hit is None else hit
            n_keep = start // P
            if alloc.free_pages >= n_total - n_keep:
                fresh = alloc.reserve_shared(next_slot, shared[:n_keep],
                                             n_total - n_keep)
                added = cache.insert(prompt, alloc.owned(next_slot), alloc)
                live[next_slot] = prompt
                trace.append(("admit", hit, fresh, added))
                next_slot += 1
            else:
                trace.append(("full", hit))
        elif kind == "cow" and live:
            s = sorted(live)[arg % len(live)]
            owned = alloc.owned(s)
            col = arg % len(owned)
            if alloc.refcount(owned[col]) > 1 and alloc.free_pages:
                trace.append(("cow", alloc.cow(s, col)))
        elif kind == "close" and live:
            s = sorted(live)[arg % len(live)]
            del live[s]
            trace.append(("close", alloc.release(s)))
        elif kind == "evict":
            trace.append(("evict", cache.evict(1 + arg % 3, alloc)))
        alloc.check(cache.pages())
        trace.append(("refs", [alloc.refcount(p) for p in range(POOL)],
                      sorted(cache.pages())))
    for s in list(live):
        alloc.release(s)
    trace.append(("drained", cache.evict(POOL, alloc), alloc.free_pages,
                  cache.stats()))
    alloc.check(cache.pages())
    return trace


@pytest.mark.parametrize("seed", [7, 11, 23])
def test_allocator_and_prefix_cache_match_reference(seed):
    """Port of tests/test_prefix.py's refcount property, run through both
    packages on the same operations: every return value, every refcount
    and the cache's held pages are equal after every operation."""
    ops = _ops(seed)
    want = _drive(jpaged, ops)
    got = _drive(paged, ops)
    assert got == want
    assert any(t[0] == "cow" for t in got), "no COW happened — vacuous"
    assert any(t[0] == "admit" and t[1] is not None for t in got)
    assert got[-1][2] == 32


@pytest.mark.parametrize("case", ["full_then_partial", "partial_lcp",
                                  "forget_partials_only"])
def test_prefix_cache_unit_cases_match_reference(case):
    """tests/test_prefix.py's radix-cache cases, through both packages."""
    def run(mod):
        if case == "full_then_partial":
            alloc, c = mod.PageAllocator(8, 4), mod.PrefixCache(4)
            prompt = list(range(100, 110))
            pages = alloc.reserve(0, mod.pages_for(len(prompt), 4))
            return (c.insert(prompt, pages, alloc), c.match(prompt + [7, 8]),
                    c.match(prompt[:8] + [1, 2, 3]), c.match(list(prompt)),
                    c.match([1, 2, 3]))
        if case == "partial_lcp":
            alloc, c = mod.PageAllocator(4, 8), mod.PrefixCache(8)
            pages = alloc.reserve(0, 1)
            c.insert([5, 6, 7, 8, 9], pages, alloc)
            return c.match([5, 6, 7, 1, 2, 3]), pages
        alloc, c = mod.PageAllocator(4, 4), mod.PrefixCache(4)
        pages = alloc.reserve(0, 2)
        c.insert([1, 2, 3, 4, 5, 6], pages, alloc)
        out = (c.forget_page(pages[1], alloc), c.forget_page(pages[0], alloc))
        alloc.release(0)
        alloc.check(c.pages())
        return out, alloc.free_pages
    assert run(paged) == run(jpaged)


def test_gather_and_scatter_view_match_reference():
    jpool, tpool = _pools(0)
    pt = np.array([[3, 7, 10], [0, 10, 10]], np.int32)     # 10 is TRASH
    jv = jpaged.gather_view(jpool, jnp.asarray(pt), AXES)
    tv = paged.gather_view(tpool, torch.from_numpy(pt))
    assert tv["k"].shape == (2, 2, 12, 2, 8)
    np.testing.assert_array_equal(np.asarray(jv["layers"][0]),
                                  tv["k"].numpy())
    np.testing.assert_array_equal(np.asarray(jv["layers"][1]),
                                  tv["v"].numpy())

    rng = np.random.RandomState(1)
    new = rng.standard_normal(tv["k"].shape).astype(np.float32)
    jview = {"layers": (jnp.asarray(new), jnp.asarray(new * 2))}
    tview = {"k": torch.from_numpy(new), "v": torch.from_numpy(new * 2)}
    valid = np.array([True, False])
    jout = jpaged.scatter_view(jpool, jview, jnp.asarray(pt), AXES,
                               valid=jnp.asarray(valid), trash=10)
    paged.scatter_view(tpool, tview, torch.from_numpy(pt),
                       valid=torch.from_numpy(valid), trash=10)
    _same(jout, tpool, pages=list(range(10)))     # TRASH may differ
    # the invalid row's stale table (page 0) was not written
    np.testing.assert_array_equal(tpool["k"][:, 0].numpy(),
                                  np.asarray(jpool["layers"][0])[:, 0])


def test_copy_pages_and_live_round_trip_match_reference():
    jpool, tpool = _pools(2)
    src, dst = np.array([1, 4]), np.array([6, 2])
    jout = jpaged.copy_pages(jpool, jnp.asarray(src), jnp.asarray(dst), AXES)
    paged.copy_pages(tpool, torch.from_numpy(src), torch.from_numpy(dst))
    _same(jout, tpool)

    live = np.array([0, 2, 5, 9], np.int32)
    jl = jpaged.gather_live(jout, jnp.asarray(live), AXES)
    tl = paged.gather_live(tpool, torch.from_numpy(live))
    assert tl["k"].shape == (2, 4, 4, 2, 8)
    np.testing.assert_array_equal(np.asarray(jl["layers"][0]),
                                  tl["k"].numpy())
    jz = {"layers": tuple(jnp.zeros_like(x) for x in jout["layers"])}
    tz = {n: torch.zeros_like(t) for n, t in tpool.items()}
    jback = jpaged.scatter_live(jz, jnp.asarray(live), jl, AXES)
    paged.scatter_live(tz, torch.from_numpy(live), tl)
    _same(jback, tz)
    assert paged.pool_bytes(tpool, 10) == jpaged.pool_bytes(jout, 10)
