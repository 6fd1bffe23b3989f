"""Paged KV cache: fixed-size pages behind a per-slot page table.

Port of ``repro.serving.paged``. The slot cache allocates ``slots x
cache_len`` positions whether a slot holds 3 tokens or 3000; the paged pool
stores the same K/V as ``num_pages`` pages of ``page_size`` tokens, shared
by every slot through a per-slot page table::

    pool (one per k and v)       page table (device, (slots, max_pages) int32)
    (L, NP+1, P, Hkv, D)         pt[slot, j] = page holding tokens [jP, (j+1)P)
                                 unreserved columns point at the TRASH page

Logical position ``t`` of a slot lives at ``pool[:, pt[slot, t // P], t % P]``.
A slot reserves ``ceil(min(len(prompt) + max_new, cache_len) / P)`` pages
at admission (a host-side free list: decode never allocates on the device)
and releases them when it finishes, so concurrent sessions are bounded by
live tokens, not slots x capacity. The extra page at index NP (TRASH)
absorbs every masked write: padding rows of a prefill wave and decode
writes by inactive slots go there, never through a stale table row.

**Prefix sharing (copy-on-write).** Pages carry refcounts
(``PageAllocator``), and a host-side radix tree (``PrefixCache``) maps
token-id chunks at page granularity to the pages that hold their K/V. A
hit maps a slot's first table columns onto cached pages and prefills only
the unshared tail; the first write into a shared page copies it to a fresh
page first; pages held only by the cache are evicted, LRU first, when an
admission needs room.

The host logic (``pages_for``, ``PageAllocator``, ``PrefixCache``) is the
reference's, copied: the reference module imports JAX. The device helpers
work on any dict of pool leaves built by ``Transformer.init_cache(num_pages
+ 1, page_size)`` (``{"k", "v"}`` of shape (L, NP+1, P, Hkv, D), or MLA's
``{"ckv": (L, NP+1, P, R), "krope": (L, NP+1, P, dr)}``): the page axis
sits where the slot cache's slot axis is, whatever trails it. Writes are in
place (the reference returned new arrays). ``pageable`` is the reference's
test that a cache's leaves have that layout.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

Pool = Dict[str, torch.Tensor]


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to hold ``tokens`` positions (at least one)."""
    return max(1, -(-int(tokens) // int(page_size)))


class PageAllocator:
    """Host-side refcounted allocator for the shared page pool.

    Reservation happens at admission for a request's whole lifetime
    (prompt + max_new, capped at cache_len), so decode never allocates on
    the device and a megastep can never run out of pages mid-flight.

    Refcounts make pages shareable: a prefix-cache hit maps a slot onto
    already-live pages (``reserve_shared`` increfs them), the PrefixCache
    holds one reference per cached page (``incref``/``decref``), and
    ``release`` decrefs a slot's whole mapping; a page returns to the free
    list exactly when its last reference drops. Invariant (see ``check``):
    a page is on the free list iff its refcount is zero, and every refcount
    equals the number of slot mappings plus cache holds naming it.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 1 or page_size < 1:
            raise ValueError(f"bad pool shape: {num_pages} pages x "
                             f"{page_size} tokens")
        self.num_pages = num_pages
        self.page_size = page_size
        self._refs = np.zeros((num_pages,), np.int32)
        self._free: collections.deque = collections.deque(range(num_pages))
        self._owned: Dict[int, List[int]] = {}     # slot -> page ids

    # ------------------------------------------------------------- queries --
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        return self.num_pages - len(self._free)

    def pages_needed(self, total_tokens: int) -> int:
        return pages_for(total_tokens, self.page_size)

    def can_reserve(self, n: int) -> bool:
        return n <= len(self._free)

    def owned(self, slot: int) -> List[int]:
        return list(self._owned.get(slot, ()))

    def refcount(self, page: int) -> int:
        return int(self._refs[page])

    def live_ids(self) -> List[int]:
        """Every referenced page, ascending, each exactly once (snapshot
        order): shared pages appear in several slot mappings but serialize
        a single time."""
        return [int(p) for p in np.nonzero(self._refs > 0)[0]]

    # ----------------------------------------------------------- refcounts --
    def incref(self, page: int) -> None:
        if self._refs[page] <= 0:
            raise RuntimeError(f"incref of free page {page}")
        self._refs[page] += 1

    def decref(self, page: int) -> None:
        if self._refs[page] <= 0:
            raise RuntimeError(f"decref of free page {page}")
        self._refs[page] -= 1
        if self._refs[page] == 0:
            self._free.append(int(page))

    # ----------------------------------------------------------- lifecycle --
    def _take(self, n: int) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(f"pool exhausted: need {n}, "
                               f"free {len(self._free)}")
        ids = [self._free.popleft() for _ in range(n)]
        for p in ids:
            self._refs[p] = 1
        return ids

    def reserve(self, slot: int, n: int) -> List[int]:
        if slot in self._owned:
            raise RuntimeError(f"slot {slot} already holds pages")
        ids = self._take(n)
        self._owned[slot] = ids
        return ids

    def reserve_shared(self, slot: int, shared_ids: List[int],
                       n_new: int) -> List[int]:
        """Map ``slot`` onto already-live ``shared_ids`` (refcount++) plus
        ``n_new`` fresh private pages. Returns the fresh ids; the slot's
        mapping is ``shared_ids + fresh`` in table-column order."""
        if slot in self._owned:
            raise RuntimeError(f"slot {slot} already holds pages")
        fresh = self._take(n_new)
        for p in shared_ids:
            self.incref(p)
        self._owned[slot] = list(shared_ids) + fresh
        return fresh

    def cow(self, slot: int, col: int) -> Tuple[int, int]:
        """Copy-on-write bookkeeping for one table column: allocate a fresh
        page, swap it into the slot's mapping at ``col`` and drop the
        slot's reference on the shared original. Returns ``(src, dst)``;
        the caller copies the page on the device."""
        ids = self._owned[slot]
        src = ids[col]
        dst = self._take(1)[0]
        ids[col] = dst
        self.decref(src)
        return src, dst

    def release(self, slot: int) -> int:
        ids = self._owned.pop(slot, None)
        if ids is None:
            return 0
        for p in ids:
            self.decref(p)
        return len(ids)

    def reset(self) -> None:
        self._refs[:] = 0
        self._free = collections.deque(range(self.num_pages))
        self._owned = {}

    def check(self, cache_holds: Optional[Set[int]] = None) -> None:
        """Assert the refcount invariant: free + referenced == pool, the
        free list is exactly the zero-ref set, and every refcount equals
        slot mappings + cache holds naming the page. Raises AssertionError
        with the first violation."""
        counts = collections.Counter()
        for ids in self._owned.values():
            counts.update(ids)
        for p in (cache_holds or ()):
            counts[p] += 1
        free = set(self._free)
        assert len(free) == len(self._free), "free list holds duplicates"
        for p in range(self.num_pages):
            assert int(self._refs[p]) == counts.get(p, 0), (
                f"page {p}: refcount {int(self._refs[p])} != "
                f"{counts.get(p, 0)} references")
            assert (p in free) == (self._refs[p] == 0), (
                f"page {p}: free-list membership disagrees with refcount "
                f"{int(self._refs[p])}")
        assert len(free) + int(np.sum(self._refs > 0)) == self.num_pages


# ------------------------------------------------------------ prefix cache --
def _lcp(a, b) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


class _PrefixNode:
    __slots__ = ("children", "partials", "page", "last_used")

    def __init__(self, page: int = -1):
        self.children: Dict[Tuple[int, ...], "_PrefixNode"] = {}
        self.partials: Dict[Tuple[int, ...], List[int]] = {}  # [page, used]
        self.page = page
        self.last_used = 0


class PrefixCache:
    """Host-side radix tree over token-id chunks at page granularity.

    Each full ``page_size``-token chunk of a completed prompt becomes a node
    holding the pool page with that chunk's K/V; a trailing partial chunk
    becomes a ``partials`` entry on its parent. ``match`` walks the tree
    chunk by chunk and finishes with a longest-common-prefix probe of the
    terminal node's children and partials, so hits land on any shared
    page-aligned prefix plus up to one partially shared page (the COW
    boundary). The cache holds one allocator reference per cached page;
    ``evict`` reclaims LRU leaf pages whose only reference is the cache, so
    live reservations are never evicted from under a slot.
    """

    def __init__(self, page_size: int):
        self.page_size = int(page_size)
        self.root = _PrefixNode()
        self._holds: Set[int] = set()
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # ------------------------------------------------------------- queries --
    def pages(self) -> Set[int]:
        """Pages the cache currently holds a reference on."""
        return set(self._holds)

    def match(self, prompt) -> Optional[Tuple[int, List[int]]]:
        """Longest shared prefix of ``prompt``: ``(start, shared_pages)``
        where the first ``start`` tokens' K/V lives in ``shared_pages``
        (``ceil(start / P)`` of them, table-column order), or None.
        ``start`` is capped at ``len(prompt) - 1``: at least one tail token
        is always computed, so every admission yields a logit."""
        P = self.page_size
        self._clock += 1
        node = self.root
        pages: List[int] = []
        i = 0
        while i + P <= len(prompt):
            child = node.children.get(tuple(prompt[i:i + P]))
            if child is None:
                break
            child.last_used = self._clock
            pages.append(child.page)
            node = child
            i += P
        rem = tuple(prompt[i:])
        best_len, best_page, best_ent = 0, -1, None
        for key, child in node.children.items():
            l = _lcp(key, rem)
            if l > best_len:
                best_len, best_page, best_ent = l, child.page, child
        for key, ent in node.partials.items():
            l = _lcp(key, rem)
            if l > best_len:
                best_len, best_page, best_ent = l, ent[0], ent
        if best_len:
            pages.append(best_page)
            i += best_len
            if isinstance(best_ent, _PrefixNode):
                best_ent.last_used = self._clock
            else:
                best_ent[1] = self._clock
        start = min(i, len(prompt) - 1)
        if start <= 0:
            self.misses += 1
            return None
        self.hits += 1
        return start, pages[:pages_for(start, P)]

    # ------------------------------------------------------------- updates --
    def insert(self, prompt, owned_pages: List[int],
               alloc: PageAllocator) -> int:
        """Record a freshly prefilled prompt: chunk ``j`` maps to
        ``owned_pages[j]`` (the slot's table column ``j``). New entries take
        one allocator reference; chunks already cached just touch. Returns
        how many new pages the cache now holds."""
        P = self.page_size
        self._clock += 1
        node = self.root
        added = 0
        n_full = len(prompt) // P
        for j in range(min(n_full, len(owned_pages))):
            key = tuple(prompt[j * P:(j + 1) * P])
            child = node.children.get(key)
            if child is None:
                child = _PrefixNode(page=owned_pages[j])
                node.children[key] = child
                alloc.incref(child.page)
                self._holds.add(child.page)
                added += 1
            child.last_used = self._clock
            node = child
        rem = tuple(prompt[n_full * P:])
        if rem and n_full < len(owned_pages):
            ent = node.partials.get(rem)
            if ent is None:
                node.partials[rem] = [owned_pages[n_full], self._clock]
                alloc.incref(owned_pages[n_full])
                self._holds.add(owned_pages[n_full])
                added += 1
            else:
                ent[1] = self._clock
        return added

    def _leaves(self, node, acc):
        for key, child in node.children.items():
            if not child.children and not child.partials:
                acc.append((child.last_used, node, ("c", key), child.page))
            else:
                self._leaves(child, acc)
        for key, ent in node.partials.items():
            acc.append((ent[1], node, ("p", key), ent[0]))

    def evict(self, n: int, alloc: PageAllocator) -> int:
        """Reclaim up to ``n`` pages, LRU leaf entries first, touching only
        pages whose sole reference is the cache (refcount 1): a page still
        mapped by a live slot is never pulled out from under it. Evicting a
        leaf can expose its parent as the next candidate, so the scan
        repeats until satisfied or nothing reclaimable remains."""
        freed = 0
        while freed < n:
            acc: List = []
            self._leaves(self.root, acc)
            cands = [c for c in acc if alloc.refcount(c[3]) == 1]
            if not cands:
                break
            _, parent, (kind, key), page = min(cands, key=lambda c: c[0])
            if kind == "c":
                del parent.children[key]
            else:
                del parent.partials[key]
            self._holds.discard(page)
            alloc.decref(page)
            self.evictions += 1
            freed += 1
        return freed

    def forget_page(self, page: int, alloc: PageAllocator) -> bool:
        """Drop the cache's reference on one partial entry's page (the
        no-free-pages fallback of a decode-append COW: un-sharing the page
        makes the copy unnecessary). Full-chunk pages are never
        decode-written, so only partials are searched."""
        stack = [self.root]
        while stack:
            node = stack.pop()
            for key, ent in list(node.partials.items()):
                if ent[0] == page:
                    del node.partials[key]
                    self._holds.discard(page)
                    alloc.decref(page)
                    return True
            stack.extend(node.children.values())
        return False

    def stats(self) -> Dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "held_pages": len(self._holds)}


# ------------------------------------------------------------ pool helpers --
def gather_view(pages: Pool, pt: torch.Tensor) -> Pool:
    """Contiguous-equivalent view of ``n`` pages per slot: ``pt`` (B, n)
    turns each (L, NP+1, P, Hkv, D) pool into (L, B, n*P, Hkv, D), the
    slot cache's layout, so the contiguous decode math runs on it
    unchanged. A copy (the reference's was a new array too)."""
    B, n = pt.shape
    ids = pt.reshape(-1).long()
    out = {}
    for name, t in pages.items():
        v = t.index_select(1, ids)                  # (L, B*n, P, ...)
        out[name] = v.reshape((t.shape[0], B, n * t.shape[2]) + t.shape[3:])
    return out


def scatter_view(pages: Pool, view: Pool, pt: torch.Tensor,
                 valid: Optional[torch.Tensor], trash: int) -> None:
    """Write a per-slot contiguous view back into the pool, in place. Rows
    where ``valid`` is False (padding rows, free slots) scatter into the
    TRASH page instead of whatever their stale table names: live pages are
    only ever written through their owner's table."""
    B, n = pt.shape
    dest = pt.long() if valid is None else torch.where(
        valid[:, None], pt.long(), torch.full_like(pt, trash).long())
    ids = dest.reshape(-1)
    for name, t in pages.items():
        v = view[name].reshape((t.shape[0], B * n) + t.shape[2:])
        t[:, ids] = v.to(t.dtype)


def copy_pages(pages: Pool, src: torch.Tensor, dst: torch.Tensor) -> None:
    """Copy whole pages ``src[i] -> dst[i]`` in every layer, in place (the
    device half of copy-on-write). The destinations are distinct fresh
    pages, never a source of the same call."""
    src, dst = src.long(), dst.long()
    for t in pages.values():
        t[:, dst] = t[:, src]


def gather_live(pages: Pool, live_ids: torch.Tensor) -> Pool:
    """Only the live pages: (L, n_live, P, Hkv, D) per tensor. This is what
    snapshots and templates ship, each referenced page once, so their size
    scales with the context actually held."""
    ids = live_ids.long()
    return {name: t.index_select(1, ids) for name, t in pages.items()}


def scatter_live(pages: Pool, live_ids: torch.Tensor, live: Pool) -> None:
    """Inverse of ``gather_live``, in place: put snapshotted live pages back
    into a (zeroed) full pool. The page table restored beside them relinks
    every slot, shared pages aliased as they were."""
    ids = live_ids.long()
    for name, t in pages.items():
        t[:, ids] = live[name].to(t.dtype)


def pool_bytes(pages: Pool, num_pages: int) -> Dict[str, int]:
    """{"capacity_bytes", "per_page_bytes"} of a pool built with
    ``num_pages`` usable pages (+1 TRASH page in the buffers)."""
    total = sum(t.numel() * t.element_size() for t in pages.values())
    per_page = total // (num_pages + 1)
    return {"capacity_bytes": per_page * num_pages,
            "per_page_bytes": per_page}


def pageable(batch_axes: Dict[str, int], seq_axes: Dict[str, int]) -> bool:
    """True iff every cache leaf scales with cache_len and keeps its
    sequence axis right after its batch axis: the layout
    ``init_cache(num_pages + 1, page_size)`` relies on (the reference's
    ``paging.pageable``). ``batch_axes`` and ``seq_axes`` are
    ``repro_torch.serving.kvcache``'s."""
    return all(seq_axes[n] == b + 1 for n, b in batch_axes.items())
