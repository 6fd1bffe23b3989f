"""Slot-cache helpers for continuous batching.

Port of the slot-cache part of ``repro.serving.kvcache``. Every leaf of
the port's cache (``{"k", "v"}`` of shape (L, slots, cache_len, Hkv, D),
MLA's ``{"ckv", "krope"}`` of shape (L, slots, cache_len, R | dr), the
hybrid's Mamba2 states ``{"ssm", "conv_x", "conv_bc"}`` of shape (L,
slots, ...)) has the slot axis second, so the helpers take one layer's
(slots, ...) tensor and work in place. ``batch_axes`` and ``seq_axes``
read each leaf's batch and sequence axis from the shapes of caches built
on the meta device, as the reference's functions of those names do from
abstract shapes; the engine asks them whether a cache pages
(``paging.pageable``) and which leaves ``live_bytes`` pro-rates.

* ``merge_slots`` writes a prefill wave's rows into their slots. The
  reference built a whole (slots, cache_len) wave cache and merged it; the
  port writes the wave's valid rows straight into the slot cache, so no
  second cache is ever allocated. Positions past the wave's bucket keep
  their old content (the reference zeroed them); every read masks them.
  A recurrent state has no positions: its rows are written whole.
* ``select_slots`` keeps masked rows bit for bit: the megastep's decode
  writes go through it, so free slots are untouched without the
  reference's post-loop restore of the whole cache.
* ``capacity_bytes`` is the allocated cache, what device memory pays;
  ``live_bytes`` what a snapshot of the live context would ship: the
  leaves with a sequence axis (``seq_leaves``) pro-rated by the
  live-token share, the rest (a recurrent state, or a sliding window's
  ring buffer, which does not scale with ``cache_len`` once it exceeds
  the window) whole.

The paged pool is ``repro_torch.serving.paged``.
"""

from __future__ import annotations

from typing import Callable, Dict, FrozenSet, List, Optional

import torch


def merge_slots(dst: torch.Tensor, src: torch.Tensor,
                slots: Optional[torch.Tensor] = None,
                seq: bool = True) -> None:
    """Write ``src`` (n, S, ...) into ``dst`` (B, S_cache, ...) positions
    [0, S), in place: row i goes to slot ``slots[i]`` for i < len(slots);
    rows past ``len(slots)`` are padding and are not written. With
    ``slots`` None, row i goes to slot i (the reference's whole-batch
    prefill). ``seq=False`` is for a leaf with no sequence axis (a
    recurrent state (n, ...)): each row is written whole."""
    if slots is None:
        rows = slice(0, src.shape[0])
    else:
        rows, src = slots, src[:slots.shape[0]]
    if seq:
        dst[rows, :src.shape[1]] = src.to(dst.dtype)
    else:
        dst[rows] = src.to(dst.dtype)


def select_slots(old: torch.Tensor, new: torch.Tensor,
                 active: torch.Tensor) -> torch.Tensor:
    """Per-slot select over the leading (slot) axis: rows where ``active``
    take ``new``, the rest keep ``old`` bit for bit."""
    mask = active.reshape((-1,) + (1,) * (old.dim() - 1))
    return torch.where(mask, new.to(old.dtype), old)


def capacity_bytes(cache: Dict[str, torch.Tensor]) -> int:
    """Allocated bytes of the whole cache, however much context is live."""
    return sum(t.numel() * t.element_size() for t in cache.values())


def _axes_between(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]
                  ) -> Dict[str, List[int]]:
    """Per leaf, the axes on which two caches' shapes differ."""
    return {n: [i for i, (x, y) in enumerate(zip(t.shape, b[n].shape))
                if x != y] for n, t in a.items()}


def batch_axes(init_cache: Callable, cache_len: int,
               dtype: Optional[torch.dtype]) -> Dict[str, int]:
    """Leaf name -> its batch axis, read from caches of 2 and 3 slots built
    on the meta device (the reference's ``batch_axes``)."""
    a = init_cache(2, cache_len, dtype, device="meta")
    b = init_cache(3, cache_len, dtype, device="meta")
    out = {}
    for n, diff in _axes_between(a, b).items():
        if len(diff) != 1:
            raise ValueError(f"ambiguous batch axis of {n}: "
                             f"{tuple(a[n].shape)} vs {tuple(b[n].shape)}")
        out[n] = diff[0]
    return out


def seq_axes(init_cache: Callable, batch: int, cache_len: int,
             dtype: Optional[torch.dtype]) -> Dict[str, int]:
    """Leaf name -> its cache-length axis, or -1 for a leaf that does not
    scale with ``cache_len`` (a ring buffer capped below it, a recurrent
    state), read as the reference's ``seq_axes`` reads it: caches of
    ``cache_len`` and ``cache_len - 8`` positions built on the meta device,
    and the one axis that differs, if its size is ``cache_len``."""
    if cache_len <= 8:
        raise ValueError(f"seq_axes needs cache_len > 8, got {cache_len}")
    a = init_cache(batch, cache_len, dtype, device="meta")
    b = init_cache(batch, cache_len - 8, dtype, device="meta")
    return {n: (diff[0] if len(diff) == 1
                and a[n].shape[diff[0]] == cache_len else -1)
            for n, diff in _axes_between(a, b).items()}


def seq_leaves(init_cache: Callable, cache: Dict[str, torch.Tensor],
               slots: int, cache_len: int,
               dtype: Optional[torch.dtype]) -> Optional[FrozenSet[str]]:
    """Names of the leaves of ``cache`` (built by ``init_cache(slots,
    cache_len, dtype)``) that scale with the cache length (``seq_axes``),
    or None when ``cache_len`` is too short to probe (<= 8), where the
    reference counts the whole cache as live. A leaf that keeps its shape
    (a recurrent state, whatever its name, or a ring buffer at its
    window) is not among them."""
    if cache_len <= 8:
        return None
    axes = seq_axes(init_cache, slots, cache_len, dtype)
    return frozenset(n for n in cache if axes[n] >= 0)


def live_bytes(cache: Dict[str, torch.Tensor], seq: FrozenSet[str],
               live_tokens: int, capacity_tokens: int) -> int:
    """Estimated bytes of the live context in a slot cache: each leaf named
    in ``seq`` (``seq_leaves``: K/V, MLA latents) pro-rated by
    ``live_tokens / capacity_tokens`` (capacity = slots x cache_len), each
    other leaf (a recurrent state) counted whole, as the reference's
    ``kvcache.live_bytes`` does."""
    frac = min(1.0, live_tokens / max(1, capacity_tokens))
    total = 0
    for name, t in cache.items():
        nbytes = t.numel() * t.element_size()
        total += int(nbytes * frac) if name in seq else nbytes
    return total
