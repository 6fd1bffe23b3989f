"""Slot-cache helpers for continuous batching.

Port of the slot-cache part of ``repro.serving.kvcache``. Every leaf of
the port's cache (``{"k", "v"}`` of shape (L, slots, cache_len, Hkv, D),
MLA's ``{"ckv", "krope"}`` of shape (L, slots, cache_len, R | dr), the
hybrid's Mamba2 states ``{"ssm", "conv_x", "conv_bc"}`` of shape (L,
slots, ...)) has the slot axis second, so the batch axis needs no
discovery (the reference's ``batch_axes``): helpers take one layer's
(slots, ...) tensor and work in place.

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
  live-token share, the rest (a recurrent state) whole.

The paged pool is ``repro_torch.serving.paged``.
"""

from __future__ import annotations

from typing import Callable, Dict, FrozenSet, Optional

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


def seq_leaves(init_cache: Callable, cache: Dict[str, torch.Tensor],
               slots: int, cache_len: int,
               dtype: Optional[torch.dtype]) -> FrozenSet[str]:
    """Names of the leaves of ``cache`` (built by ``init_cache(slots,
    cache_len, dtype)``) that have a sequence axis, found as the
    reference's ``seq_axes`` finds them: the leaves whose shape changes
    with the cache length. The second shape comes from the meta device,
    so nothing is allocated. A leaf with no sequence axis (a recurrent
    state, whatever its name) keeps its shape."""
    probe = init_cache(slots, cache_len + 1, dtype, device="meta")
    return frozenset(n for n, t in cache.items()
                     if probe[n].shape != t.shape)


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
