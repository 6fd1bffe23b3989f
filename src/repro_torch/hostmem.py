"""Host memory that the port owns: one arena of host RAM per part of a
demoted context.

A demote copies the engine's device state into host memory. PyTorch's
caching host allocator (``pin_memory=True``) rounds each block up and keeps
freed blocks for reuse, so what it holds is neither what a snapshot counts
nor given back when the snapshot goes. An arena is one buffer of exactly
the bytes its tensors need, each tensor a shaped, typed view of it at an
``ALIGN``-byte offset. The views share the arena's storage, so
``t.untyped_storage().nbytes()`` is the arena's size for each of them: code
that counts storages once counts each arena once.

The buffer is an anonymous private mapping of its own. For the card it is
registered with CUDA (``cudaHostRegister`` through ``torch.cuda.cudart()``,
portable to every context): page-locked, so copies between it and the
device run asynchronously at the link's rate. A registration that fails
raises, naming the bytes; nothing falls back to pageable memory or to the
caching allocator. When the last view is gone, the registration is undone
and the mapping unmapped: the RAM goes back to the OS at once, as it does
when the reference drops a snapshot's numpy arrays. On the CPU the buffer
is the same mapping, unregistered.

Copies into and out of a pinned arena run asynchronously: ``host_copy``
issues them non-blocking, so its caller synchronises the device before it
releases the sources or reads the views, and a copy out of an arena must
have landed before the arena's last view is dropped.
"""

from __future__ import annotations

import math
import mmap
import threading
from typing import Dict, List, Sequence, Tuple, Union

import torch

ALIGN = 512             # byte alignment of every view's offset in an arena
_REGISTER_PORTABLE = 1  # cudaHostRegisterPortable

_LOCK = threading.Lock()
_LIVE = {"arenas": 0, "bytes": 0, "pinned_bytes": 0}

Tree = Union[torch.Tensor, Dict[str, "Tree"]]


class _Mapping(mmap.mmap):
    """An anonymous mapping that undoes its CUDA registration before it is
    unmapped. ``torch.frombuffer`` keeps a reference to it from the
    storage of every view, so this runs when the last view is gone."""

    def __del__(self):
        nbytes, ptr = self.__dict__.get("nbytes"), self.__dict__.get("ptr")
        if ptr is not None:
            torch.cuda.cudart().cudaHostUnregister(ptr)
        if nbytes is not None:
            with _LOCK:
                _LIVE["arenas"] -= 1
                _LIVE["bytes"] -= nbytes
                if ptr is not None:
                    _LIVE["pinned_bytes"] -= nbytes


def _nbytes(shape, dtype: torch.dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def _arena_bytes(specs: Sequence[Tuple[Sequence[int], torch.dtype]]) -> int:
    """The size of an arena holding a view of each (shape, dtype): every
    view's bytes rounded up to ``ALIGN``."""
    return max(sum(-(-_nbytes(s, d) // ALIGN) * ALIGN for s, d in specs),
               ALIGN)


def _empty(specs: Sequence[Tuple[Sequence[int], torch.dtype]], *,
          pinned: bool) -> List[torch.Tensor]:
    """A view of one new arena for each (shape, dtype), in order; the
    arena page-locked for the card when ``pinned``."""
    nbytes = _arena_bytes(specs)
    # the pages are faulted in as the mapping is made (MAP_POPULATE): the
    # registration then pins pages that are there, where faulting them in
    # page by page from inside it is the slow part of pinning a large
    # arena (chip_smoke.py --demote-timing)
    buf = _Mapping(-1, nbytes, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS
                   | mmap.MAP_POPULATE)
    base = torch.frombuffer(buf, dtype=torch.uint8)
    if pinned:
        cudart = torch.cuda.cudart()
        err = cudart.cudaHostRegister(base.data_ptr(), nbytes,
                                      _REGISTER_PORTABLE)
        if int(err) != 0:
            raise RuntimeError(
                f"could not pin {nbytes} bytes of host memory for a "
                f"demoted context: {cudart.cudaGetErrorString(err)}")
        buf.ptr = base.data_ptr()
    buf.nbytes = nbytes
    with _LOCK:
        _LIVE["arenas"] += 1
        _LIVE["bytes"] += nbytes
        if pinned:
            _LIVE["pinned_bytes"] += nbytes
    views, offset = [], 0
    for shape, dtype in specs:
        n = _nbytes(shape, dtype)
        views.append(base[offset:offset + n].view(dtype).view(tuple(shape)))
        offset += -(-n // ALIGN) * ALIGN
    return views


def _leaves(tree: Tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for v in tree.values() for t in _leaves(v)]


def _like(tree: Tree, views) -> Tree:
    if isinstance(tree, torch.Tensor):
        return next(views)
    return {k: _like(v, views) for k, v in tree.items()}


def host_copy(tree: Tree, *, pinned: bool) -> Tree:
    """``tree`` (a tensor, or a dict of trees) copied into one new arena:
    the same structure, each leaf a view of the arena with its tensor's
    shape, dtype and values. Every leaf is sized before the arena is made;
    the copies are issued non-blocking when ``pinned``, so synchronise
    the sources' device before they are released or the views read."""
    leaves = _leaves(tree)
    views = _empty([(t.shape, t.dtype) for t in leaves], pinned=pinned)
    for view, t in zip(views, leaves):
        view.copy_(t, non_blocking=pinned)
    return _like(tree, iter(views))


def live() -> Dict[str, int]:
    """The arenas alive in this process: how many, their bytes, and the
    bytes of those that are page-locked."""
    with _LOCK:
        return dict(_LIVE)
