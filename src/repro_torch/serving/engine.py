"""Continuously batched inference engine with fused decode megasteps.

Port of ``repro.serving.engine.InferenceEngine``. A fixed number of decode
SLOTS share one KV store allocated once; the weights, that store and the
per-slot decode state (lengths, last tokens, temperatures, active mask,
generated counts, max-new budgets, stop-token table, the RNG) live on the
device for the engine's lifetime and together form the PCM *context*.

**Admission.** ``submit`` keeps a priority queue (higher ``priority``
first, FIFO within a class). Every ``step()`` first admits queued prompts
into free slots (``admission="continuous"``; ``"drain"`` waits until no
slot is active), then runs one decode megastep. A prefill wave is bucketed
to the smallest ``prefill_buckets`` length that holds its longest prompt
and padded to the full slot count; the valid rows' K/V are written
straight into their slots or pages (the reference built a second,
transient wave cache and merged it). The wave syncs with the host once,
for the first tokens and the done flags.

**The megastep.** One megastep generates up to ``megastep=K`` tokens per
slot with every mask on the device: free and finished slots sample
nothing, advance nothing and write nothing live, and stop-token,
max-new-token and cache-overflow checks run on the device. The host syncs
once per megastep for a (slots, K) token block, per-slot produced counts
and the active mask. The loop ends on the reference's condition: when no
slot is active, or, with requests queued under continuous admission, when
a slot active at entry has stopped (so the waiting work is admitted
promptly). PyTorch runs eagerly, so after each step but the last the host
reads that one-flag condition from the device; the step count is capped
beforehand from what the host knows (the largest remaining budget of an
active slot, or the smallest when requests wait, at most K). Greedy
outputs are the same for every K and whatever shares the batch.

**Paged KV storage (``paged=True``).** The slot cache is replaced by a
pool of ``num_pages`` pages of ``page_size`` tokens behind a per-slot page
table (``repro_torch.serving.paged``). A request reserves
``ceil(min(prompt + max_new, cache_len) / page_size)`` pages at admission
(a host-side free list: decode never allocates on the device) and releases
them when it finishes, so concurrent sessions are bounded by live tokens,
not slots x cache_len. Megasteps address a column slice of the table
sized to the live page count. With kernels every decode step reads the
pages in place (the paged flash-decode kernel); without, the pages are
gathered into a contiguous view once per megastep, decoded by the slot
cache's math and scattered back once. Masked writes (padding rows, free
slots) land in the pool's TRASH page, so pages are only ever written
through their owner's table.

**Prefix sharing (``prefix_sharing=True``, paged only).** Completed
prompts enter a radix tree of page-sized token chunks; a later prompt that
shares a prefix maps its first table columns onto those pages and
prefills only its tail (the prefill kernel with per-row query offsets).
A hit that ends mid-page copies the boundary page into a fresh private
page before the tail is written, and a copy-on-write fence before each
megastep copies any shared page a decode would append into. Pages held
only by the prefix cache are evicted, LRU first, when an admission needs
room.

**Frontend inputs (``extra``).** An audio or vision model's frontend is a
stub, as in the reference: the engine takes ``extra``, a dict of
precomputed embeddings with ``slots`` rows (``frames`` or ``patches``,
``models.registry.extra_inputs``), and hands the whole of it to every
prefill wave. Wave row i reads row i of ``extra``: a request meets the
frontend row of the wave row it lands in, not a row of its own, which is
the reference's meaning, mirrored. ``extra`` lives on the device with the
rest of the context: a demote ships it, a restore brings it back, a
template carries it. The engine keeps the caller's host tensors as well:
the wire recipe carries them (base64 pickle) and ``aot_fingerprint`` a
digest of them.

**Kernels.** With ``cfg.use_kernels`` on a CUDA device, prefill and decode
attention (and the MoE GEMMs and Mamba2 scans of models that have them,
and a ``Transformer``'s prefill linears, whose rows' bits do not depend
on a wave's size) run in the hand-written kernels of
``repro_torch/csrc``; the
engine builds them at construction when they are not on disk yet, and
``stats.compiles`` counts those builds (0 for a warm context).

**Demote and restore (PCM snapshot hooks).** ``offload_device_state()``
copies the weights, the KV store, the per-slot state and the RNG state
into host memory and frees the device memory; a paged engine ships only
its live pages, each once, with their refcounts. The host copies are views
of two arenas the port owns (``repro_torch.hostmem``: page-locked on the
card, outside PyTorch's caching host allocator), one for the weights and
one for the rest, so the bytes a snapshot counts are the bytes it holds,
and dropping an arena's last view gives its RAM back at once.
``restore_device_state()`` copies them back. A restored engine decodes
bit-identically to one that never left the device, and rebuilds nothing:
the restore costs the transfer only. A model module may be shared by
several engines (a context builder that closes over one model builds
every worker's engine over it). A demote never changes a tensor another
resident engine reads: the last resident engine over a model releases its
parameters in place; any other copies them to the host as well, then
moves onto a model shell of its own (``models.registry.build_shell``) and
leaves the shared tensors to their other readers, as dropping one
reference to an immutable JAX array does in the reference. Restored, such
an engine fills its own shell: a second copy on the device. A released
model keeps the snapshot's host copies of its parameters (the same
tensors as the snapshot's ``params``, no second host copy), so a context
builder that closes over one model goes on working once every engine over
it is demoted, as the reference's does (its closure keeps the arrays): an
engine built over a released model copies them back onto the device (one
host-to-device copy) and joins the model. A demoted engine restored
while another engine is resident over its model fills a shell of its
own. While the model keeps them, the parameters' arena stays in pinned
host RAM wherever the snapshot goes (3.4 GB for SmolLM2-1.7B in bf16),
where the reference keeps its arrays on the device: a spill of the
snapshot to disk frees the other arena (KV store, per-slot state and
``extra``), not the weights', and a snapshot taken from its pool holds
them until it is restored. ``core.store.SnapshotPool`` counts them
against its host budget (the models behind its snapshots, each arena
once). A restore into the model, or an engine built over it, takes them
back onto the device and drops them, which frees the arena; so does
dropping the model. ``export_template`` (or its
two halves, ``export_template_device`` and ``export_template_host``, for
a streamed export) and ``clone_offloaded`` bootstrap a twin engine from
the weights alone. ``warm_executables`` loads every kernel library the model launches
(building it at first use), the warm-up a PCM context runs once when it
is built.

**Across processes.** ``wire_recipe()`` describes the engine as JSON (its
config and knobs, and ``aot_fingerprint``: a digest of those, the torch
and CUDA versions and the kernel libraries it loads), which
``repro_torch.core.wire`` ships in place of the object;
``engine_from_wire`` rebuilds a shell from it on the receiving process's
device, with no weights and no state until a restore lands, and counts
each kernel library it finds already built under
``stats.aot_cache_hits`` (a real build under ``stats.compiles``).
"""

from __future__ import annotations

import base64
import collections
import copy
import dataclasses
import hashlib
import json
import pickle
import sys
import threading
import time
import traceback
import weakref
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch import hostmem
from repro_torch.models.layers import cdt
from repro_torch.serving import kvcache
from repro_torch.serving import paged as paging
from repro_torch.serving.request import EngineStats, Request, RequestState
from repro_torch.serving.sampler import sample

NO_TOKEN = -1  # stop-table padding: never matches a real (>= 0) token id

_STATE_FIELDS = ("lengths", "last_tokens", "temps", "active_mask",
                 "gen_counts", "max_news", "stop_table")


# guards the resident engines of every model module (``_holders``): a
# build or a restore joins them, a demote leaves them and decides, from
# whether any remain, what to do with the module's tensors
_HOLDERS_LOCK = threading.Lock()


def _holders(model) -> "weakref.WeakSet[InferenceEngine]":
    """The resident engines over ``model``: built over it or restored into
    it, and not demoted since. Kept on the module, weakly (a dropped
    engine leaves by itself; one that a reference cycle keeps counts
    until the cycle is collected). Call under ``_HOLDERS_LOCK``."""
    held = model.__dict__.get("_engine_holders")
    if held is None:
        held = model._engine_holders = weakref.WeakSet()
    return held


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds the largest prefill bucket "
                     f"({buckets[-1]}) — prompts must never be silently "
                     f"truncated")


class InferenceEngine:
    # True for a shell rebuilt from a wire recipe (``engine_from_wire``):
    # its kernel libraries come from the build directory another process
    # filled, each counted under ``stats.aot_cache_hits``
    _aot_shared = False
    _aot_resolved: frozenset = frozenset()

    def __init__(self, model, *, device: Union[str, torch.device] = "cuda",
                 slots: int = 8, cache_len: int = 512,
                 prefill_buckets: Sequence[int] = (32, 128, 512),
                 cache_dtype: torch.dtype = torch.float32, rng_seed: int = 0,
                 megastep: int = 1, max_stop_tokens: int = 4,
                 admission: str = "continuous", paged: bool = False,
                 page_size: int = 64, num_pages: Optional[int] = None,
                 prefix_sharing: bool = True,
                 extra: Optional[Dict] = None):
        dev = devices.resolve(device)
        if admission not in ("continuous", "drain"):
            raise ValueError(f"admission must be 'continuous' or 'drain', "
                             f"got {admission!r}")
        if model.device.type != dev.type:
            raise ValueError(f"model lives on {model.device}, engine asked "
                             f"for {dev}")
        with _HOLDERS_LOCK:
            released = model.__dict__.pop("_released_params", None)
            if released is not None:
                # the demote of the last engine over it released the
                # parameters in place: bring back the snapshot's host
                # copies, which the model kept
                for n, p in model.named_parameters():
                    p.data = released[n].to(
                        dev, non_blocking=released[n].is_pinned(), copy=True)
                # the copies land before ``released`` goes, and with it
                # the arena they read
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            _holders(model).add(self)
        self.device = model.device
        self.model = model
        self.cfg = model.cfg
        self.slots = slots
        self.cache_len = cache_len
        # every admissible prompt (submit enforces len <= cache_len) gets a
        # bucket that holds it whole
        self.prefill_buckets = tuple(sorted(
            set(min(b, cache_len) for b in prefill_buckets) | {cache_len}))
        self.megastep = int(megastep)
        if self.megastep < 1:
            raise ValueError(f"megastep must be >= 1, got {megastep}")
        self.admission = admission
        self.max_stop_tokens = max_stop_tokens
        # the host copy the recipe and the fingerprint read, whether or not
        # the device copy is resident
        self._extra_host = self._check_extra(extra)
        self.extra = (None if self._extra_host is None else
                      {n: t.to(self.device)
                       for n, t in self._extra_host.items()})

        # ---- paged-vs-contiguous resolution: paged=True is a request; a
        # model with no paged decode (the hybrid's recurrent state, a
        # sliding window's ring buffers) or a cache whose leaves do not
        # page keeps the slot cache and says why, in the reference's order
        # and words
        self.page_size = int(page_size)
        if paged and self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self._paged = False
        self.paged_fallback: Optional[str] = None
        if paged:
            if getattr(model, "decode_paged", None) is None:
                self.paged_fallback = (
                    "model has no paged decode path (SSM/xLSTM state and "
                    "sliding-window ring buffers keep the slot cache)")
            elif cache_len <= 8:
                self.paged_fallback = "cache_len too small to page"
            elif not paging.pageable(
                    kvcache.batch_axes(model.init_cache, cache_len,
                                       cache_dtype),
                    kvcache.seq_axes(model.init_cache, slots, cache_len,
                                     cache_dtype)):
                self.paged_fallback = (
                    "cache leaves are not (batch, seq)-adjacent or do "
                    "not scale with cache_len")
            else:
                self._paged = True

        self.stats = EngineStats(decode_path="paged" if self._paged
                                 else "full")
        self.compile_seconds = 0.0
        if self.cfg.use_kernels and self.device.type == "cuda":
            from repro_torch.kernels import build
            info = build.build_all()
            self.stats.compiles = len(info["built"])
            self.compile_seconds = info["seconds"]

        d = self.device
        self._state_fields = _STATE_FIELDS
        if self._paged:
            # the pool is the model's own cache built at (num_pages + 1,
            # page_size): pages where the slots were, +1 TRASH page that
            # absorbs every masked write. The default num_pages matches the
            # slot cache's capacity.
            self.max_pages = -(-cache_len // self.page_size)
            self.num_pages = (int(num_pages) if num_pages is not None
                              else slots * self.max_pages)
            self.trash = self.num_pages
            self._alloc = paging.PageAllocator(self.num_pages,
                                               self.page_size)
            self.cache = model.init_cache(self.num_pages + 1, self.page_size,
                                          cache_dtype)
            self.page_table = torch.full((slots, self.max_pages), self.trash,
                                         dtype=torch.int32, device=d)
            self._state_fields = _STATE_FIELDS + ("page_table",)
            bks, b = {self.max_pages}, 1
            while b < self.max_pages:
                bks.add(b)
                b *= 2
            self._page_buckets = tuple(sorted(bks))
        else:
            self.cache = model.init_cache(slots, cache_len, cache_dtype)
            self.page_table = None
            self._seq_leaves = kvcache.seq_leaves(
                model.init_cache, self.cache, slots, cache_len, cache_dtype)
        # the K/V leaves' dtype: a hybrid's cache also holds f32 states
        self._cache_dtype = self.cache[model.cache_names[0]].dtype

        # ---- prefix sharing: a request, resolved on the paged path only.
        # It needs a model whose tail-only prefill is exact (no MoE, no
        # MLA: see Transformer.prefill_shared); the shared prefix K/V must
        # be bitwise what a whole prefill would have written (cache dtype
        # == compute dtype), and the page size must divide the plain
        # route's 1024-token attention chunk so shared and whole prefills
        # chunk at the same key positions.
        self._prefix_cache: Optional[paging.PrefixCache] = None
        self.prefix_fallback: Optional[str] = None
        if paged and prefix_sharing:
            if not self._paged:
                self.prefix_fallback = ("engine is not paged: "
                                        + (self.paged_fallback or ""))
            elif getattr(model, "prefill_shared", None) is None:
                self.prefix_fallback = (
                    "model has no shared-prefix prefill (MoE capacity "
                    "dropping and MLA recompression are "
                    "sequence-dependent; SWA does not page)")
            elif self._cache_dtype != cdt(self.cfg):
                self.prefix_fallback = (
                    "cache dtype differs from the compute dtype — shared "
                    "prefix K/V would round where a whole prefill would not")
            elif 1024 % self.page_size:
                self.prefix_fallback = (
                    f"page_size {self.page_size} does not divide the "
                    f"1024-token attention chunk")
            else:
                self._prefix_cache = paging.PrefixCache(self.page_size)
        elif paged:
            self.prefix_fallback = "disabled (prefix_sharing=False)"

        self.lengths = torch.zeros(slots, dtype=torch.int32, device=d)
        self.last_tokens = torch.zeros(slots, dtype=torch.int32, device=d)
        self.temps = torch.zeros(slots, dtype=torch.float32, device=d)
        self.active_mask = torch.zeros(slots, dtype=torch.bool, device=d)
        self.gen_counts = torch.zeros(slots, dtype=torch.int32, device=d)
        self.max_news = torch.zeros(slots, dtype=torch.int32, device=d)
        self.stop_table = torch.full((slots, max_stop_tokens), NO_TOKEN,
                                     dtype=torch.int32, device=d)
        self._gen = torch.Generator(device=d)
        self._gen.manual_seed(rng_seed)
        self._host_lengths = np.zeros((slots,), np.int64)

        self.queue: collections.deque = collections.deque()
        self.active: Dict[int, Request] = {}          # slot -> request
        self.free_slots: collections.deque = collections.deque(range(slots))

    def _check_extra(self, extra: Optional[Dict]
                     ) -> Optional[Dict[str, torch.Tensor]]:
        """``extra`` as floating tensors in host memory (the caller's own
        when they are there), after checking it is what the model's
        frontend takes (``models.registry.extra_inputs``) at ``slots``
        rows. None for none (or an empty dict)."""
        if not extra:
            return None
        from repro_torch.models.registry import extra_inputs
        want = extra_inputs(self.cfg, self.slots)
        if set(extra) != set(want):
            raise ValueError(
                f"extra holds {sorted(extra)}; {self.cfg.arch_id} (family "
                f"{self.cfg.family!r}) takes {sorted(want) or 'none'}")
        out = {}
        for name, spec in want.items():
            t = torch.as_tensor(extra[name])
            if tuple(t.shape) != tuple(spec.shape) \
                    or not t.is_floating_point():
                raise ValueError(
                    f"extra[{name!r}] is {tuple(t.shape)} {t.dtype}; the "
                    f"engine takes floating {tuple(spec.shape)}: one row "
                    f"per slot")
            out[name] = t.detach().cpu()
        return out

    # -------------------------------------------- PCM tier offload/restore --
    @property
    def offloaded(self) -> bool:
        """True while the engine's device state lives in host memory."""
        return self.cache is None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def offload_device_state(self) -> Dict:
        """Demote: copy every device-resident tensor (weights, KV store,
        per-slot decode state, ``extra``) and the RNG state to host memory
        (two arenas, ``hostmem.host_copy``: the weights' and the rest's,
        page-locked when the device is the card) and free the device
        copies. The queue, the host length shadow, the page allocator and
        prefix cache, the stats and the built kernels stay on this object;
        a later ``restore_device_state`` needs no rebuild. Offloading twice
        raises.

        A paged engine ships only its live pages, each once
        (``_paged_live_ids`` names them, ``_paged_refcounts`` carries their
        sharing for checking), so the snapshot scales with the context
        actually held."""
        if self.offloaded:
            raise RuntimeError("engine device state is already offloaded")
        params = dict(self.model.named_parameters())
        cache = self.cache
        if self._paged:
            live = np.asarray(self._alloc.live_ids(), np.int64)
            cache = paging.gather_live(
                self.cache, torch.as_tensor(live, device=self.device))
        state = {"cache": cache, "_rng": self._gen.get_state()}
        state.update((n, getattr(self, n)) for n in self._state_fields)
        if self.extra is not None:
            state["extra"] = self.extra
        pinned = self.device.type == "cuda"
        # two arenas: the parameters outlive the snapshot when the model
        # keeps them (released below); a spill or a take frees the rest
        host = {"params": hostmem.host_copy(params, pinned=pinned),
                **hostmem.host_copy(state, pinned=pinned)}
        if self._paged:
            host["_paged_live_ids"] = live
            host["_paged_refcounts"] = np.array(
                [self._alloc.refcount(int(p)) for p in live], np.int32)
            # the page axis of each gathered leaf: a spill chunks the
            # leaves along it, so every chunk boundary is a page boundary
            host["_paged_page_axes"] = {n: np.int32(1) for n in cache}
        self._sync()
        with _HOLDERS_LOCK:
            held = _holders(self.model)
            held.discard(self)
            if held:
                # another resident engine reads these tensors: leave them
                # and move onto a shell of this engine's own
                from repro_torch.models.registry import build_shell
                self.model = build_shell(self.cfg, device=self.device)
            else:
                for p in params.values():
                    p.data = torch.empty((0,), dtype=p.dtype,
                                         device=self.device)
                # a later build over the model restores these (the
                # snapshot's own tensors, not a second host copy)
                self.model._released_params = host["params"]
            self.cache = None
            self.extra = None
            for name in self._state_fields:
                setattr(self, name, None)
        return host

    def restore_device_state(self, host_state: Dict) -> None:
        """Promote: copy a state dict from ``offload_device_state`` (or
        ``export_template``) back onto the device. The restored engine
        decodes bit-identically to one that never left it. A paged engine
        rebuilds its pool around the live pages; released pages and TRASH
        come back zeroed, which no read can see (every read is
        length-masked)."""
        if not self.offloaded:
            raise RuntimeError("engine device state is already resident")
        missing = [n for n in ("params", "cache", "_rng") + self._state_fields
                   if n not in host_state]
        if self._paged and "_paged_live_ids" not in host_state:
            missing.append("_paged_live_ids")
        if self._extra_host is not None and set(
                host_state.get("extra") or ()) != set(self._extra_host):
            missing.append("extra")
        if missing:
            raise ValueError(f"snapshot is missing engine state: {missing}")
        d = self.device

        def put(t):
            # on the CPU a copy too: the engine keeps no view of the
            # snapshot's arenas
            return t.to(d, non_blocking=t.is_pinned(), copy=d.type == "cpu")

        if self._paged:
            live = np.asarray(host_state["_paged_live_ids"], np.int64)
            refs = host_state.get("_paged_refcounts")
            if refs is not None and len(refs) != live.size:
                raise ValueError(
                    f"paged snapshot refcount vector ({len(refs)}) does not "
                    f"match its live-page index ({live.size})")
        with _HOLDERS_LOCK:
            model = self.model
            if any(e is not self for e in _holders(model)):
                # an engine built over the released model since the demote
                # reads it: fill a shell of this engine's own
                from repro_torch.models.registry import build_shell
                model = build_shell(self.cfg, device=self.device)
            params = dict(model.named_parameters())
            if set(params) != set(host_state["params"]):
                raise ValueError("snapshot weights do not match the "
                                 "model's parameters")
            # the model is this engine's own shell, or the one it released
            # in place as the last engine over it, which no engine reads
            model.__dict__.pop("_released_params", None)
            for n, p in params.items():
                p.data = put(host_state["params"][n])
            self.model = model
            _holders(model).add(self)
        if self._paged:
            self.cache = self.model.init_cache(self.num_pages + 1,
                                               self.page_size,
                                               self._cache_dtype)
            if live.size:
                paging.scatter_live(
                    self.cache, torch.as_tensor(live, device=d),
                    {n: put(t) for n, t in host_state["cache"].items()})
        else:
            self.cache = {n: put(t) for n, t in host_state["cache"].items()}
        for name in self._state_fields:
            setattr(self, name, put(host_state[name]))
        if self._extra_host is not None:
            self.extra = {n: put(t) for n, t in host_state["extra"].items()}
        # a copy: ``set_state`` reads the state from the start of its
        # tensor's storage, not at a view's offset into an arena
        self._gen.set_state(host_state["_rng"].clone())
        self._sync()
        if self._aot_shared:
            # a wire shell's kernels load with its state
            self.warm_executables()

    def _require_resident(self):
        if self.offloaded:
            raise RuntimeError(
                "engine device state is offloaded (context demoted to host "
                "memory) — restore the context before use")

    # ------------------------------------------- P2P template transfer -----
    def export_template_device(self) -> Dict:
        """Device half of the template: the fields that ship verbatim from
        this engine's device memory — the weights, as device tensors (no
        host copy; a chunk-streamed export copies them to the host chunk
        by chunk between serving turns, which the weights allow because
        they never change after the build) — the RNG state and, for a
        frontend model, ``extra``."""
        self._require_resident()
        out = {"params": dict(self.model.named_parameters()),
               "_rng": self._gen.get_state()}
        if self.extra is not None:
            out["extra"] = dict(self.extra)
        return out

    def export_template_host(self) -> Dict:
        """Host half of the template: every other field of a pristine
        engine (all slots free, empty KV store), made from shapes alone
        with no copy from the device. A paged template ships no pages at
        all and an all-TRASH page table, so its size is the weights'."""
        self._require_resident()
        host: Dict = {}
        for name in ("lengths", "last_tokens", "temps", "gen_counts",
                     "max_news", "active_mask"):
            a = getattr(self, name)
            host[name] = torch.zeros(a.shape, dtype=a.dtype)
        host["stop_table"] = torch.full(self.stop_table.shape, NO_TOKEN,
                                        dtype=self.stop_table.dtype)
        if self._paged:
            host["cache"] = {n: torch.zeros((t.shape[0], 0) + t.shape[2:],
                                            dtype=t.dtype)
                             for n, t in self.cache.items()}
            host["_paged_live_ids"] = np.zeros((0,), np.int64)
            host["page_table"] = torch.full(self.page_table.shape,
                                            self.trash, dtype=torch.int32)
        else:
            host["cache"] = {n: torch.zeros(t.shape, dtype=t.dtype)
                             for n, t in self.cache.items()}
        return host

    def export_template(self) -> Dict:
        """Donor side of a peer-to-peer context bootstrap: a host copy of
        the weights and the RNG state plus the per-slot decode state of a
        pristine engine (all slots free, empty KV store), without detaching
        anything from this engine, which keeps serving. The monolithic form
        of the two halves above, held as a demote's copy is: the weights in
        one arena, the rest in another. Restored into
        ``clone_offloaded()``'s twin it decodes as a freshly built engine
        does, with no kernel build."""
        host = self.export_template_host()
        device = self.export_template_device()
        state = {n: t for n, t in host.items() if n != "_paged_live_ids"}
        state["_rng"] = device["_rng"]
        if "extra" in device:
            state["extra"] = device["extra"]
        pinned = self.device.type == "cuda"
        host.update(hostmem.host_copy(state, pinned=pinned),
                    params=hostmem.host_copy(device["params"], pinned=pinned))
        self._sync()
        return host

    def clone_offloaded(self) -> "InferenceEngine":
        """A structural twin of this engine for a peer-to-peer receiver:
        the same config and geometry, its own model shell (no weights),
        empty queues and stats, a fresh page allocator and an empty prefix
        cache (the cache indexes this engine's pool, and a receiver starts
        with an empty one), and no device state: ``offloaded`` until
        ``restore_device_state`` pushes an exported template in. The
        kernels are already built in this process, so the twin builds
        nothing."""
        from repro_torch.models.registry import build_shell
        clone = copy.copy(self)
        clone.model = build_shell(self.cfg, device=self.device)
        clone._gen = torch.Generator(device=self.device)
        clone.queue = collections.deque()
        clone.active = {}
        clone.free_slots = collections.deque(range(self.slots))
        clone._host_lengths = np.zeros_like(self._host_lengths)
        clone.stats = EngineStats(decode_path=self.stats.decode_path)
        clone.compile_seconds = 0.0
        if self._paged:
            clone._alloc = paging.PageAllocator(self.num_pages,
                                                self.page_size)
            if self._prefix_cache is not None:
                clone._prefix_cache = paging.PrefixCache(self.page_size)
        clone.cache = None
        clone.extra = None
        for name in self._state_fields:
            setattr(clone, name, None)
        return clone

    def _kernel_libraries(self) -> Tuple[str, ...]:
        """The kernel libraries (``kernels.build.SOURCES``) this engine's
        model launches: none on the CPU or without ``use_kernels``, none for
        xLSTM (its blocks are torch, as the reference's are XLA); the
        prefill kernel and the decode kernel of the engine's cache for
        dense attention (and the audio and vision models' cross-attention
        on the same two); the paged MLA decode for MLA on the paged pool
        (its prefill and slot-cache decode are torch); the grouped GEMM for
        MoE, and for a dense ``Transformer`` the prefill linear's dense
        GEMM; the SSD scan for Mamba2."""
        cfg = self.cfg
        if not (cfg.use_kernels and self.device.type == "cuda"):
            return ()
        names = []
        if cfg.attention == "mla":
            if self._paged:
                names.append("paged_mla_decode")
        elif cfg.family != "ssm":
            names += ["flash_attention", "paged_flash_decode" if self._paged
                      else "flash_decode"]
        if cfg.family == "moe":
            names.append("grouped_gemm")
        if cfg.family == "dense":
            names.append("dense_gemm")
        if cfg.family == "hybrid":
            names.append("ssd_scan")
        return tuple(names)

    def warm_executables(self) -> float:
        """Load every kernel library the model launches, building any that
        is not on disk yet (``kernels.build``; a build counts in
        ``stats.compiles``). PCM materialization calls it once per context
        so that no task pays for a load or a build; returns the seconds
        spent (about 0 when already warm). Kernels are all there is to
        prepare: PyTorch runs eagerly and captures no graphs."""
        self._require_resident()
        t0 = time.monotonic()
        names = self._kernel_libraries()
        if names:
            from repro_torch.kernels import build
            missing = [n for n in names if not build.library_path(n).exists()]
            if self._aot_shared:
                self.stats.aot_cache_hits += sum(
                    1 for n in names
                    if n not in missing and n not in self._aot_resolved)
                self._aot_resolved = self._aot_resolved | set(names)
            if missing:
                self.stats.compiles += len(build.build_all()["built"])
            for name in names:
                build.library(name)
        return time.monotonic() - t0

    # ----------------------------------------------------- wire identity ---
    def _extra_digest(self) -> Optional[str]:
        """sha256 over ``extra``'s names, shapes, dtypes and bytes (None
        without it): what the fingerprint says of the frontend inputs."""
        if self._extra_host is None:
            return None
        h = hashlib.sha256()
        for n in sorted(self._extra_host):
            t = self._extra_host[n].contiguous()
            h.update(f"{n}{tuple(t.shape)}{t.dtype}".encode())
            h.update(t.view(torch.uint8).numpy().tobytes())
        return h.hexdigest()

    def _wire_knobs(self) -> Dict:
        """Every constructor knob that shapes what the engine launches,
        and the torch, CUDA and device type it runs on."""
        return {
            "slots": self.slots, "cache_len": self.cache_len,
            "prefill_buckets": list(self.prefill_buckets),
            "cache_dtype": str(self._cache_dtype),
            "megastep": self.megastep,
            "max_stop_tokens": self.max_stop_tokens,
            "admission": self.admission,
            "paged": self._paged, "page_size": self.page_size,
            "num_pages": self.num_pages if self._paged else None,
            "prefix_sharing": self._prefix_cache is not None,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "device": self.device.type,
        }

    @property
    def aot_fingerprint(self) -> str:
        """The namespace of this engine's kernel libraries: a digest of the
        model config, the knobs (``_wire_knobs``) and the file names of
        the kernel libraries the engine loads (each carries a hash of its
        sources and flags). PyTorch ships no executable, so equal
        fingerprints mean the same libraries serve both engines: one
        process's build is the other's cache hit."""
        fp = self.__dict__.get("_aot_fp")
        if fp is None:
            from repro_torch.kernels import build
            spec = dict(self._wire_knobs(), config=self.cfg.key(),
                        extra=self._extra_digest(),
                        libraries=[build.library_path(n).name
                                   for n in self._kernel_libraries()])
            fp = hashlib.sha256(
                json.dumps(spec, sort_keys=True).encode()).hexdigest()[:16]
            self.__dict__["_aot_fp"] = fp
        return fp

    def wire_recipe(self) -> Dict:
        """The engine's wire-format identity: a JSON-serializable recipe
        (the config, the knobs and the fingerprint) and the loader a
        receiving process imports to rebuild the SHELL — the model's
        structure with no weights, no device state. ``repro_torch.core.
        wire`` ships this instead of the engine object; the weights travel
        as the snapshot's arrays and the kernels load from the receiver's
        build directory. A frontend model's ``extra`` rides as a base64
        pickle of its host copy (``extra_b64``), as in the reference."""
        rec = dict(self._wire_knobs(),
                   loader="repro_torch.serving.engine:engine_from_wire",
                   config=dataclasses.asdict(self.cfg),
                   fingerprint=self.aot_fingerprint)
        if self._extra_host is not None:
            rec["extra_b64"] = base64.b64encode(
                pickle.dumps(self._extra_host)).decode("ascii")
        return rec

    # -------------------------------------------------------------- public --
    def submit(self, req: Request) -> Request:
        if len(req.prompt) > self.cache_len:
            raise ValueError(f"prompt ({len(req.prompt)}) exceeds cache "
                             f"({self.cache_len})")
        if len(req.stop_tokens) > self.max_stop_tokens:
            raise ValueError(f"request has {len(req.stop_tokens)} stop "
                             f"tokens; engine supports at most "
                             f"{self.max_stop_tokens}")
        if any(t < 0 for t in req.stop_tokens):
            raise ValueError("stop tokens must be non-negative ids")
        if self._paged:
            need = self._alloc.pages_needed(
                min(len(req.prompt) + req.max_new_tokens, self.cache_len))
            if need > self.num_pages:
                raise ValueError(
                    f"request needs {need} pages for its whole lifetime "
                    f"(prompt {len(req.prompt)} + max_new "
                    f"{req.max_new_tokens}); the pool holds "
                    f"{self.num_pages}")
        if req.priority > 0:
            # ahead of every queued request of strictly lower priority,
            # behind equal-or-higher (FIFO within class)
            idx = next((i for i, q in enumerate(self.queue)
                        if q.priority < req.priority), len(self.queue))
            self.queue.insert(idx, req)
        else:
            self.queue.append(req)
        return req

    def has_work(self) -> bool:
        return bool(self.queue or self.active)

    def step(self) -> List[Request]:
        """Admit queued prefills into free slots, then one decode megastep
        (up to K tokens) for all active slots. Returns finished requests.
        In ``drain`` mode admission waits for the active set to empty."""
        self._require_resident()
        finished: List[Request] = []
        if self.queue and self.free_slots and (
                self.admission == "continuous" or not self.active):
            finished.extend(self._admit_wave())
        if self.active:
            finished.extend(self._megastep_wave())
        self.stats.steps += 1
        return finished

    def run_to_completion(self) -> List[Request]:
        done = []
        while self.has_work():
            done.extend(self.step())
        return done

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 32, temperature: float = 0.0
                 ) -> List[List[int]]:
        reqs = [self.submit(Request(prompt=list(p),
                                    max_new_tokens=max_new_tokens,
                                    temperature=temperature))
                for p in prompts]
        self.run_to_completion()
        return [r.generated for r in reqs]

    def cancel(self, req: Request) -> bool:
        """Withdraw a request: a queued one is removed, a running one has
        its slot freed, its pages released (shared prefix pages survive by
        their cache reference) and its device row deactivated (no host
        sync), other slots undisturbed. Returns False when the request is
        finished or unknown to this engine."""
        if req.done:
            return False
        try:
            self.queue.remove(req)
            req.state = RequestState.CANCELLED
            req.finished_time = time.monotonic()
            return True
        except ValueError:
            pass
        s = req.slot
        if s is None or self.active.get(s) is not req:
            return False
        self._require_resident()
        del self.active[s]
        self.free_slots.append(s)
        if self._paged:
            self._alloc.release(s)
        self._host_lengths[s] = 0
        self.active_mask[s] = False
        self.lengths[s] = 0
        req.state = RequestState.CANCELLED
        req.finished_time = time.monotonic()
        return True

    def drop_prefix_cache(self) -> int:
        """Evict every reclaimable prefix-cache page; return the count
        freed. Pages an active slot still maps (refcount > 1) stay cached;
        on an idle engine the cache empties entirely."""
        if self._prefix_cache is None:
            return 0
        return self._prefix_cache.evict(self._alloc.num_pages, self._alloc)

    # ------------------------------------------------------------ internal --
    def _ensure_free_pages(self, n: int) -> bool:
        """Free-list admission with prefix-cache pressure relief: when a
        reservation does not fit, evict LRU cache-only prefix pages
        (refcount 1, never a page a live slot maps) until it does or
        nothing reclaimable remains."""
        if self._alloc.can_reserve(n):
            return True
        if self._prefix_cache is not None:
            self._prefix_cache.evict(n - self._alloc.free_pages, self._alloc)
        return self._alloc.can_reserve(n)

    def _reserve_wave(self):
        """The paged admission walk: claim head-of-queue requests while a
        slot and their whole-lifetime page reservation fit, stopping at the
        first that does not (no queue-order bypass). A prefix hit reserves
        only its unshared pages and maps the shared ones. Returns (wave,
        slots, starts, pins); a pin is the shared boundary page of a hit
        that ends mid-page, referenced until the wave has copied it, so an
        eviction for a later request of this walk cannot recycle it."""
        sharing = self._prefix_cache is not None
        wave, wave_slots, starts, pins = [], [], [], []
        while self.queue and self.free_slots:
            r = self.queue[0]
            n_total = self._alloc.pages_needed(
                min(len(r.prompt) + r.max_new_tokens, self.cache_len))
            hit = (self._prefix_cache.match(r.prompt)
                   if sharing and len(r.prompt) > 1 else None)
            if hit is not None:
                start, shared = hit
                n_keep = start // self.page_size
                if not self._ensure_free_pages(n_total - n_keep):
                    break
                self.queue.popleft()
                s = self.free_slots.popleft()
                self._alloc.reserve_shared(s, shared[:n_keep],
                                           n_total - n_keep)
                pin = -1
                if start % self.page_size:
                    pin = shared[n_keep]
                    self._alloc.incref(pin)
                r.prefix_tokens = start
            else:
                if not self._ensure_free_pages(n_total):
                    break
                self.queue.popleft()
                s = self.free_slots.popleft()
                self._alloc.reserve(s, n_total)
                start, pin = 0, -1
            wave.append(r)
            wave_slots.append(s)
            starts.append(start)
            pins.append(pin)
        return wave, wave_slots, starts, pins

    @torch.no_grad()
    def _admit_wave(self) -> List[Request]:
        if self._paged:
            wave, wave_slots, wave_starts, wave_pins = self._reserve_wave()
            if not wave:
                return []
        else:
            n = min(len(self.queue), len(self.free_slots))
            wave = [self.queue.popleft() for _ in range(n)]
            wave_slots = [self.free_slots.popleft() for _ in range(n)]
            wave_starts, wave_pins = [0] * n, [-1] * n
        n = len(wave)
        # a wave with any prefix hit prefills tails only, bucketed on tail
        # length (cold rows ride along with start 0)
        shared_wave = any(wave_starts)
        bucket = _bucket(max(len(r.prompt) - st
                             for r, st in zip(wave, wave_starts)),
                         self.prefill_buckets)
        toks = np.zeros((self.slots, bucket), np.int32)
        lens = np.zeros((self.slots,), np.int32)
        starts = np.zeros((self.slots,), np.int32)
        temps = np.zeros((self.slots,), np.float32)
        max_new = np.zeros((self.slots,), np.int32)
        stops = np.full((self.slots, self.max_stop_tokens), NO_TOKEN,
                        np.int32)
        for i, r in enumerate(wave):
            tail = r.prompt[wave_starts[i]:]
            toks[i, :len(tail)] = tail
            lens[i] = len(r.prompt)
            starts[i] = wave_starts[i]
            temps[i] = r.temperature
            max_new[i] = r.max_new_tokens
            stops[i, :len(r.stop_tokens)] = r.stop_tokens
            r.state = RequestState.PREFILLING
            r.slot = wave_slots[i]

        d = self.device
        valid = torch.arange(self.slots, device=d) < n
        slot_t = torch.as_tensor(wave_slots, dtype=torch.long, device=d)
        toks_t = torch.as_tensor(toks, device=d)
        lens_t = torch.as_tensor(lens, device=d)
        temps_t = torch.as_tensor(temps, device=d)
        max_new_t = torch.as_tensor(max_new, device=d)
        stops_t = torch.as_tensor(stops, device=d)
        try:
            if self._paged:
                logits = self._paged_prefill(wave_slots, wave_starts,
                                             wave_pins, toks_t, lens_t, lens,
                                             starts, shared_wave)
            else:
                extra = {} if self.extra is None else {"extra": self.extra}
                logits = self.model.prefill(toks_t, lens_t, self.cache,
                                            slots=slot_t, **extra)
        except BaseException:
            # an admission that fails to dispatch hands back everything it
            # claimed (pages, shared references, pins, slots, queue places)
            for pin in wave_pins:
                if pin >= 0:
                    self._alloc.decref(pin)
            for r, s in zip(reversed(wave), reversed(wave_slots)):
                if self._paged:
                    self._alloc.release(s)
                self.free_slots.appendleft(s)
                r.state = RequestState.QUEUED
                r.slot = None
                r.prefix_tokens = 0
                self.queue.appendleft(r)
            raise
        first = sample(logits, self._gen, temps_t,
                       vocab_size=self.cfg.vocab_size, active=valid)
        # on-device done detection for the first token: stop token,
        # max_new_tokens == 1, or a prompt that already fills the cache
        stopped = (first[:, None] == stops_t).any(dim=1)
        row_active = valid & ~(stopped | (max_new_t <= 1)
                               | (lens_t >= self.cache_len - 1))
        self.lengths[slot_t] = lens_t[:n]
        self.last_tokens[slot_t] = first[:n]
        self.temps[slot_t] = temps_t[:n]
        self.active_mask[slot_t] = row_active[:n]
        self.gen_counts[slot_t] = 1
        self.max_news[slot_t] = max_new_t[:n]
        self.stop_table[slot_t] = stops_t[:n]

        if self._prefix_cache is not None:
            # the pins are only needed until the wave's boundary copies are
            # issued: later writes to a recycled page queue behind them
            for pin in wave_pins:
                if pin >= 0:
                    self._alloc.decref(pin)
            # record the freshly prefilled prompts: the cache takes a
            # reference, so a prefix outlives its request
            for r, s in zip(wave, wave_slots):
                self._prefix_cache.insert(r.prompt, self._alloc.owned(s),
                                          self._alloc)
            self.stats.prefix_hits += sum(1 for st in wave_starts if st)
            self.stats.prefix_tokens_reused += sum(wave_starts)
            self.stats.cow_copies += sum(1 for p in wave_pins if p >= 0)

        # one host sync per wave: the first tokens and done flags
        host = torch.stack([first[:n], row_active[:n].to(torch.int32)]).cpu()
        if any(r.keep_logits for r in wave):
            rows = logits[:n].float().cpu()
            for i, r in enumerate(wave):
                if r.keep_logits:
                    r.first_logits = rows[i]
        first_np, row_active_np = host.numpy()
        now = time.monotonic()
        done: List[Request] = []
        for i, r in enumerate(wave):
            tok = int(first_np[i])
            r.generated.append(tok)
            r.first_token_time = now
            r.state = RequestState.DECODING
            self._host_lengths[r.slot] = len(r.prompt)
            if r.on_token is not None:
                self._emit(r, tok, 0)
            if row_active_np[i]:
                self.active[r.slot] = r
            else:
                done.append(self._finish(r))
        # tail tokens are what prefill computed: the prefix hits' savings
        # show here (starts are all zero without sharing)
        self.stats.prefill_tokens += int(lens.sum()) - int(starts.sum())
        self.stats.prefill_batches += 1
        return done

    def _paged_prefill(self, wave_slots, wave_starts, wave_pins, toks_t,
                       lens_t, lens, starts, shared_wave) -> torch.Tensor:
        """Prefill one wave into the pool and point the wave's slots' table
        rows at their pages. Padding rows' tables are all TRASH. A wave
        with a prefix hit first copies each mid-page hit's shared boundary
        page whole into the row's fresh page (the copy-on-write), then
        prefills tails only over a table sliced to the wave's longest
        prompt."""
        d = self.device
        P = self.page_size
        pt = np.full((self.slots, self.max_pages), self.trash, np.int32)
        for i, s in enumerate(wave_slots):
            ids = self._alloc.owned(s)
            pt[i, :len(ids)] = ids
        pt_t = torch.as_tensor(pt, device=d)
        if shared_wave:
            cow = [(pin, int(pt[i, wave_starts[i] // P]))
                   for i, pin in enumerate(wave_pins) if pin >= 0]
            if cow:
                src, dst = zip(*cow)
                paging.copy_pages(self.cache,
                                  torch.as_tensor(src, device=d),
                                  torch.as_tensor(dst, device=d))
            ncols = paging.pages_for(int(lens.max()), P)
            logits = self.model.prefill_shared(
                toks_t, lens_t, torch.as_tensor(starts, device=d),
                self.cache, pt_t[:, :ncols])
        else:
            logits = self.model.prefill(toks_t, lens_t, self.cache,
                                        page_table=pt_t)
        n = len(wave_slots)
        self.page_table[torch.as_tensor(wave_slots, dtype=torch.long,
                                        device=d)] = pt_t[:n]
        return logits

    def _decode_cow(self):
        """Copy-on-write fence ahead of a decode megastep: any active slot
        whose next K appends would land in a page the prefix cache also
        holds (refcount > 1: its prompt's partial tail page) first gets a
        private copy; all copies and table repoints go in one batched
        device copy, with no device-to-host read. With no free page to
        copy into, the cache's claim on the page is revoked instead
        (un-share). Shared full-prefix pages never reach this: a hit maps
        them below its first private column, and appends land at or above
        it."""
        entries = []
        K = self.megastep
        for s in self.active:
            owned = self._alloc.owned(s)
            length = int(self._host_lengths[s])
            lo = length // self.page_size
            hi = min((length + K - 1) // self.page_size + 1, len(owned))
            for col in range(lo, hi):
                if self._alloc.refcount(owned[col]) <= 1:
                    continue
                if self._ensure_free_pages(1):
                    src, dst = self._alloc.cow(s, col)
                    entries.append((s, col, src, dst))
                else:
                    page = owned[col]
                    self._prefix_cache.forget_page(page, self._alloc)
                    if self._alloc.refcount(page) > 1:
                        raise RuntimeError(
                            f"page {page} is shared (refcount "
                            f"{self._alloc.refcount(page)}) in slot {s}'s "
                            f"append range but is not a cache partial — "
                            f"cannot un-share and no free page to copy into")
        if not entries:
            return
        rows, cols, src, dst = (torch.as_tensor(x, device=self.device)
                                for x in zip(*entries))
        paging.copy_pages(self.cache, src, dst)
        self.page_table[rows.long(), cols.long()] = dst.to(torch.int32)
        self.stats.cow_copies += len(entries)

    def _megastep_steps(self) -> int:
        """Decode steps of the next megastep, from host-tracked state only:
        the largest remaining budget of an active slot (max-new tokens or
        cache room), or the smallest when queued requests wait for a slot,
        capped at K."""
        rem = [min(r.max_new_tokens - len(r.generated),
                   self.cache_len - 1 - int(self._host_lengths[s]))
               for s, r in self.active.items()]
        waiting = bool(self.queue) and self.admission == "continuous"
        return max(1, min(self.megastep, min(rem) if waiting else max(rem)))

    def _decode_npages(self) -> int:
        """Smallest page-count bucket that bounds every active slot's reads
        and writes this megastep (host-tracked, no device sync): per-token
        work scales with live pages, not the table's width."""
        bound = 1 + max(
            self._host_lengths[s] + min(self.megastep,
                                        r.max_new_tokens - len(r.generated))
            for s, r in self.active.items())
        need = -(-int(bound) // self.page_size)
        for b in self._page_buckets:
            if need <= b:
                return b
        return self.max_pages

    @staticmethod
    def _keep_decoding(act: torch.Tensor, entry_active: torch.Tensor,
                       waiting: bool) -> bool:
        """The reference's loop condition, read on the host (one flag):
        some slot is active and, with requests waiting, no slot active at
        entry has stopped."""
        go = act.any()
        if waiting:  # a slot freed up for the queued work
            go = go & ~(entry_active & ~act).any()
        return bool(go)

    @torch.no_grad()
    def _megastep_wave(self) -> List[Request]:
        t0 = time.monotonic()
        if self._prefix_cache is not None:
            self._decode_cow()
        n_steps = self._megastep_steps()
        waiting = bool(self.queue) and self.admission == "continuous"
        B, K = self.slots, self.megastep
        lengths, last = self.lengths, self.last_tokens
        act, gen = self.active_mask, self.gen_counts
        entry_active = act
        if not self._paged:
            def decode(last, lengths, act):
                return self.model.decode_step(last[:, None], lengths,
                                              self.cache, active=act)
        else:
            self.stats.live_pages = self._alloc.live_pages
            pt = self.page_table[:, :self._decode_npages()]
            if self.cfg.use_kernels:
                # the kernel reads the pages in place through the table
                def decode(last, lengths, act):
                    return self.model.decode_paged(last[:, None], lengths,
                                                   self.cache, pt, act)
            else:
                # gathered once, decoded by the slot cache's math,
                # scattered back once after the loop
                view = paging.gather_view(self.cache, pt)

                def decode(last, lengths, act):
                    return self.model.decode_step(last[:, None], lengths,
                                                  view, active=act)
        block = torch.zeros((B, K), dtype=torch.int32, device=self.device)
        produced = torch.zeros(B, dtype=torch.int32, device=self.device)
        steps = 0
        for step in range(n_steps):
            if step and not self._keep_decoding(act, entry_active, waiting):
                break
            steps += 1
            logits = decode(last, lengths, act)
            toks = sample(logits, self._gen, self.temps,
                          vocab_size=self.cfg.vocab_size, active=act,
                          fallback=last)
            lengths = torch.where(act, lengths + 1, lengths)
            gen = torch.where(act, gen + 1, gen)
            block[:, step] = torch.where(act, toks, 0)
            produced += act.to(torch.int32)
            stopped = (toks[:, None] == self.stop_table).any(dim=1)
            act = act & ~(stopped | (gen >= self.max_news)
                          | (lengths >= self.cache_len - 1))
            last = toks
        if self._paged and not self.cfg.use_kernels:
            # rows inactive at entry (free slots, stale tables) land in
            # TRASH; active rows write back exactly their own pages
            paging.scatter_view(self.cache, view, pt, valid=entry_active,
                                trash=self.trash)
        # zero finished/free slots' lengths: later megasteps attend over a
        # single masked position for them (admission rewrites lengths; the
        # host tracks real lengths in its shadow)
        self.lengths = torch.where(act, lengths, 0)
        self.last_tokens, self.active_mask, self.gen_counts = last, act, gen
        self.stats.decode_steps += steps

        # the single host sync for up to K tokens across all slots
        host = torch.cat([block, produced[:, None],
                          act[:, None].to(torch.int32)], dim=1).cpu().numpy()
        block_np, produced_np, active_np = host[:, :K], host[:, K], host[:, K + 1]
        now = time.monotonic()
        done: List[Request] = []
        for s, r in list(self.active.items()):
            k = int(produced_np[s])
            if k:
                base = len(r.generated)
                toks_s = [int(t) for t in block_np[s, :k]]
                r.generated.extend(toks_s)
                if r.on_token is not None:
                    for j, t in enumerate(toks_s):
                        self._emit(r, t, base + j)
            if not active_np[s]:
                del self.active[s]
                done.append(self._finish(r, now))
        self._host_lengths += produced_np
        self.stats.decode_tokens += int(produced_np.sum())
        self.stats.megasteps += 1
        self.stats.decode_seconds += time.monotonic() - t0
        return done

    def _emit(self, r: Request, token: int, index: int):
        """Fire a request's streaming callback; a raising callback is
        reported and dropped (the stream breaks, not the engine)."""
        try:
            r.on_token(r, token, index)
        except BaseException:
            print(f"on_token callback failed for request {r.request_id}:",
                  file=sys.stderr)
            traceback.print_exc(file=sys.stderr)

    def _finish(self, r: Request, now: Optional[float] = None) -> Request:
        r.state = RequestState.DONE
        r.finished_time = now if now is not None else time.monotonic()
        self.free_slots.append(r.slot)
        if self._paged:
            # the pages go back to the pool now; the slot's stale table row
            # is harmless (reads are length-masked, writes by inactive
            # slots go to TRASH) and is rewritten at re-admission
            self._alloc.release(r.slot)
        self.stats.completed += 1
        return r

    def snapshot(self) -> Dict:
        """Engine-state summary. ``capacity_bytes`` is the allocated KV
        store (what device memory pays), ``live_bytes`` what a snapshot
        would ship: the exact live pages on the paged path; on the slot
        cache the sequence leaves pro-rated by the active slots'
        host-tracked lengths and the recurrent states whole."""
        if self.offloaded:
            cap = live = 0
        elif self._paged:
            pb = paging.pool_bytes(self.cache, self.num_pages)
            cap = pb["capacity_bytes"]
            live = pb["per_page_bytes"] * self._alloc.live_pages
        else:
            cap = kvcache.capacity_bytes(self.cache)
            live_tokens = sum(int(self._host_lengths[s])
                              for s in self.active)
            live = cap if self._seq_leaves is None else kvcache.live_bytes(
                self.cache, self._seq_leaves, live_tokens,
                self.slots * self.cache_len)
        return {
            "active": len(self.active), "queued": len(self.queue),
            "free_slots": len(self.free_slots),
            "admission": self.admission,
            "offloaded": self.offloaded,
            "cache_bytes": cap,
            "capacity_bytes": cap,
            "live_bytes": live,
            "decode_path": self.stats.decode_path,
            "live_pages": self._alloc.live_pages if self._paged else 0,
            "free_pages": self._alloc.free_pages if self._paged else 0,
            "paged_fallback": self.paged_fallback,
            "prefix_fallback": self.prefix_fallback,
            "extra": (None if self._extra_host is None else
                      {n: list(t.shape)
                       for n, t in self._extra_host.items()}),
            "prefix_cache": (self._prefix_cache.stats()
                             if self._prefix_cache is not None else None),
            "compile_seconds": self.compile_seconds,
            "stats": self.stats.as_dict(),
        }


def engine_from_wire(rec: Dict, device: Optional[Union[str, torch.device]]
                     = None) -> "InferenceEngine":
    """Rebuild an engine SHELL from a :meth:`InferenceEngine.wire_recipe`
    in THIS process, on ``device`` (the receiving node's; default the
    sender's device type): the model's structure from its config with
    empty parameters, the engine constructed with the knobs the donor
    recorded, then stripped of device state (``offloaded`` until a
    restore lands) and marked ``_aot_shared``: when its state arrives it
    loads its kernel libraries, each found already built counted under
    ``stats.aot_cache_hits`` and only a real ``nvcc`` run under
    ``stats.compiles``. No model object, parameter or kernel crosses the
    wire inside the recipe; a frontend model's ``extra`` does
    (``extra_b64``), and its device copy arrives with the restore, as the
    rest of the device state does."""
    from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                          SSMConfig)
    from repro_torch.models.registry import build_shell
    d = dict(rec["config"])
    d["moe"] = MoEConfig(**d["moe"])
    d["mla"] = MLAConfig(**d["mla"])
    d["ssm"] = SSMConfig(**d["ssm"])
    cfg = ModelConfig(**d)
    dev = devices.resolve(device if device is not None else rec["device"])
    num_pages = rec.get("num_pages")
    eng = InferenceEngine(
        build_shell(cfg, device=dev), device=dev,
        slots=int(rec["slots"]), cache_len=int(rec["cache_len"]),
        prefill_buckets=tuple(rec["prefill_buckets"]),
        cache_dtype=getattr(torch, rec["cache_dtype"].split(".")[-1]),
        megastep=int(rec["megastep"]),
        max_stop_tokens=int(rec["max_stop_tokens"]),
        admission=rec.get("admission", "continuous"),
        paged=bool(rec.get("paged", False)),
        page_size=int(rec.get("page_size", 64)),
        num_pages=int(num_pages) if num_pages is not None else None,
        prefix_sharing=bool(rec.get("prefix_sharing", True)))
    # the host copy only: the device copy arrives with the restore
    if rec.get("extra_b64"):
        eng._extra_host = eng._check_extra(
            pickle.loads(base64.b64decode(rec["extra_b64"])))
    eng.cache = None
    for name in eng._state_fields:
        setattr(eng, name, None)
    eng._aot_shared = True
    return eng
