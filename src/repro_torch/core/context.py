"""Context recipes, materialized contexts and context snapshots — the
paper's first-class entity through its whole residency lifecycle.

A *recipe* is everything needed to (re)build an LLM context anywhere in the
cluster: the constructor function, its inputs, the software environment, and
the byte footprint of each stage (shared-FS artifact -> local disk -> host
RAM -> device HBM). A *context* is one materialization of a recipe on one
worker; the Library holds it across task executions (full-context mode).

A *snapshot* (:class:`ContextSnapshot`) is a demoted context: the device-
resident state (weights, KV cache, per-slot decode state, RNG) copied to
host memory (the engine's two ``hostmem`` arenas, page-locked on the
card), with the built kernels and every host-side
structure retained on the engine object. Snapshots can spill further to
local disk through ``repro_torch.checkpoint.io`` and are promoted back
with ``restore_context`` — no builder call, no kernel build,
bit-identical state.

Recipes hash stably (``key()``), so the scheduler, stores, and transfer
planner all agree on identity without shipping the payload around; the
same plain fields give the same key in this package and in the JAX
reference (``repro.core.context``).

Port of ``repro.core.context``: trees are flattened by
``checkpoint.io.tree_flatten`` (the reference's path names), a spilled
snapshot keeps ``checkpoint.io.LeafSpec`` records where the reference
keeps ``jax.ShapeDtypeStruct``, and promotion copies to the engine's
device and synchronizes it before ``restore_seconds`` is read.
"""

from __future__ import annotations

import hashlib
import json
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import io as ckio

GB = 1024 ** 3


def _arg_token(x: Any) -> str:
    """Stable identity token for a builder argument. ``repr`` alone is not
    enough: arrays and tensors truncate their repr (distinct arrays would
    collide), so array-likes hash their bytes — a tensor's on the host, a
    bf16 one through its 2-byte view, so a tensor hashes as the numpy
    array of the same values and dtype does. Objects with default reprs
    (memory addresses) stay distinct per object — conservative: logically
    equal but distinct objects rebuild rather than alias."""
    if isinstance(x, (str, int, float, bool, bytes, type(None))):
        return repr(x)
    if isinstance(x, (tuple, list)):
        return "[" + ",".join(_arg_token(i) for i in x) + "]"
    if isinstance(x, dict):
        items = sorted(x.items(), key=lambda kv: repr(kv[0]))
        return "{" + ",".join(f"{_arg_token(k)}:{_arg_token(v)}"
                              for k, v in items) + "}"
    if isinstance(x, torch.Tensor):
        arr = ckio.to_numpy(x)
        digest = hashlib.sha256(arr.tobytes()).hexdigest()[:16]
        return f"array{arr.shape}:{ckio.dtype_name(x)}:{digest}"
    if hasattr(x, "__array__") and hasattr(x, "shape"):   # numpy array
        arr = np.asarray(x)
        digest = hashlib.sha256(arr.tobytes()).hexdigest()[:16]
        return f"array{arr.shape}:{arr.dtype}:{digest}"
    return f"{type(x).__qualname__}:{repr(x)}"


@dataclass(frozen=True)
class ContextRecipe:
    """Declarative description of an LLM context.

    ``builder`` runs ONCE per worker (the paper's ``load_model``); its return
    value is held by the Library and handed to every invocation. Footprints
    default to the paper's measured SmolLM2 numbers (3.7 GB model artifact,
    7.4 GB loaded, 10.5 GB conda env).
    """

    name: str
    builder: Optional[Callable[..., Any]] = None
    builder_args: Tuple = ()
    builder_kwargs: Tuple = ()                  # tuple of (k, v) pairs
    model_key: str = ""                         # ModelConfig.key() if any
    artifact_bytes: int = int(3.7 * GB)         # shared-FS model payload
    env_bytes: int = int(10.5 * GB)             # software deps payload
    host_bytes: int = int(7.4 * GB)             # resident host RAM
    device_bytes: int = int(3.7 * GB)           # resident HBM
    version: int = 0

    def key(self) -> str:
        # cached: the scheduler recomputes keys in per-dispatch hot loops
        cached = self.__dict__.get("_key")
        if cached is not None:
            return cached
        ident = {
            "name": self.name, "model_key": self.model_key,
            "artifact": self.artifact_bytes, "env": self.env_bytes,
            "version": self.version,
            "builder": getattr(self.builder, "__qualname__", str(self.builder)),
            # same builder with different inputs is a DIFFERENT context
            "args": _arg_token(self.builder_args),
            "kwargs": _arg_token(self.builder_kwargs),
        }
        blob = json.dumps(ident, sort_keys=True)
        key = hashlib.sha256(blob.encode()).hexdigest()[:16]
        object.__setattr__(self, "_key", key)
        return key

    @property
    def transfer_bytes(self) -> int:
        """Bytes pulled when bootstrapping a cold worker (artifact + env)."""
        return self.artifact_bytes + self.env_bytes

    def with_builder(self, builder, *args, **kwargs) -> "ContextRecipe":
        import dataclasses as dc
        return dc.replace(self, builder=builder, builder_args=args,
                          builder_kwargs=tuple(sorted(kwargs.items())))


@dataclass
class Context:
    """A materialized recipe living on one worker. ``aot_seconds`` is the
    kernel-library load (and build, at first use) inside the build."""

    recipe: ContextRecipe
    value: Any = None
    worker_id: str = ""
    created_at: float = field(default_factory=time.monotonic)
    build_seconds: float = 0.0
    aot_seconds: float = 0.0       # AOT executable warm-up inside the build
    uses: int = 0
    last_used: float = field(default_factory=time.monotonic)
    restored: bool = False         # promoted from a snapshot, not built
    restore_seconds: float = 0.0   # real promotion cost when restored
    # per-stage (disk/h2d) split of a streamed restore, {stage: [bytes,
    # seconds]} — feeds TransferPlanner.observe_stage calibration
    stage_seconds: Dict[str, list] = field(default_factory=dict)

    @property
    def key(self) -> str:
        return self.recipe.key()

    def touch(self):
        self.uses += 1
        self.last_used = time.monotonic()


def _reachable(value: Any):
    """The context value plus one level of dict/list/tuple containers —
    the shapes context builders actually return."""
    items = [value]
    if isinstance(value, dict):
        items += list(value.values())
    elif isinstance(value, (list, tuple)):
        items += list(value)
    return items


def _warmable(value: Any):
    """Yield warmable engines reachable from a context value.

    Duck-typed (``warm_executables``) so core never imports the serving
    layer."""
    for v in _reachable(value):
        if callable(getattr(v, "warm_executables", None)):
            yield v


def _offloadable(value: Any):
    """Yield objects reachable from a context value that support physical
    device<->host state movement (duck-typed ``offload_device_state`` /
    ``restore_device_state`` — e.g.
    :class:`repro_torch.serving.InferenceEngine`).
    Deterministic order: demote and restore walk the same sequence."""
    for v in _reachable(value):
        if callable(getattr(v, "offload_device_state", None)) and \
                callable(getattr(v, "restore_device_state", None)):
            yield v


def materialize(recipe: ContextRecipe, worker_id: str = "local") -> Context:
    """Run the builder (the one-time expensive startup) and wrap it.

    Materialization also warms any inference engines the builder returned
    (``warm_executables``: every kernel library the engine's model runs,
    built at first use and loaded), so the kernels are part of the
    resident context and every task against a warm context builds
    nothing — the paper's full-context amortization extended down to the
    kernel level."""
    t0 = time.monotonic()
    value = None
    if recipe.builder is not None:
        value = recipe.builder(*recipe.builder_args,
                               **dict(recipe.builder_kwargs))
    aot = 0.0
    for engine in _warmable(value):
        aot += engine.warm_executables()
    return Context(recipe=recipe, value=value, worker_id=worker_id,
                   build_seconds=time.monotonic() - t0, aot_seconds=aot)


# ----------------------------------------------------------- snapshots -----
def _tree_nbytes(tree: Any) -> int:
    """The host bytes a tree holds: each tensor storage once, by its size
    (the views of one ``hostmem`` arena count the arena once, alignment
    included), and every other leaf with ``nbytes`` by it."""
    total = 0
    storages = set()
    for leaf in _tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            storage = leaf.untyped_storage()
            if storage.data_ptr() not in storages:
                storages.add(storage.data_ptr())
                total += storage.nbytes()
        elif hasattr(leaf, "nbytes"):
            total += int(leaf.nbytes)
    return total


def _tree_leaves(tree: Any):
    return ckio.tree_leaves(tree)


@dataclass
class ContextSnapshot:
    """A demoted context: the materialized value with its device state
    pulled off the accelerator.

    ``value`` is the builder's return object (engine instances, tokenizers,
    plain dicts) with every offloadable component's device tensors REMOVED
    — the built kernels stay loaded and the host-side structures stay on
    those components, which is what makes promotion build-free.
    ``host_state`` maps component index -> host tree of that component's
    device state (pinned CPU tensors); for values with no offloadable
    components the value itself IS the (host) state and ``host_state`` is
    empty.

    Lifecycle::

        snapshot_context(ctx)   DEVICE    -> HOST_RAM   (copy to pinned host)
        snap.spill(store)       HOST_RAM  -> LOCAL_DISK (checkpoint/io npz)
        snap.unspill(store)     LOCAL_DISK-> HOST_RAM   (npz load)
        restore_context(snap)   HOST_RAM  -> DEVICE     (copy to the device)

    A snapshot is single-owner: restoring it moves the value object to the
    restoring worker (see ``repro_torch.core.store.SnapshotPool.take``).
    """

    recipe: ContextRecipe
    value: Any
    host_state: Dict[str, Any]
    nbytes: int
    build_seconds: float = 0.0
    aot_seconds: float = 0.0
    spilled: bool = False            # arrays currently on LOCAL_DISK
    spill_key: str = ""
    created_at: float = field(default_factory=time.monotonic)
    last_used: float = field(default_factory=time.monotonic)
    demote_seconds: float = 0.0

    @property
    def key(self) -> str:
        return self.recipe.key()

    @property
    def tier(self) -> int:
        """1 == Tier.LOCAL_DISK, 2 == Tier.HOST_RAM (int values match the
        ``repro_torch.core.store.Tier`` IntEnum; typed as int to avoid a
        circular import)."""
        return 1 if self.spilled else 2

    # ----------------------------------------------------------- spilling --
    def spill(self, spill_store, chunk_bytes: int = 64 << 20) -> str:
        """Write the host tensors to local disk (atomic npz + manifest via
        ``repro_torch.checkpoint.io``) and release the host RAM copy. A
        shape/dtype skeleton (``LeafSpec`` leaves) stays in RAM so
        ``unspill`` can rebuild the exact tree, each leaf a tensor or an
        array as it was."""
        if self.spilled:
            return self.spill_key
        import uuid
        # generation-unique path: two snapshots of the SAME context can be
        # in flight concurrently (e.g. demote on two workers) — sharing a
        # directory would let the loser's discard delete the winner's data
        self.spill_key = f"ctx_{self.key}_{uuid.uuid4().hex[:8]}"
        # paged-KV components (their offload dict carries the live-page
        # index) stream their cache leaves through checkpoint/io in
        # PAGE-ALIGNED chunks: each gathered leaf is sliced along its own
        # page axis (``_paged_page_axes``, a pytree of ints mirroring the
        # cache) in whole-page groups, so every chunk boundary is a page
        # boundary — integrity (per-chunk sha256) and partial reads
        # (io.load_chunks) address whole pages, never splitting one
        chunk_rows: dict = {}
        for name, comp in self.host_state.items():
            if not (isinstance(comp, dict) and "_paged_live_ids" in comp):
                continue
            axes = comp.get("_paged_page_axes")
            if axes is None:                    # pre-axis snapshots
                chunk_rows[f"{name}/cache"] = 8
                continue
            for key, ax in ckio._flatten({"cache": axes}).items():
                chunk_rows[f"{name}/{key}"] = {"rows": 8, "axis": int(ax)}
        # every remaining large leaf (the weights) chunks too — per-chunk
        # sha256, so a streamed restore verifies entry-by-entry instead of
        # re-hashing the whole payload file, and a corrupt chunk is
        # addressable without discarding the rest
        for key, spec in ckio.plan_chunk_rows(self.host_state,
                                              chunk_bytes).items():
            if not any(key == p or key.startswith(p + "/")
                       for p in chunk_rows):
                chunk_rows[key] = spec
        spill_store.save(self.spill_key, self.host_state,
                         meta={"context_key": self.key,
                               "recipe": self.recipe.name},
                         chunk_rows=chunk_rows or None)
        self._skeleton = ckio.tree_map(
            lambda a: ckio.LeafSpec(tuple(a.shape), a.dtype)
            if hasattr(a, "shape") else a, self.host_state)
        self.host_state = {}
        self.spilled = True
        return self.spill_key

    def unspill(self, spill_store):
        """Read the arrays back LOCAL_DISK -> HOST_RAM and delete the disk
        copy: snapshots are single-owner, so promotion CONSUMES the spill
        (leaving it would leak one GB-scale npz directory per
        demote-to-disk/restore cycle)."""
        if not self.spilled:
            return
        self.host_state, _ = spill_store.load(self.spill_key,
                                              like=self._skeleton)
        spill_store.delete(self.spill_key)
        self.spill_key = ""
        self._skeleton = None
        self.spilled = False

    def discard(self, spill_store):
        """Drop the on-disk copy (pool eviction of a spilled snapshot)."""
        if self.spilled and self.spill_key:
            spill_store.delete(self.spill_key)


class PeerExportError(RuntimeError):
    """The context value holds a device-stateful component that cannot be
    cloned for a peer transfer (no ``clone_offloaded``/``export_template``
    hooks) — the receiver must fall back down the fetch ladder."""


def _clone_item(v: Any) -> Any:
    """Clone one reachable component for a peer transfer. Device-stateful
    components must provide the transfer duck-type (``clone_offloaded`` —
    a structural twin sharing the built kernels, device state detached —
    plus ``export_template``); plain host objects are deep-copied."""
    if callable(getattr(v, "clone_offloaded", None)) and \
            callable(getattr(v, "export_template", None)):
        return v.clone_offloaded()
    if callable(getattr(v, "offload_device_state", None)):
        raise PeerExportError(
            f"{type(v).__qualname__} is device-stateful but does not "
            "support peer transfer (clone_offloaded/export_template)")
    import copy
    return copy.deepcopy(v)


def _exportable(value: Any):
    """Donor components whose template state ships in the transfer.

    Membership is ``_offloadable`` AND the transfer hooks: the receiver's
    ``restore_context`` feeds ``host_state`` by index over the clone's
    ``_offloadable`` walk, so the two enumerations must agree exactly — a
    component with export hooks but no offload/restore hooks is cloned
    (``_clone_item``) but ships no template, matching the restore side
    that would never touch it."""
    for v in _offloadable(value):
        if callable(getattr(v, "export_template", None)) and \
                callable(getattr(v, "clone_offloaded", None)):
            yield v


def export_context(ctx: Context) -> ContextSnapshot:
    """Donor side of a peer-to-peer context bootstrap (FetchSource.PEER).

    Unlike :func:`snapshot_context` (demotion — destructive, the donor
    loses its device state), export builds a TEMPLATE copy while the donor
    keeps serving: each device-stateful component contributes a pristine
    host-side template (weights copied to host tensors, per-slot decode
    state blank) via ``export_template``, and the snapshot's value is a
    structural clone (``clone_offloaded``) that SHARES the donor's built
    kernels in-process — which is why the receiver's restore performs
    zero builder calls and zero kernel builds. Plain host components
    (tokenizers, configs) are deep-copied.

    Raises :class:`PeerExportError` when a device-stateful component lacks
    the transfer hooks; callers fall back down the fetch ladder."""
    t0 = time.monotonic()
    value = ctx.value
    if isinstance(value, dict):
        clone = {k: _clone_item(v) for k, v in value.items()}
    elif isinstance(value, (list, tuple)):
        clone = type(value)(_clone_item(v) for v in value)
    else:
        clone = _clone_item(value)
    host_state: Dict[str, Any] = {}
    for i, comp in enumerate(_exportable(value)):
        host_state[f"c{i}"] = comp.export_template()
    nbytes = _tree_nbytes(host_state) if host_state \
        else ctx.recipe.host_bytes
    return ContextSnapshot(recipe=ctx.recipe, value=clone,
                           host_state=host_state, nbytes=nbytes,
                           build_seconds=ctx.build_seconds,
                           aot_seconds=ctx.aot_seconds,
                           demote_seconds=time.monotonic() - t0)


def stripe_export_state(ctx: Context) -> Dict[str, Any]:
    """Device halves of every exportable component that supports the split
    export hooks — DEVICE tensors, no host copy. This is the tree a
    streamed (chunked) export plans over: params never mutate during
    serving, so per-chunk host copies interleaved with decode work read a
    coherent payload."""
    device: Dict[str, Any] = {}
    for i, comp in enumerate(_exportable(ctx.value)):
        fn = getattr(comp, "export_template_device", None)
        if callable(fn):
            device[f"c{i}"] = fn()
    return device


def stripe_export_template(ctx: Context):
    """Metadata half of a streamed export: the structural clone (shares
    the donor's built kernels in-process) plus each component's
    synthesized host half. Components lacking the split hooks ship their
    WHOLE template in the host half (monolithic for that component only —
    one host copy), so streamed transfers degrade gracefully to
    :func:`export_context` semantics. Returns ``(clone, host_halves,
    host_nbytes)``; add the device-half plan's total for the full template
    size. Raises :class:`PeerExportError` exactly where
    :func:`export_context` would."""
    value = ctx.value
    if isinstance(value, dict):
        clone = {k: _clone_item(v) for k, v in value.items()}
    elif isinstance(value, (list, tuple)):
        clone = type(value)(_clone_item(v) for v in value)
    else:
        clone = _clone_item(value)
    host_halves: Dict[str, Any] = {}
    for i, comp in enumerate(_exportable(value)):
        if callable(getattr(comp, "export_template_device", None)) and \
                callable(getattr(comp, "export_template_host", None)):
            host_halves[f"c{i}"] = comp.export_template_host()
        else:
            host_halves[f"c{i}"] = comp.export_template()
    return clone, host_halves, _tree_nbytes(host_halves)


def snapshot_context(ctx: Context) -> ContextSnapshot:
    """Demote DEVICE -> HOST_RAM: copy every offloadable component's device
    state to (pinned) host tensors (``offload_device_state``, which waits
    for the copies) and detach it from the accelerator. The value object
    (with its built kernels) rides along as host metadata; values with no
    offloadable components (plain host objects) snapshot as-is."""
    t0 = time.monotonic()
    host_state: Dict[str, Any] = {}
    for i, comp in enumerate(_offloadable(ctx.value)):
        host_state[f"c{i}"] = comp.offload_device_state()
    nbytes = _tree_nbytes(host_state) if host_state \
        else ctx.recipe.host_bytes
    return ContextSnapshot(recipe=ctx.recipe, value=ctx.value,
                           host_state=host_state, nbytes=nbytes,
                           build_seconds=ctx.build_seconds,
                           aot_seconds=ctx.aot_seconds,
                           demote_seconds=time.monotonic() - t0)


def _component_devices(value: Any) -> Dict[str, torch.device]:
    """``{"c{i}": device}`` of each offloadable component that names a
    non-CPU device: where a streamed restore puts that component's large
    tensors."""
    out = {}
    for i, comp in enumerate(_offloadable(value)):
        dev = getattr(comp, "device", None)
        if isinstance(dev, torch.device) and dev.type != "cpu":
            out[f"c{i}"] = dev
    return out


def _sync_devices(devices) -> None:
    for dev in set(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _streamed_unspill(snap: ContextSnapshot, spill_store,
                      stage_seconds: Dict[str, list]):
    """LOCAL_DISK -> DEVICE without materializing the whole host snapshot:
    a reader thread does pure disk IO (raw npz chunks, no hashing — the
    whole-file sha pass is skipped entirely) while this thread verifies
    each chunk's manifest digest, concatenates completed leaves and copies
    each large tensor leaf to its component's device, so verify/assembly/
    h2d of chunk *i* overlap the disk read of chunk *i+1*. Small leaves
    and numpy leaves stay on the host; a tensor already on the device
    passes through ``restore_device_state`` downstream unchanged. Consumes
    the spill like ``unspill``. Corrupt chunks raise
    ``ChunkCorruptionError`` from this thread, naming the entry."""
    import queue as _queue
    import threading

    directory = spill_store.path(snap.spill_key)
    fifo: _queue.Queue = _queue.Queue(maxsize=4)
    fail: list = []

    def _reader():
        t0 = time.monotonic()
        nbytes = 0
        try:
            for item in ckio.iter_raw_chunks(directory):
                nbytes += int(item[4].numel() * item[4].element_size())
                fifo.put(item)
        except BaseException as exc:            # surface on the main thread
            fail.append(exc)
        finally:
            stage_seconds["disk"] = [nbytes, time.monotonic() - t0]
            fifo.put(None)

    pairs, structure = ckio.tree_flatten(snap._skeleton)
    specs = dict(pairs)
    devices = _component_devices(snap.value)
    reader = threading.Thread(target=_reader, daemon=True,
                              name="pcm-unspill-reader")
    reader.start()
    flat: Dict[str, Any] = {}
    parts: list = []
    corrupt = None
    t_h2d = 0.0
    h2d_bytes = 0
    while True:
        item = fifo.get()
        if item is None:
            break
        if corrupt is not None:
            continue              # drain so the reader can finish and exit
        key, index, count, axis, arr, want = item
        try:
            ckio.verify_chunk(key, index, arr, want, where=directory)
        except ckio.ChunkCorruptionError as exc:
            corrupt = exc
            continue
        if count > 1:
            parts.append(arr)
            if len(parts) < count:
                continue
            arr = torch.cat(parts, dim=axis)
            parts = []
        nbytes = arr.numel() * arr.element_size()
        dev = devices.get(key.split("/", 1)[0])
        spec = specs.get(key)
        if dev is not None and nbytes >= (1 << 20) and \
                isinstance(spec, ckio.LeafSpec) and spec.is_tensor:
            t0 = time.monotonic()
            flat[key] = arr.to(dev)
            t_h2d += time.monotonic() - t0
            h2d_bytes += nbytes
        else:
            flat[key] = arr
    reader.join()
    if h2d_bytes:
        t0 = time.monotonic()
        _sync_devices(devices.values())
        t_h2d += time.monotonic() - t0
    stage_seconds["h2d"] = [h2d_bytes, t_h2d]
    if corrupt is not None:
        raise corrupt
    if fail:
        raise fail[0]
    snap.host_state = ckio.tree_unflatten(
        structure, [ckio.restore_like(flat[key], spec)
                    for key, spec in pairs])
    spill_store.delete(snap.spill_key)
    snap.spill_key = ""
    snap._skeleton = None
    snap.spilled = False


def restore_context(snap: ContextSnapshot, worker_id: str = "local",
                    spill_store=None, streamed: bool = False) -> Context:
    """Promote a snapshot back to a live device-resident Context.

    LOCAL_DISK snapshots are unspilled to host first (requires
    ``spill_store``), then each offloadable component's state is copied
    back to its device (``restore_device_state``). With ``streamed=True``
    a spilled snapshot instead streams entry-by-entry to the device
    (per-entry digest verification, read/verify of the next entry
    overlapping the copy of the current one — see
    :func:`_streamed_unspill`). No builder call, no kernel build: the
    kernels never left the process. The devices are synchronized before
    the clock stops, so ``restore_seconds`` on the returned Context is the
    real promotion cost (a copy from pinned memory returns before it
    lands); ``stage_seconds`` carries the per-stage (disk/h2d) split for
    pipeline calibration when streamed."""
    t0 = time.monotonic()
    stage_seconds: Dict[str, list] = {}
    if snap.spilled:
        if spill_store is None:
            raise ValueError(
                f"snapshot {snap.key} is spilled to disk; a spill store is "
                "required to restore it")
        if streamed:
            _streamed_unspill(snap, spill_store, stage_seconds)
        else:
            snap.unspill(spill_store)
    for i, comp in enumerate(_offloadable(snap.value)):
        comp.restore_device_state(snap.host_state[f"c{i}"])
    _sync_devices(_component_devices(snap.value).values())
    snap.host_state = {}
    ctx = Context(recipe=snap.recipe, value=snap.value, worker_id=worker_id,
                  build_seconds=snap.build_seconds,
                  aot_seconds=snap.aot_seconds)
    ctx.restore_seconds = time.monotonic() - t0
    ctx.stage_seconds = stage_seconds
    ctx.restored = True
    return ctx
