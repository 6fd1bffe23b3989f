"""Versioned wire format for context snapshots and stripe templates.

This is the serialization layer that lets a :class:`ContextSnapshot` (or a
streamed-transfer template) cross a PROCESS boundary: everything the
in-process peer path shares by pointer — the structural clone with its
loaded kernels, the host trees, the chunk plan — is re-expressed as bytes
plus enough metadata for the receiver to rebuild an identical object.

Three rules shape the format:

1.  **Arrays travel through ``checkpoint/io``'s chunked-sha256 path.**
    ``pack_tree``/``unpack_tree`` give every leaf (and every 64 MB chunk of
    every large leaf) an individual digest, so a corrupt or truncated
    transfer is detected at chunk granularity (``ChunkCorruptionError``
    naming ``wire``) exactly like a corrupt spill file — one integrity
    story for disk and network.

2.  **Kernels never cross the wire; recipes do.** Components exposing
    ``wire_recipe()`` (duck-typed — core never imports the serving layer)
    are replaced by a JSON recipe: the full constructor configuration plus
    a fingerprint (config hash + geometry + bucket sets + megastep K +
    paged/prefix flags + torch/CUDA versions + the kernel libraries the
    engine launches). The receiver re-runs the named loader
    (``"module:function"``, resolved via importlib) on ITS device, which
    builds a shell with no device state and loads the kernel libraries
    from its build directory — built by another process when that
    directory is shared, so the receiver runs no ``nvcc``.

3.  **Structure is exact.** The tree structure travels pickled
    (``checkpoint.io.tree_flatten``'s) plus a leaf table; non-array leaves
    (page-axis ints, RNG states that are not tensors, None markers) ride
    in a pickled sidecar keyed by leaf index, and numpy leaves come back
    as numpy arrays, so the decoded tree is structurally identical to the
    encoded one — not merely array-equal.

Blob layout (little-endian)::

    b"PCMW" | u16 version | u32 header_len | JSON header | sections...

The JSON header carries the section offset table, the array manifest
(shapes/dtypes/per-chunk sha256), the component recipes and the scalar
meta; binary sections carry pickles (skeleton, recipe, structure, sidecar)
and the packed array payload.

Port of ``repro.core.wire``: the same framing, version and header, array
leaves keyed ``L{idx:05d}`` and packed by the port's ``pack_tree`` (bf16
as the ``<V2`` voids the reference writes), so for the same leaves the
JSON table and the array payload are byte-equal to the reference's. The
pickled sections differ: they hold this package's tree structure where the
reference holds a jax treedef. A device tensor is never pickled: every
array leaf is copied to the host by ``pack_tree``, after a device sync on
the thread that encodes.
"""

from __future__ import annotations

import importlib
import json
import pickle
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import io as ckio

WIRE_MAGIC = b"PCMW"
WIRE_VERSION = 1


class WireError(RuntimeError):
    """Malformed, truncated or version-incompatible wire blob."""


class _WirePlaceholder:
    """Stands in for a recipe-encoded component inside the pickled value
    skeleton. Module-level (picklable); ``index`` points into the header's
    recipe table."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index

    def __reduce__(self):
        return (_WirePlaceholder, (self.index,))


# ------------------------------------------------------------- helpers -----
def _split_value(value: Any) -> Tuple[Any, List[Dict]]:
    """Walk the context value ONE level (the same ``_reachable`` shapes
    builders actually return) and pull out every component that knows how
    to describe itself as a wire recipe. Everything else stays in the
    skeleton and must be plain-picklable."""
    recipes: List[Dict] = []

    def enc(v):
        fn = getattr(v, "wire_recipe", None)
        if callable(fn):
            recipes.append(fn())
            return _WirePlaceholder(len(recipes) - 1)
        return v

    if isinstance(value, dict):
        skel: Any = {k: enc(v) for k, v in value.items()}
    elif isinstance(value, (list, tuple)):
        skel = type(value)(enc(v) for v in value)
    else:
        skel = enc(value)
    return skel, recipes


def load_component(rec: Dict, device=None) -> Any:
    """Rebuild one component from its wire recipe by importing and calling
    its named loader (``"pkg.mod:function"``). The loader owns all
    reconstruction semantics (for engines: a device-state-less shell whose
    kernels load from the build directory). ``device``, when given, is
    where the receiving process builds it; else the loader's default."""
    loader = rec.get("loader", "")
    if ":" not in loader:
        raise WireError(f"wire recipe has no importable loader: {rec!r}")
    mod_name, _, attr = loader.partition(":")
    try:
        fn = getattr(importlib.import_module(mod_name), attr)
    except Exception as exc:
        raise WireError(f"cannot import wire loader {loader!r}: {exc}")
    return fn(rec) if device is None else fn(rec, device=device)


def _join_value(skel: Any, recipes: List[Dict], device=None) -> Any:
    def dec(v):
        if isinstance(v, _WirePlaceholder):
            return load_component(recipes[v.index], device=device)
        return v

    if isinstance(skel, dict):
        return {k: dec(v) for k, v in skel.items()}
    if isinstance(skel, (list, tuple)):
        return type(skel)(dec(v) for v in skel)
    return dec(skel)


def _is_arrayish(leaf: Any) -> bool:
    return hasattr(leaf, "shape") and hasattr(leaf, "dtype") and \
        hasattr(leaf, "__array__")


def _pack_state(tree: Any, chunk_bytes: int) -> Tuple[Dict, bytes, bytes]:
    """Flatten a host (or device) tree into (json_table, pickled_sidecar,
    packed_payload). Array leaves — tensors and numpy arrays — go through
    ``pack_tree`` keyed by leaf index (each copied to the host there);
    non-array leaves (ints, None, small metadata) go into the pickled
    sidecar so their exact Python types survive the round trip."""
    pairs, structure = ckio.tree_flatten(tree)
    arrays: Dict[str, Any] = {}
    sidecar: Dict[int, Any] = {}
    numpy_leaves: List[int] = []
    devices = set()
    for idx, (_path, leaf) in enumerate(pairs):
        if _is_arrayish(leaf):
            arrays[f"L{idx:05d}"] = leaf
            if isinstance(leaf, torch.Tensor):
                devices.add(leaf.device)
            else:
                numpy_leaves.append(idx)
        else:
            sidecar[idx] = leaf
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    manifest, payload = ckio.pack_tree(arrays, chunk_bytes=chunk_bytes)
    table = {"n_leaves": len(pairs), "manifest": manifest}
    side = pickle.dumps({"structure": structure, "sidecar": sidecar,
                         "numpy": numpy_leaves},
                        protocol=pickle.HIGHEST_PROTOCOL)
    return table, side, payload


def _unpack_state(table: Dict, side: bytes, payload) -> Any:
    meta = pickle.loads(side)
    flat = ckio.unpack_tree(table["manifest"], payload)
    sidecar = meta["sidecar"]
    as_numpy = set(meta["numpy"])
    leaves = []
    for idx in range(int(table["n_leaves"])):
        if idx in sidecar:
            leaves.append(sidecar[idx])
        elif idx in as_numpy:
            leaves.append(flat[f"L{idx:05d}"].numpy())
        else:
            leaves.append(flat[f"L{idx:05d}"])
    return ckio.tree_unflatten(meta["structure"], leaves)


def _frame(kind: str, header_extra: Dict, sections: Dict[str, bytes]
           ) -> bytes:
    offsets = {}
    pos = 0
    order = list(sections.keys())
    for name in order:
        offsets[name] = [pos, len(sections[name])]
        pos += len(sections[name])
    header = dict(header_extra)
    header["kind"] = kind
    header["sections"] = offsets
    hdr = json.dumps(header, sort_keys=True).encode()
    return b"".join([WIRE_MAGIC, struct.pack("<HI", WIRE_VERSION, len(hdr)),
                     hdr] + [sections[n] for n in order])


def _unframe(blob: bytes, expect_kind: Optional[str] = None
             ) -> Tuple[Dict, memoryview]:
    if len(blob) < 10 or bytes(blob[:4]) != WIRE_MAGIC:
        raise WireError("not a PCM wire blob (bad magic)")
    version, hdr_len = struct.unpack("<HI", bytes(blob[4:10]))
    if version != WIRE_VERSION:
        raise WireError(f"wire version {version} != {WIRE_VERSION}")
    if len(blob) < 10 + hdr_len:
        raise WireError("truncated wire blob (header)")
    header = json.loads(bytes(blob[10:10 + hdr_len]).decode())
    body = memoryview(blob)[10 + hdr_len:]
    total = max((off + ln for off, ln in header["sections"].values()),
                default=0)
    if len(body) < total:
        raise WireError("truncated wire blob (payload)")
    if expect_kind is not None and header.get("kind") != expect_kind:
        raise WireError(
            f"wire blob kind {header.get('kind')!r} != {expect_kind!r}")
    return header, body


def _section(header: Dict, body: memoryview, name: str) -> memoryview:
    """A section as a view into the blob (no copy: the array payload of a
    full-width context is gigabytes)."""
    off, ln = header["sections"][name]
    return body[off:off + ln]


# ---------------------------------------------------------------- chunks ---
def chunk_meta(piece) -> Dict:
    """The frame metadata that rebuilds one host chunk on the far side:
    the manifest dtype name (``"bfloat16"`` for bf16) and the shape."""
    return {"dtype": ckio.dtype_name(piece), "shape": list(piece.shape)}


def chunk_bytes_of(piece) -> bytes:
    """A host chunk's raw bytes (bf16 as its 2-byte words)."""
    return ckio.to_numpy(piece).tobytes()


def chunk_from_frame(meta: Dict, payload) -> torch.Tensor:
    """Inverse of :func:`chunk_meta` + :func:`chunk_bytes_of`: a CPU
    tensor of the frame's dtype and shape."""
    name = meta["dtype"]
    dt = np.dtype("V2") if name == "bfloat16" else np.dtype(name)
    arr = np.frombuffer(payload, dtype=dt).reshape(meta["shape"])
    return ckio.to_tensor(arr, name)


# ------------------------------------------------------------ snapshots ----
def encode_snapshot(snap, chunk_bytes: int = 64 << 20) -> bytes:
    """Serialize a HOST_RAM :class:`ContextSnapshot` to a self-contained
    wire blob. Spilled snapshots must be unspilled first (the disk copy is
    node-local; the wire carries bytes, not paths)."""
    if getattr(snap, "spilled", False):
        raise WireError(
            f"snapshot {snap.key} is spilled to local disk; unspill before "
            "encoding for the wire")
    skel, recipes = _split_value(snap.value)
    table, side, payload = _pack_state(snap.host_state, chunk_bytes)
    header = {
        "recipes": recipes,
        "state": table,
        "meta": {
            "context_key": snap.key,
            "nbytes": int(snap.nbytes),
            "build_seconds": float(snap.build_seconds),
            "aot_seconds": float(snap.aot_seconds),
            "demote_seconds": float(snap.demote_seconds),
        },
    }
    sections = {
        "skeleton": pickle.dumps(skel, protocol=pickle.HIGHEST_PROTOCOL),
        "recipe": pickle.dumps(snap.recipe,
                               protocol=pickle.HIGHEST_PROTOCOL),
        "state_side": side,
        "state_payload": payload,
    }
    return _frame("snapshot", header, sections)


def decode_snapshot(blob: bytes, device=None):
    """Rebuild a :class:`ContextSnapshot` from a wire blob. Every array
    chunk is sha256-verified during unpack; recipe-encoded components are
    reconstructed via their loaders on ``device`` (default: the sender's)
    — shells with no device state, which ``restore_context`` promotes
    exactly like an in-process peer template."""
    from repro_torch.core.context import ContextSnapshot

    header, body = _unframe(blob, expect_kind="snapshot")
    skel = pickle.loads(_section(header, body, "skeleton"))
    recipe = pickle.loads(_section(header, body, "recipe"))
    host_state = _unpack_state(header["state"],
                               _section(header, body, "state_side"),
                               _section(header, body, "state_payload"))
    value = _join_value(skel, header["recipes"], device=device)
    meta = header["meta"]
    return ContextSnapshot(recipe=recipe, value=value,
                           host_state=host_state,
                           nbytes=int(meta["nbytes"]),
                           build_seconds=float(meta["build_seconds"]),
                           aot_seconds=float(meta["aot_seconds"]),
                           demote_seconds=float(meta["demote_seconds"]))


# ------------------------------------------------------------ templates ----
def encode_template(recipe, clone, host_halves, device_tree,
                    nbytes: int, build_seconds: float, aot_seconds: float,
                    chunk_bytes: int = 64 << 20) -> bytes:
    """Serialize the METADATA half of a streamed (striped) transfer: the
    structural clone + host halves travel up front in one blob while the
    device half streams separately as verified chunks. ``device_tree`` (the
    donor's ``stripe_export_state`` output) is reduced to a
    ``checkpoint.io.LeafSpec`` tree — the receiver rebuilds the identical
    :class:`ChunkPlan` from specs alone, so donor and receiver agree on
    every chunk boundary without shipping the device bytes here."""
    skel, recipes = _split_value(clone)
    table, side, payload = _pack_state(host_halves, chunk_bytes)
    spec_tree = ckio.tree_map(
        lambda a: ckio.LeafSpec(tuple(a.shape), a.dtype), device_tree)
    header = {
        "recipes": recipes,
        "state": table,
        "meta": {
            "context_key": recipe.key(),
            "nbytes": int(nbytes),
            "build_seconds": float(build_seconds),
            "aot_seconds": float(aot_seconds),
            "chunk_bytes": int(chunk_bytes),
        },
    }
    sections = {
        "skeleton": pickle.dumps(skel, protocol=pickle.HIGHEST_PROTOCOL),
        "recipe": pickle.dumps(recipe, protocol=pickle.HIGHEST_PROTOCOL),
        "specs": pickle.dumps(spec_tree, protocol=pickle.HIGHEST_PROTOCOL),
        "state_side": side,
        "state_payload": payload,
    }
    return _frame("template", header, sections)


def decode_template_specs(blob: bytes) -> Tuple[Any, Dict]:
    """Cheap manager-side peek at a template blob: just the LeafSpec tree
    (to rebuild the ChunkPlan) and the scalar meta — no clone
    reconstruction, no host-half unpack. Used when the manager forwards a
    remote donor's template to a remote receiver: the blob passes through
    verbatim, but the manager still needs the plan to track the stripe."""
    header, body = _unframe(blob, expect_kind="template")
    spec_tree = pickle.loads(_section(header, body, "specs"))
    meta = header["meta"]
    return spec_tree, {
        "nbytes": int(meta["nbytes"]),
        "build_seconds": float(meta["build_seconds"]),
        "aot_seconds": float(meta["aot_seconds"]),
        "chunk_bytes": int(meta["chunk_bytes"]),
    }


def decode_template(blob: bytes, device=None) -> Dict[str, Any]:
    """Receiver half of :func:`encode_template`. Returns a dict with the
    rebuilt ``recipe``, ``clone`` (its components built on ``device``),
    ``host_halves``, the ``spec_tree`` to plan chunks over, and the scalar
    meta (``nbytes``, ``build_seconds``, ``aot_seconds``,
    ``chunk_bytes``)."""
    header, body = _unframe(blob, expect_kind="template")
    skel = pickle.loads(_section(header, body, "skeleton"))
    recipe = pickle.loads(_section(header, body, "recipe"))
    spec_tree = pickle.loads(_section(header, body, "specs"))
    host_halves = _unpack_state(header["state"],
                                _section(header, body, "state_side"),
                                _section(header, body, "state_payload"))
    clone = _join_value(skel, header["recipes"], device=device)
    meta = header["meta"]
    return {
        "recipe": recipe, "clone": clone, "host_halves": host_halves,
        "spec_tree": spec_tree, "nbytes": int(meta["nbytes"]),
        "build_seconds": float(meta["build_seconds"]),
        "aot_seconds": float(meta["aot_seconds"]),
        "chunk_bytes": int(meta["chunk_bytes"]),
    }
