"""Atomic pytree checkpoint IO (npz payload + json manifest).

Port of ``repro.checkpoint.io``, with the same on-disk layout byte for
byte, so each package reads the other's files:
``<dir>/<name>/arrays.npz`` + ``<dir>/<name>/manifest.json``, leaves named
by their tree path (dict keys as ``str(key)`` in sorted order, list and
tuple items as ``[i]``, joined by ``/``), chunked leaves as
``<key>#chunkNNNNN`` entries, and a sha256 per entry, per chunk and for
the whole npz. The manifest is written LAST (commit marker): a checkpoint
without a valid manifest is ignored by the manager, so a preemption
mid-write can never yield a half-restored state.

Trees are nested dicts, lists and tuples whose leaves are torch tensors
(any device; they are copied to the host to be written), numpy arrays or
Python scalars. bfloat16 needs no ``ml_dtypes``: a bf16 tensor is written
as raw 2-byte void entries (npy descr ``<V2``) with the manifest dtype
``"bfloat16"``, exactly as ``np.savez`` stores an ``ml_dtypes`` array, and
read back as a ``torch.bfloat16`` tensor. Loads return torch tensors on
the CPU; with a template (``like``) each leaf takes the template leaf's
kind (tensor or numpy array) and dtype.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import struct
import tempfile
import zipfile
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


class ChunkCorruptionError(ValueError):
    """A chunk (or unchunked entry) failed its sha256 verification.

    Typed so callers can distinguish payload corruption — degrade the
    fetch to the next ladder rung, drop the stripe lane — from plain
    argument errors."""


@dataclass(frozen=True)
class LeafSpec:
    """Shape, dtype and kind of a leaf without its data: what a spilled
    snapshot keeps in RAM to rebuild its tree (the reference's
    ``jax.ShapeDtypeStruct``). ``dtype`` is a ``torch.dtype`` for a tensor
    leaf and a ``numpy.dtype`` for an array leaf."""

    shape: Tuple[int, ...]
    dtype: Any

    @property
    def is_tensor(self) -> bool:
        return isinstance(self.dtype, torch.dtype)


# --------------------------------------------------------- tree paths -----
def tree_flatten(tree) -> Tuple[List[Tuple[str, Any]], Any]:
    """``([(path key, leaf), ...], structure)`` in the reference's order
    and naming (``jax.tree_util.tree_flatten_with_path`` + ``_path_str``):
    dict keys sorted and named ``str(key)``, list and tuple items ``[i]``,
    ``None`` an empty subtree. ``structure`` rebuilds the tree in
    :func:`tree_unflatten`."""
    pairs: List[Tuple[str, Any]] = []
    return pairs, _walk(tree, (), pairs)


# the walks are module functions, not closures: a closure that calls
# itself is a reference cycle, which would keep every leaf it saw (a
# demoted context's host arenas) alive until the garbage collector ran
def _walk(node, path, pairs):
    if node is None:
        return None
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", keys, [_walk(node[k], path + (str(k),), pairs)
                               for k in keys])
    if isinstance(node, (list, tuple)):
        return (type(node), len(node),
                [_walk(v, path + (f"[{i}]",), pairs)
                 for i, v in enumerate(node)])
    pairs.append(("/".join(path), node))
    return ("leaf",)


def tree_unflatten(structure, leaves) -> Any:
    """Inverse of :func:`tree_flatten`: ``leaves`` in flatten order."""
    return _build(structure, iter(leaves))


def _build(node, leaves):
    if node is None:
        return None
    kind = node[0]
    if kind == "leaf":
        return next(leaves)
    if kind == "dict":
        return {k: _build(c, leaves) for k, c in zip(node[1], node[2])}
    return kind(_build(c, leaves) for c in node[2])


def tree_map(fn, tree) -> Any:
    pairs, structure = tree_flatten(tree)
    return tree_unflatten(structure, [fn(leaf) for _, leaf in pairs])


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_flatten(tree)[0]]


# ------------------------------------------------------ leaves <-> bytes --
def dtype_name(leaf) -> str:
    """The manifest dtype of a leaf: numpy's name, ``"bfloat16"`` for a
    bf16 tensor."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return "bfloat16"
        return str(torch.empty((), dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


def to_numpy(leaf) -> np.ndarray:
    """A leaf as the numpy array whose bytes are written: a tensor is
    copied to the host, a bf16 one viewed as 2-byte voids."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        t = t.contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _np_dtype(name: str) -> np.dtype:
    return np.dtype("V2") if name == "bfloat16" else np.dtype(name)


def to_tensor(arr: np.ndarray, name: str) -> torch.Tensor:
    """Bytes read back (numpy, any dtype kind) -> a CPU tensor of the
    manifest dtype ``name`` (no copy where numpy allows it)."""
    if not (arr.flags.writeable and arr.flags.c_contiguous):
        arr = arr.copy(order="C")
    if name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def leaf_nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    if isinstance(leaf, LeafSpec):
        return int(np.prod(leaf.shape, dtype=np.int64)) * leaf.dtype.itemsize
    return int(np.asarray(leaf).nbytes)


def _leaf_shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") \
        else np.asarray(leaf).shape


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: to_numpy(leaf) for key, leaf in tree_flatten(tree)[0]}


def _sha256_file(path: str, chunk: int = 1 << 20) -> str:
    """Streaming digest: checkpoint/snapshot payloads can be many GB, so
    hashing must not load the whole file into RAM."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(chunk), b""):
            h.update(block)
    return h.hexdigest()


def _chunk_spec(key: str, chunk_rows: Optional[Dict]
                ) -> Optional[Tuple[int, int]]:
    """(rows, axis) per chunk for a flat key, or None when the key is
    unchunked. ``chunk_rows`` maps "/"-joined flat-key PREFIXES to either
    a row count (chunking the leading axis) or ``{"rows": r, "axis": a}``
    (chunking axis ``a``). A key matches when it equals the prefix or
    continues it at a "/" boundary."""
    if not chunk_rows:
        return None
    for prefix, spec in chunk_rows.items():
        if key == prefix or key.startswith(prefix + "/"):
            if isinstance(spec, dict):
                return int(spec["rows"]), int(spec.get("axis", 0))
            return int(spec), 0
    return None


def _sha256_array(arr) -> str:
    """sha256 of a leaf's raw bytes (a tensor's on the host): the digest
    both packages write and check."""
    arr = to_numpy(arr) if isinstance(arr, torch.Tensor) else arr
    return hashlib.sha256(
        np.ascontiguousarray(arr).view(np.uint8).reshape(-1).data).hexdigest()


def plan_chunk_rows(tree, chunk_bytes: int = 64 << 20,
                    axes: Optional[Dict[str, int]] = None) -> Dict[str, Dict]:
    """Auto chunk_rows covering every leaf bigger than ``chunk_bytes``:
    each such leaf is split along its chunk axis (``axes`` maps flat-key
    prefixes to an axis; default 0) into pieces of at most
    ``chunk_bytes``. The plan is deterministic in the tree's shapes
    alone. Reads shapes and sizes only: no leaf is copied."""
    plan: Dict[str, Dict] = {}
    for key, leaf in tree_flatten(tree)[0]:
        shape, nbytes = _leaf_shape(leaf), leaf_nbytes(leaf)
        if not shape or nbytes <= chunk_bytes:
            continue
        axis = 0
        for prefix, ax in (axes or {}).items():
            if key == prefix or key.startswith(prefix + "/"):
                axis = int(ax)
                break
        dim = shape[axis]
        if dim <= 1:
            continue
        row_bytes = max(1, nbytes // dim)
        rows = max(1, min(dim, chunk_bytes // row_bytes))
        plan[key] = {"rows": int(rows), "axis": axis}
    return plan


def _write_npy(fid, arr: np.ndarray, name: str) -> None:
    """One npz member as ``np.lib.format.write_array`` writes it; a bf16
    leaf's header names ``<V2``, as numpy writes an ``ml_dtypes`` array."""
    if name != "bfloat16":
        np.lib.format.write_array(fid, arr, allow_pickle=False)
        return
    header = np.lib.format.header_data_from_array_1_0(arr)
    header["descr"] = "<V2"
    np.lib.format.write_array_header_1_0(fid, header)
    fid.write(np.ascontiguousarray(arr).data)


def _savez(path: str, entries: Dict[str, Tuple[np.ndarray, str]]) -> None:
    """``np.savez(path, **entries)``, member for member."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, (arr, name) in entries.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                _write_npy(fid, arr, name)


def save_pytree(tree, directory: str, extra_meta: Optional[Dict] = None,
                chunk_rows: Optional[Dict[str, int]] = None) -> str:
    """Atomic save. ``chunk_rows`` streams matching leaves in chunks along
    their chunk axis — each chunk is its own npz entry
    ``<key>#chunkNNNNN`` with its own sha256 in the manifest, so integrity
    is verifiable (and a partial restore addressable) at chunk
    granularity."""
    os.makedirs(os.path.dirname(directory) or ".", exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".ckpt_tmp_",
                           dir=os.path.dirname(directory) or ".")
    try:
        pairs = tree_flatten(tree)[0]
        names = {key: dtype_name(leaf) for key, leaf in pairs}
        flat = {key: to_numpy(leaf) for key, leaf in pairs}
        entries: Dict[str, Tuple[np.ndarray, str]] = {}
        chunks: Dict[str, Dict] = {}
        entry_sha: Dict[str, str] = {}
        for key, v in flat.items():
            spec = _chunk_spec(key, chunk_rows)
            if spec is None or v.ndim == 0:
                entries[key] = (v, names[key])
                entry_sha[key] = _sha256_array(v)
                continue
            rows, axis = spec
            if rows < 1:
                raise ValueError(f"chunk_rows for {key!r} must be >= 1, "
                                 f"got {rows}")
            if not -v.ndim <= axis < v.ndim:
                raise ValueError(f"chunk axis {axis} out of range for "
                                 f"{key!r} with shape {v.shape}")
            dim = v.shape[axis]
            n = -(-dim // rows) if dim else 0
            sel = (slice(None),) * (axis % v.ndim)
            digests = []
            for i in range(n):
                part = v[sel + (slice(i * rows, (i + 1) * rows),)]
                entries[f"{key}#chunk{i:05d}"] = (part, names[key])
                digests.append(_sha256_array(part))
            chunks[key] = {"rows": rows, "axis": axis, "count": n,
                           "sha256": digests}
        _savez(os.path.join(tmp, "arrays.npz"), entries)
        digest = _sha256_file(os.path.join(tmp, "arrays.npz"))
        manifest = {
            "keys": sorted(flat.keys()),
            "dtypes": dict(names),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "chunks": chunks,
            "entry_sha256": entry_sha,
            "sha256": digest,
            "nbytes": int(sum(v.nbytes for v in flat.values())),
            "meta": extra_meta or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(directory):
            shutil.rmtree(directory)
        os.replace(tmp, directory)
        return directory
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def pack_tree(tree, chunk_bytes: int = 64 << 20,
              axes: Optional[Dict[str, int]] = None,
              chunk_rows: Optional[Dict[str, Dict]] = None
              ) -> Tuple[Dict, bytes]:
    """In-memory counterpart of :func:`save_pytree`: serialize a tree into
    ``(manifest, payload)`` where ``payload`` is the concatenated raw bytes
    of every entry and the JSON-serializable ``manifest`` carries the same
    per-entry/per-chunk sha256 metadata the on-disk format uses. Leaves
    bigger than ``chunk_bytes`` split into per-chunk entries hashed
    independently."""
    if chunk_rows is None:
        chunk_rows = plan_chunk_rows(tree, chunk_bytes, axes=axes)
    pairs = tree_flatten(tree)[0]
    names = {key: dtype_name(leaf) for key, leaf in pairs}
    flat = {key: to_numpy(leaf) for key, leaf in pairs}
    parts = []
    offsets: Dict[str, Tuple[int, int]] = {}
    chunks: Dict[str, Dict] = {}
    entry_sha: Dict[str, str] = {}
    pos = 0

    def _emit(name: str, arr: np.ndarray) -> str:
        nonlocal pos
        raw = np.ascontiguousarray(arr)
        parts.append(raw.view(np.uint8).reshape(-1).data)
        offsets[name] = (pos, raw.nbytes)
        pos += raw.nbytes
        return _sha256_array(raw)

    for key, v in flat.items():
        spec = _chunk_spec(key, chunk_rows)
        if spec is None or v.ndim == 0:
            entry_sha[key] = _emit(key, v)
            continue
        rows, axis = spec
        dim = v.shape[axis]
        n = -(-dim // rows) if dim else 0
        sel = (slice(None),) * (axis % v.ndim)
        digests = [_emit(f"{key}#chunk{i:05d}",
                         v[sel + (slice(i * rows, (i + 1) * rows),)])
                   for i in range(n)]
        chunks[key] = {"rows": rows, "axis": axis, "count": n,
                       "sha256": digests}
    manifest = {
        "keys": list(flat.keys()),
        "dtypes": dict(names),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "chunks": chunks,
        "entry_sha256": entry_sha,
        "offsets": {k: list(v) for k, v in offsets.items()},
        "nbytes": int(sum(v.nbytes for v in flat.values())),
    }
    return manifest, b"".join(parts)


def unpack_tree(manifest: Dict, payload, keys=None
                ) -> Dict[str, torch.Tensor]:
    """Decode a :func:`pack_tree` payload back into a flat ``{key:
    tensor}`` map. Every entry is re-hashed against its manifest digest
    BEFORE chunked leaves are reassembled, so corruption surfaces as
    :class:`ChunkCorruptionError` naming the exact chunk."""
    view = memoryview(payload)
    offsets = manifest["offsets"]
    chunks = manifest.get("chunks", {})
    entry_sha = manifest.get("entry_sha256", {})
    out: Dict[str, torch.Tensor] = {}
    for key in (manifest["keys"] if keys is None else keys):
        name = manifest["dtypes"][key]
        dt = _np_dtype(name)
        shape = tuple(manifest["shapes"][key])
        spec = chunks.get(key)
        if spec is None:
            off, length = offsets[key]
            arr = np.frombuffer(view[off:off + length],
                                dtype=dt).reshape(shape)
            verify_chunk(key, 0, arr, entry_sha.get(key), where="wire")
            out[key] = to_tensor(arr, name)
            continue
        rows, axis = spec["rows"], spec.get("axis", 0)
        dim = shape[axis] if shape else 0
        pieces = []
        for i in range(spec["count"]):
            cshape = list(shape)
            cshape[axis] = min(dim, (i + 1) * rows) - i * rows
            off, length = offsets[f"{key}#chunk{i:05d}"]
            part = np.frombuffer(view[off:off + length],
                                 dtype=dt).reshape(cshape)
            verify_chunk(key, i, part, spec["sha256"][i], where="wire")
            pieces.append(part)
        out[key] = to_tensor(np.concatenate(pieces, axis=axis) if pieces
                             else np.zeros(shape, dt), name)
    return out


def load_chunks(directory: str, key: str, indices=None):
    """Partial restore of one chunked leaf: return ``(chunks, spec)``
    where ``chunks`` holds the requested chunk tensors (all of them when
    ``indices`` is None), each verified against its manifest sha256."""
    if not is_valid(directory):
        raise FileNotFoundError(f"no valid checkpoint at {directory}")
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    spec = manifest.get("chunks", {}).get(key)
    if spec is None:
        raise KeyError(f"{key!r} is not a chunked leaf of {directory}")
    idx = range(spec["count"]) if indices is None else indices
    out = []
    with _npz_reader(os.path.join(directory, "arrays.npz")) as fetch:
        for i in idx:
            raw = fetch(f"{key}#chunk{i:05d}")
            got = _sha256_array(raw)
            if got != spec["sha256"][i]:
                raise ChunkCorruptionError(
                    f"chunk {i} of {key!r} failed verification "
                    f"({got[:12]} != {spec['sha256'][i][:12]})")
            out.append(to_tensor(raw, manifest["dtypes"][key]))
    return out, spec


def is_valid(directory: str) -> bool:
    man = os.path.join(directory, "manifest.json")
    arr = os.path.join(directory, "arrays.npz")
    if not (os.path.isfile(man) and os.path.isfile(arr)):
        return False
    try:
        with open(man) as f:
            manifest = json.load(f)
        return _sha256_file(arr) == manifest["sha256"]
    except (json.JSONDecodeError, KeyError, OSError):
        return False


def read_manifest(directory: str) -> Dict:
    """Parse the manifest (commit marker) without the whole-file sha pass.
    Raises FileNotFoundError when the checkpoint was never committed."""
    man = os.path.join(directory, "manifest.json")
    arr = os.path.join(directory, "arrays.npz")
    if not (os.path.isfile(man) and os.path.isfile(arr)):
        raise FileNotFoundError(f"no checkpoint at {directory}")
    with open(man) as f:
        return json.load(f)


_ZIP_LOCAL_HEADER = struct.Struct("<4s5H3I2H")      # 30-byte local header


def _npz_raw_members(path: str) -> Optional[Dict[str, Tuple[int, int]]]:
    """Map npz member key -> (data_offset, data_size), resolved against
    each member's LOCAL zip header. Returns None when any member is
    compressed (foreign archives; ``np.savez`` writes ZIP_STORED)."""
    try:
        with zipfile.ZipFile(path) as zf:
            infos = zf.infolist()
        out: Dict[str, Tuple[int, int]] = {}
        with open(path, "rb") as f:
            for info in infos:
                if info.compress_type != zipfile.ZIP_STORED:
                    return None
                f.seek(info.header_offset)
                hdr = f.read(_ZIP_LOCAL_HEADER.size)
                if len(hdr) != _ZIP_LOCAL_HEADER.size:
                    return None
                fields = _ZIP_LOCAL_HEADER.unpack(hdr)
                if fields[0] != b"PK\x03\x04":
                    return None
                namelen, extralen = fields[-2], fields[-1]
                name = info.filename
                if name.endswith(".npy"):     # np.load strips the suffix
                    name = name[:-4]
                out[name] = (info.header_offset + _ZIP_LOCAL_HEADER.size
                             + namelen + extralen, info.file_size)
        return out
    except (OSError, zipfile.BadZipFile):
        return None


@contextlib.contextmanager
def _npz_reader(path: str):
    """Member fetcher for an npz payload: yields ``fetch(key) -> raw numpy
    array`` (bf16 members as 2-byte voids). The fast path seeks straight
    to each STORED member's data and reads it with one ``np.fromfile``,
    skipping the zip layer's CRC pass (every chunk is verified against its
    manifest sha256 anyway); falls back to ``np.load``."""
    members = _npz_raw_members(path) \
        if hasattr(np.lib.format, "_read_array_header") else None
    if members is None:
        data = np.load(path)
        try:
            yield lambda key: np.asarray(data[key])
        finally:
            data.close()
        return
    with open(path, "rb") as f:

        def fetch(key: str) -> np.ndarray:
            offset, size = members[key]
            f.seek(offset)
            version = np.lib.format.read_magic(f)
            shape, fortran, dtype = np.lib.format._read_array_header(
                f, version)
            count = int(np.prod(shape, dtype=np.int64)) if shape else 1
            arr = np.fromfile(f, dtype=dtype, count=count)
            if arr.size != count:
                raise OSError(
                    f"npz member {key!r} truncated in {path}")
            return arr.reshape(shape, order="F" if fortran else "C")

        yield fetch


def iter_raw_chunks(directory: str, keys=None):
    """Raw chunk reader: yield ``(key, index, count, axis, tensor,
    expected_sha)`` straight off the npz with NO digest verification and
    NO assembly — the pure-IO producer half of the streamed restore. The
    consumer verifies each chunk against ``expected_sha`` and concatenates
    completed leaves. Unchunked entries arrive as a single chunk with
    ``count == 1``; ``expected_sha`` is None for entries saved before
    per-entry digests existed."""
    manifest = read_manifest(directory)
    chunks = manifest.get("chunks", {})
    entry_sha = manifest.get("entry_sha256", {})
    with _npz_reader(os.path.join(directory, "arrays.npz")) as fetch:
        for k in manifest["keys"] if keys is None else keys:
            name = manifest["dtypes"][k]
            spec = chunks.get(k)
            if spec is None:
                yield (k, 0, 1, 0, to_tensor(fetch(k), name),
                       entry_sha.get(k))
                continue
            if spec["count"] == 0:
                yield (k, 0, 1, 0,
                       to_tensor(np.zeros(manifest["shapes"][k],
                                          _np_dtype(name)), name), None)
                continue
            for i in range(spec["count"]):
                part = to_tensor(fetch(f"{k}#chunk{i:05d}"), name)
                yield (k, i, spec["count"], spec.get("axis", 0), part,
                       spec["sha256"][i])


def verify_chunk(key: str, index: int, arr, expected_sha, where: str = ""):
    """Check one raw chunk (tensor or array) against its manifest digest;
    raises ``ChunkCorruptionError`` naming the exact entry. No-op when
    ``expected_sha`` is None (pre-digest save)."""
    if expected_sha is None:
        return
    got = _sha256_array(arr)
    if got != expected_sha:
        raise ChunkCorruptionError(
            f"chunk {index} of {key!r} failed verification"
            f"{' in ' + where if where else ''} "
            f"({got[:12]} != {expected_sha[:12]})")


def iter_entries(directory: str, keys=None):
    """Streaming per-leaf reader: yield ``(key, tensor)`` for each flat
    key, verifying each npz entry against its own manifest digest instead
    of hashing the whole payload file up front."""
    parts: list = []
    for k, i, count, axis, arr, want in iter_raw_chunks(directory, keys):
        verify_chunk(k, i, arr, want, where=directory)
        if count == 1:
            yield k, arr
            continue
        parts.append(arr)
        if len(parts) == count:
            yield k, torch.cat(parts, dim=axis)
            parts = []


def restore_like(t: torch.Tensor, like) -> Any:
    """A loaded tensor in the kind and dtype of its template leaf: a
    tensor (or a tensor :class:`LeafSpec`) gives a tensor of its dtype, a
    numpy array (or an array spec) a numpy array, anything else the
    tensor as it is."""
    if isinstance(like, torch.Tensor) or (isinstance(like, LeafSpec)
                                          and like.is_tensor):
        return t.to(like.dtype)
    if isinstance(like, (np.ndarray, np.generic)) or isinstance(like,
                                                                LeafSpec):
        dt = like.dtype
        if t.dtype == torch.bfloat16:
            return t
        return t.numpy().astype(dt, copy=False)
    return t


def load_pytree(directory: str, like: Any = None) -> Tuple[Any, Dict]:
    """Restore. With ``like`` (a template tree, whose leaves may be
    :class:`LeafSpec`s), returns the same structure and leaf kinds;
    otherwise a nested dict of CPU tensors keyed by path segments."""
    if not is_valid(directory):
        raise FileNotFoundError(f"no valid checkpoint at {directory}")
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    chunks = manifest.get("chunks", {})
    with _npz_reader(os.path.join(directory, "arrays.npz")) as fetch:

        def _load_key(k):
            name = manifest["dtypes"][k]
            spec = chunks.get(k)
            if spec is None:
                return to_tensor(fetch(k), name)
            parts = [fetch(f"{k}#chunk{i:05d}")
                     for i in range(spec["count"])]
            if not parts:
                return to_tensor(np.zeros(manifest["shapes"][k],
                                          _np_dtype(name)), name)
            return to_tensor(
                np.concatenate(parts, axis=spec.get("axis", 0)), name)

        flat = {k: _load_key(k) for k in manifest["keys"]}
    if like is not None:
        pairs, structure = tree_flatten(like)
        return (tree_unflatten(structure, [restore_like(flat[key], leaf)
                                           for key, leaf in pairs]),
                manifest["meta"])
    nested: Dict = {}
    for key, arr in flat.items():
        parts = key.split("/")
        d = nested
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = arr
    return nested, manifest["meta"]
