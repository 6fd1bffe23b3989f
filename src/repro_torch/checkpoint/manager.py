"""Rotating checkpoint manager with resume — the fault-tolerance substrate
for the training loop and for PCM inference progress logs — plus the keyed
:class:`SpillStore` that backs HOST_RAM -> LOCAL_DISK context-snapshot
spills in the concurrent PCM runtime.

Port of ``repro.checkpoint.manager``: the same directory names
(``step_NNNNNNNNNN``) and the same payload layout (``checkpoint.io``), so
either package resumes from the other's checkpoints."""

from __future__ import annotations

import atexit
import os
import re
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Set, Tuple

from repro_torch.checkpoint import io

_STEP_RE = re.compile(r"^step_(\d+)$")
_KEY_RE = re.compile(r"^[A-Za-z0-9._-]+$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and io.is_valid(os.path.join(self.directory, name)):
                out.append(int(m.group(1)))
        return sorted(out)

    def save(self, step: int, state: Any, meta: Optional[Dict] = None) -> str:
        path = io.save_pytree(state, self._step_dir(step),
                              extra_meta={"step": step, **(meta or {})})
        self._rotate()
        return path

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, like: Any, step: Optional[int] = None
                ) -> Tuple[Any, Dict]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return io.load_pytree(self._step_dir(step), like=like)

    def restore_or_init(self, init_state: Any) -> Tuple[Any, int]:
        step = self.latest_step()
        if step is None:
            return init_state, 0
        state, meta = self.restore(like=init_state, step=step)
        return state, int(meta.get("step", step))

    def _rotate(self):
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)


class SpillStore:
    """Keyed (not step-numbered) on-disk pytree store.

    The LOCAL_DISK tier of the PCM snapshot pool: each spilled context
    snapshot lives at ``<dir>/<key>/`` as an atomic npz + manifest pair
    (same commit-marker discipline as training checkpoints, so a
    preemption mid-spill never yields a half-written snapshot). Without an
    explicit directory a per-process temp dir is used and cleaned up on
    interpreter exit."""

    def __init__(self, directory: Optional[str] = None):
        if directory is None:
            directory = tempfile.mkdtemp(prefix="pcm_spill_")
            self._owns_dir = True
            # atexit, not __del__: finalizers are not guaranteed at
            # interpreter shutdown and these directories hold GB-scale
            # spills (the hook holds only the path, never self)
            atexit.register(shutil.rmtree, directory, ignore_errors=True)
        else:
            os.makedirs(directory, exist_ok=True)
            self._owns_dir = False
        self.directory = directory

    def _path(self, key: str) -> str:
        if not _KEY_RE.match(key):
            raise ValueError(f"invalid spill key {key!r}")
        return os.path.join(self.directory, key)

    def save(self, key: str, tree: Any, meta: Optional[Dict] = None,
             chunk_rows: Optional[Dict[str, int]] = None) -> str:
        return io.save_pytree(tree, self._path(key),
                              extra_meta={"key": key, **(meta or {})},
                              chunk_rows=chunk_rows)

    def path(self, key: str) -> str:
        """On-disk directory of one spill — the handle streamed restores
        hand to ``io.iter_entries`` for per-entry verified reads (no
        whole-file sha pass, no full host materialization)."""
        return self._path(key)

    def load(self, key: str, like: Any = None) -> Tuple[Any, Dict]:
        return io.load_pytree(self._path(key), like=like)

    def iter_entries(self, key: str, keys=None):
        """Streaming per-leaf read of one spill (see ``io.iter_entries``):
        each entry verified against its own manifest digest as it is
        yielded."""
        return io.iter_entries(self._path(key), keys=keys)

    def has(self, key: str) -> bool:
        return io.is_valid(self._path(key))

    def delete(self, key: str):
        shutil.rmtree(self._path(key), ignore_errors=True)

    def keys(self) -> Set[str]:
        if not os.path.isdir(self.directory):
            return set()
        return {name for name in os.listdir(self.directory)
                if io.is_valid(os.path.join(self.directory, name))}

    def bytes_used(self) -> int:
        total = 0
        for name in os.listdir(self.directory):
            arr = os.path.join(self.directory, name, "arrays.npz")
            if os.path.isfile(arr):
                total += os.path.getsize(arr)
        return total

    def __del__(self):
        # best-effort early cleanup; the atexit hook is the guarantee
        if getattr(self, "_owns_dir", False):
            shutil.rmtree(self.directory, ignore_errors=True)
