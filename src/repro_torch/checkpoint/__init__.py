from repro_torch.checkpoint.io import (ChunkCorruptionError, is_valid,
                                       load_chunks, load_pytree,
                                       read_manifest, save_pytree)
from repro_torch.checkpoint.manager import CheckpointManager, SpillStore

__all__ = ["ChunkCorruptionError", "is_valid", "load_chunks", "load_pytree",
           "read_manifest", "save_pytree", "CheckpointManager", "SpillStore"]
