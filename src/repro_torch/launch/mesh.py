"""Device meshes for the sharded path.

Port of ``repro.launch.mesh`` on ``torch.distributed.device_mesh``. A
mesh spans the ranks of the default process group, which the caller
starts (``torch.distributed.init_process_group`` with its own address,
world size and rank: nothing here reads a cluster's environment). The
production mesh is refused, naming the ranks it needs, when the world is
smaller: it is never built smaller quietly. Meshes are made by functions,
never at import.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch.distributed as dist


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _mesh(device_type: str, shape: Tuple[int, ...],
          names: Tuple[str, ...], what: str):
    from torch.distributed.device_mesh import init_device_mesh
    n, world = math.prod(shape), _world()
    if not dist.is_initialized() or world != n:
        raise RuntimeError(
            f"{what} mesh {shape} {names} needs {n} ranks in an initialised "
            f"process group, found {world if dist.is_initialized() else 0}"
            f": start {n} processes and call "
            f"torch.distributed.init_process_group in each first")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's production mesh: (16, 16) over ("data", "model"),
    or (2, 16, 16) over ("pod", "data", "model") with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, names, "production")


def make_host_mesh(data: int = 1, model: int = 1,
                   device_type: str = "cuda"):
    """A (data, model) mesh over the ranks that exist (tests, one card)."""
    return _mesh(device_type, (data, model), ("data", "model"), "host")
