"""Device meshes for the sharded path.

Port of ``repro.launch.mesh`` on ``torch.distributed.device_mesh``. A
mesh spans the ranks of the default process group, which the caller
starts (``torch.distributed.init_process_group`` with its own address,
world size and rank: nothing here reads a cluster's environment). The
production mesh is refused, naming the ranks it needs, when the world is
smaller: it is never built smaller quietly. Meshes are made by functions,
never at import.

``fake_world`` stands where the reference's dry-run sets
``XLA_FLAGS=--xla_force_host_platform_device_count=512``: a process group
of n ranks on torch's fake backend, this process as rank 0, on which the
production mesh builds. A fake group allocates nothing and runs no
collective: a collective's result has the right shape and no meaning, so
it is for analysis under ``FakeTensorMode`` only.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Iterator, Tuple

import torch

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


@contextmanager
def fake_world(n: int, device_type: str = "cuda") -> Iterator[int]:
    """A default process group of ``n`` ranks on the fake backend, this
    process as rank 0, destroyed on exit; yields ``n``. Inside it
    ``make_production_mesh(device_type=...)`` builds the (16, 16) mesh for
    n = 256 and the (2, 16, 16) one for n = 512. Refused when a default
    group already exists (it is named), and for ``device_type="cuda"`` on
    a machine with no card.

    The fake backend is registered by importing
    ``torch.testing._internal.distributed.fake_pg`` (present in torch
    2.11 and 2.13), done here, never at import of this module."""
    import torch.testing._internal.distributed.fake_pg as fake_pg
    if dist.is_initialized():
        raise RuntimeError(
            f"fake_world({n}): a default process group already exists "
            f"(backend {dist.get_backend()!r}, "
            f"{dist.get_world_size()} ranks); destroy it first")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"fake_world({n}): no CUDA device on this machine; pass "
            f"device_type='cpu' to analyse on the CPU")
    dist.init_process_group("fake", store=fake_pg.FakeStore(), rank=0,
                            world_size=n)
    try:
        yield n
    finally:
        dist.destroy_process_group()
