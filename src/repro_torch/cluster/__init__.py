"""The cluster model and worker nodes of the PyTorch port.

Port of ``repro.cluster`` so far: the device profiles (``devices.py``) and
the worker node process (``node.py``: ``python -m
repro_torch.cluster.node --connect HOST:PORT --worker-id ID``, or
``repro_torch.cluster.node.spawn_node_process`` from Python; not imported
here, so ``-m`` runs it fresh). The event loop, the capacity traces
and the discrete-event simulator wait for their own slice (ROADMAP.md,
queue 1).
"""

from repro_torch.cluster.devices import (PAPER_TABLE_1, PROFILES,
                                         TPU_PROFILES, CostModel,
                                         DeviceProfile, cluster_census,
                                         inference_seconds, load_seconds,
                                         task_seconds)

__all__ = [
    "PAPER_TABLE_1", "PROFILES", "TPU_PROFILES", "CostModel",
    "DeviceProfile", "cluster_census", "inference_seconds", "load_seconds",
    "task_seconds",
]
