"""The cluster model and worker nodes of the PyTorch port.

Port of ``repro.cluster``: the device profiles (``devices.py``), the
deterministic event loop (``events.py``), the capacity traces and the
open-loop session arrivals (``traces.py``), the discrete-event cluster
simulator that runs the port's scheduler against modeled time
(``simulator.py``; ``SimulatorBackend`` in ``repro_torch.core`` is its
client-facing half), and the worker node process (``node.py``: ``python
-m repro_torch.cluster.node --connect HOST:PORT --worker-id ID``, or
``repro_torch.cluster.node.spawn_node_process`` from Python; not imported
here, so ``-m`` runs it fresh).
"""

from repro_torch.cluster.devices import (PAPER_TABLE_1, PROFILES,
                                         TPU_PROFILES, CostModel,
                                         DeviceProfile, cluster_census,
                                         inference_seconds, load_seconds,
                                         task_seconds)
from repro_torch.cluster.events import Event, EventLoop
from repro_torch.cluster.simulator import (ClusterSimulator, SimResult,
                                           simulate_sweep)
from repro_torch.cluster import traces

__all__ = [
    "PAPER_TABLE_1", "PROFILES", "TPU_PROFILES", "CostModel",
    "DeviceProfile", "cluster_census", "inference_seconds", "load_seconds",
    "task_seconds", "Event", "EventLoop", "ClusterSimulator", "SimResult",
    "simulate_sweep", "traces",
]
