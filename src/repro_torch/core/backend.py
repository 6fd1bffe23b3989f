"""Pluggable execution backends behind the PCMClient session API.

Port of ``repro.core.backend``. An ``ExecutionBackend`` is anything that
can accept PCM task submissions and resolve their Futures. This package
ships the LIVE backend, :class:`repro_torch.core.manager.PCMManager`:
tasks run real PyTorch inference in-process, contexts are actual
(weights, kernels, KV pool) objects. The reference's dry-run
``SimulatorBackend`` drives the same scheduler on a discrete-event clock
with modeled device costs; it arrives with the port slice for the
cluster model (``cluster/devices.py``, ``events.py``, ``traces.py``,
``simulator.py``).
"""

from __future__ import annotations

from typing import (Callable, Dict, List, Mapping, Optional, Protocol,
                    runtime_checkable)

from repro_torch.core.context import ContextRecipe
from repro_torch.core.manager import Future, PCMManager
from repro_torch.core.scheduler import Task
from repro_torch.core.store import Tier


@runtime_checkable
class ExecutionBackend(Protocol):
    """What the PCMClient needs from a runtime. ``PCMManager`` satisfies
    it (and the reference's ``SimulatorBackend`` does too).

    ``concurrent`` tells consumers how progress is made: True — worker
    threads run independently and ``wait`` blocks on condition variables;
    False — single-threaded, and ``wait``/``step`` drive the event loop.
    ``now`` is the backend's single clock source: every scheduler event
    timestamp comes from it (wall seconds since start for the live
    runtime, modeled event-loop seconds for the simulator) — never from
    ``time.monotonic()`` directly."""

    concurrent: bool

    def submit(self, fn: Callable, args: tuple = (), kwargs: dict = None,
               recipe: Optional[ContextRecipe] = None,
               recipes: Optional[Mapping[str, ContextRecipe]] = None,
               n_items: int = 1, priority: int = 0) -> Future: ...

    def step(self) -> bool: ...

    def run_until_idle(self) -> int: ...

    def wait(self, fut: Future, timeout: Optional[float] = None) -> None: ...

    def warm_up(self, recipe: ContextRecipe,
                worker_ids: Optional[List[str]] = None) -> List[str]: ...

    def demote_context(self, recipe: ContextRecipe,
                       tier: Tier = Tier.HOST_RAM,
                       worker_ids: Optional[List[str]] = None
                       ) -> List[str]: ...

    def pin_context(self, recipe: ContextRecipe) -> None: ...

    def release_context(self, recipe: ContextRecipe) -> None: ...

    def residency(self, recipe: ContextRecipe) -> Dict[str, Tier]: ...

    def fetch_history(self, recipe: Optional[ContextRecipe] = None
                      ) -> List: ...

    def lookup_task(self, task_id: str) -> Optional[Task]: ...

    @property
    def outstanding(self) -> int: ...

    @property
    def now(self) -> float: ...

    def stats(self) -> Dict: ...


LiveBackend = PCMManager     # the live runtime under its backend name
