"""Pervasive Context Management — the paper's primary contribution, in the
PyTorch port.

Port of ``repro.core`` for in-process workers on one card. The user entry
point is the **PCMClient session API** (api.py): declare contexts as
first-class handles (``client.context`` -> pin / release / warm_up /
residency), attach one or several named contexts to tasks
(``@client.task(contexts={...})``), and submit work as Futures
(``client.submit``) or FutureBatches (``client.map``). The client drives
an **ExecutionBackend** (backend.py): ``PCMManager`` runs tasks live.

The live backend is a **concurrent actor runtime**: every worker is a
thread with a mailbox owning its Library/ContextStore; the scheduler runs
behind one lock fed by runtime events; Futures resolve on condition
variables. Context tier movement is physical — demotion copies weights and
engine state to pinned host memory, spills to local disk through
``checkpoint/io``, and promotion restores with zero builder calls and zero
kernel builds (see the residency state diagram in store.py).

Module map:
  context.py   ContextRecipe / Context / ContextSnapshot
  store.py     tiered per-worker residency + pinning + the node
               SnapshotPool (physical HOST_RAM/LOCAL_DISK tiers)
  library.py   per-worker executor holding materialized (named) contexts
  transfer.py  the FetchSource ladder (PEER/POOL/DISK/FS/BUILD)
  scheduler.py context-aware placement and FetchSource decisions
               (fetch_log — identical to the reference's on one trace)
  streaming.py chunk plans and stripe buffers for striped PEER fetches
  factory.py   reactive pool reconciliation (WorkerFactory) +
               ElasticRunner over a capacity callable
  manager.py   live concurrent runtime (worker actor threads + mailboxes,
               physical preemption demotion, peer context transfer) +
               Future
  backend.py   ExecutionBackend protocol
  api.py       PCMClient / ContextHandle / FutureBatch (+ @context_app)

Not ported yet: the simulator backend (with the cluster model), remote
workers over the socket transport (``wire.py``, ``transport.py``), and
streaming sessions through the front door (ROADMAP.md, queue 1).
"""

from repro_torch.core.api import (ContextHandle, FutureBatch, PCMClient,
                                  context_app, get_default_client,
                                  get_default_manager, load_context,
                                  make_recipe, set_default_manager)
from repro_torch.core.backend import ExecutionBackend, LiveBackend
from repro_torch.core.context import (Context, ContextRecipe,
                                      ContextSnapshot, PeerExportError,
                                      export_context, materialize,
                                      restore_context, snapshot_context)
from repro_torch.core.factory import (ElasticRunner, PoolDirective,
                                      WorkerFactory)
from repro_torch.core.library import (Library, current_context,
                                      load_variable_from_context)
from repro_torch.core.manager import Future, PCMManager
from repro_torch.core.scheduler import (Action, Completion,
                                        ContextAwareScheduler, FetchDecision,
                                        Task, WorkerPhase)
from repro_torch.core.store import (ContextMode, ContextStore, SnapshotPool,
                                    Tier, TierFullError)
from repro_torch.core.transfer import (FetchSource, TransferPlan,
                                       TransferPlanner)

__all__ = [
    "ContextHandle", "FutureBatch", "PCMClient", "context_app",
    "get_default_client", "get_default_manager", "load_context",
    "make_recipe", "set_default_manager", "ExecutionBackend", "LiveBackend",
    "Context", "ContextRecipe", "ContextSnapshot", "PeerExportError",
    "export_context", "materialize", "restore_context", "snapshot_context",
    "ElasticRunner", "PoolDirective", "WorkerFactory",
    "Library", "current_context", "load_variable_from_context",
    "Future", "PCMManager", "Action", "Completion", "ContextAwareScheduler",
    "FetchDecision", "Task", "WorkerPhase",
    "ContextMode", "ContextStore", "SnapshotPool", "Tier", "TierFullError",
    "FetchSource", "TransferPlan", "TransferPlanner",
]
