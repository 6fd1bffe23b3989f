"""Pervasive Context Management — the paper's primary contribution, in the
PyTorch port.

Port of ``repro.core``. The user entry
point is the **PCMClient session API** (api.py): declare contexts as
first-class handles (``client.context`` -> pin / release / warm_up /
residency), attach one or several named contexts to tasks
(``@client.task(contexts={...})``), and submit work as Futures
(``client.submit``) or FutureBatches (``client.map``), or stream turns
through sessions (``client.session`` / ``client.stream``, the front door
of ``repro_torch.serving.frontdoor``). The client drives an
**ExecutionBackend** (backend.py): ``PCMManager`` runs tasks live;
``SimulatorBackend`` dry-runs the identical application against the
discrete-event cluster model (``repro_torch.cluster``).

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
               Future; with ``listen()`` workers may be PROCESSES
               (``repro_torch.cluster.node``; RemoteWorker proxies
               translating the same mailbox vocabulary into frames)
  transport.py length-prefixed socket frames with per-connection IO
               threads, heartbeats, and two-layer loss detection (EOF +
               declared-lost) feeding the normal preemption path
  wire.py      versioned wire format for snapshots/templates: arrays via
               checkpoint/io's chunked-sha256 path, engines as recipes
               (receivers load the kernels from the build directory)
  backend.py   ExecutionBackend protocol + SimulatorBackend dry-run
  api.py       PCMClient / ContextHandle / FutureBatch (+ @context_app,
               front-door sessions and streams)
"""

from repro_torch.core.api import (ContextHandle, FutureBatch, PCMClient,
                                  context_app, get_default_client,
                                  get_default_manager, load_context,
                                  make_recipe, set_default_manager)
from repro_torch.core.backend import (ExecutionBackend, LiveBackend,
                                      SimTaskResult, SimulatorBackend)
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
from repro_torch.core.transport import (Connection, Listener, Router,
                                        TransportError)
from repro_torch.core.wire import (WireError, decode_snapshot,
                                   decode_template, encode_snapshot,
                                   encode_template)

__all__ = [
    "ContextHandle", "FutureBatch", "PCMClient", "context_app",
    "get_default_client", "get_default_manager", "load_context",
    "make_recipe", "set_default_manager", "ExecutionBackend", "LiveBackend",
    "SimTaskResult", "SimulatorBackend", "Context", "ContextRecipe", "ContextSnapshot", "PeerExportError",
    "export_context", "materialize", "restore_context", "snapshot_context",
    "ElasticRunner", "PoolDirective", "WorkerFactory",
    "Library", "current_context", "load_variable_from_context",
    "Future", "PCMManager", "Action", "Completion", "ContextAwareScheduler",
    "FetchDecision", "Task", "WorkerPhase",
    "ContextMode", "ContextStore", "SnapshotPool", "Tier", "TierFullError",
    "FetchSource", "TransferPlan", "TransferPlanner",
    "Connection", "Listener", "Router", "TransportError",
    "WireError", "decode_snapshot", "decode_template", "encode_snapshot",
    "encode_template",
]
