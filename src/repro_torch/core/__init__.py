"""Myrmics core runtime: hierarchical dependency-aware task scheduling.

The paper's primary contribution (regions, dependency queues,
hierarchical schedulers, locality/load-balance placement) lives here,
split into role-scoped agents wired together by the ``runtime`` facade:

* ``api``          — declarative programming surface: ``@task``
  signatures, ``In/Out/InOut/Safe`` access annotations, typed
  ``RegionRef``/``ObjRef`` handles, ``RunReport``
* ``substrate``    — the message substrate seam (``Message``,
  ``Substrate``, ``SimSubstrate``): agents talk to this, backends
  implement it
* ``backend_threads`` — the real concurrent executor
  (``Myrmics(backend="threads")``): one mailbox + thread per scheduler
  node, plus a worker pool
* ``regions``      — sharded region directory (one shard per scheduler)
* ``deps``         — dependency state machine, sharded per scheduler
  (``DepShard``) behind a routing coordinator (``DepEngine``)
* ``sched``        — scheduler/worker tree + locality/balance scoring
* ``sched_agent``  — scheduler-role handlers (spawn/descend/complete/migrate)
* ``worker_agent`` — sim worker-role handlers (dispatch/DMA/exec/wait/backup)
* ``alloc``        — memory API acting on the owning shard
* ``serial``       — the serial-elision oracle
"""

from .api import (
    NOTRANSFER,
    Arg,
    In,
    InOut,
    ObjRef,
    Out,
    RegionRef,
    RunReport,
    Safe,
    TaskFn,
    current_ctx,
    task,
)
from .deps import DepEngine, DepShard, DeterminacyRaceError
from .regions import (
    MODE_READ,
    MODE_WRITE,
    ROOT_RID,
    AncestryCache,
    Directory,
    DirectoryShard,
)
from .runtime import (
    Myrmics,
    Task,
    TaskContext,
)
from .serial import SerialContext, SerialRuntime
from .sim import CostModel, Engine
from .substrate import Message, SimSubstrate, Substrate

__all__ = [
    "Arg", "In", "InOut", "Out", "Safe", "NOTRANSFER",
    "task", "TaskFn", "RegionRef", "ObjRef", "RunReport", "current_ctx",
    "Myrmics", "SerialRuntime", "SerialContext", "Task", "TaskContext",
    "CostModel", "Engine", "Directory", "DirectoryShard", "AncestryCache",
    "DepEngine", "DepShard", "DeterminacyRaceError",
    "Message", "Substrate", "SimSubstrate",
    "MODE_READ", "MODE_WRITE", "ROOT_RID",
]
