"""The Myrmics runtime facade (paper SV).

Ties together the discrete-event engine, the sharded region directory,
the dependency engine and the scheduler hierarchy.  The runtime logic
itself lives in role-scoped agents:

* :mod:`.sched_agent` — scheduler-core work: spawn handling, dependency
  traversal, packing + hierarchical descent, completion/quiesce effects
  and region-ownership migration;
* :mod:`.worker_agent` — worker-core work: dispatch intake, DMA, task
  execution, sys_wait suspend/resume, straggler backups, failures;
* :mod:`.alloc` — the memory API (sys_ralloc/alloc/balloc/free) acting
  on the owning scheduler's directory shard.

The *programming surface* lives in :mod:`.api`: access annotations
(``In``/``Out``/``InOut``/``Safe``), the ``@task`` decorator that
derives a spawn's dependency footprint from the task signature, the
typed ``RegionRef``/``ObjRef`` handles, and the ``RunReport`` returned
by :meth:`Myrmics.run`.  This module defines the execution-side surface
(``Task``, ``TaskContext``, ``Myrmics``) and wires the agents together.
The agents communicate only through the reified message/substrate
interface (:mod:`.substrate`): every cross-core interaction is a
``Message`` handed to ``rt.sub``, and ``Myrmics(backend=...)`` selects
which substrate executes it:

* ``backend="sim"`` — :class:`~.substrate.SimSubstrate`: the
  deterministic discrete-event engine with paper-calibrated
  virtual-cycle charges.  Task bodies (Python callables, or pure
  ``duration=`` placeholders) run synchronously inside the event loop,
  so this backend is for scheduling studies, not throughput.
* ``backend="threads"`` — :class:`~.backend_threads.ThreadSubstrate`:
  a real concurrent executor with a decentralized scheduler tier.
  Every scheduler node drains its own mailbox on a dedicated thread
  (handlers for different shards run concurrently); worker cores are a
  thread pool running actual Python/JAX task bodies in parallel
  against the object store; DMA/compute charges become wall-clock
  measurements — including per-scheduler queue delay — in the
  ``RunReport``.
* ``backend="procs"`` — :class:`~.backend_procs.ProcSubstrate`: the
  scheduler tier as above, but every worker node is a forked OS
  process speaking serialized ``Message`` frames over a Unix socket —
  task bodies run outside the GIL entirely, with footprint snapshots
  shipped in and write-backs shipped out (the paper's DMA model).

A task function has signature ``fn(ctx, *args)``.  Under the
declarative API each argument arrives as the handle the spawner passed
(so ``ref.read()`` works); under the legacy ``list[Arg]`` shim it is
the raw nid (or the value, for SAFE args).  Functions may be
generators, in which case ``yield ctx.wait([...])`` suspends the task
until the waited arguments quiesce (sys_wait).
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass
from typing import Any, Callable

from .api import (
    Arg,
    In,
    InOut,
    ObjRef,
    Out,
    RegionRef,
    RunReport,
    Safe,
    TaskFn,
    free_nid,
    nid_of,
    task,
    value_nid,
)
from .deps import DepEngine, Sanitizer
from .regions import MODE_READ, MODE_WRITE, ROOT_RID, Directory
from .sched import Hierarchy, SchedNode, WorkerNode
from .sim import CostModel, Engine
from .substrate import SimSubstrate

__all__ = [
    "Arg", "In", "Out", "InOut", "Safe", "task", "TaskFn",
    "RegionRef", "ObjRef", "RunReport",
    "Task", "TaskContext", "WaitSpec", "Myrmics",
]

# -- task ----------------------------------------------------------------------

SPAWNED, READY, DISPATCHED, RUNNING, WAITING, DONE = range(6)


class Task:
    _ids = itertools.count()

    def __init__(self, fn: Callable | None, args: list[Arg],
                 parent: "Task | None", duration: float = 0.0,
                 name: str | None = None, call: tuple | None = None):
        self.tid = next(Task._ids)
        self.fn = fn
        self.args = args
        self.call = call        # declarative spawns: (pos values, kw values)
        self.parent = parent
        # precomputed ancestor set (identity semantics — Task has no
        # __eq__): the dependency engine's per-queue-entry ancestor
        # checks become one set hit instead of a parent-chain walk
        self._anc = (parent._anc | {parent}) if parent is not None \
            else frozenset()
        self.duration = duration
        self.name = name or (fn.__name__ if fn is not None else f"t{self.tid}")
        self.state = SPAWNED
        self.owner: SchedNode | None = None
        self.worker: WorkerNode | None = None
        self.dep_args = [a for a in args if not a.safe]
        self.satisfied = 0
        self.wait_remaining = 0
        self.pack_by_worker: dict[str, int] = {}
        self.gen = None                 # generator state when suspended
        self.extra: tuple = ()          # extra main() positional args
        self.completed = False          # monotonic (backup-safe) flag
        self.backup_spawned = False
        self.occ_weight = 1.0           # queued-work estimate (set at packing)
        self.stolen = 0                 # times re-homed by work stealing
        # sanitizer logical clocks (SP-bags-style happens-before): the
        # task's own op counter, and the parent's counter value at this
        # task's spawn — a parent access precedes a child access iff it
        # precedes the spawn edge.  Plain int bookkeeping, maintained
        # unconditionally (spawns of one parent are program-ordered on
        # its executing thread); only read when sanitize=True.
        self.san_clock = 0
        self.san_spawn_clock = parent.san_clock if parent is not None else 0
        if parent is not None:
            parent.san_clock += 1

    def __repr__(self) -> str:
        return f"<Task {self.name}#{self.tid}>"

    def arg_nids(self) -> list[int]:
        return [a.nid for a in self.dep_args]


@dataclass
class WaitSpec:
    args: list[Arg]


# -- task context ---------------------------------------------------------------


class TaskContext:
    """API surface available inside a running task (paper Fig. 4)."""

    def __init__(self, rt: "Myrmics", task: Task, worker: WorkerNode,
                 t0: float):
        self.rt = rt
        self.task = task
        self.worker = worker
        self.t0 = t0
        self.cursor = 0.0   # virtual cycles consumed so far by this activation
        self._spawn_buf: list[Task] | None = None   # threads-backend coalescing

    # --- coalesced spawn flushing (threads backend) -----------------------------
    def buffer_spawn(self, task: Task) -> None:
        if self._spawn_buf is None:
            self._spawn_buf = []
        self._spawn_buf.append(task)

    def flush_spawns(self) -> None:
        """Flush buffered child spawns as one marshalled batch call.
        Legal because dependencies are only observable at a wait: spawn
        processing (footprint validation, dependency enqueues) defers to
        the next wait / runtime call / body end, collapsing per-spawn
        mailbox round-trips into one."""
        buf, self._spawn_buf = self._spawn_buf, None
        if buf:
            self.rt.sub.call("sys_spawn_batch", tuple(buf), self)

    # --- time -----------------------------------------------------------------
    def compute(self, cycles: float) -> None:
        self.cursor += cycles

    @property
    def now(self) -> float:
        return self.t0 + self.cursor

    @property
    def worker_id(self) -> str:
        return self.worker.core_id

    # --- memory ----------------------------------------------------------------
    def ralloc(self, parent_rid: int | RegionRef = ROOT_RID,
               level_hint: int = 10**9,
               label: str | None = None) -> RegionRef:
        self.flush_spawns()   # keep spawn/alloc ordering observable
        self.cursor += self.rt.cost.worker_alloc_call
        rid = self.rt.sub.call("sys_ralloc", nid_of(parent_rid), level_hint,
                               self, label)
        return RegionRef(rid, label, self.rt.dir)

    def alloc(self, size: int, rid: int | RegionRef = ROOT_RID,
              label: str | None = None) -> ObjRef:
        self.flush_spawns()
        self.cursor += self.rt.cost.worker_alloc_call
        oid = self.rt.sub.call("sys_alloc", size, nid_of(rid), self, label)
        return ObjRef(oid, label, self.rt.dir)

    def balloc(self, size: int, rid: int | RegionRef, num: int,
               label: str | None = None) -> list[ObjRef]:
        self.flush_spawns()
        self.cursor += self.rt.cost.worker_alloc_call
        oids = self.rt.sub.call("sys_balloc", size, nid_of(rid), num, self,
                                label)
        return [ObjRef(o, f"{label}[{i}]" if label else None, self.rt.dir)
                for i, o in enumerate(oids)]

    def free(self, oid: int | ObjRef) -> None:
        self.flush_spawns()
        self.cursor += self.rt.cost.worker_alloc_call
        self.rt.sub.call("sys_free", free_nid(oid, False, "free"), self)

    def rfree(self, rid: int | RegionRef) -> None:
        self.flush_spawns()
        self.cursor += self.rt.cost.worker_alloc_call
        self.rt.sub.call("sys_rfree", free_nid(rid, True, "rfree"), self)

    # --- object store (real mode) -----------------------------------------------
    def read(self, oid: int | ObjRef) -> Any:
        nid = value_nid(oid, self.rt.dir, "read")
        if self.rt.san is not None:
            self.rt.san.check(self.task, nid, MODE_READ)
        else:
            self.rt.check_access(self.task, nid, MODE_READ)
        return self.rt.storage.get(nid)

    def write(self, oid: int | ObjRef, value: Any) -> None:
        nid = value_nid(oid, self.rt.dir, "write")
        if self.rt.san is not None:
            self.rt.san.check(self.task, nid, MODE_WRITE)
        else:
            self.rt.check_access(self.task, nid, MODE_WRITE)
        self.rt.storage[nid] = value

    # --- tasking ------------------------------------------------------------------
    def spawn(self, fn: "TaskFn | Callable | None", *args,
              duration: float = 0.0, name: str | None = None,
              **kwargs) -> Task:
        """Spawn a child task.

        Declarative form: ``fn`` is ``@task``-decorated and ``*args`` /
        ``**kwargs`` are the handles (and SAFE values) its signature
        declares — the dependency footprint is derived from the access
        annotations.  Legacy shim: ``fn`` is a plain callable (or None
        for pure-duration virtual tasks) and the single positional
        argument is the hand-assembled ``list[Arg]`` footprint.
        """
        self.cursor += self.rt.cost.worker_spawn_call
        fn, largs, call = _lower_spawn(fn, args, kwargs)
        return self.rt.sys_spawn(fn, largs, self, duration, name, call)

    def wait(self, args: list[Arg]) -> WaitSpec:
        """Use as ``yield ctx.wait([...])`` inside a generator task."""
        self.flush_spawns()   # dependencies become observable here
        self.cursor += self.rt.cost.worker_wait_call
        return WaitSpec(args)


def _lower_spawn(fn, args: tuple, kwargs: dict):
    """Shared spawn-argument lowering for the parallel and serial
    contexts: returns ``(plain_fn, footprint, call)`` where ``call`` is
    the ``(pos, kw)`` values the task body is invoked with (None for
    the legacy shim, which reconstructs them from the footprint)."""
    if isinstance(fn, TaskFn):
        largs, pos, kw = fn.lower(args, kwargs)
        return fn.fn, largs, (pos, kw)
    if kwargs:
        raise TypeError(
            "spawn with keyword task arguments requires a @task-decorated "
            f"function, got {fn!r}")
    if not args:
        return fn, [], None
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        largs = list(args[0])
        for a in largs:
            if not isinstance(a, Arg):
                raise TypeError(
                    f"legacy spawn footprint entries must be In/Out/InOut/"
                    f"Safe specs, got {a!r}")
        return fn, largs, None
    raise TypeError(
        "spawn with positional handle arguments requires a @task-decorated "
        f"function, got {fn!r} (or pass a legacy [In(..)/Out(..)] list)")


def resolve_call(task: Task) -> tuple[list, dict]:
    """The values a task function receives: the bound call values for
    declarative spawns, or — for the legacy shim — the SAFE value, the
    originating handle when the spawner passed one, or the raw nid."""
    if task.call is not None:
        pos, kw = task.call
        return list(pos) + list(task.extra), dict(kw)
    vals = [a.value if a.safe else (a.ref if a.ref is not None else a.nid)
            for a in task.args]
    return vals + list(task.extra), {}


# -- the runtime facade ----------------------------------------------------------


class Myrmics:
    """One runtime instance = one simulated machine + one application run.

    The facade owns the shared state (substrate, hierarchy, sharded
    directory, dependency engine, object store, counters) and delegates
    all behaviour to the role-scoped agents it wires together.
    ``backend`` selects the substrate executing the agents' messages:
    ``"sim"`` (deterministic virtual time, the default), ``"threads"``
    (real concurrent execution; see :mod:`.backend_threads`) or
    ``"procs"`` (real multi-process execution over serialized message
    frames; see :mod:`.backend_procs`).
    ``migrate_threshold`` opts in to SV-C region-ownership migration:
    a scheduler owning more than that many directory nodes offers
    subtrees to underloaded siblings (default off — virtual-time results
    are then identical to the pre-sharding runtime).
    ``coalesce`` (default on) batches the per-argument control-plane
    messages: dependency enqueues, releases and the quiesce/ready
    notification cascades travel as one ``*_batch`` message per
    (source, owner) pair, and — on the threads backend — a task body's
    ``ctx.spawn``s flush as one marshalled batch at the next
    wait/runtime call/body end.  ``coalesce=False`` is the escape hatch
    reproducing the per-arg message stream (and its virtual-time
    figures) byte-identically.
    ``steal`` (default on) enables work stealing between worker pools
    plus the region-affinity placement term: a leaf scheduler whose live
    workers are starving first rebalances its own queues, then sends a
    charged ``s_steal_req`` up the tree; the most-loaded subtree serves
    as the victim, re-homing queued-but-undispatched tasks when the
    steal gate passes (estimated compute saved > DMA cost of moving the
    task's packed footprint).  ``steal=False`` is the escape hatch
    reproducing the steal-free schedules byte-identically (pinned like
    ``coalesce``).
    ``sanitize`` (default off) arms the dynamic footprint sanitizer:
    every task-body ``.read()``/``.write()`` is validated against the
    executing task's declared footprint and checked against an
    SP-bags-style per-object shadow, so two conflicting accesses not
    ordered by the dependency graph raise
    :class:`~.deps.DeterminacyRaceError` — catching annotation lies and
    scheduler races alike, on both backends.  Off, the access hot path
    is untouched (``rt.san is None``) and all virtual-time schedules
    stay byte-identical.
    """

    def __init__(self, n_workers: int = 4, sched_levels: list[int] | None = None,
                 cost: CostModel | None = None, policy_p: int = 20,
                 max_events: int | None = 50_000_000,
                 migrate_threshold: int | None = None,
                 backend: str = "sim", max_wall_s: float = 600.0,
                 coalesce: bool = True, steal: bool = True,
                 sanitize: bool = False, faults=None):
        from .alloc import AllocAgent
        from .sched_agent import DepEffects, SchedAgent
        from .worker_agent import WorkerAgent

        if backend not in ("sim", "threads", "procs"):
            raise ValueError(
                f"unknown backend {backend!r}: sim | threads | procs")
        if sanitize and backend == "procs":
            raise ValueError(
                "sanitize=True needs a shared-memory backend (sim | "
                "threads): the procs workers run task bodies in separate "
                "address spaces, so the sanitizer's shadow state cannot "
                "observe their accesses")
        self.backend = backend
        self.coalesce = coalesce
        self.steal = steal
        self.sanitize = sanitize
        self.engine = Engine()
        self.cost = cost or CostModel.heterogeneous()
        self.hier = Hierarchy.build(
            self.engine, self.cost, n_workers, sched_levels or [1]
        )
        self.dir = Directory(root_owner=self.hier.root.core_id)
        self.root = RegionRef(ROOT_RID, "root", self.dir)
        self.storage: dict[int, Any] = {}
        self.labels: dict[int, str] = {}   # nid -> app label (for oracles)
        self.policy_p = policy_p
        self.max_events = max_events
        # shared run counters: mutated from whichever scheduler context
        # handles the spawn/completion — under the threads backend those
        # are different OS threads, so increments take this lock.
        self.count_lock = threading.Lock()
        self.tasks_spawned = 0
        self.tasks_done = 0
        self.main_task: Task | None = None
        # -- scale-out features (straggler backup / failure / elastic) --
        self.backup_factor: float | None = None   # e.g. 3.0 enables backups
        self.backups_spawned = 0
        self.service_ewma: float | None = None
        self.dead_workers: set[str] = set()
        self.dead_scheds: set[str] = set()
        self.tasks_rescheduled = 0
        # -- SV-C ownership migration (opt-in) --
        self.migrate_threshold = migrate_threshold
        self.migrations = 0
        self.nodes_migrated = 0
        # -- work stealing (default on; counters under count_lock) --
        self.steals_attempted = 0
        self.steals_granted = 0
        self.steal_tasks_moved = 0
        self.steal_bytes_moved = 0
        # request hop budget: generous bound on up+down relays so stale
        # occupancy counters can never ping-pong a request forever
        depth = max(s.depth for s in self.hier.scheds)
        self.steal_ttl = 4 * (depth + 1) + 4
        # subtree membership caches: scheduler core_id -> ids below it
        self.subtree_ids: dict[str, set[str]] = {
            s.core_id: {x.core_id for x in s.subtree_scheds()}
            for s in self.hier.scheds
        }
        self.subtree_workers: dict[str, set[str]] = {
            s.core_id: s.subtree_worker_ids() for s in self.hier.scheds
        }
        # -- role-scoped agents, one per scheduler node (decentralized
        #    scheduler tier: each owns its dep/dir shard, ancestry cache
        #    and descent counters; peers are reached via the substrate) --
        self.sched_agents = {
            s.core_id: SchedAgent(self, s) for s in self.hier.scheds
        }
        self.alloc_agents = {
            cid: AllocAgent(self, agent.cache)
            for cid, agent in self.sched_agents.items()
        }
        if backend == "threads":
            from .backend_threads import ThreadSubstrate, ThreadWorkerAgent
            self.sub = ThreadSubstrate(self.hier, max_wall_s=max_wall_s)
            self.worker_agent = ThreadWorkerAgent(self)
        elif backend == "procs":
            from .backend_procs import ProcSubstrate, ProcWorkerAgent
            self.sub = ProcSubstrate(self.hier, max_wall_s=max_wall_s)
            self.worker_agent = ProcWorkerAgent(self)
            self.sub.runtime = self
            self.sub.agent = self.worker_agent
        else:
            self.sub = SimSubstrate(self.hier)
            self.worker_agent = WorkerAgent(self)
        self.deps = DepEngine(self.dir, DepEffects(self), rt=self)
        # the dynamic footprint sanitizer: None when off, so the access
        # hot path costs one attribute test and nothing else
        self.san = Sanitizer(self) if sanitize else None
        # the fault layer (detection / injection / replay / snapshots):
        # None when off — every recovery hook is gated on this attribute
        # so the faults=None hot paths stay byte-identical (§1.10)
        if faults is not None:
            from .faults import FaultInjector, normalize_faults
            self.fault_plan = normalize_faults(faults)
            self.fault_injector = FaultInjector(self, self.fault_plan)
        else:
            self.fault_plan = None
            self.fault_injector = None
        self.sub.bind(self._handlers(), is_done=self._program_done,
                      route=self._call_dest)

    def agent_of(self, sched: SchedNode | str) -> "SchedAgent":
        """The per-scheduler agent instance for a scheduler node."""
        core_id = sched if isinstance(sched, str) else sched.core_id
        return self.sched_agents[core_id]

    def alloc_of(self, nid: int) -> "AllocAgent":
        """The allocation agent of the scheduler owning ``nid``."""
        return self.alloc_agents[self.dir.owner_of(nid)]

    @property
    def sched_agent(self) -> "SchedAgent":
        """Back-compat alias: the root scheduler's agent."""
        return self.sched_agents[self.hier.root.core_id]

    @property
    def alloc_agent(self) -> "AllocAgent":
        """Back-compat alias: the root scheduler's allocation agent."""
        return self.alloc_agents[self.hier.root.core_id]

    def _call_dest(self, kind: str, args: tuple) -> SchedNode:
        """Destination scheduler of a marshalled runtime-service call
        (the threaded substrate routes the call to this scheduler's
        mailbox; the sim substrate dispatches synchronously)."""
        if kind in ("sys_spawn", "sys_spawn_batch"):
            return args[1].task.owner          # (task(s), ctx)
        if kind == "sys_ralloc":
            return self.node_owner(args[0])    # (parent_rid, ...)
        if kind in ("sys_alloc", "sys_balloc"):
            return self.node_owner(args[1])    # (size, rid, ...)
        return self.node_owner(args[0])        # sys_free / sys_rfree

    def _handlers(self) -> dict:
        """The message-kind registry: every cross-core interaction the
        agents emit resolves to one of these callables (messages are
        plain data, so substrates can marshal them across threads).
        Scheduler-role kinds resolve to the *destination* scheduler's
        agent instance, so each handler runs against its own shard and
        cache — the decentralized-tier invariant."""
        wa, deps = self.worker_agent, self.deps
        agent = self.agent_of
        return {
            # charge-only messages (accounting; no destination effect)
            "noop": lambda *a: None,
            # scheduler-role handlers (per-destination agent instances)
            "s_spawn": lambda sched, task: agent(sched).h_spawn(task),
            "s_enqueue": deps.h_enqueue,
            "s_mark_ready": lambda task: agent(task.owner).mark_ready(task),
            "s_descend": lambda sched, task: agent(sched).h_descend(task),
            "s_wait": lambda task, args: agent(task.owner).h_wait(task, args),
            "s_complete": lambda task: agent(task.owner).h_complete(task),
            # work stealing: starvation check, parent-relayed request,
            # victim grant (the thief leaf re-dispatches)
            "s_steal_check": lambda sched: agent(sched).maybe_steal(),
            "s_steal_req": lambda sched, thief_id, ttl:
                agent(sched).h_steal_req(thief_id, ttl),
            "s_steal_grant": lambda sched, tasks:
                agent(sched).h_steal_grant(tasks),
            "s_release": deps.h_release,
            "s_arg_ready": deps.fx._h_arg_ready,
            "s_wait_ready": deps.fx._h_wait_ready,
            "d_quiesce": deps.recv_quiesce,
            # coalesced control-plane batches (one message, many ops)
            "s_enqueue_batch": deps.h_enqueue_batch,
            "s_release_batch": deps.h_release_batch,
            "d_quiesce_batch": deps.h_quiesce_batch,
            "s_arg_ready_batch": deps.fx._h_arg_ready_batch,
            "s_wait_ready_batch": deps.fx._h_wait_ready_batch,
            # worker-role handlers (dispatched to whichever worker agent
            # the backend installed)
            "w_dispatch": wa.h_dispatch,
            "w_resume": wa.h_resume,
            "w_try_start": wa.try_start,
            "w_exec": wa.exec_task,
            "w_resume_retry": wa.resume_retry,
            "w_backup_check": wa.backup_check,
            "w_kill": wa.do_kill,
            # fault detection/injection (uniform across backends): real
            # detectors (procs socket EOF, scheduler heartbeat) and the
            # injector's timers both land here
            "w_dead": self._h_worker_dead,
            "s_dead": self._h_sched_dead,
            "f_heartbeat": self._h_heartbeat,
            # synchronous runtime services (task body -> scheduler side),
            # routed to the owning scheduler's agent (see _call_dest)
            "sys_spawn": lambda task, ctx:
                agent(ctx.task.owner).sys_spawn(task, ctx),
            "sys_spawn_batch": lambda tasks, ctx:
                [agent(ctx.task.owner).sys_spawn(t, ctx) for t in tasks],
            "sys_ralloc": lambda parent_rid, *a:
                self.alloc_of(parent_rid).sys_ralloc(parent_rid, *a),
            "sys_alloc": lambda size, rid, *a:
                self.alloc_of(rid).sys_alloc(size, rid, *a),
            "sys_balloc": lambda size, rid, *a:
                self.alloc_of(rid).sys_balloc(size, rid, *a),
            "sys_free": lambda oid, *a: self.alloc_of(oid).sys_free(oid, *a),
            "sys_rfree": lambda rid, *a: self.alloc_of(rid).sys_rfree(rid, *a),
        }

    def _program_done(self) -> bool:
        return (self.main_task is not None and self.main_task.completed
                and self.tasks_done == self.tasks_spawned)

    # ---- helpers -------------------------------------------------------------

    def sched_of(self, core_id: str) -> SchedNode:
        return self.hier.by_id[core_id]

    def node_owner(self, nid: int) -> SchedNode:
        return self.hier.by_id[self.dir.owner_of(nid)]

    def check_access(self, task: Task, oid: int | ObjRef, mode: str) -> None:
        """A task may touch an object only if one of its (non-safe,
        transferable) arguments covers it with sufficient permissions."""
        oid = nid_of(oid)
        for a in task.dep_args:
            if a.notransfer:
                continue
            if mode == MODE_WRITE and a.mode != MODE_WRITE:
                continue
            if self.dir.is_ancestor_or_self(a.nid, oid):
                return
        raise PermissionError(
            f"{task} has no {mode}-covering argument for node {oid}"
        )

    # ---- delegated API (stable surface; behaviour lives in the agents) -------

    def sys_spawn(self, fn: Callable | None, args: list[Arg],
                  ctx: TaskContext, duration: float, name: str | None,
                  call: tuple | None = None) -> Task:
        task = Task(fn, args, parent=ctx.task, duration=duration, name=name,
                    call=call)
        if (self.coalesce and self.backend == "threads"
                and self.sub.executing_id() is None):
            # worker-side coalescing: buffer the spawn; it flushes as
            # one marshalled sys_spawn_batch at the next wait / runtime
            # call / body end (dependencies only observable at wait)
            ctx.buffer_spawn(task)
            return task
        self.sub.call("sys_spawn", task, ctx)
        return task

    def kill_worker(self, worker_id: str, at: float | None = None) -> None:
        self.worker_agent.kill_worker(worker_id, at)

    def kill_scheduler(self, sched_id: str, at: float | None = None) -> None:
        """Kill a scheduler node: its worker domains die (their tasks
        replay elsewhere) and its directory/dep shards evacuate onto a
        live sibling.  Immediate when ``at`` is None, else a timer
        (virtual cycles on sim, wall seconds on threads/procs)."""
        if at is None:
            self._h_sched_dead(sched_id, "killed")
        else:
            from .substrate import Message
            self.sub.timer(at, Message("s_dead", (sched_id, "killed")))

    def add_worker(self, leaf_sched_id: str) -> str:
        return self.worker_agent.add_worker(leaf_sched_id)

    # ---- fault handling (detection -> recovery; see faults.py) ---------------

    def _h_worker_dead(self, worker_id: str, reason: str) -> None:
        """Uniform worker-death entry point: injected kills, procs
        socket EOF and explicit ``kill_worker`` all converge here."""
        if worker_id in self.dead_workers:
            return
        if self.fault_injector is not None:
            self.fault_injector.note_detection(f"worker:{reason}")
        self.worker_agent.do_kill(worker_id)

    def _h_sched_dead(self, sched_id: str, reason: str) -> None:
        """Uniform scheduler-death entry point.  Injected/logical death
        evacuates the dead node's shards onto a sibling; a *real*
        mailbox-thread death (heartbeat detection) fails fast — the dead
        thread can no longer drain its shard, so recovery-in-context is
        impossible and hanging is the alternative."""
        if sched_id in self.dead_scheds:
            return
        if self.fault_injector is not None:
            self.fault_injector.note_detection(f"sched:{reason}")
        from .faults import SchedulerDiedError, evacuate_scheduler
        if reason == "heartbeat":
            raise SchedulerDiedError(
                sched_id, "mailbox thread died (heartbeat missed); its "
                "shard can no longer drain — failing fast instead of "
                "hanging")
        evacuate_scheduler(self, sched_id, reason)

    def _h_heartbeat(self) -> None:
        """Wall-clock scheduler liveness probe: every mailbox thread
        must still be alive; a dead one can never drain its queue, which
        today would hang the run.  Re-arms itself."""
        inj = self.fault_injector
        sub = self.sub
        if inj is None or self.backend == "sim" or getattr(
                sub, "_aborting", False):
            return
        threads = {t.name: t for t in getattr(sub, "_threads", ())}
        for s in self.hier.scheds:
            cid = s.core_id
            if cid in self.dead_scheds:
                continue
            t = threads.get(f"myrmics-{cid}")
            if t is not None and not t.is_alive():
                self._h_sched_dead(cid, "heartbeat")
        from .substrate import Message
        sub.timer(sub.now + inj.plan.heartbeat_s, Message("f_heartbeat", ()))

    # ---- program entry ----------------------------------------------------------

    def run(self, main_fn: TaskFn | Callable, *main_extra: Any,
            until: float | None = None) -> RunReport:
        if isinstance(main_fn, TaskFn):
            main_fn = main_fn.fn
        main = Task(main_fn, [InOut(self.root)], parent=None, name="main")
        main.owner = self.hier.root
        main.extra = main_extra
        self.main_task = main
        self.tasks_spawned += 1
        # main implicitly holds the root region (no queueing).
        self.deps.node(ROOT_RID).holders[main] = MODE_WRITE
        main.satisfied = len(main.dep_args)
        main.state = READY
        self.agent_of(main.owner).begin_packing(main)
        if self.fault_injector is not None:
            self.fault_injector.arm()
        self.sub.run(until=until, max_events=self.max_events)
        return self.report()

    def labelled_storage(self) -> dict[str, Any]:
        """Final object values keyed by application label — the quantity
        compared against the serial oracle."""
        return {
            self.labels[nid]: v for nid, v in self.storage.items()
            if nid in self.labels
        }

    def report(self) -> RunReport:
        workers = {
            w.core_id: self.sub.stats(w) for w in self.hier.workers
        }
        scheds = {s.core_id: self.sub.stats(s) for s in self.hier.scheds}
        return RunReport(
            total_cycles=self.sub.now,
            tasks_spawned=self.tasks_spawned,
            tasks_done=self.tasks_done,
            events=self.sub.events_processed,
            workers=workers,
            scheds=scheds,
            region_load={s.core_id: s.region_load
                         for s in self.hier.scheds},
            migrations=self.migrations,
            nodes_migrated=self.nodes_migrated,
            backend=self.backend,
            msg_kinds=self.sub.msg_kind_summary(),
            steals={
                "attempted": self.steals_attempted,
                "granted": self.steals_granted,
                "tasks_moved": self.steal_tasks_moved,
                "bytes_moved": self.steal_bytes_moved,
            },
            sanitize=(self.san.counters() if self.san is not None else
                      {"enabled": False, "accesses_checked": 0,
                       "violations": 0}),
            wire=(self.sub.wire_report()
                  if hasattr(self.sub, "wire_report") else {}),
            procs=(self.sub.proc_report()
                   if hasattr(self.sub, "proc_report") else {}),
            faults=(self.fault_injector.counters()
                    if self.fault_injector is not None
                    else {"enabled": False}),
        )


def __getattr__(name: str):
    # API compatibility: the serial oracle moved to .serial but remains
    # importable from here (lazily, to avoid a circular import).
    if name in ("SerialRuntime", "SerialContext"):
        from . import serial
        return getattr(serial, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
