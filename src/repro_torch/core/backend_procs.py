"""The process backend: worker nodes as OS processes, messages on a wire.

``Myrmics(backend="procs")`` is the first configuration where task
bodies run outside the runtime's address space: every worker node is a
forked OS process speaking length-prefixed binary frames
(:meth:`~.substrate.Message.to_wire`) over a Unix socket pair — the
reproduction's stand-in for the paper's non-cache-coherent
NoC mailboxes + DMA.  It breaks the GIL ceiling: eight worker
processes run eight task bodies on eight cores, full stop, where the
threads backend only parallelizes bodies that release the GIL.

Division of labour:

* **control plane (host process)** — the scheduler tier is inherited
  unchanged from :class:`~.backend_threads.ThreadSubstrate`: one
  mailbox + thread per scheduler node, the same agents, dependency
  shards, steal protocol and ``update`` bookkeeping.  (The paper's
  scheduler cores share no memory either, but its scheduler-to-
  scheduler traffic carries directory *queries*, which the sharded
  directory answers synchronously here; serializing the scheduler tier
  too would force an async rewrite of every agent.  The worker
  boundary is where the GIL actually bites, so that is the boundary
  this backend moves out of process.)
* **worker tier (one process per worker node)** — forked at ``run()``
  start (before any host thread exists), each child runs a reader
  thread plus a serial executor loop.  The host ships one task at a
  time per worker as an ``x_exec`` frame carrying the task descriptor
  and its *footprint snapshot*: the values, cover modes and ancestry
  of every node the In/Out footprint grants — the paper's DMA model,
  where the footprint tells the runtime exactly what to copy in.
  No other state is shared; a child's writes travel back as explicit
  write-back dictionaries.

Wire protocol (all frames are ``Message`` bodies):

* host → child: ``x_exec (desc, snapshot)``, ``x_resume (tid,
  snapshot)`` (refreshed footprint after a wait), ``x_reply (seq, ok,
  value)``, ``x_stop``.
* child → host: ``x_call (tid, seq, kind, payload, dirty)`` — a
  marshalled ``sys_*`` request; ``x_suspend (tid, wait_args, dirty)``;
  ``x_complete (tid, dirty)``; ``x_error (tid, exc)``.

Write-back rules: a child flushes its dirty values on **every**
outgoing frame — each ``x_call`` (so parent writes are visible to any
child task spawnable after that point, exactly the places the
shared-memory backends make them visible), at suspend (before the
``s_wait`` is processed) and at completion (before ``s_complete``
releases dependants).  Resume re-ships the full refreshed snapshot, so
values produced by awaited children are seen after the wait.

Suspended generators stay resident in their worker process (they
cannot cross the wire); the host keeps per-worker dispatch queues as
the steal surface, so work stealing re-homes only tasks that have not
been shipped yet — the same queued-but-undispatched rule as the other
backends.

Start method: the original forks unless JAX is loaded (XLA's threads
deadlock in a forked child); the port always spawns
(``START_METHOD``).  A forked child cannot use the card once its parent
has run ``cuInit``, and ``torch.cuda.is_available()`` runs it while
``torch.cuda.is_initialized()`` stays false, so that check is not
enough; ``import torch`` already maps ``libcuda``, so its
presence says nothing either.  A child forked after torch has run CPU
work on its OpenMP threads also hangs in its first parallel operation.
Objects that cross the wire hold CPU tensors: a tensor on the card
would be unpickled onto the card in the host, which would set up a
CUDA context there, so a task that writes one fails.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import socket
import struct
import sys
import threading
import time
from collections import deque

from .api import Arg, ObjRef, RegionRef, active_ctx
from .backend_threads import ThreadSubstrate, ThreadWorkerAgent
from .regions import MODE_READ, MODE_WRITE
from .runtime import (
    RUNNING,
    WAITING,
    Task,
    WaitSpec,
    _lower_spawn,
    resolve_call,
)
from .sched import WorkerNode
from .substrate import Message

_LEN = struct.Struct(">Q")      # 8 bytes, as substrate._WIRE_LEN


# -- framing ------------------------------------------------------------------


def _recv_exact(sock: socket.socket, n: int) -> bytearray | None:
    """Read exactly ``n`` bytes; None on EOF.  Into one buffer: a
    ``recv(n - got)`` per chunk allocates that many bytes each time,
    which for a frame of gigabytes costs seconds a chunk."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        try:
            k = sock.recv_into(view[got:])
        except OSError:
            return None
        if not k:
            return None
        got += k
    return buf


def _recv_sized_frame(sock: socket.socket) -> tuple[Message | None, int]:
    """A frame and its bytes on the wire, length prefix included: the
    host's wire stats count what arrived, with no second pickling."""
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None, 0
    (n,) = _LEN.unpack(head)
    data = _recv_exact(sock, n)
    if data is None:
        return None, 0
    return Message.from_wire(data), _LEN.size + n


def _recv_frame(sock: socket.socket) -> Message | None:
    return _recv_sized_frame(sock)[0]


def _frame_bytes(msg: Message) -> bytes:
    data = msg.to_wire()
    return _LEN.pack(len(data)) + data


#: how worker processes start (module docstring)
START_METHOD = "spawn"


def _refuse_device_tensors(nid: int, value) -> None:
    """Refuse a tensor on the card in a written value (module
    docstring): it is never moved to the CPU quietly."""
    torch = sys.modules.get("torch")
    if torch is None:
        return
    todo = [value]
    while todo:
        v = todo.pop()
        if isinstance(v, torch.Tensor):
            if v.device.type != "cpu":
                raise ValueError(
                    f"write({nid}): a tensor on {v.device} on backend='procs'; "
                    "objects that cross the wire hold CPU tensors (move it "
                    "with .cpu() in the task body)")
        elif isinstance(v, dict):
            todo.extend(v.values())
        elif isinstance(v, (list, tuple)):
            todo.extend(v)


def _wire_safe_exc(exc: BaseException) -> BaseException:
    """An exception instance that survives the wire (falls back to a
    RuntimeError carrying the repr when the original does not pickle)."""
    from . import wire
    try:
        wire.dumps(exc)
        return exc
    except wire.WireError:
        return RuntimeError(f"{type(exc).__name__}: {exc}")


# -- host side ----------------------------------------------------------------


class _Channel:
    """Host-side end of one worker process's duplex stream."""

    __slots__ = ("worker", "sock", "proc", "wlock", "reader", "closing")

    def __init__(self, worker: WorkerNode, sock: socket.socket, proc):
        self.worker = worker
        self.sock = sock
        self.proc = proc
        self.wlock = threading.Lock()
        self.reader: threading.Thread | None = None
        self.closing = False


class _HostCtx:
    """The context shim handed to scheduler-side handlers for a
    marshalled call: the handlers only touch ``.task`` (routing +
    footprint validation), ``.worker`` (message source) and ``.now``."""

    __slots__ = ("rt", "task", "worker")

    def __init__(self, rt, task: Task, worker: WorkerNode):
        self.rt = rt
        self.task = task
        self.worker = worker

    @property
    def now(self) -> float:
        return self.rt.sub.now


#: ctx-argument slot per marshalled service kind (the child sends None
#: there; the host substitutes a _HostCtx before dispatch).
_CTX_SLOT = {"sys_ralloc": 2, "sys_alloc": 2, "sys_balloc": 3,
             "sys_free": 1, "sys_rfree": 1}


class ProcSubstrate(ThreadSubstrate):
    """Wall-clock substrate with out-of-process workers: the inherited
    per-scheduler mailbox threads, plus one forked OS process + host
    reader thread per worker node."""

    backend = "procs"

    def __init__(self, hier, max_wall_s: float = 600.0):
        # the pool only carries placeholder work on this backend; real
        # bodies run in the worker processes
        super().__init__(hier, max_wall_s=max_wall_s, n_threads=1)
        self.runtime = None          # set by Myrmics right after construction
        self.agent: "ProcWorkerAgent | None" = None
        self._channels: dict[str, _Channel] = {}
        #: per-frame-kind wire accounting: kind -> [frames, bytes]
        self.wire_kinds: dict[str, list] = {}
        self._wire_lock = threading.Lock()
        #: per-worker process stats (pid, frames/bytes each way, tasks)
        self.proc_stats: dict[str, dict] = {}

    # -- wire accounting -----------------------------------------------------

    def _note_wire(self, kind: str, nbytes: int, wid: str,
                   outbound: bool) -> None:
        with self._wire_lock:
            rec = self.wire_kinds.get(kind)
            if rec is None:
                rec = self.wire_kinds[kind] = [0, 0]
            rec[0] += 1
            rec[1] += nbytes
            st = self.proc_stats[wid]
            if outbound:
                st["frames_out"] += 1
                st["bytes_out"] += nbytes
            else:
                st["frames_in"] += 1
                st["bytes_in"] += nbytes

    def wire_report(self) -> dict:
        """Per-frame-kind wire traffic: frames and bytes on the real
        host<->worker sockets, plus totals."""
        with self._wire_lock:
            per_kind = {k: {"frames": f, "bytes": b}
                        for k, (f, b) in sorted(self.wire_kinds.items())}
        return {
            "per_kind": per_kind,
            "total_frames": sum(v["frames"] for v in per_kind.values()),
            "total_bytes": sum(v["bytes"] for v in per_kind.values()),
        }

    def proc_report(self) -> dict:
        """Per-worker-process stats: pid, frames/bytes each way, tasks
        shipped."""
        with self._wire_lock:
            return {wid: dict(st) for wid, st in self.proc_stats.items()}

    # -- child lifecycle -----------------------------------------------------

    def _start_children(self) -> None:
        rt = self.runtime
        start = START_METHOD
        ctx = multiprocessing.get_context(start)
        # fork every child before starting any host thread (reader
        # threads included): fork + live threads is the classic deadlock.
        # Each pair is created, forked and its child end closed before
        # the next fork — otherwise later children inherit earlier
        # children's socket ends and a dead sibling's channel never
        # reaches EOF (death detection would hang on the duplicate fd).
        for w in self.hier.workers:
            host_sock, child_sock = socket.socketpair()
            proc = ctx.Process(
                target=_child_main,
                args=(host_sock if start == "fork" else None,
                      child_sock, w.core_id, rt.coalesce),
                name=f"myrmics-{w.core_id}", daemon=True)
            proc.start()
            child_sock.close()
            ch = _Channel(w, host_sock, proc)
            self._channels[w.core_id] = ch
            self.proc_stats[w.core_id] = {
                "pid": proc.pid, "frames_out": 0, "bytes_out": 0,
                "frames_in": 0, "bytes_in": 0, "tasks": 0,
            }
        for ch in self._channels.values():
            ch.reader = threading.Thread(
                target=self._reader, args=(ch,),
                name=f"myrmics-rx-{ch.worker.core_id}", daemon=True)
            ch.reader.start()

    def _stop_children(self) -> None:
        for ch in self._channels.values():
            ch.closing = True
            try:
                with ch.wlock:
                    ch.sock.sendall(_frame_bytes(Message("x_stop")))
            except OSError:
                pass
        for ch in self._channels.values():
            ch.proc.join(timeout=5.0)
            if ch.proc.is_alive():
                ch.proc.terminate()
                ch.proc.join(timeout=2.0)
            try:
                ch.sock.close()
            except OSError:
                pass
        for ch in self._channels.values():
            if ch.reader is not None:
                ch.reader.join(timeout=2.0)
        self._channels.clear()

    def run(self, until: float | None = None,
            max_events: int | None = None) -> None:
        self._start_children()
        try:
            super().run(until=until, max_events=max_events)
        finally:
            self._stop_children()

    def kill_channel(self, wid: str) -> int | None:
        """Sever a worker process's channel (kill path): mark it closing
        so the reader's EOF stays quiet, close the socket and terminate
        the child.  The process object stays registered so
        ``_stop_children`` still joins it.  Returns the pid."""
        ch = self._channels.get(wid)
        if ch is None:
            return None
        ch.closing = True
        try:
            ch.sock.close()
        except OSError:
            pass
        pid = ch.proc.pid
        if ch.proc.is_alive():
            ch.proc.terminate()
        return pid

    # -- frames out ----------------------------------------------------------

    def send_frame(self, wid: str, msg: Message) -> None:
        ch = self._channels[wid]
        frame = _frame_bytes(msg)
        try:
            with ch.wlock:
                ch.sock.sendall(frame)
        except OSError as e:
            rt = self.runtime
            if ch.closing or (rt is not None and wid in rt.dead_workers):
                return          # already-detected death: drop quietly
            if rt is not None and rt.fault_injector is not None:
                # recovery armed: surface the uniform death message;
                # the leaf-context kill replays this worker's tasks
                ch.closing = True
                self.dispatch("w_dead", (wid, "send-error"))
                return
            from .faults import WorkerDiedError
            self.fail(WorkerDiedError(
                wid, pid=ch.proc.pid,
                last_task=self.agent.last_task_of(wid),
                detail=f"send failed: {e}"))
            return
        self._note_wire(msg.kind, len(frame), wid, outbound=True)

    # -- frames in -----------------------------------------------------------

    def _reader(self, ch: _Channel) -> None:
        """Host reader for one worker process: write-backs, marshalled
        calls, suspensions and completions all land here."""
        wid = ch.worker.core_id
        while True:
            try:
                msg, nbytes = _recv_sized_frame(ch.sock)
            except Exception as e:      # corrupt frame: fail the run
                self.fail(RuntimeError(
                    f"corrupt frame from worker process {wid}: {e}"))
                return
            if msg is None:             # EOF
                if ch.closing or self._aborting:
                    return
                rt = self.runtime
                try:
                    if rt is not None and rt.fault_injector is not None:
                        # recovery armed: uniform death message — the
                        # kill surgery runs in the leaf's context, this
                        # reader thread just reports and exits
                        ch.closing = True
                        self.dispatch("w_dead", (wid, "eof"))
                    else:
                        from .faults import WorkerDiedError
                        self.fail(WorkerDiedError(
                            wid, pid=ch.proc.pid,
                            last_task=self.agent.last_task_of(wid),
                            detail="socket EOF (child process died)"))
                except BaseException as e:
                    self.fail(e)
                return
            self._note_wire(msg.kind, nbytes, wid, outbound=False)
            self._count_event()
            try:
                self._handle_frame(ch, msg)
            except BaseException as e:
                self.fail(e)
                return

    def _handle_frame(self, ch: _Channel, msg: Message) -> None:
        agent = self.agent
        w = ch.worker
        kind = msg.kind
        if kind == "x_call":
            tid, seq, call_kind, payload, dirty = msg.args
            self._apply_dirty(dirty)
            self._serve_call(ch, tid, seq, call_kind, payload)
        elif kind == "x_complete":
            tid, dirty = msg.args
            self._apply_dirty(dirty)
            agent.on_complete(w, tid)
        elif kind == "x_suspend":
            tid, wait_args, dirty = msg.args
            self._apply_dirty(dirty)
            agent.on_suspend(w, tid, wait_args)
        elif kind == "x_error":
            tid, exc = msg.args
            if not isinstance(exc, BaseException):
                exc = RuntimeError(f"worker process {w.core_id}: {exc!r}")
            self.fail(exc)
        else:
            raise RuntimeError(
                f"unexpected frame kind {kind!r} from worker {w.core_id}")

    def _apply_dirty(self, dirty: dict) -> None:
        """Write-back: a child's object writes land in the host store
        (dict item assignment; same discipline as the threads backend's
        concurrent ctx.write path)."""
        if dirty:
            self.runtime.storage.update(dirty)

    def _serve_call(self, ch: _Channel, tid: int, seq: int, kind: str,
                    payload) -> None:
        """Serve one marshalled ``sys_*`` request: rebuild host-side
        arguments (Tasks for spawns, the ctx shim), route it through the
        inherited ``call`` — the reader thread blocks exactly like a
        pool thread would — and reply."""
        rt = self.runtime
        agent = self.agent
        try:
            parent, worker = agent.inflight_task(tid)
            hctx = _HostCtx(rt, parent, worker)
            if kind == "sys_spawn":
                (desc,) = payload
                task = _build_task(desc, parent)
                self.call(kind, task, hctx)
                result = task.tid
            elif kind == "sys_spawn_batch":
                tasks = [_build_task(d, parent) for d in payload]
                self.call(kind, tuple(tasks), hctx)
                result = [t.tid for t in tasks]
            else:
                args = list(payload)
                slot = _CTX_SLOT.get(kind)
                if slot is not None:
                    args[slot] = hctx
                result = self.call(kind, *args)
            reply = Message("x_reply", (seq, True, result))
        except BaseException as e:
            reply = Message("x_reply", (seq, False, _wire_safe_exc(e)))
        self.send_frame(ch.worker.core_id, reply)


def _build_task(desc: tuple, parent: Task) -> Task:
    """Rebuild a host Task from a child's spawn stub descriptor."""
    fn, largs, call, duration, name = desc
    return Task(fn, list(largs), parent=parent, duration=duration,
                name=name, call=call)


# -- the worker agent (host side) --------------------------------------------


class ProcWorkerAgent(ThreadWorkerAgent):
    """Ships tasks to worker processes one at a time; keeps the
    per-worker dispatch queues host-side as the steal surface."""

    def __init__(self, rt):
        super().__init__(rt)
        # in-flight activations: tid -> (task, worker, wall0)
        self._inflight: dict[int, tuple] = {}
        self._busy: dict[str, int] = {}     # worker id -> activations shipped
        # suspended generators resident in each child process (they
        # cannot cross the wire, so they die with it): worker id -> tids
        self._parked: dict[str, set[int]] = {}
        # wid -> in-flight activations reaped from a dead child, staged
        # between _collect_victims and the _torn_victims snapshot hook
        self._torn: dict[str, list] = {}

    def inflight_task(self, tid: int) -> tuple:
        with self._qlock:
            task, w, _ = self._inflight[tid]
        return task, w

    def last_task_of(self, wid: str):
        """The task in flight on a worker process (diagnostics for
        :class:`~.faults.WorkerDiedError`)."""
        with self._qlock:
            for task, w, _ in self._inflight.values():
                if w.core_id == wid:
                    return task
        return None

    # ---- fault handling -------------------------------------------------------

    def _collect_victims(self, w: WorkerNode) -> list:
        """Queued tasks (host-side, replayable) plus the activation in
        flight inside the dead process (RUNNING — replayable, its torn
        writes roll back if snapshots are on).  A *suspended* generator
        resident in the child is unrecoverable: its continuation lived
        only in that address space, so the run fails loudly instead of
        silently replaying side effects (at-most-once limit, DESIGN.md
        §1.12)."""
        rt = self.rt
        wid = w.core_id
        victims = super()._collect_victims(w)
        torn = self._torn.setdefault(wid, [])
        with self._qlock:
            flight = [tid for tid, (t, ww, _) in self._inflight.items()
                      if ww.core_id == wid]
            for tid in flight:
                task, _, _ = self._inflight.pop(tid)
                victims.append(task)
                torn.append(task)
            self._busy[wid] = 0
            parked = self._parked.pop(wid, None)
        pid = rt.sub.kill_channel(wid)
        if parked:
            from .faults import WorkerDiedError
            raise WorkerDiedError(
                wid, pid=pid, last_task=sorted(parked),
                detail=f"{len(parked)} suspended task(s) were resident "
                "in the dead process; a mid-wait continuation cannot be "
                "replayed (its spawned children are visible side "
                "effects) — failing loudly")
        return victims

    def _torn_victims(self, w: WorkerNode, victims: list) -> list:
        """The dead child's in-flight activations: shipped bodies may
        have partially executed (and partially flushed write-backs)
        before the SIGKILL, so these — and only these — roll back to
        their last committed snapshot."""
        return self._torn.pop(w.core_id, [])

    def _rehome_parked(self, w: WorkerNode, parked: list) -> None:
        # nothing host-side to re-home: child-resident continuations are
        # handled (fatally) in _collect_victims
        return

    # ---- dispatch ------------------------------------------------------------

    def h_dispatch(self, w: WorkerNode, task: Task) -> None:
        rt = self.rt
        dma_bytes = sum(
            b for wid, b in task.pack_by_worker.items() if wid != w.core_id
        )
        if dma_bytes > 0:
            rt.sub.add_dma(w, dma_bytes)
        with self._qlock:
            self._queues.setdefault(w.core_id, deque()).append(task)
        self._maybe_ship(w)

    def _maybe_ship(self, w: WorkerNode) -> None:
        """Ship the next queued task unless the worker process already
        has an activation in flight (one at a time per process: queued
        tasks stay host-side where stealing can re-home them)."""
        rt = self.rt
        while True:
            with self._qlock:
                if w.core_id in rt.dead_workers:
                    return
                if self._busy.get(w.core_id, 0) > 0:
                    return
                q = self._queues.get(w.core_id)
                if not q:
                    return
                task = q.popleft()
                if task.fn is not None:
                    self._busy[w.core_id] = \
                        self._busy.get(w.core_id, 0) + 1
                    self._inflight[task.tid] = (task, w, rt.sub.now)
            if task.fn is None:
                # pure-duration placeholder: nothing to run in a child
                task.state = RUNNING
                task.last_exec_cycles = 0.0
                rt.sub.charge_task(w, 0.0, executed=True)
                rt.sub.send(w, task.owner, Message("s_complete", (task,)))
                continue
            task.state = RUNNING
            desc = (task.tid, task.fn, list(task.args), task.call,
                    tuple(task.extra), task.name, task.duration)
            snapshot = self._footprint(task)
            rt.sub.proc_stats[w.core_id]["tasks"] += 1
            rt.sub.send_frame(w.core_id,
                              Message("x_exec", (desc, snapshot)))
            return

    # ---- footprint snapshots --------------------------------------------------

    def _footprint(self, task: Task) -> tuple:
        """The shippable closure of a task's footprint (the paper's
        DMA list): object values, per-arg cover modes (ORed: any
        covering entry on the ancestor chain grants access), parent
        links for the cover walk, and which nids are regions."""
        rt = self.rt
        dir_, storage = rt.dir, rt.storage
        values: dict[int, object] = {}
        cover: dict[int, str] = {}
        parents: dict[int, int | None] = {}
        regions: list[int] = []

        def chain(nid: int) -> None:
            cur = nid
            while cur is not None and cur not in parents:
                p = dir_.parent_of(cur) if dir_.has(cur) else None
                parents[cur] = p
                cur = p

        for a in task.dep_args:
            if a.notransfer:
                continue
            prev = cover.get(a.nid)
            if prev is None or (a.mode == MODE_WRITE and prev != MODE_WRITE):
                cover[a.nid] = a.mode
            chain(a.nid)
            if dir_.has(a.nid) and dir_.is_region(a.nid):
                for meta in dir_.objects_under(a.nid):
                    if meta.nid in storage:
                        values[meta.nid] = storage[meta.nid]
                    chain(meta.nid)
            elif a.nid in storage:
                values[a.nid] = storage[a.nid]
        for nid in list(parents):
            if dir_.has(nid) and dir_.is_region(nid):
                regions.append(nid)
        return (values, cover, parents, sorted(regions))

    # ---- resume ---------------------------------------------------------------

    def h_resume(self, w: WorkerNode, task: Task) -> None:
        """Wait quiesced: re-ship the refreshed footprint snapshot (the
        awaited children's write-backs have already landed host-side)
        and resume the parked generator in its worker process."""
        rt = self.rt
        with self._qlock:
            self._busy[w.core_id] = self._busy.get(w.core_id, 0) + 1
            self._inflight[task.tid] = (task, w, rt.sub.now)
            parked = self._parked.get(w.core_id)
            if parked is not None:
                parked.discard(task.tid)
        task.state = RUNNING
        rt.sub.send_frame(w.core_id,
                          Message("x_resume",
                                  (task.tid, self._footprint(task))))

    # ---- child-side outcomes (called from the reader threads) -----------------

    def _deactivate(self, w: WorkerNode, tid: int) -> tuple:
        with self._qlock:
            entry = self._inflight.pop(tid, None)
            if entry is None:
                # already reaped by _collect_victims (message raced the
                # kill) — nothing to account
                return None, 0.0, False
            task, _, wall0 = entry
            self._busy[w.core_id] = max(0, self._busy.get(w.core_id, 1) - 1)
            idle = not self._queues.get(w.core_id)
        return task, wall0, idle

    def on_complete(self, w: WorkerNode, tid: int) -> None:
        rt = self.rt
        task, wall0, idle = self._deactivate(w, tid)
        if task is None:
            return
        dt = rt.sub.now - wall0
        task.last_exec_cycles = dt
        rt.sub.charge_task(w, dt, executed=True)
        rt.sub.send(w, task.owner, Message("s_complete", (task,)))
        self._maybe_ship(w)
        if idle and rt.steal:
            rt.sub.send(w, w.parent,
                        Message("s_steal_check", (w.parent,),
                                cost=rt.cost.steal_proc))

    def on_suspend(self, w: WorkerNode, tid: int, wait_args: list) -> None:
        rt = self.rt
        task, wall0, _ = self._deactivate(w, tid)
        if task is None:
            return
        with self._qlock:
            self._parked.setdefault(w.core_id, set()).add(tid)
        task.state = WAITING
        task.wait_remaining = len(wait_args)
        rt.sub.charge_task(w, rt.sub.now - wall0, executed=False)
        rt.sub.send(w, task.owner,
                    Message("s_wait", (task, list(wait_args))))
        self._maybe_ship(w)


# -- child side ---------------------------------------------------------------


class _ChildTask:
    """Child-side task record: duck-types the slots ``resolve_call``
    and error messages touch."""

    __slots__ = ("tid", "fn", "args", "call", "extra", "name", "duration",
                 "dep_args")

    def __init__(self, tid, fn, args, call, extra, name, duration):
        self.tid = tid
        self.fn = fn
        self.args = list(args)
        self.call = call
        self.extra = tuple(extra)
        self.name = name
        self.duration = duration
        self.dep_args = [a for a in self.args if not a.safe]

    def desc(self) -> tuple:
        return (self.fn, self.args, self.call, self.duration, self.name)

    def __repr__(self) -> str:
        return f"<Task {self.name}#{self.tid}>"


class _ChildCtx:
    """The task-context surface inside a worker process: local reads
    and writes against the shipped snapshot (checked against the
    footprint cover), marshalled ``sys_*`` requests for everything
    that needs the scheduler tier."""

    def __init__(self, child: "_Child", task: _ChildTask,
                 cover: dict[int, str]):
        self.child = child
        self.task = task
        self.cover = cover
        self.cursor = 0.0
        self._spawn_buf: list[_ChildTask] | None = None

    # --- access checks ---------------------------------------------------------

    def _check(self, nid: int, mode: str) -> None:
        """The host ``check_access`` rule over the shipped cover: walk
        the ancestor chain; any covering entry with sufficient mode
        grants (a read-only entry never blocks a write granted higher
        up the chain)."""
        cover, parents = self.cover, self.child.parents
        cur = nid
        while cur is not None:
            m = cover.get(cur)
            if m is not None and (mode != MODE_WRITE or m == MODE_WRITE):
                return
            cur = parents.get(cur)
        raise PermissionError(
            f"{self.task} has no {mode}-covering argument for node {nid}")

    def _value_nid(self, target, op: str) -> int:
        if isinstance(target, RegionRef):
            raise TypeError(
                f"{target!r} is a region, not an object: regions hold no "
                "value (access an ObjRef allocated inside it)")
        nid = int(target)
        if nid in self.child.regions:
            raise TypeError(
                f"{op}({nid}): node is a region, not an object — regions "
                "hold no value (access an object allocated inside it)")
        return nid

    # --- object store ----------------------------------------------------------

    def read(self, oid):
        nid = self._value_nid(oid, "read")
        self._check(nid, MODE_READ)
        return self.child.store.get(nid)

    def write(self, oid, value) -> None:
        nid = self._value_nid(oid, "write")
        self._check(nid, MODE_WRITE)
        _refuse_device_tensors(nid, value)
        self.child.store[nid] = value
        self.child.dirty[nid] = value

    # --- time ------------------------------------------------------------------

    def compute(self, cycles: float) -> None:
        self.cursor += cycles

    @property
    def now(self) -> float:
        return time.perf_counter() - self.child.t0

    @property
    def worker_id(self) -> str:
        return self.child.worker_id

    @property
    def worker(self) -> str:
        return self.child.worker_id

    # --- tasking ---------------------------------------------------------------

    def spawn(self, fn, *args, duration: float = 0.0,
              name: str | None = None, **kwargs) -> _ChildTask:
        fn, largs, call = _lower_spawn(fn, args, kwargs)
        stub = _ChildTask(
            -1, fn, largs, call, (),
            name or (fn.__name__ if fn is not None else "t?"), duration)
        if self.child.coalesce:
            if self._spawn_buf is None:
                self._spawn_buf = []
            self._spawn_buf.append(stub)
        else:
            stub.tid = self.child.call_host(
                self.task.tid, "sys_spawn", (stub.desc(),))
        return stub

    def buffer_spawn(self, stub) -> None:
        if self._spawn_buf is None:
            self._spawn_buf = []
        self._spawn_buf.append(stub)

    def flush_spawns(self) -> None:
        buf, self._spawn_buf = self._spawn_buf, None
        if buf:
            tids = self.child.call_host(
                self.task.tid, "sys_spawn_batch", [s.desc() for s in buf])
            for stub, tid in zip(buf, tids):
                stub.tid = tid

    def wait(self, args: list[Arg]) -> WaitSpec:
        self.flush_spawns()   # dependencies become observable here
        return WaitSpec(args)

    # --- memory ----------------------------------------------------------------

    def _sys(self, kind: str, payload: tuple):
        self.flush_spawns()   # keep spawn/alloc ordering observable
        return self.child.call_host(self.task.tid, kind, payload)

    def ralloc(self, parent_rid=None, level_hint: int = 10**9,
               label: str | None = None) -> RegionRef:
        from .regions import ROOT_RID
        pr = int(parent_rid) if parent_rid is not None else ROOT_RID
        rid = self._sys("sys_ralloc", (pr, level_hint, None, label))
        self.child.parents[rid] = pr
        self.child.regions.add(rid)
        return RegionRef(rid, label)

    def alloc(self, size: int, rid=None, label: str | None = None) -> ObjRef:
        from .regions import ROOT_RID
        r = int(rid) if rid is not None else ROOT_RID
        oid = self._sys("sys_alloc", (size, r, None, label))
        self.child.parents[oid] = r
        return ObjRef(oid, label)

    def balloc(self, size: int, rid, num: int,
               label: str | None = None) -> list[ObjRef]:
        r = int(rid)
        oids = self._sys("sys_balloc", (size, r, num, None, label))
        for o in oids:
            self.child.parents[o] = r
        return [ObjRef(o, f"{label}[{i}]" if label else None)
                for i, o in enumerate(oids)]

    def free(self, oid) -> None:
        from .api import free_nid
        nid = free_nid(oid, False, "free")
        self._sys("sys_free", (nid, None))
        self.child.store.pop(nid, None)
        self.child.dirty.pop(nid, None)

    def rfree(self, rid) -> None:
        from .api import free_nid
        nid = free_nid(rid, True, "rfree")
        self._sys("sys_rfree", (nid, None))
        self.child.regions.discard(nid)


class _Child:
    """One worker process: a reader thread feeding a serial executor.

    The host ships at most one fresh task at a time, but a resume for a
    parked generator can arrive while another activation runs — frames
    queue in the inbox and execute in arrival order."""

    def __init__(self, sock: socket.socket, worker_id: str, coalesce: bool):
        self.sock = sock
        self.worker_id = worker_id
        self.coalesce = coalesce
        self.wlock = threading.Lock()
        self.inbox: queue.SimpleQueue = queue.SimpleQueue()
        self.stopping = False
        self.t0 = time.perf_counter()
        # child-global structural/value state (per-task access rights
        # live on each activation's ctx.cover, not here)
        self.store: dict[int, object] = {}
        self.parents: dict[int, int | None] = {}
        self.regions: set[int] = set()
        self.dirty: dict[int, object] = {}
        self.suspended: dict[int, tuple] = {}   # tid -> (gen, ctx)
        # one outstanding marshalled call at a time (serial executor)
        self._seq = 0
        self._reply_evt = threading.Event()
        self._reply: tuple | None = None

    # -- wire ------------------------------------------------------------------

    def send(self, msg: Message) -> None:
        frame = _frame_bytes(msg)
        with self.wlock:
            self.sock.sendall(frame)

    def _reader(self) -> None:
        while True:
            try:
                msg = _recv_frame(self.sock)
            except Exception:
                msg = None
            if msg is None or msg.kind == "x_stop":
                self.stopping = True
                self._reply_evt.set()
                self.inbox.put(None)
                return
            if msg.kind == "x_reply":
                self._reply = msg.args
                self._reply_evt.set()
            else:
                self.inbox.put(msg)

    def call_host(self, tid: int, kind: str, payload):
        """One marshalled request/reply round trip.  Dirty values flush
        on every request: the host applies them before dispatching, so
        anything this call makes spawnable sees this task's writes."""
        if self.stopping:
            raise RuntimeError("worker process is shutting down")
        self._seq += 1
        seq = self._seq
        self._reply_evt.clear()
        self._reply = None
        dirty, self.dirty = self.dirty, {}
        self.send(Message("x_call", (tid, seq, kind, payload, dirty)))
        while not self._reply_evt.wait(timeout=1.0):
            if self.stopping:
                raise RuntimeError(
                    "host connection lost while awaiting a reply")
        if self.stopping and self._reply is None:
            raise RuntimeError("host connection lost while awaiting a reply")
        rseq, ok, value = self._reply
        if rseq != seq:
            raise RuntimeError(
                f"reply sequence mismatch: got {rseq}, expected {seq}")
        if not ok:
            raise value
        return value

    # -- snapshots -------------------------------------------------------------

    def merge(self, snapshot: tuple) -> dict[int, str]:
        values, cover, parents, regions = snapshot
        self.store.update(values)
        self.parents.update(parents)
        self.regions.update(regions)
        return dict(cover)

    # -- the executor loop -----------------------------------------------------

    def serve(self) -> None:
        reader = threading.Thread(target=self._reader, daemon=True)
        reader.start()
        while True:
            msg = self.inbox.get()
            if msg is None:
                return
            if msg.kind == "x_exec":
                tid = msg.args[0][0]
            elif msg.kind == "x_resume":
                tid = msg.args[0]
            else:
                tid = -1
            try:
                if msg.kind == "x_exec":
                    self._exec(msg.args)
                elif msg.kind == "x_resume":
                    self._resume(msg.args)
                else:
                    raise RuntimeError(
                        f"unexpected frame kind {msg.kind!r} in worker "
                        f"{self.worker_id}")
            except BaseException as e:
                try:
                    self.send(Message("x_error", (tid, _wire_safe_exc(e))))
                except OSError:
                    return

    def _exec(self, args: tuple) -> None:
        desc, snapshot = args
        tid, fn, largs, call, extra, name, duration = desc
        cover = self.merge(snapshot)
        task = _ChildTask(tid, fn, largs, call, extra, name, duration)
        ctx = _ChildCtx(self, task, cover)
        pos, kw = resolve_call(task)
        with active_ctx(ctx):
            result = task.fn(ctx, *pos, **kw)
        if hasattr(result, "__next__"):
            self._drive(task, result, ctx)
        else:
            ctx.flush_spawns()   # body end is a flush point
            self._complete(task)

    def _resume(self, args: tuple) -> None:
        tid, snapshot = args
        gen, ctx = self.suspended.pop(tid)
        ctx.cover.update(self.merge(snapshot))
        self._drive(ctx.task, gen, ctx)

    def _drive(self, task: _ChildTask, gen, ctx: _ChildCtx) -> None:
        try:
            with active_ctx(ctx):
                yielded = next(gen)
        except StopIteration:
            ctx.flush_spawns()
            self._complete(task)
            return
        if not isinstance(yielded, WaitSpec):
            raise TypeError(
                f"task yielded {yielded!r}; expected ctx.wait(...)")
        ctx.flush_spawns()   # children must enqueue before the WAIT
        self.suspended[task.tid] = (gen, ctx)
        dirty, self.dirty = self.dirty, {}
        self.send(Message("x_suspend",
                          (task.tid, list(yielded.args), dirty)))

    def _complete(self, task: _ChildTask) -> None:
        dirty, self.dirty = self.dirty, {}
        self.send(Message("x_complete", (task.tid, dirty)))


def _child_main(host_sock, child_sock: socket.socket,
                worker_id: str, coalesce: bool) -> None:
    if host_sock is not None:   # fork duplicated both socketpair ends
        host_sock.close()
    child = _Child(child_sock, worker_id, coalesce)
    try:
        child.serve()
    except BaseException as e:   # last resort: tell the host, then die
        try:
            child.send(Message("x_error", (-1, _wire_safe_exc(e))))
        except OSError:
            pass
    finally:
        try:
            child_sock.close()
        except OSError:
            pass
        os._exit(0)
