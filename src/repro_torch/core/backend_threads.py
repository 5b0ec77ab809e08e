"""The threaded backend: a real concurrent executor for Myrmics programs.

``Myrmics(backend="threads")`` runs the *same* scheduler/dependency
agents as the virtual-time simulation, but over this substrate:

* **scheduler tier** — one mailbox and one dedicated OS thread *per
  scheduler node*.  Every scheduler-role message (spawn handling,
  dependency traversal, packing + descent, completion, quiesce,
  allocation) is queued to the owning scheduler's mailbox and drained
  by that scheduler's thread, so handlers for different shards run
  genuinely concurrently.  Each thread only ever touches its own
  :class:`~.regions.DirectoryShard` / :class:`~.deps.DepShard` /
  descent counters — the same no-locks-on-owned-state discipline the
  distributed design imposes, now with real parallelism across the
  scheduler tier.  Cross-scheduler interactions go queue-to-queue
  (messages and uncharged ``update`` bookkeeping); the per-mailbox
  wait time is measured into ``queue_delay_cycles`` per scheduler.
* **worker side** — worker "cores" are a thread pool
  (:class:`~concurrent.futures.ThreadPoolExecutor`, one thread per
  worker node) executing actual Python/JAX task bodies against the
  shared object store.  Task bodies that release the GIL (JAX/XLA
  dispatch, NumPy BLAS, hashlib, zlib) run with genuine multicore
  parallelism.
* **runtime services** — a task body's ``ctx.spawn/ralloc/alloc/...``
  are marshalled as synchronous calls to the mailbox of the *owning*
  scheduler (``Myrmics._call_dest``): footprint validation and
  directory mutation happen in the owner's execution context, never
  concurrently with another handler for the same shard.  With message
  coalescing on (the default), ``ctx.spawn``s are buffered on the task
  context and flushed as **one** marshalled ``sys_spawn_batch`` call
  at the next wait / runtime call / body end — legal because
  dependencies are only observable at a wait — and each scheduler
  mailbox drains its whole queue per wakeup instead of one blocking
  get per message.
* **accounting** — message costs are not charged: ``busy_cycles`` /
  ``task_cycles`` / ``queue_delay_cycles`` in the
  :class:`~.api.RunReport` are wall-clock seconds measured around each
  task activation, handler and mailbox wait, and ``total_cycles`` is
  the wall-clock duration of the run.

Fault handling: ``kill_worker`` (and the ``Myrmics(faults=...)``
injector) works on this backend too.  The fail-stop boundary is the
per-worker *dispatch queue*: a killed worker's queued tasks replay
through their owners from the recorded footprints and its parked
(mid-wait) continuations re-home onto a live sibling, while a body
already executing on the pool runs to completion — pool threads share
the host address space, so "worker death" is a logical event and the
in-flight activation is not torn.  Straggler backups remain
virtual-time-only: they *duplicate* execution of live tasks, which is
safe only for pure virtual placeholders.
"""

from __future__ import annotations

import heapq
import itertools
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

from .api import active_ctx
from .runtime import (
    DISPATCHED,
    READY,
    RUNNING,
    WAITING,
    Task,
    TaskContext,
    WaitSpec,
    resolve_call,
)
from .sched import WorkerNode
from .substrate import Message, Substrate


class _Call:
    """A synchronous runtime-service request marshalled from a worker
    thread to the owning scheduler's thread."""

    __slots__ = ("kind", "args", "done", "result", "error")

    def __init__(self, kind: str, args: tuple):
        self.kind = kind
        self.args = args
        self.done = threading.Event()
        self.result = None
        self.error: BaseException | None = None


class _Update:
    """Uncharged cross-scheduler bookkeeping, applied in the
    destination scheduler's execution context (queue-to-queue)."""

    __slots__ = ("fn", "args")

    def __init__(self, fn, args: tuple):
        self.fn = fn
        self.args = args


_STOP = object()   # mailbox sentinel: scheduler thread exits


class ThreadSubstrate(Substrate):
    """Wall-clock substrate: one thread per scheduler node + a worker
    thread pool."""

    backend = "threads"

    def __init__(self, hier, max_wall_s: float = 600.0,
                 n_threads: int | None = None):
        super().__init__()
        self.hier = hier
        self.max_wall_s = max_wall_s
        self.n_threads = n_threads or max(1, len(hier.workers))
        # one mailbox per scheduler node (the decentralized tier)
        self._boxes: dict[str, queue.SimpleQueue] = {
            s.core_id: queue.SimpleQueue() for s in hier.scheds
        }
        self._sched_by_id = {s.core_id: s for s in hier.scheds}
        self._local = threading.local()    # .node = this thread's scheduler
        self._timers: list = []
        self._timer_seq = itertools.count()
        self._timer_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._pending = 0                  # queued-but-unprocessed mailbox items
        self._pending_lock = threading.Lock()
        self._inflight = 0                 # running worker-pool jobs
        self._inflight_lock = threading.Lock()
        self._events = 0
        self._events_lock = threading.Lock()
        self._idle = threading.Event()     # nudges the monitor loop
        self._t0: float | None = None
        self._end: float | None = None
        self._threads: list[threading.Thread] = []
        self._pool: ThreadPoolExecutor | None = None
        self._error: BaseException | None = None
        self._aborting = False
        self._max_events: int | None = None

    # -- execution context ---------------------------------------------------

    def executing_id(self) -> str | None:
        node = getattr(self._local, "node", None)
        return node.core_id if node is not None else None

    @property
    def scheduler_threads(self) -> int:
        """Mailbox-draining threads: one per scheduler node."""
        return len(self._boxes)

    def _is_sched(self, node) -> bool:
        return node is not None and node.core_id in self._boxes

    # -- messaging ----------------------------------------------------------

    def _put(self, dst, payload) -> None:
        with self._pending_lock:
            self._pending += 1
        self._boxes[dst.core_id].put((time.perf_counter(), payload))

    def _done_item(self) -> None:
        with self._pending_lock:
            self._pending -= 1
            quiet = self._pending == 0
        if quiet:   # wake the monitor only at a possible idle point
            self._idle.set()

    def send(self, src, dst, msg: Message, *,
             send_time: float | None = None) -> None:
        with self._stats_lock:
            st = src.core.stats
            st.msgs_sent += 1
            st.msg_bytes_sent += msg.payload_bytes
            self._note_msg(msg.kind, msg.payload_bytes)
        if self._is_sched(dst):
            self._put(dst, msg)
        else:
            # worker-destined messages have no shard state to protect:
            # the handler just hands the body to the pool / resumes it
            self.dispatch(msg.kind, msg.args)

    def local(self, node, msg: Message, *,
              at_time: float | None = None) -> None:
        if self._is_sched(node):
            self._put(node, msg)
        else:
            self.dispatch(msg.kind, msg.args)

    def update(self, dst, fn, *args) -> None:
        if not self._is_sched(dst) or self.executing_id() == dst.core_id:
            fn(*args)       # already in (or needs no) owner context
        else:
            self._put(dst, _Update(fn, args))

    def defer(self, dst, fn, *args) -> None:
        # unconditionally to the back of dst's mailbox: the caller is
        # parking this behind an adopt already queued ahead of it.
        self._put(dst, _Update(fn, args))

    def call(self, kind: str, *args):
        # aborting check first: after shutdown begins, a still-running
        # pool thread must fail fast instead of marshalling a call no
        # scheduler thread will ever answer.
        if self._aborting:
            raise RuntimeError("substrate is shutting down")
        dst = self._route(kind, args) if self._route is not None else None
        ex = getattr(self._local, "node", None)
        if dst is None or self._t0 is None or \
                (ex is not None and ex.core_id == dst.core_id):
            return self.dispatch(kind, args)
        if ex is not None:
            raise AssertionError(
                f"scheduler {ex.core_id} would block on a marshalled "
                f"{kind} call to {dst.core_id}: runtime services are "
                "worker-side entry points")
        # charge the call's argument payload into the per-kind message
        # table (estimated; see wire.payload_size) so marshalled sys_*
        # traffic is byte-accounted comparably with the sim's charged
        # payloads and the procs backend's real frame sizes.
        from . import wire
        with self._stats_lock:
            self._note_msg(kind, wire.payload_size(args))
        return self._marshal(dst, kind, args)

    def _marshal(self, dst, kind: str, args: tuple):
        """Queue a synchronous service request to ``dst``'s mailbox and
        block for the answer (the worker-thread half of ``call``; the
        procs backend's reader threads enter here directly)."""
        req = _Call(kind, args)
        self._put(dst, req)
        req.done.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def timer(self, when: float, msg: Message) -> None:
        with self._timer_lock:
            heapq.heappush(self._timers, (when, next(self._timer_seq), msg))

    # -- worker pool ---------------------------------------------------------

    def submit(self, fn, *args) -> None:
        """Run ``fn(*args)`` on a worker-pool thread; the run loop stays
        alive until every submitted job has finished."""
        with self._inflight_lock:
            self._inflight += 1
        self._pool.submit(self._job, fn, args)

    def _job(self, fn, args) -> None:
        try:
            fn(*args)
        except BaseException as e:  # surface task-body errors in run()
            self.fail(e)
        finally:
            with self._inflight_lock:
                self._inflight -= 1
                quiet = self._inflight == 0
            if quiet:
                self._idle.set()

    def fail(self, e: BaseException) -> None:
        if self._error is None:
            self._error = e
        self._idle.set()

    # -- time / cores --------------------------------------------------------

    @property
    def now(self) -> float:
        if self._t0 is None:
            return 0.0
        if self._end is not None:
            return self._end - self._t0
        return time.perf_counter() - self._t0

    @property
    def events_processed(self) -> int:
        return self._events

    def occupy(self, node, arrival: float, cost: float) -> float:
        """Wall-clock accounting: ``cost`` is measured seconds."""
        with self._stats_lock:
            node.core.stats.busy_cycles += cost
            node.core.stats.events += 1
        return self.now

    def next_free(self, node) -> float:
        return self.now

    def stats(self, node):
        return node.core.stats

    def charge_task(self, node, seconds: float, *, executed: bool) -> None:
        with self._stats_lock:
            st = node.core.stats
            st.busy_cycles += seconds
            st.task_cycles += seconds
            st.events += 1
            if executed:
                st.tasks_executed += 1

    def add_dma(self, node, nbytes: int) -> None:
        with self._stats_lock:
            node.core.stats.dma_bytes += nbytes

    # -- scheduler threads ----------------------------------------------------

    def _count_event(self) -> None:
        with self._events_lock:
            self._events += 1
            over = (self._max_events is not None
                    and self._events > self._max_events)
        if over:
            self.fail(RuntimeError(
                f"threads backend processed more than {self._max_events} "
                "messages (possible runaway spawn loop)"))

    def _sched_loop(self, sched) -> None:
        """One scheduler node: drain the mailbox, handlers touch only
        this scheduler's shards.  Each wakeup drains *everything*
        already queued in one sweep (coalescing at the executor level:
        one blocking get per burst instead of one per message), then
        processes the swept items in arrival order."""
        self._local.node = sched
        box = self._boxes[sched.core_id]
        while True:
            try:
                batch = [box.get(timeout=0.05)]
            except queue.Empty:
                if self._aborting:
                    break
                continue
            while True:   # sweep the rest of the queue without blocking
                try:
                    batch.append(box.get_nowait())
                except queue.Empty:
                    break
            stopping = False
            for i, (enq_t, payload) in enumerate(batch):
                if payload is _STOP:
                    # items swept after the sentinel were pulled out of
                    # the box, so _shutdown's drain cannot answer them:
                    # abort their calls here before exiting the loop
                    err = self._error or RuntimeError("substrate shut down")
                    for _, rest in batch[i + 1:]:
                        if isinstance(rest, _Call):
                            rest.error = err
                            rest.done.set()
                        if rest is not _STOP:
                            self._done_item()
                    stopping = True
                    break
                try:
                    self._handle(sched, enq_t, payload)
                finally:
                    self._done_item()
            if stopping:
                break

    def _handle(self, sched, enq_t: float, payload) -> None:
        if isinstance(payload, _Call):
            if self._aborting:
                payload.error = self._error or RuntimeError(
                    "substrate shut down")
            else:
                try:
                    payload.result = self.dispatch(payload.kind, payload.args)
                except BaseException as e:
                    payload.error = e
            payload.done.set()
            # count after answering: tripping the cap mid-call must not
            # leave the caller blocked on an unanswered request
            self._count_event()
            return
        if isinstance(payload, _Update):
            if not self._aborting:
                try:
                    payload.fn(*payload.args)
                except BaseException as e:
                    self.fail(e)
            return
        # a Message: measure mailbox delay + handler time on this core
        if self._aborting:
            return
        t0 = time.perf_counter()
        try:
            self.dispatch(payload.kind, payload.args)
        except BaseException as e:
            self.fail(e)
            return
        dt = time.perf_counter() - t0
        with self._stats_lock:
            st = sched.core.stats
            st.busy_cycles += dt
            st.events += 1
            st.msgs_handled += 1
            st.queue_delay_cycles += t0 - enq_t
        self._count_event()

    # -- the run monitor -------------------------------------------------------

    def _fire_due_timers(self) -> None:
        """Dispatch every due timer (monitor thread; timers are rare on
        this backend — sim-only features return early)."""
        while True:
            with self._timer_lock:
                if not self._timers or self._timers[0][0] > self.now:
                    return
                _, _, msg = heapq.heappop(self._timers)
            self._count_event()
            self.dispatch(msg.kind, msg.args)

    def run(self, until: float | None = None,
            max_events: int | None = None) -> None:
        if until is not None:
            raise ValueError(
                "until= bounds virtual time and only exists on "
                "backend='sim'; the threads backend is bounded by "
                "max_wall_s")
        self._max_events = max_events
        self._t0 = time.perf_counter()
        self._end = None
        self._aborting = False
        self._pool = ThreadPoolExecutor(
            max_workers=self.n_threads, thread_name_prefix="myrmics-w")
        self._threads = [
            threading.Thread(target=self._sched_loop, args=(s,),
                             name=f"myrmics-{s.core_id}", daemon=True)
            for s in self.hier.scheds
        ]
        for t in self._threads:
            t.start()
        deadline = self._t0 + self.max_wall_s
        try:
            while True:
                if self._error is not None:
                    raise self._error
                if time.perf_counter() > deadline:
                    raise RuntimeError(
                        f"threads backend exceeded max_wall_s="
                        f"{self.max_wall_s}s (possible hang)")
                self._fire_due_timers()
                with self._pending_lock:
                    quiet = self._pending == 0
                with self._inflight_lock:
                    quiet = quiet and self._inflight == 0
                if quiet and self._is_done():
                    break
                self._idle.clear()
                self._idle.wait(timeout=0.02)
        finally:
            self._end = time.perf_counter()
            self._shutdown()
        if self._error is not None:
            raise self._error

    def _shutdown(self) -> None:
        """Tear down scheduler threads and the pool without orphaning
        anyone: every marshalled call still in (or entering) a mailbox
        is answered with the abort error so its caller unblocks —
        otherwise a worker stuck in ``_Call.done.wait()`` would make
        ``pool.shutdown(wait=True)`` hang forever."""
        self._aborting = True
        for box in self._boxes.values():
            box.put((0.0, _STOP))
        for t in self._threads:
            t.join()
        self._threads = []
        pool, self._pool = self._pool, None
        down = threading.Event()
        waiter = threading.Thread(
            target=lambda: (pool.shutdown(wait=True), down.set()),
            daemon=True)
        waiter.start()
        err = self._error or RuntimeError("substrate shut down")
        while not down.is_set():
            drained_call = False
            for box in self._boxes.values():
                try:
                    while True:
                        _, payload = box.get_nowait()
                        if isinstance(payload, _Call):
                            payload.error = err
                            payload.done.set()
                            drained_call = True
                except queue.Empty:
                    pass
            if not drained_call:
                down.wait(timeout=0.02)
        waiter.join()


# ---------------------------------------------------------------------------
# the worker agent for the threaded substrate
# ---------------------------------------------------------------------------


@dataclass
class ThreadExec:
    """Execution record for one task activation on a pool thread."""

    task: Task
    ctx: TaskContext
    wall0: float = 0.0


class ThreadWorkerAgent:
    """Executes real task bodies on the pool; speaks the same message
    surface (``w_dispatch`` / ``w_resume``) as the sim worker agent."""

    def __init__(self, rt):
        self.rt = rt
        self._suspended: dict[int, ThreadExec] = {}   # tid -> parked record
        self._suspend_lock = threading.Lock()         # pool vs owner threads
        # per-worker dispatch queues (steal=True): what stealing raids.
        # _active holds workers with a drain job running on the pool.
        self._queues: dict[str, deque] = {}
        self._active: set[str] = set()
        self._qlock = threading.Lock()

    # ---- fault handling ------------------------------------------------------

    def kill_worker(self, worker_id: str, at: float | None = None) -> None:
        """Kill a worker domain (``at`` is wall seconds when given).
        The fail-stop boundary is the dispatch queue: queued tasks
        replay via their owners, parked continuations re-home, and a
        body already on the pool finishes normally (logical death —
        pool threads share the address space, nothing is torn)."""
        if at is None:
            self.do_kill(worker_id)
        else:
            self.rt.sub.timer(at, Message("w_kill", (worker_id,)))

    def do_kill(self, worker_id: str) -> None:
        """Route the kill surgery into the leaf scheduler's execution
        context: all counter/queue mutation happens on the thread that
        also runs this leaf's dispatches, so kill-vs-dispatch races are
        serialized away."""
        rt = self.rt
        if worker_id in rt.dead_workers:
            return
        w = rt.hier.by_id[worker_id]
        rt.sub.update(w.parent, self._kill_in_ctx, w)

    def _kill_in_ctx(self, w: WorkerNode) -> None:
        from .faults import replay_task, retract_descent_path

        rt = self.rt
        worker_id = w.core_id
        if worker_id in rt.dead_workers:
            return
        rt.dead_workers.add(worker_id)
        inj = rt.fault_injector
        if inj is not None:
            with rt.count_lock:
                inj.workers_killed += 1
        victims = self._collect_victims(w)
        with self._suspend_lock:
            parked = [r for r in self._suspended.values()
                      if r.task.worker is w]
        for t in victims:
            retract_descent_path(rt, w, t)
        for rec in parked:
            retract_descent_path(rt, w, rec.task)
        w.parent.workers = [x for x in w.parent.workers
                            if x.core_id != worker_id]
        w.parent.load.pop(worker_id, None)
        w.parent.occ.pop(worker_id, None)
        if inj is not None and inj.snapshots is not None:
            # restore only what may be torn: the activations that were
            # executing inside the dead node (procs in-flight tasks —
            # empty here and on sim; see RegionSnapshots.on_worker_death)
            inj.snapshots.on_worker_death(
                worker_id, self._torn_victims(w, victims))
        self._rehome_parked(w, parked)
        for t in victims:
            if t.completed or t.state not in (DISPATCHED, RUNNING):
                continue
            rt.tasks_rescheduled += 1
            t.state = READY
            t.gen = None
            t.worker = None
            replay_task(rt, t)

    def _torn_victims(self, w: WorkerNode, victims: list[Task]) -> list[Task]:
        """The subset of victims that may have partially executed (torn
        writes) on the dead node: none on this backend — a body already
        on the pool finishes normally (logical death).  The procs agent
        overrides this with the killed child's in-flight activations."""
        return []

    def _collect_victims(self, w: WorkerNode) -> list[Task]:
        """Tasks lost with the worker: its dispatch queue (the fail-stop
        boundary on this backend — a body already on the pool finishes
        normally).  The procs agent overrides this to add the tasks
        in flight inside the killed child process."""
        with self._qlock:
            q = self._queues.get(w.core_id)
            victims = list(q) if q else []
            if q:
                q.clear()
        return victims

    def _rehome_parked(self, w: WorkerNode, parked: list) -> None:
        """Move a dead worker's parked (mid-wait) continuations to a
        live sibling: the generators live in host memory, so only the
        worker pointer and the descent-path counters move.  The records
        stay keyed in ``_suspended`` — the wait's eventual resume pops
        by tid and continues on the adopter (worker-destined sends
        dispatch synchronously on this backend, so no resume is ever in
        flight toward the corpse)."""
        from .faults import credit_descent_path, pick_live_worker

        rt = self.rt
        for rec in parked:
            t = rec.task
            w2 = pick_live_worker(rt, w.parent)
            t.worker = w2
            rec.ctx.worker = w2
            rt.tasks_rescheduled += 1
            credit_descent_path(rt, w2, t)

    def add_worker(self, leaf_sched_id: str) -> str:
        raise RuntimeError(
            "add_worker (elastic join) is only supported on backend='sim'; "
            "size the thread pool via n_workers at construction instead")

    def note_service_time(self, dt: float) -> None:
        rt = self.rt
        if rt.service_ewma is None:
            rt.service_ewma = dt
        else:
            rt.service_ewma = 0.9 * rt.service_ewma + 0.1 * dt

    def maybe_backup(self, task: Task) -> None:
        # straggler backups re-execute tasks — safe only when bodies are
        # pure virtual placeholders, i.e. on the sim backend.
        return

    def backup_check(self, task: Task) -> None:
        return

    # ---- sim-only message kinds (never emitted on this backend) -------------

    def try_start(self, w: WorkerNode) -> None:  # pragma: no cover
        raise AssertionError("w_try_start is a sim-substrate message")

    def exec_task(self, w: WorkerNode, rec) -> None:  # pragma: no cover
        raise AssertionError("w_exec is a sim-substrate message")

    def resume_retry(self, w: WorkerNode, rec) -> None:  # pragma: no cover
        raise AssertionError("w_resume_retry is a sim-substrate message")

    # ---- dispatch / execution ------------------------------------------------

    def h_dispatch(self, w: WorkerNode, task: Task) -> None:
        """Dispatch intake (runs on the dispatching leaf scheduler's
        thread): account the would-be DMA (data is already addressable
        in the shared store) and hand the body to the pool.

        With ``steal`` on, the task goes through a per-worker queue
        drained serially by one pool job — the queue is what work
        stealing raids; an idle worker (drained queue) nudges its leaf
        scheduler's mailbox with ``s_steal_check``.  With ``steal``
        off, the body is submitted to the pool directly (the original
        free-for-all path, preserved as the escape hatch)."""
        rt = self.rt
        if w.core_id in rt.dead_workers:
            # dispatch raced with the failure (cross-leaf steal grant):
            # retract this dispatch's counters and re-schedule
            from .faults import replay_task, retract_descent_path
            retract_descent_path(rt, w, task)
            rt.tasks_rescheduled += 1
            task.state = READY
            task.worker = None
            replay_task(rt, task)
            return
        dma_bytes = sum(
            b for wid, b in task.pack_by_worker.items() if wid != w.core_id
        )
        if dma_bytes > 0:
            rt.sub.add_dma(w, dma_bytes)
        if not rt.steal:
            rt.sub.submit(self._exec, w, task)
            return
        with self._qlock:
            q = self._queues.setdefault(w.core_id, deque())
            q.append(task)
            kick = w.core_id not in self._active
            if kick:
                self._active.add(w.core_id)
        if kick:
            rt.sub.submit(self._drain, w)

    def _drain(self, w: WorkerNode) -> None:
        """Pool job: run ``w``'s queued tasks one at a time.  The active
        flag is cleared under the same lock that finds the queue empty,
        so a concurrent enqueue either sees the flag (and lets this
        drain pick the task up) or kicks a fresh drain — tasks are never
        stranded.  On going idle, trigger the leaf's steal check through
        its mailbox, same protocol as the sim backend."""
        rt = self.rt
        while True:
            with self._qlock:
                q = self._queues[w.core_id]
                if not q:
                    self._active.discard(w.core_id)
                    break
                task = q.popleft()
            self._exec(w, task)
        rt.sub.send(w, w.parent,
                    Message("s_steal_check", (w.parent,),
                            cost=rt.cost.steal_proc))

    # ---- work-stealing queue interface --------------------------------------

    def queued_stealable(self, w: WorkerNode) -> list[Task]:
        with self._qlock:
            return list(self._queues.get(w.core_id, ()))

    def remove_queued(self, w: WorkerNode, task: Task) -> bool:
        """Remove a queued task (victim side of a steal); False when the
        drain loop already popped it for execution — the same lock
        serializes both, so a task runs exactly once."""
        with self._qlock:
            q = self._queues.get(w.core_id)
            if q is None:
                return False
            try:
                q.remove(task)
            except ValueError:
                return False
            return True

    def _exec(self, w: WorkerNode, task: Task) -> None:
        """Pool thread: one task activation, measured in wall time.

        Sanitizer note: with ``Myrmics(sanitize=True)`` the
        footprint/race checks ride the shared :class:`TaskContext`
        read/write path created here, serialized by the sanitizer's own
        lock; a ``DeterminacyRaceError`` escaping the body lands in the
        pool loop's BaseException hook (``fail``) and re-raises from
        ``run()`` like any task-body error."""
        rt = self.rt
        task.state = RUNNING
        ctx = TaskContext(rt, task, w, rt.sub.now)
        rec = ThreadExec(task, ctx, wall0=rt.sub.now)
        if task.fn is None:
            # a pure-duration placeholder task: nothing real to run
            self._finish(w, rec)
            return
        pos, kw = resolve_call(task)
        with active_ctx(ctx):
            result = task.fn(ctx, *pos, **kw)
        if hasattr(result, "__next__"):
            task.gen = result
            self._drive(w, rec)
        else:
            ctx.flush_spawns()   # coalesced spawns: body end is a flush point
            self._finish(w, rec)

    def _drive(self, w: WorkerNode, rec: ThreadExec) -> None:
        try:
            with active_ctx(rec.ctx):
                yielded = next(rec.task.gen)
        except StopIteration:
            rec.ctx.flush_spawns()
            self._finish(w, rec)
            return
        if not isinstance(yielded, WaitSpec):
            raise TypeError(
                f"task yielded {yielded!r}; expected ctx.wait(...)")
        self._suspend(w, rec, yielded)

    # ---- sys_wait suspend / resume -------------------------------------------

    def _suspend(self, w: WorkerNode, rec: ThreadExec,
                 spec: WaitSpec) -> None:
        rt = self.rt
        task = rec.task
        rec.ctx.flush_spawns()   # children must enqueue before the WAIT
        task.state = WAITING
        task.wait_remaining = len(spec.args)
        rt.sub.charge_task(w, rt.sub.now - rec.wall0, executed=False)
        with self._suspend_lock:
            self._suspended[task.tid] = rec
        rt.sub.send(w, task.owner,
                    Message("s_wait", (task, list(spec.args))))
        # the pool thread returns here: the generator is parked and the
        # thread is free for other tasks until the wait quiesces.

    def h_resume(self, w: WorkerNode, task: Task) -> None:
        with self._suspend_lock:
            rec = self._suspended.pop(task.tid, None)
        if rec is None:
            return   # stale/duplicate resume (kill re-homed the record)
        # resume on the task's *current* worker: a kill may have
        # re-homed the record after the owner addressed this message
        self.rt.sub.submit(self._continue, task.worker or w, rec)

    def _continue(self, w: WorkerNode, rec: ThreadExec) -> None:
        rt = self.rt
        rec.task.state = RUNNING
        rec.wall0 = rt.sub.now
        rec.ctx.t0 = rec.wall0
        rec.ctx.cursor = 0.0
        self._drive(w, rec)

    # ---- completion -----------------------------------------------------------

    def _finish(self, w: WorkerNode, rec: ThreadExec) -> None:
        rt = self.rt
        task = rec.task
        dt = rt.sub.now - rec.wall0
        task.last_exec_cycles = dt
        rt.sub.charge_task(w, dt, executed=True)
        rt.sub.send(w, task.owner, Message("s_complete", (task,)))
