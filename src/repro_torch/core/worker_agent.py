"""Worker-role agent for the virtual-time substrate: dispatch intake,
DMA modelling, task execution, sys_wait suspend/resume, straggler
backups and worker fault handling.

Every handler here is work performed on (or about) a *worker core*.
The agent owns the per-worker execution records; scheduler-side effects
(completion processing, wait enqueues) are reified messages back to the
task's owning scheduler, charged through the substrate.  All timing is
the substrate's virtual clock (``rt.sub.now`` / ``rt.sub.timer``) —
this agent is installed for ``backend="sim"``; the wall-clock
equivalent lives in :mod:`.backend_threads`.
"""

from __future__ import annotations

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
from .substrate import Message


@dataclass
class ExecRecord:
    """Worker-side record of a dispatched task."""

    task: Task
    dma_done: float = 0.0
    start: float = 0.0
    ctx: "TaskContext | None" = None
    idle_counted: bool = False


class WorkerAgent:
    """Dispatch, DMA, exec, wait/resume, backup (paper SV-B/SV-E)."""

    def __init__(self, rt):
        self.rt = rt

    # ---- scale-out: straggler backups, worker failure, elastic join ---------

    def kill_worker(self, worker_id: str, at: float | None = None) -> None:
        """Simulate losing a worker domain: queued and running tasks are
        re-dispatched by their owners (the dependency queues define the
        exact re-execution set); suspended (mid-wait) continuations
        re-home onto a live sibling; subsequent placement avoids the
        corpse."""
        if at is None:
            self.do_kill(worker_id)
        else:
            self.rt.sub.timer(at, Message("w_kill", (worker_id,)))

    def do_kill(self, worker_id: str) -> None:
        from .faults import (
            credit_descent_path,
            pick_live_worker,
            replay_task,
            retract_descent_path,
        )

        rt = self.rt
        if worker_id in rt.dead_workers:
            return
        w = rt.hier.by_id[worker_id]
        rt.dead_workers.add(worker_id)
        inj = rt.fault_injector
        if inj is not None:
            with rt.count_lock:
                inj.workers_killed += 1
        victims = [r.task for r in w.queue]
        if w.running is not None:
            victims.append(w.running.task)
        parked = list(w.suspended.values())
        w.queue.clear()
        w.running = None
        w.suspended.clear()
        # counter hygiene first: undo the descent-path load/occ of every
        # task leaving the corpse (the walk starts at the worker, so the
        # leaf-level entry is retracted before it is popped below)
        for t in victims:
            retract_descent_path(rt, w, t)
        for rec in parked:
            retract_descent_path(rt, w, rec.task)
        w.parent.workers = [x for x in w.parent.workers
                            if x.core_id != worker_id]
        w.parent.load.pop(worker_id, None)
        w.parent.occ.pop(worker_id, None)
        # no snapshot restore on this backend: a sim body applies its
        # writes atomically at its start instant, so a victim still in
        # the queue/running slot has written nothing (exactly-once) —
        # and rolling back would clobber applied writes of non-victim
        # tasks whose completions (and commits) are still in flight
        # a suspended (mid-wait) task has visible side effects (spawned
        # children), so it must not re-execute from the top — its live
        # continuation (the generator record) re-homes onto a live
        # worker instead, and resumes there when its wait quiesces
        for rec in parked:
            t = rec.task
            w2 = pick_live_worker(rt, w.parent)
            t.worker = w2
            w2.suspended[t.tid] = rec
            rt.tasks_rescheduled += 1
            credit_descent_path(rt, w2, t)
            if t.wait_remaining == 0:
                # the wait already quiesced: its w_resume targeted the
                # corpse (dropped by h_resume's pop guard) — re-issue
                rt.agent_of(t.owner).resume_task(t)
        # queued / running victims replay from the recorded footprint
        for t in victims:
            if t.completed or t.state not in (DISPATCHED, RUNNING):
                continue
            rt.tasks_rescheduled += 1
            t.state = READY
            t.gen = None
            t.worker = None
            replay_task(rt, t)

    def add_worker(self, leaf_sched_id: str) -> str:
        """Elastic join: attach a fresh worker under a leaf scheduler."""
        rt = self.rt
        leaf = rt.hier.by_id[leaf_sched_id]
        wid = f"w{len(rt.hier.workers)}"
        w = WorkerNode(rt.engine, wid, leaf)
        leaf.workers.append(w)
        leaf.load[wid] = 0
        leaf.occ[wid] = 0.0
        rt.hier.workers.append(w)
        rt.hier.by_id[wid] = w
        for s in rt.hier.scheds:
            rt.subtree_workers[s.core_id] = s.subtree_worker_ids()
        return wid

    def note_service_time(self, dt: float) -> None:
        rt = self.rt
        if rt.service_ewma is None:
            rt.service_ewma = dt
        else:
            rt.service_ewma = 0.9 * rt.service_ewma + 0.1 * dt

    def maybe_backup(self, task: Task) -> None:
        """Straggler watchdog: if the task has not completed within
        factor x EWMA service time, re-dispatch a backup copy to another
        worker; the first completion wins (tasks are pure)."""
        rt = self.rt
        if rt.backup_factor is None or rt.service_ewma is None:
            return
        deadline = rt.sub.now + rt.backup_factor * rt.service_ewma
        rt.sub.timer(deadline, Message("w_backup_check", (task,)))

    def backup_check(self, task: Task) -> None:
        rt = self.rt
        if not task.completed and not task.backup_spawned and \
                task.state in (DISPATCHED, RUNNING) and \
                task.worker is not None and \
                task.worker.core_id not in rt.dead_workers:
            task.backup_spawned = True
            rt.backups_spawned += 1
            rt.sub.local(task.owner,
                         Message("s_descend", (task.owner, task),
                                 cost=rt.cost.schedule_base))

    # ---- work-stealing queue interface --------------------------------------

    def queued_stealable(self, w: WorkerNode) -> list[Task]:
        """Queued-but-undispatched tasks on ``w`` (steal candidates), in
        queue order.  The running task is never in here — ``try_start``
        pops it before execution."""
        return [rec.task for rec in w.queue]

    def remove_queued(self, w: WorkerNode, task: Task) -> bool:
        """Remove a queued task record (victim side of a steal); False
        when the task already left the queue for execution."""
        for i, rec in enumerate(w.queue):
            if rec.task is task:
                del w.queue[i]
                return True
        return False

    # ---- dispatch intake + DMA ----------------------------------------------

    def h_dispatch(self, w: WorkerNode, task: Task) -> None:
        rt = self.rt
        if w.core_id in rt.dead_workers:
            # dispatch raced with the failure: retract the descent-path
            # counters this dispatch charged, then the owner re-schedules
            from .faults import replay_task, retract_descent_path
            retract_descent_path(rt, w, task)
            rt.tasks_rescheduled += 1
            task.state = READY
            task.worker = None
            replay_task(rt, task)
            return
        rec = ExecRecord(task)
        dma_bytes = sum(
            b for wid, b in task.pack_by_worker.items() if wid != w.core_id
        )
        n_xfers = sum(
            1 for wid, b in task.pack_by_worker.items()
            if wid != w.core_id and b > 0
        )
        if dma_bytes > 0:
            dur = (rt.cost.dma_startup * max(1, n_xfers)
                   + dma_bytes / rt.cost.dma_bytes_per_cycle)
            start = max(rt.sub.now, w.dma_free)
            w.dma_free = start + dur
            rec.dma_done = w.dma_free
            rt.sub.stats(w).dma_bytes += dma_bytes
        w.queue.append(rec)
        self.try_start(w)

    def try_start(self, w: WorkerNode) -> None:
        rt = self.rt
        if w.core_id in rt.dead_workers:
            return   # a timer-deferred start raced with the failure
        if w.running is not None or not w.queue:
            return
        rec = w.queue[0]
        if rec.dma_done > rt.sub.now:
            if not rec.idle_counted:
                rec.idle_counted = True
                rt.sub.stats(w).idle_wait_dma += rec.dma_done - rt.sub.now
            rt.sub.timer(rec.dma_done, Message("w_try_start", (w,)))
            return
        w.queue.pop(0)
        w.running = rec
        rec.start = max(rt.sub.now, rt.sub.next_free(w))
        rt.sub.timer(rec.start, Message("w_exec", (w, rec)))

    # ---- execution ----------------------------------------------------------

    def exec_task(self, w: WorkerNode, rec: ExecRecord) -> None:
        rt = self.rt
        if w.core_id in rt.dead_workers:
            return   # the kill already replayed this record's task
        task = rec.task
        if task.completed:
            # a backup copy already finished; drop this duplicate
            w.running = None
            self.try_start(w)
            return
        task.state = RUNNING
        ctx = TaskContext(rt, task, w, rec.start)
        rec.ctx = ctx
        if task.fn is None:
            ctx.cursor += task.duration
            self.finish_exec(w, rec)
            return
        pos, kw = resolve_call(task)
        with active_ctx(ctx):
            result = task.fn(ctx, *pos, **kw)
        if hasattr(result, "__next__"):
            task.gen = result
            self.drive_gen(w, rec)
        else:
            ctx.cursor += task.duration
            self.finish_exec(w, rec)

    def drive_gen(self, w: WorkerNode, rec: ExecRecord) -> None:
        try:
            # each generator activation runs with its context ambient, so
            # ref.read()/direct task calls resolve across suspensions
            with active_ctx(rec.ctx):
                yielded = next(rec.task.gen)
        except StopIteration:
            self.finish_exec(w, rec)
            return
        if not isinstance(yielded, WaitSpec):
            raise TypeError(f"task yielded {yielded!r}; expected ctx.wait(...)")
        self.suspend_for_wait(w, rec, yielded)

    # ---- sys_wait suspend / resume ------------------------------------------

    def suspend_for_wait(self, w: WorkerNode, rec: ExecRecord,
                         spec: WaitSpec) -> None:
        rt = self.rt
        task = rec.task
        ctx = rec.ctx
        task.state = WAITING
        task.wait_remaining = len(spec.args)
        rt.sub.occupy(w, rec.start, ctx.cursor)
        rt.sub.stats(w).task_cycles += ctx.cursor
        w.running = None
        w.suspended[task.tid] = rec
        # WAIT message to the owner, which enqueues WAIT entries at the
        # waited nodes (sys_wait, paper SV-A)
        rt.sub.send(w, task.owner,
                    Message("s_wait", (task, list(spec.args)),
                            cost=rt.cost.complete_proc_base),
                    send_time=ctx.now)
        self.try_start(w)

    def h_resume(self, w: WorkerNode, task: Task) -> None:
        rt = self.rt
        rec = w.suspended.pop(task.tid, None)
        if rec is None:
            # stale resume addressed to a corpse: the kill re-homed the
            # record and re-issued the resume at the adopting worker
            return
        if w.running is not None:
            # run after the current task; keep FIFO order ahead of queue
            rt.sub.timer(rt.sub.next_free(w),
                         Message("w_resume_retry", (w, rec)))
            w.suspended[task.tid] = rec
            return
        self.continue_gen(w, rec)

    def resume_retry(self, w: WorkerNode, rec: ExecRecord) -> None:
        rt = self.rt
        if w.running is not None:
            rt.sub.timer(rt.sub.next_free(w),
                         Message("w_resume_retry", (w, rec)))
            return
        if rec.task.tid in w.suspended:
            w.suspended.pop(rec.task.tid)
            self.continue_gen(w, rec)

    def continue_gen(self, w: WorkerNode, rec: ExecRecord) -> None:
        rt = self.rt
        task = rec.task
        task.state = RUNNING
        w.running = rec
        rec.start = max(rt.sub.now, rt.sub.next_free(w))
        # the generator closed over rec.ctx: rebase it for this activation
        rec.ctx.t0 = rec.start
        rec.ctx.cursor = 0.0
        self.drive_gen(w, rec)

    # ---- completion ---------------------------------------------------------

    def finish_exec(self, w: WorkerNode, rec: ExecRecord) -> None:
        rt = self.rt
        task = rec.task
        ctx = rec.ctx
        task.last_exec_cycles = ctx.cursor
        end = rec.start + ctx.cursor
        rt.sub.occupy(w, rec.start, ctx.cursor)
        rt.sub.stats(w).task_cycles += ctx.cursor
        rt.sub.stats(w).tasks_executed += 1
        w.running = None
        cost = (rt.cost.complete_proc_base
                + rt.cost.complete_per_arg * len(task.dep_args))
        rt.sub.send(w, task.owner, Message("s_complete", (task,), cost=cost),
                    send_time=end)
        # completion send cost on the worker
        rt.sub.occupy(w, end, rt.cost.worker_complete_send)
        rt.sub.timer(rt.sub.next_free(w), Message("w_try_start", (w,)))
