"""Scheduler-role agent: spawn, dependency traversal, descent, complete,
quiesce, and region-ownership migration.

One :class:`SchedAgent` instance exists *per scheduler node* — the
paper's decentralized design point (SIV): each scheduler owns its slice
of runtime state (its :class:`~.regions.DirectoryShard`, its
:class:`~.deps.DepShard`, its descent load counters, its
:class:`~.regions.AncestryCache`) and talks to peers only through the
substrate.  Every handler in this module is work performed *on* its
scheduler core: it is entered through the substrate
(``rt.sub.send``/``local``) with the processing cost charged to (sim)
or measured on (threads) that core.  Cross-owner dependency operations
ride substrate messages (``s_enqueue``/``s_release``/``d_quiesce``);
cross-shard metadata reads go through the forwarding helpers
(``forward_lookup``, the packing walk) and are charged to the owning
scheduler, mirroring paper Fig. 6a where S2 packs region A via S0/S1;
owner routes and ancestry facts resolve through the per-scheduler
:class:`~.regions.AncestryCache` (invalidated on SV-C migration);
and bookkeeping another scheduler owns (descent-load decrements
piggybacked on completions, migration adoption) is applied in the
owner's execution context through the substrate's uncharged ``update``
channel — synchronous under virtual time, queue-to-queue between
scheduler threads.

Ownership migration (paper SV-C): when a scheduler's ``region_load``
exceeds the opt-in threshold, the agent picks its largest owned region
subtree that fits inside half the load gap to the least-loaded sibling
and re-homes it there.  The request is parent-routed — owner -> parent
-> sibling — and the grant message is charged per migrated node, so
rebalancing is visible in the virtual-time accounting.  The dependency
state of the moved nodes is handed off with it (``begin_handoff`` on
the old owner, atomically with the owner-table flip; ``adopt`` in the
new owner's context), so no scheduler ever analyses dependencies for a
node it does not own.  With the feature disabled (default) no handler,
message or charge differs from the unsharded runtime.
"""

from __future__ import annotations

import sys
import threading
from typing import TYPE_CHECKING

from .api import nid_of
from .deps import ARG, TRAVERSE, WAIT, Entry
from .regions import MODE_WRITE, ROOT_RID, AncestryCache, NodeMeta
from .runtime import DISPATCHED, DONE, READY, SPAWNED
from .sched import SchedNode, score_candidates
from .sim import batch_payload_bytes
from .substrate import Message

if TYPE_CHECKING:  # pragma: no cover - import cycle guard
    from .runtime import Myrmics, Task, TaskContext


class SchedAgent:
    """One scheduler node's agent: spawn / traverse / descend /
    complete / quiesce effects, acting only on state this scheduler
    owns."""

    # steal-gate hysteresis: required ratio of compute saved to one-shot
    # re-fetch DMA before a queued task may be re-homed (see
    # :meth:`_pick_steals`)
    STEAL_GATE_FACTOR = 2.0
    # minimum gate-passing backlog on a victim worker before any of it
    # may be stolen: shallow queues (a balanced app draining at a
    # barrier) re-balance themselves faster than a steal round-trip, and
    # re-homing their tasks scatters the next iteration's locality
    STEAL_MIN_VICTIM_QUEUE = 3

    def __init__(self, rt: "Myrmics", sched: SchedNode):
        self.rt = rt
        self.sched = sched
        self.cache = AncestryCache(rt.dir)

    def owner_sched(self, nid: int) -> SchedNode:
        """The scheduler owning ``nid``, via this agent's cached owner
        route (the id-decode; stale-after-migration answers are
        re-homed by the dependency coordinator)."""
        return self.rt.sched_of(self.cache.owner_of(nid))

    # ---- shard forwarding ---------------------------------------------------

    def forward_lookup(self, requester: SchedNode, nid: int) -> NodeMeta:
        """Standalone forwarded-lookup primitive: resolve a node's
        metadata, charged on the owning scheduler's core when the
        requester does not own it (free locally).

        The hot paths do not call this — their cross-shard reads ride
        messages they already charge (pack_per_arg during packing,
        dep_enqueue/traverse during traversal).  This is the explicit
        primitive for reads outside those flows (extensions, tooling),
        and pins down the forwarding cost model under test."""
        rt = self.rt
        nid = nid_of(nid)   # accept RegionRef/ObjRef handles
        owner_id = rt.dir.owner_of(nid)
        meta = rt.dir.serve_lookup(nid, requester.core_id)
        if owner_id != requester.core_id:
            rt.sub.send(requester, rt.sched_of(owner_id),
                        Message("noop", cost=rt.cost.shard_lookup_proc))
        return meta

    # ---- spawn path ---------------------------------------------------------

    def sys_spawn(self, task: "Task", ctx: "TaskContext") -> None:
        rt = self.rt
        # well-formedness (the programming model's footprint rule [6]):
        # every child argument must lie inside the spawner's footprint.
        parent_nids = ctx.task.arg_nids()
        for a in task.dep_args:
            if not any(self.cache.is_ancestor_or_self(p, a.nid)
                       for p in parent_nids):
                raise ValueError(
                    f"{ctx.task} spawns {task} with arg node {a.nid} "
                    "outside the parent's declared footprint")
        with rt.count_lock:
            rt.tasks_spawned += 1
        # SPAWN message: worker -> owner of the parent task (routed via tree)
        rt.sub.send(ctx.worker, ctx.task.owner,
                    Message("s_spawn", (ctx.task.owner, task),
                            cost=rt.cost.spawn_proc),
                    send_time=ctx.now)

    def h_spawn(self, task: "Task") -> None:
        """Spawn handling at the parent task's owner (this agent's
        scheduler).

        Ownership is delegated downward while a single child subtree owns
        every argument (paper SV-E); the delegation messages are charged
        but the walk is resolved here so that the *dependency enqueues*
        for successive spawns of one parent leave this scheduler in spawn
        order — the origin node's FIFO queue then reflects program order.
        """
        rt = self.rt
        sched = self.sched
        arg_owners = {self.cache.owner_of(a.nid) for a in task.dep_args}
        owner = sched
        hop_src = sched
        while True:
            nxt = None
            for c in owner.children:
                if arg_owners and arg_owners <= rt.subtree_ids[c.core_id] \
                        and c.core_id not in rt.dead_scheds:
                    nxt = c
                    break
            if nxt is None:
                break
            # charge the delegation message (accounting only)
            rt.sub.send(hop_src, nxt, Message("noop", cost=rt.cost.spawn_proc))
            hop_src = nxt
            owner = nxt
        task.owner = owner
        if not task.dep_args:
            task.state = READY
            rt.sub.local(owner, Message("s_mark_ready", (task,)))
            return
        parent_nids = task.parent.arg_nids() if task.parent else [ROOT_RID]
        enqueues = []
        for i, a in enumerate(task.dep_args):
            origin = self.cache.covering_node(parent_nids, a.nid)
            path = self.cache.path_down(origin, a.nid)
            if len(path) == 1:
                entry = Entry(ARG, task, a.mode, (), i)
            else:
                entry = Entry(TRAVERSE, task, a.mode, tuple(path[1:]), i)
            enqueues.append((origin, entry, None))
        self._send_enqueues(sched, enqueues)

    # ---- coalesced dependency sends (perf: batched control plane) -----------

    def _grouped_by_owner(self, keyed_items) -> dict[str, list]:
        """Group (nid, item) pairs by owning scheduler, resolving every
        route through one :meth:`~.regions.AncestryCache.owners_of`
        pass — the batch-routing fast path shared by the enqueue and
        release coalescers."""
        keyed = list(keyed_items)
        owners = self.cache.owners_of(nid for nid, _ in keyed)
        groups: dict[str, list] = {}
        for nid, item in keyed:
            groups.setdefault(owners[nid], []).append(item)
        return groups

    def _send_enqueues(self, src: SchedNode, items: list[tuple]) -> None:
        """Send dependency enqueues, grouped per owning scheduler when
        coalescing is on: one ``s_enqueue_batch`` per (src, owner) pair,
        charged by :meth:`~.sim.CostModel.batch_cost` and sized in
        64-byte packets.  Singleton groups keep the legacy per-arg
        message with its legacy charge, so 1-arg spawn paths (the fig7a
        calibration) are identical with coalescing on or off."""
        rt = self.rt
        if not rt.coalesce:
            for nid, entry, via in items:
                rt.sub.send(src, self.owner_sched(nid),
                            Message("s_enqueue", (nid, entry, via),
                                    cost=rt.cost.dep_enqueue_per_arg))
            return
        groups = self._grouped_by_owner((it[0], it) for it in items)
        for owner_id, group in groups.items():
            dst = rt.sched_of(owner_id)
            if len(group) == 1:
                for nid, entry, via in group:
                    rt.sub.send(src, dst,
                                Message("s_enqueue", (nid, entry, via),
                                        cost=rt.cost.dep_enqueue_per_arg))
            else:
                rt.sub.send(src, dst, Message(
                    "s_enqueue_batch", (tuple(group),),
                    cost=rt.cost.batch_cost(rt.cost.dep_enqueue_per_arg,
                                            len(group)),
                    payload_bytes=batch_payload_bytes(len(group))))

    def mark_ready(self, task: "Task") -> None:
        task.state = READY
        self.begin_packing(task)

    # ---- packing + hierarchical scheduling descent --------------------------

    def begin_packing(self, task: "Task") -> None:
        """Coalesce the task footprint by last producer (paper SV-E),
        on this agent's scheduler (the task's owner).

        The footprint walk is a sharded-directory read: object metadata
        owned by other schedulers is served by their shards, and each
        remote owner is charged for answering (the pack_per_arg message
        below), replacing any free global-structure read."""
        rt = self.rt
        sched = self.sched
        pack: dict[str, int] = {}
        remote_owners: set[str] = set()
        for a in task.dep_args:
            if a.notransfer or not a.fetch:
                continue
            for meta in rt.dir.objects_under(a.nid, requester=sched.core_id):
                if meta.owner != sched.core_id:
                    remote_owners.add(meta.owner)
                key = meta.last_producer or "_unborn"
                pack[key] = pack.get(key, 0) + meta.size
        task.pack_by_worker = {
            k: v for k, v in pack.items() if k != "_unborn"
        }
        # queued-work estimate for the occupancy counters: compute plus
        # the DMA time of the packed footprint (pack-bytes-weighted
        # depth).  Set once here so descent increments and completion
        # decrements always cancel exactly.
        task.occ_weight = max(1.0, task.duration) + (
            sum(task.pack_by_worker.values()) / rt.cost.dma_bytes_per_cycle)
        cost = rt.cost.schedule_base + rt.cost.pack_per_arg * max(
            1, len(task.dep_args))
        # packing requires messages to the schedulers owning parts of
        # the footprint (paper Fig. 6a: S2 packs region A via S0 and S1)
        for ro in sorted(remote_owners):
            rt.sub.send(sched, rt.sched_of(ro),
                        Message("noop", cost=rt.cost.pack_per_arg))
        rt.sub.local(sched, Message("s_descend", (sched, task), cost=cost))

    def live_workers(self, sched: SchedNode) -> set[str]:
        """Live worker ids under ``sched`` (callers only read).  With no
        dead workers — every run except the fault-injection ones — this
        is the precomputed subtree set itself, not a fresh copy built
        per descent candidate."""
        rt = self.rt
        subtree = rt.subtree_workers[sched.core_id]
        if not rt.dead_workers:
            return subtree
        return {w for w in subtree if w not in rt.dead_workers}

    def h_descend(self, task: "Task") -> None:
        rt = self.rt
        sched = self.sched
        if sched.is_leaf and not sched.workers:
            if sched.parent is None:
                raise RuntimeError(
                    f"h_descend: no live workers left anywhere in the "
                    f"hierarchy to dispatch {task} — every worker domain "
                    "has been killed; the run cannot make progress")
            # bounce back up; a non-owner arrival was counted by the
            # parent's pick (owner-local descends never were), so
            # retract that increment before re-entering descent there
            if sched is not task.owner:
                rt.sub.update(sched.parent,
                              rt.agent_of(sched.parent)._retract_load,
                              sched.core_id, task.occ_weight)
            rt.sub.send(sched, sched.parent,
                        Message("s_descend", (sched.parent, task),
                                cost=rt.cost.dispatch_proc))
            return
        if sched.is_leaf:
            self._leaf_dispatch(task)
            return
        cands = [
            (c, rt.subtree_workers[c.core_id], sched.load[c.core_id])
            for c in sched.children
            if self.live_workers(c)
        ]
        if not cands:
            if sched.parent is None:
                # exhaustion at the root: no subtree has live workers,
                # and bouncing to a child would just ping-pong the
                # descend message forever — fail the run loudly instead.
                raise RuntimeError(
                    f"h_descend: no live workers left anywhere in the "
                    f"hierarchy to dispatch {task} — every worker domain "
                    "has been killed; the run cannot make progress")
            # no live workers below: bounce back up to the parent,
            # retracting the parent-pick increment (see the leaf bounce)
            if sched is not task.owner:
                rt.sub.update(sched.parent,
                              rt.agent_of(sched.parent)._retract_load,
                              sched.core_id, task.occ_weight)
            rt.sub.send(sched, sched.parent,
                        Message("s_descend", (sched.parent, task),
                                cost=rt.cost.dispatch_proc))
            return
        aff = None
        if rt.steal and sum(task.pack_by_worker.values()) == 0:
            # region-affinity term: when nothing has produced this
            # task's inputs yet (no packed bytes to steer by), prefer
            # the subtree whose schedulers own the In/InOut nodes it
            # will fetch (Directory ownership via the per-agent
            # AncestryCache — a pure cached read, no message or
            # charge), so the owner-side dependency traffic and the
            # compute land in the same subtree and fewer steals are
            # needed in the first place.  Out-only args are excluded:
            # they carry no fetch, and herding first-touch producers
            # onto the owning shard would fight load balance for no
            # data-movement win.
            reads = [a for a in task.dep_args if a.fetch]
            if reads:
                owners = self.cache.owners_of(a.nid for a in reads)
                n = len(reads)
                aff = [
                    sum(1 for a in reads
                        if owners[a.nid] in rt.subtree_ids[c.core_id]) / n
                    for c, _, _ in cands
                ]
        c = score_candidates(task.pack_by_worker, cands, rt.policy_p,
                             region_affinity=aff)
        sched.load[c.core_id] += 1
        sched.occ[c.core_id] = sched.occ.get(c.core_id, 0.0) + task.occ_weight
        rt.sub.send(sched, c,
                    Message("s_descend", (c, task),
                            cost=rt.cost.dispatch_proc))
        if rt.steal and sched.starving:
            # new work entered this subtree: re-nudge the oldest thief
            # whose request we relayed, so starvation retries ride on
            # dispatch traffic (a drained machine sends nothing).
            thief = rt.sched_of(sched.starving.pop(0))
            rt.sub.send(sched, thief,
                        Message("s_steal_check", (thief,),
                                cost=rt.cost.steal_proc))

    def _leaf_dispatch(self, task: "Task", only: list | None = None) -> None:
        """Leaf-level dispatch: score this leaf's workers (optionally a
        restricted subset), pin the task and send ``w_dispatch``.  Used
        by the normal descent and — unchanged, so stolen tasks behave
        exactly like first dispatches — by the thief side of a steal."""
        rt = self.rt
        sched = self.sched
        workers = only if only else sched.workers
        cands = [
            (w, {w.core_id}, sched.load[w.core_id]) for w in workers
        ]
        w = score_candidates(task.pack_by_worker, cands, rt.policy_p)
        sched.load[w.core_id] += 1
        sched.occ[w.core_id] = sched.occ.get(w.core_id, 0.0) + task.occ_weight
        task.worker = w
        task.state = DISPATCHED
        # from now on the chosen worker is the last producer of all
        # write arguments (paper SV-E); NOTRANSFER tasks never touch
        # the data, so they leave producers unchanged.  The updates
        # land in the owning shards, piggybacked on the dispatch
        # message (fixed 64-byte messages have spare payload).
        for a in task.dep_args:
            if a.mode == MODE_WRITE and not a.notransfer:
                for meta in rt.dir.objects_under(
                        a.nid, requester=sched.core_id):
                    meta.last_producer = w.core_id
        rt.sub.send(sched, w,
                    Message("w_dispatch", (w, task),
                            cost=rt.cost.worker_dispatch_recv))
        rt.worker_agent.maybe_backup(task)

    # ---- sys_wait -----------------------------------------------------------

    def h_wait(self, task: "Task", args: list) -> None:
        self._send_enqueues(
            task.owner,
            [(a.nid, Entry(WAIT, task, a.mode, (), -1), None) for a in args])

    def resume_task(self, task: "Task") -> None:
        rt = self.rt
        w = task.worker
        rt.sub.send(task.owner, w,
                    Message("w_resume", (w, task),
                            cost=rt.cost.worker_dispatch_recv))

    # ---- completion ---------------------------------------------------------

    def _note_complete(self, child_id: str, weight: float) -> None:
        """Descent load/occupancy decrement, applied in this agent's
        scheduler's execution context (its counters, its thread).  At a
        leaf, a live worker's counter reaching zero is the starvation
        signal — the steal check piggybacks on it, so the happy path
        needs no new message kinds."""
        sched = self.sched
        if child_id in sched.load:
            sched.load[child_id] = max(0, sched.load[child_id] - 1)
            sched.occ[child_id] = max(
                0.0, sched.occ.get(child_id, 0.0) - weight)
            if (self.rt.steal and sched.is_leaf
                    and sched.load[child_id] == 0):
                self.maybe_steal()

    def _retract_load(self, child_id: str, weight: float) -> None:
        """Victim-side counter retraction for a stolen task (no steal
        trigger: the victim must not recurse into stealing mid-grant)."""
        sched = self.sched
        if child_id in sched.load:
            sched.load[child_id] = max(0, sched.load[child_id] - 1)
            sched.occ[child_id] = max(
                0.0, sched.occ.get(child_id, 0.0) - weight)

    def _credit_load(self, child_id: str, weight: float) -> None:
        """Thief-side counter credit for a stolen task's new descent
        path (mirrors the increments h_descend would have applied)."""
        sched = self.sched
        if child_id in sched.load:
            sched.load[child_id] += 1
            sched.occ[child_id] = sched.occ.get(child_id, 0.0) + weight

    def h_complete(self, task: "Task") -> None:
        rt = self.rt
        if task.completed:
            return  # backup copy finished second; first completion won
        task.completed = True
        task.state = DONE
        with rt.count_lock:
            rt.tasks_done += 1
        inj = rt.fault_injector
        if inj is not None and inj.snapshots is not None:
            # region durability: commit the task's Out objects before
            # their quiesce effects propagate (owner-context hook)
            inj.snapshots.on_complete(task)
        rt.worker_agent.note_service_time(
            getattr(task, "last_exec_cycles", 1.0))
        # load decrements piggyback on the completion route (worker ->
        # owner); each counter is applied in its owning scheduler's
        # context through the uncharged update channel.
        if task.worker is not None:
            node = task.worker
            while node is not task.owner and node.parent is not None:
                parent = node.parent
                rt.sub.update(parent, rt.agent_of(parent)._note_complete,
                              node.core_id, task.occ_weight)
                node = parent
        owner = task.owner
        if rt.coalesce and len(task.dep_args) > 1:
            # one s_release_batch per (owner, arg-owner) pair instead of
            # one s_release per argument; singletons keep the legacy
            # message and charge
            groups = self._grouped_by_owner(
                (a.nid, a.nid) for a in task.dep_args)
            for owner_id, nids in groups.items():
                dst = rt.sched_of(owner_id)
                if len(nids) == 1:
                    for nid in nids:
                        rt.sub.send(owner, dst,
                                    Message("s_release", (nid, task),
                                            cost=rt.cost.traverse_hop))
                else:
                    rt.sub.send(owner, dst, Message(
                        "s_release_batch", (tuple(nids), task),
                        cost=rt.cost.batch_cost(rt.cost.traverse_hop,
                                                len(nids)),
                        payload_bytes=batch_payload_bytes(len(nids))))
        else:
            for a in task.dep_args:
                rt.sub.send(owner, self.owner_sched(a.nid),
                            Message("s_release", (a.nid, task),
                                    cost=rt.cost.traverse_hop))
        if task is rt.main_task:
            rt.deps.release(ROOT_RID, task)

    # ---- work stealing (dask-style, with a data-movement gate) ---------------

    def maybe_steal(self) -> None:
        """Starvation check at a leaf scheduler: if live workers sit
        idle, first rebalance this leaf's own queues (no protocol
        messages), then — at most one outstanding request at a time —
        send a charged ``s_steal_req`` up the tree.

        The check piggybacks on traffic that already exists: the
        completion-walk counter decrement (sim + threads), the threads
        backend's idle-worker ``s_steal_check`` nudge, and the
        starving-thief re-nudges relayed on task descents."""
        rt = self.rt
        sched = self.sched
        if not rt.steal or not sched.is_leaf:
            return
        live = [w for w in sched.workers
                if w.core_id not in rt.dead_workers]
        idle = [w for w in live if sched.load.get(w.core_id, 0) == 0]
        if not idle:
            return
        if self._steal_local(idle):
            return
        if sched.steal_pending or sched.parent is None:
            return
        sched.steal_pending = True
        with rt.count_lock:
            rt.steals_attempted += 1
        rt.sub.send(sched, sched.parent,
                    Message("s_steal_req",
                            (sched.parent, sched.core_id, rt.steal_ttl),
                            cost=rt.cost.steal_proc))

    def _steal_local(self, idle: list) -> bool:
        """Intra-leaf rebalance: re-home queued-but-undispatched tasks
        from this leaf's loaded workers onto its idle ones.  No protocol
        messages — the re-dispatch itself is charged like any dispatch."""
        rt = self.rt
        idle_ids = {w.core_id for w in idle}
        picks, moved = self._pick_steals(idle_ids, exclude=idle_ids)
        if not picks:
            return False
        with rt.count_lock:
            rt.steal_tasks_moved += len(picks)
            rt.steal_bytes_moved += moved
        for task in picks:
            self._leaf_dispatch(task, only=idle)
        return True

    def h_steal_req(self, thief_id: str, ttl: int) -> None:
        """Steal-request routing (charged, parent-relayed).  A non-leaf
        match point forwards the request to its most pack-occupied child
        subtree with live workers — excluding the thief's own subtree —
        or escalates to its parent; at the root with no candidate (or an
        exhausted hop budget) the thief gets an empty grant so its
        pending flag clears.  A leaf serves as the victim."""
        rt = self.rt
        sched = self.sched
        if sched.is_leaf:
            self._serve_steal(thief_id)
            return
        if thief_id not in sched.starving:
            # remember the thief: if this round comes up empty, the next
            # descent through here re-nudges it (see :meth:`h_descend`)
            sched.starving.append(thief_id)
        thief = rt.sched_of(thief_id)
        if ttl <= 0:
            rt.sub.send(sched, thief,
                        Message("s_steal_grant", (thief, ()),
                                cost=rt.cost.steal_proc))
            return
        best, best_occ = None, 0.0
        for c in sched.children:
            if thief_id in rt.subtree_ids[c.core_id]:
                continue
            if sched.load.get(c.core_id, 0) <= 0 or not self.live_workers(c):
                continue
            o = sched.occ.get(c.core_id, 0.0)
            if best is None or o > best_occ:
                best, best_occ = c, o
        if best is not None:
            rt.sub.send(sched, best,
                        Message("s_steal_req", (best, thief_id, ttl - 1),
                                cost=rt.cost.steal_proc))
        elif sched.parent is not None:
            rt.sub.send(sched, sched.parent,
                        Message("s_steal_req",
                                (sched.parent, thief_id, ttl - 1),
                                cost=rt.cost.steal_proc))
        else:
            rt.sub.send(sched, thief,
                        Message("s_steal_grant", (thief, ()),
                                cost=rt.cost.steal_proc))

    def _serve_steal(self, thief_id: str) -> None:
        """Victim side: pick the stealable half of this leaf's queued
        work (gate-passing, see :meth:`_pick_steals`) and grant it to
        the thief leaf in one charged message."""
        rt = self.rt
        sched = self.sched
        if thief_id == sched.core_id:   # degenerate routing: nothing to do
            picks, moved = [], 0
        else:
            picks, moved = self._pick_steals(rt.subtree_workers[thief_id])
        thief = rt.sched_of(thief_id)
        if picks:
            with rt.count_lock:
                rt.steals_granted += 1
                rt.steal_tasks_moved += len(picks)
                rt.steal_bytes_moved += moved
        rt.sub.send(sched, thief, Message(
            "s_steal_grant", (thief, tuple(picks)),
            cost=rt.cost.steal_proc + rt.cost.dispatch_proc * len(picks),
            payload_bytes=batch_payload_bytes(max(1, len(picks)))))

    def _pick_steals(self, thief_wids: set[str],
                     exclude: set[str] | None = None) -> tuple[list, int]:
        """Steal-half selection with the data-movement gate.

        A queued-but-undispatched task passes the gate when the compute
        it would save (its declared duration, falling back to the
        service-time EWMA) exceeds ``STEAL_GATE_FACTOR`` times the DMA
        cost of re-fetching the part of its packed footprint that lives
        outside the thief subtree, at the cost model's per-byte rate.
        The factor > 1 is hysteresis: a steal also scatters the task's
        *future* locality (its outputs re-home to the thief), a cost the
        one-shot DMA estimate cannot see, so marginal steals are worse
        than they look and the gate demands a clear win.  Per victim
        worker the *later*
        half of what passes is taken (dask-style steal-half) — all of it
        when the worker has other outstanding work beyond the passing
        set.  Picked tasks are removed from the victim queues and their
        descent-path counters retracted."""
        rt = self.rt
        sched = self.sched
        cost = rt.cost
        picks: list = []
        moved = 0
        for w in sched.workers:
            if exclude and w.core_id in exclude:
                continue
            # passing ⊆ w.queue, so a queue under the minimum bar can
            # never produce a take — skip the scan (most queues are
            # empty or shallow when a steal check sweeps the leaf)
            if len(w.queue) < self.STEAL_MIN_VICTIM_QUEUE:
                continue
            passing = []
            for task in rt.worker_agent.queued_stealable(w):
                if task.completed or task.state != DISPATCHED:
                    continue
                if task.stolen >= 2:    # ping-pong guard
                    continue
                est = task.duration or rt.service_ewma or 0.0
                foreign = sum(b for wid, b in task.pack_by_worker.items()
                              if wid not in thief_wids)
                dma = (cost.dma_startup + foreign / cost.dma_bytes_per_cycle
                       if foreign else 0.0)
                if est > self.STEAL_GATE_FACTOR * dma:
                    passing.append((task, foreign))
            if len(passing) < self.STEAL_MIN_VICTIM_QUEUE:
                continue
            if sched.load.get(w.core_id, 0) > len(passing):
                take = passing
            else:
                take = passing[(len(passing) + 1) // 2:]
            for task, foreign in take:
                if not rt.worker_agent.remove_queued(w, task):
                    continue   # raced into execution
                task.stolen += 1
                task.worker = None
                moved += foreign
                picks.append(task)
                self._retract_path(w, task)
        return picks, moved

    def _retract_path(self, node, task: "Task") -> None:
        """Undo the descent-path load/occ increments for a task leaving
        ``node``'s queue (victim side), each counter applied in its
        owning scheduler's context via the uncharged update channel."""
        rt = self.rt
        while node is not task.owner and node.parent is not None:
            parent = node.parent
            rt.sub.update(parent, rt.agent_of(parent)._retract_load,
                          node.core_id, task.occ_weight)
            node = parent

    def h_steal_grant(self, tasks: tuple) -> None:
        """Thief side: granted tasks are dispatched across this leaf's
        workers with the normal scoring — their ``last_producer``
        updates land in the owning directory shards exactly like a first
        dispatch — and the descent-path counters toward each task's
        owner are re-credited along the new path.  An empty grant just
        clears the pending flag (no immediate retry: the next completion
        or idle nudge re-triggers the check, keeping the protocol
        quiescent when the whole machine drains)."""
        rt = self.rt
        sched = self.sched
        sched.steal_pending = False
        for task in tasks:
            if task.completed or task.state != DISPATCHED:
                continue
            if not sched.workers:
                # every worker here died while the grant was in flight:
                # hand the task back to its owner for a fresh descent
                rt.sub.local(task.owner,
                             Message("s_descend", (task.owner, task),
                                     cost=rt.cost.schedule_base))
                continue
            self._leaf_dispatch(task)
            node = sched
            while node is not task.owner and node.parent is not None:
                parent = node.parent
                rt.sub.update(parent, rt.agent_of(parent)._credit_load,
                              node.core_id, task.occ_weight)
                node = parent

    # ---- ownership migration (paper SV-C) -----------------------------------

    def maybe_migrate(self) -> None:
        """Opt-in load balancing: if this agent's scheduler holds more
        directory nodes than ``rt.migrate_threshold``, hand its largest
        fitting region subtree to the least-loaded sibling.

        Runs in the owner's execution context (the alloc agent routes
        it there).  Following the simulation's convention (mutations
        synchronous, cycle costs travel as messages), the shard hand-off
        is applied immediately — directory flip and dependency-state pop
        atomically under the directory lock, adoption in the new owner's
        context — while the parent-routed protocol (owner -> parent
        request, parent -> sibling grant carrying the subtree metadata)
        is charged through the substrate with a per-node transfer
        cost."""
        rt = self.rt
        owner = self.sched
        th = rt.migrate_threshold
        if th is None or owner.parent is None or owner.migrate_no_fit:
            return
        if owner.region_load <= th:
            return
        sibs = owner.siblings()
        if not sibs:
            return
        target = min(sibs, key=lambda c: (c.region_load, c.core_id))
        gap = owner.region_load - target.region_load
        if gap <= 1:
            return
        # largest owned region subtree that still narrows the gap
        best, best_n = None, 0
        for m in rt.dir.shard(owner.core_id).live_regions():
            if m.nid == ROOT_RID:
                continue
            n = rt.dir.owned_subtree_size(m.nid)
            if best_n < n <= gap // 2 + 1:
                best, best_n = m, n
        if best is None:
            # nothing fits (e.g. one monolithic region): object allocs
            # only widen it, so stop rescanning until a new region owned
            # by this scheduler appears (cleared in AllocAgent.sys_ralloc)
            owner.migrate_no_fit = True
            return
        # directory flip + dependency-state pop are atomic under the
        # directory lock: any observer that sees the new owner also sees
        # the in-flight marker, and defers behind the adopt.
        with rt.dir.lock:
            nids = rt.dir.subtree_owned_nids(best.nid)
            handoff = rt.deps.begin_handoff(
                nids, owner.core_id, target.core_id)
            moved = rt.dir.migrate_subtree(best.nid, target.core_id)
        if not moved:   # pragma: no cover - target is never the owner
            rt.deps.adopt(handoff, owner.core_id)
            return
        owner.region_load -= len(moved)
        rt.sub.update(target, self._adopt_migration,
                      target, handoff, len(moved))
        with rt.count_lock:
            rt.migrations += 1
            rt.nodes_migrated += len(moved)
        # parent-routed hand-off: request, then grant + metadata transfer
        rt.sub.send(owner, owner.parent,
                    Message("noop", cost=rt.cost.migrate_proc))
        rt.sub.send(owner.parent, target,
                    Message("noop",
                            cost=rt.cost.migrate_proc
                            + rt.cost.migrate_per_node * len(moved)))

    def _adopt_migration(self, target: SchedNode, handoff: dict,
                         n_moved: int) -> None:
        """New-owner side of a hand-off (runs in target's context)."""
        self.rt.deps.adopt(handoff, target.core_id)
        target.region_load += n_moved


#: kind -> interned "{kind}_batch" tag, built lazily (4 kinds in
#: practice): the flush path must not allocate a fresh f-string — and
#: re-hash it — per coalesced batch.
_BATCH_KINDS: dict = {}


def _batch_kind(kind: str) -> str:
    k = _BATCH_KINDS.get(kind)
    if k is None:
        k = _BATCH_KINDS[kind] = sys.intern(kind + "_batch")
    return k


class _CoalesceScope:
    """Context for one dependency-cascade coalescing extent.  The
    effect buffer dict is recycled through ``fx._local.spare`` across
    scopes on the same thread, so steady-state cascades allocate only
    this small slotted object."""

    __slots__ = ("fx", "opened")

    def __init__(self, fx: "DepEffects"):
        self.fx = fx

    def __enter__(self) -> "_CoalesceScope":
        fx = self.fx
        local = fx._local
        if not fx.rt.coalesce or getattr(local, "buf", None) is not None:
            self.opened = False
            return self
        buf = getattr(local, "spare", None)
        if buf is None:
            buf = {}
        else:
            local.spare = None
        local.buf = buf
        self.opened = True
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self.opened:
            fx = self.fx
            local = fx._local
            buf, local.buf = local.buf, None
            try:
                fx._flush(buf)
            finally:
                buf.clear()
                local.spare = buf
        return False


class DepEffects:
    """DepEngine effects: every callback is work on the owner of the
    destination node; route + charge accordingly.  The effects object
    is deliberately stateless apart from the thread-local outgoing
    coalescing buffer — it runs inside whichever shard's scan emitted
    the effect, so any per-scheduler state it needed would belong to
    that shard, not here.

    With coalescing on, a *batch* dependency handler opens
    :meth:`coalesce_scope` around its scan cascade: the per-entry
    effects it emits (traversal-forwarding ``s_enqueue``, ``d_quiesce``,
    ``s_arg_ready``, ``s_wait_ready``) are buffered per (source,
    destination) pair and flushed grouped at scope exit — one
    ``*_batch`` message per pair, charged by
    :meth:`~.sim.CostModel.batch_cost_mixed`.  Singleton groups flush
    as the legacy message with the legacy charge, and singleton
    handlers never buffer (their one notification is a latency-critical
    hop).  The buffer is thread-local so concurrent scheduler threads
    never interleave buffers."""

    def __init__(self, rt: "Myrmics"):
        self.rt = rt
        self._local = threading.local()

    # ---- outgoing-message coalescing ----------------------------------------

    def coalesce_scope(self) -> "_CoalesceScope":
        """Buffer batchable effect messages for the dynamic extent of
        one dependency-handler cascade; no-op (and no buffer) when
        coalescing is off or a scope is already open on this thread.

        A hand-rolled context-manager object, not ``@contextmanager``:
        the generator machinery (one generator + two ``next`` calls per
        scope) was a measurable share of the dep-cascade hot path."""
        return _CoalesceScope(self)

    def _emit(self, src: SchedNode, dst: SchedNode, kind: str,
              item: tuple, cost: float) -> None:
        buf = getattr(self._local, "buf", None)
        if buf is None:
            self.rt.sub.send(src, dst, Message(kind, item, cost=cost))
            return
        key = (src.core_id, dst.core_id, kind)
        group = buf.get(key)
        if group is None:
            group = buf[key] = []
        group.append((item, cost))

    def _flush(self, buf: dict) -> None:
        rt = self.rt
        sched_of = rt.sched_of
        send = rt.sub.send
        batch_cost_mixed = rt.cost.batch_cost_mixed
        for (src_id, dst_id, kind), entries in buf.items():
            if len(entries) == 1:
                item, cost = entries[0]
                send(sched_of(src_id), sched_of(dst_id),
                     Message(kind, item, cost=cost))
            else:
                items = tuple(item for item, _ in entries)
                send(sched_of(src_id), sched_of(dst_id), Message(
                    _batch_kind(kind), (items,),
                    cost=batch_cost_mixed(c for _, c in entries),
                    payload_bytes=batch_payload_bytes(len(entries))))

    # ---- batch-message handler entry points ----------------------------------

    def _h_arg_ready_batch(self, items: tuple) -> None:
        for (task,) in items:
            self._h_arg_ready(task)

    def _h_wait_ready_batch(self, items: tuple) -> None:
        for (task,) in items:
            self._h_wait_ready(task)

    def forward_traverse(self, from_nid: int, entry: Entry) -> None:
        rt = self.rt
        nxt = entry.path[0]
        rest = entry.path[1:]
        if rest:
            new = Entry(TRAVERSE, entry.task, entry.mode, rest, entry.arg_index)
            cost = rt.cost.traverse_hop
        else:
            new = Entry(ARG, entry.task, entry.mode, (), entry.arg_index)
            cost = rt.cost.dep_enqueue_per_arg
        self._emit(rt.node_owner(from_nid), rt.node_owner(nxt),
                   "s_enqueue", (nxt, new, from_nid), cost)

    def arg_activated(self, task, arg_index: int, nid: int) -> None:
        self._emit(self.rt.node_owner(nid), task.owner,
                   "s_arg_ready", (task,), self.rt.cost.arg_ready_proc)

    def _h_arg_ready(self, task) -> None:
        task.satisfied += 1
        if task.satisfied == len(task.dep_args) and task.state == SPAWNED:
            task.state = READY
            self.rt.agent_of(task.owner).begin_packing(task)

    def wait_activated(self, task, nid: int) -> None:
        self._emit(self.rt.node_owner(nid), task.owner,
                   "s_wait_ready", (task,), self.rt.cost.arg_ready_proc)

    def _h_wait_ready(self, task) -> None:
        task.wait_remaining -= 1
        if task.wait_remaining == 0:
            self.rt.agent_of(task.owner).resume_task(task)

    def send_quiesce(self, child_nid: int, parent_nid: int,
                     recv_r: int, recv_w: int) -> None:
        rt = self.rt
        self._emit(rt.node_owner(child_nid), rt.node_owner(parent_nid),
                   "d_quiesce", (parent_nid, child_nid, recv_r, recv_w),
                   rt.cost.quiesce_proc)
