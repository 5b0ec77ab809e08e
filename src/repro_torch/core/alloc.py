"""Memory-allocation agent: sys_ralloc / sys_alloc / sys_balloc / free.

Role-scoped slice of the runtime (paper SV-B), instantiated *per
scheduler node*: allocation requests are messages from the calling
worker to the scheduler that owns the target region; that owner's
agent creates the node in its directory shard and charges the request
processing on its core.  Task bodies reach these handlers through
``rt.sub.call`` — on the sim substrate that is a synchronous call at
the spawn site (mutations synchronous, cycle costs travel as charge
messages through the substrate); on the threaded substrate the call is
marshalled to the owning scheduler's mailbox, so directory mutation for
a node only ever happens in its owner's execution context.  Scheduler
bookkeeping that belongs to a *different* node than the handling one
(the region-load counter of a delegated-down region owner, and the
migration scan it may trigger) is applied through the substrate's
uncharged ``update`` channel.

Region placement (paper SV-C): a new region is delegated down the
scheduler tree toward ``level_hint``, choosing the least-loaded child at
every step, so the region directory spreads over the hierarchy.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from .regions import AncestryCache
from .sched import SchedNode
from .substrate import Message

if TYPE_CHECKING:  # pragma: no cover - import cycle guard
    from .runtime import Myrmics, TaskContext


class AllocAgent:
    """One scheduler node's allocation/free handlers.  Shares its
    scheduler's :class:`~.regions.AncestryCache` for owner routes."""

    def __init__(self, rt: "Myrmics", cache: AncestryCache):
        self.rt = rt
        self.cache = cache

    def _require_region(self, nid: int, call: str) -> None:
        """Allocation targets must be regions — objects cannot contain
        allocations.  Enforced here so both the typed-handle API and the
        legacy raw-nid shim get the same check."""
        if not self.rt.dir.is_region(nid):
            raise TypeError(
                f"{call}: node {nid} is an object, not a region — "
                "objects cannot contain allocations")

    def assign_region_owner(self, parent_rid: int, level_hint: int) -> SchedNode:
        rt = self.rt
        s = rt.sched_of(self.cache.owner_of(parent_rid))
        while s.depth < level_hint and s.children:
            s = min(s.children, key=lambda c: (c.region_load, c.core_id))
        return s

    @staticmethod
    def _note_alloc(owner: SchedNode, n: int, fresh_region: bool) -> None:
        """Directory-load bookkeeping, in the owning scheduler's
        context."""
        owner.region_load += n
        if fresh_region:
            owner.migrate_no_fit = False  # fresh migration candidate

    def _owner_scan(self, owner: SchedNode) -> None:
        """Run the owner's migration scan in the owner's context."""
        self.rt.sub.update(owner, self.rt.agent_of(owner).maybe_migrate)

    def sys_ralloc(self, parent_rid: int, level_hint: int,
                   ctx: "TaskContext | None", label: str | None = None) -> int:
        rt = self.rt
        self._require_region(parent_rid, "ralloc")
        owner = self.assign_region_owner(parent_rid, level_hint)
        rt.sub.update(owner, self._note_alloc, owner, 1, True)
        rid = rt.dir.new_region(parent_rid, owner.core_id, level_hint)
        if label is not None:
            rt.labels[rid] = label
        if ctx is not None:
            rt.sub.send(ctx.worker, owner,
                        Message("noop", cost=rt.cost.ralloc_proc),
                        send_time=ctx.now)
        self._owner_scan(owner)
        return rid

    def sys_alloc(self, size: int, rid: int, ctx: "TaskContext | None",
                  label: str | None = None) -> int:
        rt = self.rt
        self._require_region(rid, "alloc")
        owner = rt.sched_of(self.cache.owner_of(rid))
        rt.sub.update(owner, self._note_alloc, owner, 1, False)
        oid = rt.dir.new_object(rid, owner.core_id, size)
        if label is not None:
            rt.labels[oid] = label
        if ctx is not None:
            rt.sub.send(ctx.worker, owner,
                        Message("noop", cost=rt.cost.alloc_proc),
                        send_time=ctx.now)
        self._owner_scan(owner)
        return oid

    def sys_balloc(self, size: int, rid: int, num: int,
                   ctx: "TaskContext | None", label: str | None = None) -> list[int]:
        rt = self.rt
        self._require_region(rid, "balloc")
        owner = rt.sched_of(self.cache.owner_of(rid))
        rt.sub.update(owner, self._note_alloc, owner, num, False)
        oids = [rt.dir.new_object(rid, owner.core_id, size)
                for _ in range(num)]
        if label is not None:
            for i, oid in enumerate(oids):
                rt.labels[oid] = f"{label}[{i}]"
        if ctx is not None:
            rt.sub.send(
                ctx.worker, owner,
                Message("noop", cost=rt.cost.alloc_proc
                        + rt.cost.balloc_per_obj * num),
                send_time=ctx.now)
        self._owner_scan(owner)
        return oids

    def sys_free(self, oid: int, ctx: "TaskContext | None") -> None:
        self._free_common(oid, ctx)

    def sys_rfree(self, rid: int, ctx: "TaskContext | None") -> None:
        self._free_common(rid, ctx)

    def _free_common(self, nid: int, ctx: "TaskContext | None") -> None:
        rt = self.rt
        owner = rt.sched_of(self.cache.owner_of(nid))
        for freed in rt.dir.free(nid):
            # dependency state is dropped through the dep coordinator:
            # nodes delegated to other schedulers are dropped in *their*
            # owner's execution context, never reached into directly.
            rt.deps.drop(freed)
            rt.storage.pop(freed, None)
        if ctx is not None:
            rt.sub.send(ctx.worker, owner,
                        Message("noop", cost=rt.cost.free_proc),
                        send_time=ctx.now)
