"""Hierarchical dependency analysis (paper SV-D), sharded per scheduler.

Every region/object node keeps an in-order *dependency queue* plus
counters tracking busy descendants.  A task is ready when its entry is
*active* at every argument node.  Traversals flow from the spawner's
covering argument down to the target node, incrementing per-edge "sent"
counters; subtree completion flows upward as QUIESCE notifications
carrying cumulative "received" counters, which the parent compares with
its "sent" counters to tolerate crossing messages (the paper's
parent/child counter race protocol, Fig. 5b).

Sharding model (mirroring :class:`~.regions.DirectoryShard`):

* :class:`DepShard` — one scheduler's slice of the dependency state.
  A node's :class:`DepNode` lives in the shard of the scheduler that
  owns the node in the region directory; every mutation happens in
  that scheduler's execution context (asserted), so shard contents are
  single-threaded by construction — no locks on the hot path.
* :class:`DepEngine` — the coordinator: routes an operation to the
  owning shard.  When the operation is invoked from a *different*
  scheduler's context (a message that crossed an SV-C ownership
  migration in flight), it is re-homed to the owner through the
  substrate's uncharged ``update`` channel — synchronous on the
  virtual-time backend (bit-identical to the unsharded engine),
  queue-to-queue on the threaded backend.
* Migration hand-off: ``begin_handoff`` (on the old owner, atomically
  with the directory owner-table flip) pops the moving ``DepNode``s and
  marks them *in flight*; ``adopt`` (in the new owner's context)
  installs them and clears the marker.  Operations that observe the
  marker defer themselves behind the adopt so no scheduler ever acts
  on dependency state it does not hold.

The shard is a pure state machine: all cross-node notifications are
emitted through an ``Effects`` interface so the runtime can charge
scheduler processing costs and message latencies for hops that cross
scheduler boundaries.
"""

from __future__ import annotations

import contextlib
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Protocol

from .regions import MODE_READ, MODE_WRITE, Directory

#: reusable no-op context (``contextlib.nullcontext`` instances are
#: stateless, so one object serves every un-coalesced batch scope)
_NULL_CTX = contextlib.nullcontext()
_UNSET = object()


# ---------------------------------------------------------------------------
# queue entries
# ---------------------------------------------------------------------------

ARG = "arg"            # task argument settles at this node
TRAVERSE = "traverse"  # passing through, heading to a descendant
WAIT = "wait"          # sys_wait: task waits for its delegated subtree


@dataclass
class Entry:
    kind: str
    task: "object"            # runtime Task (opaque to this module)
    mode: str                 # MODE_READ or MODE_WRITE
    path: tuple[int, ...] = ()  # remaining node path (TRAVERSE only)
    arg_index: int = -1       # which task argument (ARG/WAIT)


@dataclass
class EdgeState:
    """Parent-side per-child-edge counters (paper's 'c' counters) and the
    acknowledgement state used for the race protocol."""

    sent_r: int = 0
    sent_w: int = 0
    acked_r: int = 0
    acked_w: int = 0

    @property
    def busy_r(self) -> int:
        return self.sent_r - self.acked_r

    @property
    def busy_w(self) -> int:
        return self.sent_w - self.acked_w


@dataclass
class DepNode:
    nid: int
    queue: deque = field(default_factory=deque)
    holders: dict = field(default_factory=dict)      # task -> mode (active ARGs)
    edges: dict = field(default_factory=dict)        # child nid -> EdgeState
    recv_r: int = 0   # child-side cumulative received counters ('p' counters)
    recv_w: int = 0
    last_quiesce_sent: tuple[int, int] = (-1, -1)
    #: Running sums of ``busy_r``/``busy_w`` over all edges, maintained
    #: where the per-edge counters change (_activate / recv_quiesce) so
    #: the activation scan never re-sums the adjacency dict.  Both are
    #: always >= 0: ``acked`` is only ever set to a value ``sent``
    #: already reached.
    busy_r_total: int = 0
    busy_w_total: int = 0

    def child_busy(self, mode: str) -> int:
        if mode == MODE_WRITE:
            return self.busy_r_total + self.busy_w_total
        return self.busy_w_total

    def active_writers(self) -> list:
        return [t for t, m in self.holders.items() if m == MODE_WRITE]

    def idle(self) -> bool:
        return (
            not self.queue
            and not self.holders
            and self.busy_r_total == 0
            and self.busy_w_total == 0
        )


class Effects(Protocol):
    """Callbacks the runtime provides; every call corresponds to work on
    the scheduler that owns the *destination* node."""

    def forward_traverse(self, from_nid: int, entry: Entry) -> None: ...
    def arg_activated(self, task, arg_index: int, nid: int) -> None: ...
    def wait_activated(self, task, nid: int) -> None: ...
    def send_quiesce(self, child_nid: int, parent_nid: int,
                     recv_r: int, recv_w: int) -> None: ...


class DepShard:
    """One scheduler's slice of the dependency state machine.

    The runtime routes each operation to the handler of the owning
    scheduler, which acts on *its own* shard; emitted effects are again
    routed (and charged) by the runtime.  State per node is therefore
    only ever touched 'on' its owner, matching the distributed design —
    enforced by the execution-context assert on every mutation.
    """

    def __init__(self, owner_id: str, directory: Directory, effects: Effects,
                 engine: "DepEngine | None" = None):
        self.owner_id = owner_id
        self.dir = directory
        self.fx = effects
        self.eng = engine
        self.nodes: dict[int, DepNode] = {}
        self._sub = None   # substrate memo (set on first non-None sighting)

    def __len__(self) -> int:
        return len(self.nodes)

    def __contains__(self, nid: int) -> bool:
        return nid in self.nodes

    def _check_context(self) -> None:
        """Shard state may only be touched in its owner's execution
        context (or outside any handler: program entry, tests)."""
        sub = self._sub
        if sub is None:
            sub = self.eng.sub if self.eng is not None else None
            if sub is None:     # bare-engine tests / pre-bind: no context
                return
            self._sub = sub     # the substrate never changes once set
        ex = sub.executing_id()
        if ex is not None and ex != self.owner_id:
            raise AssertionError(
                f"DepShard[{self.owner_id}] touched from scheduler {ex}: "
                "cross-owner dependency state access must go through "
                "substrate messages")

    def node(self, nid: int) -> DepNode:
        self._check_context()
        n = self.nodes.get(nid)
        if n is None:
            n = self.nodes[nid] = DepNode(nid)
        return n

    # -- helpers ------------------------------------------------------------

    @staticmethod
    def _is_ancestor_task(maybe_anc, task) -> bool:
        # runtime Tasks carry a precomputed ancestor set; fall back to
        # the parent-chain walk for opaque task stand-ins (bare-engine
        # tests use plain objects)
        anc = getattr(task, "_anc", None)
        if anc is not None:
            return maybe_anc in anc
        cur = task
        while cur is not None:
            cur = getattr(cur, "parent", None)
            if cur is maybe_anc:
                return True
        return False

    def _foreign_holders(self, node: DepNode, task) -> list:
        """Active holders that are NOT ancestors of ``task`` (a spawner's
        own hold does not block its descendants: hierarchical delegation)."""
        return [t for t in node.holders if not self._is_ancestor_task(t, task)]

    # -- entry admission ------------------------------------------------------

    def enqueue(self, nid: int, entry: Entry, via_parent: int | None = None) -> None:
        """Admit an entry at a node.  ``via_parent`` set when the entry
        arrived through the region-tree edge from that parent (counts
        toward the child-side 'received' counters)."""
        node = self.node(nid)
        if via_parent is not None:
            if entry.mode == MODE_WRITE:
                node.recv_w += 1
            else:
                node.recv_r += 1
        node.queue.append(entry)
        self.scan(nid, node)

    # -- activation scan ------------------------------------------------------

    def _can_activate(self, node: DepNode, entry: Entry) -> bool:
        # same predicate as the original list-building form ("foreign" =
        # holders that are not ancestors of entry.task), written as
        # early-exit loops over the holders dict: the scan calls this
        # for every queued entry, so no per-call list allocation.
        holders = node.holders
        task = entry.task
        kind = entry.kind
        if kind == TRAVERSE:
            # heading into a child: ordering deeper in the tree resolves
            # same-branch conflicts; only whole-node holders block us.
            if entry.mode == MODE_WRITE:
                for t in holders:
                    if not self._is_ancestor_task(t, task):
                        return False
                return True
            for t, m in holders.items():
                if m == MODE_WRITE and not self._is_ancestor_task(t, task):
                    return False
            return True
        if kind == ARG:
            if entry.mode == MODE_WRITE:
                if node.busy_r_total or node.busy_w_total:
                    return False
                for t in holders:
                    if not self._is_ancestor_task(t, task):
                        return False
                return True
            if node.busy_w_total:
                return False
            for t, m in holders.items():
                if m == MODE_WRITE and not self._is_ancestor_task(t, task):
                    return False
            return True
        if kind == WAIT:
            if entry.mode == MODE_WRITE:
                if node.busy_r_total or node.busy_w_total:
                    return False
                for t in holders:
                    if t is not task:
                        return False
                return True
            if node.busy_w_total:
                return False
            for t, m in holders.items():
                if t is not task and m == MODE_WRITE:
                    return False
            return True
        raise AssertionError(kind)

    def _activate(self, node: DepNode, entry: Entry) -> None:
        if entry.kind == ARG:
            node.holders[entry.task] = self._merge_hold(
                node.holders.get(entry.task), entry.mode
            )
            self.fx.arg_activated(entry.task, entry.arg_index, node.nid)
        elif entry.kind == TRAVERSE:
            nxt = entry.path[0]
            edge = node.edges.get(nxt)
            if edge is None:
                edge = node.edges[nxt] = EdgeState()
            if entry.mode == MODE_WRITE:
                edge.sent_w += 1
                node.busy_w_total += 1
            else:
                edge.sent_r += 1
                node.busy_r_total += 1
            self.fx.forward_traverse(node.nid, entry)
        elif entry.kind == WAIT:
            self.fx.wait_activated(entry.task, node.nid)

    def _nested_in_holder(self, node: DepNode, entry: Entry) -> bool:
        """Entry belonging to the turn of a task currently holding this
        node: it may bypass blocked entries queued ahead of it (paper
        SV-D: a parent's children are enqueued *under* its active claim,
        not behind later waiters).  This covers entries spawned
        (transitively) by a holder, and a holder's *own* entries — in
        particular its sys_wait: a WAIT stuck behind a foreign ARG that
        is itself blocked by the waiter's hold would deadlock."""
        task = entry.task
        holders = node.holders
        # ``task in holders`` == any(h is task): Task hashes by identity.
        if task in holders:
            return True
        anc = getattr(task, "_anc", None)
        if anc is not None:
            # any holder among task's ancestors, as one C-level set op
            return not anc.isdisjoint(holders)
        for h in holders:
            if self._is_ancestor_task(h, task):
                return True
        return False

    def scan(self, nid: int, node: DepNode | None = None) -> None:
        """Activate admissible entries: FIFO prefix for ordinary entries
        (the first blocked entry stops ordinary activation, preserving
        the program's serial order), but entries nested inside a current
        active holder bypass the blocked prefix.

        Identical activation order to the original copy-per-pass
        implementation: each pass walks the queue in place and removes
        the chosen entry by index (duplicate-valued entries behave the
        same — equal entries satisfy the same predicates, so the first
        eligible one is always the first equal one)."""
        if node is None:
            node = self.node(nid)
        queue = node.queue
        progressed = queue
        while progressed:
            progressed = False
            blocked_front = False
            i = 0
            for entry in queue:
                if not blocked_front:
                    if self._can_activate(node, entry):
                        del queue[i]
                        self._activate(node, entry)
                        progressed = True
                        break
                    blocked_front = True
                # behind a blocked entry: only holder-nested entries
                # (in their own FIFO order) may bypass
                elif self._nested_in_holder(node, entry) and \
                        self._can_activate(node, entry):
                    del queue[i]
                    self._activate(node, entry)
                    progressed = True
                    break
                i += 1
        self._maybe_quiesce(nid, node)

    @staticmethod
    def _merge_hold(existing: str | None, new: str) -> str:
        if existing == MODE_WRITE or new == MODE_WRITE:
            return MODE_WRITE
        return MODE_READ

    # -- completion ------------------------------------------------------------

    def release(self, nid: int, task) -> None:
        """Task finished (or sys_wait consumed): drop its hold and let the
        queue progress."""
        node = self.node(nid)
        node.holders.pop(task, None)
        self.scan(nid, node)

    # -- quiesce protocol --------------------------------------------------------

    def _maybe_quiesce(self, nid: int, node: DepNode | None = None) -> None:
        if node is None:
            node = self.node(nid)
        if not node.idle():
            return
        # dep state for nid lives on nid's owner, whose shard also holds
        # the parent pointer — a local (already-charged) directory read.
        parent = self.dir.parent_of(nid) if self.dir.has(nid) else None
        if parent is None:
            return
        snap = (node.recv_r, node.recv_w)
        if snap != node.last_quiesce_sent and snap != (0, 0):
            node.last_quiesce_sent = snap
            self.fx.send_quiesce(nid, parent, *snap)

    def recv_quiesce(self, parent_nid: int, child_nid: int,
                     recv_r: int, recv_w: int) -> None:
        """Parent-side handling of a child's QUIESCE: only accept if the
        counts match what we have sent (otherwise messages are still in
        flight and the child will re-report; paper Fig. 5b)."""
        node = self.node(parent_nid)
        edge = node.edges.get(child_nid)
        if edge is None:
            return
        if edge.sent_r == recv_r and edge.sent_w == recv_w:
            node.busy_r_total -= recv_r - edge.acked_r
            node.busy_w_total -= recv_w - edge.acked_w
            edge.acked_r, edge.acked_w = recv_r, recv_w
            self.scan(parent_nid, node)

    # -- teardown ---------------------------------------------------------------

    def drop(self, nid: int) -> None:
        """Discard a freed node's dependency state (sys_free/sys_rfree).
        The node must be idle: freeing a node with queued or active
        dependency entries is a programming error."""
        self._check_context()
        node = self.nodes.pop(nid, None)
        if node is not None and not node.idle():
            raise RuntimeError(f"freeing busy node {nid}")


class DepEngine:
    """Coordinator for the per-scheduler dependency shards.

    Pure routing: resolves a node to the shard of its directory owner
    and runs the operation in that owner's execution context.  An
    operation arriving in the *wrong* context (its message was routed
    before an ownership migration landed) is re-homed through the
    substrate's uncharged ``update`` channel — synchronous under
    virtual time, queue-to-queue on the threaded backend — and an
    operation that observes a mid-flight hand-off defers itself until
    the new owner has adopted the state.
    """

    def __init__(self, directory: Directory, effects: Effects, rt=None):
        self.dir = directory
        self.fx = effects
        self.rt = rt
        self.shards: dict[str, DepShard] = {}
        self._scope_fn = _UNSET   # memoized fx.coalesce_scope (or None)
        #: nid -> new owner core_id while a migration hand-off is in
        #: flight (set atomically with the owner-table flip, cleared by
        #: ``adopt`` in the new owner's context).
        self.in_flight: dict[int, str] = {}

    @property
    def sub(self):
        return self.rt.sub if self.rt is not None else None

    def shard(self, owner_id: str) -> DepShard:
        s = self.shards.get(owner_id)
        if s is None:
            s = self.shards[owner_id] = DepShard(
                owner_id, self.dir, self.fx, self)
        return s

    def shard_of(self, nid: int) -> DepShard:
        return self.shard(self.dir.owner_of(nid))

    # -- owner-context routing ------------------------------------------------

    def _on_owner(self, nid: int, op: str, *args) -> None:
        """Run ``shard.op(*args)`` in the owning scheduler's context.

        Local when this already *is* the owner's context (the common
        case: the runtime addressed the message to the owner); re-homed
        through ``sub.update`` when the message crossed a migration, or
        deferred behind the adopt while the hand-off is in flight."""
        target = self.in_flight.get(nid)
        sub = self.sub
        if target is not None and sub is not None:
            # mid-hand-off: park behind the adopt already queued at the
            # new owner (defer never runs inline, so the adopt is
            # guaranteed to be processed first)
            sub.defer(self.rt.sched_of(target), self._on_owner,
                      nid, op, *args)
            return
        owner = self.dir.owner_of(nid)
        ex = sub.executing_id() if sub is not None else None
        if sub is not None and ex is not None and ex != owner:
            # the message crossed a migration: re-home to the owner
            sub.update(self.rt.sched_of(owner), self._on_owner,
                       nid, op, *args)
            return
        getattr(self.shard(owner), op)(*args)

    # -- the operation surface (routed) ----------------------------------------

    def node(self, nid: int) -> DepNode:
        """Direct state access for the facade and tests (program entry:
        no handler context).  Handlers use the routed operations."""
        return self.shard_of(nid).node(nid)

    def enqueue(self, nid: int, entry: Entry,
                via_parent: int | None = None) -> None:
        self._on_owner(nid, "enqueue", nid, entry, via_parent)

    def release(self, nid: int, task) -> None:
        self._on_owner(nid, "release", nid, task)

    def recv_quiesce(self, parent_nid: int, child_nid: int,
                     recv_r: int, recv_w: int) -> None:
        self._on_owner(parent_nid, "recv_quiesce",
                       parent_nid, child_nid, recv_r, recv_w)

    def drop(self, nid: int) -> None:
        self._on_owner(nid, "drop", nid)

    # -- batched operation routing (message coalescing) --------------------------

    def _fx_scope(self):
        """The effects object's outgoing-message coalescing scope, when
        it provides one (a no-op otherwise — e.g. bare-engine tests)."""
        scope = self._scope_fn
        if scope is _UNSET:
            scope = self._scope_fn = getattr(self.fx, "coalesce_scope", None)
        return scope() if scope is not None else _NULL_CTX

    def _batch_on_owner(self, op: str, items: list) -> None:
        """Run ``shard.op(*item)`` for every item (item[0] is the nid) in
        the owning scheduler's context, preserving item order per
        destination.  Items whose owner's context this is run inline;
        items that crossed an SV-C migration are re-homed to the new
        owner — as whole sub-batches — through the same uncharged
        ``update``/``defer`` channels the per-item path uses.

        Hot path: all dict/method lookups hoisted, the shard method
        resolved once per (owner, op) — the common all-local batch runs
        as one bound-method call per item with no group dicts built."""
        sub = self.sub
        ex = sub.executing_id() if sub is not None else None
        in_flight = self.in_flight
        owner_of = self.dir.owner_of
        deferred: dict[str, list] | None = None
        rehomed: dict[str, list] | None = None
        bound: dict[str, Callable] = {}
        for item in items:
            nid = item[0]
            if in_flight:
                target = in_flight.get(nid)
                if target is not None and sub is not None:
                    if deferred is None:
                        deferred = {}
                    deferred.setdefault(target, []).append(item)
                    continue
            owner = owner_of(nid)
            if sub is not None and ex is not None and ex != owner:
                if rehomed is None:
                    rehomed = {}
                rehomed.setdefault(owner, []).append(item)
                continue
            fn = bound.get(owner)
            if fn is None:
                fn = bound[owner] = getattr(self.shard(owner), op)
            fn(*item)
        if rehomed:
            for owner, group in rehomed.items():
                sub.update(self.rt.sched_of(owner), self._h_batch_group,
                           op, group)
        if deferred:
            for target, group in deferred.items():
                sub.defer(self.rt.sched_of(target), self._h_batch_group,
                          op, group)

    def _h_batch_group(self, op: str, items: list) -> None:
        """Re-homed/deferred sub-batch, re-entering in (what is now) the
        owner's context; re-partitions in case ownership moved again."""
        with self._fx_scope():
            self._batch_on_owner(op, items)

    # -- message-handler entry points (registered by the runtime) ---------------
    # Singleton handlers do NOT open the effects' coalescing scope:
    # their notifications (one arg-ready, one quiesce) are
    # latency-critical single hops, and buffering them measurably
    # lengthens the end-to-end schedule.  Only the *batch* handlers
    # below buffer their cascades — a burst of k ops naturally emits a
    # burst of same-destination notifications worth grouping.

    def h_enqueue(self, nid: int, entry: Entry,
                  via_parent: int | None) -> None:
        self.enqueue(nid, entry, via_parent)

    def h_release(self, nid: int, task) -> None:
        if self.dir.is_live(nid):
            self.release(nid, task)

    def h_enqueue_batch(self, items: tuple) -> None:
        """One coalesced enqueue batch: items are (nid, entry,
        via_parent) in program order for this (origin, owner) pair."""
        with self._fx_scope():
            self._batch_on_owner("enqueue", list(items))

    def h_release_batch(self, nids: tuple, task) -> None:
        """One coalesced release batch: every argument node of ``task``
        owned by this scheduler."""
        with self._fx_scope():
            self._batch_on_owner(
                "release", [(nid, task) for nid in nids
                            if self.dir.is_live(nid)])

    def h_quiesce_batch(self, items: tuple) -> None:
        """One coalesced quiesce batch: items are (parent_nid, child_nid,
        recv_r, recv_w) tuples addressed to this parent-owner."""
        with self._fx_scope():
            self._batch_on_owner("recv_quiesce", list(items))

    # -- SV-C migration hand-off ------------------------------------------------

    def begin_handoff(self, nids: list[int], old_owner: str,
                      new_owner: str) -> dict:
        """Old-owner side: pop the moving dependency state and mark it
        in flight.  Must run atomically with the directory owner-table
        flip (the caller holds the directory lock), so any observer
        that sees the new owner also sees the in-flight marker."""
        shard = self.shard(old_owner)
        shard._check_context()
        moved = {}
        for nid in nids:
            node = shard.nodes.pop(nid, None)
            if node is not None:
                moved[nid] = node
                self.in_flight[nid] = new_owner
        return moved

    def adopt(self, nodes: dict, new_owner: str) -> None:
        """New-owner side: install the handed-off dependency state and
        clear the in-flight markers, unblocking deferred operations.
        No scan: adopting state must not change activation (the old
        owner's scans already ran after every mutation)."""
        shard = self.shard(new_owner)
        shard._check_context()
        for nid, node in nodes.items():
            shard.nodes[nid] = node
            self.in_flight.pop(nid, None)


# ---------------------------------------------------------------------------
# dynamic footprint sanitizer (Myrmics(sanitize=True))
# ---------------------------------------------------------------------------


class DeterminacyRaceError(RuntimeError):
    """Two conflicting storage accesses were not ordered by the
    dependency graph — either an annotation lie slipped past the
    footprint check (e.g. a ref smuggled through a ``Safe`` argument)
    or the scheduler itself released a task early (a steal/migration
    bug).  The message names both tasks, the object, and the access
    modes."""


class _ObjShadow:
    """SP-bags-style shadow for one object: the last unordered writer
    and the readers since, each stamped with the owning task's logical
    clock at access time."""

    __slots__ = ("write", "readers")

    def __init__(self) -> None:
        self.write: tuple | None = None        # (task, seq)
        self.readers: dict = {}                # task -> seq


def _happens_before(prev_task, prev_seq: int, task) -> bool:
    """Is access ``(prev_task, prev_seq)`` ordered before the current
    access by ``task``?  True when they are the same task (program
    order), when ``prev_task`` has completed (the dependency graph
    ordered its release before ``task``'s access), or when
    ``prev_task`` is an ancestor whose access preceded the spawn edge
    leading down to ``task``."""
    if prev_task is task or prev_task.completed:
        return True
    t = task
    while t is not None:
        if t.parent is prev_task:
            return prev_seq < t.san_spawn_clock
        t = t.parent
    return False


class Sanitizer:
    """Per-access footprint validation + determinacy-race detection.

    Installed as ``rt.san`` when ``Myrmics(sanitize=True)``; with the
    default ``sanitize=False`` the hot path never touches this class
    (``rt.san is None``), keeping virtual-time schedules byte-identical.

    Every ``.read()``/``.write()`` from a task body funnels through
    :meth:`check`: the access is counted, validated against the
    executing task's declared footprint (the existing
    ``Myrmics.check_access`` coverage walk), then checked against the
    per-object shadow — two conflicting accesses with no
    happens-before path through the dependency graph raise
    :class:`DeterminacyRaceError`.  A single lock serializes shadow
    state: the sim backend is single-threaded (negligible cost) and
    the threads backend's pool workers contend only on actual
    accesses.
    """

    def __init__(self, rt) -> None:
        self.rt = rt
        self.lock = threading.Lock()
        self.shadow: dict[int, _ObjShadow] = {}
        self.accesses_checked = 0
        self.violations = 0

    def counters(self) -> dict:
        return {"enabled": True, "accesses_checked": self.accesses_checked,
                "violations": self.violations}

    def check(self, task, nid: int, mode: str) -> None:
        """Validate one storage access; raises PermissionError (footprint
        lie) or DeterminacyRaceError (unordered conflict)."""
        try:
            self.rt.check_access(task, nid, mode)
        except PermissionError:
            with self.lock:
                self.accesses_checked += 1
                self.violations += 1
            raise
        with self.lock:
            self.accesses_checked += 1
            self._race_check(task, nid, mode)

    def _race_check(self, task, nid: int, mode: str) -> None:
        sh = self.shadow.get(nid)
        if sh is None:
            sh = self.shadow[nid] = _ObjShadow()
        seq = task.san_clock
        task.san_clock = seq + 1
        prev = None
        if sh.write is not None and not _happens_before(*sh.write, task):
            prev = (*sh.write, MODE_WRITE)
        if prev is None and mode == MODE_WRITE:
            for r_task, r_seq in sh.readers.items():
                if not _happens_before(r_task, r_seq, task):
                    prev = (r_task, r_seq, MODE_READ)
                    break
        if prev is not None:
            self.violations += 1
            p_task, _, p_mode = prev
            label = self.rt.labels.get(nid, f"node {nid}")
            raise DeterminacyRaceError(
                f"determinacy race on {label!s} (nid {nid}): "
                f"{p_mode} by {p_task} is unordered with {mode} by {task} "
                "— the dependency graph does not serialize these accesses")
        if mode == MODE_WRITE:
            sh.write = (task, seq)
            sh.readers.clear()
        else:
            sh.readers[task] = seq
