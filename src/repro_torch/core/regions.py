"""Region/object metadata: the sharded region-tree directory.

A Myrmics *region* is a growable pool of objects and subregions
(paper SII, SV-C).  Each region/object node is owned by exactly one
scheduler; the owner performs all dependency analysis for the node and
holds the node's metadata in its :class:`DirectoryShard`.  This module
holds the logical tree structure; the distributed-protocol state
(queues, counters) lives in ``deps.DepNode``.

Sharding model (paper SV-C):

* ``DirectoryShard`` — one scheduler's slice of the tree.  All metadata
  reads/writes for a node land in its owner's shard.
* ``Directory`` — the coordinator: it routes a nid to its shard via the
  owner table (in hardware Myrmics the owner is encoded in the id bits,
  so this lookup is a free local decode; the table exists here so that
  ownership *migration* can re-home subtrees, which the id encoding
  alone cannot express).
* Structural walks (``ancestors``, ``path_down``, ``covering_node``,
  ``objects_under``) follow parent/children pointers across shards.
  They are only ever executed inside a scheduler handler whose
  processing cost is already charged by the runtime (spawn_proc,
  pack_per_arg, traverse_hop, ...); modules outside this file never
  touch shard contents directly — they go through the Directory API and
  the runtime's forwarding path, which charges the owning scheduler.

``ROOT_RID`` (0) is the implicit top-level region owned by the root
scheduler.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field

ROOT_RID = 0

MODE_READ = "r"
MODE_WRITE = "w"   # inout: write implies read access


@dataclass
class NodeMeta:
    nid: int
    parent: int | None            # parent region nid (None for root)
    is_region: bool
    owner: str                    # scheduler core_id responsible for the node
    size: int = 0                 # bytes (objects only)
    level_hint: int = 0           # regions: requested scheduler depth
    last_producer: str | None = None   # worker core_id (objects only)
    children: set[int] = field(default_factory=set)
    freed: bool = False


class DirectoryShard:
    """One scheduler's slice of the region directory (paper SV-C).

    Holds the metadata of every node the scheduler owns.  ``served``
    counts forwarded lookups answered on behalf of other schedulers —
    the runtime charges those on this shard's core.
    """

    def __init__(self, owner_id: str, lock: threading.RLock | None = None):
        self.owner_id = owner_id
        self.nodes: dict[int, NodeMeta] = {}
        self.served = 0    # forwarded lookups answered for other cores
        self._lock = lock or threading.RLock()

    def __len__(self) -> int:
        return len(self.nodes)

    def __contains__(self, nid: int) -> bool:
        return nid in self.nodes

    def live_regions(self) -> list[NodeMeta]:
        """Owned, live region nodes (migration candidates)."""
        with self._lock:
            return [m for m in self.nodes.values()
                    if m.is_region and not m.freed]


class Directory:
    """Sharded region-tree directory.

    Every node's metadata lives in exactly one scheduler's shard; the
    owner table maps nid -> shard.  All mutation helpers keep the global
    id sequence and the per-node ``children`` sets identical to a
    single-structure implementation, so virtual-time runs are
    bit-reproducible regardless of how the tree is sharded.
    """

    def __init__(self, root_owner: str):
        self._ids = itertools.count(1)
        self.shards: dict[str, DirectoryShard] = {}
        self._owner: dict[int, str] = {}
        #: Serializes structural mutations and multi-node walks across
        #: concurrent scheduler threads.  This is the software stand-in
        #: for what the prototype gets from its transport: metadata
        #: requests serialize at the owning scheduler's mailbox, and
        #: the owner route is a free id-bit decode.  Single-field reads
        #: (owner_of / parent_of / is_region) stay lock-free; the costs
        #: of cross-shard reads are still charged through the
        #: forwarding/packing messages, exactly as before.
        self.lock = threading.RLock()
        #: Bumped whenever node ownership can change under a reader
        #: (SV-C migration) or nodes die (free): per-scheduler
        #: AncestryCaches invalidate their owner entries against it.
        self.version = 0
        #: Flat nid -> NodeMeta read index across all shards.  A meta
        #: object is created exactly once (``_place``) and never
        #: replaced: migration moves the *same* object between shards
        #: and free only marks, so this index is always coherent and a
        #: metadata read is one dict hit instead of the two-step
        #: owner-route read (which remains the authority for routing).
        self._flat: dict[int, NodeMeta] = {}
        self._place(NodeMeta(ROOT_RID, None, True, root_owner))

    # -- shard plumbing -----------------------------------------------------

    def shard(self, owner_id: str) -> DirectoryShard:
        s = self.shards.get(owner_id)
        if s is None:
            s = self.shards[owner_id] = DirectoryShard(owner_id, self.lock)
        return s

    def _place(self, meta: NodeMeta) -> None:
        with self.lock:
            self.shard(meta.owner).nodes[meta.nid] = meta
            self._owner[meta.nid] = meta.owner
            self._flat[meta.nid] = meta

    def _meta(self, nid: int) -> NodeMeta:
        # one lock-free dict hit via the flat index (see __init__): the
        # meta object is shard-location-independent, so a concurrent
        # migration (which moves the same object between shards) can
        # never make this read miss or go stale.
        return self._flat[nid]

    # -- routing / liveness (free: owner bits are part of the id) -----------

    def owner_of(self, nid: int) -> str:
        """Owning scheduler core_id (the id-encoded route, footnote 4)."""
        return self._owner[nid]

    def has(self, nid: int) -> bool:
        return nid in self._owner

    def is_live(self, nid: int) -> bool:
        return nid in self._owner and not self._meta(nid).freed

    def parent_of(self, nid: int) -> int | None:
        return self._meta(nid).parent

    def is_region(self, nid: int) -> bool:
        return self._meta(nid).is_region

    def serve_lookup(self, nid: int, requester: str) -> NodeMeta:
        """Answer a metadata lookup on behalf of ``requester``.  Local to
        the owner's shard when the requester owns the node; otherwise the
        owning shard serves (and counts) a forwarded lookup — the runtime
        charges the corresponding processing on the owner's core."""
        owner = self._owner[nid]
        if owner != requester:
            self.shards[owner].served += 1
        return self._meta(nid)

    # -- mutation (performed inside the owner's charged handler) ------------

    def new_region(self, parent: int, owner: str, level_hint: int) -> int:
        nid = next(self._ids)
        with self.lock:
            self._place(NodeMeta(nid, parent, True, owner,
                                 level_hint=level_hint))
            self._meta(parent).children.add(nid)
        return nid

    def new_object(self, parent: int, owner: str, size: int) -> int:
        nid = next(self._ids)
        with self.lock:
            self._place(NodeMeta(nid, parent, False, owner, size=size))
            self._meta(parent).children.add(nid)
        return nid

    def free(self, nid: int) -> list[int]:
        """Recursively free a node; returns all freed nids."""
        freed = []
        with self.lock:
            stack = [nid]
            while stack:
                cur = stack.pop()
                meta = self._meta(cur)
                if meta.freed:
                    continue
                meta.freed = True
                freed.append(cur)
                stack.extend(meta.children)
            parent = self._meta(nid).parent
            if parent is not None:
                self._meta(parent).children.discard(nid)
            self.version += 1
        return freed

    # -- ownership migration (paper SV-C load balancing) ---------------------

    def owned_subtree_size(self, rid: int) -> int:
        """Number of live nodes in rid's subtree owned by rid's owner."""
        return len(self.subtree_owned_nids(rid))

    def subtree_owned_nids(self, rid: int) -> list[int]:
        """Live nodes in rid's subtree owned by rid's owner — exactly
        the set :meth:`migrate_subtree` would move."""
        with self.lock:
            owner = self._owner[rid]
            out = []
            stack = [rid]
            while stack:
                cur = stack.pop()
                meta = self._meta(cur)
                if meta.freed:
                    continue
                if self._owner[cur] == owner:
                    out.append(cur)
                    stack.extend(meta.children)
            return out

    def migrate_subtree(self, rid: int, new_owner: str) -> list[int]:
        """Re-home rid's subtree: every live node currently owned by
        rid's owner moves to ``new_owner``'s shard.  Nodes inside the
        subtree already delegated elsewhere stay put (their owners keep
        serving them).  Returns the migrated nids."""
        with self.lock:
            old = self._owner[rid]
            if old == new_owner:
                return []
            src, dst = self.shard(old), self.shard(new_owner)
            moved = []
            stack = [rid]
            while stack:
                cur = stack.pop()
                meta = self._meta(cur)
                if meta.freed:
                    continue
                if self._owner[cur] == old:
                    # publish at the new home before unlinking the old
                    # one: lock-free readers (_meta) never observe a
                    # node that is in neither shard
                    dst.nodes[cur] = meta
                    meta.owner = new_owner
                    self._owner[cur] = new_owner
                    del src.nodes[cur]
                    moved.append(cur)
                    stack.extend(meta.children)
            self.version += 1
            return moved

    def evacuate_shard(self, old_owner: str, new_owner: str) -> list[int]:
        """Forced whole-shard migration (scheduler-death recovery):
        every node in ``old_owner``'s shard — live or freed, regardless
        of tree position — moves to ``new_owner``'s shard.  Same
        publish-before-unlink ordering as :meth:`migrate_subtree` so
        lock-free readers never observe a homeless node.  Returns the
        moved nids."""
        with self.lock:
            if old_owner == new_owner:
                return []
            src, dst = self.shard(old_owner), self.shard(new_owner)
            moved = []
            for cur in sorted(src.nodes):
                meta = src.nodes[cur]
                dst.nodes[cur] = meta
                meta.owner = new_owner
                self._owner[cur] = new_owner
                del src.nodes[cur]
                moved.append(cur)
            if moved:
                self.version += 1
            return moved

    # -- structural walks (cost subsumed by the calling handler's charge) ----

    def ancestors(self, nid: int) -> list[int]:
        """nid's ancestor chain [parent, ..., root]."""
        out = []
        cur = self._meta(nid).parent
        while cur is not None:
            out.append(cur)
            cur = self._meta(cur).parent
        return out

    def path_down(self, origin: int, target: int) -> list[int]:
        """Region-tree path [origin, ..., target].  ``origin`` must be an
        ancestor of (or equal to) ``target``; discovered by walking parent
        pointers from the target upward (paper SV-D)."""
        if origin == target:
            return [origin]
        chain = [target]
        cur = self._meta(target).parent
        while cur is not None:
            chain.append(cur)
            if cur == origin:
                return list(reversed(chain))
            cur = self._meta(cur).parent
        raise ValueError(f"node {origin} is not an ancestor of {target}")

    def is_ancestor_or_self(self, anc: int, nid: int) -> bool:
        if anc == nid:
            return True
        flat = self._flat
        cur = flat[nid].parent
        while cur is not None:
            if cur == anc:
                return True
            cur = flat[cur].parent
        return False

    def covering_node(self, parent_arg_nids: list[int], target: int) -> int:
        """Deepest node among ``parent_arg_nids`` that covers ``target``;
        falls back to the root region (used for the initial main task)."""
        best, best_depth = ROOT_RID, -1
        for nid in parent_arg_nids:
            if self.is_ancestor_or_self(nid, target):
                d = len(self.ancestors(nid))
                if d > best_depth:
                    best, best_depth = nid, d
        return best

    def objects_under(self, nid: int, requester: str | None = None) -> list[NodeMeta]:
        """All live objects in the subtree rooted at nid (nid included if
        it is an object), in deterministic tree order.

        When ``requester`` is given, shards other than the requester's
        count a served forwarded lookup — the runtime charges the
        corresponding owner-side processing (paper Fig. 6a: S2 packs
        region A via S0 and S1)."""
        with self.lock:
            out = []
            stack = [nid]
            while stack:
                cur = stack.pop()
                meta = self._meta(cur)
                if meta.freed:
                    continue
                if requester is not None and self._owner[cur] != requester:
                    self.shards[self._owner[cur]].served += 1
                if meta.is_region:
                    stack.extend(meta.children)
                else:
                    out.append(meta)
            return out


class AncestryCache:
    """One scheduler's local view of cross-shard routing facts.

    The owner-lookup/ancestry protocol (paper SV-C/SV-D): a scheduler
    handler may resolve *routing facts* about nodes it does not own —
    who owns a node (free on hardware: the owner is encoded in the id
    bits) and where a node sits in the region tree (parent pointers are
    immutable once published) — without a charged message.  Everything
    else about a foreign node goes through the substrate.

    Owner answers are memoized per scheduler and invalidated against
    ``Directory.version``, which bumps whenever ownership can change
    under a reader (SV-C subtree migration) or nodes die (free).  A
    stale answer between the bump and the next sync is harmless by
    protocol: a message routed to the previous owner is re-homed,
    uncharged, by the dependency coordinator's hand-off protocol.
    """

    def __init__(self, directory: Directory):
        self.dir = directory
        self._owner: dict[int, str] = {}
        self._version = -1

    def _sync(self) -> None:
        if self._version != self.dir.version:
            self._owner.clear()
            self._version = self.dir.version

    # -- owner route (cached, invalidated on migration/free) ----------------

    def owner_of(self, nid: int) -> str:
        self._sync()
        owner = self._owner.get(nid)
        if owner is None:
            owner = self._owner[nid] = self.dir.owner_of(nid)
        return owner

    def owners_of(self, nids) -> dict[int, str]:
        """Batch owner routes: one version sync for the whole group, one
        memoized lookup per distinct nid — the fast path batch routing
        groups destinations with (message coalescing)."""
        self._sync()
        cached = self._owner
        out: dict[int, str] = {}
        for nid in nids:
            owner = cached.get(nid)
            if owner is None:
                owner = cached[nid] = self.dir.owner_of(nid)
            out[nid] = owner
        return out

    # -- ancestry walks (parent pointers are immutable; no caching needed) --

    def path_down(self, origin: int, target: int) -> list[int]:
        return self.dir.path_down(origin, target)

    def covering_node(self, parent_arg_nids: list[int], target: int) -> int:
        return self.dir.covering_node(parent_arg_nids, target)

    def is_ancestor_or_self(self, anc: int, nid: int) -> bool:
        return self.dir.is_ancestor_or_self(anc, nid)
