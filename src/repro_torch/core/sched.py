"""Hierarchical scheduler/worker tree (paper SIV, SV-C, SV-E).

Schedulers form a tree; workers hang off leaf schedulers.  All
communication is strictly parent<->child: a message between two cores is
routed along the tree (via the LCA), charging forwarding cost on every
intermediate scheduler — this is what makes non-local traffic expensive
and the hierarchy matter, exactly as on the prototype's NoC.

Scheduling of a ready task descends the tree one level at a time
combining a locality score L (bytes of the task's packed footprint that
were last produced inside the candidate subtree) with a load-balancing
score B, as ``T = (p*L + (100-p)*B) / 100`` (paper SV-E / SVI-D).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Any, Optional

from .sim import Core, CostModel, Engine, MESSAGE_SIZE


class SchedNode:
    """A scheduler core in the hierarchy."""

    def __init__(self, engine: Engine, core_id: str, depth: int,
                 parent: Optional["SchedNode"]):
        self.core = Core(engine, core_id)
        self.core_id = core_id
        self.depth = depth
        self.parent = parent
        self.children: list[SchedNode] = []
        self.workers: list[WorkerNode] = []          # leaf schedulers only
        self.region_load = 0                          # owned regions/objects
        self.migrate_no_fit = False                   # no migratable subtree
        # outstanding dispatched tasks per direct child (core_id -> count);
        # incremented during descent, decremented as completions route back.
        self.load: dict[str, int] = {}
        # pack-bytes-weighted outstanding work per direct child (same keys
        # as ``load``): the occupancy estimate work stealing uses to match
        # starving leaves against loaded victims.  Maintained at the same
        # points as ``load`` — pure bookkeeping, no messages or charges.
        self.occ: dict[str, float] = {}
        self.steal_pending = False        # one outstanding s_steal_req at a time
        # starving-thief registry (non-leaf): leaf ids whose steal
        # requests this scheduler relayed.  The next task descent through
        # here re-nudges the oldest entry (new work arriving = a new
        # steal opportunity) — retries piggyback on existing dispatch
        # traffic instead of timers, so a drained machine stays quiet.
        self.starving: list[str] = []
        self._rr = 0                                  # deterministic tie-break

    @property
    def is_leaf(self) -> bool:
        return not self.children

    def siblings(self) -> list["SchedNode"]:
        """Same-parent schedulers (migration candidates, paper SV-C)."""
        if self.parent is None:
            return []
        return [c for c in self.parent.children if c is not self]

    def subtree_scheds(self) -> list["SchedNode"]:
        out, stack = [], [self]
        while stack:
            s = stack.pop()
            out.append(s)
            stack.extend(s.children)
        return out

    def subtree_worker_ids(self) -> set[str]:
        out: set[str] = set()
        for s in self.subtree_scheds():
            out.update(w.core_id for w in s.workers)
        return out


class WorkerNode:
    """A worker core: executes tasks dispatched by its leaf scheduler,
    fetching remote argument data by DMA first.  DMA for a queued task is
    issued at dispatch time, so it overlaps with the currently running
    task (double buffering, paper SV-E)."""

    def __init__(self, engine: Engine, core_id: str, parent: SchedNode):
        self.core = Core(engine, core_id)
        self.core_id = core_id
        self.parent = parent
        self.queue: list[Any] = []          # TaskExec records (runtime-owned)
        self.suspended: dict[int, Any] = {} # tid -> suspended execution state
        self.running: Any | None = None
        self.dma_free: float = 0.0


@dataclass
class Hierarchy:
    """The full core tree plus routing helpers."""

    engine: Engine
    cost: CostModel
    root: SchedNode
    scheds: list[SchedNode]
    workers: list[WorkerNode]
    by_id: dict[str, Any] = field(default_factory=dict)
    #: route memo: (src id, dst id) -> (intermediate nodes, wire latency).
    #: Safe to cache lazily: parent pointers are immutable after a node
    #: is built (add_worker only introduces fresh ids, kill_worker keeps
    #: the node's position), and CostModel is frozen.
    _routes: dict = field(default_factory=dict, repr=False)

    @staticmethod
    def build(engine: Engine, cost: CostModel, n_workers: int,
              sched_levels: list[int]) -> "Hierarchy":
        """``sched_levels[i]`` = number of schedulers at depth i
        (sched_levels[0] must be 1).  Workers attach to the deepest
        scheduler level, split as evenly as possible."""
        assert sched_levels and sched_levels[0] == 1
        levels: list[list[SchedNode]] = []
        scheds: list[SchedNode] = []
        for depth, count in enumerate(sched_levels):
            row = []
            for i in range(count):
                if depth == 0:
                    parent = None
                else:
                    parent = levels[depth - 1][i * len(levels[depth - 1]) // count]
                s = SchedNode(engine, f"s{depth}.{i}", depth, parent)
                if parent is not None:
                    parent.children.append(s)
                    parent.load[s.core_id] = 0
                    parent.occ[s.core_id] = 0.0
                row.append(s)
                scheds.append(s)
            levels.append(row)
        leaves = levels[-1]
        workers = []
        for w in range(n_workers):
            leaf = leaves[w * len(leaves) // n_workers]
            wn = WorkerNode(engine, f"w{w}", leaf)
            leaf.workers.append(wn)
            leaf.load[wn.core_id] = 0
            leaf.occ[wn.core_id] = 0.0
            workers.append(wn)
        h = Hierarchy(engine, cost, levels[0][0], scheds, workers)
        for s in scheds:
            h.by_id[s.core_id] = s
        for w in workers:
            h.by_id[w.core_id] = w
        return h

    # -- tree routing ----------------------------------------------------------

    def _chain_up(self, node: Any) -> list[Any]:
        chain = [node]
        cur = node.parent if isinstance(node, WorkerNode) else node.parent
        while cur is not None:
            chain.append(cur)
            cur = cur.parent
        return chain

    def route_path(self, src: Any, dst: Any) -> list[Any]:
        """Cores visited between src and dst (exclusive of both) when
        routing along the tree via the LCA."""
        if src is dst:
            return []
        up = self._chain_up(src)
        down = self._chain_up(dst)
        up_ids = {id(n): i for i, n in enumerate(up)}
        lca_j = next(j for j, n in enumerate(down) if id(n) in up_ids)
        lca_i = up_ids[id(down[lca_j])]
        path = up[1:lca_i + 1] + list(reversed(down[1:lca_j]))
        return path

    def send(self, src: Any, dst: Any, proc_cost: float, handler, *args,
             send_time: float | None = None, payload_bytes: int = MESSAGE_SIZE):
        """Route a message src -> dst along the tree.  Intermediate
        schedulers charge forwarding cost; the destination core charges
        ``proc_cost`` and then runs ``handler(*args)``."""
        engine = self.engine
        t = engine.now if send_time is None else send_time
        if src is not dst:
            stats = src.core.stats
            stats.msgs_sent += 1
            stats.msg_bytes_sent += payload_bytes
            route = self._routes.get((src.core_id, dst.core_id))
            if route is None:
                inter = tuple(self.route_path(src, dst))
                # hops = len(inter) + 1; latency depends only on the pair
                lat = (self.cost.msg_base_latency
                       + self.cost.msg_hop_latency * len(inter))
                route = self._routes[src.core_id, dst.core_id] = (inter, lat)
            inter, lat = route
            t += lat
            msg_proc = self.cost.msg_proc
            for node in inter:
                t = node.core.occupy(t, msg_proc)
                stats = node.core.stats
                stats.msgs_sent += 1
                stats.msg_bytes_sent += payload_bytes
        # fused dst.core.exec_at: occupy the destination and push the
        # handler event without re-packing *args through two frames
        end = dst.core.occupy(t, proc_cost)
        now = engine.now
        engine._seq = seq = engine._seq + 1
        heapq.heappush(engine._q,
                       (end if end > now else now, seq, handler, args))

    def local(self, node: Any, proc_cost: float, handler, *args,
              at_time: float | None = None):
        """Charge processing on ``node`` without any message (same-core
        follow-up work)."""
        engine = self.engine
        t = engine.now if at_time is None else at_time
        end = node.core.occupy(t, proc_cost)
        now = engine.now
        engine._seq = seq = engine._seq + 1
        heapq.heappush(engine._q,
                       (end if end > now else now, seq, handler, args))


def choose(scored: list[tuple[float, int, Any]]) -> Any:
    """Pick max score; ties broken by the stable secondary key (the
    smallest index wins — list order).  Equivalent to
    ``max(scored, key=lambda x: (x[0], -x[1]))`` without the per-item
    lambda call: scanning in index order and replacing only on a
    strictly greater score keeps the earliest of any tied maximum."""
    if not scored:
        raise ValueError("choose() arg is an empty sequence")
    it = iter(scored)
    best = next(it)
    best_t = best[0]
    for s in it:
        if s[0] > best_t:
            best = s
            best_t = s[0]
    return best[2]


def score_candidates(
    pack_bytes_by_worker: dict[str, int],
    candidates: list[tuple[Any, set[str], int]],
    policy_p: int,
    region_affinity: list[float] | None = None,
) -> Any:
    """Combine locality and load-balance scores (paper SV-E).

    candidates: (node, worker_ids_in_subtree, load) triples.

    The locality score L of a candidate is the fraction of the task's
    packed footprint (bytes grouped by last producer) already inside the
    candidate subtree.  ``region_affinity`` — one entry per candidate in
    ``[0, 1]``, or None — is the work-stealing tier's region-ownership
    term: the fraction of the task's fetched dependency-argument nodes
    whose owning scheduler lies inside the candidate subtree.  It is a
    *tie-break* among the balance winners: only when the task has no
    packed bytes at all (nothing has produced its inputs yet) and the
    candidate is tied for the least load does L take the affinity
    value, steering first-touch tasks toward the subtree that owns
    their In/InOut regions — where the dependency analysis for them is
    sharded anyway.  Real producer bytes always win, and a less-loaded
    non-owner always beats a loaded owner: region ownership is often
    concentrated on one shard, and letting it outbid balance would herd
    whole first sweeps onto that subtree.  With
    ``region_affinity=None`` the scoring is byte-identical to the
    pre-stealing runtime.

    Degenerate case (documented contract): when ``pack_bytes_by_worker``
    is empty — typical for first-spawn tasks whose arguments have no
    producer yet — and no affinity is given, L is 0 for *every*
    candidate, so ``T = (100-p)/100 * B``: for any ``policy_p < 100``
    the ordering is pure load balance (the weight rescales every score
    equally).  At exactly ``policy_p=100`` the balance weight is zero
    too, all scores collapse to 0.0, and the choice falls through to
    list order — a pure-locality policy with no locality information
    expresses no preference (which is why locality-trap workloads at
    high p herd).  With equal loads, candidates likewise tie-break on
    list order (earliest wins, via :func:`choose`'s stable secondary
    key).  This order is pinned by
    ``tests/test_core_sched.py::TestScoreCandidates`` so placement of
    first-spawn tasks cannot silently shift under scoring changes.
    """
    total = sum(pack_bytes_by_worker.values())
    max_load = min_load = 0
    if candidates:
        max_load = min_load = candidates[0][2]
        for _, _, load in candidates:
            if load > max_load:
                max_load = load
            elif load < min_load:
                min_load = load
    scored = []
    i = 0
    for node, wids, load in candidates:
        if total > 0:
            # integer byte sum over the smaller collection: addition
            # order differs between the two shapes but the sum is an
            # exact int either way, so the score is identical
            produced = 0
            if len(wids) < len(pack_bytes_by_worker):
                for wid in wids:
                    b = pack_bytes_by_worker.get(wid)
                    if b is not None:
                        produced += b
            else:
                for wid, b in pack_bytes_by_worker.items():
                    if wid in wids:
                        produced += b
            loc = 1024.0 * produced / total
        elif region_affinity is not None and load == min_load:
            loc = 1024.0 * region_affinity[i]
        else:
            loc = 0.0
        bal = 1024.0 * (1.0 - (load / max_load if max_load > 0 else 0.0))
        t = (policy_p * loc + (100 - policy_p) * bal) / 100.0
        scored.append((t, i, node))
        i += 1
    return choose(scored)
