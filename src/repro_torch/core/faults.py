"""Fault model: detection, injection, footprint replay, region
snapshots and scheduler-shard evacuation.

The dependency engine records every task's exact In/Out footprint, so a
dead worker's in-flight work is re-dispatchable by construction: the
owner re-descends each victim task (``replay_task``) and the dependency
queues replay the same footprint.  This module holds everything the
recovery layer shares across backends:

* the named failure exceptions (:class:`WorkerDiedError`,
  :class:`SchedulerDiedError`, :class:`PoisonTaskError`);
* :class:`FaultPlan` / :class:`FaultInjector` — the ``Myrmics(faults=)``
  surface: explicit or seeded-random kill schedules, replay caps with
  exponential backoff, heartbeat detection on wall-clock backends, and
  the recovery counters that feed ``RunReport.fault_summary()``;
* :class:`RegionSnapshots` — opt-in durability for Out regions through
  :mod:`repro_torch.checkpoint.store`'s atomic-commit store, restored when a
  producer's outputs are lost with its worker;
* :func:`evacuate_scheduler` — scheduler-death recovery: the dead
  node's directory/dep shards re-home onto a live sibling through the
  SV-C ``begin_handoff``/``adopt`` protocol (forced migration), and its
  worker domains are killed (their tasks replay elsewhere).

Execution semantics (see DESIGN.md §1.12): replay is *at-least-once* —
a victim task may have partially executed before the kill, so recovery
assumes task bodies are pure/idempotent with respect to their declared
footprint (the paper's model; duplicated child spawns both complete and
last-writer-wins ordering is preserved by the dependency queues).  The
one documented at-most-once hole is a procs worker whose *suspended*
generator died with the child process: its continuation lived only in
that address space, so the run fails loudly instead of replaying.

With ``faults=None`` (the default) none of this code runs on any hot
path: every hook is gated on ``rt.fault_injector``/``rt.dead_workers``/
``rt.dead_scheds`` being empty, preserving the byte-identity contract
(DESIGN.md §1.10).
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from .regions import MODE_WRITE
from .substrate import Message


class WorkerDiedError(RuntimeError):
    """A worker domain died in a way recovery cannot (or is configured
    not to) absorb.  Carries the worker id, the OS pid when the worker
    was a real process, and the last task known in flight on it."""

    def __init__(self, worker_id: str, pid: int | None = None,
                 last_task=None, detail: str = ""):
        self.worker_id = worker_id
        self.pid = pid
        self.last_task = last_task
        bits = [f"worker {worker_id} died"]
        if pid is not None:
            bits.append(f"(pid {pid})")
        if last_task is not None:
            bits.append(f"last task in flight: {last_task}")
        if detail:
            bits.append(f"— {detail}")
        super().__init__(" ".join(bits))


class SchedulerDiedError(RuntimeError):
    """A scheduler node died in a way evacuation cannot absorb (the
    root, or a real mailbox-thread death on a wall-clock backend)."""

    def __init__(self, sched_id: str, detail: str = ""):
        self.sched_id = sched_id
        msg = f"scheduler {sched_id} died"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


class PoisonTaskError(RuntimeError):
    """A task was replayed more than ``FaultPlan.max_replays`` times —
    it (or the fault schedule) is poisoning the run; fail loudly
    instead of replaying forever."""

    def __init__(self, task, n_replays: int, cap: int):
        self.task = task
        self.n_replays = n_replays
        super().__init__(
            f"poison task: {task} replayed {n_replays} times "
            f"(max_replays={cap}); failing the run instead of retrying")


@dataclass(frozen=True)
class FaultPlan:
    """The ``Myrmics(faults=...)`` knob (also accepted as a dict).

    ``kills`` is an explicit schedule of ``(node_id, at)`` pairs —
    virtual cycles on sim, wall seconds on threads/procs.  ``seed`` +
    ``n_kills`` adds seeded-random victims drawn uniformly in
    ``window`` (workers only unless ``kill_scheds``); at least one
    worker is always left alive.  ``max_replays``/``backoff``/
    ``replay_delay`` bound the per-task retry loop (delay of the n-th
    replay is ``replay_delay * backoff**(n-1)``; 0.0 replays
    immediately).  ``snapshot_dir`` opts into region snapshots through
    the checkpoint store.  ``heartbeat_s`` is the scheduler-mailbox
    liveness probe period on wall-clock backends."""

    kills: tuple = ()
    seed: int | None = None
    n_kills: int = 0
    window: tuple = (0.0, 1_000_000.0)
    kill_scheds: bool = False
    max_replays: int = 5
    backoff: float = 2.0
    replay_delay: float = 0.0
    snapshot_dir: str | None = None
    heartbeat_s: float = 0.05


def normalize_faults(spec) -> FaultPlan | None:
    """``faults=`` argument -> FaultPlan (None stays None)."""
    if spec is None:
        return None
    if isinstance(spec, FaultPlan):
        return spec
    if spec is True:
        return FaultPlan()
    if isinstance(spec, dict):
        plan = FaultPlan(**spec)
    else:
        raise ValueError(
            f"faults= expects a FaultPlan, dict or None, got {spec!r}")
    return plan


# ---------------------------------------------------------------------------
# shared replay / counter-hygiene helpers (used by every backend's kill path)
# ---------------------------------------------------------------------------


def replay_task(rt, task) -> None:
    """Re-descend a task whose worker died: the owner re-runs packing's
    descent and the dependency queues replay the recorded footprint.
    With an injector armed this is where the poison cap and exponential
    backoff live; without one (plain ``kill_worker``) the behaviour is
    the pre-fault-layer immediate re-descend."""
    msg = Message("s_descend", (task.owner, task),
                  cost=rt.cost.schedule_base)
    inj = rt.fault_injector
    if inj is not None:
        delay = inj.note_replay(task)   # raises PoisonTaskError past cap
        if delay > 0.0:
            rt.sub.timer(rt.sub.now + delay, msg)
            return
    rt.sub.local(task.owner, msg)


def retract_descent_path(rt, node, task) -> None:
    """Undo the descent-path load/occ increments for a task leaving a
    (dying) worker, starting at the worker itself so the leaf-level
    entry is covered; each counter applies in its owning scheduler's
    context via the uncharged update channel."""
    while node is not task.owner and node.parent is not None:
        parent = node.parent
        rt.sub.update(parent, rt.agent_of(parent)._retract_load,
                      node.core_id, task.occ_weight)
        node = parent


def credit_descent_path(rt, node, task) -> None:
    """Mirror of :func:`retract_descent_path` for a task re-homed onto
    a live worker (suspended-task evacuation): re-credit the counters
    along the new worker's path so completion decrements cancel."""
    while node is not task.owner and node.parent is not None:
        parent = node.parent
        rt.sub.update(parent, rt.agent_of(parent)._credit_load,
                      node.core_id, task.occ_weight)
        node = parent


def pick_live_worker(rt, leaf):
    """A live worker to adopt a dead worker's suspended records —
    preferring the same leaf (the corpse is already unlinked from
    ``leaf.workers``), else the first live worker anywhere."""
    for w in leaf.workers:
        if w.core_id not in rt.dead_workers:
            return w
    for w in rt.hier.workers:
        if w.core_id not in rt.dead_workers:
            return w
    raise RuntimeError(
        "no live workers left anywhere to re-home suspended tasks; "
        "the run cannot make progress")


# ---------------------------------------------------------------------------
# region snapshots (opt-in durability through the checkpoint store)
# ---------------------------------------------------------------------------


def _encode(v):
    """Host value -> (ndarray, type tag) for the npy-backed store, or
    None when the value is not snapshot-able (non-numeric payloads are
    skipped and counted, never an error)."""
    import numpy as np

    if v is None:
        return None
    if isinstance(v, bool):
        return np.asarray(v), "bool"
    if isinstance(v, int):
        return np.asarray(v), "int"
    if isinstance(v, float):
        return np.asarray(v), "float"
    import torch
    if isinstance(v, torch.Tensor):
        # the store keeps bf16 as its bit pattern; np.asarray would refuse it
        return v.detach().cpu(), "tensor"
    tag = "array"
    if isinstance(v, list):
        tag = "list"
    elif isinstance(v, tuple):
        tag = "tuple"
    elif isinstance(v, np.ndarray):
        tag = "nparray"
    try:
        arr = np.asarray(v)
    except Exception:
        return None
    if arr.dtype.kind not in "biufc":
        return None
    return arr, tag


def _decode(x, tag):
    """Restored array -> the host-visible type the task wrote."""
    import numpy as np

    if tag in ("tensor", "array"):
        return x        # a CPU tensor of the saved dtype, as the store restored it
    arr = np.asarray(x)
    if tag == "bool":
        return bool(arr)
    if tag == "int":
        return int(arr)
    if tag == "float":
        return float(arr)
    if tag == "list":
        return arr.tolist()
    if tag == "tuple":
        return tuple(arr.tolist())
    if tag == "nparray":
        return arr
    return x


class RegionSnapshots:
    """Opt-in Out-region durability: on every task completion the
    objects under its Out/InOut footprint are committed to the
    checkpoint store (atomic tmp+rename, see
    :mod:`repro_torch.checkpoint.store`); when a worker dies, the Out objects
    of tasks that were *executing* inside it roll back to their last
    committed value, so a partially-executed victim's torn writes never
    leak into the replay.  Restore is scoped to executing victims only:
    a queued or suspended victim never wrote anything, and rolling its
    (often region-wide) footprint back would clobber applied writes of
    *non-victim* tasks whose completions — and therefore commits — are
    still in flight.  By the same argument the executing-victim restore
    is safe: the dependency engine serializes writers, so any prior
    writer of an executing victim's footprint has fully completed and
    committed before the victim could start.  Numeric payloads only
    (ints/floats/bools and array-likes); others are skipped and
    counted."""

    def __init__(self, rt, directory: str):
        # lazy import: checkpoint.store pulls in torch at module top, and
        # the core must stay importable without it unless snapshots are
        # actually requested
        from ..checkpoint.store import CheckpointStore

        self.rt = rt
        self.store = CheckpointStore(directory, keep=1 << 30)
        self.by_nid: dict[int, int] = {}    # nid -> latest committed step
        self._step = 0
        self.saved = 0
        self.restored = 0
        self.skipped = 0

    def _out_nids(self, task) -> list[int]:
        rt = self.rt
        nids: list[int] = []
        for a in task.dep_args:
            if a.notransfer or a.mode != MODE_WRITE:
                continue
            if rt.dir.has(a.nid) and rt.dir.is_region(a.nid):
                nids.extend(m.nid for m in rt.dir.objects_under(a.nid))
            elif rt.dir.has(a.nid):
                nids.append(a.nid)
        return nids

    def on_complete(self, task) -> None:
        """Commit the task's Out objects (owner-context hook)."""
        rt = self.rt
        state, tags = {}, {}
        for nid in self._out_nids(task):
            enc = _encode(rt.storage.get(nid))
            if enc is None:
                if nid in rt.storage:
                    self.skipped += 1
                continue
            arr, tag = enc
            state[str(nid)] = arr
            tags[str(nid)] = tag
        if not state:
            return
        self._step += 1
        step = self._step
        self.store.save(step, state, extra={"types": tags})
        for key in state:
            self.by_nid[int(key)] = step
        self.saved += 1

    def on_worker_death(self, worker_id: str, executing) -> None:
        """Roll the *executing* victims' Out objects back to their last
        committed value (restore-on-replay).  Callers pass only tasks
        that may have partially run on the dead node: the in-flight
        activations of a dead child process on the procs backend —
        empty on sim (bodies apply atomically with virtual time) and on
        threads (a body already on the pool finishes normally)."""
        rt = self.rt
        for task in executing:
            for nid in self._out_nids(task):
                step = self.by_nid.get(nid)
                if step is None:
                    continue
                got = self.store.restore(step, like={str(nid): 0})
                tag = self.store.extra(step).get(
                    "types", {}).get(str(nid), "array")
                rt.storage[nid] = _decode(got[str(nid)], tag)
                self.restored += 1


# ---------------------------------------------------------------------------
# the injector: kill schedules, detection counters, replay bookkeeping
# ---------------------------------------------------------------------------


class FaultInjector:
    """Drives the fault plan for one run and owns recovery accounting.

    Injection is uniform across backends: a timer fires a ``w_dead`` /
    ``s_dead`` message (virtual time on sim, wall time on threads and
    procs) and the runtime's handler runs the same recovery path real
    detection (procs socket EOF, scheduler heartbeat) feeds."""

    def __init__(self, rt, plan: FaultPlan):
        self.rt = rt
        self.plan = plan
        self.workers_killed = 0
        self.scheds_killed = 0
        self.tasks_replayed = 0
        self.evacuations = 0
        self.nodes_evacuated = 0
        self.replays: dict[int, int] = {}       # tid -> replay count
        self.detections: dict[str, int] = {}    # reason -> count
        self.snapshots = (RegionSnapshots(rt, plan.snapshot_dir)
                          if plan.snapshot_dir else None)

    # -- schedule -----------------------------------------------------------

    def resolve_schedule(self) -> list[tuple[float, str]]:
        """The concrete kill schedule: explicit ``kills`` plus seeded
        random victims, sorted by time.  Deterministic per plan."""
        rt, plan = self.rt, self.plan
        out = [(float(at), str(node_id)) for node_id, at in plan.kills]
        if plan.n_kills and plan.seed is not None:
            rng = random.Random(plan.seed)
            pool = [w.core_id for w in rt.hier.workers]
            if plan.kill_scheds:
                pool += [s.core_id for s in rt.hier.scheds
                         if s.parent is not None]
            victims = rng.sample(pool, min(plan.n_kills, len(pool)))
            wids = {w.core_id for w in rt.hier.workers}
            if wids and wids <= set(victims):
                # never schedule the whole worker tier away
                for v in victims:
                    if v in wids:
                        victims.remove(v)
                        break
            lo, hi = plan.window
            out.extend((rng.uniform(lo, hi), v) for v in victims)
        return sorted(out)

    def arm(self) -> None:
        """Install the kill timers (and, off-sim, the first heartbeat).
        Called by ``Myrmics.run`` just before the substrate starts."""
        rt = self.rt
        for at, node_id in self.resolve_schedule():
            node = rt.hier.by_id.get(node_id)
            kind = "s_dead" if node is not None and hasattr(
                node, "children") else "w_dead"
            rt.sub.timer(at, Message(kind, (node_id, "injected")))
        if rt.backend != "sim":
            rt.sub.timer(self.plan.heartbeat_s, Message("f_heartbeat", ()))

    # -- bookkeeping --------------------------------------------------------

    def note_detection(self, reason: str) -> None:
        with self.rt.count_lock:
            self.detections[reason] = self.detections.get(reason, 0) + 1

    def note_replay(self, task) -> float:
        """Record one replay of ``task``; returns the backoff delay for
        this attempt and raises :class:`PoisonTaskError` past the cap."""
        with self.rt.count_lock:
            n = self.replays.get(task.tid, 0) + 1
            self.replays[task.tid] = n
            self.tasks_replayed += 1
        if n > self.plan.max_replays:
            raise PoisonTaskError(task, n, self.plan.max_replays)
        if self.plan.replay_delay <= 0.0:
            return 0.0
        return self.plan.replay_delay * (self.plan.backoff ** (n - 1))

    def counters(self) -> dict:
        snaps = self.snapshots
        return {
            "enabled": True,
            "workers_killed": self.workers_killed,
            "scheds_killed": self.scheds_killed,
            "tasks_replayed": self.tasks_replayed,
            "evacuations": self.evacuations,
            "nodes_evacuated": self.nodes_evacuated,
            "detections": dict(self.detections),
            "snapshots_saved": snaps.saved if snaps else 0,
            "snapshots_restored": snaps.restored if snaps else 0,
            "snapshots_skipped": snaps.skipped if snaps else 0,
        }


# ---------------------------------------------------------------------------
# scheduler-death evacuation (forced SV-C migration via handoff/adopt)
# ---------------------------------------------------------------------------


def evacuate_scheduler(rt, sched_id: str, reason: str = "killed") -> None:
    """Scheduler-death recovery: kill every worker domain under the dead
    node (their tasks replay elsewhere) and re-home the dead subtree's
    directory/dep shards onto a live sibling via the SV-C
    ``begin_handoff``/``adopt`` protocol.  Root death is unrecoverable —
    there is no sibling to adopt the root shard."""
    if sched_id in rt.dead_scheds:
        return
    node = rt.hier.by_id.get(sched_id)
    if node is None or not hasattr(node, "children"):
        raise ValueError(
            f"kill_scheduler: {sched_id!r} is not a scheduler node")
    if node.parent is None:
        raise SchedulerDiedError(
            sched_id, "the root scheduler has no sibling to adopt its "
            "shards; root death is unrecoverable")
    dead_ids = sorted(rt.subtree_ids[sched_id])
    rt.dead_scheds.update(dead_ids)
    inj = rt.fault_injector
    if inj is not None:
        with rt.count_lock:
            inj.scheds_killed += 1

    # 1. the dead subtree's worker domains die with it; their queued and
    # in-flight tasks replay through the normal worker-death path.
    for wid in sorted(rt.subtree_workers[sched_id]):
        if wid not in rt.dead_workers:
            rt.worker_agent.do_kill(wid)

    # 2. pick the adopter: the least-region-loaded live sibling, else
    # the parent itself.
    sibs = [c for c in node.parent.children
            if c.core_id not in rt.dead_scheds]
    target = (min(sibs, key=lambda c: (c.region_load, c.core_id))
              if sibs else node.parent)

    # 3. evacuate each dead shard.  begin_handoff must run in the dead
    # owner's execution context (its shard checks); on wall-clock
    # backends that context is the dead node's still-draining mailbox
    # thread (injected/logical death — a *real* thread death fails fast
    # in the heartbeat handler before ever reaching here), which also
    # serializes the pop against its in-flight handlers.
    for sid in dead_ids:
        dead = rt.hier.by_id[sid]
        if rt.backend == "sim":
            _evacuate_one(rt, dead, target)
        else:
            rt.sub.update(dead, _evacuate_one, rt, dead, target)

    # 4. counter hygiene: the parent stops tracking the dead child, and
    # no starving list may keep nudging a dead leaf.
    parent = node.parent
    rt.sub.update(parent, _scrub_dead_child, parent, sched_id)
    dead_set = set(dead_ids)
    for s in rt.hier.scheds:
        if s.core_id not in rt.dead_scheds and s.starving:
            rt.sub.update(s, _drop_dead_starving, s, dead_set)


def _evacuate_one(rt, dead, target) -> None:
    """Hand one dead scheduler's directory + dep shards to ``target``
    (runs in the dead node's execution context)."""
    if dead is target:      # pragma: no cover - guarded by caller
        return
    with rt.dir.lock:
        dir_shard = rt.dir.shards.get(dead.core_id)
        dep_shard = rt.deps.shards.get(dead.core_id)
        nids = sorted(set(dir_shard.nodes if dir_shard else ())
                      | set(dep_shard.nodes if dep_shard else ()))
        handoff = rt.deps.begin_handoff(nids, dead.core_id, target.core_id)
        moved = rt.dir.evacuate_shard(dead.core_id, target.core_id)
    dead.region_load = 0
    inj = rt.fault_injector
    if inj is not None:
        with rt.count_lock:
            inj.evacuations += 1
            inj.nodes_evacuated += len(moved)
    rt.sub.update(target, _adopt_evacuation, rt, target, handoff, len(moved))


def _adopt_evacuation(rt, target, handoff: dict, n_moved: int) -> None:
    """New-owner side of an evacuation (runs in target's context)."""
    rt.deps.adopt(handoff, target.core_id)
    target.region_load += n_moved


def _scrub_dead_child(parent, dead_id: str) -> None:
    parent.load.pop(dead_id, None)
    parent.occ.pop(dead_id, None)


def _drop_dead_starving(sched, dead_ids: set) -> None:
    sched.starving[:] = [x for x in sched.starving if x not in dead_ids]
