"""The declarative programming surface (paper Fig. 4).

The paper's model is *declarative*: access annotations live on the task
signature and the compiler derives the spawn footprint.  This module is
that surface for the reproduction:

* ``In`` / ``Out`` / ``InOut`` / ``Safe`` — access specifications.
  Used as *annotations* on a ``@task`` signature (``x: In``,
  ``y: Out``, ``k: Safe``; ``In.nt`` or ``Annotated[In, NOTRANSFER]``
  for the NOTRANSFER variants), or *called* with a handle/nid as the
  legacy shim (``In(oid)`` returns an :class:`Arg`).
* ``@task`` — wraps a function whose signature carries access
  annotations into a :class:`TaskFn`.  ``ctx.spawn(fn, a, b, c)``
  binds the arguments against the signature and derives the dependency
  footprint; calling ``fn(a, b, c)`` inside a running task spawns it
  through the ambient context.
* ``RegionRef`` / ``ObjRef`` — opaque typed handles returned by
  ``ctx.ralloc/alloc/balloc``.  They carry their directory nid and
  label, resolve their live owning scheduler through the directory,
  and support ctx-free ``ref.read()`` / ``ref.write(v)`` sugar.
* ``RunReport`` — the typed result of ``Myrmics.run`` (it still
  supports ``rep["total_cycles"]`` for the legacy dict surface).

Everything here lowers onto the same internals as the legacy
positional-``list[Arg]`` surface, so the two front ends are
cycle-identical; the serial oracle executes the same decorated
functions, keeping the serial-equivalence property tests meaningful
for both.
"""

from __future__ import annotations

import inspect
import threading
import typing
from contextlib import contextmanager
from dataclasses import dataclass, field, replace
from typing import Any

from .regions import MODE_READ, MODE_WRITE

#: Metadata marker for ``Annotated[In, NOTRANSFER]`` annotations.
NOTRANSFER = "notransfer"


# -- lowered argument spec (the internal/legacy form) --------------------------


@dataclass(frozen=True)
class Arg:
    """One lowered task argument (paper Fig. 4 type bits)."""

    nid: int | None          # region/object id; None for SAFE by-value args
    mode: str | None         # MODE_READ / MODE_WRITE; None for SAFE
    safe: bool = False
    notransfer: bool = False
    fetch: bool = True       # False for OUT-only args: no DMA-in needed
    value: Any = None        # SAFE only
    ref: Any = field(default=None, compare=False, repr=False)  # originating handle


# -- typed handles -------------------------------------------------------------


class Ref:
    """Opaque handle to a directory node: carries the nid, the
    application label and (via the directory) the live owning
    scheduler.  Hashes/compares by nid so handles can key sets/dicts
    interchangeably with raw ids."""

    __slots__ = ("nid", "label", "_dir")
    kind = "node"

    def __init__(self, nid: int, label: str | None = None, directory=None):
        self.nid = nid
        self.label = label
        self._dir = directory

    @property
    def owner(self) -> str | None:
        """Core id of the owning scheduler (live: follows migration)."""
        return self._dir.owner_of(self.nid) if self._dir is not None else None

    def __index__(self) -> int:
        return self.nid

    def __int__(self) -> int:
        return self.nid

    def __eq__(self, other) -> bool:
        if isinstance(other, Ref):
            return self.nid == other.nid
        if isinstance(other, int):
            return self.nid == other
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.nid)

    def __repr__(self) -> str:
        tag = f" {self.label!r}" if self.label else ""
        return f"<{type(self).__name__}{tag} #{self.nid}>"


class ObjRef(Ref):
    """Handle to an object: supports ctx-free read/write sugar that
    routes through the ambient task context (so the runtime's access
    checks still apply)."""

    __slots__ = ()
    kind = "object"

    def read(self) -> Any:
        return current_ctx().read(self)

    def write(self, value: Any) -> None:
        current_ctx().write(self, value)


class RegionRef(Ref):
    """Handle to a region: a growable pool of objects and subregions.
    Regions hold no value themselves — reads/writes must target an
    :class:`ObjRef` inside them."""

    __slots__ = ()
    kind = "region"

    def read(self) -> Any:
        raise TypeError(
            f"{self!r} is a region, not an object: regions hold no value "
            "(read an ObjRef allocated inside it)")

    def write(self, value: Any) -> None:
        raise TypeError(
            f"{self!r} is a region, not an object: regions hold no value "
            "(write an ObjRef allocated inside it)")


def nid_of(target) -> int:
    """Coerce a handle-or-raw-id to the directory nid."""
    if isinstance(target, Ref):
        return target.nid
    if isinstance(target, bool) or not isinstance(target, int):
        raise TypeError(
            f"expected a RegionRef/ObjRef handle or a raw nid, got {target!r}")
    return target


def value_nid(target, directory, op: str) -> int:
    """Coerce a read/write target to its nid, rejecting regions — typed
    handle and raw nid alike: regions hold no value."""
    if isinstance(target, RegionRef):
        raise TypeError(
            f"{target!r} is a region, not an object: regions hold no value "
            "(access an ObjRef allocated inside it)")
    nid = nid_of(target)
    if directory is not None and directory.has(nid) \
            and directory.is_region(nid):
        raise TypeError(
            f"{op}({nid}): node is a region, not an object — regions hold "
            "no value (access an object allocated inside it)")
    return nid


def free_nid(target, region: bool, op: str) -> int:
    """Coerce a free/rfree target to its nid, rejecting the wrong handle
    kind (shared by the parallel and serial contexts)."""
    if region and isinstance(target, ObjRef):
        raise TypeError(f"{op}({target!r}): use ctx.free for objects")
    if not region and isinstance(target, RegionRef):
        raise TypeError(f"{op}({target!r}): use ctx.rfree for regions")
    return nid_of(target)


# -- the ambient context stack -------------------------------------------------

# Thread-local: on the threaded backend each pool thread runs its own
# task activation, and one thread's ambient context must never leak
# into another's ref.read()/write() access checks.
_CTX_LOCAL = threading.local()


def _ctx_stack() -> list[Any]:
    stack = getattr(_CTX_LOCAL, "stack", None)
    if stack is None:
        stack = _CTX_LOCAL.stack = []
    return stack


@contextmanager
def active_ctx(ctx):
    """Make ``ctx`` the ambient task context for the dynamic extent of
    one task activation (used by the worker agents and the serial
    oracle around every ``fn(ctx, ...)`` / generator step)."""
    stack = _ctx_stack()
    stack.append(ctx)
    try:
        yield ctx
    finally:
        stack.pop()


def current_ctx():
    """The context of the task activation currently executing; this is
    what ``ref.read()`` and direct ``taskfn(...)`` calls resolve."""
    stack = _ctx_stack()
    if not stack:
        raise RuntimeError(
            "no task is executing: ref.read()/ref.write() and direct "
            "task calls only work inside a running task (use "
            "ctx.read/ctx.write/ctx.spawn otherwise)")
    return stack[-1]


# -- access specifications -----------------------------------------------------


@dataclass(frozen=True)
class Access:
    """An access specification: annotation on ``@task`` parameters
    (``x: In``, ``x: In.nt``) and, called with a handle, the legacy
    ``Arg`` constructor shim (``In(oid)``)."""

    mode: str | None
    safe: bool = False
    notransfer: bool = False
    fetch: bool = True
    _name: str = ""

    @property
    def nt(self) -> "Access":
        """The NOTRANSFER variant: dependency-ordered, but grants the
        task no storage access and moves no data."""
        return replace(self, notransfer=True)

    def __call__(self, target, notransfer: bool = False) -> Arg:
        if self.safe:
            return Arg(None, None, safe=True, value=target)
        return Arg(nid_of(target), self.mode,
                   notransfer=self.notransfer or notransfer, fetch=self.fetch,
                   ref=target if isinstance(target, Ref) else None)

    def __repr__(self) -> str:
        return self._name + (".nt" if self.notransfer else "")


In = Access(MODE_READ, _name="In")
Out = Access(MODE_WRITE, fetch=False, _name="Out")
InOut = Access(MODE_WRITE, _name="InOut")
Safe = Access(None, safe=True, _name="Safe")


def _resolve_spec(param: inspect.Parameter, fn) -> Access:
    ann = param.annotation
    if typing.get_origin(ann) is typing.Annotated:
        base, *meta = typing.get_args(ann)
        if isinstance(base, Access):
            if NOTRANSFER in meta:
                base = base.nt
            ann = base
    if isinstance(ann, Access):
        return ann
    raise TypeError(
        f"@task {fn.__qualname__}: parameter {param.name!r} needs an access "
        "annotation (In/Out/InOut/Safe, .nt or Annotated[..., NOTRANSFER] "
        f"for NOTRANSFER), got {ann!r}")


# -- @task ---------------------------------------------------------------------


class TaskFn:
    """A task function with a declarative footprint.

    The first parameter receives the task context; every following
    parameter must carry an access annotation.  A ``*args`` parameter
    (annotated) declares a variable-length tail of same-mode arguments;
    keyword-only parameters are bound by keyword at spawn time.
    """

    def __init__(self, fn, name: str | None = None):
        self.fn = fn
        self.__name__ = name or fn.__name__
        self.__doc__ = fn.__doc__
        self.__wrapped__ = fn
        sig = inspect.signature(fn, eval_str=True)
        params = list(sig.parameters.values())
        if not params:
            raise TypeError(
                f"@task {fn.__qualname__}: the first parameter receives the "
                "task context")
        for p in params[1:]:
            if p.kind is inspect.Parameter.VAR_KEYWORD:
                raise TypeError(
                    f"@task {fn.__qualname__}: **{p.name} is not supported — "
                    "the footprint must be derivable from the signature")
            if p.name in ("duration", "name"):
                raise TypeError(
                    f"@task {fn.__qualname__}: parameter name {p.name!r} is "
                    "reserved for spawn options (duration=, name=) and would "
                    "be shadowed at spawn time — rename the parameter")
        self._sig = sig
        self._specs = {p.name: _resolve_spec(p, fn) for p in params[1:]}

    def lower(self, args: tuple, kwargs: dict):
        """Bind call arguments against the signature and lower them.

        Returns ``(footprint, pos, kw)``: the :class:`Arg` list in
        signature order (``*args`` tails expand), plus the positional
        values and keyword-only values to call the function body with.
        """
        try:
            bound = self._sig.bind(None, *args, **kwargs)
        except TypeError as e:
            raise TypeError(f"@task {self.__name__}: {e}") from None
        bound.apply_defaults()
        lowered, pos, kw = [], [], {}
        for pname, spec in self._specs.items():
            if pname not in bound.arguments:
                continue
            value = bound.arguments[pname]
            param = self._sig.parameters[pname]
            if param.kind is inspect.Parameter.VAR_POSITIONAL:
                lowered.extend(spec(v) for v in value)
                pos.extend(value)
            elif param.kind is inspect.Parameter.KEYWORD_ONLY:
                lowered.append(spec(value))
                kw[pname] = value
            else:
                lowered.append(spec(value))
                pos.append(value)
        return lowered, pos, kw

    def footprint(self, args: tuple, kwargs: dict) -> list[Arg]:
        """The derived dependency footprint for one call (paper Fig. 4)."""
        return self.lower(args, kwargs)[0]

    def __call__(self, *args, duration: float = 0.0, name: str | None = None,
                 **kwargs):
        """Direct-call sugar: spawn through the ambient task context."""
        return current_ctx().spawn(self, *args, duration=duration, name=name,
                                   **kwargs)

    def __repr__(self) -> str:
        return f"<task {self.__name__}>"


def task(fn=None, *, name: str | None = None):
    """Decorator: derive a task's dependency footprint from its
    signature's access annotations (paper Fig. 4)::

        @task
        def stencil(ctx, blk: InOut, top: Out, bot: Out, *nbrs: In):
            blk.write(...)

        ctx.spawn(stencil, blk, top, bot, left, right)   # or, in a task:
        stencil(blk, top, bot, left, right)
    """
    if fn is None:
        return lambda f: TaskFn(f, name=name)
    return TaskFn(fn, name=name)


# -- run report ----------------------------------------------------------------

_REPORT_FIELDS = (
    "total_cycles", "tasks_spawned", "tasks_done", "events",
    "workers", "scheds", "region_load", "migrations", "nodes_migrated",
    "backend", "msg_kinds", "steals", "sanitize", "wire", "procs",
    "faults",
)

#: Message kinds that carry per-argument dependency control traffic —
#: the traffic coalescing batches.  Prefix-matched so the ``*_batch``
#: variants count toward the same family.
_DEP_CONTROL_PREFIXES = (
    "s_enqueue", "s_release", "d_quiesce", "s_arg_ready", "s_wait_ready",
)


@dataclass
class RunReport:
    """Typed result of ``Myrmics.run`` (one simulated application run).

    ``workers``/``scheds`` map core ids to their per-core stats;
    ``region_load`` maps scheduler ids to owned-directory-node counts.
    ``backend`` records which substrate produced the run: for ``"sim"``
    the time fields are virtual cycles, for ``"threads"`` they are
    wall-clock seconds measured on the real executor.  ``to_dict()``
    reproduces the legacy ``report()`` dict for the benchmark JSON
    path, and ``rep["key"]`` keeps dict-style reads working as a thin
    shim.
    """

    total_cycles: float
    tasks_spawned: int
    tasks_done: int
    events: int
    workers: dict[str, Any]
    scheds: dict[str, Any]
    region_load: dict[str, int]
    migrations: int
    nodes_migrated: int
    backend: str = "sim"
    #: per-kind wire-message accounting: kind -> {"count", "bytes"}
    #: (sim counts cross-core sends; threads counts every send)
    msg_kinds: dict[str, Any] = field(default_factory=dict)
    #: work-stealing outcome counters: attempted/granted requests,
    #: tasks and packed bytes re-homed (all zero with ``steal=False``)
    steals: dict[str, Any] = field(default_factory=dict)
    #: dynamic footprint-sanitizer counters (``Myrmics(sanitize=True)``):
    #: ``enabled``, ``accesses_checked``, ``violations``
    sanitize: dict[str, Any] = field(default_factory=dict)
    #: procs backend only: real wire-frame accounting —
    #: ``{"per_kind": {kind: {"frames", "bytes"}}, "total_frames",
    #: "total_bytes"}`` measured on the host<->worker sockets (empty on
    #: sim/threads, whose messages never serialize)
    wire: dict[str, Any] = field(default_factory=dict)
    #: procs backend only: per-worker-process stats (pid, frames/bytes
    #: each way, tasks shipped); empty on sim/threads
    procs: dict[str, Any] = field(default_factory=dict)
    #: fault-layer recovery counters (``Myrmics(faults=...)``): kills,
    #: replays, evacuations, detections, snapshot commits/restores;
    #: ``{"enabled": False}`` on a fault-free run
    faults: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {name: getattr(self, name) for name in _REPORT_FIELDS}

    def __getitem__(self, key: str):
        if key not in _REPORT_FIELDS:
            raise KeyError(key)
        return getattr(self, key)

    def msg_summary(self) -> dict:
        """Wire-message accounting for the run: per-kind counts/bytes,
        totals, and the per-task rates — in particular
        ``dep_ctrl_msgs_per_task``, the per-argument dependency-control
        traffic (enqueue/release/quiesce/ready families) that message
        coalescing batches; the ``msg_coalescing`` benchmark row and the
        CI perf smoke assert its >=2x reduction.  Works on both
        backends; :func:`repro_torch.core.trace.msg_summary` renders the
        per-kind table as rows."""
        per_kind = {k: dict(v) for k, v in sorted(self.msg_kinds.items())}
        total = sum(v["count"] for v in per_kind.values())
        total_bytes = sum(v["bytes"] for v in per_kind.values())
        dep = sum(v["count"] for k, v in per_kind.items()
                  if k.startswith(_DEP_CONTROL_PREFIXES))
        tasks = self.tasks_done or 1
        return {
            "per_kind": per_kind,
            "total_msgs": total,
            "total_bytes": total_bytes,
            "dep_ctrl_msgs": dep,
            "msgs_per_task": total / tasks,
            "dep_ctrl_msgs_per_task": dep / tasks,
        }

    def wire_summary(self) -> dict:
        """Real wire traffic for a procs-backend run: per-frame-kind
        frame counts and byte totals measured on the host<->worker
        sockets, plus per-task rates.  All-zero/empty on sim/threads
        (their messages are routed in-memory and never serialize)."""
        per_kind = dict(self.wire.get("per_kind", {}))
        total = self.wire.get("total_frames", 0)
        total_bytes = self.wire.get("total_bytes", 0)
        tasks = self.tasks_done or 1
        return {
            "per_kind": per_kind,
            "total_frames": total,
            "total_bytes": total_bytes,
            "frames_per_task": total / tasks,
            "bytes_per_task": total_bytes / tasks,
        }

    def proc_summary(self) -> dict:
        """Per-worker-process stats for a procs-backend run: pid, frames
        and bytes in each direction, tasks shipped.  Empty on
        sim/threads."""
        return {wid: dict(st) for wid, st in sorted(self.procs.items())}

    def steal_summary(self) -> dict:
        """Work-stealing outcome for the run: requests attempted and
        granted, tasks and packed bytes re-homed, plus the per-worker
        occupancy coefficient of variation — std/mean of per-worker busy
        time, the imbalance quantity the ``skewed_dag`` benchmark row
        asserts stealing lowers.  Counters are zero with ``steal=False``
        (the cv is still computed); works on both backends.
        :func:`repro_torch.core.trace.steal_summary` renders the rounded
        view."""
        busys = [st.busy_cycles for st in self.workers.values()]
        n = len(busys) or 1
        mean = sum(busys) / n
        var = sum((b - mean) ** 2 for b in busys) / n
        cv = (var ** 0.5) / mean if mean else 0.0
        out = {"attempted": 0, "granted": 0,
               "tasks_moved": 0, "bytes_moved": 0}
        out.update(self.steals)
        out["occupancy_cv"] = cv
        return out

    def sanitize_summary(self) -> dict:
        """Dynamic-sanitizer outcome for the run: whether the sanitizer
        was armed, how many storage accesses it validated, how many
        violations (footprint lies or determinacy races) it counted —
        a passing sanitized run reports ``violations == 0`` — plus the
        per-task check rate.  All-zero with the default
        ``sanitize=False``.  :func:`repro_torch.core.trace.sanitize_summary`
        renders the rounded view."""
        out = {"enabled": False, "accesses_checked": 0, "violations": 0}
        out.update(self.sanitize)
        out["checks_per_task"] = out["accesses_checked"] / (self.tasks_done
                                                            or 1)
        return out

    def fault_summary(self) -> dict:
        """Fault-layer outcome for the run: whether an injector was
        armed, workers/schedulers killed, tasks replayed from their
        recorded footprints, shard evacuations performed, detections by
        reason, and region-snapshot commits/restores.  All-zero with
        the default ``faults=None``."""
        out = {
            "enabled": False, "workers_killed": 0, "scheds_killed": 0,
            "tasks_replayed": 0, "evacuations": 0, "nodes_evacuated": 0,
            "detections": {}, "snapshots_saved": 0,
            "snapshots_restored": 0, "snapshots_skipped": 0,
        }
        out.update(self.faults)
        return out

    def sched_summary(self) -> dict[str, dict]:
        """Per-scheduler decentralization stats: messages handled,
        mailbox queue delay and occupancy for every scheduler node
        (sim: virtual cycles / fractions of virtual time; threads:
        wall seconds measured on the per-scheduler mailbox threads).
        This is the quantity the ``sched_scaling`` benchmark row
        sweeps; :func:`repro_torch.core.trace.sched_summary` renders it as
        rows."""
        total = self.total_cycles or 1.0
        out = {}
        for core_id, st in self.scheds.items():
            msgs = st.msgs_handled
            out[core_id] = {
                "msgs_handled": msgs,
                "queue_delay": st.queue_delay_cycles,
                "mean_queue_delay":
                    st.queue_delay_cycles / msgs if msgs else 0.0,
                "occupancy": st.busy_cycles / total,
            }
        return out
