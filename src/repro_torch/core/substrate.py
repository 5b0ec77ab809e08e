"""The message substrate: the seam between agent logic and execution.

The paper's runtime logic (spawn handling, dependency traversal,
hierarchical descent, completion, quiesce, allocation) is *transport
agnostic*: on the 520-core prototype it runs over NoC mailboxes, in
this reproduction it runs over whichever :class:`Substrate` the
:class:`~.runtime.Myrmics` facade was constructed with.  The agents in
``sched_agent`` / ``worker_agent`` / ``alloc`` never touch an engine,
a clock or a core directly — every cross-core interaction is a
reified :class:`Message` handed to the substrate:

* ``send(src, dst, msg)``    — route a message between two cores and run
  the handler registered for ``msg.kind`` at the destination;
* ``local(node, msg)``       — same-core follow-up work (no message);
* ``call(kind, *args)``      — a synchronous runtime service invoked
  from *inside a running task body* (sys_spawn / sys_alloc / ...),
  executed on the scheduler side whatever thread the body runs on;
* ``timer(when, msg)``       — a deferred self-message (DMA completion,
  straggler watchdog, fault injection);
* ``occupy(node, arrival, cost)`` — charge/measure execution time on a
  core; ``now`` / ``next_free(node)`` — the substrate's clock;
* ``stats(node)``            — the per-core accounting record.

Handlers are registered once by the runtime (``bind``): a message is
plain data (``kind`` + ``args``), so a substrate implementation is free
to marshal it across threads — or, as :class:`SimSubstrate` does, to
feed it through the deterministic discrete-event engine, charging the
virtual-cycle costs carried by the message.  The two implementations:

* :class:`SimSubstrate` (here) — the virtual-time backend: wraps the
  :class:`~.sim.Engine` and the tree-routed :meth:`~.sched.Hierarchy.send`
  with paper-calibrated cycle charges.  Deterministic and
  bit-reproducible; used for all scaling studies.
* :class:`~.backend_threads.ThreadSubstrate` — the real concurrent
  backend: every scheduler node drains its own mailbox on a dedicated
  thread, worker cores are a thread pool executing actual Python/JAX
  task bodies, and charges are wall-clock measurements.
"""

from __future__ import annotations

import gc
import struct
from typing import Any, Callable

from .sim import MESSAGE_SIZE, CoreStats

#: Wire-frame header constants (``Message.to_wire``/``from_wire``): a
#: 2-byte magic + version so a desynchronized stream fails loudly, then
#: the interned kind code, the cost and payload_bytes charges (doubles:
#: batch payloads can be fractional in the back-to-back packet model),
#: then the length-prefixed pickled args blob.
WIRE_MAGIC = b"\xa9M"
WIRE_VERSION = 1

#: Every interned message kind, in wire-code order.  Appending is safe;
#: reordering is a wire-format break (bump WIRE_VERSION).  Kinds not in
#: this table (tests, future extensions) travel as code 0xFF plus an
#: inline length-prefixed kind string.
WIRE_KINDS = (
    "noop",
    # scheduler-role messages
    "s_spawn", "s_enqueue", "s_mark_ready", "s_descend", "s_wait",
    "s_complete", "s_steal_check", "s_steal_req", "s_steal_grant",
    "s_release", "s_arg_ready", "s_wait_ready", "d_quiesce",
    # coalesced control-plane batches (one frame, many ops)
    "s_enqueue_batch", "s_release_batch", "d_quiesce_batch",
    "s_arg_ready_batch", "s_wait_ready_batch",
    # worker-role messages
    "w_dispatch", "w_resume", "w_try_start", "w_exec", "w_resume_retry",
    "w_backup_check", "w_kill",
    # marshalled runtime services
    "sys_spawn", "sys_spawn_batch", "sys_ralloc", "sys_alloc",
    "sys_balloc", "sys_free", "sys_rfree",
    # procs-backend transport frames (host <-> worker process)
    "x_exec", "x_resume", "x_call", "x_reply", "x_complete",
    "x_suspend", "x_error", "x_stop",
    # fault detection/injection (uniform across backends)
    "w_dead", "s_dead",
)
_WIRE_KIND_INDEX = {k: i for i, k in enumerate(WIRE_KINDS)}
_WIRE_KIND_RAW = 0xFF
_WIRE_HEADER = struct.Struct(">2sBBdd")
# 8-byte lengths: a 4-byte one caps a frame at 4 GiB, and a full-width
# model's parameters and moments ship in one frame
_WIRE_LEN = struct.Struct(">Q")


class Message:
    """One reified runtime message: plain data, no behaviour.

    ``kind`` selects the destination handler from the runtime's
    registry; ``args`` is the payload; ``cost`` is the destination
    processing charge in virtual cycles (ignored by wall-clock
    substrates, which measure instead of charging).

    A ``__slots__`` plain class, not a dataclass: messages are the
    single most-allocated object in the simulator's hot loop, and the
    frozen-dataclass ``__init__`` (one ``object.__setattr__`` per
    field) plus eq/hash machinery cost measurably at the fig8 512-core
    scale.  Kind tags are interned string literals throughout the
    runtime, so handler lookups hash pre-computed pointers."""

    __slots__ = ("kind", "args", "cost", "payload_bytes")

    def __init__(self, kind: str, args: tuple = (), cost: float = 0.0,
                 payload_bytes: int = MESSAGE_SIZE):
        self.kind = kind
        self.args = args
        self.cost = cost
        self.payload_bytes = payload_bytes

    def __repr__(self) -> str:
        return (f"Message(kind={self.kind!r}, args={self.args!r}, "
                f"cost={self.cost!r}, payload_bytes={self.payload_bytes!r})")

    # -- wire form (procs backend) ------------------------------------------

    def to_wire(self) -> bytes:
        """Compact binary frame body: header (magic, version, interned
        kind code, cost, payload_bytes) + length-prefixed pickled args.
        Batch messages serialize exactly like singles — one frame per
        ``*_batch`` group, mirroring the 64-byte-packet cost model's
        one-charge-per-batch convention."""
        from . import wire
        code = _WIRE_KIND_INDEX.get(self.kind, _WIRE_KIND_RAW)
        blob = wire.dumps(self.args)
        try:
            head = _WIRE_HEADER.pack(WIRE_MAGIC, WIRE_VERSION, code,
                                     float(self.cost),
                                     float(self.payload_bytes))
        except (struct.error, TypeError, ValueError) as e:
            raise wire.WireError(
                f"unencodable frame header for {self.kind!r}: {e}") from e
        if code == _WIRE_KIND_RAW:
            kb = self.kind.encode("utf-8")
            head += _WIRE_LEN.pack(len(kb)) + kb
        return head + _WIRE_LEN.pack(len(blob)) + blob

    @classmethod
    def from_wire(cls, buf: bytes) -> "Message":
        """Inverse of :meth:`to_wire`; raises :class:`~.wire.WireError`
        on malformed frames (bad magic/version/kind code, truncated or
        trailing bytes, corrupt args blob)."""
        from . import wire
        try:
            magic, ver, code, cost, pb = _WIRE_HEADER.unpack_from(buf, 0)
        except struct.error as e:
            raise wire.WireError(f"truncated frame header: {e}") from e
        if magic != WIRE_MAGIC:
            raise wire.WireError(f"bad frame magic {magic!r}")
        if ver != WIRE_VERSION:
            raise wire.WireError(
                f"wire version mismatch: got {ver}, expected {WIRE_VERSION}")
        off = _WIRE_HEADER.size
        if code == _WIRE_KIND_RAW:
            if len(buf) < off + _WIRE_LEN.size:
                raise wire.WireError("truncated kind-string length")
            (klen,) = _WIRE_LEN.unpack_from(buf, off)
            off += _WIRE_LEN.size
            kb = buf[off:off + klen]
            if len(kb) != klen:
                raise wire.WireError("truncated kind string")
            kind = kb.decode("utf-8")
            off += klen
        else:
            if code >= len(WIRE_KINDS):
                raise wire.WireError(f"unknown interned kind code {code}")
            kind = WIRE_KINDS[code]
        if len(buf) < off + _WIRE_LEN.size:
            raise wire.WireError("truncated args-blob length")
        (blen,) = _WIRE_LEN.unpack_from(buf, off)
        off += _WIRE_LEN.size
        blob = buf[off:off + blen]
        if len(blob) != blen or off + blen != len(buf):
            raise wire.WireError(
                f"frame length mismatch: header says {blen} args bytes, "
                f"buffer has {len(buf) - off} (trailing garbage or "
                "truncation)")
        args = wire.loads(blob)
        if not isinstance(args, tuple):
            args = tuple(args)
        pb_int = int(pb)
        return cls(kind, args, cost=cost,
                   payload_bytes=pb_int if pb_int == pb else pb)


class Substrate:
    """Abstract message/time substrate the agents are written against."""

    def __init__(self) -> None:
        self.handlers: dict[str, Callable] = {}
        self._is_done: Callable[[], bool] = lambda: True
        self._route: Callable[[str, tuple], Any] | None = None
        #: per-kind wire-message accounting: kind -> [count, bytes].
        #: Follows each backend's msgs_sent convention (sim counts
        #: cross-core sends, threads counts every send); read through
        #: :meth:`msg_kind_summary`.
        self.msg_kinds: dict[str, list] = {}

    def _note_msg(self, kind: str, payload_bytes: int) -> None:
        rec = self.msg_kinds.get(kind)
        if rec is None:
            rec = self.msg_kinds[kind] = [0, 0]
        rec[0] += 1
        rec[1] += payload_bytes

    def msg_kind_summary(self) -> dict[str, dict]:
        """Snapshot of the per-kind message counts and bytes."""
        return {k: {"count": c, "bytes": b}
                for k, (c, b) in self.msg_kinds.items()}

    def bind(self, handlers: dict[str, Callable],
             is_done: Callable[[], bool] | None = None,
             route: Callable[[str, tuple], Any] | None = None) -> None:
        """Install the runtime's handler registry (kind -> callable).
        ``route`` maps a marshalled service call to its destination
        scheduler node (used by substrates that run one execution
        context per scheduler)."""
        self.handlers = handlers
        if is_done is not None:
            self._is_done = is_done
        if route is not None:
            self._route = route

    def dispatch(self, kind: str, args: tuple) -> Any:
        return self.handlers[kind](*args)

    def executing_id(self) -> str | None:
        """Core id of the node whose handler is currently executing on
        this substrate (None outside any handler — e.g. the program
        entry).  Shard-owned state uses this to assert that it is only
        ever touched in its owner's execution context."""
        return None

    # -- messaging ----------------------------------------------------------
    def send(self, src: Any, dst: Any, msg: Message, *,
             send_time: float | None = None) -> None:
        raise NotImplementedError

    def local(self, node: Any, msg: Message, *,
              at_time: float | None = None) -> None:
        raise NotImplementedError

    def call(self, kind: str, *args: Any) -> Any:
        """Synchronous runtime service from inside a task body."""
        raise NotImplementedError

    def update(self, dst: Any, fn: Callable, *args: Any) -> None:
        """Apply a state mutation *in dst's execution context*, without
        any cost or message charge.

        This is the seam for bookkeeping that the simulation convention
        applies synchronously at the call site (load-counter decrements
        piggybacked on completions, shard hand-offs, drop-on-free of
        foreign dep nodes): the virtual-time substrate runs ``fn`` right
        away — bit-identical to the pre-sharding runtime — while a
        concurrent substrate marshals it to dst's mailbox so the state
        is only ever touched by its owning scheduler thread."""
        raise NotImplementedError

    def defer(self, dst: Any, fn: Callable, *args: Any) -> None:
        """Like :meth:`update`, but never applied inline: on queueing
        substrates the mutation goes to the *back* of dst's mailbox
        even from dst's own context.  Used to park an operation behind
        an in-flight hand-off adopt that is already queued ahead."""
        self.update(dst, fn, *args)

    def timer(self, when: float, msg: Message) -> None:
        raise NotImplementedError

    # -- time / cores --------------------------------------------------------
    @property
    def now(self) -> float:
        raise NotImplementedError

    @property
    def events_processed(self) -> int:
        raise NotImplementedError

    def occupy(self, node: Any, arrival: float, cost: float) -> float:
        raise NotImplementedError

    def next_free(self, node: Any) -> float:
        raise NotImplementedError

    def stats(self, node: Any) -> CoreStats:
        raise NotImplementedError

    # -- program execution ---------------------------------------------------
    def run(self, until: float | None = None,
            max_events: int | None = None) -> None:
        raise NotImplementedError


class SimSubstrate(Substrate):
    """Virtual-time substrate: the discrete-event engine + tree routing.

    Message delivery, forwarding charges and core occupancy are exactly
    the pre-substrate ``Hierarchy.send`` / ``Engine.at`` semantics —
    virtual-time schedules are bit-identical to the unrefactored
    runtime (pinned by the fig7a/fig8 regression tests)."""

    backend = "sim"

    def __init__(self, hier) -> None:
        super().__init__()
        self.hier = hier
        self.engine = hier.engine
        self._executing: Any = None   # node whose handler is running

    def executing_id(self) -> str | None:
        ex = self._executing
        return ex.core_id if ex is not None else None

    def _dispatch_on(self, dst, kind: str, args: tuple):
        """Run a handler with ``dst`` recorded as the executing core, so
        shard ownership asserts hold through the event loop."""
        prev = self._executing
        self._executing = dst
        try:
            return self.handlers[kind](*args)
        finally:
            self._executing = prev

    def _run_on(self, dst, handler: Callable, args: tuple):
        """:meth:`_dispatch_on` with the handler already resolved: the
        kind→handler table lookup happens once at send time, not again
        when the event fires."""
        prev = self._executing
        self._executing = dst
        try:
            return handler(*args)
        finally:
            self._executing = prev

    # -- messaging ----------------------------------------------------------
    def send(self, src, dst, msg: Message, *,
             send_time: float | None = None) -> None:
        kind = msg.kind
        if src is not dst:   # same-core sends are not wire messages
            rec = self.msg_kinds.get(kind)   # _note_msg, inlined
            if rec is None:
                rec = self.msg_kinds[kind] = [0, 0]
            rec[0] += 1
            rec[1] += msg.payload_bytes
        self.hier.send(src, dst, msg.cost, self._run_on, dst,
                       self.handlers[kind], msg.args,
                       send_time=send_time, payload_bytes=msg.payload_bytes)

    def local(self, node, msg: Message, *,
              at_time: float | None = None) -> None:
        self.hier.local(node, msg.cost, self._run_on, node,
                        self.handlers[msg.kind], msg.args, at_time=at_time)

    def call(self, kind: str, *args):
        # the simulation convention: runtime-service mutations apply
        # synchronously at the call site; their cycle costs travel as
        # charge messages issued by the handler itself.
        return self.handlers[kind](*args)

    def update(self, dst, fn, *args) -> None:
        # uncharged bookkeeping applies synchronously (the pre-sharding
        # semantics), but inside dst's execution context so shard
        # ownership asserts see the right owner.
        prev, self._executing = self._executing, dst
        try:
            fn(*args)
        finally:
            self._executing = prev

    def timer(self, when: float, msg: Message) -> None:
        self.engine.at(when, self.handlers[msg.kind], *msg.args)

    # -- time / cores --------------------------------------------------------
    @property
    def now(self) -> float:
        return self.engine.now

    @property
    def events_processed(self) -> int:
        return self.engine.events_processed

    def occupy(self, node, arrival: float, cost: float) -> float:
        return node.core.occupy(arrival, cost)

    def next_free(self, node) -> float:
        return node.core.next_free

    def stats(self, node) -> CoreStats:
        return node.core.stats

    # -- program execution ---------------------------------------------------
    def run(self, until: float | None = None,
            max_events: int | None = None) -> None:
        # The event loop allocates short-lived tuples/messages at a rate
        # that triggers hundreds of gen-0 cycle collections per run, each
        # re-scanning the long-lived dependency graph (~10% of wall time).
        # Reference counting reclaims the acyclic event garbage just as
        # well, so pause the cyclic collector for the loop and restore it
        # after.  Purely a wall-clock optimization: virtual time, event
        # counts and all derived values are untouched.
        was_enabled = gc.isenabled()
        if was_enabled:
            gc.disable()
        try:
            self.engine.run(until=until, max_events=max_events)
        finally:
            if was_enabled:
                gc.enable()
