"""Discrete-event simulation engine + paper-calibrated cost model.

The Myrmics paper evaluates on a 520-core message-passing prototype
(8 ARM Cortex-A9 scheduler cores + 512 MicroBlaze worker cores).  This
container is CPU-only, so the scalability experiments run in *virtual
time*: every message, DMA and runtime function charges cycles on the
core that performs it, using constants calibrated to the paper's
measurements (Fig. 7a):

  * heterogeneous (Cortex scheduler / MicroBlaze worker):
      spawn(1-arg empty task) ~ 16.2 K cycles, execute ~ 13.3 K cycles
  * homogeneous MicroBlaze scheduler: spawn ~ 37.4 K cycles

The ``Engine``/``Core``/``CostModel`` here are the internals of the
virtual-time substrate (:class:`~.substrate.SimSubstrate`): task bodies
— whether ``duration=`` placeholders or real Python callables — execute
*synchronously inside the single-threaded event loop*, so this backend
measures schedules, not throughput.  For actually-parallel execution of
real Python/JAX task bodies, construct ``Myrmics(backend="threads")``
(:mod:`~.backend_threads`), which runs the identical agent logic over a
wall-clock substrate.
"""

from __future__ import annotations

import dataclasses
import heapq
from dataclasses import dataclass
from typing import Any, Callable


class Engine:
    """Minimal deterministic discrete-event engine (virtual cycles).

    Events live on the heap as plain ``(time, seq, fn, args)`` tuples:
    the unique, monotonically increasing ``seq`` both enforces FIFO
    ordering among same-timestamp events and guarantees tuple
    comparison never reaches the (non-orderable) callable, so every
    heap sift runs at C speed with no Python ``__lt__`` calls."""

    def __init__(self) -> None:
        self._q: list[tuple[float, int, Callable, tuple]] = []
        self._seq = 0
        self.now: float = 0.0
        self.events_processed = 0

    def at(self, time: float, fn: Callable, *args: Any) -> None:
        now = self.now
        self._seq = seq = self._seq + 1
        heapq.heappush(self._q, (time if time > now else now, seq, fn, args))

    def after(self, delay: float, fn: Callable, *args: Any) -> None:
        self.at(self.now + delay, fn, *args)

    def run(self, until: float | None = None, max_events: int | None = None) -> None:
        q = self._q
        pop = heapq.heappop
        if until is None and max_events is None:
            # hot path: no bound checks, locals bound outside the loop.
            while q:
                time, _seq, fn, args = pop(q)
                self.now = time
                self.events_processed += 1
                fn(*args)
            return
        while q:
            if max_events is not None and self.events_processed >= max_events:
                raise RuntimeError(
                    f"simulation exceeded {max_events} events (possible livelock)"
                )
            # peek instead of pop+push-back: pausing at ``until`` leaves
            # the heap untouched (no re-heapify on resume).
            time = q[0][0]
            if until is not None and time > until:
                return
            time, _seq, fn, args = pop(q)
            self.now = time
            self.events_processed += 1
            fn(*args)

    @property
    def pending(self) -> int:
        return len(self._q)


@dataclass(frozen=True)
class CostModel:
    """Per-operation virtual-cycle costs.

    Scheduler-side costs are *effective* cycles (already reflecting the
    scheduler core's speed); worker-side costs are MicroBlaze cycles.
    Calibration targets and the fit are documented in EXPERIMENTS.md.
    """

    name: str = "heterogeneous"

    # --- network (paper SIII: round trip 38..131 cycles, msgs processed
    #     back-to-back in 450..750 cycles) ---
    msg_base_latency: float = 20.0     # one-way, nearest
    msg_hop_latency: float = 8.0       # extra per hierarchy hop
    msg_proc: float = 650.0            # generic forward/route processing

    # --- worker-side runtime calls ---
    worker_spawn_call: float = 8000.0
    worker_dispatch_recv: float = 3000.0
    worker_complete_send: float = 2100.0
    worker_wait_call: float = 1500.0
    worker_alloc_call: float = 900.0

    # --- scheduler-side processing ---
    spawn_proc: float = 6600.0         # spawn request bookkeeping
    dep_enqueue_per_arg: float = 1500.0
    traverse_hop: float = 650.0        # per region-tree hop during traversal
    schedule_base: float = 3200.0      # ready-task scheduling decision
    pack_per_arg: float = 800.0        # packing one argument
    dispatch_proc: float = 1200.0
    complete_proc_base: float = 1300.0
    complete_per_arg: float = 500.0
    arg_ready_proc: float = 400.0
    quiesce_proc: float = 650.0
    load_report_proc: float = 650.0
    ralloc_proc: float = 2500.0
    alloc_proc: float = 1200.0
    balloc_per_obj: float = 150.0
    free_proc: float = 900.0
    # --- sharded directory (SV-C): forwarded lookups + ownership migration ---
    shard_lookup_proc: float = 650.0   # answer a cross-shard metadata read
    migrate_proc: float = 2500.0       # migration request/grant bookkeeping
    migrate_per_node: float = 150.0    # per directory node handed over
    # --- work stealing (worker-tier load redistribution) ---
    steal_proc: float = 650.0          # steal request match/relay/grant

    # --- DMA engine (paper SIII: a DMA can be started in 24 cycles) ---
    dma_startup: float = 24.0
    dma_bytes_per_cycle: float = 8.0

    #: Fields NOT scaled by :meth:`microblaze`: wire latencies, costs
    #: paid on the (already-MicroBlaze) worker cores, and the DMA
    #: engine.  Every *other* field is scheduler-side processing and is
    #: scaled programmatically — a newly added scheduler cost cannot
    #: silently skip the homogeneous-system factor.
    WORKER_SIDE_FIELDS = frozenset({
        "name",
        "msg_base_latency", "msg_hop_latency",
        "worker_spawn_call", "worker_dispatch_recv",
        "worker_complete_send", "worker_wait_call", "worker_alloc_call",
        "dma_startup", "dma_bytes_per_cycle",
    })

    def batch_cost(self, per_item_cost: float, n_items: int) -> float:
        """Destination charge of one coalesced control-plane batch.

        The paper (SIII) processes back-to-back messages at a fixed
        per-packet rate, so a batch charges ``msg_proc`` once per
        64-byte packet of items (the transport share), plus each item's
        *work increment*: its legacy per-message charge net of the
        message-processing share it no longer pays.  A batch is
        therefore never dearer at the destination than the per-arg
        message stream it replaces."""
        return self.batch_cost_mixed((per_item_cost,) * n_items)

    def batch_cost_mixed(self, per_item_costs) -> float:
        """:meth:`batch_cost` for a batch whose items carry different
        legacy charges (e.g. traverse hops mixed with arg enqueues)."""
        mp = self.msg_proc
        n = 0
        extra = 0.0
        # same arithmetic as summing max(0.0, c - mp) in order: adding
        # an exact 0.0 term never changes a float sum, so skipping the
        # clamped-to-zero items is byte-identical.
        for c in per_item_costs:
            n += 1
            if c > mp:
                extra += c - mp
        return mp * batch_packets(n) + extra

    @staticmethod
    def heterogeneous() -> "CostModel":
        """Cortex-A9 schedulers + MicroBlaze workers (the default)."""
        return CostModel(name="heterogeneous")

    @staticmethod
    def microblaze() -> "CostModel":
        """MicroBlaze-only system: every scheduler-side cost scaled so
        that the single-arg spawn microbenchmark reproduces the paper's
        37.4 K cycles (Fig. 7a / Fig. 12a)."""
        f = 3.617  # (37.4K - worker-side spawn path) / (16.2K - same)
        h = CostModel.heterogeneous()
        scaled = {
            fld.name: getattr(h, fld.name) * f
            for fld in dataclasses.fields(h)
            if fld.name not in CostModel.WORKER_SIDE_FIELDS
        }
        return dataclasses.replace(h, name="microblaze", **scaled)


@dataclass
class CoreStats:
    """Per-core accounting used by the breakdown / traffic figures and
    the per-scheduler occupancy/queue-delay summary (sched_scaling)."""

    busy_cycles: float = 0.0
    task_cycles: float = 0.0          # workers: cycles inside task bodies
    idle_wait_dma: float = 0.0
    msgs_sent: int = 0
    msg_bytes_sent: int = 0
    dma_bytes: int = 0
    tasks_executed: int = 0
    events: int = 0
    #: messages/work items that waited for this core, and the total time
    #: they spent queued before processing started (sim: virtual cycles,
    #: threads: wall seconds spent in the scheduler mailbox).
    msgs_handled: int = 0
    queue_delay_cycles: float = 0.0


class Core:
    """A simulated core: serially processes work items (messages, task
    executions).  ``next_free`` models the core being busy."""

    def __init__(self, engine: Engine, core_id: str):
        self.engine = engine
        self.core_id = core_id
        self.next_free: float = 0.0
        self.stats = CoreStats()

    def occupy(self, arrival: float, cost: float) -> float:
        """Reserve the core for ``cost`` cycles starting no earlier than
        ``arrival``; returns the completion time."""
        nf = self.next_free
        start = arrival if arrival > nf else nf
        end = start + cost
        self.next_free = end
        stats = self.stats
        stats.busy_cycles += cost
        stats.events += 1
        stats.msgs_handled += 1
        stats.queue_delay_cycles += start - arrival
        return end

    def exec_at(self, arrival: float, cost: float, fn: Callable, *args: Any) -> float:
        """Process a work item: occupy the core, then run the handler at
        the completion time.  Returns completion time."""
        end = self.occupy(arrival, cost)
        self.engine.at(end, fn, *args)
        return end


MESSAGE_SIZE = 64  # bytes; paper SV-B: fixed 64-byte messages (1 cache line)

#: Batch entries per 64-byte packet: one coalesced item (node id + task
#: id + mode/kind bits, or a quiesce counter pair) fits in 16 bytes, so
#: four ride in one cache-line message; longer batches span packets.
BATCH_ENTRIES_PER_MSG = 4


def batch_packets(n_items: int) -> int:
    """Packets a coalesced batch occupies: ceil(items/entries-per-packet),
    at least one.  Single source of the packetization used by both the
    charging rule (``CostModel.batch_cost``) and the wire size below —
    the two must never disagree."""
    return max(1, -(-n_items // BATCH_ENTRIES_PER_MSG))


def batch_payload_bytes(n_items: int) -> int:
    """Wire size of a coalesced batch: whole fixed-size packets."""
    return batch_packets(n_items) * MESSAGE_SIZE
