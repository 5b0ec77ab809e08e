"""Chrome-trace export + per-scheduler summaries for the Myrmics runtime.

Records per-core busy intervals (task execution, scheduler processing,
DMA transfers) during a run and writes the Chrome tracing JSON format —
load in chrome://tracing or Perfetto to see the schedule: worker lanes,
scheduler lanes, DMA overlap, straggler backups, failures.

    rt = Myrmics(...)
    tracer = attach_tracer(rt)
    rt.run(main)
    tracer.write("trace.json")

:func:`sched_summary` renders a run's per-scheduler decentralization
stats (messages handled, mailbox queue delay, occupancy) as rows — the
data the ``sched_scaling`` benchmark row sweeps over scheduler counts.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field


@dataclass
class Tracer:
    events: list = field(default_factory=list)
    _pids: dict = field(default_factory=dict)

    def _pid(self, core_id: str) -> int:
        kind = 0 if core_id.startswith("w") else 1
        return kind

    def add(self, core_id: str, name: str, start: float, dur: float,
            cat: str = "work", args: dict | None = None) -> None:
        if dur <= 0:
            return
        self.events.append({
            "name": name, "cat": cat, "ph": "X",
            "ts": start, "dur": dur,
            "pid": self._pid(core_id), "tid": core_id,
            "args": args or {},
        })

    def write(self, path: str) -> None:
        doc = {
            "traceEvents": self.events,
            "displayTimeUnit": "ns",
            "metadata": {"unit": "virtual cycles (as us)"},
        }
        with open(path, "w") as f:
            json.dump(doc, f)


def sched_summary(report, ndigits: int = 6) -> list[dict]:
    """Per-scheduler stat rows for a :class:`~.api.RunReport`, in
    deterministic core-id order: messages handled, total and mean
    mailbox queue delay, and occupancy (busy fraction of the run).
    Works for both backends — virtual cycles on ``sim``, wall seconds
    on ``threads``."""
    return [
        {
            "sched": core_id,
            "msgs_handled": s["msgs_handled"],
            "queue_delay": round(s["queue_delay"], ndigits),
            "mean_queue_delay": round(s["mean_queue_delay"], ndigits),
            "occupancy": round(s["occupancy"], ndigits),
        }
        for core_id, s in sorted(report.sched_summary().items())
    ]


def msg_summary(report, top: int | None = None) -> list[dict]:
    """Per-kind wire-message rows for a :class:`~.api.RunReport`, most
    frequent first: kind, count, bytes, and the count per completed
    task.  Works for both backends (sim counts cross-core sends,
    threads counts every send).  This is how the >=2x message reduction
    of coalescing is read off a report instead of by hand-instrumenting
    the substrate."""
    tasks = report.tasks_done or 1
    rows = [
        {
            "kind": kind,
            "count": rec["count"],
            "bytes": rec["bytes"],
            "per_task": round(rec["count"] / tasks, 3),
        }
        for kind, rec in sorted(report.msg_kinds.items(),
                                key=lambda kv: (-kv[1]["count"], kv[0]))
    ]
    return rows[:top] if top is not None else rows


def steal_summary(report, ndigits: int = 6) -> dict:
    """Work-stealing rollup for a :class:`~.api.RunReport`: requests
    attempted/granted, tasks and packed bytes re-homed, and the
    per-worker occupancy coefficient of variation (rounded) — the
    redistribution quantities the ``skewed_dag`` benchmark row tracks.
    All counters are zero for a ``steal=False`` run."""
    s = report.steal_summary()
    s["occupancy_cv"] = round(s["occupancy_cv"], ndigits)
    return s


def sanitize_summary(report, ndigits: int = 3) -> dict:
    """Dynamic-sanitizer rollup for a :class:`~.api.RunReport`:
    whether the sanitizer was armed, accesses validated, violations
    counted, and the (rounded) checks-per-task rate.  All-zero for the
    default ``sanitize=False`` run."""
    s = report.sanitize_summary()
    s["checks_per_task"] = round(s["checks_per_task"], ndigits)
    return s


def attach_tracer(rt) -> Tracer:
    """Instrument a Myrmics runtime instance (monkey-patch the two
    choke points: worker-agent task completion and core occupancy)."""
    tracer = Tracer()

    wa = rt.worker_agent
    orig_finish = wa.finish_exec

    def finish_exec(w, rec):
        t = rec.task
        tracer.add(w.core_id, t.name, rec.start, rec.ctx.cursor,
                   cat="task", args={"tid": t.tid})
        return orig_finish(w, rec)

    wa.finish_exec = finish_exec

    # wrap every core's occupy for scheduler/message lanes
    def make(orig, cid):
        def occupy(arrival, cost):
            end = orig(arrival, cost)
            tracer.add(cid, "sched", end - cost, cost, cat="runtime")
            return end
        return occupy

    for s in rt.hier.scheds:
        s.core.occupy = make(s.core.occupy, s.core_id)
    return tracer
