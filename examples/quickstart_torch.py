"""The port's twin of ``examples/quickstart.py``, on ``repro_torch.core``
(the same program, the same output).

Quickstart: the Myrmics programming model in 30 lines.

A region holds objects; a ``@task`` signature declares each argument's
access (In/Out/InOut/Safe); the runtime derives the dependency
footprint from the signature, extracts all parallelism and guarantees
serial equivalence.  Inside a task, calling another task spawns it.

    PYTHONPATH=src python examples/quickstart_torch.py
"""

from repro_torch.core import In, InOut, Myrmics, Out, Safe, SerialRuntime, task


@task
def initialize(ctx, o: Out, value: Safe):
    ctx.compute(50_000)          # model 50K cycles of work
    o.write(value)


@task
def square(ctx, o: InOut):
    ctx.compute(100_000)
    o.write(o.read() ** 2)


@task
def reduce_sum(ctx, region: In, out: InOut, oids: Safe):
    out.write(sum(o.read() for o in oids))  # lint: allow(safe-ref-access: covered by region: In)


def main(ctx, root):
    data = ctx.ralloc(root, 1, label="data")           # a region handle
    oids = ctx.balloc(8, data, 16, label="x")          # 16 object handles
    result = ctx.alloc(8, root, label="sum")
    for i, o in enumerate(oids):
        initialize(o, i)                               # 16 parallel inits
    for o in oids:
        square(o)                                      # 16 parallel squares
    # depends on the WHOLE region: runs after every object settles
    reduce_sum(data, result, list(oids))
    yield ctx.wait([InOut(root)])                      # sys_wait
    print("sum of squares 0..15 =", result.read())


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", choices=("sim", "threads", "procs"),
                    default="sim",
                    help="sim: virtual time; threads: concurrent executor; "
                    "procs: one OS process per worker over wire frames")
    args = ap.parse_args()

    rt = Myrmics(n_workers=8, sched_levels=[1, 2], backend=args.backend)
    report = rt.run(main)
    unit = "virtual cycles" if args.backend == "sim" else "wall seconds"
    print(f"tasks: {report.tasks_done}, "
          f"{unit}: {report.total_cycles:.4g}")

    serial = SerialRuntime()
    serial.run(main)
    assert rt.labelled_storage() == serial.labelled_storage()
    print("parallel == serial:", rt.labelled_storage()["sum"])
