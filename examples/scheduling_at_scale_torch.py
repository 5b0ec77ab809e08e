"""The port's twin of ``examples/scheduling_at_scale.py``, on ``repro_torch.core``
(the same program, the same output).

The paper's scalability story on the training workload: schedule a
data-parallel step DAG through the hierarchical Myrmics runtime at 512
worker domains, with straggler backups, a killed domain, and SV-C
region-ownership migration evening out the sharded directory.

Tasks are written against the declarative API: access annotations on
the ``@task`` signature; spawns pass handles positionally.

    PYTHONPATH=src python examples/scheduling_at_scale_torch.py
"""

from repro_torch.core import In, InOut, Myrmics, Out, Safe, task
from repro_torch.train.orchestrator import locality_sweep


def step_dag(n_micro: int, grad_bytes: int = 1 << 20,
             compute: float = 3e5):
    @task
    def micro(ctx, g: Out, i: Safe):
        ctx.compute(compute)
        g.write(("grad", i))

    @task
    def reduce(ctx, region: In, out: InOut, gs: Safe):
        ctx.compute(compute / 10)
        out.write(sum(1 for g in gs if g.read() is not None))  # lint: allow(safe-ref-access: covered by region: In)

    def main(ctx, root):
        for s in range(3):
            r = ctx.ralloc(root, 1, label=f"step{s}")
            gs = ctx.balloc(grad_bytes, r, n_micro, label=f"g{s}")
            for i, g in enumerate(gs):
                ctx.spawn(micro, g, i)
            out = ctx.alloc(64, root, label=f"upd{s}")
            ctx.spawn(reduce, r, out, list(gs))
            yield ctx.wait([InOut(root)])
            ctx.rfree(r)
    return main


def run(n_workers, levels, kill=None, backups=False):
    rt = Myrmics(n_workers=n_workers, sched_levels=levels)
    if backups:
        rt.backup_factor = 3.0
    if kill is not None:
        rt.kill_worker(kill, at=4e6)
    rep = rt.run(step_dag(n_micro=4 * n_workers))
    busy = [s.busy_cycles / rep.total_cycles
            for s in rep.scheds.values()]
    return rep, max(busy)


if __name__ == "__main__":
    print("=== flat (1 scheduler) vs hierarchical, 512 worker domains ===")
    for label, levels in (("flat  [1]", [1]), ("hier  [1,7]", [1, 7]),
                          ("deep  [1,7,49]", [1, 7, 49])):
        rep, max_busy = run(512, levels)
        print(f"{label:16s} cycles={rep.total_cycles:12.0f} "
              f"max_sched_busy={max_busy:.2f}")

    print("=== fault tolerance: kill w17 mid-step (128 domains) ===")
    rep, _ = run(128, [1, 7], kill="w17", backups=True)
    print(f"tasks {rep.tasks_done}/{rep.tasks_spawned} completed "
          f"despite the failure")

    print("=== locality vs load-balance policy (paper Fig. 11) ===")
    for p, v in locality_sweep(policy_points=(100, 50, 20, 0),
                               n_domains=16, sched_levels=(1, 4),
                               steps=2).items():
        print(f"p={p:3d}  cycles/step={v['cycles_per_step']:12.0f}  "
              f"dma/step={v['dma_per_step']/1e6:8.1f} MB")

    print("=== SV-C ownership migration: sharded-directory balance ===")

    @task
    def fill(ctx, o: Out):
        """Touch one object (virtual compute)."""

    def nested_tree(ctx, root):
        # one top region anchors every group subtree, so without
        # migration a single scheduler owns the whole directory
        top = ctx.ralloc(root, 1, label="top")
        for g in range(24):
            sub = ctx.ralloc(top, 10**9, label=f"sub{g}")
            for o in ctx.balloc(256, sub, 8, label=f"x{g}"):
                ctx.spawn(fill, o, duration=5e4)
        yield ctx.wait([InOut(root)])

    for label, th in (("migration off", None), ("migration on ", 8)):
        rt = Myrmics(n_workers=64, sched_levels=[1, 4],
                     migrate_threshold=th)
        rep = rt.run(nested_tree)
        loads = [rep.region_load[s.core_id]
                 for s in rt.hier.scheds if s.parent is not None]
        print(f"{label}  region_load per scheduler={loads}  "
              f"migrations={rep.migrations}  "
              f"cycles={rep.total_cycles:.0f}")
