"""Myrmics-scheduled distributed training orchestration: a port of
``repro.train.orchestrator``.

This is the paper's runtime applied at *cluster* scale: worker cores of
the core runtime model worker DOMAINS (pods / hosts); regions model the
persistent state each domain owns (its DP shard of optimizer state);
tasks model per-step work items (microbatch grad computation, gradient
reduction, parameter update).  The hierarchical schedulers place
microbatch tasks with the locality/load-balance score — producer-
consumer DMA accounting then *measures* how much gradient/parameter
traffic a placement policy causes, which is the paper's Fig. 11
experiment re-run on a training workload.

``run_training_schedule`` and ``locality_sweep`` schedule virtual work
and are the JAX module's, line for line, on the port's copy of the
runtime (``repro_torch.core``).  ``run_myrmics_training`` schedules the
same task DAG as the JAX function; its gradient tasks run the port's
loss and gradients (``train.steps._value_and_grad``) on the model's
device, and its update task the port's AdamW.  ``backend="procs"``
raises in the runtime: it is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.core import In, InOut, Myrmics, Out, Safe, task
from repro_torch.core.payload import burn
from repro_torch.core.sim import CostModel
from repro_torch.data import TokenDataset
from repro_torch.models.transformer import LM
from repro_torch.optim import AdamW
from repro_torch.train.loop import TrainReport
from repro_torch.train.steps import _value_and_grad
from repro_torch.tree import leaves, tree_map


@dataclass
class StepStats:
    cycles: float = 0.0
    dma_bytes: int = 0
    msgs: int = 0
    backups: int = 0


@dataclass
class OrchestratorConfig:
    n_domains: int = 16
    sched_levels: tuple[int, ...] = (1, 4)
    microbatches_per_domain: int = 2
    grad_bytes: int = 1 << 20          # per-microbatch gradient size
    compute_cycles: float = 2e6        # per microbatch
    steps: int = 4
    policy_p: int = 20                 # locality bias (paper Fig. 11)
    straggler_factor: float = 3.0
    slow_domains: dict = field(default_factory=dict)  # worker idx -> slowdown
    kill_at: tuple = ()                # (step, worker_idx) pairs
    join_at: dict = field(default_factory=dict)       # step -> extra domains
    backend: str = "sim"               # "sim" (virtual) | "threads" (real)


def run_training_schedule(cfg: OrchestratorConfig) -> list[StepStats]:
    """Run ``steps`` optimizer steps scheduled by the Myrmics runtime;
    returns per-step stats.  On ``cfg.backend="sim"`` compute is
    virtual cycles (deterministic scaling studies); on ``"threads"``
    each microbatch burns real GIL-releasing compute on the concurrent
    executor and the stats are wall-clock measurements."""
    rt = Myrmics(n_workers=cfg.n_domains,
                 sched_levels=list(cfg.sched_levels),
                 cost=CostModel.heterogeneous(),
                 policy_p=cfg.policy_p,
                 backend=cfg.backend)
    stats: list[StepStats] = []

    n_micro = cfg.n_domains * cfg.microbatches_per_domain
    slow = dict(cfg.slow_domains)
    real = cfg.backend == "threads"

    @task
    def micro_task(ctx, g: Out, mb_idx: Safe):
        factor = slow.get(int(ctx.worker_id[1:]), 1.0)
        ctx.compute(cfg.compute_cycles * factor)
        if real:
            burn(cfg.compute_cycles * factor)
        g.write(("grad", mb_idx))

    @task
    def reduce_task(ctx, region: In, out: InOut, g_oids: Safe):
        ctx.compute(cfg.compute_cycles * 0.1)
        vals = [g.read() for g in g_oids]  # lint: allow(safe-ref-access: covered by region: In)
        out.write(("reduced", len(vals)))

    def main(ctx, root):
        for step in range(cfg.steps):
            step_r = ctx.ralloc(root, 1, label=f"step{step}")
            g_oids = ctx.balloc(cfg.grad_bytes, step_r, n_micro,
                                label=f"g{step}")
            for i, g in enumerate(g_oids):
                ctx.spawn(micro_task, g, i, name=f"micro{step}.{i}")
            out = ctx.alloc(64, root, label=f"upd{step}")
            ctx.spawn(reduce_task, step_r, out, list(g_oids),
                      name=f"reduce{step}")
            yield ctx.wait([InOut(root)])
            ctx.rfree(step_r)

    rep = rt.run(main)
    total = rep.total_cycles
    per_step = total / cfg.steps
    dma = sum(w.dma_bytes for w in rep.workers.values())
    msgs = sum(w.msgs_sent for w in rep.workers.values()) + sum(
        s.msgs_sent for s in rep.scheds.values())
    for s in range(cfg.steps):
        stats.append(StepStats(cycles=per_step, dma_bytes=dma // cfg.steps,
                               msgs=msgs // cfg.steps))
    return stats


def run_myrmics_training(model_cfg, *, seq_len: int = 64,
                         global_batch: int = 8, steps: int = 10,
                         n_shards: int = 2, seed: int = 0, opt=None,
                         on_step=None, backend: str = "threads",
                         device: str | torch.device | None = None):
    """Data-parallel LM training *executed by the Myrmics runtime*.

    Each optimizer step is a task DAG: ``n_shards`` gradient tasks
    (each running the port's loss and gradients on its microbatch slice
    against the parameters in the object store, on ``device``), then an
    update task that averages the shard gradients and applies AdamW —
    dependencies derived from the ``@task`` signatures, exactly like
    every other Myrmics program.  On ``backend="threads"`` the gradient
    tasks run concurrently on the worker pool; their kernels share the
    device's current stream.  ``backend="sim"`` runs the same DAG
    deterministically.  ``device``: None means the GPU (and raises
    without CUDA); the CPU only when asked for.

    Returns ``(TrainReport, RunReport)``.
    """
    if global_batch % n_shards:
        raise ValueError(f"global_batch={global_batch} not divisible by "
                         f"n_shards={n_shards}")
    lm = LM(model_cfg, device)
    opt = opt or AdamW(lr=1e-3, warmup_steps=max(steps // 10, 1),
                       total_steps=steps)
    data = TokenDataset(model_cfg, seq_len, global_batch, seed)

    params0 = lm.init(seed)
    opt0 = opt.init(params0)
    param_bytes = int(sum(x.numel() * x.element_size() for x in leaves(params0)))
    per_shard = global_batch // n_shards
    report = TrainReport()

    @task
    def grad_shard(ctx, g: Out, loss_o: Out, p: In, batch: Safe):
        b = {k: torch.from_numpy(v).to(lm.device) for k, v in batch.items()}
        loss, grads = _value_and_grad(lm, p.read(), b, remat=True)
        g.write(grads)
        loss_o.write(float(loss))

    @task
    def apply_update(ctx, p: InOut, o: InOut, step_r: In, gs: Safe):
        grads = [g.read() for g in gs]  # lint: allow(safe-ref-access: covered by step_r: In)
        avg = tree_map(lambda *x: sum(x) / len(x), *grads)
        params, opt_state, _ = opt.update(avg, o.read(), p.read())
        p.write(params)
        o.write(opt_state)

    def main(ctx, root):
        nonlocal params0, opt0
        p_obj = ctx.alloc(param_bytes, root, label="params")
        o_obj = ctx.alloc(param_bytes, root, label="opt")
        ctx.write(p_obj, params0)
        ctx.write(o_obj, opt0)
        # the object store holds them now: held here too, the first
        # step's parameters and moments would stay on the device all run
        params0 = opt0 = None
        for step in range(steps):
            step_r = ctx.ralloc(root, 1, label=f"step{step}")
            gs = ctx.balloc(param_bytes, step_r, n_shards,
                            label=f"g{step}")
            ls = ctx.balloc(8, root, n_shards, label=f"l{step}")
            batch = data.get_batch(step)
            for i in range(n_shards):
                shard = {k: v[i * per_shard:(i + 1) * per_shard]
                         for k, v in batch.items()}
                ctx.spawn(grad_shard, gs[i], ls[i], p_obj, shard,
                          name=f"grad{step}.{i}")
            ctx.spawn(apply_update, p_obj, o_obj, step_r, list(gs),
                      name=f"upd{step}")
            yield ctx.wait([InOut(root)])
            losses = [ctx.read(lo) for lo in ls]
            report.losses.append(sum(losses) / len(losses))
            report.steps_run += 1
            if on_step is not None:
                on_step(step, report.losses[-1])
            ctx.rfree(step_r)

    rt = Myrmics(n_workers=n_shards, sched_levels=[1], backend=backend)
    run_rep = rt.run(main)
    return report, run_rep


def locality_sweep(policy_points=(100, 80, 60, 40, 20, 0), **kw):
    """Paper Fig. 11 on the training workload: policy bias vs cycles
    and DMA traffic."""
    out = {}
    for p in policy_points:
        cfg = OrchestratorConfig(policy_p=p, **kw)
        st = run_training_schedule(cfg)
        out[p] = {
            "cycles_per_step": sum(s.cycles for s in st) / len(st),
            "dma_per_step": sum(s.dma_bytes for s in st) / len(st),
        }
    return out
