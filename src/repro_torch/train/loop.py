"""Fault-tolerant training loop: a port of ``repro.train.loop``.

Step-level checkpointing (sync or async), restart from the latest
checkpoint on an injected or real worker failure, deterministic data
resume, and the straggler watchdog (per-step service-time EWMA; a step
over ``straggler_factor`` x EWMA is counted).  Runs on the GPU unless
``device="cpu"`` is given.  ``LM.init`` draws from a ``torch.Generator``,
so a seed gives other initial weights than the JAX loop's.
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.data import TokenDataset
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import LM
from repro_torch.optim import AdamW
from repro_torch.train.steps import make_train_step


class WorkerFailure(RuntimeError):
    """Simulated (or surfaced) loss of a worker domain."""


@dataclass
class FailurePlan:
    """Deterministic failure injection for tests/examples."""

    fail_at_steps: tuple[int, ...] = ()
    _tripped: set = field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self._tripped:
            self._tripped.add(step)
            raise WorkerFailure(f"injected failure at step {step}")


@dataclass
class TrainReport:
    losses: list = field(default_factory=list)
    restarts: int = 0
    stragglers: int = 0
    steps_run: int = 0


def default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


def train(cfg: ModelConfig, *, seq_len: int = 32, global_batch: int = 4,
          steps: int = 20, ckpt_dir: str | None = None,
          ckpt_every: int = 5, async_ckpt: bool = False,
          failure_plan: FailurePlan | None = None,
          straggler_factor: float = 3.0, seed: int = 0,
          opt: AdamW | None = None,
          on_step: Callable | None = None,
          device: str | torch.device | None = None) -> TrainReport:
    """``device``: None means the GPU (and raises without CUDA); the CPU
    only when asked for.  ``ckpt_dir`` defaults to ``default_ckpt_dir()``."""
    lm = LM(cfg, device)
    opt = opt or AdamW(warmup_steps=5, total_steps=steps)
    data = TokenDataset(cfg, seq_len, global_batch, seed)
    store = CheckpointStore(ckpt_dir or default_ckpt_dir())
    step_fn = make_train_step(lm, opt)
    report = TrainReport()

    def fresh_state():
        params = lm.init(seed)
        return params, opt.init(params)

    def to_device(batch: dict) -> dict:
        return {k: torch.from_numpy(v).to(lm.device) for k, v in batch.items()}

    params, opt_state = fresh_state()
    start = 0
    latest = store.latest_step()
    if latest is not None:
        restored = store.restore(latest, {"params": params, "opt": opt_state})
        params, opt_state = restored["params"], restored["opt"]
        start = latest

    step = start
    ewma = None
    while step < steps:
        try:
            batch = to_device(data.get_batch(step))
            t0 = time.perf_counter()
            if failure_plan is not None:
                failure_plan.check(step)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])          # waits for the step's kernels
            dt = time.perf_counter() - t0
            if ewma is None:
                ewma = dt
            else:
                if dt > straggler_factor * ewma:
                    report.stragglers += 1
                ewma = 0.9 * ewma + 0.1 * dt
            report.losses.append(loss)
            report.steps_run += 1
            if on_step is not None:
                on_step(step, loss)
            step += 1
            if step % ckpt_every == 0 or step == steps:
                state = {"params": params, "opt": opt_state}
                if async_ckpt:
                    store.save_async(step, state, extra=data.state(step))
                else:
                    store.save(step, state, extra=data.state(step))
        except WorkerFailure:
            # restart-from-latest: restore params/opt/data position
            report.restarts += 1
            store.wait()
            latest = store.latest_step()
            if latest is None:
                params, opt_state = fresh_state()
                step = 0
            else:
                like = {"params": params, "opt": opt_state}
                restored = store.restore(latest, like)
                params, opt_state = restored["params"], restored["opt"]
                step = latest
    store.wait()
    return report
