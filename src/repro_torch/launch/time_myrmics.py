"""Warm step ms of full-width qwen2-0.5B training (bf16, 4 × 512 tokens,
``chip_smoke.py``'s train shape) three ways in one process: the plain loop,
and under the Myrmics runtime (threads backend) with the batch in 1 and in
2 gradient tasks a step.  The 1-task run does the loop's work under the
runtime, so its step over the loop's is the runtime's own cost on one card.

    PYTHONPATH=src python -m repro_torch.launch.time_myrmics --rounds 3

The three runs alternate within each round, so the host clock's drift
falls on all three alike.  Prints the card's name and power limit and one
JSON line.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time

import torch

from repro_torch.configs import get_config
from repro_torch.train.loop import train
from repro_torch.train.orchestrator import run_myrmics_training

ARCH, SEQ, BATCH = "qwen2_0_5b", 512, 4


def warm_step_ms(run) -> list[float]:
    """Host ms between consecutive ``on_step`` calls of ``run(on_step)``:
    steps 1.. (step 0 holds the first use of every kernel)."""
    stamps = []
    run(lambda step, loss: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    return [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]


def loop_run(cfg, common, on_step) -> None:
    """The plain loop, checkpointing once after its last step (after the
    last ``on_step``), as ``chip_smoke.py``'s train phase does."""
    with tempfile.TemporaryDirectory(prefix="time_myrmics_ckpt_") as ckpt:
        train(cfg, **common, ckpt_dir=ckpt, ckpt_every=common["steps"], device="cuda",
              on_step=on_step)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs CUDA")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    cfg = get_config(ARCH)
    common = dict(seq_len=SEQ, global_batch=BATCH, steps=args.steps, seed=0)
    runs = {
        "loop": lambda cb: loop_run(cfg, common, cb),
        "runtime_1_task": lambda cb: run_myrmics_training(
            cfg, **common, n_shards=1, backend="threads", device="cuda", on_step=cb),
        "runtime_2_tasks": lambda cb: run_myrmics_training(
            cfg, **common, n_shards=2, backend="threads", device="cuda", on_step=cb),
    }
    step_ms = {name: [] for name in runs}
    for _ in range(args.rounds):
        for name, run in runs.items():
            step_ms[name].append(warm_step_ms(run))
    means = {name: [sum(r) / len(r) for r in rounds] for name, rounds in step_ms.items()}
    print(json.dumps({
        "arch": ARCH, "dtype": cfg.param_dtype, "seq_len": SEQ, "global_batch": BATCH,
        "steps": args.steps, "step_ms": step_ms, "mean_step_ms": means,
        "over_loop": {name: [m / l for m, l in zip(ms, means["loop"])]
                      for name, ms in means.items() if name != "loop"}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
