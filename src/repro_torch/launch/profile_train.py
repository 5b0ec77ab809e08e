"""Where a train step's time goes on the GPU: one step under
``torch.profiler``, device time by kernel and the device's idle share.

    PYTHONPATH=src python -m repro_torch.launch.profile_train --full-config

Runs the step the training loop runs (``make_train_step``: forward with
per-layer remat, chunked loss, backward, AdamW) on random weights from a
seed, once to warm up and once under the profiler, and prints one JSON
line: the step's host-clock ms, the device's busy ms (the sum of kernel
and copy times; one stream, so they do not overlap) and idle share, and
the device ms of each group of kernels and of the top kernels by name.
Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data import TokenDataset
from repro_torch.models.transformer import LM
from repro_torch.optim import AdamW
from repro_torch.train.steps import make_train_step

# kernel-name fragments -> group, first match wins
GROUPS = (("flash_bwd", "attention backward (ours)"),
          ("bwd_", "attention backward (ours)"),
          ("flash_fwd", "attention forward (ours)"),
          ("gemm", "matmul (cuBLAS)"), ("nvjet", "matmul (cuBLAS)"),
          ("sm90_", "matmul (cuBLAS)"),
          ("cutlass", "matmul (cuBLAS)"), ("Memcpy", "copies"), ("Memset", "copies"))


def _group(name: str) -> str:
    return next((g for frag, g in GROUPS if frag in name), "other (elementwise, reductions)")


def profile_step(arch: str, full: bool, seq_len: int, batch: int, seed: int = 0) -> dict:
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config(arch)
    if not full:
        cfg = cfg.smoke()
    lm = LM(cfg)
    opt = AdamW(warmup_steps=1, total_steps=10)
    params = lm.init(seed)
    state = opt.init(params)
    step = make_train_step(lm, opt)
    data = {k: torch.from_numpy(v).to(lm.device)
            for k, v in TokenDataset(cfg, seq_len, batch, seed).get_batch(0).items()}
    params, state, metrics = step(params, state, data)          # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, data)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    device_events = [ev for ev in prof.events()
                     if ev.device_type == torch.autograd.DeviceType.CUDA]
    kernels: dict[str, float] = {}
    for ev in device_events:
        kernels[ev.name] = kernels.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
    busy_ms = sum(kernels.values())
    groups: dict[str, float] = {}
    for name, ms in kernels.items():
        groups[_group(name)] = groups.get(_group(name), 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    return {"arch": arch, "full_config": full, "n_layers": cfg.n_layers, "seq_len": seq_len,
            "global_batch": batch, "dtype": cfg.param_dtype, "nvidia_smi": card,
            "loss": loss, "step_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms, "groups_ms": groups,
            "top_kernels_ms": top, "n_device_events": len(device_events)}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_0_5b")
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the profile is of the GPU")
    print(json.dumps(profile_step(args.arch, args.full_config, args.seq_len, args.batch)))


if __name__ == "__main__":
    main()
