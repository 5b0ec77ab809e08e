"""Training launcher: the fault-tolerant loop on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_0_5b --full-config

Runs on the GPU unless ``--device cpu`` is given; without CUDA it
raises.  Without ``--full-config`` the architecture's smoke config is
trained.  A full-width checkpoint (bf16 parameters, f32 moments) holds
about 5 GB; ``--ckpt-every`` sets how many are written, and a second run
into the same ``--ckpt-dir`` resumes from the latest.
"""

from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.optim import AdamW
from repro_torch.train.loop import FailurePlan, TrainReport, default_ckpt_dir, train


def main(argv: list[str] | None = None) -> TrainReport:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--full-config", action="store_true",
                    help="train the full-width config (one H100 holds qwen2_0_5b)")
    ap.add_argument("--ckpt-dir", default=default_ckpt_dir())
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--async-ckpt", action="store_true")
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = cfg.smoke()
    plan = FailurePlan(fail_at_steps=tuple(args.fail_at)) \
        if args.fail_at else None
    opt = AdamW(warmup_steps=max(args.steps // 10, 1),
                total_steps=args.steps)
    rep = train(cfg, seq_len=args.seq_len, global_batch=args.batch,
                steps=args.steps, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, async_ckpt=args.async_ckpt,
                failure_plan=plan, opt=opt, device=args.device,
                on_step=lambda s, l: print(f"step {s} loss {l:.4f}"))
    if rep.losses:
        print(f"losses: {rep.losses[0]:.4f} -> {rep.losses[-1]:.4f} "
              f"restarts={rep.restarts}")
    else:
        print(f"no steps run: {args.ckpt_dir} already holds a checkpoint at "
              f"step {args.steps} or later")
    return rep


if __name__ == "__main__":
    main()
