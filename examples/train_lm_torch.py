"""End-to-end training driver for the PyTorch/CUDA port: train a small LM
with the full stack (data pipeline -> model -> AdamW -> checkpoints ->
fault tolerance), the port's mirror of ``examples/train_lm.py``.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 300     # ~20M params, GPU
    PYTHONPATH=src python examples/train_lm_torch.py --arch qwen2_0_5b --smoke --device cpu

Any ported architecture is selectable with --arch (reduced to its smoke
config with --smoke; its full config otherwise).  Only ``--backend
loop`` (the plain training loop) is ported; the Myrmics-runtime
backends come with the runtime's port.
"""

import argparse
import os
import tempfile
from dataclasses import replace

from repro_torch.configs import get_config
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamW
from repro_torch.train.loop import FailurePlan, train


def default_20m() -> ModelConfig:
    base = get_config("qwen2_0_5b")
    return replace(
        base, arch_id="demo_20m", n_layers=4, d_model=256, n_heads=4,
        n_kv_heads=2, d_ff=1024, vocab=8192, pad_to=64,
        tie_embeddings=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--inject-failure", action="store_true",
                    help="kill a 'worker' mid-run to demo restart")
    ap.add_argument("--backend", choices=("loop", "threads", "procs"), default="loop",
                    help="loop: the plain training loop (the only one ported)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    if args.backend != "loop":
        raise NotImplementedError(
            f"--backend {args.backend} is not ported yet: ROADMAP.md Queue 1, "
            "'Slice 5: training of the dense family under the Myrmics runtime'")
    if args.arch is None:
        cfg = default_20m()
    else:
        cfg = get_config(args.arch)
        if args.smoke:
            cfg = cfg.smoke()
    print(f"arch={cfg.arch_id} ~{cfg.param_count() / 1e6:.1f}M params "
          f"steps={args.steps} seq={args.seq_len} batch={args.batch} device={args.device}")

    plan = FailurePlan(fail_at_steps=(args.steps // 2,)) \
        if args.inject_failure else None
    opt = AdamW(lr=1e-3, warmup_steps=max(args.steps // 20, 1),
                total_steps=args.steps)

    def on_step(step, loss):
        if step % 10 == 0:
            print(f"step {step:5d}  loss {loss:.4f}")

    rep = train(cfg, seq_len=args.seq_len, global_batch=args.batch,
                steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=50,
                async_ckpt=True, failure_plan=plan, opt=opt,
                on_step=on_step, device=args.device)
    if not rep.losses:
        print(f"no steps run: {args.ckpt_dir} already holds a checkpoint at "
              f"step {args.steps} or later")
        return
    print(f"done: first loss {rep.losses[0]:.4f} -> last "
          f"{rep.losses[-1]:.4f}; restarts={rep.restarts} "
          f"stragglers={rep.stragglers}")
    if rep.losses[-1] >= rep.losses[0]:
        raise SystemExit("loss did not decrease")


if __name__ == "__main__":
    main()
