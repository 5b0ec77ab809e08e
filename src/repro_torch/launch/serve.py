"""Serving launcher (batched prefill + continuous-batching decode).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_0_5b -n 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon_mamba_7b --full-config

Runs on the GPU unless ``--device cpu`` is given; the smoke config
unless ``--full-config`` is given.  Exits non-zero unless every request
completes.
"""

from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.serving import Request, ServingEngine


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("-n", "--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = cfg.smoke()
    eng = ServingEngine(cfg, max_batch=args.max_batch, max_len=64,
                        prompt_len=8, device=args.device)
    reqs = [Request(rid=i, prompt=list(range(1 + i, 9 + i)),
                    max_new_tokens=args.max_new_tokens)
            for i in range(args.requests)]
    for r in reqs:
        eng.submit(r)
    stats = eng.run()
    print("stats:", stats)
    for r in reqs[:4]:
        print(f"req {r.rid}: {r.out_tokens}")
    if stats["completed"] != args.requests:
        raise SystemExit(f"completed {stats['completed']} of {args.requests} requests")


if __name__ == "__main__":
    main()
