"""Batched serving demo for the PyTorch/CUDA port: submit a queue of
requests, decode with the continuous-batching engine, print per-request
generations; the port's mirror of ``examples/serve_lm.py``.

    PYTHONPATH=src python examples/serve_lm_torch.py --arch qwen2_0_5b
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
"""

import argparse
import time

from repro_torch.configs import get_config
from repro_torch.serving import Request, ServingEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_0_5b")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch).smoke()
    eng = ServingEngine(cfg, max_batch=args.max_batch, max_len=64,
                        prompt_len=8, device=args.device)
    reqs = [
        Request(rid=i, prompt=[1 + i, 2, 3, 4, 5, 6, 7, 8],
                max_new_tokens=args.max_new_tokens)
        for i in range(args.requests)
    ]
    for r in reqs:
        eng.submit(r)
    t0 = time.time()
    stats = eng.run()
    dt = time.time() - t0
    print(f"stats: {stats} in {dt:.1f}s")
    for r in reqs[:5]:
        print(f"req {r.rid}: {r.out_tokens}")
    toks = stats["decode_steps"] * args.max_batch
    print(f"~{toks / dt:.1f} batched tokens/s on {args.device} (smoke config)")
    if stats["completed"] != args.requests:
        raise SystemExit(f"completed {stats['completed']} of {args.requests}")


if __name__ == "__main__":
    main()
