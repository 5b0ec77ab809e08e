"""Time per call of the flash-attention forward (bf16, causal) as
``chip_smoke.py`` times it, at qwen2-0.5B's serve shape (1, 256, 256, 14,
2, 64) and, with lse, its training shape (4, 512, 512, 14, 2, 64): from
Python (``eager_ms``) and on the device (``cuda_ms``), by
``chip_smoke.py``'s own timers, ``--rounds`` times each.

    PYTHONPATH=src python src/repro_torch/launch/time_forward.py

Host time per call varies between processes, so to compare two trees run
this file once per process, alternating ``PYTHONPATH`` between the trees'
``src``; the kernels come from the tree on ``PYTHONPATH``.  Prints one JSON
line.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

# the package under PYTHONPATH first: importing chip_smoke puts its own
# tree's src at the front of sys.path
from repro_torch.kernels import flash_attention as fa

# name -> (shape, return_lse)
SHAPES = {"serve": ((1, 256, 256, 14, 2, 64), False),
          "train": ((4, 512, 512, 14, 2, 64), True)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs CUDA")
    sys.path.insert(0, str(Path(__file__).resolve().parents[3]))
    from chip_smoke import cuda_ms, eager_ms
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"package": str(Path(fa.__file__).resolve().parents[2])}
    for name, ((b, s, t, hq, hkv, d), lse) in SHAPES.items():
        q, k, v = (torch.randn(sh, generator=gen, device="cuda").to(torch.bfloat16)
                   for sh in ((b, s, hq, d), (b, t, hkv, d), (b, t, hkv, d)))
        call = lambda: fa.flash_attention(q, k, v, causal=True, return_lse=lse)
        out[name] = {"eager_ms": [eager_ms(call) for _ in range(args.rounds)],
                     "cuda_ms": [cuda_ms(call) for _ in range(args.rounds)]}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
