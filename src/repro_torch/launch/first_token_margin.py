"""How close the first greedy token is to a tie: for each prompt, the gap
between the two largest last-position logits of a prefill, taken three
ways on the same weights.

    PYTHONPATH=src python -m repro_torch.launch.first_token_margin --arch qwen2_0_5b

- ``kernel``: the model in its own dtype, attention by the CUDA kernels;
- ``plain``: the same, prefill attention by the forward's plain version;
- ``f32``: the same weights cast to f32, computed in f32, prefill
  attention by the plain version (no bf16 rounding of P).

The prompts and weights are those of ``chip_smoke.py``'s serve phase
(``ServingEngine(seed=0)``; prompts drawn one by one from
``default_rng(0)``, the first ``--skip`` for its warm-up run).  Prints one
JSON line: per prompt and per way, the first token, the runner-up, their
gap, and the largest logit difference from the f32 way.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
from dataclasses import replace

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import layers
from repro_torch.models.transformer import LM


def _plain_flash(q, k, v, causal, q_offset=0, kv_len=None, return_lse=False):
    o, lse = flash_attention_plain(q, k, v, causal, q_offset, kv_len)
    return (o, lse) if return_lse else o


def _to_f32(tree):
    return {k: _to_f32(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}


def margins(arch: str, prompt_len: int, n: int, skip: int, max_len: int) -> dict:
    cfg = get_config(arch)
    lm = LM(cfg)
    params = lm.init(0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, prompt_len).tolist() for _ in range(skip + n)][skip:]
    lm32 = LM(replace(cfg, param_dtype="float32", compute_dtype="float32"))
    params32 = _to_f32(params)
    kernel = layers._flash_kernel
    out = []
    for prompt in prompts:
        toks = torch.tensor([prompt], dtype=torch.int64, device=lm.device)
        logits = {}
        try:
            logits["kernel"] = lm.prefill(params, {"tokens": toks}, max_len)[1][0]
            layers._flash_kernel = _plain_flash
            logits["plain"] = lm.prefill(params, {"tokens": toks}, max_len)[1][0]
            logits["f32"] = lm32.prefill(params32, {"tokens": toks}, max_len)[1][0]
        finally:
            layers._flash_kernel = kernel
        row = {}
        for way, lg in logits.items():
            top = torch.topk(lg, 2)        # over what the engine's argmax sees
            row[way] = {"token": int(top.indices[0]), "runner_up": int(top.indices[1]),
                        "gap": float(top.values[0] - top.values[1]),
                        "max_diff_from_f32": float((lg - logits["f32"]).abs().max())}
        out.append(row)
    return {"arch": arch, "prompt_len": prompt_len, "skip": skip, "prompts": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2_0_5b")
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--prompts", type=int, default=8)
    ap.add_argument("--skip", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=512)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs CUDA")
    print(json.dumps(margins(args.arch, args.prompt_len, args.prompts, args.skip,
                             args.max_len)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
