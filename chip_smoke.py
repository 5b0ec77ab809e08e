#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero and
prints no result line:

1. env      -- card, power limit, versions; builds the CUDA kernels.
2. kernels  -- each kernel against its plain version on the card, at the
               serve path's shapes and the JAX kernel tests' shapes, f32
               and bf16; times at the serve path's shapes.
3. serve    -- full-width qwen2-0.5B (bf16, random weights from a seed)
               through ``ServingEngine``; the launch counters must show
               that every prefill and decode layer ran the kernels.
4. parity   -- full-width f32 prefill + decode on the card against the
               same calls with ``device="cpu"``.

The last line is ``{"ok": true, "device": {...}}``.  Needs one CUDA card;
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and dense bf16/f32 rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # the JAX kernel tests' tolerances

# the JAX kernel tests' shapes (tests/test_kernels.py)
FA_SHAPES = [(1, 64, 64, 1, 1, 32), (2, 128, 128, 4, 2, 64),
             (1, 100, 100, 8, 8, 64), (2, 64, 192, 4, 1, 48)]
DEC_SHAPES = [(1, 128, 1, 1, 32), (2, 256, 4, 2, 64), (3, 300, 8, 4, 48)]

# the serve phase: full-width qwen2-0.5B, 8 requests in rounds of 4
ARCH, MAX_BATCH, MAX_LEN, PROMPT_LEN = "qwen2_0_5b", 4, 512, 256
N_REQUESTS, NEW_TOKENS = 8, 32


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, reps: int = 10) -> float:
    """Device time of one call: ``iters`` calls captured in a CUDA graph,
    the graph replayed ``reps`` times between two CUDA events.  The
    replay issues the kernels back to back, so the host's per-call
    overhead (Python, the wrapper's checks) stays out of the number."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm up off the capture stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def eager_ms(fn, iters: int = 50) -> float:
    """Time of one call issued from Python, by CUDA events over ``iters``
    back-to-back calls: the larger of the device time and the host's
    per-call overhead."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def phase_kernels(torch, fa, dec) -> dict:
    """Every kernel against its plain version; returns each kernel's
    max error and times at the serve path's shapes (bf16)."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    checks = []                # one entry per comparison, printed on the phase's line
    errs = {"flash_attention_fwd": 0.0, "decode_attention": 0.0}
    slice_fa = (1, PROMPT_LEN, PROMPT_LEN, 14, 2, 64)
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for shape in [slice_fa] + FA_SHAPES:
            b, s, t, hq, hkv, d = shape
            q, k, v = randn(b, s, hq, d, dtype=dt), randn(b, t, hkv, d, dtype=dt), \
                randn(b, t, hkv, d, dtype=dt)
            # every case in full; the serve shape also with a q_offset and a kv_len
            cases = [(c, 0, t) for c in (True, False)]
            if shape == slice_fa:
                cases += [(True, 16, t - 40), (False, 0, t - 40)]
            for causal, q_offset, kv_len in cases:
                o, lse = fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                                            kv_len=kv_len, return_lse=True)
                o_ref, lse_ref = fa.flash_attention_plain(q, k, v, causal, q_offset, kv_len)
                torch.cuda.synchronize()
                err, lse_err = max_err(o, o_ref), max_err(lse, lse_ref)
                checks.append({"kernel": "flash_attention_fwd", "dtype": dtype,
                               "shape": shape, "causal": causal, "q_offset": q_offset,
                               "kv_len": kv_len, "max_abs_err": err,
                               "lse_max_abs_err": lse_err, "tol": TOL[dtype],
                               "ok": err <= TOL[dtype] and lse_err <= TOL[dtype]})
                if shape == slice_fa and dtype == "bfloat16":
                    errs["flash_attention_fwd"] = max(errs["flash_attention_fwd"], err)

        slice_dec = (MAX_BATCH, MAX_LEN, 14, 2, 64)
        for shape in [slice_dec] + DEC_SHAPES:
            b, t, hq, hkv, d = shape
            q, kc, vc = randn(b, 1, hq, d, dtype=dt), randn(b, t, hkv, d, dtype=dt), \
                randn(b, t, hkv, d, dtype=dt)
            lens = (1, 257, 511) if shape == slice_dec else (1, t // 2, t - 1)
            for n in lens:
                per_row = [max(1, n - 13 * i) for i in range(b)]
                for length in (torch.tensor(n, dtype=torch.int32, device="cuda"),
                               torch.tensor(per_row, dtype=torch.int32, device="cuda")):
                    o = dec.decode_attention(q, kc, vc, length)
                    err = max_err(o, dec.decode_attention_plain(q, kc, vc, length))
                    checks.append({"kernel": "decode_attention", "dtype": dtype,
                                   "shape": shape, "length": length.tolist(),
                                   "max_abs_err": err, "tol": TOL[dtype],
                                   "ok": err <= TOL[dtype]})
                    if shape == slice_dec and dtype == "bfloat16":
                        errs["decode_attention"] = max(errs["decode_attention"], err)

    if not all(c["ok"] for c in checks):
        emit({"phase": "kernels", "ok": False, "checks": checks})
        raise AssertionError("a kernel disagrees with its plain version")

    # times at the serve path's shapes, in its dtype (bf16)
    dt, elt = torch.bfloat16, 2
    b, s, t, hq, hkv, d = slice_fa
    q, k, v = randn(b, s, hq, d, dtype=dt), randn(b, t, hkv, d, dtype=dt), \
        randn(b, t, hkv, d, dtype=dt)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    keys_seen = sum(min(t, i + 1) for i in range(s))           # causal, top-left
    fa_bound, fa_by = bound((2 * b * s * hq * d + 2 * b * t * hkv * d) * elt,
                            4 * b * hq * d * keys_seen, "bfloat16")
    kernel = lambda: fa.flash_attention(q, k, v, causal=True)
    timing = {"flash_attention_fwd": dict(
        ms=cuda_ms(kernel), eager_ms=eager_ms(kernel),
        plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, True)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        bound_ms=fa_bound, bound_by=fa_by, shape=[b, s, t, hq, hkv, d])}

    b, t, hq, hkv, d = slice_dec
    n = PROMPT_LEN + NEW_TOKENS // 2          # a mid-round decode length
    q, kc, vc = randn(b, 1, hq, d, dtype=dt), randn(b, t, hkv, d, dtype=dt), \
        randn(b, t, hkv, d, dtype=dt)
    length = torch.tensor(n, dtype=torch.int32, device="cuda")
    qt, kt, vt = q.transpose(1, 2), kc[:, :n].transpose(1, 2), vc[:, :n].transpose(1, 2)
    dec_bound, dec_by = bound((2 * b * hq * d + 2 * b * n * hkv * d) * elt,
                              4 * b * hq * d * n, "bfloat16")
    kernel = lambda: dec.decode_attention(q, kc, vc, length)
    timing["decode_attention"] = dict(
        ms=cuda_ms(kernel), eager_ms=eager_ms(kernel),
        plain_ms=cuda_ms(lambda: dec.decode_attention_plain(q, kc, vc, length)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                  enable_gqa=True)),
        bound_ms=dec_bound, bound_by=dec_by, shape=[b, t, hq, hkv, d], length=n)
    emit({"phase": "kernels", "ok": True, "checks": checks, "timing_bf16": timing})
    return {name: {**timing[name], "max_abs_err": errs[name]} for name in timing}


def phase_serve(torch, get_config, Request, ServingEngine, fa, dec, kernels) -> dict:
    import numpy as np
    cfg = get_config(ARCH)
    eng = ServingEngine(cfg, max_batch=MAX_BATCH, max_len=MAX_LEN,
                        prompt_len=PROMPT_LEN, seed=0)
    lm, times = eng.lm, {"prefill": [], "decode": []}

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cache, logits = fn(*args, **kwargs)
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"non-finite logits from {name}")
            times[name].append(time.perf_counter() - t0)
            return cache, logits
        return run

    rng = np.random.default_rng(0)

    def requests(n):
        return [Request(rid=i, prompt=rng.integers(0, cfg.vocab, PROMPT_LEN).tolist(),
                        max_new_tokens=NEW_TOKENS) for i in range(n)]

    # a short run first, so that one-time costs (cuBLAS handles, the caching
    # allocator's first blocks) stay out of the timed run
    warm = ServingEngine(cfg, eng.params, max_batch=MAX_BATCH, max_len=MAX_LEN,
                         prompt_len=PROMPT_LEN)
    for r in requests(MAX_BATCH):
        r.max_new_tokens = 2
        warm.submit(r)
    warm.run()
    del warm

    lm.prefill = timed("prefill", lm.prefill)
    lm.decode_step = timed("decode", lm.decode_step)
    reqs = requests(N_REQUESTS)
    for r in reqs:
        eng.submit(r)
    fa.flash_attention.launches = 0
    dec.decode_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention_fwd": fa.flash_attention.launches,
                "decode_attention": dec.decode_attention.launches}

    generated = sum(len(r.out_tokens) for r in reqs)
    prefill_ms = 1e3 * sum(times["prefill"]) / len(times["prefill"])
    decode_ms = 1e3 * sum(times["decode"]) / len(times["decode"])
    out = {"phase": "serve", "arch": ARCH, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "dtype": cfg.param_dtype, "max_batch": MAX_BATCH, "max_len": MAX_LEN,
           "prompt_len": PROMPT_LEN, "requests": N_REQUESTS, "stats": stats,
           "launches": launches, "generated_tokens": generated, "wall_s": wall,
           "prefill_ms_per_request": prefill_ms, "decode_ms_per_step": decode_ms,
           "generated_tokens_per_s": generated / wall,
           # the attention kernels' device time (kernels phase) per layer,
           # as a share of the host-clock prefill / decode-step time
           "flash_share_of_prefill":
               cfg.n_layers * kernels["flash_attention_fwd"]["ms"] / prefill_ms,
           "decode_attention_share_of_step":
               cfg.n_layers * kernels["decode_attention"]["ms"] / decode_ms,
           "first_tokens": [r.out_tokens[:8] for r in reqs[:2]]}
    problems = []
    if stats["completed"] != N_REQUESTS:
        problems.append(f"completed {stats['completed']} of {N_REQUESTS}")
    if launches["flash_attention_fwd"] != cfg.n_layers * stats["prefills"]:
        problems.append(f"flash launches {launches} for {stats['prefills']} prefills")
    if launches["decode_attention"] != cfg.n_layers * stats["decode_steps"]:
        problems.append(f"decode launches {launches} for {stats['decode_steps']} steps")
    if not all(len(r.out_tokens) == NEW_TOKENS
               and all(0 <= t < cfg.padded_vocab for t in r.out_tokens) for r in reqs):
        problems.append("a request's tokens are short or out of range")
    emit({**out, "ok": not problems})
    if problems:
        raise AssertionError("; ".join(problems))
    return launches


def phase_parity(torch, get_config, LM) -> None:
    """Full width, f32: the card against the CPU on the same weights."""
    import numpy as np
    cfg = replace(get_config(ARCH), param_dtype="float32", compute_dtype="float32")
    cpu_lm, gpu_lm = LM(cfg, device="cpu"), LM(cfg)
    cpu_params = cpu_lm.init(seed=1)
    gpu_params = {k: ({kk: vv.to("cuda") for kk, vv in v.items()}
                      if isinstance(v, dict) else v.to("cuda"))
                  for k, v in cpu_params.items()}
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (1, 64))

    def run(lm, params, device):
        cache, logits = lm.prefill(params, {"tokens": torch.from_numpy(toks).to(device)},
                                   max_len=128)
        all_logits, tokens = [logits.cpu()], []
        for _ in range(4):
            tok = torch.argmax(logits, dim=-1)
            tokens.append(tok.tolist())
            cache, logits = lm.decode_step(params, cache, tok)
            all_logits.append(logits.cpu())
        return torch.stack(all_logits), tokens

    gl, gt = run(gpu_lm, gpu_params, "cuda")
    cl, ct = run(cpu_lm, cpu_params, "cpu")
    rel = ((gl - cl).abs().max() / cl.abs().max()).item()
    ok = rel < 1e-3 and gt == ct and bool(torch.isfinite(gl).all())
    emit({"phase": "parity", "arch": ARCH, "dtype": "float32", "prompt_len": 64,
          "decode_steps": 4, "logits_rel_max_err": rel, "tol": 1e-3,
          "tokens_cuda": gt, "tokens_cpu": ct, "ok": ok})
    if not ok:
        raise AssertionError("card and CPU disagree")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.transformer import LM
    from repro_torch.serving import Request, ServingEngine

    card = smi()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    emit({"phase": "env", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "build_s": time.perf_counter() - t0, "library": str(lib.relative_to(ROOT)),
          "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32}})

    kernels = phase_kernels(torch, fa, dec)
    launches = phase_serve(torch, get_config, Request, ServingEngine, fa, dec, kernels)
    phase_parity(torch, get_config, LM)

    replaces = {"flash_attention_fwd": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                        "src/repro/kernels/flash_attention.py:25"),
                "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                                     "src/repro/kernels/decode_attention.py:24")}
    print(card, flush=True)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": replaces[name][0],
         "replaces": replaces[name][1], "launches": launches[name],
         "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
         "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
         "library_ms": row["library_ms"]} for name, row in kernels.items()]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
