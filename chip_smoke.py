#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero and
prints no result line:

1. env      -- card, power limit, versions; builds the CUDA kernels and
               prints ptxas's registers and spills of the scan kernel's
               instantiations.
2. kernels  -- each attention kernel against its plain version on the
               card, at the main paths' shapes (qwen2-0.5B's serve and
               training shapes, zamba2-2.7B's shared block's, head dim
               80), the JAX kernel tests' shapes and the other head dims
               the kernels take (16, 128), f32 and bf16.  Times and
               bounds at the serve path's shapes (forward; decode at
               qwen2-0.5B's and zamba2-2.7B's) and the training shape
               (backward, and the forward beside it).  Then the scan
               kernel against its plain version (y and h_final, with and
               without h0, f32 and bf16) at the JAX scan test's shapes,
               both SSM serve shapes, S = 1, either side of the kernel's
               32-step chunk and 300 at both serve widths, (Bt, S) =
               (4, 512) at both, 2048 steps at falcon-mamba-7B's width,
               N = 4 and 8 over many blocks, and misaligned slices; two
               launches bit-for-bit equal;
               its refusal under autograd; its times and launch shapes
               at the serve shapes (and, for information, the (4, 512)
               shapes); its bound counts the exps at the SFU's rate.
3. serve    -- full-width qwen2-0.5B (bf16, random weights from a seed)
               through ``ServingEngine``; the launch counters must show
               that every prefill and decode layer ran the kernels.
4. parity   -- full-width f32 prefill + decode on the card against the
               same calls with ``device="cpu"``.
5. serve_ssm, serve_hybrid -- the same for full-width falcon-mamba-7B
               (the scan once per layer per prefill, no attention) and
               zamba2-2.7B (the scan per layer, flash per application of
               the shared block per prefill, decode attention per
               application per step).
6. ssm_parity -- card against CPU, f32, full width at reduced depth:
               falcon-mamba-7B at 2 layers, zamba2-2.7B at 6 (the shared
               block runs once).
7. train    -- full-width qwen2-0.5B (bf16, random weights from a seed)
               through ``repro_torch.train.loop.train``: per-step time,
               tokens/s, finite losses starting near ln(vocab); the launch
               counters must read 2·L·steps forward (remat runs each
               layer again in the backward) and L·steps backward.  Then a
               restart from a checkpoint restored to the card, at full
               width and reduced depth.
8. train-parity -- one full-width, reduced-depth f32 train step on the
               card against the same step with ``device="cpu"``.
9. launcher -- ``python -m repro_torch.launch.train --arch qwen2_0_5b
               --full-config`` as a user runs it (its defaults, a fresh
               checkpoint directory), twice: the first run trains every
               step with finite losses and writes its checkpoints, the
               second finds the last step saved and runs none.
10. serve_launcher -- ``python -m repro_torch.launch.serve --arch
               zamba2_2_7b --full-config``: exit 0, every request done.
11. examples -- the smoke configs (head dim 16) as a user runs them:
               ``examples/serve_lm_torch.py`` at its defaults, ``python -m
               repro_torch.launch.serve --arch qwen2_0_5b`` and
               ``examples/train_lm_torch.py --arch qwen2_0_5b --smoke
               --steps 20``: exit 0, every request done, losses falling;
               then ``examples/train_lm_torch.py --backend threads
               --shards 2`` at its defaults (the 20M demo model, 300
               steps under the Myrmics runtime): exit 0, losses falling.
12. train_myrmics -- full-width qwen2-0.5B (bf16) trained under the
               Myrmics runtime, ``run_myrmics_training(backend="threads")``:
               2 gradient tasks of 2 x 512 tokens a step on 2 workers,
               then the update task.  Losses finite, the first near
               ln(vocab); launch counts 2·L·steps·shards forward and
               L·steps·shards backward; every task done, as many as the
               same DAG runs on ``backend="sim"`` on the CPU.  Host ms a
               step beside the train phase's and beside the same run in
               one gradient task a step (not counted), message counts,
               peak memory of each step.
13. train_myrmics_parity -- 2 layers, f32, 3 steps: the card on
               ``threads`` against the CPU on ``sim`` (losses and final
               parameters within 1e-4 of each leaf's largest magnitude),
               and the card on ``sim`` against the card on ``threads``
               (identical bits).

Every counted run (3, 5, 7, 12) sets every kernel's launch counter to 0
just before it and reads all of them just after.  The line before the
last lists each kernel with its launches summed over those runs.
The last line is ``{"ok": true, "device": {...}}``.  Needs one CUDA card;
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SMS = 132   # H100 SXM streaming multiprocessors
# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and dense bf16/f32 rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# exponentials by the SFU (MUFU) alone: 16 a clock per SM on compute
# capability 9.0 (CUDA C++ Programming Guide, throughput of arithmetic
# instructions: base-2 exponential), 132 SMs at the 1.98 GHz boost clock
PEAK_EXPS = SMS * 16 * 1.98e9
# FMA-pipe instructions for one exp2 taken off the SFU: one subtraction for
# the range reduction, then a degree-5 polynomial (5 FMAs), the least that
# holds f32 accuracy (a degree-3 one errs by ~1e-4 per exp, which a
# 256-step product of decays carries past the scan's f32 rtol of 5e-4);
# the exponent's integer ops run on the INT pipe
FMA_PER_EXP = 6
TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # the JAX kernel tests' tolerances

# the JAX kernel tests' shapes (tests/test_kernels.py), then the head dims
# they leave out: 16 (every smoke config) and 128 (chatglm3-6B, yi-6B; at
# decode with chatglm3-6B's group of 16, the kernel's limit)
FA_SHAPES = [(1, 64, 64, 1, 1, 32), (2, 128, 128, 4, 2, 64),
             (1, 100, 100, 8, 8, 64), (2, 64, 192, 4, 1, 48),
             (2, 64, 64, 4, 2, 16), (1, 100, 130, 8, 1, 128)]
DEC_SHAPES = [(1, 128, 1, 1, 32), (2, 256, 4, 2, 64), (3, 300, 8, 4, 48),
              (2, 128, 4, 2, 16), (2, 300, 16, 1, 128)]

# the JAX backward tests' shapes and a cross length (B, S, T, Hq, Hkv, D),
# then head dims 16, 80 (zamba2-2.7B's shared block: group 1) and 128
# (ragged tiles, a cross length)
BWD_SHAPES = [(2, 64, 64, 4, 2, 32), (1, 96, 96, 8, 8, 64), (2, 64, 192, 4, 1, 48),
              (2, 64, 64, 4, 2, 16), (1, 96, 96, 4, 4, 80), (1, 100, 130, 8, 2, 128)]

# the serve phases: full width, 8 requests in rounds of 4
ARCH, MAX_BATCH, MAX_LEN, PROMPT_LEN = "qwen2_0_5b", 4, 512, 256
N_REQUESTS, NEW_TOKENS = 8, 32
SSM_ARCH, HYBRID_ARCH = "falcon_mamba_7b", "zamba2_2_7b"

# the scan: the JAX kernel test's shapes (Bt, S, Din, N), then the serve
# prefill's shapes of falcon-mamba-7B and zamba2-2.7B; its tolerances
# (atol, rtol), the JAX scan test's in f32
SCAN_SHAPES = [(1, 32, 16, 4), (2, 96, 64, 8), (1, 100, 128, 16)]
SCAN_SERVE = {SSM_ARCH: (1, PROMPT_LEN, 8192, 16), HYBRID_ARCH: (1, PROMPT_LEN, 5120, 64)}
# the scan kernel's time chunk (TC in csrc/mamba_scan.cu); at both serve
# widths: one step, a step either side of the chunk, and 300 steps; the
# (Bt, S) = (4, 512) that SSM training will run; 2048 steps at falcon's
# width, where the error of the decays piles up
SCAN_CHUNK = 32
SCAN_EDGES = [(1, s, din, n) for s in (1, SCAN_CHUNK - 1, SCAN_CHUNK + 1, 300)
              for (_, _, din, n) in SCAN_SERVE.values()]
SCAN_TRAIN = {arch: (4, 512, din, n) for arch, (_, _, din, n) in SCAN_SERVE.items()}
SCAN_LONG = (1, 2048, 8192, 16)
# N = 4 and 8 (one and two lanes a channel) over many blocks
SCAN_WIDE = [(8, 64, 8192, 4), (4, 64, 8192, 8)]
# B and C one element past an aligned start, x and dt slices one element
# in, Din ragged against the block: staged by plain loads
SCAN_MISALIGNED = (2, 100, 1000, 16)
# the kernel's layout (csrc/mamba_scan.cu `Shape`): 4 states a lane, N / 4
# lanes a channel, 128 threads a block and at most 64 channels
SCAN_STATES_A_LANE, SCAN_BLOCK, SCAN_MAX_CHANNELS = 4, 128, 64
SCAN_TOL = {"float32": (5e-5, 5e-4), "bfloat16": (2e-2, 2e-2)}
# zamba2-2.7B's shared attention block: 32 heads of 80, group 1
HYBRID_FA = (1, PROMPT_LEN, PROMPT_LEN, 32, 32, 80)
HYBRID_DEC = (MAX_BATCH, MAX_LEN, 32, 32, 80)
# card-vs-CPU parity depth: 2 falcon layers; 6 zamba2 layers, so that the
# shared block (every 6th layer) runs once
SSM_PARITY_LAYERS = {SSM_ARCH: 2, HYBRID_ARCH: 6}

# the train phase: full-width qwen2-0.5B, bf16; a checkpoint once, at the end
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 512, 4, 4
TRAIN_SHAPE = (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 14, 2, 64)   # its attention
RESTART_LAYERS, PARITY_LAYERS, PARITY_SEQ = 2, 2, 64

# the Myrmics phases: the train phase's batch in 2 gradient tasks a step;
# the parity run at 2 layers, f32, seq 64, 3 steps
MYRMICS_SHARDS, MYRMICS_PARITY_STEPS = 2, 3

# the launcher phase: the launcher's defaults
LAUNCH_STEPS, LAUNCH_CKPT_EVERY, LAUNCH_SEQ, LAUNCH_BATCH = 20, 10, 128, 4
LAUNCH_TIMEOUT_S = 600
# the examples phase: the smoke configs (head dim 16); the serving example's
# and the launcher's default request counts
EXAMPLE_STEPS, EXAMPLE_REQUESTS, LAUNCHER_REQUESTS = 20, 10, 8


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


def fwd_bound(b: int, s: int, t: int, hq: int, hkv: int, d: int) -> tuple[float, str]:
    """The causal bf16 forward's bound: q, k, v read and o written once;
    4·D FLOPs (two products) per visible query-key pair, top-left mask."""
    pairs = b * hq * sum(min(t, i + 1) for i in range(s))
    return bound((2 * b * s * hq * d + 2 * b * t * hkv * d) * 2, 4 * d * pairs, "bfloat16")


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
        for shape in [slice_fa, HYBRID_FA, TRAIN_SHAPE] + FA_SHAPES:
            b, s, t, hq, hkv, d = shape
            q, k, v = randn(b, s, hq, d, dtype=dt), randn(b, t, hkv, d, dtype=dt), \
                randn(b, t, hkv, d, dtype=dt)
            # every case in full; the serve shapes also with a q_offset and a
            # kv_len, the training shape with a q_offset
            cases = [(c, 0, t) for c in (True, False)]
            if shape in (slice_fa, HYBRID_FA):
                cases += [(True, 16, t - 40), (False, 0, t - 40)]
            elif shape == TRAIN_SHAPE:
                cases += [(True, 16, t)]
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
        for shape in [slice_dec, HYBRID_DEC] + DEC_SHAPES:
            b, t, hq, hkv, d = shape
            q, kc, vc = randn(b, 1, hq, d, dtype=dt), randn(b, t, hkv, d, dtype=dt), \
                randn(b, t, hkv, d, dtype=dt)
            lens = (1, 257, 511) if shape in (slice_dec, HYBRID_DEC) else (1, t // 2, t - 1)
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
    fa_bound, fa_by = fwd_bound(*slice_fa)
    kernel = lambda: fa.flash_attention(q, k, v, causal=True)
    timing = {"flash_attention_fwd": dict(
        ms=cuda_ms(kernel), eager_ms=eager_ms(kernel),
        plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, True)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        bound_ms=fa_bound, bound_by=fa_by, shape=[b, s, t, hq, hkv, d])}

    n = PROMPT_LEN + NEW_TOKENS // 2          # a mid-round decode length
    by_arch = {}
    for arch, shape in ((ARCH, slice_dec), (HYBRID_ARCH, HYBRID_DEC)):
        b, t, hq, hkv, d = shape
        q, kc, vc = randn(b, 1, hq, d, dtype=dt), randn(b, t, hkv, d, dtype=dt), \
            randn(b, t, hkv, d, dtype=dt)
        length = torch.tensor(n, dtype=torch.int32, device="cuda")
        qt, kt, vt = q.transpose(1, 2), kc[:, :n].transpose(1, 2), vc[:, :n].transpose(1, 2)
        dec_bound, dec_by = bound((2 * b * hq * d + 2 * b * n * hkv * d) * elt,
                                  4 * b * hq * d * n, "bfloat16")
        kernel = lambda: dec.decode_attention(q, kc, vc, length)
        by_arch[arch] = dict(
            ms=cuda_ms(kernel), eager_ms=eager_ms(kernel),
            plain_ms=cuda_ms(lambda: dec.decode_attention_plain(q, kc, vc, length)),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                      enable_gqa=True)),
            bound_ms=dec_bound, bound_by=dec_by, shape=[b, t, hq, hkv, d], length=n,
            n_split=dec.decode_splits(b, t, hkv, torch.cuda.get_device_properties(0)
                                      .multi_processor_count))
    timing["decode_attention"] = {**by_arch[ARCH], "by_arch": by_arch}
    emit({"phase": "kernels", "ok": True, "checks": checks, "timing_bf16": timing})
    return {name: {**timing[name], "max_abs_err": errs[name]} for name in timing}


def phase_kernels_bwd(torch, fa, fb) -> dict:
    """The backward kernel against its plain version (dq, dk and dv), then
    its times at the training shape (bf16).  A gradient's error is taken
    over its scale, max(1, max |plain|): dk and dv sum a whole GQA group
    and reach magnitudes where one bf16 rounding step is above 2e-2, and
    the kernel and the plain version each round their f32 sums once."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(1)

    def inputs(shape, dt):
        b, s, t, hq, hkv, d = shape
        return [torch.randn(sh, generator=gen, device="cuda").to(dt)
                for sh in ((b, s, hq, d), (b, t, hkv, d), (b, t, hkv, d), (b, s, hq, d))]

    checks, err_train = [], 0.0
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for shape in [TRAIN_SHAPE] + BWD_SHAPES:
            q, k, v, do = inputs(shape, dt)
            cases = [(True, 0), (False, 0)] + ([(True, 16)] if shape == TRAIN_SHAPE else [])
            for causal, q_offset in cases:
                o, lse = fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                                            return_lse=True)
                got = fb.flash_attention_bwd(q, k, v, o, do, lse, causal, q_offset)
                want = fb.flash_attention_bwd_plain(q, k, v, o, do, lse, causal, q_offset)
                torch.cuda.synchronize()
                errs = {n: max_err(g, w) for n, g, w in zip(("dq", "dk", "dv"), got, want)}
                refs = {n: w.float().abs().max().item() for n, w in zip(("dq", "dk", "dv"), want)}
                scaled = max(errs[n] / max(1.0, refs[n]) for n in errs)
                checks.append({"kernel": "flash_attention_bwd", "dtype": dtype, "shape": shape,
                               "causal": causal, "q_offset": q_offset, "max_abs_err": errs,
                               "max_abs_plain": refs, "scaled_err": scaled, "tol": TOL[dtype],
                               "ok": scaled <= TOL[dtype]})
                if shape == TRAIN_SHAPE and dtype == "bfloat16" and causal and not q_offset:
                    err_train = max(errs.values())
    if not all(c["ok"] for c in checks):
        emit({"phase": "kernels_bwd", "ok": False, "checks": checks})
        raise AssertionError("the backward kernel disagrees with its plain version")

    # times at the training shape, in its dtype (bf16), causal
    b, s, t, hq, hkv, d = TRAIN_SHAPE
    q, k, v, do = inputs(TRAIN_SHAPE, torch.bfloat16)
    o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    pairs = b * hq * sum(min(t, i + 1) for i in range(s))     # visible query-key pairs
    n_bytes = (4 * b * s * hq * d + 4 * b * t * hkv * d) * 2 + b * hq * s * 4
    bwd_bound, bwd_by = bound(n_bytes, 10 * d * pairs, "bfloat16")
    f_bound, f_by = fwd_bound(*TRAIN_SHAPE)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    dot = do.transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    sdpa_ms = cuda_ms(sdpa)
    sdpa_fwd_bwd_ms = cuda_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot))
    kernel = lambda: fb.flash_attention_bwd(q, k, v, o, do, lse, True)
    timing = dict(
        ms=cuda_ms(kernel), eager_ms=eager_ms(kernel),
        plain_ms=cuda_ms(lambda: fb.flash_attention_bwd_plain(q, k, v, o, do, lse, True)),
        library_ms=sdpa_fwd_bwd_ms - sdpa_ms, library_fwd_ms=sdpa_ms,
        library_fwd_bwd_ms=sdpa_fwd_bwd_ms, bound_ms=bwd_bound, bound_by=bwd_by,
        shape=list(TRAIN_SHAPE),
        # the forward kernel at the same shape, for the train phase's shares
        fwd_ms=cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True, return_lse=True)),
        fwd_bound_ms=f_bound, fwd_bound_by=f_by)
    emit({"phase": "kernels_bwd", "ok": True, "checks": checks, "timing_bf16": timing})
    return {**timing, "max_abs_err": err_train}


def scan_bound(bt: int, s: int, din: int, n: int, elt: int) -> tuple[float, str, dict]:
    """Bytes: x and dt read and y written (Bt,S,Din), B and C read
    (Bt,S,N), in the input type; A (Din,N) and D (Din,) read and h_final
    (Bt,Din,N) written, in f32.  FLOPs: 6 per (t, d, n) step and 3 per
    (t, d), at the f32 rate (the scan's arithmetic is f32).  Exps: one per
    (t, d, n) step (the decay) and one per (t, d) (softplus).

    Returns the bound in ms, what sets it ("operations" for either rate)
    and the terms.  The bound takes every exp at the SFU's rate
    (``exp_mufu_only``).  That is not a floor: the FMA pipes can evaluate
    exp2 by a polynomial beside the SFU.  ``flops_and_exp_mufu_fma`` is
    the floor for the arithmetic, the exps shared between the SFU and the
    FMA pipes at ``FMA_PER_EXP`` instructions each, the FLOPs on the FMA
    pipes as FMAs; it lies between ``flops_f32`` and ``exp_mufu_only``."""
    n_bytes = (3 * bt * s * din + 2 * bt * s * n) * elt + (din * n + din + bt * din * n) * 4
    flops, exps = bt * s * din * (6 * n + 3), bt * s * din * (n + 1)
    fma_per_s = PEAK_FLOPS["float32"] / 2                 # FMA instructions a second
    terms = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
             "flops_f32": flops / PEAK_FLOPS["float32"] * 1e3,
             "exp_mufu_only": exps / PEAK_EXPS * 1e3}
    by = max(terms, key=terms.get)
    terms["flops_and_exp_mufu_fma"] = max(
        flops / 2 / fma_per_s,
        (flops / 2 + FMA_PER_EXP * exps) / (fma_per_s + FMA_PER_EXP * PEAK_EXPS)) * 1e3
    return terms[by], "bytes" if by == "bytes" else "operations", terms


def phase_kernels_scan(torch, ms) -> dict:
    """The scan kernel against its plain version (y and h_final, from zeros
    and from a given h0; B and C strided slices of one projection, as on
    the model path; also misaligned slices), bit-for-bit equal results
    from two launches, its refusal under autograd, then its times and
    launch shapes at the two serve shapes and, for information, at the
    training shapes (bf16).  Returns its row for the kernels line, at
    falcon-mamba-7B's shape."""
    gen = torch.Generator(device="cuda").manual_seed(2)

    def inputs(shape, dt, offset=0):
        """B and C slices of one projection; with ``offset``, every row of
        x, dt, B and C starts ``offset`` elements past an aligned one."""
        bt, s, din, n = shape
        g = lambda *sh: torch.randn(sh, generator=gen, device="cuda")
        wide = lambda: (0.5 * g(bt, s, din + offset)).to(dt)[..., offset:]
        proj = (0.5 * g(bt, s, 3 * n + offset)).to(dt)[..., offset:]
        return (wide(), wide(), -torch.exp(0.3 * g(din, n)), proj[..., n:2 * n],
                proj[..., 2 * n:], 1 + 0.5 * g(din), 0.5 * g(bt, din, n))

    def over_tol(got, want, atol, rtol):
        """max(|got - want| - rtol·|want|): at most atol where the two agree."""
        want = want.float()
        return ((got.float() - want).abs() - rtol * want.abs()).max().item()

    def launch(shape):
        """The kernel's launch shape."""
        bt, _, din, n = shape
        lanes = n // SCAN_STATES_A_LANE
        ch = min(SCAN_MAX_CHANNELS, SCAN_BLOCK // lanes)
        blocks, warps = bt * -(-din // ch), -(-ch * lanes // 32)
        return {"states_a_lane": SCAN_STATES_A_LANE, "channels_a_block": ch, "blocks": blocks,
                "warps_a_block": warps,
                # if every block is resident at once (registers and shared
                # memory allow it at the serve shapes), spread evenly
                "warps_a_sm": [blocks // SMS * warps, -(-blocks // SMS) * warps]}

    cases = ([(shape, 0) for shape in list(SCAN_SERVE.values()) + SCAN_SHAPES + SCAN_EDGES
              + list(SCAN_TRAIN.values()) + [SCAN_LONG] + SCAN_WIDE]
             + [(SCAN_MISALIGNED, 1)])
    checks, row_err = [], 0.0
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        atol, rtol = SCAN_TOL[dtype]
        for shape, offset in cases:
            x, dtr, A, B, C, D, h0 = inputs(shape, dt, offset)
            for start in (None, h0):
                y, h = ms.mamba_scan(x, dtr, A, B, C, D, start)
                y_ref, h_ref = ms.mamba_scan_plain(x, dtr, A, B, C, D, start)
                torch.cuda.synchronize()
                errs = {"y": max_err(y, y_ref), "h_final": max_err(h, h_ref)}
                ok = (over_tol(y, y_ref, atol, rtol) <= atol
                      and over_tol(h, h_ref, atol, rtol) <= atol
                      and y.dtype == dt and h.dtype == torch.float32)
                checks.append({"kernel": "mamba_scan", "dtype": dtype, "shape": shape,
                               "offset": offset, "h0": start is not None,
                               "max_abs_err": errs,
                               "max_abs_plain": {"y": y_ref.float().abs().max().item(),
                                                 "h_final": h_ref.abs().max().item()},
                               "tol": [atol, rtol], "ok": ok})
                if shape == SCAN_SERVE[SSM_ARCH] and dtype == "bfloat16" and start is None:
                    row_err = errs["y"]
        for shape in SCAN_SERVE.values():
            x, dtr, A, B, C, D, h0 = inputs(shape, dt)
            first, second = (ms.mamba_scan(x, dtr, A, B, C, D, h0) for _ in range(2))
            checks.append({"kernel": "mamba_scan", "check": "two launches, identical bits",
                           "dtype": dtype, "shape": shape,
                           "ok": all(torch.equal(u, v) for u, v in zip(first, second))})
    x, dtr, A, B, C, D, _ = inputs(SCAN_SHAPES[0], torch.float32)
    try:
        ms.mamba_scan(x.requires_grad_(True), dtr, A, B, C, D)
        refused = False
    except NotImplementedError:
        refused = True
    checks.append({"kernel": "mamba_scan", "check": "raises under autograd", "ok": refused})
    if not all(c["ok"] for c in checks):
        emit({"phase": "kernels_scan", "ok": False,
              "failed": [c for c in checks if not c["ok"]], "n_checks": len(checks)})
        raise AssertionError("the scan kernel disagrees with its plain version")

    def timed(shape, plain):
        x, dtr, A, B, C, D, _ = inputs(shape, torch.bfloat16)
        b_ms, b_by, b_terms = scan_bound(*shape, elt=2)
        kernel = lambda: ms.mamba_scan(x, dtr, A, B, C, D)
        return dict(
            ms=cuda_ms(kernel), eager_ms=eager_ms(kernel),
            # the plain version is a loop of S steps: fewer calls per graph
            plain_ms=(cuda_ms(lambda: ms.mamba_scan_plain(x, dtr, A, B, C, D), iters=2, reps=3)
                      if plain else None),
            library_ms=None, bound_ms=b_ms, bound_by=b_by, bound_terms_ms=b_terms,
            shape=list(shape), exps=shape[0] * shape[1] * shape[2] * (shape[3] + 1),
            launch=launch(shape))

    timing = {arch: timed(shape, plain=True) for arch, shape in SCAN_SERVE.items()}
    # for information: the shapes SSM training will run
    timing_train = {arch: timed(shape, plain=False) for arch, shape in SCAN_TRAIN.items()}
    emit({"phase": "kernels_scan", "ok": True, "n_checks": len(checks), "checks": checks,
          "timing_bf16": timing, "timing_train_bf16": timing_train,
          "library": "none: no single PyTorch call computes the selective scan"})
    return {**timing[SSM_ARCH], "max_abs_err": row_err, "by_arch": timing}


def phase_serve(torch, phase, arch, counters, per_prefill, per_step, shares) -> dict:
    """Full-width ``arch`` (bf16, random weights from a seed) through
    ``ServingEngine``.  Every kernel's counter is set to 0 just before the
    counted run and read just after; kernel k must have launched
    ``per_prefill[k]`` times per prefill plus ``per_step[k]`` per decode
    step (0 where absent).  ``shares``: label -> (launches per prefill or
    step, the kernel's device ms, "prefill" or "decode"), each printed as
    a share of the host-clock prefill or step time."""
    import gc

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.serving import Request, ServingEngine
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
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
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    want = {name: per_prefill.get(name, 0) * stats["prefills"]
            + per_step.get(name, 0) * stats["decode_steps"] for name in counters}

    generated = sum(len(r.out_tokens) for r in reqs)
    prefill_ms = 1e3 * sum(times["prefill"]) / len(times["prefill"])
    decode_ms = 1e3 * sum(times["decode"]) / len(times["decode"])
    out = {"phase": phase, "arch": arch, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "dtype": cfg.param_dtype, "max_batch": MAX_BATCH, "max_len": MAX_LEN,
           "prompt_len": PROMPT_LEN, "requests": N_REQUESTS, "stats": stats,
           "launches": launches, "launches_wanted": want, "generated_tokens": generated,
           "wall_s": wall, "prefill_ms_per_request": prefill_ms,
           "decode_ms_per_step": decode_ms, "generated_tokens_per_s": generated / wall,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           # a kernel's device time (kernels phases) times its launches per
           # prefill or step, as a share of the host-clock prefill or step
           **{label: n * ms / (prefill_ms if which == "prefill" else decode_ms)
              for label, (n, ms, which) in shares.items()},
           "first_tokens": [r.out_tokens[:8] for r in reqs[:2]]}
    problems = []
    if stats["completed"] != N_REQUESTS:
        problems.append(f"completed {stats['completed']} of {N_REQUESTS}")
    if launches != want:
        problems.append(f"launches {launches}, want {want} for {stats['prefills']} "
                        f"prefills and {stats['decode_steps']} decode steps")
    if not all(len(r.out_tokens) == NEW_TOKENS
               and all(0 <= t < cfg.padded_vocab for t in r.out_tokens) for r in reqs):
        problems.append("a request's tokens are short or out of range")
    emit({**out, "ok": not problems})
    if problems:
        raise AssertionError("; ".join(problems))
    del eng, lm
    gc.collect()                 # the timed wrappers hold the model in a cycle
    torch.cuda.empty_cache()
    return launches


def phase_parity(torch, get_config, LM, arch=ARCH, n_layers=None, phase="parity") -> None:
    """Full width, f32: the card against the CPU on the same weights, at the
    config's depth or ``n_layers``."""
    import numpy as np
    cfg = replace(get_config(arch), param_dtype="float32", compute_dtype="float32",
                  n_layers=n_layers or get_config(arch).n_layers)
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
    emit({"phase": phase, "arch": arch, "n_layers": cfg.n_layers, "dtype": "float32",
          "prompt_len": 64, "decode_steps": 4, "logits_rel_max_err": rel, "tol": 1e-3,
          "tokens_cuda": gt, "tokens_cpu": ct, "ok": ok})
    if not ok:
        raise AssertionError("card and CPU disagree")


def phase_train(torch, get_config, counters, bwd) -> tuple[dict, float]:
    """Full-width training through the loop, then a restart at reduced
    depth.  Returns the main run's launch counts and mean warm step ms."""
    import tempfile
    from repro_torch.train.loop import FailurePlan, train
    cfg = get_config(ARCH)
    stamps = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt:
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        rep = train(cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, steps=TRAIN_STEPS,
                    ckpt_dir=ckpt, ckpt_every=TRAIN_STEPS, seed=0, device="cuda",
                    on_step=lambda step, loss: stamps.append(time.perf_counter()))
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counters.items()}
        wall = time.perf_counter() - t0
        saved = sorted(os.listdir(ckpt))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]   # steps 1.. (warm)
    mean_ms = sum(step_ms) / len(step_ms)
    n_layers = cfg.n_layers
    attn_ms = n_layers * (2 * bwd["fwd_ms"] + bwd["ms"])      # per step, by device time
    ln_vocab = math.log(cfg.padded_vocab)
    problems = []
    if launches != {**dict.fromkeys(counters, 0),
                    "flash_attention_fwd": 2 * n_layers * TRAIN_STEPS,
                    "flash_attention_bwd": n_layers * TRAIN_STEPS}:
        problems.append(f"launches {launches}, want 2·L·steps forward and L·steps backward")
    if not all(math.isfinite(x) for x in rep.losses) or len(rep.losses) != TRAIN_STEPS:
        problems.append(f"losses {rep.losses}")
    elif abs(rep.losses[0] - ln_vocab) > 0.5:
        problems.append(f"first loss {rep.losses[0]} is not near ln(vocab) {ln_vocab}")
    if saved != [f"step_{TRAIN_STEPS:08d}"]:
        problems.append(f"checkpoints {saved}")

    # restart: a failure mid-run restores the latest checkpoint to the card
    rcfg = replace(cfg, n_layers=RESTART_LAYERS)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt:
        rrep = train(rcfg, seq_len=128, global_batch=2, steps=4, ckpt_dir=ckpt,
                     ckpt_every=2, failure_plan=FailurePlan(fail_at_steps=(3,)), seed=1,
                     device="cuda")
    # steps 0, 1, 2, then the failure at 3 restores step 2's checkpoint: 2 runs again
    replay_err = abs(rrep.losses[2] - rrep.losses[3]) if len(rrep.losses) == 5 else math.inf
    if rrep.restarts != 1 or rrep.steps_run != 5 or replay_err > 1e-4:
        problems.append(f"restart: {rrep}")
    emit({"phase": "train", "arch": ARCH, "n_layers": n_layers, "d_model": cfg.d_model,
          "dtype": cfg.param_dtype, "seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH,
          "steps": TRAIN_STEPS, "losses": rep.losses, "ln_padded_vocab": ln_vocab,
          "first_step_ms": 1e3 * (stamps[0] - t0), "step_ms": step_ms,
          "mean_step_ms": mean_ms, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / mean_ms * 1e3,
          "wall_s_with_checkpoint": wall, "checkpoints": saved, "peak_mem_gb": peak_gb,
          "launches": launches, "stragglers": rep.stragglers,
          # the attention kernels' device time (kernels phase, training
          # shape) per step, as a share of the host-clock step time
          "attention_kernels_ms_per_step": attn_ms,
          "flash_fwd_share_of_step": n_layers * 2 * bwd["fwd_ms"] / mean_ms,
          "flash_bwd_share_of_step": n_layers * bwd["ms"] / mean_ms,
          "restart": {"n_layers": RESTART_LAYERS, "seq_len": 128, "global_batch": 2,
                      "restarts": rrep.restarts, "steps_run": rrep.steps_run,
                      "losses": rrep.losses, "replayed_step_abs_err": replay_err,
                      "tol": 1e-4},
          "ok": not problems})
    if problems:
        raise AssertionError("; ".join(problems))
    return launches, mean_ms


def phase_train_parity(torch, get_config, LM) -> None:
    """One f32 train step at full width and reduced depth, the card against
    the CPU from the same weights and batch.  Adam's first step is
    lr·g/(|g| + eps), the sign of g for the default eps, which flips
    between two correct runs wherever g is near 0; eps = 1e-2 makes it a
    smooth function of g, so every updated leaf compares at f32's
    summation-order tolerance."""
    from repro_torch.data import TokenDataset
    from repro_torch.optim import AdamW
    from repro_torch.train.steps import make_train_step
    from repro_torch.tree import flatten_with_keys, tree_map
    cfg = replace(get_config(ARCH), n_layers=PARITY_LAYERS, param_dtype="float32",
                  compute_dtype="float32")
    opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-2)
    cpu_lm, gpu_lm = LM(cfg, device="cpu"), LM(cfg)
    cpu_params = cpu_lm.init(seed=2)
    gpu_params = tree_map(lambda x: x.to("cuda"), cpu_params)
    batch = TokenDataset(cfg, PARITY_SEQ, 2, seed=2).get_batch(0)
    out = {}
    for name, lm, params in (("cuda", gpu_lm, gpu_params), ("cpu", cpu_lm, cpu_params)):
        dev_batch = {k: torch.from_numpy(v).to(lm.device) for k, v in batch.items()}
        new, state, metrics = make_train_step(lm, opt)(params, opt.init(params), dev_batch)
        out[name] = (dict(flatten_with_keys(new)), {k: float(v) for k, v in metrics.items()})
    (gp, gm), (cp, cm) = out["cuda"], out["cpu"]
    rel = lambda a, b: ((a.cpu() - b).abs().max() / (b.abs().max() + 1e-30)).item()
    leaf_err = {k: rel(gp[k], cp[k]) for k in cp}
    metric_err = {k: abs(gm[k] - cm[k]) / abs(cm[k]) for k in cm}
    tol = 1e-4
    ok = max(leaf_err.values()) <= tol and max(metric_err.values()) <= tol and all(
        math.isfinite(v) for v in gm.values())
    emit({"phase": "train_parity", "arch": ARCH, "n_layers": PARITY_LAYERS, "dtype": "float32",
          "seq_len": PARITY_SEQ, "global_batch": 2, "metrics_cuda": gm, "metrics_cpu": cm,
          "metric_rel_err": metric_err, "max_leaf_rel_err": max(leaf_err.values()),
          "worst_leaf": max(leaf_err, key=leaf_err.get), "tol": tol, "ok": ok})
    if not ok:
        raise AssertionError("card and CPU train steps disagree")


def phase_train_myrmics(torch, get_config, counters, plain_step_ms) -> dict:
    """Full-width training under the Myrmics runtime on the threads
    backend: the train phase's model, sequence, batch and steps, the
    batch split into ``MYRMICS_SHARDS`` gradient tasks a step.  Returns
    the run's launch counts."""
    from repro_torch.train import orchestrator
    cfg = get_config(ARCH)
    stamps, step_peaks = [], []

    def on_step(step, loss):
        stamps.append(time.perf_counter())
        step_peaks.append(torch.cuda.max_memory_allocated() / 1e9)
        torch.cuda.reset_peak_memory_stats()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    rep, run_rep = orchestrator.run_myrmics_training(
        cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, steps=TRAIN_STEPS,
        n_shards=MYRMICS_SHARDS, seed=0, backend="threads", device="cuda", on_step=on_step)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    wall = time.perf_counter() - t0
    peak_gb = max(step_peaks + [torch.cuda.max_memory_allocated() / 1e9])
    # the same DAG on the virtual-time backend, on the CPU, at the smoke size
    _, sim_rep = orchestrator.run_myrmics_training(
        cfg.smoke(), seq_len=16, global_batch=TRAIN_BATCH, steps=TRAIN_STEPS,
        n_shards=MYRMICS_SHARDS, backend="sim", device="cpu")
    step_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]   # steps 1.. (warm)
    mean_ms = sum(step_ms) / len(step_ms)
    n_layers, tasks = cfg.n_layers, TRAIN_STEPS * MYRMICS_SHARDS
    want = {**dict.fromkeys(counters, 0),
            # remat (LM.loss's default) runs each layer again in the backward
            "flash_attention_fwd": 2 * n_layers * tasks,
            "flash_attention_bwd": n_layers * tasks}
    ln_vocab = math.log(cfg.padded_vocab)
    problems = []
    if launches != want:
        problems.append(f"launches {launches}, want {want}")
    if not all(math.isfinite(x) for x in rep.losses) or len(rep.losses) != TRAIN_STEPS:
        problems.append(f"losses {rep.losses}")
    elif abs(rep.losses[0] - ln_vocab) > 0.5:
        problems.append(f"first loss {rep.losses[0]} is not near ln(vocab) {ln_vocab}")
    if not run_rep.tasks_done == run_rep.tasks_spawned == sim_rep.tasks_done:
        problems.append(f"tasks: threads {run_rep.tasks_done} done of {run_rep.tasks_spawned}, "
                        f"sim {sim_rep.tasks_done}")
    emit({"phase": "train_myrmics", "arch": ARCH, "n_layers": n_layers,
          "d_model": cfg.d_model, "dtype": cfg.param_dtype, "seq_len": TRAIN_SEQ,
          "global_batch": TRAIN_BATCH, "n_shards": MYRMICS_SHARDS, "steps": TRAIN_STEPS,
          "backend": run_rep.backend, "losses": rep.losses, "ln_padded_vocab": ln_vocab,
          "first_step_ms": 1e3 * (stamps[0] - t0), "step_ms": step_ms,
          "mean_step_ms": mean_ms, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / mean_ms * 1e3,
          "wall_s": wall, "runtime_wall_s": run_rep.total_cycles, "peak_mem_gb": peak_gb,
          "peak_mem_gb_by_step": step_peaks,
          "launches": launches, "launches_wanted": want,
          "tasks_spawned": run_rep.tasks_spawned, "tasks_done": run_rep.tasks_done,
          "sim_tasks_done": sim_rep.tasks_done,
          "tasks_by_worker": {w: s.tasks_executed for w, s in run_rep.workers.items()},
          "msgs_sent": {"workers": sum(s.msgs_sent for s in run_rep.workers.values()),
                        "scheds": sum(s.msgs_sent for s in run_rep.scheds.values())},
          "msg_kinds": run_rep.msg_kinds,
          # for information: the plain loop at the same tokens a step
          "loop_mean_step_ms": plain_step_ms, "step_ms_over_loop": mean_ms / plain_step_ms,
          "ok": not problems})
    if problems:
        raise AssertionError("; ".join(problems))
    return launches


def phase_train_myrmics_parity(torch, get_config, LM) -> None:
    """2 layers, f32, 3 steps under the runtime from the same weights (drawn
    on the CPU, moved to the card): the card on threads against the CPU on
    sim, and the card on sim against the card on threads.  eps = 1e-2 as
    in ``phase_train_parity``: Adam's first step is otherwise the sign of
    g, which flips between two correct runs wherever g is near 0."""
    from repro_torch.optim import AdamW
    from repro_torch.train import orchestrator
    from repro_torch.tree import flatten_with_keys, tree_map
    cfg = replace(get_config(ARCH), n_layers=PARITY_LAYERS, param_dtype="float32",
                  compute_dtype="float32")
    opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=MYRMICS_PARITY_STEPS, eps=1e-2)
    kept, init, runtime = [], LM.init, orchestrator.Myrmics

    class Recording(runtime):
        """Keeps each runtime, so its final object store can be read."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            kept.append(self)

    def cpu_init(self, seed=0):
        return tree_map(lambda x: x.to(self.device), init(LM(self.cfg, device="cpu"), seed))

    out = {}
    LM.init, orchestrator.Myrmics = cpu_init, Recording
    try:
        for device, backend in (("cuda", "threads"), ("cuda", "sim"), ("cpu", "sim")):
            rep, run_rep = orchestrator.run_myrmics_training(
                cfg, seq_len=PARITY_SEQ, global_batch=TRAIN_BATCH,
                steps=MYRMICS_PARITY_STEPS, n_shards=MYRMICS_SHARDS, seed=3, opt=opt,
                backend=backend, device=device)
            params = dict(flatten_with_keys(kept[-1].labelled_storage()["params"]))
            out[device, backend] = (rep.losses, {k: v.cpu() for k, v in params.items()},
                                    run_rep.tasks_done)
    finally:
        LM.init, orchestrator.Myrmics = init, runtime
    (gl, gp, _), (sl, sp, _), (cl, cp, _) = (out["cuda", "threads"], out["cuda", "sim"],
                                             out["cpu", "sim"])
    rel = lambda a, b: ((a - b).abs().max() / (b.abs().max() + 1e-30)).item()
    leaf_err = {k: rel(gp[k], cp[k]) for k in cp}
    loss_err = [abs(a - b) / abs(b) for a, b in zip(gl, cl, strict=True)]
    tol = 1e-4
    bits = gl == sl and all(torch.equal(gp[k], sp[k]) for k in sp)
    sim_vs_threads = max(max((gp[k] - sp[k]).abs().max().item() for k in sp),
                         max(abs(a - b) for a, b in zip(gl, sl, strict=True)))
    ok = (max(leaf_err.values()) <= tol and max(loss_err) <= tol and bits
          and all(math.isfinite(x) for x in gl))
    emit({"phase": "train_myrmics_parity", "arch": ARCH, "n_layers": PARITY_LAYERS,
          "dtype": "float32", "seq_len": PARITY_SEQ, "global_batch": TRAIN_BATCH,
          "n_shards": MYRMICS_SHARDS, "steps": MYRMICS_PARITY_STEPS,
          "losses_cuda_threads": gl, "losses_cuda_sim": sl, "losses_cpu_sim": cl,
          "tasks_done": {f"{d}_{b}": v[2] for (d, b), v in out.items()},
          "loss_rel_err": loss_err, "max_leaf_rel_err": max(leaf_err.values()),
          "worst_leaf": max(leaf_err, key=leaf_err.get), "tol": tol,
          "cuda_sim_vs_threads_max_abs_diff": sim_vs_threads,
          "cuda_sim_vs_threads_identical_bits": bits, "ok": ok})
    if not ok:
        raise AssertionError("the Myrmics runs disagree: card vs CPU, or sim vs threads")


def _run_launcher(cmd: list[str]) -> tuple[int, list[tuple[float, str]]]:
    """Run ``cmd``, stamping each output line with the host clock as it
    arrives; killed after ``LAUNCH_TIMEOUT_S``."""
    import threading
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    timer = threading.Timer(LAUNCH_TIMEOUT_S, proc.kill)
    timer.start()
    try:
        lines = [(time.perf_counter(), line.rstrip("\n")) for line in proc.stdout]
        return proc.wait(), lines
    finally:
        timer.cancel()
        proc.kill()
        proc.wait()


def phase_launcher(torch) -> None:
    """The training launcher as a user runs it, twice into one fresh
    checkpoint directory.  Step times are the intervals between its
    ``step N loss`` lines; the one that holds a checkpoint is reported
    apart."""
    import re
    import statistics
    import tempfile
    torch.cuda.empty_cache()        # the launcher is another process on the same card
    cmd = [sys.executable, "-u", "-m", "repro_torch.launch.train", "--arch", ARCH,
           "--full-config"]
    step_re = re.compile(r"^step (\d+) loss (\S+)$")
    problems, runs = [], []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_launch_") as ckpt:
        for _ in range(2):
            t0 = time.perf_counter()
            rc, lines = _run_launcher(cmd + ["--ckpt-dir", ckpt])
            steps = [(t, int(m[1]), float(m[2])) for t, line in lines
                     if (m := step_re.match(line))]
            runs.append({"rc": rc, "wall_s": time.perf_counter() - t0, "steps": steps,
                         "last_line": lines[-1][1] if lines else "",
                         "checkpoints": sorted(os.listdir(ckpt))})
    first, second = runs
    losses = [loss for _, _, loss in first["steps"]]
    gaps = [1e3 * (b[0] - a[0]) for a, b in zip(first["steps"], first["steps"][1:])]
    # the interval ending at step LAUNCH_CKPT_EVERY holds that step's save
    ckpt_gap = gaps.pop(LAUNCH_CKPT_EVERY - 1) if len(gaps) >= LAUNCH_CKPT_EVERY else None
    want_ckpts = [f"step_{s:08d}" for s in range(LAUNCH_CKPT_EVERY, LAUNCH_STEPS + 1,
                                                 LAUNCH_CKPT_EVERY)]
    if first["rc"] != 0 or [s for _, s, _ in first["steps"]] != list(range(LAUNCH_STEPS)):
        problems.append(f"first run: rc {first['rc']}, steps "
                        f"{[s for _, s, _ in first['steps']]}, last line {first['last_line']!r}")
    if not losses or not all(math.isfinite(x) for x in losses):
        problems.append(f"first run losses {losses}")
    if first["checkpoints"] != want_ckpts:
        problems.append(f"checkpoints {first['checkpoints']}, want {want_ckpts}")
    if second["rc"] != 0 or second["steps"] or not second["last_line"].startswith("no steps run"):
        problems.append(f"second run: rc {second['rc']}, {len(second['steps'])} steps, "
                        f"last line {second['last_line']!r}")
    mean_ms = sum(gaps) / len(gaps) if gaps else math.nan
    emit({"phase": "launcher", "command": "python " + " ".join(cmd[1:]), "steps": LAUNCH_STEPS,
          "seq_len": LAUNCH_SEQ, "global_batch": LAUNCH_BATCH, "losses": losses,
          "step_ms": gaps, "mean_step_ms": mean_ms,
          "median_step_ms": statistics.median(gaps) if gaps else math.nan,
          "tokens_per_s": LAUNCH_BATCH * LAUNCH_SEQ / mean_ms * 1e3,
          "interval_with_checkpoint_ms": ckpt_gap, "checkpoints": first["checkpoints"],
          "wall_s": [r["wall_s"] for r in runs], "rc": [r["rc"] for r in runs],
          "last_lines": [r["last_line"] for r in runs], "ok": not problems})
    if problems:
        raise AssertionError("; ".join(problems))


def _stats(lines) -> list[dict]:
    """The ``stats: {...}`` dicts a serving script printed."""
    import ast
    import re
    return [ast.literal_eval(m[1]) for _, line in lines
            if (m := re.match(r"^stats: (\{.*\})", line))]


def phase_serve_launcher(torch) -> None:
    """The serving launcher as a user runs it, on the hybrid at full width:
    exit 0 and every request completed."""
    torch.cuda.empty_cache()        # the launcher is another process on the same card
    cmd = [sys.executable, "-u", "-m", "repro_torch.launch.serve", "--arch", HYBRID_ARCH,
           "--full-config"]
    t0 = time.perf_counter()
    rc, lines = _run_launcher(cmd)
    wall = time.perf_counter() - t0
    stats = _stats(lines)
    n = 8                           # the launcher's default request count
    ok = rc == 0 and len(stats) == 1 and stats[0]["completed"] == n
    emit({"phase": "serve_launcher", "command": "python " + " ".join(cmd[1:]), "rc": rc,
          "stats": stats[0] if stats else None, "requests": n, "wall_s": wall,
          "last_lines": [line for _, line in lines[-5:]], "ok": ok})
    if not ok:
        raise AssertionError(f"serve launcher: rc {rc}, stats {stats}")


def phase_examples(torch) -> None:
    """The smoke configs (head dim 16) on the card as a user runs them:
    the serving example at its defaults, the serving launcher without
    ``--full-config``, and the training example for a few steps into a
    fresh checkpoint directory; then the training example on the threads
    backend at its defaults.  Each must exit 0; each serving run must
    complete every request, and each training run must report its losses
    (it exits non-zero when the loss does not fall)."""
    import tempfile
    torch.cuda.empty_cache()        # the scripts are other processes on the same card
    with tempfile.TemporaryDirectory(prefix="chip_smoke_example_") as ckpt:
        runs = {
            "serve_example": ([sys.executable, "-u", "examples/serve_lm_torch.py"],
                              EXAMPLE_REQUESTS),
            "serve_launcher": ([sys.executable, "-u", "-m", "repro_torch.launch.serve",
                                "--arch", ARCH], LAUNCHER_REQUESTS),
            "train_example": ([sys.executable, "-u", "examples/train_lm_torch.py", "--arch",
                               ARCH, "--smoke", "--steps", str(EXAMPLE_STEPS), "--ckpt-dir",
                               ckpt], None),
            # the training example under the Myrmics runtime, at its defaults
            "train_example_threads": ([sys.executable, "-u", "examples/train_lm_torch.py",
                                       "--backend", "threads", "--shards", "2"], None),
        }
        results, problems = {}, []
        for name, (cmd, n_requests) in runs.items():
            t0 = time.perf_counter()
            rc, lines = _run_launcher(cmd)
            stats = _stats(lines)
            results[name] = {"command": "python " + " ".join(cmd[1:]), "rc": rc,
                             "wall_s": time.perf_counter() - t0,
                             "stats": stats[0] if stats else None,
                             "last_lines": [line for _, line in lines[-4:]]}
            if rc != 0:
                problems.append(f"{name}: rc {rc}")
            if n_requests is not None and (len(stats) != 1
                                           or stats[0]["completed"] != n_requests):
                problems.append(f"{name}: stats {stats}, want {n_requests} completed")
            if n_requests is None and not any(line.startswith(("done: first loss",
                                                               "done (threads backend"))
                                              for _, line in lines):
                problems.append(f"{name}: no 'done' line")
    emit({"phase": "examples", "head_dim": 16, "runs": results, "ok": not problems})
    if problems:
        raise AssertionError("; ".join(problems))


def main() -> int:
    import gc

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.models.transformer import LM

    card = smi()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    report = lib.parent / "mamba_scan.ptxas.txt"
    emit({"phase": "env", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "build_s": time.perf_counter() - t0, "library": str(lib.relative_to(ROOT)),
          # each scan instantiation's name, then its stack and spills, then registers
          "ptxas_mamba_scan": [
              line.split("ptxas info    :")[-1].strip()
              for line in (report.read_text().splitlines() if report.exists() else [])
              if any(w in line for w in ("entry function", "spill", "registers"))],
          "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32}})

    counters = {"flash_attention_fwd": fa.flash_attention,
                "decode_attention": dec.decode_attention,
                "flash_attention_bwd": fb.flash_attention_bwd,
                "mamba_scan": ms.mamba_scan}
    kernels = phase_kernels(torch, fa, dec)
    kernels["flash_attention_bwd"] = phase_kernels_bwd(torch, fa, fb)
    kernels["mamba_scan"] = phase_kernels_scan(torch, ms)
    scan_ms = kernels["mamba_scan"]["by_arch"]

    # the main paths, each run with every counter set to 0 just before it
    runs = []
    qwen = get_config(ARCH)
    runs.append(phase_serve(
        torch, "serve", ARCH, counters, {"flash_attention_fwd": qwen.n_layers},
        {"decode_attention": qwen.n_layers},
        {"flash_share_of_prefill": (qwen.n_layers, kernels["flash_attention_fwd"]["ms"],
                                    "prefill"),
         "decode_attention_share_of_step": (qwen.n_layers, kernels["decode_attention"]["ms"],
                                            "decode")}))
    phase_parity(torch, get_config, LM)
    falcon = get_config(SSM_ARCH)
    runs.append(phase_serve(
        torch, "serve_ssm", SSM_ARCH, counters, {"mamba_scan": falcon.n_layers}, {},
        {"scan_share_of_prefill": (falcon.n_layers, scan_ms[SSM_ARCH]["ms"], "prefill")}))
    zamba = get_config(HYBRID_ARCH)
    n_apps = zamba.n_layers // zamba.shared_attn_every
    runs.append(phase_serve(
        torch, "serve_hybrid", HYBRID_ARCH, counters,
        {"mamba_scan": zamba.n_layers, "flash_attention_fwd": n_apps},
        {"decode_attention": n_apps},
        {"scan_share_of_prefill": (zamba.n_layers, scan_ms[HYBRID_ARCH]["ms"], "prefill")}))
    for arch, n_layers in SSM_PARITY_LAYERS.items():
        phase_parity(torch, get_config, LM, arch, n_layers, phase="ssm_parity")
        gc.collect()
        torch.cuda.empty_cache()
    train_launches, train_step_ms = phase_train(torch, get_config, counters,
                                                kernels["flash_attention_bwd"])
    runs.append(train_launches)
    phase_train_parity(torch, get_config, LM)
    runs.append(phase_train_myrmics(torch, get_config, counters, train_step_ms))
    phase_train_myrmics_parity(torch, get_config, LM)
    phase_launcher(torch)
    phase_serve_launcher(torch)
    phase_examples(torch)
    # each kernel's launches summed over the main paths' counted runs
    launches = {name: sum(run[name] for run in runs) for name in counters}

    replaces = {"flash_attention_fwd": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                        "src/repro/kernels/flash_attention.py:25"),
                "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                                     "src/repro/kernels/decode_attention.py:24"),
                "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                                        "src/repro/kernels/flash_attention_bwd.py:30"),
                "mamba_scan": ("src/repro_torch/kernels/csrc/mamba_scan.cu",
                               "src/repro/kernels/mamba_scan.py:26")}
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
