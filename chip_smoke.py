#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero and
prints no result line:

1. env      -- card, power limit, versions; builds the CUDA kernels and
               prints ptxas's registers and spills of the scan kernel's
               instantiations.  Meanwhile two spawned processes build
               the kernels into an empty directory; both must load the
               one library path and launch a correct forward
               (procs_cold_build).
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
               steps under the Myrmics runtime) and ``--backend procs
               --shards 2 --smoke --steps 20``: exit 0, losses falling.
12. train_myrmics -- full-width qwen2-0.5B (bf16) trained under the
               Myrmics runtime, ``run_myrmics_training(backend="threads")``:
               2 gradient tasks of 2 x 512 tokens a step on 2 workers,
               then the update task.  Losses finite, the first near
               ln(vocab); launch counts 2·L·steps·shards forward and
               L·steps·shards backward; every task done, as many as the
               same DAG runs on ``backend="sim"`` on the CPU.  Host ms a
               step beside the train phase's, message counts, peak
               memory of each step.
13. train_myrmics_parity -- 2 layers, f32, 3 steps: the card on
               ``threads`` against the CPU on ``sim`` (losses and final
               parameters within 1e-4 of each leaf's largest magnitude),
               and the card on ``sim`` against the card on ``threads``
               (identical bits).
14. train_myrmics_procs -- full-width qwen2-0.5B (bf16) under the
               runtime on ``backend="procs"``: the tasks in 2 spawned
               worker processes, every object shipped to them as CPU
               tensors.  Hosted by ``python chip_smoke.py --procs-train``,
               a process that sets up no CUDA; its workers import this
               file and log their launches.  Launches 2·L·steps·shards
               forward and L·steps·shards backward in the workers, none in
               the host; tasks done as on sim; the card's compute apps
               grow by the 2 workers.  Prints step ms beside the loop's
               and the threads runtime's at the same depth (run after it
               in this process), bytes shipped a step by frame kind and
               by task kind and direction, RSS.
15. procs_start -- ``python chip_smoke.py --procs-start``: workers forked
               (forced) and spawned from a host without CUDA, each making
               a CUDA call, timed; forked after ``torch.cuda.is_available()``
               they must fail the run.
16. train_myrmics_procs_parity -- the parity setup (13) on procs against
               the card on threads: within 1e-4, identical bits wanted.
17. faults_procs -- the same with one worker process killed in step 1 by
               the runtime's ``FaultPlan``, at the middle of the task it
               ran longest in 16's run: one worker killed, a task
               replayed, final losses and parameters identical to 16's.

Every counted run (3, 5, 7, 12, 14) sets every kernel's launch counter
to 0 just before it and reads all of them just after (14: the workers'
logs, in a fresh directory).  The line before the
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
# the procs phases.  Every object crosses the wire at every task, at ~5 s
# a GB on the card's host (PERF.md), so they are cut to fit the smoke:
# the full-width run to 2 layers and 3 steps (2 warm), the parity and
# fault runs to 2 steps (the kill lands in step 1).  ``python
# chip_smoke.py --procs-train <out.json> <layers> <steps>`` runs the
# full-width host alone at any depth.  A worker process of the
# full-width run logs its kernel launches to a file of its own in the
# directory CHILD_LOG_ENV names (set only for the process hosting it).
PROCS_LAYERS, PROCS_STEPS, PROCS_PARITY_STEPS = 2, 3, 2
CHILD_LOG_ENV, PROCS_TIMEOUT_S = "CHIP_SMOKE_CHILD_LOG", 900
# the kernel counter that each wrapper's name stands for
COUNTER_OF = {"flash_attention": "flash_attention_fwd", "decode_attention": "decode_attention",
              "flash_attention_bwd": "flash_attention_bwd", "mamba_scan": "mamba_scan"}

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


def _parity_setup(get_config):
    """The parity runs' config (2 layers, f32) and optimizer (eps 1e-2)."""
    from repro_torch.optim import AdamW
    cfg = replace(get_config(ARCH), n_layers=PARITY_LAYERS, param_dtype="float32",
                  compute_dtype="float32")
    return cfg, AdamW(lr=1e-3, warmup_steps=1, total_steps=MYRMICS_PARITY_STEPS, eps=1e-2)


def _parity_run(LM, cfg, opt, device, backend, runtime, kept,
                steps: int = MYRMICS_PARITY_STEPS) -> tuple:
    """One parity run from the weights drawn on the CPU (moved to
    ``device``), scheduled by ``runtime``, a ``Myrmics`` subclass that
    appends each instance to ``kept``: (losses, final parameters on the
    CPU by key, run report)."""
    from repro_torch.train import orchestrator
    from repro_torch.tree import flatten_with_keys, tree_map
    init, base = LM.init, orchestrator.Myrmics

    def cpu_init(self, seed=0):
        return tree_map(lambda x: x.to(self.device), init(LM(self.cfg, device="cpu"), seed))

    LM.init, orchestrator.Myrmics = cpu_init, runtime
    try:
        rep, run_rep = orchestrator.run_myrmics_training(
            cfg, seq_len=PARITY_SEQ, global_batch=TRAIN_BATCH, steps=steps,
            n_shards=MYRMICS_SHARDS, seed=3, opt=opt, backend=backend, device=device)
    finally:
        LM.init, orchestrator.Myrmics = init, base
    params = dict(flatten_with_keys(kept[-1].labelled_storage()["params"]))
    return rep.losses, {k: v.cpu() for k, v in params.items()}, run_rep


def phase_train_myrmics_parity(torch, get_config, LM) -> tuple:
    """2 layers, f32, 3 steps under the runtime from the same weights (drawn
    on the CPU, moved to the card): the card on threads against the CPU on
    sim, and the card on sim against the card on threads.  eps = 1e-2 as
    in ``phase_train_parity``: Adam's first step is otherwise the sign of
    g, which flips between two correct runs wherever g is near 0.
    Returns the card's threads run's losses, and its parameters after
    ``PROCS_PARITY_STEPS`` steps (a run of its own) for the procs parity."""
    from repro_torch.core import Myrmics
    cfg, opt = _parity_setup(get_config)
    kept = []

    class Recording(Myrmics):
        """Keeps each runtime, so its final object store can be read."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            kept.append(self)

    out = {}
    for device, backend in (("cuda", "threads"), ("cuda", "sim"), ("cpu", "sim")):
        losses, params, run_rep = _parity_run(LM, cfg, opt, device, backend, Recording, kept)
        out[device, backend] = (losses, params, run_rep.tasks_done)
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
    losses, params, _ = _parity_run(LM, cfg, opt, "cuda", "threads", Recording, kept,
                                    PROCS_PARITY_STEPS)
    return losses, params


def phase_train_myrmics_procs_parity(torch, get_config, LM, threads_run) -> dict:
    """The parity setup on procs, its workers spawned from this process
    (which holds a CUDA context), against the card on threads: the same
    kernels on the same card, and a copy through the CPU changes no bit,
    so identical bits are wanted; within 1e-4 of each leaf's largest
    magnitude and of each loss is required.  Returns the procs run's
    losses, parameters and stamps for ``phase_faults_procs``."""
    from repro_torch.core import Myrmics
    cfg, opt = _parity_setup(get_config)
    kept, stamps, traffic = [], [], {}
    t0 = time.perf_counter()
    losses, params, run_rep = _parity_run(LM, cfg, opt, "cuda", "procs",
                                          _instrumented(Myrmics, kept, stamps, traffic), kept,
                                          PROCS_PARITY_STEPS)
    wall = time.perf_counter() - t0
    tl, tp = threads_run
    rel = lambda a, b: ((a - b).abs().max() / (b.abs().max() + 1e-30)).item()
    leaf_err = {k: rel(params[k], tp[k]) for k in tp}
    loss_err = [abs(a - b) / abs(b) for a, b in zip(losses, tl, strict=True)]
    bits = losses == tl and all(torch.equal(params[k], tp[k]) for k in tp)
    tol = 1e-4
    ok = (max(leaf_err.values()) <= tol and max(loss_err) <= tol
          and run_rep.tasks_done == run_rep.tasks_spawned)
    emit({"phase": "train_myrmics_procs_parity", "arch": ARCH, "n_layers": PARITY_LAYERS,
          "dtype": "float32", "seq_len": PARITY_SEQ, "global_batch": TRAIN_BATCH,
          "n_shards": MYRMICS_SHARDS, "steps": PROCS_PARITY_STEPS,
          "losses_cuda_procs": losses, "losses_cuda_threads": tl, "loss_rel_err": loss_err,
          "max_leaf_rel_err": max(leaf_err.values()),
          "worst_leaf": max(leaf_err, key=leaf_err.get), "tol": tol,
          "identical_bits": bits, "tasks_done": run_rep.tasks_done,
          "tasks_spawned": run_rep.tasks_spawned, "wall_s": wall,
          "step_ms": _step_ms(stamps, PROCS_PARITY_STEPS),
          "wire_total_bytes": run_rep.wire_summary()["total_bytes"],
          "traffic_by_task": {k: {"frames": f, "bytes": b} for k, (f, b) in sorted(traffic.items())},
          "stamps": stamps, "ok": ok})
    if not ok:
        raise AssertionError("the card on procs and on threads disagree")
    return {"losses": losses, "params": params, "stamps": stamps}


def phase_faults_procs(torch, get_config, LM, clean) -> None:
    """The parity setup on procs with one worker process killed in step 1
    by the runtime's fault plan (``FaultPlan(kills=...)`` with region
    snapshots), through a ``Myrmics`` subclass.  The victim is a worker
    that does not host ``main`` (a suspended ``main`` dies with its
    process, unrecoverably): the one that ran the longest task of step 1
    in the uninjected run, killed at that task's middle, so that the kill
    lands on a task in flight although a run's clock moves by a tenth
    between runs.  What the victim had queued or in flight replays on the
    survivor, and at least one task must replay; the tasks are pure and a
    killed worker's writes never reach the host, so the final losses and
    parameters must equal the uninjected run's bits."""
    import tempfile
    from repro_torch.core import Myrmics
    from repro_torch.core.faults import FaultPlan
    stamps = clean["stamps"]
    done = {name: t for t, what, name, _ in stamps if what == "done"}
    starts = {name: (t, w) for t, what, name, w in stamps if what == "start"}
    main_worker = starts["main"][1]
    lo, hi = done["upd0"], done["upd1"]
    step1 = [(done[name] - t, name, w) for name, (t, w) in starts.items()
             if lo <= t and w != main_worker and name in done]
    if not step1:
        raise AssertionError(f"no task of step 1 ran off main's worker {main_worker} "
                             f"in the uninjected run: nothing to kill ({stamps})")
    _, target, victim = max(step1)
    at = (starts[target][0] + done[target]) / 2
    cfg, opt = _parity_setup(get_config)
    kept, st, traffic = [], [], {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_snapshots_") as snaps:
        plan = FaultPlan(snapshot_dir=snaps, kills=((victim, at),))
        losses, params, run_rep = _parity_run(
            LM, cfg, opt, "cuda", "procs", _instrumented(Myrmics, kept, st, traffic, plan), kept,
            PROCS_PARITY_STEPS)
    fs = run_rep.fault_summary()
    bits = losses == clean["losses"] and all(torch.equal(params[k], clean["params"][k])
                                             for k in clean["params"])
    # what the victim had started and not finished when the kill fired
    done2 = {name: t for t, what, name, _ in st if what == "done"}
    in_flight = [name for t, what, name, w in st
                 if what == "start" and w == victim and t <= at < done2.get(name, math.inf)]
    ok = (fs["workers_killed"] == 1 and fs["tasks_replayed"] >= 1 and bits
          and run_rep.tasks_done == run_rep.tasks_spawned)
    emit({"phase": "faults_procs", "arch": ARCH, "n_layers": PARITY_LAYERS, "dtype": "float32",
          "steps": PROCS_PARITY_STEPS, "victim": victim, "main_worker": main_worker,
          "kill_at_s": at, "step1_window_s": [lo, hi], "target_task": target,
          "victim_in_flight_at_kill": in_flight,
          "fault_summary": fs, "dead_workers": sorted(kept[-1].dead_workers),
          "losses": losses, "losses_uninjected": clean["losses"], "identical_bits": bits,
          "tasks_done": run_rep.tasks_done, "tasks_spawned": run_rep.tasks_spawned,
          "stamps": st, "ok": ok})
    if not ok:
        raise AssertionError("the run with a killed worker differs from the clean run, "
                             "or the kill did not land on a task in flight")


# ---------------------------------------------------------------------------
# the procs backend: task bodies in spawned worker processes
# ---------------------------------------------------------------------------


def _log_child_launches(directory: str) -> None:
    """In a worker process of the full-width procs run: each kernel launch
    also appends the kernel's name and the process's peak device bytes so
    far to ``<directory>/<pid>.log``."""
    import torch
    from repro_torch.kernels import _build
    count, path = _build.count_launch, os.path.join(directory, f"{os.getpid()}.log")

    def logged(wrapper):
        count(wrapper)
        with open(path, "a") as f:
            f.write(f"{wrapper.__name__} {torch.cuda.max_memory_allocated()}\n")
    _build.count_launch = logged


def _child_launches(directory: str) -> tuple[dict, dict]:
    """(launches by counter summed over the worker processes, each process's
    peak device bytes at its last launch), from the logs above."""
    launches, peaks = dict.fromkeys(COUNTER_OF.values(), 0), {}
    for name in sorted(os.listdir(directory)):
        lines = Path(directory, name).read_text().split()
        for wrapper, peak in zip(lines[::2], lines[1::2]):
            launches[COUNTER_OF[wrapper]] += 1
            peaks[name.removesuffix(".log")] = int(peak)
    return launches, peaks


def _instrumented(base, kept: list, stamps: list, traffic: dict, faults=None):
    """A ``Myrmics`` subclass for the procs phases: it keeps each runtime;
    stamps each shipped task's start and each completion with the run's
    clock (``rt.sub.now``) as (seconds, "start" or "done", task, worker);
    adds each frame's bytes, as the backend counts them, to
    ``traffic["<out|in>:<task kind>"]`` (grad, upd, main); and passes
    ``faults`` to the runtime."""
    import threading

    class Instrumented(base):
        def __init__(self, *args, **kwargs):
            if faults is not None:
                kwargs["faults"] = faults
            super().__init__(*args, **kwargs)
            kept.append(self)
            agent, sub, last, lock = self.worker_agent, self.sub, threading.local(), \
                threading.Lock()
            note, send, handle, done = (sub._note_wire, sub.send_frame, sub._handle_frame,
                                        agent.on_complete)

            def name_of(tid):
                with agent._qlock:
                    entry = agent._inflight.get(tid)
                return entry[0].name if entry else "?"

            def add(direction, name):
                key = f"{direction}:{name.rstrip('0123456789.')}"
                with lock:
                    rec = traffic.setdefault(key, [0, 0])
                    rec[0] += 1
                    rec[1] += getattr(last, "nbytes", 0)
                last.nbytes = 0

            def noted(kind, nbytes, wid, outbound):
                last.nbytes = nbytes
                note(kind, nbytes, wid, outbound)

            def sent(wid, msg):
                if msg.kind == "x_exec":
                    name = msg.args[0][5]
                    stamps.append((sub.now, "start", name, wid))
                elif msg.kind == "x_resume":
                    name = name_of(msg.args[0])
                else:
                    task = agent.last_task_of(wid)
                    name = task.name if task is not None else "?"
                last.nbytes = 0
                send(wid, msg)
                add("out", name)

            def handled(ch, msg):
                add("in", name_of(msg.args[0]) if msg.args else "?")
                handle(ch, msg)

            def completed(w, tid):
                name = name_of(tid)
                done(w, tid)
                stamps.append((sub.now, "done", name, w.core_id))

            sub._note_wire, sub.send_frame, sub._handle_frame = noted, sent, handled
            agent.on_complete = completed

    return Instrumented


def _step_ms(stamps: list, steps: int) -> list[float]:
    """Warm step times: the intervals between the update tasks' completions."""
    done = {name: t for t, what, name, _ in stamps if what == "done"}
    ends = [done[f"upd{step}"] for step in range(steps)]
    return [1e3 * (b - a) for a, b in zip(ends, ends[1:])]


def procs_train_host(out_path: str, n_layers: str = str(PROCS_LAYERS),
                     steps: str = str(PROCS_STEPS)) -> None:
    """The host of ``train_myrmics_procs``, a process of its own that
    touches no CUDA itself: full-width qwen2-0.5B at ``n_layers`` layers
    through ``run_myrmics_training(backend="procs")`` for ``steps``
    steps.  Writes its readings as JSON to ``out_path``; its own kernel
    counters must stay at 0."""
    import resource
    import threading

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.train import orchestrator

    counters = {"flash_attention_fwd": fa.flash_attention, "decode_attention": dec.decode_attention,
                "flash_attention_bwd": fb.flash_attention_bwd, "mamba_scan": ms.mamba_scan}
    smi_apps = ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"]

    def apps():
        out = subprocess.run(smi_apps, capture_output=True, text=True).stdout
        return [line.strip() for line in out.splitlines() if line.strip()]

    polls, free_gb, stop = [], [], threading.Event()

    def poll():
        while not stop.wait(1.0):
            polls.append(apps())
            with open("/proc/meminfo") as f:
                free_gb.append(next(int(line.split()[1]) for line in f
                                    if line.startswith("MemAvailable")) / 2**20)
            if len(polls) % 30 == 0:        # progress, shown if the phase fails
                print(f"{len(polls)} s: last stamp {stamps[-1:]}, "
                      f"{free_gb[-1]:.1f} GB available", flush=True)

    kept, stamps, traffic = [], [], {}
    orchestrator.Myrmics = _instrumented(orchestrator.Myrmics, kept, stamps, traffic)
    cfg, steps = replace(get_config(ARCH), n_layers=int(n_layers)), int(steps)
    for fn in counters.values():
        fn.launches = 0
    before = apps()
    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    t0 = time.perf_counter()
    try:
        rep, run_rep = orchestrator.run_myrmics_training(
            cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, steps=steps,
            n_shards=MYRMICS_SHARDS, seed=0, backend="procs", device="cuda")
    finally:
        stop.set()
        poller.join()
    wall = time.perf_counter() - t0
    rt = kept[0]
    result = {
        "n_layers": cfg.n_layers, "steps": steps,
        "losses": rep.losses, "wall_s": wall, "runtime_wall_s": run_rep.total_cycles,
        "step_ms": _step_ms(stamps, steps), "stamps": stamps,
        "tasks_spawned": run_rep.tasks_spawned, "tasks_done": run_rep.tasks_done,
        "tasks_by_worker": {w: s.tasks_executed for w, s in run_rep.workers.items()},
        "proc_report": rt.sub.proc_report(), "wire": run_rep.wire_summary(),
        "traffic_by_task": {k: {"frames": f, "bytes": b} for k, (f, b) in sorted(traffic.items())},
        "host_launches": {name: fn.launches for name, fn in counters.items()},
        "host_cuda_initialized": torch.cuda.is_initialized(),
        "host_peak_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
        "workers_peak_rss_gb": resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / 2**20,
        "compute_apps_before": before, "compute_apps_during": polls,
        "host_min_available_gb": min(free_gb, default=None),
    }
    Path(out_path).write_text(json.dumps(result))


def _run_host(mode: str, timeout: float, env: dict | None = None) -> dict:
    """Run this file as ``python chip_smoke.py <mode> <out.json>`` in a
    process of its own; return what it wrote, or raise with its output."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_host_") as tmp:
        out = os.path.join(tmp, "out.json")
        try:
            r = subprocess.run([sys.executable, "-u", str(ROOT / "chip_smoke.py"), mode, out],
                               cwd=ROOT, capture_output=True, text=True, timeout=timeout,
                               env={**os.environ, **(env or {})})
        except subprocess.TimeoutExpired as e:
            raise AssertionError(f"{mode}: over {timeout} s\n{(e.stdout or b'')[-3000:]}") from e
        if r.returncode != 0 or not os.path.exists(out):
            raise AssertionError(f"{mode}: rc {r.returncode}\n{r.stdout[-3000:]}\n"
                                 f"{r.stderr[-6000:]}")
        return json.loads(Path(out).read_text())


def _same_depth_step_ms(torch, cfg) -> dict:
    """Mean warm step ms of the plain loop and of the threads runtime (2
    gradient tasks) at ``cfg``'s depth, at the procs phase's shape and
    steps: its step's yardsticks in this call, at its own depth."""
    from repro_torch.train import orchestrator
    from repro_torch.train.loop import train
    out = {}
    for path in ("loop", "threads"):
        stamps = []
        on_step = lambda step, loss: stamps.append(time.perf_counter())
        if path == "loop":
            train(cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, steps=PROCS_STEPS,
                  seed=0, device="cuda", on_step=on_step)
        else:
            orchestrator.run_myrmics_training(
                cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, steps=PROCS_STEPS,
                n_shards=MYRMICS_SHARDS, seed=0, backend="threads", device="cuda",
                on_step=on_step)
        torch.cuda.synchronize()
        step_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
        out[path] = sum(step_ms) / len(step_ms)
    return out


def phase_train_myrmics_procs(torch, get_config, counters) -> dict:
    """qwen2-0.5B at full width (bf16, ``PROCS_LAYERS`` layers) trained
    under the runtime on the procs backend: the gradient and update
    tasks in 2 spawned worker processes, every object shipped over the
    wire by its footprint.  The host is a fresh process that touches no
    CUDA; the workers log their launches (``_log_child_launches``).
    Its step is held beside the loop's and the threads runtime's at the
    same depth, run in this process after it.  Returns the workers'
    launch counts."""
    import tempfile
    from repro_torch.train import orchestrator
    cfg = replace(get_config(ARCH), n_layers=PROCS_LAYERS)
    torch.cuda.empty_cache()        # the workers are other processes on the same card
    with tempfile.TemporaryDirectory(prefix="chip_smoke_launches_") as logs:
        res = _run_host("--procs-train", PROCS_TIMEOUT_S, {CHILD_LOG_ENV: logs})
        launches, device_peaks = _child_launches(logs)
    _, sim_rep = orchestrator.run_myrmics_training(
        cfg.smoke(), seq_len=16, global_batch=TRAIN_BATCH, steps=PROCS_STEPS,
        n_shards=MYRMICS_SHARDS, backend="sim", device="cpu")
    same_depth = _same_depth_step_ms(torch, cfg)
    n_layers, tasks = cfg.n_layers, PROCS_STEPS * MYRMICS_SHARDS
    want = {**dict.fromkeys(counters, 0), "flash_attention_fwd": 2 * n_layers * tasks,
            "flash_attention_bwd": n_layers * tasks}
    losses, ln_vocab = res["losses"], math.log(cfg.padded_vocab)
    worker_pids = sorted(str(st["pid"]) for st in res["proc_report"].values())
    n_before = len(res["compute_apps_before"])
    n_during = max((len(p) for p in res["compute_apps_during"]), default=0)
    mean_ms = sum(res["step_ms"]) / len(res["step_ms"])
    traffic = res["traffic_by_task"]
    problems = []
    if launches != want:
        problems.append(f"worker launches {launches}, want {want}")
    if any(res["host_launches"].values()):
        problems.append(f"the host launched kernels: {res['host_launches']}")
    if not set(device_peaks) <= set(worker_pids):
        problems.append(f"launch logs of {sorted(device_peaks)}, workers {worker_pids}")
    if not all(math.isfinite(x) for x in losses) or len(losses) != PROCS_STEPS:
        problems.append(f"losses {losses}")
    elif abs(losses[0] - ln_vocab) > 0.5:
        problems.append(f"first loss {losses[0]} is not near ln(vocab) {ln_vocab}")
    if not res["tasks_done"] == res["tasks_spawned"] == sim_rep.tasks_done:
        problems.append(f"tasks: procs {res['tasks_done']} done of {res['tasks_spawned']}, "
                        f"sim {sim_rep.tasks_done}")
    if res["host_cuda_initialized"]:
        problems.append("the host set up a CUDA context")
    # nvidia-smi names processes by pids of another namespace here, so the
    # check counts them: this process's context, then one per worker
    if n_during != n_before + MYRMICS_SHARDS:
        problems.append(f"compute apps: {n_before} before the run, at most {n_during} during it, "
                        f"want {n_before + MYRMICS_SHARDS}")
    per_step = {k: v["bytes"] / PROCS_STEPS for k, v in traffic.items()}
    emit({"phase": "train_myrmics_procs", "arch": ARCH, "n_layers": n_layers,
          "d_model": cfg.d_model, "dtype": cfg.param_dtype, "seq_len": TRAIN_SEQ,
          "global_batch": TRAIN_BATCH, "n_shards": MYRMICS_SHARDS, "steps": PROCS_STEPS,
          "backend": "procs", "losses": losses, "ln_padded_vocab": ln_vocab,
          "step_ms": res["step_ms"], "mean_step_ms": mean_ms,
          "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / mean_ms * 1e3,
          # the loop and the threads runtime at this depth, in this process
          "loop_mean_step_ms": same_depth["loop"],
          "threads_mean_step_ms": same_depth["threads"],
          "step_ms_over_loop": mean_ms / same_depth["loop"],
          "step_ms_over_threads": mean_ms / same_depth["threads"],
          "wall_s": res["wall_s"], "runtime_wall_s": res["runtime_wall_s"],
          "stamps": res["stamps"], "launches": launches, "launches_wanted": want,
          "host_launches": res["host_launches"], "tasks_spawned": res["tasks_spawned"],
          "tasks_done": res["tasks_done"], "sim_tasks_done": sim_rep.tasks_done,
          "tasks_by_worker": res["tasks_by_worker"], "proc_report": res["proc_report"],
          "wire_total_bytes": res["wire"]["total_bytes"],
          "wire_bytes_per_step": res["wire"]["total_bytes"] / PROCS_STEPS,
          "wire_per_kind": res["wire"]["per_kind"], "traffic_by_task": traffic,
          "bytes_per_step_by_task": per_step,
          "worker_peak_device_gb_at_last_launch": {k: v / 1e9 for k, v in device_peaks.items()},
          "host_peak_rss_gb": res["host_peak_rss_gb"],
          "workers_peak_rss_gb": res["workers_peak_rss_gb"],
          "machine_min_available_gb": res["host_min_available_gb"],
          "host_cuda_initialized": res["host_cuda_initialized"],
          "compute_apps_before": res["compute_apps_before"],
          "compute_apps_max_during": n_during,
          "compute_apps_during_last": res["compute_apps_during"][-3:],
          "ok": not problems})
    if problems:
        raise AssertionError("; ".join(problems))
    return launches


def _probe_cuda(c, out):
    """A task body: the first CUDA operation of its worker process, timed."""
    import torch
    t = time.time()
    value = float(torch.ones(4, device="cuda").sum().item())
    c.write(out, [value, t, time.time(), os.getpid()])


def _start_probe_app(ctx, root):
    from repro_torch.core import InOut, Out
    started = ctx.alloc(8, root, label="main_started")
    ctx.write(started, time.time())
    for o in ctx.balloc(8, root, 2, label="probe"):
        ctx.spawn(_probe_cuda, [Out(o)])
    yield ctx.wait([InOut(root)])


def procs_start_host(out_path: str) -> None:
    """The host of ``procs_start``, a process of its own: a 2-worker procs
    run whose tasks each make a CUDA call, with the workers forked (forced)
    from this process while it has set up no CUDA, then spawned (the
    port's rule), then forked after ``torch.cuda.is_available()``.  Writes
    each case's seconds and outcome to ``out_path``."""
    import torch
    from repro_torch.core import Myrmics, backend_procs
    result = {}
    for case in ("fork", "spawn", "fork_after_is_available"):
        if case == "fork_after_is_available":
            result["is_available"] = torch.cuda.is_available()
            result["is_initialized_after_is_available"] = torch.cuda.is_initialized()
        backend_procs.START_METHOD = "spawn" if case == "spawn" else "fork"
        rt = Myrmics(n_workers=2, sched_levels=[1], backend="procs", max_wall_s=120.0)
        t0 = time.time()
        try:
            rt.run(_start_probe_app)
        except Exception as e:      # the last case must fail: its outcome is the reading
            result[case] = {"ok": False, "run_s": time.time() - t0,
                            "error": f"{type(e).__name__}: {e}"[:400]}
            continue
        store = rt.labelled_storage()
        probes = [store[f"probe[{i}]"] for i in range(2)]
        result[case] = {"ok": all(p[0] == 4.0 for p in probes), "run_s": time.time() - t0,
                        "first_body_s": store["main_started"] - t0,
                        "first_cuda_call_s": [p[2] - p[1] for p in probes],
                        "probe_done_s": [p[2] - t0 for p in probes]}
    result["host_cuda_initialized"] = torch.cuda.is_initialized()
    Path(out_path).write_text(json.dumps(result))


def phase_procs_start(torch) -> None:
    """How the procs backend's worker processes start: forked and spawned
    from a host that has set up no CUDA, and forked after
    ``torch.cuda.is_available()``, which must fail the run (its workers
    cannot use the card; the port therefore always spawns)."""
    res = _run_host("--procs-start", 300)
    ok = (res["fork"]["ok"] and res["spawn"]["ok"]
          and not res["fork_after_is_available"]["ok"]
          and "CUDA" in res["fork_after_is_available"]["error"]
          and not res["is_initialized_after_is_available"])
    emit({"phase": "procs_start", **res, "ok": ok})
    if not ok:
        raise AssertionError(f"procs start: {res}")


def _cold_build_child(build_root: str, queue) -> None:
    """One of two processes started together on an empty build directory:
    build and load the kernels there, launch the forward once on the card
    and compare it with its plain version."""
    try:
        import torch
        from repro_torch.kernels import _build
        from repro_torch.kernels import flash_attention as fa
        _build.BUILD_ROOT = Path(build_root)
        t0 = time.perf_counter()
        _build.library()
        build_s = time.perf_counter() - t0
        gen = torch.Generator(device="cuda").manual_seed(os.getpid())
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for shape in ((1, 64, 4, 64), (1, 64, 2, 64), (1, 64, 2, 64)))
        err = max_err(fa.flash_attention(q, k, v, causal=True),
                      fa.flash_attention_plain(q, k, v, True)[0])
        with open("/proc/self/maps") as f:
            fields = next(line for line in f if "libkernels" in line).split(maxsplit=5)
        # " (deleted)": the other process replaced the file after this one
        # mapped it; the mapping stays valid
        path = fields[5].strip()
        queue.put({"pid": os.getpid(), "library": path.removesuffix(" (deleted)"),
                   "replaced_after_load": path.endswith(" (deleted)"),
                   "inode": int(fields[4]), "build_s": build_s, "max_abs_err": err})
    except BaseException as e:
        queue.put({"pid": os.getpid(), "error": f"{type(e).__name__}: {e}"[-1500:]})


def start_cold_build():
    """Start the two cold-build processes (spawned; they build while this
    process builds the library the other phases use)."""
    import multiprocessing
    import tempfile
    root = tempfile.mkdtemp(prefix="chip_smoke_cold_build_")
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_cold_build_child, args=(root, queue)) for _ in range(2)]
    for p in procs:
        p.start()
    return root, queue, procs


def phase_procs_cold_build(cold) -> None:
    """Two processes that start together on a cold build directory both
    load the one library path and launch a correct kernel."""
    import shutil
    root, queue, procs = cold
    try:
        got = [queue.get(timeout=600) for _ in procs]
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
        shutil.rmtree(root, ignore_errors=True)
    ok = (all("error" not in g and g["max_abs_err"] <= TOL["bfloat16"] for g in got)
          and len({g.get("library") for g in got}) == 1)
    emit({"phase": "procs_cold_build", "children": got,
          "libraries": sorted({str(g.get("library")).removeprefix(root) for g in got}),
          "tol": TOL["bfloat16"], "ok": ok})
    if not ok:
        raise AssertionError(f"cold build: {got}")


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
            # and in worker processes, on the smoke config
            "train_example_procs": ([sys.executable, "-u", "examples/train_lm_torch.py",
                                     "--backend", "procs", "--shards", "2", "--arch", ARCH,
                                     "--smoke", "--steps", str(EXAMPLE_STEPS)], None),
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
                                                               "done (threads backend",
                                                               "done (procs backend"))
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
    cold = start_cold_build()       # two processes building into an empty directory meanwhile
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
    phase_procs_cold_build(cold)

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
    threads_run = phase_train_myrmics_parity(torch, get_config, LM)
    runs.append(phase_train_myrmics_procs(torch, get_config, counters))
    phase_procs_start(torch)
    clean = phase_train_myrmics_procs_parity(torch, get_config, LM, threads_run)
    phase_faults_procs(torch, get_config, LM, clean)
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


# the hosts of the procs phases, each a process of its own
HOSTS = {"--procs-train": procs_train_host, "--procs-start": procs_start_host}

if __name__ == "__mp_main__" and os.environ.get(CHILD_LOG_ENV):
    # a worker process spawned by the full-width procs run imports this
    # file as its __mp_main__: log the kernels it launches
    _log_child_launches(os.environ[CHILD_LOG_ENV])

if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] in HOSTS:
        HOSTS[sys.argv[1]](*sys.argv[2:])
        sys.exit(0)
    sys.exit(main())
