"""Chip smoke test for the PyTorch / CUDA port (`src/repro_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package. Phases, each fatal:
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel of the serving and training paths from the sources
     in the checkout, one nvcc per source, all at once (`kernels/
     flash_attention/csrc/flash_attention.cu`, `kernels/midx_probs/csrc/
     midx_probs.cu`, `kernels/sampled_ce/csrc/sampled_ce_pt.cu` and
     `sampled_ce.cu`, `kernels/rff_sample/csrc/rff_sample.cu`, `kernels/
     ssd_scan/csrc/ssd_scan.cu`), and print what ptxas says; for the
     flash, ssd_scan and shared-CE libraries, each kernel's registers and
     spills (a spill in a tensor-core kernel fails the run: flash's bf16
     kernels, the scan's kernels but its carry, the shared CE's forward
     partials and backward) and, where `cuobjdump` is on the machine, the
     count of HGMMA (wgmma; flash) or HMMA (mma.sync; the 3xTF32 scan and
     shared CE) instructions in each kernel's SASS (none in a tensor-core
     kernel fails the run; without `cuobjdump`, "not checked");
  3. hold each kernel against its plain torch version on the card, at the
     main paths' shapes and a sweep around them (the per-token CE also
     with one id taking about half of the occurrences), with TF32 off; both
     sampled-CE backwards, the shared CE's forward and the RFF sampler
     must also repeat bit for bit, the sampler's ids may differ from the
     plain version's only at near-ties, and each row of a `midx_probs` call
     must equal, bit for bit, that row alone (T = 1) inside calls of T = 4,
     8, 33 and 512 rows; time each kernel and its plain version with CUDA
     events (median of 50 cold-L2 launches) beside the bound (bytes over
     3.35 TB/s, operations over 67 TFLOP/s fp32; for the shared CE and the
     scan, matrix products over 3xTF32's 165 TFLOP/s, with the all-fp32
     bound beside it), the shared CE also at `train_4k`'s shape (B=2,
     S=4096, M=1024, D=2048), and the fp32 bmm of the shared CE's logit
     product as a reference point;
 3b. hold the flash-attention forward against its plain version, TF32 off:
     a sweep (fp32/bf16, hd 50/64/128, four (H, KV), S 128..2048, causal
     on/off, window None/16, Sq < Sk, rows with no allowed key), every
     case bitwise repeatable; at the main shapes (llama3.2-1b prefill B=4,
     S=2048 and 4096; B=1, S=32768) batched == solo bit for bit, and the
     times of the kernel, its plain version and SDPA (the library call)
     beside the bound (bf16 operations at 989 TFLOP/s on the tensor
     cores), with the kernel's achieved TFLOP/s (the bound's operations
     over its time), its share of the bound and its time over SDPA's; the
     bf16 kernel's two load routes (TMA, and plain loads for unaligned
     tensors) give the same bits at hd 64 and 128;
 3c. hold the SSD scan against its plain version, TF32 off: a sweep (chunk
     Q in {8, 13, 64, 256} and Q = S; (N, P) in {16, 128} x {16, 64}, and
     N=30, P=50 (the plain-load route); Bt 1-4, H 3 and 32; adt as
     `tests/test_ssd_kernel.py` draws it, and a steep case, adt ~ -20 a
     step at Q = 256, where the masked exponentials would overflow), y and
     h_last within
     1e-4·max(1, |plain|), every case bitwise repeatable and row b of a
     batch equal to that row alone; then the times of the kernel and its
     plain version beside the bound (products over 165 TFLOP/s, the rest
     over 67, with the all-fp32 bound beside it) at mamba2-370m's
     training shape (Bt=4, S=1024, H=32, P=64, N=128,
     Q=256) and its prefill shapes (4 x 512, Q=256; 4 x 64, Q=64);
  4. check the port against itself on the CPU at a small input (prefill
     hidden states, fp32; paper-lm and the reduced mamba2);
  5. serve `paper-lm` at full width through the MIDX head (16 requests,
     4 slots, 16 tokens), with batched == solo on 2 requests;
  6. serve `llama3.2-1b` at full width through the MIDX head (8 requests,
     4 slots, prompt 64, 32 tokens), then once with the full head, greedy,
     batched == solo; then through the RFF proposal head (`rff-fused`, the
     same requests) from fresh params, with the peak device memory of the
     MIDX and the RFF serves;
 6b. serve `llama3.2-1b` at full width through the MIDX head with long
     prompts (2 of 2048 and 2 of 4096 tokens, 16 tokens each, 4 slots,
     page 16): whole-prompt prefill through the flash kernel, batched ==
     solo on one request of each length, tok/s, p50/p99, prefill latency
     per length and peak memory;
  7. train `paper-lm` at full width through `launch.train.train_loop` with
     the per-token MIDX head (120 steps, batch 16, seq 64, lr 3e-3, index
     refreshes after steps 49 and 99): every step finite and applied, the
     last 5 steps' mean loss more than 0.1 below the first 5's; then two
     more 30-step runs (refresh every 10) must agree bit for bit — losses,
     params, optimizer state and index; the per-token backward at the last
     step's own inputs held to its plain version, repeated bit for bit and
     timed beside it, and the step's ids saved (`TRAIN_IDS`) for
     `scripts/head_kernel_times.py`; serve the trained model (8
     requests, 16 tokens), with batched == solo on 2;
  8. train `llama3.2-1b` at full width (16 layers, d=2048, V=128 256) with
     its own pooled head (RQ, K=64, M=1024) through `train_loop`: 60 steps
     of 4 x 256 tokens from 32 ZipfLM sequences, lr 1e-3, refreshes after
     steps 24 and 49, the same finite / applied / loss-drop checks, and
     the peak device memory; serve the trained params and index (4
     requests, 16 tokens) with batched == solo on 2; two 10-step runs at
     2 layers (refresh every 5) must agree bit for bit; 5 steps at 2
     layers with the mixture proposal must stay finite and launch both
     shared-CE kernels;
  9. the RFF proposal (`head="rff-fused"`): train `paper-lm` at full width
     with its per-token proposal (M=20), 120 steps, batch 16, seq 64, lr
     3e-3, φ(C) re-mapped after steps 49 and 99, with the same finite /
     applied / loss-drop checks, then serve the trained params and
     proposal state (8 requests, 16 tokens) with batched == solo on 2;
     two 10-step runs of `llama3.2-1b` cut to 2 layers with its pooled
     head (M=1024, 4 x 256 tokens, refresh every 5) must agree bit for
     bit, losses, params, optimizer state and proposal state;
 10. train_4k: `llama3.2-1b` at full width and depth (16 layers), with
     its pooled head, 20 steps of batch 2 x seq 4096 (2 x 4097
     tokens cut from phase 8's corpus),
     lr 1e-3, refresh every 10, with the same checks, the median step,
     tokens/s and peak memory; `flash_attention`, `sampled_ce` and
     `sampled_ce_bwd` all launched; two 5-step runs at 2 layers and seq
     4096 (refresh every 3) agree bit for bit;
 11. serve `mamba2-370m` at full width (48 layers, d=1024, V=50 280,
     N=128, P=64, H=32, chunk 256, tied embeddings) from random weights, 4
     slots: the MIDX head with 2 prompts of 64 tokens (one chunk of 64)
     and 2 of 512 (two chunks of 256), 16 tokens each, batched == solo on
     one of each length; then the full head, greedy, batched == solo; tok/s,
     p50/p99, prefill latency per length and peak memory; `ssd_scan`
     launched 48 times per prefill group;
 12. train `mamba2-370m` at full width with its own head (pooled MIDX, RQ
     K=64, M=1024) through `train_loop`: 30 steps of 4 x 1024 on the
     reference's default corpus (512 x 1025 ZipfLM sequences), lr 1e-3,
     refresh every 10, with the same finite / applied / loss-drop checks,
     the median step, tokens/s and peak memory, `ssd_scan` launched 48
     times a step and both shared-CE kernels launched; serve the trained params and index with batched == solo
     on 2; two 5-step runs cut to 2 layers agree bit for bit;
 13. print the kernels' JSON line, then the result line.
Each main-path run sets the kernels' launch counters to 0 just before it
and reads them just after; a kernel of the path that was never launched
fails the run. Exits non-zero, with no result line, without a CUDA device
or without the repository beside it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_S = 3.35e12          # H100 SXM device memory rate
FP32_FLOP_S = 67e12            # H100 SXM fp32 outside the tensor cores
TF32X3_FLOP_S = 495e12 / 3     # H100 SXM TF32 tensor rate over 3xTF32's three
                               # products: the fastest route known to hold 1e-4
REL_TOL = 1e-4                 # |kernel - plain| <= 1e-4 * max(1, |plain|)
LLAMA_STEPS, LLAMA_LR, LLAMA_REFRESH = 60, 1e-3, 25   # full-width training
LLAMA_CORPUS = 32              # ZipfLM sequences (host time: O(V) per token)
TRAIN_4K = 4096                # the repo's train_4k sequence length
MIDX_TS = (1, 4, 8, 33, 512, 1024)   # decode, prefill and training rows
MIDX_DK = ((200, 32), (1024, 64), (2048, 64))   # paper-lm, mamba2, llama
MIDX_SOLO = (4, 8, 33, 512)    # calls whose rows must equal the rows alone


def log(msg: str) -> None:
    print(msg, flush=True)


T_START = time.perf_counter()


def mark(phase: str) -> None:
    """Log the script time at the end of a phase."""
    log(f"[smoke] time: {phase} done at {time.perf_counter() - T_START:.1f}s")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def flash_label(mangled: str) -> str:
    got = re.search(r"flash_fwd_wgmma_kernelILi(\d+)ELb([01])E", mangled)
    if got:
        return (f"bf16 wgmma hd<={got[1]} "
                f"{'TMA' if got[2] == '1' else 'plain loads'}")
    got = re.search(r"flash_fwd_kernelILi(\d+)E", mangled)
    return f"fp32 SIMT hd<={got[1]}" if got else mangled[:60]


def kernel_label(mangled: str) -> str:
    """`ssd_out_kernel vec`, `bwd_w_kernel bf16 plain loads`, ... for the
    ssd_scan and shared-CE libraries' templated kernels."""
    got = re.search(r"\d((?:ssd|bwd|fwd)_[a-z]+_kernel)", mangled)
    if not got:
        return mangled[:60]
    name = got[1]
    if "bfloat16" in mangled:
        name += " bf16"
    elif re.search(r"kernelIf", mangled):
        name += " fp32"
    if "Lb1E" in mangled:
        name += " vec"
    elif "Lb0E" in mangled:
        name += " plain loads"
    return name


def check_kernel_build(lib, label, tensor_core, instr: str) -> None:
    """Phase 2 for a library: each kernel's registers and spills from ptxas
    and, where cuobjdump is on the machine, the count of `instr` (HGMMA for
    wgmma, HMMA for mma.sync) instructions in each kernel's SASS. A kernel
    for which `tensor_core(name)` holds fails the run if it spills or has
    no such instruction."""
    kernels, name = {}, None
    for line in lib.build_log.splitlines():
        got = re.search(r"Compiling entry function '(\S+)'", line)
        if got:
            name = label(got[1])
            kernels[name] = {}
        got = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        line)
        if got and name:
            kernels[name]["spills"] = int(got[1]) + int(got[2])
        got = re.search(r"Used (\d+) registers", line)
        if got and name:
            kernels[name]["registers"] = int(got[1])
    if not kernels:            # already built: nvcc printed nothing
        log(f"[smoke] {lib.name} ptxas: library was already built, "
            "registers and spills not printed")
    for name, k in kernels.items():
        log(f"[smoke] {lib.name} ptxas: {name}: {k.get('registers')} "
            f"registers, {k.get('spills')} bytes of spill stores + loads")
        if tensor_core(name) and k.get("spills", 0) > 0:
            raise SystemExit(f"{lib.name}: the {name} kernel spills")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        log(f"[smoke] {lib.name} SASS: cuobjdump not found, {instr} not "
            "checked")
        return
    sass = subprocess.run([tool, "-sass", str(lib.library_path())],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = label(line.split("Function :")[1].strip())
            counts[name] = 0
        elif name and re.search(rf"\b{instr}\b", line):
            counts[name] += 1
    log(f"[smoke] {lib.name} SASS {instr} instructions: " + ", ".join(
        f"{n} {c}" for n, c in sorted(counts.items())))
    tensor = {n: c for n, c in counts.items() if tensor_core(n)}
    if not tensor or min(tensor.values()) == 0:
        raise SystemExit(f"{lib.name}: a tensor-core kernel has no {instr} "
                         "instruction")


def roofline_ms(nbytes: float, ops: float, product_ops: float = 0.0):
    """The least time the card could take: the larger of the bytes over the
    memory rate, the matrix products' operations over 3xTF32's rate and the
    other operations over the fp32 rate (the tensor and CUDA cores run side
    by side); and which bounds it. Also the bound as PRs 11-17 took it, all
    operations over the fp32 rate."""
    b_ms = nbytes / HBM_BYTES_S * 1e3
    f_ms = max(product_ops / TF32X3_FLOP_S, ops / FP32_FLOP_S) * 1e3
    old = max(b_ms, (product_ops + ops) / FP32_FLOP_S * 1e3)
    return max(b_ms, f_ms), ("bytes" if b_ms >= f_ms else "operations"), old


def flush_l2(buf: torch.Tensor) -> None:
    buf.zero_()                # 128 MB > the 50 MB L2: evicts everything


def time_ms(fn, buf: torch.Tensor, reps: int = 50, warm: int = 5) -> float:
    """Median of `reps` single calls, each after an L2 flush, timed with
    CUDA events, after `warm` untimed calls."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        flush_l2(buf)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def midx_inputs(t: int, d: int, k: int, split: bool, seed: int):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dc = d // 2 if split else d
    z = torch.randn((t, d), generator=g, device="cuda")
    cb1 = 0.1 * torch.randn((k, dc), generator=g, device="cuda")
    cb2 = 0.1 * torch.randn((k, dc), generator=g, device="cuda")
    counts = torch.randint(0, 4, (k, k), generator=g, device="cuda")
    counts[:, 0] = 0           # empty joint clusters, as a real index has
    counts[1] = 0              # an empty k1 row
    return z, cb1, cb2, counts.float()


def midx_bound_ms(t: int, d: int, k: int, split: bool):
    dc = d // 2 if split else d
    nbytes = 4 * (t * d + 2 * k * dc + k * k + 3 * t * k + t)
    flops = 2 * t * k * dc * 2 + 2 * t * k * k
    b_ms, f_ms = nbytes / HBM_BYTES_S * 1e3, flops / FP32_FLOP_S * 1e3
    return max(b_ms, f_ms), ("bytes" if b_ms >= f_ms else "operations")


def check_midx_probs(cuda_mod, ref_fn, buf, card: str):
    """Phase 3 for midx_probs: sweep vs plain; time at the decode shape."""
    worst = 0.0
    for d, k in MIDX_DK:
        for split in (True, False):
            for t in MIDX_TS:
                z, cb1, cb2, counts = midx_inputs(t, d, k, split,
                                                  seed=t * 7 + d + k)
                got = cuda_mod.midx_probs_cuda(z, cb1, cb2, counts,
                                               split=split)
                want = ref_fn(z, cb1, cb2, counts, split=split)
                torch.cuda.synchronize()
                for name, a, b in zip(("s1", "s2", "log_psi", "lse"),
                                      got, want):
                    if a.shape != b.shape or not torch.isfinite(a).all():
                        raise SystemExit(f"midx_probs {name}: bad output "
                                         f"shape/values at T={t} D={d} K={k}")
                    err = (a - b).abs()
                    lim = REL_TOL * torch.clamp(b.abs(), min=1.0)
                    if bool((err > lim).any()):
                        raise SystemExit(
                            f"midx_probs {name} disagrees with the plain "
                            f"version at T={t} D={d} K={k} "
                            f"{'pq' if split else 'rq'}: max err "
                            f"{float(err.max()):.3e}")
                    worst = max(worst, float(err.max()))
    log(f"[smoke] midx_probs vs plain: max_abs_err={worst:.3e} over "
        f"(D,K) in {set(MIDX_DK)}, pq/rq, T in {MIDX_TS} "
        f"(tol {REL_TOL}*max(1,|ref|))")
    for d, k in MIDX_DK:       # a row's bits do not depend on T
        for split in (True, False):
            z, cb1, cb2, counts = midx_inputs(512, d, k, split, seed=d + k)
            outs = {t: cuda_mod.midx_probs_cuda(z[:t], cb1, cb2, counts,
                                                split=split)
                    for t in MIDX_SOLO}
            for r in (0, 3, 7, 32, 511):
                solo = cuda_mod.midx_probs_cuda(z[r:r + 1], cb1, cb2, counts,
                                                split=split)
                for t, got in outs.items():
                    if r < t and not all(torch.equal(a[0], b[r])
                                         for a, b in zip(solo, got)):
                        raise SystemExit(
                            f"midx_probs: row {r} alone differs from row {r}"
                            f" of a T={t} call at D={d} K={k} "
                            f"{'pq' if split else 'rq'}")
    log(f"[smoke] midx_probs: each row alone (T=1) equals that row of the "
        f"T in {MIDX_SOLO} calls bit for bit, over (D,K) in {set(MIDX_DK)}, "
        f"pq/rq")
    timings = {}
    for name, (t, d, k, split) in (
            ("paper-lm decode", (4, 200, 32, False)),
            ("llama3.2-1b decode", (4, 2048, 64, False)),
            ("llama3.2-1b T=8", (8, 2048, 64, False)),
            ("llama3.2-1b T=512", (512, 2048, 64, False)),
            ("llama3.2-1b decode pq", (4, 2048, 64, True)),
            ("mamba2-370m decode", (4, 1024, 64, False)),
            ("paper-lm train", (1024, 200, 32, False))):
        z, cb1, cb2, counts = midx_inputs(t, d, k, split, seed=1)
        ms = time_ms(lambda: cuda_mod.midx_probs_cuda(
            z, cb1, cb2, counts, split=split), buf)
        plain = time_ms(lambda: ref_fn(z, cb1, cb2, counts, split=split),
                        buf)
        bound, by = midx_bound_ms(t, d, k, split)
        timings[name] = (ms, plain, bound, by)
        log(f"[smoke] midx_probs {name} (T={t} D={d} K={k} "
            f"{'pq' if split else 'rq'}): kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {bound:.6f} ms ({by}); library: none; "
            f"on {card}")
    return worst, timings


def sce_inputs(t: int, d: int, m: int, v: int, dtype, seed: int,
               hot_row: bool = False):
    """Per-token sampled-CE inputs on the card, with duplicate ids within
    rows, ids repeated across rows and negative == positive collisions.
    hot_row: one id also takes every other negative from column 3 on and
    every other positive, about half of all occurrences: the long segment
    of the d(table) reduction that a frequent class gives a real step."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    h = 0.5 * torch.randn((t, d), generator=g, device="cuda")
    table = (0.1 * torch.randn((v, d), generator=g, device="cuda")).to(dtype)
    log_q = -9.0 + 0.5 * torch.randn((t, m), generator=g, device="cuda")
    neg = torch.randint(0, v, (t, m), generator=g, device="cuda")
    pos = torch.randint(0, v, (t,), generator=g, device="cuda")
    hot = torch.randint(0, v, (max(1, t // 4),), generator=g, device="cuda")
    pick = torch.randint(0, hot.numel(), (t, (m + 2) // 3), generator=g,
                         device="cuda")
    neg[:, ::3] = hot[pick]                     # repeats across rows
    neg[:, 1] = neg[:, 0]                       # duplicates within a row
    neg[::2, 2] = pos[::2]                      # collisions with the positive
    if hot_row:
        neg[:, 3::2] = hot[0]
        pos[1::2] = hot[0]
    grad = torch.rand((t,), generator=g, device="cuda")   # linear: order 1
    return h, table, log_q, neg, pos, grad


def sce_bound_ms(t: int, d: int, m: int, v: int, elem: int, neg, pos,
                 backward: bool):
    """Bytes: each input read once — the distinct table rows this run's ids
    gather, h, log_q, the ids (and g, lse) — and each output written once
    (loss and lse; or dh, dlq and the dense [V, D] fp32 d(table)). FLOPs:
    the (M+1)·D-long dots of every token, fp32 FMA (and, backward, the dh
    and d(table) sums, three times as many)."""
    rows = int(torch.unique(torch.cat([neg.reshape(-1), pos])).numel())
    nbytes = rows * d * elem + 4 * t * d + 4 * t * m + 8 * t * m + 8 * t
    if backward:
        nbytes += 8 * t + 4 * t * d + 4 * t * m + 4 * v * d
    else:
        nbytes += 8 * t
    flops = 2 * t * (m + 1) * d * (3 if backward else 1)
    b_ms, f_ms = nbytes / HBM_BYTES_S * 1e3, flops / FP32_FLOP_S * 1e3
    return max(b_ms, f_ms), ("bytes" if b_ms >= f_ms else "operations")


def sce_limit(ref: torch.Tensor) -> torch.Tensor:
    """1e-4 * max(|ref|, s) with s = min(1, max |ref| of the tensor): the
    bound 1e-4 * max(1, |ref|) where the tensor's values reach 1, scaled
    down to the tensor's own size where they stay below it (dlq, dh and
    d(table) at T = 1024), so a small wrong value cannot pass."""
    s = min(1.0, float(ref.abs().max()))
    return REL_TOL * torch.clamp(ref.abs(), min=max(s, 1e-30))


def hold_ce(label: str, kern_fwd, kern_bwd, ref_fwd, ref_bwd, args,
            g: torch.Tensor, bwd_names, where: str):
    """Run a sampled-CE kernel pair and its plain versions on `args`; the
    backward twice, which must agree bit for bit. Hold every output to
    `sce_limit`. Returns ((loss, lse), {"fwd": err, "bwd": err}, largest
    err/limit, readings)."""
    loss, lse = kern_fwd(*args)
    got = kern_bwd(g, *args, lse)
    again = kern_bwd(g, *args, lse)
    want_f = ref_fwd(*args)
    want_b = ref_bwd(g, *args, want_f[1])
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise SystemExit(f"{label}_bwd is not bitwise repeatable at {where}")
    worst, loosest, readings = {"fwd": 0.0, "bwd": 0.0}, 0.0, []
    for kind, names, outs, refs in (
            ("fwd", ("loss", "lse"), (loss, lse), want_f),
            ("bwd", bwd_names, got, want_b)):
        for name, a, b in zip(names, outs, refs):
            if a.shape != b.shape or not torch.isfinite(a).all():
                raise SystemExit(f"{label} {name}: bad output shape/values "
                                 f"at {where}")
            err = (a - b).abs()
            ratio = float((err / sce_limit(b)).max())
            if ratio > 1.0:
                raise SystemExit(
                    f"{label} {name} disagrees with the plain version at "
                    f"{where}: max err {float(err.max()):.3e}, {ratio:.3f} "
                    f"of the limit")
            worst[kind] = max(worst[kind], float(err.max()))
            loosest = max(loosest, ratio)
            readings.append(f"{name} {float(err.max()):.3e} (max|ref| "
                            f"{float(b.abs().max()):.3e}, err/limit "
                            f"{ratio:.4f})")
    return (loss, lse), worst, loosest, readings


def time_ce(label: str, where: str, kern, plain, bound_by, buf, card: str):
    """Time a kernel and its plain version; log them beside the bound
    (bound_by: (ms, by), or (ms, by, the all-fp32 bound of PRs 11-17)).
    Returns (ms, plain_ms, bound_ms, bound_by)."""
    ms, plain_ms = time_ms(kern, buf), time_ms(plain, buf)
    bound, by = bound_by[:2]
    old = (f"; all-fp32 bound {bound_by[2]:.6f} ms" if len(bound_by) > 2
           else "")
    log(f"[smoke] {label} ({where}): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound:.6f} ms ({by}){old}; library: "
        f"none; on {card}")
    return ms, plain_ms, bound, by


def check_sampled_ce(sce, fwd_ref, bwd_ref, buf, card: str):
    """Phase 3 for the per-token sampled CE, forward and backward: sweep
    (V, D, M) x T x table dtype against the plain version, a bitwise repeat
    of the backward, and times at the training shapes. Prints each
    output's error, size and err/limit at T = 1024."""
    worst = {"fwd": 0.0, "bwd": 0.0}
    loosest = 0.0
    for v, d, m in ((10000, 200, 20), (128256, 2048, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            for t, hot in ((1, False), (7, False), (1024, False),
                           (1024, True)):
                h, tab, lq, neg, pos, g = sce_inputs(t, d, m, v, dtype,
                                                     seed=t + d + m,
                                                     hot_row=hot)
                where = (f"T={t} D={d} M={m} V={v} "
                         f"{str(dtype).split('.')[-1]}"
                         + (" one hot row" if hot else ""))
                _, errs, ratio, readings = hold_ce(
                    "sampled_ce_pt", sce.sampled_ce_pt_cuda,
                    sce.sampled_ce_pt_bwd_cuda, fwd_ref, bwd_ref,
                    (h, tab, lq, neg, pos), g, ("dh", "dtab", "dlq"), where)
                worst = {k: max(worst[k], errs[k]) for k in worst}
                loosest = max(loosest, ratio)
                if t == 1024:
                    log(f"[smoke] sampled_ce_pt at {where}: "
                        + "; ".join(readings))
    log(f"[smoke] sampled_ce_pt vs plain: max_abs_err fwd={worst['fwd']:.3e} "
        f"bwd={worst['bwd']:.3e} over (V,D,M) in {{(10000,200,20),"
        f"(128256,2048,64)}}, fp32/bf16 table, T in {{1,7,1024}}, with "
        f"duplicate, repeated and colliding ids, and at T=1024 also with "
        f"one id taking about half of the occurrences, g ~ U(0,1) (tol "
        f"{REL_TOL}*max(|ref|, min(1, max|ref|)) per tensor, for both table "
        f"dtypes: both sides upcast the same table values; largest "
        f"err/limit {loosest:.4f}); backward bitwise repeatable")
    timings = {}
    for name, (t, d, m, v, dtype), hot in SCE_PT_TIMED:
        h, tab, lq, neg, pos, g = sce_inputs(t, d, m, v, dtype, seed=1,
                                             hot_row=hot)
        _, lse = sce.sampled_ce_pt_cuda(h, tab, lq, neg, pos)
        where = (f"{name}, T={t} D={d} M={m} V={v} "
                 f"{str(dtype).split('.')[-1]}, longest segment "
                 f"{longest_segment(neg, pos, v)}")
        elem = tab.element_size()
        timings[name] = {} if hot else {"fwd": time_ce(
            "sampled_ce_pt fwd", where,
            lambda: sce.sampled_ce_pt_cuda(h, tab, lq, neg, pos),
            lambda: fwd_ref(h, tab, lq, neg, pos),
            sce_bound_ms(t, d, m, v, elem, neg, pos, backward=False),
            buf, card)}
        timings[name]["bwd"] = time_ce(
            "sampled_ce_pt bwd", where,
            lambda: sce.sampled_ce_pt_bwd_cuda(g, h, tab, lq, neg, pos, lse),
            lambda: bwd_ref(g, h, tab, lq, neg, pos, lse),
            sce_bound_ms(t, d, m, v, elem, neg, pos, backward=True),
            buf, card)
    return worst, timings


SCE_PT_TIMED = (               # (name, (T, D, M, V, table dtype), hot row)
    ("paper-lm train", (1024, 200, 20, 10000, torch.float32), False),
    ("llama3.2-1b width", (1024, 2048, 64, 128256, torch.bfloat16), False),
    ("paper-lm train, one hot row", (1024, 200, 20, 10000, torch.float32),
     True))
#: Where the smoke saves the ids of the last step of its paper-lm per-token
#: training run, for `scripts/head_kernel_times.py`.
TRAIN_IDS = os.path.join(HERE, "build", "sampled_ce_pt_train_ids.pt")


def longest_segment(neg: torch.Tensor, pos: torch.Tensor, v: int) -> int:
    """The most occurrences of one table row among a step's ids: the
    longest segment of the d(table) reduction."""
    ids = torch.cat([neg.reshape(-1), pos.reshape(-1)])
    return int(torch.bincount(ids, minlength=v).max())


def keep_last_call(module, name: str):
    """Replace `module.name` by a wrapper that keeps the arguments of its
    latest call (in `box["args"]`); returns (box, undo). Wrap a caller of a
    kernel's wrapper (`kernels.dispatch`), not the wrapper, whose launch
    count names itself."""
    fn, box = getattr(module, name), {}

    def wrapper(*args):
        box["args"] = args
        return fn(*args)
    setattr(module, name, wrapper)
    return box, lambda: setattr(module, name, fn)


def check_train_step_bwd(sce, bwd_ref, args, card: str):
    """The per-token backward at the inputs of one step of the paper-lm
    training run (its ids, hidden rows, table, g and lse): held to the plain
    version (`sce_limit`) and bitwise repeatable, timed beside it; the ids
    saved to `TRAIN_IDS`. Returns (ms, plain_ms, bound_ms, bound_by,
    longest segment, max_abs_err)."""
    g, h, tab, lq, neg, pos, lse = args
    t, d = h.shape
    m, v = lq.shape[1], tab.shape[0]
    got = sce.sampled_ce_pt_bwd_cuda(*args)
    again = sce.sampled_ce_pt_bwd_cuda(*args)
    want = bwd_ref(*args)
    torch.cuda.synchronize()
    where = f"paper-lm train step ids, T={t} D={d} M={m} V={v}"
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise SystemExit(f"sampled_ce_pt_bwd is not bitwise repeatable at "
                         f"{where}")
    worst = 0.0
    for name, a, b in zip(("dh", "dtab", "dlq"), got, want):
        err = (a - b).abs()
        ratio = float((err / sce_limit(b)).max())
        if not torch.isfinite(a).all() or ratio > 1.0:
            raise SystemExit(f"sampled_ce_pt_bwd {name} disagrees with the "
                             f"plain version at {where}: {ratio:.3f} of the "
                             f"limit")
        worst = max(worst, float(err.max()))
    longest = longest_segment(neg, pos, v)
    os.makedirs(os.path.dirname(TRAIN_IDS), exist_ok=True)
    torch.save({"neg_ids": neg.cpu(), "pos_ids": pos.cpu(), "v": v, "d": d},
               TRAIN_IDS)
    buf = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")
    timing = time_ce(
        "sampled_ce_pt bwd", f"{where}, longest segment {longest}",
        lambda: sce.sampled_ce_pt_bwd_cuda(*args), lambda: bwd_ref(*args),
        sce_bound_ms(t, d, m, v, tab.element_size(), neg, pos,
                     backward=True), buf, card)
    log(f"[smoke] sampled_ce_pt_bwd at {where}: max_abs_err {worst:.3e}, "
        f"bitwise repeatable; ids saved to {TRAIN_IDS}")
    return (*timing, longest, worst)


SHAPE = (4, 256, 1024, 2048)   # llama3.2-1b training: B, S, M, D
SHARED_TRAIN = {               # the training shapes: (B, S, M, D), V
    "llama3.2-1b train": (SHAPE, 128256),
    "llama3.2-1b train S=512": ((4, 512, 1024, 2048), 128256),
    "mamba2-370m train": ((4, 1024, 1024, 1024), 50280),
    "llama3.2-1b train_4k": ((2, TRAIN_4K, 1024, 2048), 128256)}


def shared_inputs(b: int, s: int, m: int, d: int, v: int, dtype, seed: int):
    """Shared-negative CE inputs on the card, rows gathered from a [v, d]
    table: duplicate negatives, negatives that collide with positives, and
    a token (0, 0) all of whose negatives collide."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    h = 0.5 * torch.randn((b, s, d), generator=g, device="cuda")
    table = (0.1 * torch.randn((v, d), generator=g, device="cuda")).to(dtype)
    log_q = -9.0 + 0.5 * torch.randn((b, m), generator=g, device="cuda")
    neg = torch.randint(0, v, (b, m), generator=g, device="cuda")
    pos = torch.randint(0, v, (b, s), generator=g, device="cuda")
    neg[:, 1::2] = neg[:, 0::2][:, :m // 2]     # duplicates
    neg[:, 2] = pos[:, -1]                      # collisions
    neg[0] = pos[0, 0]                          # every negative collides
    grad = torch.rand((b, s), generator=g, device="cuda")
    return (h, table[pos].contiguous(), table[neg].contiguous(), log_q, neg,
            pos, grad)


def shared_bound_ms(b: int, s: int, m: int, d: int, elem: int,
                    backward: bool):
    """Bytes: each input read once (h, the gathered pe and ne rows, log_q,
    the ids; backward also g and lse) and each output written once (loss
    and lse; backward dh, dpe, dne, dlq). Operations the function needs:
    the [S, M] logit product over D per sequence (a matrix product, at
    3xTF32's rate) and the positive dots (fp32); the backward needs three
    products — the logits once, w·ne and (g·w)ᵀ·h — and the positive terms
    (h·pe, (p_pos − 1)·pe into dh, dpe). Returns `roofline_ms`'s (bound,
    bound_by, all-fp32 bound)."""
    nbytes = (4 * b * s * d + elem * b * (s + m) * d + 4 * b * m + 8 * b * m
              + 8 * b * s)
    if backward:
        nbytes += 8 * b * s + 4 * b * (2 * s + m) * d + 4 * b * m
        products, other = 6 * b * s * m * d, 6 * b * s * d
    else:
        nbytes += 8 * b * s
        products, other = 2 * b * s * m * d, 2 * b * s * d
    return roofline_ms(nbytes, other, products)


def check_shared_ce(sce, fwd_ref, bwd_ref, buf, card: str):
    """Phase 3 for the shared-negative CE, forward and both backward
    kernels: sweep S x M x D x row dtype against the plain version, a
    bitwise repeat of the forward and the backward, and, at the training
    shapes (`SHARED_TRAIN`: llama3.2-1b B=4, S=256 and 512, M=1024, D=2048;
    mamba2-370m B=4, S=1024, M=1024, D=1024; `train_4k` B=2, S=4096,
    M=1024, D=2048; fp32 rows), the same holds and the times. Prints each output's error, size and err/limit at
    S >= 256, M = 1024. Returns (worst errors, {shape: {"fwd", "bwd"}})."""
    worst = {"fwd": 0.0, "bwd": 0.0}
    loosest = 0.0
    bwd_names = ("dh", "dpe", "dne", "dlq")

    def hold(b, s, m, d, v, dtype, seed):
        args = shared_inputs(b, s, m, d, v, dtype, seed)
        where = f"B={b} S={s} M={m} D={d} {str(dtype).split('.')[-1]}"
        (loss, lse), errs, ratio, readings = hold_ce(
            "sampled_ce", sce.sampled_ce_cuda, sce.sampled_ce_bwd_cuda,
            fwd_ref, bwd_ref, args[:-1], args[-1], bwd_names, where)
        again = sce.sampled_ce_cuda(*args[:-1])
        if not (torch.equal(loss, again[0]) and torch.equal(lse, again[1])):
            raise SystemExit(f"sampled_ce is not bitwise repeatable at "
                             f"{where}")
        nonlocal loosest
        for k in worst:
            worst[k] = max(worst[k], errs[k])
        loosest = max(loosest, ratio)
        if float(loss[0, 0]) != 0.0:
            raise SystemExit(f"sampled_ce at {where}: a token whose "
                             f"negatives all collide has loss "
                             f"{float(loss[0, 0])}, not 0")
        if s >= 256 and m == 1024:
            log(f"[smoke] sampled_ce at {where}: " + "; ".join(readings))
        return args, lse, where

    for d in (200, 2048):
        for m in (20, 1024):
            for dtype in (torch.float32, torch.bfloat16):
                for s in (1, 7, 256):
                    hold(2, s, m, d, 5000, dtype, seed=s + m + d)
    rows = {}
    for label, ((b, s, m, d), v) in SHARED_TRAIN.items():
        (h, pe, ne, lq, neg, pos, g), lse, where = hold(
            b, s, m, d, v, torch.float32, seed=1)
        where = f"{label}, {where} V={v}"
        rows[label] = {
            "fwd": time_ce(
                "sampled_ce fwd", where,
                lambda: sce.sampled_ce_cuda(h, pe, ne, lq, neg, pos),
                lambda: fwd_ref(h, pe, ne, lq, neg, pos),
                shared_bound_ms(b, s, m, d, 4, backward=False), buf, card),
            "bwd": time_ce(
                "sampled_ce bwd", where,
                lambda: sce.sampled_ce_bwd_cuda(g, h, pe, ne, lq, neg, pos,
                                                lse),
                lambda: bwd_ref(g, h, pe, ne, lq, neg, pos, lse),
                shared_bound_ms(b, s, m, d, 4, backward=True), buf, card)}
    log(f"[smoke] sampled_ce vs plain: max_abs_err fwd={worst['fwd']:.3e} "
        f"bwd={worst['bwd']:.3e} over B=2, S in {{1,7,256}}, M in "
        f"{{20,1024}}, D in {{200,2048}}, fp32/bf16 rows, and B=4, M=1024, "
        f"fp32 rows at (S, D) in {{(256,2048),(512,2048),(1024,1024)}} and "
        f"B=2, S=4096, D=2048 (the training shapes), with "
        f"duplicate and colliding ids and an all-colliding token, g ~ "
        f"U(0,1) (tol {REL_TOL}*max(|ref|, min(1, max|ref|)) per tensor; "
        f"largest err/limit {loosest:.4f}); forward and backward bitwise "
        f"repeatable")
    b, s, m, d = SHAPE
    h, pe, ne, *_ = shared_inputs(b, s, m, d, 128256, torch.float32, seed=1)
    nt = ne.transpose(1, 2)
    bmm = time_ms(lambda: torch.bmm(h, nt), buf)
    log(f"[smoke] reference point: fp32 torch.bmm of the logit product alone "
        f"([{b},{s},{d}] x [{b},{d},{m}], TF32 off) {bmm:.4f} ms on {card}")
    return worst, rows


RFF_SWEEP = ((8, 128, 64, 16), (13, 200, 32, 5), (1, 64, 16, 3),
             (20, 130, 64, 17))            # T, N, 2R, m: ragged edges
RFF_SHAPES = {                             # the main paths' shapes
    "llama3.2-1b serve": (4, 128256, 64, 64),
    "paper-lm per-token train": (1024, 10000, 64, 20),
    "llama3.2-1b pooled train": (4, 128256, 64, 1024)}
RFF_TIE = 1e-5                 # near-tie: |v_kern - v_plain| <= 1e-5 max(1,|v|)


def rff_inputs(t: int, n: int, r2: int, form: str, seed: int):
    """φ(z), φ(C) >= 0 and the seeds in the reference's form (one seed,
    rows counted 0..T-1) or the port's (each row its own key, counter 0)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    pz = 0.3 * torch.rand((t, r2), generator=g, device="cuda")
    pc = torch.rand((n, r2), generator=g, device="cuda")
    if form == "reference":
        seeds = torch.full((t,), 7, dtype=torch.int64, device="cuda")
        t_ids = torch.arange(t, device="cuda")
    else:
        seeds = torch.randint(0, 2**32, (t,), generator=g, device="cuda")
        t_ids = torch.zeros(t, dtype=torch.int64, device="cuda")
    return pz, pc, seeds, t_ids


def rff_bound_ms(t: int, n: int, r2: int, m: int):
    """Bytes: φ(z), φ(C), seeds and row counters read once; ids and log q
    written once. Operations the function needs: per (t, n) the 2·2R of
    the dot, the floor and log of the logit and the exp, subtract and add
    of the logsumexp (5); per (t, d) the second hash round (10); per
    (t, d, n) 19: the last hash round's 10 integer operations (a multiply
    and a xor folding n in, the mix's 3 shifts, 3 xors and 2 multiplies),
    the uniform's 3 (shift, int-to-float, multiply-add), the Gumbel's two
    logs and two negations (4, a log counted as one), the add to the logit
    and the compare (2)."""
    nbytes = 4 * t * r2 + 4 * n * r2 + 16 * t + 8 * t * m
    ops = t * n * (2 * r2 + 5) + 10 * t * m + 19 * t * m * n
    b_ms, f_ms = nbytes / HBM_BYTES_S * 1e3, ops / FP32_FLOP_S * 1e3
    return max(b_ms, f_ms), ("bytes" if b_ms >= f_ms else "operations")


def check_rff_sample(rff_mod, ref_mod, buf, card: str):
    """Phase 3 for the RFF sampler: the reference's sweep and the main
    paths' shapes, both seed forms, against the plain version: ids equal
    except at near-ties of the perturbed values, log q within
    1e-5·max(1, |plain|) of the plain log q of the drawn id, the kernel
    bitwise repeatable. Then times at the main shapes (the port's form)."""
    worst, n_diff, n_draws = 0.0, 0, 0
    for t, n, r2, m in RFF_SWEEP + tuple(RFF_SHAPES.values()):
        for form in ("reference", "rows"):
            pz, pc, seeds, t_ids = rff_inputs(t, n, r2, form, seed=t + n)
            ids, lq = rff_mod.rff_sample_cuda(pz, pc, seeds, t_ids, m)
            again = rff_mod.rff_sample_cuda(pz, pc, seeds, t_ids, m)
            want, _, lse = ref_mod.rff_gumbel_ref(pz, pc, seeds, t_ids, m)
            torch.cuda.synchronize()
            where = f"T={t} N={n} 2R={r2} m={m} seeds={form}"
            if not (torch.equal(ids, again[0]) and torch.equal(lq, again[1])):
                raise SystemExit(f"rff_sample is not bitwise repeatable at "
                                 f"{where}")
            if tuple(ids.shape) != (t, m) or not torch.isfinite(lq).all() \
                    or not bool(((ids >= 0) & (ids < n)).all()):
                raise SystemExit(f"rff_sample: bad output at {where}")
            logits = ref_mod.rff_scores(pz, pc)
            a = ref_mod.perturbed_values(logits, seeds, t_ids, ids)
            b = ref_mod.perturbed_values(logits, seeds, t_ids, want)
            same = ids == want
            near = (a - b).abs() <= RFF_TIE * b.abs().clamp(min=1)
            if not bool((same | near).all()):
                raise SystemExit(f"rff_sample draws differ from the plain "
                                 f"version's beyond a near-tie at {where}")
            want_lq = torch.gather(logits, 1, ids.long()) - lse[:, None]
            err = (lq - want_lq).abs()
            if bool((err > RFF_TIE * want_lq.abs().clamp(min=1)).any()):
                raise SystemExit(f"rff_sample log_q disagrees with the plain "
                                 f"version at {where}: max err "
                                 f"{float(err.max()):.3e}")
            worst = max(worst, float(err.max()))
            n_diff += int((~same).sum())
            n_draws += t * m
    log(f"[smoke] rff_sample vs plain: log_q max_abs_err={worst:.3e} (tol "
        f"{RFF_TIE}*max(1,|ref|)); {n_diff} of {n_draws} draws differ, each "
        f"a near-tie (tol {RFF_TIE}*max(1,|v|)); over the reference's sweep "
        f"and the main shapes, both seed forms; bitwise repeatable")
    timings = {}
    for name, (t, n, r2, m) in RFF_SHAPES.items():
        pz, pc, seeds, t_ids = rff_inputs(t, n, r2, "rows", seed=1)
        ms = time_ms(lambda: rff_mod.rff_sample_cuda(pz, pc, seeds, t_ids,
                                                     m), buf)
        plain = time_ms(lambda: ref_mod.rff_gumbel_ref(pz, pc, seeds, t_ids,
                                                       m), buf)
        bound, by = rff_bound_ms(t, n, r2, m)
        timings[name] = (ms, plain, bound, by)
        log(f"[smoke] rff_sample {name} (T={t} N={n} 2R={r2} m={m}): kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.6f} ms "
            f"({by}); library: none; on {card}")
    return worst, n_diff, timings


TC_BF16_FLOP_S = 989e12        # H100 SXM bf16 on the tensor cores (dense)
BF16_RTOL = 2.0 ** -7          # one bf16 ulp is at most 2^-7 * |value|
BF16_ATOL = 1e-5               # fp32 summation-order differences, which
                               # matter only where |out| is near 0
FLASH_MAIN = {                 # llama3.2-1b causal attention: B, S (H=32,
    "llama3.2-1b prefill B=4 S=2048": (4, 2048),   # KV=8, hd=64, bf16)
    "llama3.2-1b prefill B=4 S=4096": (4, 4096),
    "prefill_32k B=1 S=32768": (1, 32768)}
FLASH_REPS = {2048: 50, 4096: 50, 32768: 5}        # timed launches per shape


def flash_inputs(b: int, sq: int, sk: int, h: int, kv: int, hd: int, dtype,
                 seed: int):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device="cuda").to(dtype)
                 for shape in ((b, sq, h, hd), (b, sk, kv, hd),
                               (b, sk, kv, hd)))


def flash_scores(sq: int, sk: int, causal: bool, window, q_offset: int) -> int:
    """The allowed (query, key) pairs of one (batch, head): the scores this
    run's mask needs."""
    qi = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(sk - 1, qi) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, qi - window + 1) if window is not None else 0
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_ops(b: int, sq: int, sk: int, h: int, hd: int, causal: bool = True,
              window=None, q_offset: int = 0) -> int:
    """The function's operations: per allowed score the q.k dot and the
    p.v update (4·hd, a multiply-add counted as two) and one exp."""
    return b * h * flash_scores(sq, sk, causal, window, q_offset) * (4 * hd + 1)


def flash_bound_ms(b: int, sq: int, sk: int, h: int, kv: int, hd: int,
                   elem: int, causal: bool = True, window=None,
                   q_offset: int = 0):
    """Operations (`flash_ops`) at the card's peak rate for the inputs'
    type: 989 TFLOP/s for bf16 (tensor cores), 67 TFLOP/s for fp32. Bytes:
    q, k and v read once, out and lse written once, at 3.35 TB/s. Returns
    (bound ms, what bounds it)."""
    ops = flash_ops(b, sq, sk, h, hd, causal, window, q_offset)
    nbytes = elem * (2 * b * sq * h * hd + 2 * b * sk * kv * hd) + 4 * b * h * sq
    rate = TC_BF16_FLOP_S if elem == 2 else FP32_FLOP_S
    b_ms, f_ms = nbytes / HBM_BYTES_S * 1e3, ops / rate * 1e3
    return max(b_ms, f_ms), "bytes" if b_ms >= f_ms else "operations"


def hold_flash(cuda_mod, ref_fn, q, k, v, *, causal: bool, window,
               q_offset: int, where: str):
    """The kernel against its plain version on one input, and bit for bit
    against itself. out within 1e-4·max(1, |plain|) in fp32 and
    2^-7·|plain| + 1e-5 in bf16 (one bf16 ulp: both round an fp32 result);
    lse within 1e-4·max(1, |plain|). Returns (out, max out err, max lse
    err, elements differing at all)."""
    sq, sk = q.shape[1], k.shape[1]
    out, lse = cuda_mod.flash_attention_cuda(q, k, v, causal=causal,
                                             window=window, q_offset=q_offset)
    again = cuda_mod.flash_attention_cuda(q, k, v, causal=causal,
                                          window=window, q_offset=q_offset)
    want, want_lse = ref_fn(q, k, v, causal=causal, window=window,
                            q_offset=q_offset, q_chunk=min(512, sq),
                            kv_chunk=min(1024, sk))
    torch.cuda.synchronize()
    if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
        raise SystemExit(f"flash_attention is not bitwise repeatable at "
                         f"{where}")
    if out.shape != want.shape or lse.shape != want_lse.shape \
            or not torch.isfinite(out).all() or not torch.isfinite(lse).all():
        raise SystemExit(f"flash_attention: bad output shape/values at "
                         f"{where}")
    bf16 = q.dtype == torch.bfloat16
    errs = []
    for name, a, b in (("out", out.float(), want.float()),
                       ("lse", lse, want_lse)):
        err = (a - b).abs()
        if name == "out" and bf16:
            lim, rule = BF16_RTOL * b.abs() + BF16_ATOL, "2^-7*|ref| + 1e-5"
        else:
            lim, rule = REL_TOL * b.abs().clamp(min=1.0), "1e-4*max(1,|ref|)"
        if bool((err > lim).any()):
            raise SystemExit(f"flash_attention {name} disagrees with the "
                             f"plain version at {where}: max err "
                             f"{float(err.max()):.3e} (tol {rule})")
        errs.append(float(err.max()))
    return out, errs[0], errs[1], int((out != want).sum())


def sdpa_backend(q, k, v) -> str:
    """Which kernel PyTorch's scaled_dot_product_attention ran: the names
    of the CUDA kernels of one call under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type.name == "CUDA"]
    return "; ".join(n[:70] for n in names) or "no CUDA kernel recorded"


def check_flash_attention(cuda_mod, ref_fn, buf, card: str):
    """Phase 3 for the flash-attention forward, TF32 off: a sweep (fp32 and
    bf16; hd in {50, 64, 128}; (H, KV) in {(4,4), (6,3), (32,8), (2,1)};
    Sq = Sk in {128, 384, 1024, 2048}; causal on and off; window None or
    16) plus Sq < Sk with q_offset = Sk - Sq and two forms with rows that
    have no allowed key, each bitwise repeatable; then the main shapes
    (llama3.2-1b prefill B=4 at S=2048 and 4096, and the prefill_32k
    length), where row b of a B=4 call must equal a B=1 call on that row
    bit for bit, and the times of the kernel, its plain version and SDPA
    beside the bound."""
    worst = {"out fp32": 0.0, "out bf16": 0.0, "lse": 0.0}
    n_diff = n_bf16 = cases = 0
    sweep = [(dt, hd, h, kv, s, s, causal, window, 0)
             for dt in (torch.float32, torch.bfloat16) for hd in (50, 64, 128)
             for h, kv in ((4, 4), (6, 3), (32, 8), (2, 1))
             for s in (128, 384, 1024, 2048) for causal in (True, False)
             for window in (None, 16)]
    sweep += [(dt, 64, 32, 8, 512, 2048, True, None, 1536)
              for dt in (torch.float32, torch.bfloat16)]
    sweep += [(torch.float32, 64, 6, 3, 384, 384, True, 16, -100),
              (torch.bfloat16, 128, 4, 2, 384, 384, False, 16, 384)]
    for dt, hd, h, kv, sq, sk, causal, window, off in sweep:
        q, k, v = flash_inputs(2, sq, sk, h, kv, hd, dt, seed=sq + hd + h)
        where = (f"B=2 Sq={sq} Sk={sk} H={h} KV={kv} hd={hd} "
                 f"{str(dt).split('.')[-1]} causal={causal} window={window} "
                 f"q_offset={off}")
        _, e_out, e_lse, nd = hold_flash(cuda_mod, ref_fn, q, k, v,
                                         causal=causal, window=window,
                                         q_offset=off, where=where)
        key = "out bf16" if dt == torch.bfloat16 else "out fp32"
        worst[key] = max(worst[key], e_out)
        worst["lse"] = max(worst["lse"], e_lse)
        if dt == torch.bfloat16:
            n_diff += nd
            n_bf16 += q.numel()
        cases += 1
    log(f"[smoke] flash_attention vs plain: {cases} cases, max_abs_err out "
        f"fp32={worst['out fp32']:.3e} bf16={worst['out bf16']:.3e} lse="
        f"{worst['lse']:.3e} (tol out 1e-4*max(1,|ref|) fp32 / 2^-7*|ref| + "
        f"1e-5 bf16, lse 1e-4*max(1,|ref|)); bf16 out elements differing at "
        f"all: {n_diff} of "
        f"{n_bf16}; every case bitwise repeatable")
    for hd in (64, 128):       # TMA against plain loads, the same values
        q, k, v = flash_inputs(2, 1024, 1024, 32, 8, hd, torch.bfloat16,
                               seed=hd)
        kw = dict(causal=True, window=None, q_offset=0)
        tma = cuda_mod.flash_attention_cuda(q, k, v, **kw)
        moved = []
        for x in (q, k, v):    # data_ptr 2 bytes past a 16-byte boundary
            flat = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
            moved.append(flat[1:].view(x.shape).copy_(x))
        plain = cuda_mod.flash_attention_cuda(*moved, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(tma[0], plain[0]) and torch.equal(tma[1],
                                                              plain[1])):
            raise SystemExit(f"flash_attention: the TMA and plain-load "
                             f"routes differ at hd={hd}")
    log("[smoke] flash_attention bf16 load routes (TMA; plain loads for a "
        "tensor off a 16-byte boundary) agree bit for bit at B=2 S=1024 "
        "H=32 KV=8 hd 64 and 128, causal")
    timings = {}
    for name, (b, s) in FLASH_MAIN.items():
        q, k, v = flash_inputs(b, s, s, 32, 8, 64, torch.bfloat16, seed=s)
        out, e_out, e_lse, nd = hold_flash(cuda_mod, ref_fn, q, k, v,
                                           causal=True, window=None,
                                           q_offset=0, where=name)
        worst["out bf16"] = max(worst["out bf16"], e_out)
        worst["lse"] = max(worst["lse"], e_lse)
        for row in range(b if b > 1 else 0):
            solo, _ = cuda_mod.flash_attention_cuda(
                q[row:row + 1].contiguous(), k[row:row + 1].contiguous(),
                v[row:row + 1].contiguous(), causal=True, window=None,
                q_offset=0)
            if not torch.equal(solo[0], out[row]):
                raise SystemExit(f"flash_attention at {name}: row {row} of "
                                 f"the batch != the same row alone")
        reps = FLASH_REPS[s]
        warm = 5 if reps > 5 else 1
        ms = time_ms(lambda: cuda_mod.flash_attention_cuda(
            q, k, v, causal=True, window=None, q_offset=0), buf, reps, warm)
        plain = time_ms(lambda: ref_fn(q, k, v, causal=True, window=None,
                                       q_offset=0, q_chunk=512,
                                       kv_chunk=1024),
                        buf, max(2, reps // 10), 1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), buf, reps, warm)
        backend = sdpa_backend(qt, kt, vt)
        bound, by = flash_bound_ms(b, s, s, 32, 8, 64, 2)
        tflops = flash_ops(b, s, s, 32, 64) / (ms * 1e-3) / 1e12
        timings[name] = (ms, plain, bound, by, lib, tflops)
        log(f"[smoke] flash_attention {name} (H=32 KV=8 hd=64 bf16 causal; "
            f"out err {e_out:.3e}, {nd} elements differ, lse err "
            f"{e_lse:.3e}; batched == solo): kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {bound:.6f} ms ({by}, bf16 at 989 "
            f"TFLOP/s), library (SDPA) {lib:.4f} ms [{backend}]"
            f"; achieved {tflops:.1f} TFLOP/s, {bound / ms:.3f} of the "
            f"bound, kernel / SDPA {ms / lib:.3f}; {reps} timed launches; "
            f"on {card}")
    return worst, n_diff, timings


SSD_MAIN = {                   # mamba2-370m: Bt, S, Q (H=32, P=64, N=128)
    "mamba2-370m train 4x1024 Q=256": (4, 1024, 256),
    "mamba2-370m prefill 4x512 Q=256": (4, 512, 256),
    "mamba2-370m prefill 4x64 Q=64": (4, 64, 64)}


def ssd_inputs(bt: int, s: int, h: int, p: int, n: int, seed: int,
               steep: bool = False):
    """x, B, C ~ 0.5·N(0,1), adt = -softplus(N(0,1)) (minus 20 when steep),
    dt = softplus(N(0,1)), as `tests/test_ssd_kernel.py` draws them."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    sp = torch.nn.functional.softplus
    x, bm, cm = 0.5 * normal(bt, s, h, p), 0.5 * normal(bt, s, n), \
        0.5 * normal(bt, s, n)
    adt = -sp(normal(bt, s, h)) - (20.0 if steep else 0.0)
    return x, bm, cm, adt, sp(normal(bt, s, h))


def ssd_bound_ms(bt: int, s: int, h: int, p: int, n: int, q: int):
    """Operations the function needs, per (b, h, chunk of Q). Matrix
    products (at 3xTF32's rate): 2P per pair of the causal half (Q(Q+1)/2
    pairs) for (CB ⊙ L)·(dt x), 2QNP for C·h and 2QNP for Bᵀ·w; C·B is
    shared by the heads, Q(Q+1)/2 · 2N once per (b, chunk). Other (fp32):
    the decay's subtract, exp and multiply into C·B (3 a pair); dt·x (QP);
    C·h's e^cum scaling (Q + QP); y1 + y2 (QP); the prefix sum (Q); the
    state update's e^(cum_Q - cum) (2Q), weights (QP) and e^cum_Q h + s
    (2NP). Bytes: x, B, C, adt and dt read once, y and h_last written once,
    fp32. Returns `roofline_ms`'s (bound, bound_by, all-fp32 bound)."""
    nc = s // q
    pairs = q * (q + 1) // 2
    products = bt * nc * (h * (pairs * 2 * p + 4 * q * n * p)
                          + pairs * 2 * n)
    other = bt * nc * h * (pairs * 3 + q * p + q + q * p + q * p + q + 2 * q
                           + q * p + 2 * n * p)
    nbytes = 4 * (2 * bt * s * h * p + 2 * bt * s * n + 2 * bt * s * h
                  + bt * h * n * p)
    return roofline_ms(nbytes, other, products)


def hold_ssd(cuda_mod, ref_fn, args, q: int, where: str):
    """The kernel against its plain version on one input: y and h_last
    within 1e-4·max(1, |plain|), bit for bit against itself, and each row
    of the batch equal to that row alone. Returns (y err, h_last err)."""
    y, h_last = cuda_mod.ssd_scan_cuda(*args, chunk=q)
    again = cuda_mod.ssd_scan_cuda(*args, chunk=q)
    want = ref_fn(*args, chunk=q)
    torch.cuda.synchronize()
    if not (torch.equal(y, again[0]) and torch.equal(h_last, again[1])):
        raise SystemExit(f"ssd_scan is not bitwise repeatable at {where}")
    errs = []
    for name, a, b in (("y", y, want[0]), ("h_last", h_last, want[1])):
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise SystemExit(f"ssd_scan {name}: bad output shape/values at "
                             f"{where}")
        err = (a - b).abs()
        if bool((err > REL_TOL * b.abs().clamp(min=1.0)).any()):
            raise SystemExit(f"ssd_scan {name} disagrees with the plain "
                             f"version at {where}: max err "
                             f"{float(err.max()):.3e}")
        errs.append(float(err.max()))
    bt = y.shape[0]
    for row in range(bt if bt > 1 else 0):
        solo = cuda_mod.ssd_scan_cuda(*(t[row:row + 1].contiguous()
                                        for t in args), chunk=q)
        if not (torch.equal(solo[0][0], y[row])
                and torch.equal(solo[1][0], h_last[row])):
            raise SystemExit(f"ssd_scan at {where}: row {row} of the batch "
                             f"!= the same row alone")
    return errs


def check_ssd_scan(cuda_mod, ref_fn, buf, card: str):
    """Phase 3c for the SSD scan (see the module docstring)."""
    worst = {"y": 0.0, "h_last": 0.0}
    cases = []
    for n, p in ((16, 16), (128, 64), (16, 64), (128, 16)):
        for q in (8, 13, 64, 256):
            cases.append((2, 2 * q, 3, p, n, q, False))
        cases.append((3, 200, 3, p, n, 200, False))           # Q = S
    cases += [(2, 512, 4, 64, 128, 256, True),                # steep
              (1, 104, 32, 64, 128, 13, False),
              (4, 1024, 32, 64, 128, 256, False),
              (2, 80, 3, 50, 30, 40, False)]                  # plain loads
    for bt, s, h, p, n, q, steep in cases:
        where = (f"Bt={bt} S={s} H={h} P={p} N={n} Q={q}"
                 f"{' steep' if steep else ''}")
        args = ssd_inputs(bt, s, h, p, n, seed=s + q + n + p, steep=steep)
        e_y, e_h = hold_ssd(cuda_mod, ref_fn, args, q, where)
        worst["y"] = max(worst["y"], e_y)
        worst["h_last"] = max(worst["h_last"], e_h)
    log(f"[smoke] ssd_scan vs plain: {len(cases)} cases, max_abs_err y="
        f"{worst['y']:.3e} h_last={worst['h_last']:.3e} (tol "
        f"{REL_TOL}*max(1,|ref|)); every case bitwise repeatable, each row "
        f"of a batch equal to that row alone")
    timings = {}
    for name, (bt, s, q) in SSD_MAIN.items():
        args = ssd_inputs(bt, s, 32, 64, 128, seed=s)
        e_y, e_h = hold_ssd(cuda_mod, ref_fn, args, q, name)
        ms = time_ms(lambda: cuda_mod.ssd_scan_cuda(*args, chunk=q), buf)
        plain = time_ms(lambda: ref_fn(*args, chunk=q), buf)
        bound, by, old = ssd_bound_ms(bt, s, 32, 64, 128, q)
        timings[name] = (ms, plain, bound, by)
        log(f"[smoke] ssd_scan {name} (H=32 P=64 N=128 fp32; y err "
            f"{e_y:.3e}, h_last err {e_h:.3e}; batched == solo): kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.6f} ms ({by}: "
            f"products at 3xTF32's 165 TFLOP/s, the rest at fp32's 67; "
            f"all-fp32 bound {old:.6f} ms); library: none; on {card}")
    return worst, timings


def check_against_cpu(cfg_name: str) -> None:
    """Phase 4: the port on the card against the port on the CPU, fp32,
    small input: prefill hidden states agree to 1e-3."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, params_to, prefill
    cfg = dataclasses.replace(get_config(cfg_name).reduced(), dtype="float32")
    params = init_params(cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(0))
    h_cpu, _ = prefill(cfg, params, toks)
    gpu = params_to(params, "cuda")
    h_gpu, _ = prefill(cfg, gpu, toks.cuda())
    err = float((h_gpu.cpu() - h_cpu).abs().max())
    if not err <= 1e-3:
        raise SystemExit(f"card vs CPU prefill hidden disagree: {err:.3e}")
    log(f"[smoke] {cfg_name} (reduced, fp32) prefill on card vs CPU: "
        f"max_abs_err={err:.3e}")


def serve(cfg, *, head: str, requests: int, prompt: int, tokens: int,
          verify: int, params=None, index=None, counter=None):
    """Drive `Engine` on the card; returns (engine, summary, launches).
    The summary adds the peak device memory from the engine's construction
    to the end of the solo replays (`peak_gib`) and what was allocated
    before it (`base_gib`)."""
    from repro_torch.launch.serve import prompt_buckets, synthetic_requests
    from repro_torch.serve import Engine
    base = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = Engine(cfg, params, index=index, head=head, device="cuda",
                    seed=0)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    reqs = synthetic_requests(cfg, num=requests, prompt=prompt,
                              max_new=tokens, rate=0.0, seed=0)
    engine.warmup(prompt_buckets(prompt))
    if counter is not None:
        counter.launches = 0
    results = engine.run(reqs)
    launches = counter.launches if counter is not None else 0
    s = engine.stats.summary()
    vocab = cfg.vocab_size
    for r in reqs:
        res = results[r.rid]
        if res.status != "ok" or len(res.tokens) != tokens:
            raise SystemExit(f"{cfg.name}/{head}: request {r.rid} came back "
                             f"{res.status} with {len(res.tokens)} tokens")
        if res.tokens.min() < 0 or res.tokens.max() >= cfg.padded_vocab:
            raise SystemExit(f"{cfg.name}/{head}: token ids out of range")
    for r in reqs[:verify]:
        solo = engine.replay_single(r)
        if not np.array_equal(results[r.rid].tokens, solo):
            raise SystemExit(f"{cfg.name}/{head}: rid {r.rid} batched "
                             f"{results[r.rid].tokens.tolist()} != solo "
                             f"{solo.tolist()}")
    torch.cuda.synchronize()
    s = {**s, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
         "base_gib": base}
    kname = counter.__name__.removesuffix("_cuda") if counter else "kernel"
    log(f"[smoke] serve {cfg.name} head={head} L={cfg.num_layers} "
        f"d={cfg.d_model} V={vocab}: setup {setup:.1f}s, "
        f"{requests} requests x {tokens} tokens on {cfg.serve.max_slots} "
        f"slots: tok/s={s['tok_s']} p50={s['p50_ms']}ms p99={s['p99_ms']}ms "
        f"steps={s['steps']}; batched == solo on {verify}; {kname} "
        f"launches {launches}; peak memory {s['peak_gib']:.2f} GiB "
        f"({base:.2f} GiB allocated before)")
    return engine, s, launches


LONG_PROMPTS = (2048, 4096, 2048, 4096)    # the long-prompt serve's requests
MAMBA_PROMPTS = (64, 512, 64, 512)         # the mamba2 serve's requests


def serve_prompts(cfg, params, index, counters, names, prompts, *,
                  head: str = "midx"):
    """Serve one request of 16 tokens per entry of `prompts` on the
    config's slots, whole-prompt prefill, one prefill per length group.
    Counters are set to 0 just before the run and read just after; batched
    == solo on one request of each length (the first two). Returns
    (engine, summary, launches)."""
    from repro_torch.serve import Engine, Request
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2**30
    engine = Engine(cfg, params, index=index, head=head, device="cuda",
                    seed=0)
    engine.warmup(sorted(set(prompts)))
    rng = np.random.default_rng(7)
    reqs = [Request(rid=i, tokens=rng.integers(0, cfg.vocab_size, size=n)
                    .astype(np.int32), max_new=16, seed=3)
            for i, n in enumerate(prompts)]
    for c in counters:
        c.launches = 0
    results = engine.run(reqs)
    torch.cuda.synchronize()
    launches = [c.launches for c in counters]
    s = engine.stats.summary()
    for r in reqs:
        res = results[r.rid]
        if res.status != "ok" or len(res.tokens) != 16 \
                or res.tokens.min() < 0 or res.tokens.max() >= cfg.padded_vocab:
            raise SystemExit(f"{cfg.name} serve: request {r.rid} (prompt "
                             f"{len(r.tokens)}) came back {res.status} with "
                             f"{res.tokens.tolist()}")
    for name, n in zip(names, launches):
        if n <= 0:
            raise SystemExit(f"{cfg.name} serve: {name} was never launched "
                             f"on the main path")
    prefill_ms = {n: 1e3 * statistics.median(
        results[r.rid].latencies_s[0] for r in reqs if len(r.tokens) == n)
        for n in sorted(set(prompts))}
    for r in reqs[:2]:                         # one of each length
        solo = engine.replay_single(r)
        if not np.array_equal(results[r.rid].tokens, solo):
            raise SystemExit(f"{cfg.name} serve: rid {r.rid} (prompt "
                             f"{len(r.tokens)}) batched "
                             f"{results[r.rid].tokens.tolist()} != solo "
                             f"{solo.tolist()}")
    torch.cuda.synchronize()
    s = {**s, "prefill_ms": prefill_ms,
         "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
         "base_gib": base}
    log(f"[smoke] serve {cfg.name} head={head} L={cfg.num_layers} "
        f"d={cfg.d_model} prompts {list(prompts)} x 16 tokens on "
        f"{cfg.serve.max_slots} slots (max_seq {cfg.serve.max_seq}): "
        f"tok/s={s['tok_s']} p50={s['p50_ms']}ms p99={s['p99_ms']}ms "
        f"steps={s['steps']}; prefill (first-token) latency per group: "
        + ", ".join(f"{n} tokens {ms:.2f} ms" for n, ms in prefill_ms.items())
        + f"; batched == solo on one of each length; launches "
        + ", ".join(f"{n} {k}" for k, n in zip(names, launches))
        + f"; peak memory {s['peak_gib']:.2f} GiB ({base:.2f} GiB allocated "
        f"before)")
    return engine, s, launches


def train(cfg, counters, names, *, steps: int, batch: int, seq: int,
          lr: float, corpus=None, refresh_every=None):
    """Drive `launch.train.train_loop` on the card with the counters set to
    0 just before; every step must be finite and applied and the last 5
    steps' mean loss more than 0.1 below the first 5's. Returns (params,
    index, launches per counter, summary)."""
    from repro_torch.launch.train import train_loop
    seen = []
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    params, _, index, hist = train_loop(
        cfg, steps=steps, batch_size=batch, seq_len=seq, lr=lr,
        corpus=corpus, refresh_every=refresh_every, log_every=20,
        device="cuda",
        on_metrics=lambda step, m: seen.append(
            (step, float(m["loss"]), float(m["grad_norm"]),
             float(m["skipped"]), m["step_s"])))
    torch.cuda.synchronize()
    launches = [c.launches for c in counters]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    bad = [s for s in seen if s[3] or not np.isfinite(s[1:3]).all()]
    if len(seen) != steps or bad:
        raise SystemExit(f"{cfg.name} training: {len(seen)} steps logged, "
                         f"skipped or non-finite: {bad[:3]}")
    first, last = float(np.mean(hist[:5])), float(np.mean(hist[-5:]))
    if not last < first - 0.1:
        raise SystemExit(f"{cfg.name} training: loss did not drop by > 0.1 "
                         f"(first 5 mean {first:.4f}, last 5 mean "
                         f"{last:.4f})")
    for name, n in zip(names, launches):
        if n <= 0:
            raise SystemExit(f"{cfg.name} training: {name} was never "
                             f"launched on the main path")
    step_s = statistics.median(s[4] for s in seen[1:])
    summary = {"first5": first, "last5": last, "median_step_ms":
               step_s * 1e3, "tok_s": batch * seq / step_s,
               "peak_gib": peak_gib}
    log(f"[smoke] train {cfg.name} L={cfg.num_layers} d={cfg.d_model} "
        f"V={cfg.vocab_size} head={cfg.head.mode} "
        f"proposal={cfg.head.proposal} "
        f"M={cfg.head.num_negatives} K={cfg.head.midx_k}: {steps} steps x "
        f"{batch}x{seq} tokens, lr {lr}, loss first-5 mean {first:.4f} -> "
        f"last-5 mean {last:.4f}; median step {step_s * 1e3:.2f} ms, "
        f"{batch * seq / step_s:.0f} tokens/s; peak memory {peak_gib:.2f} "
        f"GiB; launches " + ", ".join(f"{n} {k}" for k, n in
                                      zip(names, launches)))
    log(f"[smoke] train {cfg.name} head={cfg.head.mode} "
        f"proposal={cfg.head.proposal} losses: {json.dumps(hist)}")
    return params, index, launches, summary


def replay(cfg, *, steps: int, batch: int, seq: int, lr: float, corpus,
           refresh_every: int, counter=None) -> list:
    """Two runs from one seed agree bit for bit: losses, params, optimizer
    state and head state (the MIDX index or the proposal's state). With a
    counter, its kernel must launch in each run. Returns the launches."""
    from repro_torch.index.build import MultiIndex
    from repro_torch.launch.train import train_loop
    from repro_torch.optim.optimizers import tree_leaves
    runs, launches = [], []
    for _ in range(2):
        if counter is not None:
            counter.launches = 0
        runs.append(train_loop(cfg, steps=steps, batch_size=batch,
                               seq_len=seq, lr=lr, corpus=corpus,
                               refresh_every=refresh_every, log_every=1000,
                               device="cuda"))
        if counter is not None:
            launches.append(counter.launches)

    def state(run):
        params, opt, index, _ = run
        head = ([index.codebook1, index.codebook2, index.sorted_ids]
                if isinstance(index, MultiIndex)
                else [index[k] for k in sorted(index)])
        return (tree_leaves(params) + tree_leaves(opt.mu) + tree_leaves(opt.nu)
                + head)

    if runs[0][3] != runs[1][3] or not all(
            torch.equal(a, b) for a, b in zip(state(runs[0]),
                                              state(runs[1]))):
        raise SystemExit(f"{cfg.name} ({cfg.head.mode}, {cfg.head.proposal})"
                         f" training does not replay bit for bit on the card")
    if counter is not None and min(launches) <= 0:
        raise SystemExit(f"{cfg.name} ({cfg.head.mode}) replay: "
                         f"{counter.__name__} launches {launches}")
    log(f"[smoke] train {cfg.name} L={cfg.num_layers} d={cfg.d_model} "
        f"head={cfg.head.mode} proposal={cfg.head.proposal} replay: two "
        f"{steps}-step runs (refresh every {refresh_every}) agree bit for bit "
        f"(final loss {runs[0][3][-1]:.6f})"
        + (f"; {counter.__name__} launches {launches}" if counter else ""))
    return launches


def profile_train(cfg, params, index, label: str, b: int = 16,
                  s: int = 64, steps: int = 5) -> None:
    """Where a training step's time goes: `steps` steps of the trained model
    under torch.profiler (wall, device busy and idle share, launches, and
    the kernels that took the most device time)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import noise
    from repro_torch.launch import steps as steps_mod
    from repro_torch.optim import adamw
    opt = adamw(1e-4)
    step = steps_mod.make_train_step(cfg, opt)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen,
                         device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    state = opt.init(params)
    keys = noise.train_keys(0, 0, b * s, "cuda")
    p, state, _ = step(params, state, index, batch, keys)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            p, state, m = step(p, state, index, batch, keys)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type.name == "CUDA"
               and not e.key.startswith("train.")]
    busy_us = sum(e.self_device_time_total for e in kernels)
    n_kern = sum(e.count for e in kernels)
    log(f"[profile] {label}: {steps} steps, wall {wall * 1e3:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms (idle share {1 - busy_us / 1e6 / wall:.3f}),"
        f" {n_kern} kernel launches")
    for e in events:
        if e.key.startswith("train.") and e.device_type.name == "CPU":
            log(f"[profile]   {e.key}: x{e.count}, host "
                f"{e.cpu_time_total / 1e3 / e.count:.3f} ms each")
    log_kernels(kernels, busy_us, 8)


# The port's kernels in a profile, by library: (label, name fragments).
PORT_KERNELS = (
    ("midx_probs (2 kernels)", ("midx_part_kernel", "midx_finish_kernel")),
    ("sampled_ce_pt fwd", ("fwd_kernel<float, ",
                           "fwd_kernel<__nv_bfloat16, ")),
    ("sampled_ce_pt_bwd", ("bwd_rows_kernel", "occ_scan_kernel",
                           "occ_place_kernel", "dtab_kernel")),
    ("rff_sample (2 kernels)", ("rff_part", "rff_merge_kernel")),
    ("sampled_ce fwd (2 kernels)", ("fwd_part_kernel", "fwd_merge_kernel")),
    ("sampled_ce_bwd (3 kernels)", ("bwd_w_kernel", "bwd_dh_kernel",
                                    "bwd_dne_kernel")),
    ("flash_attention", ("flash_fwd",)),
    ("ssd_scan (4 kernels)", ("ssd_prep_kernel", "ssd_state_kernel",
                              "ssd_carry_kernel", "ssd_out_kernel")))


def log_kernels(kernels, busy_us: float, n_top: int) -> None:
    """The `n_top` kernels that took the most device time, then the port's
    other kernels, each with its share of the busy time; then each of the
    port's libraries that ran, summed."""
    def line(name, count, us):
        log(f"[profile]   {name}: x{count}, {us / 1e3:.2f} ms "
            f"({us / max(busy_us, 1e-9):.3f} of busy)")

    def ours(e):
        return any(f in e.key for _, frags in PORT_KERNELS for f in frags)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:n_top]
    for e in top + [e for e in kernels if ours(e) and e not in top]:
        line(f"kernel {e.key[:60]}", e.count, e.self_device_time_total)
    for label, frags in PORT_KERNELS:
        group = [e for e in kernels if any(f in e.key for f in frags)]
        if group:
            line(f"all of {label}", sum(e.count for e in group),
                 sum(e.self_device_time_total for e in group))


def profile_run(engine, label: str, *, prompt: int, tokens: int) -> None:
    """Where the time goes: one run (4 requests) under torch.profiler.
    Prints the wall time, the device's busy time and idle share, the kernel
    launch count, the engine's annotated ranges (prefill, decode backbone,
    decode head) and the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import synthetic_requests
    reqs = synthetic_requests(engine.cfg, num=4, prompt=prompt,
                              max_new=tokens, rate=0.0, seed=1)
    reqs = [dataclasses.replace(r, tokens=r.tokens[:1].repeat(prompt))
            for r in reqs]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type.name == "CUDA"
               and not e.key.startswith("engine.")]
    busy_us = sum(e.self_device_time_total for e in kernels)
    n_kern = sum(e.count for e in kernels)
    waves = sum(e.count for e in events if e.key == "engine.decode_head"
                and e.device_type.name == "CPU")
    log(f"[profile] {label}: wall {wall * 1e3:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms (idle share {1 - busy_us / 1e6 / wall:.3f}),"
        f" {n_kern} kernel launches, {waves} decode waves")
    for e in events:
        if e.key.startswith("engine.") and e.device_type.name == "CPU":
            log(f"[profile]   {e.key}: x{e.count}, host "
                f"{e.cpu_time_total / 1e3 / e.count:.3f} ms each")
    log_kernels(kernels, busy_us, 6)


MAMBA_STEPS, MAMBA_LR, MAMBA_REFRESH = 30, 1e-3, 10  # full-width training
MAMBA_SHAPE = (4, 1024)        # mamba2-370m training: batch, seq


def mamba_phases(get_config, ssd, midx_cuda, sce_cuda, profile: bool,
                 card: str) -> dict:
    """Phases 11 and 12: mamba2-370m at full width, served (MIDX head, then
    the full head, greedy) and trained through `train_loop` with its own
    pooled head, then the trained model served and a 2-layer cut
    replayed. Returns {kernel: launches}: ssd_scan's by main-path run,
    midx_probs' in the MIDX serve, the shared CE's in training."""
    layers = get_config("mamba2-370m").num_layers
    cfg = get_config("mamba2-370m").with_serve(
        max_slots=4, page_size=16, max_seq=max(MAMBA_PROMPTS) + 32)
    eng, mamba_serve, n_serve = serve_prompts(
        cfg, None, None, (ssd, midx_cuda.midx_probs_cuda),
        ("ssd_scan", "midx_probs"), MAMBA_PROMPTS)
    groups = len(set(MAMBA_PROMPTS))
    if n_serve[0] % layers or n_serve[0] < layers * groups:
        raise SystemExit(f"mamba2-370m serve: ssd_scan launched "
                         f"{n_serve[0]} times, not {layers} per prefill "
                         f"group (at least {groups} groups)")
    if profile:
        profile_run(eng, "mamba2-370m head=midx, one prefill of 4 x "
                    f"{max(MAMBA_PROMPTS)}-token prompts",
                    prompt=max(MAMBA_PROMPTS), tokens=1)
    greedy = cfg.with_head(decode_temperature=0.0)
    _, full_serve, n_full = serve_prompts(greedy, eng.params, None, (ssd,),
                                          ("ssd_scan",), MAMBA_PROMPTS,
                                          head="full")
    del eng
    torch.cuda.empty_cache()
    mark("mamba2-370m serving")
    b, s = MAMBA_SHAPE
    t0 = time.perf_counter()
    params, index, n_train, summary = train(
        cfg, (ssd, sce_cuda.sampled_ce_cuda, sce_cuda.sampled_ce_bwd_cuda),
        ("ssd_scan", "sampled_ce", "sampled_ce_bwd"), steps=MAMBA_STEPS,
        batch=b, seq=s, lr=MAMBA_LR, refresh_every=MAMBA_REFRESH)
    if n_train[0] != layers * MAMBA_STEPS:
        raise SystemExit(f"mamba2-370m training: ssd_scan launched "
                         f"{n_train[0]} times, not {layers} a step")
    log(f"[smoke] mamba2-370m training phase (corpus draw of max(512, 4 x "
        f"{b}) x {s + 1} ZipfLM tokens included): "
        f"{time.perf_counter() - t0:.1f}s on {card}")
    if profile:
        profile_train(cfg, params, index, "mamba2-370m train step", b=b, s=s,
                      steps=3)
    served = cfg.with_serve(max_slots=4, page_size=16, max_seq=96)
    _, _, n_trained = serve(served, head="midx", requests=4, prompt=64,
                            tokens=16, verify=2, params=params, index=index,
                            counter=ssd)
    del params, index
    torch.cuda.empty_cache()
    from repro_torch.data import ZipfLM
    corpus = ZipfLM(vocab_size=cfg.vocab_size, num_clusters=64,
                    seq_len=s + 1, seed=0).sample(16)
    n_replay = replay(dataclasses.replace(cfg, num_layers=2), steps=5,
                      batch=b, seq=s, lr=MAMBA_LR, corpus=corpus,
                      refresh_every=3, counter=ssd)
    log(f"[smoke] mamba2-370m: serve {json.dumps(mamba_serve)}; full head "
        f"{json.dumps(full_serve)}; train {json.dumps(summary)}; on {card}")
    launches = {"serve midx": n_serve[0], "serve full": n_full[0],
                "train": n_train[0], "trained serve": n_trained,
                "replay": sum(n_replay)}
    for name, n in launches.items():
        if n <= 0:
            raise SystemExit(f"mamba2-370m {name}: ssd_scan was never "
                             "launched on the main path")
    return {"ssd_scan": launches, "midx_probs": n_serve[1],
            "sampled_ce": n_train[1], "sampled_ce_bwd": n_train[2]}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="also profile one llama3.2-1b run per head, 5 "
                         "train steps each of paper-lm (MIDX, then "
                         "rff-fused) and llama3.2-1b, one "
                         "long-prompt prefill, 3 train_4k steps, one "
                         "mamba2-370m prefill and 3 of its train steps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        sys.exit(2)
    import repro_torch  # noqa: F401  (fails without the repository)
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention import cuda as flash_cuda
    from repro_torch.kernels.flash_attention.ref import flash_fwd_ref
    from repro_torch.kernels.midx_probs import cuda as midx_cuda
    from repro_torch.kernels.midx_probs.ref import midx_probs_ref
    from repro_torch.kernels.rff_sample import cuda as rff_cuda
    from repro_torch.kernels.rff_sample import ref as rff_ref
    from repro_torch.kernels.sampled_ce import cuda as sce_cuda
    from repro_torch.kernels.sampled_ce.ref import (sampled_ce_bwd_ref,
                                                    sampled_ce_fwd_ref,
                                                    sampled_ce_pt_bwd_ref,
                                                    sampled_ce_pt_fwd_ref)
    from repro_torch.kernels.ssd_scan import cuda as ssd_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    card = card_line()
    log(card)
    log(f"[smoke] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    libraries = (flash_cuda.LIBRARY, midx_cuda.LIBRARY, sce_cuda.LIBRARY,
                 sce_cuda.SHARED_LIBRARY, rff_cuda.LIBRARY, ssd_cuda.LIBRARY)
    for lib in libraries:                      # one nvcc per source, at once
        lib.start()
    for lib in libraries:
        lib.load()
        log(f"[smoke] built {lib.name} (nvcc {lib.build_seconds:.1f}s)")
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line \
                    or "Compiling entry" in line:
                log(f"[smoke]   ptxas: {line.strip()}")
    log(f"[smoke] built all kernels in {time.perf_counter() - t0:.1f}s")
    check_kernel_build(flash_cuda.LIBRARY, flash_label,
                       lambda n: n.startswith("bf16"), "HGMMA")
    check_kernel_build(ssd_cuda.LIBRARY, kernel_label,
                       lambda n: "carry" not in n, "HMMA")
    check_kernel_build(sce_cuda.SHARED_LIBRARY, kernel_label,
                       lambda n: n.startswith(("bwd", "fwd_part")), "HMMA")
    mark("build")

    buf = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")
    worst, timings = check_midx_probs(midx_cuda, midx_probs_ref, buf,
                                     card)
    sce_worst, sce_timings = check_sampled_ce(
        sce_cuda, sampled_ce_pt_fwd_ref, sampled_ce_pt_bwd_ref, buf, card)
    shared_worst, shared_timings = check_shared_ce(
        sce_cuda, sampled_ce_fwd_ref, sampled_ce_bwd_ref, buf, card)
    rff_worst, rff_diff, rff_timings = check_rff_sample(rff_cuda, rff_ref,
                                                        buf, card)
    flash_worst, flash_diff, flash_timings = check_flash_attention(
        flash_cuda, flash_fwd_ref, buf, card)
    ssd_worst, ssd_timings = check_ssd_scan(ssd_cuda, ssd_scan_ref, buf, card)
    del buf
    mark("kernel checks (phases 3-3c)")
    check_against_cpu("paper-lm")
    check_against_cpu("mamba2-370m")

    counter = midx_cuda.midx_probs_cuda
    paper = get_config("paper-lm").with_serve(max_slots=4, page_size=16,
                                              max_seq=32)
    _, _, n_paper = serve(paper, head="midx", requests=16, prompt=8,
                          tokens=16, verify=2, counter=counter)
    llama = get_config("llama3.2-1b").with_serve(max_slots=4, page_size=16,
                                                 max_seq=112)
    torch.cuda.empty_cache()
    eng, midx_serve, n_llama = serve(llama, head="midx", requests=8,
                                     prompt=64, tokens=32, verify=2,
                                     counter=counter)
    greedy = llama.with_head(decode_temperature=0.0)
    eng_full, _, _ = serve(greedy, head="full", requests=8, prompt=64,
                           tokens=32, verify=2, params=eng.params)
    if args.profile:
        profile_run(eng, "llama3.2-1b head=midx", prompt=64, tokens=16)
        profile_run(eng_full, "llama3.2-1b head=full", prompt=64, tokens=16)
    llama_params, llama_index = eng.params, eng.index
    del eng, eng_full
    # long prompts (2048 and 4096 tokens) through the chunked attention path
    flash = flash_cuda.flash_attention_cuda
    long_llama = get_config("llama3.2-1b").with_serve(
        max_slots=4, page_size=16, max_seq=max(LONG_PROMPTS) + 32)
    eng_long, long_serve, n_long_serve = serve_prompts(
        long_llama, llama_params, llama_index, (flash, counter),
        ("flash_attention", "midx_probs"), LONG_PROMPTS)
    if args.profile:
        profile_run(eng_long, "llama3.2-1b head=midx, one prefill of 4 x "
                    "4096-token prompts", prompt=max(LONG_PROMPTS), tokens=1)
    del eng_long, llama_params, llama_index
    torch.cuda.empty_cache()
    rff_counter = rff_cuda.rff_sample_cuda
    _, rff_serve, n_rff_llama = serve(llama, head="rff-fused", requests=8,
                                      prompt=64, tokens=32, verify=2,
                                      counter=rff_counter)
    log(f"[smoke] llama3.2-1b serve peak device memory: head=midx "
        f"{midx_serve['peak_gib']:.3f} GiB, head=rff-fused "
        f"{rff_serve['peak_gib']:.3f} GiB (allocated before each: "
        f"{midx_serve['base_gib']:.3f} / {rff_serve['base_gib']:.3f} GiB)")
    torch.cuda.empty_cache()
    mark("serving (phases 5-6b)")

    from repro_torch.data import ZipfLM
    counters = (midx_cuda.midx_probs_cuda, sce_cuda.sampled_ce_pt_cuda,
                sce_cuda.sampled_ce_pt_bwd_cuda)
    cfg = get_config("paper-lm")
    last_bwd, undo = keep_last_call(dispatch, "sampled_ce_pt_bwd")
    try:
        params, index, n_train, _ = train(
            cfg, counters,
            ("midx_probs", "sampled_ce_pt", "sampled_ce_pt_bwd"),
            steps=120, batch=16, seq=64, lr=3e-3)
    finally:
        undo()
    step_bwd = check_train_step_bwd(sce_cuda, sampled_ce_pt_bwd_ref,
                                    last_bwd["args"], card)
    del last_bwd
    replay(cfg, steps=30, batch=16, seq=64, lr=3e-3, refresh_every=10,
           corpus=ZipfLM(vocab_size=cfg.vocab_size, num_clusters=64,
                         seq_len=65, seed=0).sample(64))
    if args.profile:
        profile_train(cfg, params, index, "paper-lm train step")
    trained = cfg.with_serve(max_slots=4, page_size=16, max_seq=32)
    _, _, n_trained = serve(trained, head="midx", requests=8, prompt=8,
                            tokens=16, verify=2, params=params, index=index,
                            counter=counters[0])
    del params, index
    mark("paper-lm training (phase 7)")

    # llama3.2-1b at full width through the pooled head (the config's own
    # head: RQ, K=64, M=1024), then replay, mixture and serving.
    b, s, _, _ = SHAPE
    t0 = time.perf_counter()
    llama_cfg = get_config("llama3.2-1b")
    corpus = ZipfLM(vocab_size=llama_cfg.vocab_size, num_clusters=64,
                    seq_len=s + 1, seed=0).sample(LLAMA_CORPUS)
    log(f"[smoke] llama3.2-1b corpus: {LLAMA_CORPUS} sequences x {s + 1} "
        f"tokens drawn on the host in {time.perf_counter() - t0:.1f}s")
    shared = (sce_cuda.sampled_ce_cuda, sce_cuda.sampled_ce_bwd_cuda)
    params, index, n_shared, _ = train(
        llama_cfg, shared, ("sampled_ce", "sampled_ce_bwd"),
        steps=LLAMA_STEPS, batch=b, seq=s, lr=LLAMA_LR, corpus=corpus,
        refresh_every=LLAMA_REFRESH)
    if args.profile:
        profile_train(llama_cfg, params, index,
                      "llama3.2-1b pooled train step", b=b, s=s)
    served = llama_cfg.with_serve(max_slots=4, page_size=16, max_seq=48)
    _, _, n_llama_trained = serve(served, head="midx", requests=4, prompt=16,
                                  tokens=16, verify=2, params=params,
                                  index=index, counter=counters[0])
    del params, index
    torch.cuda.empty_cache()
    short = dataclasses.replace(llama_cfg, num_layers=2)
    replay(short, steps=10, batch=b, seq=s, lr=LLAMA_LR, corpus=corpus,
           refresh_every=5)
    for c in shared:
        c.launches = 0
    mixture = short.with_head(proposal="mixture")
    from repro_torch.launch.train import train_loop
    _, _, _, hist = train_loop(mixture, steps=5, batch_size=b, seq_len=s,
                               lr=LLAMA_LR, corpus=corpus, log_every=1000,
                               device="cuda")
    torch.cuda.synchronize()
    n_mix = [c.launches for c in shared]
    if not np.all(np.isfinite(hist)) or min(n_mix) <= 0:
        raise SystemExit(f"llama3.2-1b mixture training: losses {hist}, "
                         f"launches sampled_ce/sampled_ce_bwd {n_mix}")
    log(f"[smoke] train llama3.2-1b L=2 proposal=mixture: 5 steps finite "
        f"(loss {hist[0]:.4f} -> {hist[-1]:.4f}); launches {n_mix[0]} "
        f"sampled_ce, {n_mix[1]} sampled_ce_bwd")
    mark("llama3.2-1b training (phase 8)")
    # the RFF proposal: paper-lm trained and served through rff-fused, then
    # the 2-layer llama pooled replay
    rff_paper = cfg.with_head(mode="rff-fused")
    params, state, n_rff_train, _ = train(
        rff_paper, (rff_counter,), ("rff_sample",), steps=120, batch=16,
        seq=64, lr=3e-3)
    if args.profile:
        profile_train(rff_paper, params, state,
                      "paper-lm rff-fused train step")
    _, _, n_rff_trained = serve(
        rff_paper.with_serve(max_slots=4, page_size=16, max_seq=32),
        head="rff-fused", requests=8, prompt=8, tokens=16, verify=2,
        params=params, index=state, counter=rff_counter)
    del params, state
    torch.cuda.empty_cache()
    n_rff_replay = replay(short.with_head(mode="rff-fused"), steps=10,
                          batch=b, seq=s, lr=LLAMA_LR, corpus=corpus,
                          refresh_every=5, counter=rff_counter)
    torch.cuda.empty_cache()
    mark("rff-fused (phase 9)")
    # train_4k: llama3.2-1b at full width with its pooled head, batch 2 x
    # seq 4096, on 2 x 4097 tokens cut from the corpus drawn above
    long_corpus = corpus.reshape(-1)[:2 * (TRAIN_4K + 1)].reshape(
        2, TRAIN_4K + 1)
    params, index, n_4k, train_4k = train(
        llama_cfg, (flash,) + shared,
        ("flash_attention", "sampled_ce", "sampled_ce_bwd"), steps=20,
        batch=2, seq=TRAIN_4K, lr=LLAMA_LR, corpus=long_corpus,
        refresh_every=10)
    if args.profile:
        profile_train(llama_cfg, params, index, "llama3.2-1b train_4k step",
                      b=2, s=TRAIN_4K, steps=3)
    del params, index
    torch.cuda.empty_cache()
    n_4k_replay = replay(short, steps=5, batch=2, seq=TRAIN_4K, lr=LLAMA_LR,
                         corpus=long_corpus, refresh_every=3, counter=flash)
    del corpus, long_corpus
    torch.cuda.empty_cache()
    mark("train_4k (phase 10)")
    n_mamba = mamba_phases(get_config, ssd_cuda.ssd_scan_cuda, midx_cuda,
                           sce_cuda, args.profile, card)
    n_ssd = n_mamba["ssd_scan"]
    mark("mamba2-370m (phases 11-12)")
    for name, n in (("llama3.2-1b serve", n_rff_llama),
                    ("paper-lm train", n_rff_train[0]),
                    ("trained paper-lm serve", n_rff_trained)):
        if n <= 0:
            raise SystemExit(f"{name} (rff-fused): rff_sample was never "
                             "launched on the main path")
    for name, n in (("paper-lm serve", n_paper), ("llama3.2-1b serve",
                                                  n_llama),
                    ("paper-lm train", n_train[0]),
                    ("trained paper-lm serve", n_trained),
                    ("trained llama3.2-1b serve", n_llama_trained)):
        if n <= 0:
            raise SystemExit(f"{name}: midx_probs was never launched on the "
                             "main path")

    ms, plain, bound, by = timings["llama3.2-1b decode"]
    t_ms, t_plain, t_bound, t_by = timings["paper-lm train"]
    src = "src/repro_torch/kernels/sampled_ce/csrc/sampled_ce_pt.cu"
    rows = [{
        "name": "midx_probs", "route": "cuda",
        "source": "src/repro_torch/kernels/midx_probs/csrc/midx_probs.cu",
        "replaces": "src/repro/kernels/midx_probs/midx_probs.py:23",
        "launches": n_paper + n_llama + n_train[0] + n_trained
                    + n_llama_trained + n_long_serve[1]
                    + n_mamba["midx_probs"],
        "max_abs_err": worst, "ms": ms, "plain_ms": plain, "bound_ms": bound,
        "bound_by": by, "library_ms": None,
        "shape": "llama3.2-1b decode T=4 D=2048 K=64 rq",
        "train": {"shape": "paper-lm train T=1024 D=200 K=32 rq",
                  "launches": n_train[0], "ms": t_ms, "plain_ms": t_plain,
                  "bound_ms": t_bound, "bound_by": t_by},
        "mamba2": {"shape": "mamba2-370m decode T=4 D=1024 K=64 rq",
                   "launches": n_mamba["midx_probs"],
                   **dict(zip(("ms", "plain_ms", "bound_ms", "bound_by"),
                              timings["mamba2-370m decode"]))}}]
    for kname, kind, line, n in (
            ("sampled_ce_pt", "fwd", 74, n_train[1]),
            ("sampled_ce_pt_bwd", "bwd", 217, n_train[2])):
        ms, plain, bound, by = sce_timings["paper-lm train"][kind]
        rows.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": f"src/repro/kernels/sampled_ce/per_token.py:{line}",
            "launches": n, "max_abs_err": sce_worst[kind], "ms": ms,
            "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": None,
            "shape": "paper-lm train T=1024 D=200 M=20 V=10000 fp32"})
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    rows[-1]["other_shapes"] = [
        {"shape": f"{name} T={t} D={d} M={m} V={v} "
                  f"{str(dtype).split('.')[-1]}",
         **dict(zip(keys, sce_timings[name]["bwd"]))}
        for name, (t, d, m, v, dtype), _ in SCE_PT_TIMED
        if name != "paper-lm train"] + [
        {"shape": "paper-lm train step ids T=1024 D=200 M=20 V=10000 fp32",
         **dict(zip(keys, step_bwd[:4])), "longest_segment": step_bwd[4],
         "max_abs_err": step_bwd[5]}]
    src = "src/repro_torch/kernels/sampled_ce/csrc/sampled_ce.cu"
    for i, (kname, kind, line) in enumerate((
            ("sampled_ce", "fwd", "33"), ("sampled_ce_bwd", "bwd", "205"))):
        ms, plain, bound, by = shared_timings["llama3.2-1b train"][kind]
        by_path = {"llama3.2-1b train": n_shared[i], "train_4k": n_4k[1 + i],
                   "mamba2-370m train": n_mamba[kname]}
        rows.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": f"src/repro/kernels/sampled_ce/sampled_ce.py:{line}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": shared_worst[kind], "ms": ms,
            "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": None,
            "shape": "llama3.2-1b train B=4 S=256 M=1024 D=2048 fp32 rows",
            "other_shapes": [
                {"shape": f"{label} B={b} S={s_} M={m} D={d} V={v} fp32 "
                          "rows",
                 **dict(zip(("ms", "plain_ms", "bound_ms", "bound_by"),
                            shared_timings[label][kind]))}
                for label, ((b, s_, m, d), v) in SHARED_TRAIN.items()
                if label != "llama3.2-1b train"]})
    ms, plain, bound, by = rff_timings["llama3.2-1b serve"]
    rows.append({
        "name": "rff_sample", "route": "cuda",
        "source": "src/repro_torch/kernels/rff_sample/csrc/rff_sample.cu",
        "replaces": "src/repro/kernels/rff_sample/rff_sample.py:31",
        "launches": n_rff_llama + n_rff_train[0] + n_rff_trained
                    + sum(n_rff_replay),
        "max_abs_err": rff_worst, "ms": ms, "plain_ms": plain,
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        "draws_differing_at_near_ties": rff_diff,
        "shape": "llama3.2-1b serve T=4 N=128256 2R=64 m=64",
        "other_shapes": [
            {"shape": f"{name} T={t} N={n} 2R={r2} m={m}",
             "ms": rff_timings[name][0], "plain_ms": rff_timings[name][1],
             "bound_ms": rff_timings[name][2],
             "bound_by": rff_timings[name][3]}
            for name, (t, n, r2, m) in RFF_SHAPES.items()
            if name != "llama3.2-1b serve"]})
    ms, plain, bound, by, lib, tflops = flash_timings[
        "llama3.2-1b prefill B=4 S=4096"]
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:25",
        "launches": n_long_serve[0] + n_4k[0] + sum(n_4k_replay),
        "launches_by_path": {"long-prompt serve": n_long_serve[0],
                             "train_4k": n_4k[0],
                             "train_4k replay": n_4k_replay},
        "max_abs_err": max(flash_worst.values()),
        "max_abs_err_by_output": flash_worst,
        "bf16_out_elements_differing": flash_diff, "ms": ms,
        "plain_ms": plain, "bound_ms": bound, "bound_by": by,
        "library_ms": lib, "achieved_tflops": tflops,
        "shape": "llama3.2-1b prefill B=4 S=4096 H=32 KV=8 hd=64 bf16 causal",
        "other_shapes": [
            {"shape": name, "ms": t[0], "plain_ms": t[1], "bound_ms": t[2],
             "bound_by": t[3], "library_ms": t[4], "achieved_tflops": t[5]}
            for name, t in flash_timings.items()
            if name != "llama3.2-1b prefill B=4 S=4096"]})
    ms, plain, bound, by = ssd_timings["mamba2-370m train 4x1024 Q=256"]
    rows.append({
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:24",
        "launches": sum(n_ssd.values()), "launches_by_path": n_ssd,
        "max_abs_err": max(ssd_worst.values()),
        "max_abs_err_by_output": ssd_worst, "ms": ms, "plain_ms": plain,
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        "shape": "mamba2-370m train Bt=4 S=1024 H=32 P=64 N=128 Q=256 fp32",
        "other_shapes": [
            {"shape": name, "ms": t[0], "plain_ms": t[1], "bound_ms": t[2],
             "bound_by": t[3]}
            for name, t in ssd_timings.items()
            if name != "mamba2-370m train 4x1024 Q=256"]})
    log(f"[smoke] long context: serve {json.dumps(long_serve)}; train_4k "
        f"{json.dumps(train_4k)}; on {card}")
    log(json.dumps({"kernels": rows}))
    log(f"[smoke] done in {time.perf_counter() - T_START:.1f}s on {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
