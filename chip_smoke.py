"""Chip smoke test for the PyTorch / CUDA port (`src/repro_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package. Phases, each fatal:
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel of the serving and training paths from the sources
     in the checkout, both libraries at once (`kernels/midx_probs/csrc/
     midx_probs.cu`, `kernels/sampled_ce/csrc/sampled_ce_pt.cu`), and print
     what ptxas says;
  3. hold each kernel against its plain torch version on the card, at the
     main paths' shapes and a sweep around them, with TF32 off; the
     sampled-CE backward must also repeat bit for bit; time each kernel and
     its plain version with CUDA events (median of 50 cold-L2 launches)
     beside the bound (bytes over 3.35 TB/s, FLOPs over 67 TFLOP/s fp32);
  4. check the port against itself on the CPU at a small input (prefill
     hidden states, fp32);
  5. serve `paper-lm` at full width through the MIDX head (16 requests,
     4 slots, 16 tokens), with batched == solo on 2 requests;
  6. serve `llama3.2-1b` at full width through the MIDX head (8 requests,
     4 slots, prompt 64, 32 tokens), then once with the full head, greedy,
     batched == solo;
  7. train `paper-lm` at full width through `launch.train.train_loop` with
     the MIDX head (120 steps, batch 16, seq 64, lr 3e-3, index refreshes
     after steps 49 and 99): every step finite and applied, the last 5
     steps' mean loss more than 0.1 below the first 5's; then two more
     30-step runs (refresh every 10) must agree bit for bit — losses,
     params, optimizer state and index;
  8. serve the trained params and index (8 requests, 16 tokens), with
     batched == solo on 2;
  9. print the kernels' JSON line, then the result line.
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
REL_TOL = 1e-4                 # |kernel - plain| <= 1e-4 * max(1, |plain|)
MIDX_TS = (1, 4, 8, 33, 512, 1024)   # decode, prefill and training rows


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def flush_l2(buf: torch.Tensor) -> None:
    buf.zero_()                # 128 MB > the 50 MB L2: evicts everything


def time_ms(fn, buf: torch.Tensor, reps: int = 50) -> float:
    """Median of `reps` single calls, each after an L2 flush, timed with
    CUDA events."""
    for _ in range(5):
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
    for d, k in ((200, 32), (2048, 64)):
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
        f"(D,K) in {{(200,32),(2048,64)}}, pq/rq, T in {MIDX_TS} "
        f"(tol {REL_TOL}*max(1,|ref|))")
    timings = {}
    for name, (t, d, k, split) in (
            ("paper-lm decode", (4, 200, 32, False)),
            ("llama3.2-1b decode", (4, 2048, 64, False)),
            ("llama3.2-1b T=8", (8, 2048, 64, False)),
            ("llama3.2-1b T=512", (512, 2048, 64, False)),
            ("llama3.2-1b decode pq", (4, 2048, 64, True)),
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


def sce_inputs(t: int, d: int, m: int, v: int, dtype, seed: int):
    """Per-token sampled-CE inputs on the card, with duplicate ids within
    rows, ids repeated across rows and negative == positive collisions."""
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


def check_sampled_ce(sce, fwd_ref, bwd_ref, buf, card: str):
    """Phase 3 for the per-token sampled CE, forward and backward: sweep
    (V, D, M) x T x table dtype against the plain version, a bitwise repeat
    of the backward, and times at the training shapes. Prints each
    output's error, size and err/limit at T = 1024."""
    worst = {"fwd": 0.0, "bwd": 0.0}
    loosest = 0.0
    for v, d, m in ((10000, 200, 20), (128256, 2048, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            for t in (1, 7, 1024):
                h, tab, lq, neg, pos, g = sce_inputs(t, d, m, v, dtype,
                                                     seed=t + d + m)
                loss, lse = sce.sampled_ce_pt_cuda(h, tab, lq, neg, pos)
                got = sce.sampled_ce_pt_bwd_cuda(g, h, tab, lq, neg, pos, lse)
                again = sce.sampled_ce_pt_bwd_cuda(g, h, tab, lq, neg, pos,
                                                   lse)
                want_f = fwd_ref(h, tab, lq, neg, pos)
                want_b = bwd_ref(g, h, tab, lq, neg, pos, want_f[1])
                torch.cuda.synchronize()
                where = (f"T={t} D={d} M={m} V={v} "
                         f"{str(dtype).split('.')[-1]}")
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise SystemExit(f"sampled_ce_pt_bwd is not bitwise "
                                     f"repeatable at {where}")
                readings = []
                for kind, names, outs, refs in (
                        ("fwd", ("loss", "lse"), (loss, lse), want_f),
                        ("bwd", ("dh", "dtab", "dlq"), got, want_b)):
                    for name, a, b in zip(names, outs, refs):
                        if a.shape != b.shape or not torch.isfinite(a).all():
                            raise SystemExit(f"sampled_ce {name}: bad output"
                                             f" shape/values at {where}")
                        err = (a - b).abs()
                        ratio = float((err / sce_limit(b)).max())
                        if ratio > 1.0:
                            raise SystemExit(
                                f"sampled_ce {name} disagrees with the plain "
                                f"version at {where}: max err "
                                f"{float(err.max()):.3e}, {ratio:.3f} of the "
                                f"limit")
                        worst[kind] = max(worst[kind], float(err.max()))
                        loosest = max(loosest, ratio)
                        readings.append(f"{name} {float(err.max()):.3e} "
                                        f"(max|ref| {float(b.abs().max()):.3e}"
                                        f", err/limit {ratio:.4f})")
                if t == 1024:
                    log(f"[smoke] sampled_ce_pt at {where}: "
                        + "; ".join(readings))
    log(f"[smoke] sampled_ce_pt vs plain: max_abs_err fwd={worst['fwd']:.3e} "
        f"bwd={worst['bwd']:.3e} over (V,D,M) in {{(10000,200,20),"
        f"(128256,2048,64)}}, fp32/bf16 table, T in {{1,7,1024}}, with "
        f"duplicate, repeated and colliding ids, g ~ U(0,1) (tol "
        f"{REL_TOL}*max(|ref|, min(1, max|ref|)) per tensor, for both table "
        f"dtypes: both sides upcast the same table values; largest "
        f"err/limit {loosest:.4f}); backward bitwise repeatable")
    timings = {}
    for name, (t, d, m, v, dtype) in (
            ("paper-lm train", (1024, 200, 20, 10000, torch.float32)),
            ("llama3.2-1b width", (1024, 2048, 64, 128256, torch.bfloat16))):
        h, tab, lq, neg, pos, g = sce_inputs(t, d, m, v, dtype, seed=1)
        _, lse = sce.sampled_ce_pt_cuda(h, tab, lq, neg, pos)
        elem = tab.element_size()
        rows = {}
        for kind, kern, plain in (
                ("fwd", lambda: sce.sampled_ce_pt_cuda(h, tab, lq, neg, pos),
                 lambda: fwd_ref(h, tab, lq, neg, pos)),
                ("bwd", lambda: sce.sampled_ce_pt_bwd_cuda(
                    g, h, tab, lq, neg, pos, lse),
                 lambda: bwd_ref(g, h, tab, lq, neg, pos, lse))):
            ms, plain_ms = time_ms(kern, buf), time_ms(plain, buf)
            bound, by = sce_bound_ms(t, d, m, v, elem, neg, pos,
                                     backward=kind == "bwd")
            rows[kind] = (ms, plain_ms, bound, by)
            log(f"[smoke] sampled_ce_pt {kind} {name} (T={t} D={d} M={m} "
                f"V={v} {str(dtype).split('.')[-1]}): kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound {bound:.6f} ms ({by}); "
                f"library: none; on {card}")
        timings[name] = rows
    return worst, timings


def check_against_cpu(cfg_name: str) -> None:
    """Phase 4: the port on the card against the port on the CPU, fp32,
    small input: prefill hidden states agree to 1e-3."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, params_to, prefill
    cfg = dataclasses.replace(get_config(cfg_name).reduced(), dtype="float32")
    params = init_params(cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 12),
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
    """Drive `Engine` on the card; returns (engine, summary, launches)."""
    from repro_torch.launch.serve import prompt_buckets, synthetic_requests
    from repro_torch.serve import Engine
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
    log(f"[smoke] serve {cfg.name} head={head} L={cfg.num_layers} "
        f"d={cfg.d_model} V={vocab}: setup {setup:.1f}s, "
        f"{requests} requests x {tokens} tokens on {cfg.serve.max_slots} "
        f"slots: tok/s={s['tok_s']} p50={s['p50_ms']}ms p99={s['p99_ms']}ms "
        f"steps={s['steps']}; batched == solo on {verify}; "
        f"midx_probs launches {launches}")
    return engine, s, launches


def train(counters):
    """Phase 7: `paper-lm` at full width through `train_loop` on the card.
    Returns (cfg, params, index, launches per counter, summary)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train_loop
    cfg = get_config("paper-lm")
    steps, batch, seq = 120, 16, 64
    seen = []
    for c in counters:
        c.launches = 0
    params, _, index, hist = train_loop(
        cfg, steps=steps, batch_size=batch, seq_len=seq, lr=3e-3,
        log_every=40, device="cuda",
        on_metrics=lambda step, m: seen.append(
            (step, float(m["loss"]), float(m["grad_norm"]),
             float(m["skipped"]), m["step_s"])))
    torch.cuda.synchronize()
    launches = [c.launches for c in counters]
    bad = [s for s in seen if s[3] or not np.isfinite(s[1:3]).all()]
    if len(seen) != steps or bad:
        raise SystemExit(f"paper-lm training: {len(seen)} steps logged, "
                         f"skipped or non-finite: {bad[:3]}")
    first, last = float(np.mean(hist[:5])), float(np.mean(hist[-5:]))
    if not last < first - 0.1:
        raise SystemExit(f"paper-lm training: loss did not drop by > 0.1 "
                         f"(first 5 mean {first:.4f}, last 5 mean "
                         f"{last:.4f})")
    step_s = statistics.median(s[4] for s in seen[1:])
    summary = {"first5": first, "last5": last, "median_step_ms":
               step_s * 1e3, "tok_s": batch * seq / step_s}
    log(f"[smoke] train paper-lm L={cfg.num_layers} d={cfg.d_model} "
        f"V={cfg.vocab_size} head=midx M={cfg.head.num_negatives} "
        f"K={cfg.head.midx_k}: {steps} steps x {batch}x{seq} tokens, loss "
        f"first-5 mean {first:.4f} -> last-5 mean {last:.4f}; median step "
        f"{step_s * 1e3:.2f} ms, {batch * seq / step_s:.0f} tokens/s; "
        f"launches midx_probs {launches[0]}, sampled_ce_pt {launches[1]}, "
        f"sampled_ce_pt_bwd {launches[2]}")
    return cfg, params, index, launches, summary


def replay() -> None:
    """Phase 7, replay: two runs from one seed agree bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.data import ZipfLM
    from repro_torch.launch.train import train_loop
    from repro_torch.optim.optimizers import tree_leaves
    cfg = get_config("paper-lm")
    corpus = ZipfLM(vocab_size=cfg.vocab_size, num_clusters=64, seq_len=65,
                    seed=0).sample(64)
    runs = [train_loop(cfg, steps=30, batch_size=16, seq_len=64, lr=3e-3,
                       corpus=corpus, refresh_every=10, log_every=1000,
                       device="cuda") for _ in range(2)]

    def state(run):
        params, opt, index, _ = run
        return (tree_leaves(params) + tree_leaves(opt.mu) + tree_leaves(opt.nu)
                + [index.codebook1, index.codebook2, index.sorted_ids])

    if runs[0][3] != runs[1][3] or not all(
            torch.equal(a, b) for a, b in zip(state(runs[0]),
                                              state(runs[1]))):
        raise SystemExit("paper-lm training does not replay bit for bit on "
                         "the card")
    log(f"[smoke] train paper-lm replay: two 30-step runs (refresh every "
        f"10) agree bit for bit (final loss {runs[0][3][-1]:.6f})")


def profile_train(cfg, params, index, label: str) -> None:
    """Where a training step's time goes: 5 steps of the trained model
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
    toks = torch.randint(0, cfg.vocab_size, (16, 65), generator=gen,
                         device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    state = opt.init(params)
    keys = noise.train_keys(0, 0, 16 * 64, "cuda")
    p, state, _ = step(params, state, index, batch, keys)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            p, state, m = step(p, state, index, batch, keys)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type.name == "CUDA"
               and not e.key.startswith("train.")]
    busy_us = sum(e.self_device_time_total for e in kernels)
    n_kern = sum(e.count for e in kernels)
    log(f"[profile] {label}: 5 steps, wall {wall * 1e3:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms (idle share {1 - busy_us / 1e6 / wall:.3f}),"
        f" {n_kern} kernel launches")
    for e in events:
        if e.key.startswith("train.") and e.device_type.name == "CPU":
            log(f"[profile]   {e.key}: x{e.count}, host "
                f"{e.cpu_time_total / 1e3 / e.count:.3f} ms each")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    ours = [e for e in kernels if any(k in e.key for k in (
        "midx_probs", "fwd_kernel", "bwd_rows_kernel", "dtab_kernel"))]
    for e in top + [e for e in ours if e not in top]:
        log(f"[profile]   kernel {e.key[:60]}: x{e.count}, "
            f"{e.self_device_time_total / 1e3:.2f} ms "
            f"({e.self_device_time_total / max(busy_us, 1e-9):.3f} of busy)")


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
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    for e in top + [e for e in kernels if "midx_probs" in e.key]:
        log(f"[profile]   kernel {e.key[:60]}: x{e.count}, "
            f"{e.self_device_time_total / 1e3:.2f} ms "
            f"({e.self_device_time_total / max(busy_us, 1e-9):.3f} of busy)")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="also profile one llama3.2-1b run per head and 5 "
                         "paper-lm train steps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        sys.exit(2)
    import repro_torch  # noqa: F401  (fails without the repository)
    from repro_torch.configs import get_config
    from repro_torch.kernels.midx_probs import cuda as midx_cuda
    from repro_torch.kernels.midx_probs.ref import midx_probs_ref
    from repro_torch.kernels.sampled_ce import cuda as sce_cuda
    from repro_torch.kernels.sampled_ce.ref import (sampled_ce_pt_bwd_ref,
                                                    sampled_ce_pt_fwd_ref)

    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(f"[smoke] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    libraries = (midx_cuda.LIBRARY, sce_cuda.LIBRARY)
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

    buf = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")
    worst, timings = check_midx_probs(midx_cuda, midx_probs_ref, buf,
                                     card)
    sce_worst, sce_timings = check_sampled_ce(
        sce_cuda, sampled_ce_pt_fwd_ref, sampled_ce_pt_bwd_ref, buf, card)
    del buf
    check_against_cpu("paper-lm")

    counter = midx_cuda.midx_probs_cuda
    paper = get_config("paper-lm").with_serve(max_slots=4, page_size=16,
                                              max_seq=32)
    _, _, n_paper = serve(paper, head="midx", requests=16, prompt=8,
                          tokens=16, verify=2, counter=counter)
    llama = get_config("llama3.2-1b").with_serve(max_slots=4, page_size=16,
                                                 max_seq=112)
    eng, _, n_llama = serve(llama, head="midx", requests=8, prompt=64,
                            tokens=32, verify=2, counter=counter)
    greedy = llama.with_head(decode_temperature=0.0)
    eng_full, _, _ = serve(greedy, head="full", requests=8, prompt=64,
                           tokens=32, verify=2, params=eng.params)
    if args.profile:
        profile_run(eng, "llama3.2-1b head=midx", prompt=64, tokens=16)
        profile_run(eng_full, "llama3.2-1b head=full", prompt=64, tokens=16)
    del eng, eng_full
    torch.cuda.empty_cache()

    counters = (midx_cuda.midx_probs_cuda, sce_cuda.sampled_ce_pt_cuda,
                sce_cuda.sampled_ce_pt_bwd_cuda)
    cfg, params, index, n_train, _ = train(counters)
    replay()
    if args.profile:
        profile_train(cfg, params, index, "paper-lm train step")
    trained = cfg.with_serve(max_slots=4, page_size=16, max_seq=32)
    _, _, n_trained = serve(trained, head="midx", requests=8, prompt=8,
                            tokens=16, verify=2, params=params, index=index,
                            counter=counters[0])
    for name, n in (("paper-lm serve", n_paper), ("llama3.2-1b serve",
                                                  n_llama),
                    ("paper-lm train", n_train[0]),
                    ("trained paper-lm serve", n_trained)):
        if n <= 0:
            raise SystemExit(f"{name}: midx_probs was never launched on the "
                             "main path")
    for kname, n in zip(("sampled_ce_pt", "sampled_ce_pt_bwd"), n_train[1:]):
        if n <= 0:
            raise SystemExit(f"paper-lm train: {kname} was never launched")

    ms, plain, bound, by = timings["llama3.2-1b decode"]
    t_ms, t_plain, t_bound, t_by = timings["paper-lm train"]
    src = "src/repro_torch/kernels/sampled_ce/csrc/sampled_ce_pt.cu"
    rows = [{
        "name": "midx_probs", "route": "cuda",
        "source": "src/repro_torch/kernels/midx_probs/csrc/midx_probs.cu",
        "replaces": "src/repro/kernels/midx_probs/midx_probs.py:23",
        "launches": n_paper + n_llama + n_train[0] + n_trained,
        "max_abs_err": worst, "ms": ms, "plain_ms": plain, "bound_ms": bound,
        "bound_by": by, "library_ms": None,
        "shape": "llama3.2-1b decode T=4 D=2048 K=64 rq",
        "train": {"shape": "paper-lm train T=1024 D=200 K=32 rq",
                  "launches": n_train[0], "ms": t_ms, "plain_ms": t_plain,
                  "bound_ms": t_bound, "bound_by": t_by}}]
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
    log(json.dumps({"kernels": rows}))
    log(f"[smoke] done in {time.perf_counter() - t_start:.1f}s on {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
