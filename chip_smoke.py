"""Chip smoke test for the PyTorch / CUDA port (`src/repro_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package. Phases, each fatal:
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel of the serving path from the sources in the
     checkout (one: `kernels/midx_probs/csrc/midx_probs.cu`);
  3. hold each kernel against its plain torch version on the card, at the
     main path's shapes and a sweep around them, with TF32 off; time the
     kernel and the plain version with CUDA events (median of 50 cold-L2
     launches) beside the bound (bytes over 3.35 TB/s, FLOPs over 67 TFLOP/s
     fp32);
  4. check the port against itself on the CPU at a small input (prefill
     hidden states, fp32);
  5. serve `paper-lm` at full width through the MIDX head (16 requests,
     4 slots, 16 tokens), with batched == solo on 2 requests;
  6. serve `llama3.2-1b` at full width through the MIDX head (8 requests,
     4 slots, prompt 64, 32 tokens), then once with the full head, greedy,
     batched == solo;
  7. print the kernels' JSON line, then the result line.
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
            for t in (1, 4, 8, 33, 512):
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
        f"(D,K) in {{(200,32),(2048,64)}}, pq/rq, T in {{1,4,8,33,512}} "
        f"(tol {REL_TOL}*max(1,|ref|))")
    timings = {}
    for name, (t, d, k, split) in (
            ("paper-lm decode", (4, 200, 32, False)),
            ("llama3.2-1b decode", (4, 2048, 64, False)),
            ("llama3.2-1b T=8", (8, 2048, 64, False)),
            ("llama3.2-1b T=512", (512, 2048, 64, False)),
            ("llama3.2-1b decode pq", (4, 2048, 64, True))):
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
          verify: int, params=None, counter=None):
    """Drive `Engine` on the card; returns (engine, summary, launches)."""
    from repro_torch.launch.serve import prompt_buckets, synthetic_requests
    from repro_torch.serve import Engine
    t0 = time.perf_counter()
    engine = Engine(cfg, params, head=head, device="cuda", seed=0)
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
                    help="also profile one llama3.2-1b run per head")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        sys.exit(2)
    import repro_torch  # noqa: F401  (fails without the repository)
    from repro_torch.configs import get_config
    from repro_torch.kernels.midx_probs import cuda as midx_cuda
    from repro_torch.kernels.midx_probs.ref import midx_probs_ref

    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(f"[smoke] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    midx_cuda.load()
    log(f"[smoke] built midx_probs in {time.perf_counter() - t0:.1f}s "
        f"(nvcc {midx_cuda.build_seconds:.1f}s)")
    for line in midx_cuda.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[smoke]   ptxas: {line.strip()}")

    buf = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")
    worst, timings = check_midx_probs(midx_cuda, midx_probs_ref, buf,
                                     card)
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
    for name, n in (("paper-lm", n_paper), ("llama3.2-1b", n_llama)):
        if n <= 0:
            raise SystemExit(f"{name}: midx_probs was never launched on the "
                             "main path")

    ms, plain, bound, by = timings["llama3.2-1b decode"]
    log(json.dumps({"kernels": [{
        "name": "midx_probs", "route": "cuda",
        "source": "src/repro_torch/kernels/midx_probs/csrc/midx_probs.cu",
        "replaces": "src/repro/kernels/midx_probs/midx_probs.py:23",
        "launches": n_paper + n_llama, "max_abs_err": worst,
        "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
        "library_ms": None}]}))
    log(f"[smoke] done in {time.perf_counter() - t_start:.1f}s on {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
