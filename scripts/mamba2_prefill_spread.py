"""mamba2-370m prefill latency on one CUDA card, repeated for its spread.

Serves the four requests of `chip_smoke.py`'s mamba2 phase (prompts of 64,
512, 64 and 512 tokens, 16 new tokens each, on 4 slots, weights drawn from
seed 0) through `repro_torch.serve.Engine`, with the MIDX head and with the
full head (greedy), `--repeats` times in turn. Each run prints its
first-token latency per prompt group, its median token latency and its
tokens/s; the summary gives each figure's median, least and largest value.
It also times one `ssd_scan` call at each prefill group's shape (Bt=2,
S=512 Q=256 and S=64 Q=64): the host's time to issue it, and the time per
call on the card, over `--calls` calls issued back to back; and, as a
gauge of the host's speed in this process, the host's time to issue one
`torch.add` of the same x.

    PYTHONPATH=src python3 scripts/mamba2_prefill_spread.py --repeats 5

It calls only entry points that every version of the port with the scan
kernel has, so the same file measures an older checkout:
`PYTHONPATH=<checkout>/src python3 scripts/mamba2_prefill_spread.py`.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PROMPTS = (64, 512, 64, 512)
NEW_TOKENS = 16


def serve_once(engine, requests) -> dict:
    t0 = time.perf_counter()
    results = engine.run(requests)
    wall = time.perf_counter() - t0
    lat = [x for r in results.values() for x in r.latencies_s]
    if any(r.status != "ok" or len(r.tokens) != NEW_TOKENS
           for r in results.values()):
        raise SystemExit("a request did not finish")
    first = {n: 1e3 * statistics.median(
        results[r.rid].latencies_s[0] for r in requests if len(r.tokens) == n)
        for n in sorted(set(PROMPTS))}
    return {"prefill_ms": first, "p50_ms": 1e3 * statistics.median(lat),
            "tok_s": len(lat) / wall}


def time_scan(calls: int) -> dict:
    from repro_torch.kernels.ssd_scan.cuda import ssd_scan_cuda
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for s, q in ((512, 256), (64, 64)):
        bt, h, p, n = 2, 32, 64, 128
        x = torch.randn(bt, s, h, p, device="cuda", generator=g)
        bm = torch.randn(bt, s, n, device="cuda", generator=g)
        cm = torch.randn(bt, s, n, device="cuda", generator=g)
        dt = torch.rand(bt, s, h, device="cuda", generator=g) * 0.1
        adt = -dt * torch.rand(bt, s, h, device="cuda", generator=g)
        for _ in range(3):
            ssd_scan_cuda(x, bm, cm, adt, dt, chunk=q)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        t0 = time.perf_counter()
        start.record()
        for _ in range(calls):
            ssd_scan_cuda(x, bm, cm, adt, dt, chunk=q)
        host = time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize()
        out[f"Bt=2 S={s} Q={q}"] = {
            "host_us_per_call": 1e6 * host / calls,
            "card_us_per_call": 1e3 * start.elapsed_time(end) / calls}
    sink = torch.empty_like(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        torch.add(x, 1.0, out=sink)
    out["torch.add host_us_per_call"] = 1e6 * (time.perf_counter() - t0) \
        / calls
    torch.cuda.synchronize()
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("mamba2_prefill_spread: torch sees no CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.serve import Engine, Request
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = get_config("mamba2-370m").with_serve(
        max_slots=4, page_size=16, max_seq=max(PROMPTS) + 32)
    midx = Engine(cfg, None, index=None, head="midx", device="cuda", seed=0)
    full = Engine(cfg.with_head(decode_temperature=0.0), midx.params,
                  index=None, head="full", device="cuda", seed=0)
    rng = np.random.default_rng(7)
    requests = [Request(rid=i, tokens=rng.integers(0, cfg.vocab_size, size=n)
                        .astype(np.int32), max_new=NEW_TOKENS, seed=3)
                for i, n in enumerate(PROMPTS)]
    for engine in (midx, full):
        engine.warmup(sorted(set(PROMPTS)))
    runs = {"midx": [], "full": []}
    for rep in range(args.repeats):
        for head, engine in (("midx", midx), ("full", full)):
            r = serve_once(engine, requests)
            runs[head].append(r)
            print(f"[spread] {args.label} run {rep} head={head}: first "
                  f"token " + ", ".join(f"{n} tokens {ms:.2f} ms" for n, ms
                                         in r["prefill_ms"].items())
                  + f"; p50 {r['p50_ms']:.2f} ms; {r['tok_s']:.1f} tok/s",
                  flush=True)
    summary = {}
    for head, rs in runs.items():
        figures = {f"prefill_{n}_ms": [r["prefill_ms"][n] for r in rs]
                   for n in sorted(set(PROMPTS))}
        figures.update(p50_ms=[r["p50_ms"] for r in rs],
                       tok_s=[r["tok_s"] for r in rs])
        summary[head] = {k: {"median": statistics.median(v), "min": min(v),
                             "max": max(v)} for k, v in figures.items()}
    print(json.dumps({"label": args.label, "card": card,
                      "serve": summary, "ssd_scan": time_scan(args.calls)}))


if __name__ == "__main__":
    main()
