"""Serving CLI: a thin command line over `repro_torch.serve.Engine`.

Mirrors `src/repro/launch/serve.py` for what the port serves (the dense
family and the ssm family, `--arch mamba2-370m`): continuous batching over
a paged KV pool (slot-major carries for ssm), batched single-pass prefill,
and the decode heads —
  --head midx      : MIDX sampling head (default): candidates drawn through
                     the index (proposal tables from the midx_probs CUDA
                     kernel on the card), rescored exactly, IS-corrected;
  --head full      : exact [B, V] logits each step;
  --head rff-fused : candidates drawn from the RFF proposal (the rff_sample
                     CUDA kernel on the card), rescored, IS-corrected;
  --head rff       : the same proposal, drawn by plain torch ops.
Synthetic open-loop traffic (Poisson arrivals at --rate req/s; 0 = all at
t0); reports tokens/s and p50/p95/p99 per-token latency, and replays
--verify requests alone, requiring identical tokens.

The flags are the reference's for what this slice supports: --arch
--reduced --requests --rate --prompt --tokens --max-slots --page-size
--head --table-dtype --num-candidates --temperature --greedy --seed --ckpt
--verify --warmup, plus --device (default: the card). Any other flag is
rejected. --table-dtype int8 / fp8 serves the MIDX head from a quantized
state (reference `launch/serve.py:139`, `:192`): the draw scores the
low-bit codebooks (the midx_probs kernel's quantized mode on the card) and
the candidates are rescored from residual PQ codes, not [V, D] rows.
--ckpt restores params and head state from a serving checkpoint dir, e.g.
the `<ckpt>/serve` export of either package's `train_loop` (reference
`launch/serve.py:168-169`, `:213-214`).

  python -m repro_torch.launch.serve --arch llama3.2-1b --head midx
  python -m repro_torch.launch.serve --arch llama3.2-1b --head rff-fused
  python -m repro_torch.launch.serve --arch llama3.2-1b --head midx --table-dtype int8
  python -m repro_torch.launch.serve --arch mamba2-370m --prompt 512
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced --ckpt build/ck-cpu/serve
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m --device cpu --reduced
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import pad_to
from repro_torch.proposals import registry as proposals_registry
from repro_torch.serve import Engine, Request


def prompt_buckets(prompt: int) -> list[int]:
    """Prompt-length bucket set (all <= prompt) — shared by traffic
    generation and warmup."""
    return sorted({max(1, prompt // 2), max(1, (3 * prompt) // 4), prompt})


def synthetic_requests(cfg, *, num: int, prompt: int, max_new: int,
                       rate: float, seed: int) -> list[Request]:
    """Open-loop synthetic traffic: prompt lengths from a small bucket set,
    Poisson arrivals at `rate` req/s. The same seed gives the same traffic
    as the reference's generator without a shared prefix."""
    rng = np.random.default_rng(seed)
    buckets = prompt_buckets(prompt)
    arrivals = (np.cumsum(rng.exponential(1.0 / rate, size=num))
                if rate > 0 else np.zeros(num))
    pfx_len = max(cfg.serve.page_size, (prompt // 2)
                  // cfg.serve.page_size * cfg.serve.page_size)
    rng.integers(0, cfg.vocab_size, size=pfx_len)   # the reference's prefix
    reqs = []
    for i in range(num):
        plen = int(rng.choice(buckets))
        toks = rng.integers(0, cfg.vocab_size, size=plen).astype(np.int32)
        reqs.append(Request(rid=i, tokens=toks, max_new=max_new, seed=seed,
                            arrival=float(arrivals[i])))
    return reqs


def build_config(args):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    head_kw = {}
    if args.table_dtype is not None:
        head_kw["table_dtype"] = args.table_dtype
    if args.num_candidates:
        head_kw["decode_candidates"] = args.num_candidates
    if args.temperature:
        head_kw["decode_temperature"] = args.temperature
    if args.greedy:
        head_kw["decode_temperature"] = 0.0
    if head_kw:
        cfg = cfg.with_head(**head_kw)
    max_seq = pad_to(args.prompt + args.tokens + 1, args.page_size)
    return cfg.with_serve(max_slots=args.max_slots, page_size=args.page_size,
                          max_seq=max_seq)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="paper-lm")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="open-loop arrival rate in req/s (0 = all at t0)")
    ap.add_argument("--prompt", type=int, default=8,
                    help="max prompt length (lengths mix below it)")
    ap.add_argument("--tokens", type=int, default=16,
                    help="tokens per request")
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--head", default="midx",
                    choices=proposals_registry.PORTED_MODES)
    ap.add_argument("--table-dtype", default=None,
                    help="hot-path class-table format (bf16|int8|fp8, "
                         "DESIGN §12): the two-stage draw reads quantized "
                         "codebooks and the rescore reads PQ residual "
                         "codes instead of [V,D] rows")
    ap.add_argument("--num-candidates", type=int, default=0,
                    help="MIDX decode candidates (0 = cfg.head default)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = cfg.head default)")
    ap.add_argument("--greedy", action="store_true",
                    help="temperature-0 decoding (needs --head full)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None,
                    help="restore params+index from a serving checkpoint dir")
    ap.add_argument("--verify", type=int, default=2,
                    help="replay N requests solo and require identical output")
    ap.add_argument("--warmup", type=int, default=1,
                    help="run a warmup first so reported latency percentiles "
                         "are steady-state (0 disables)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' must be asked)")
    return ap


def main(argv=None) -> dict:
    """Run the CLI; returns {"summary", "results", "verified"}."""
    args = parser().parse_args(argv)
    cfg = build_config(args)
    if args.ckpt:
        engine = Engine.from_checkpoint(cfg, args.ckpt, head=args.head,
                                        device=args.device, seed=args.seed)
    else:
        engine = Engine(cfg, head=args.head, device=args.device,
                        seed=args.seed)
    reqs = synthetic_requests(cfg, num=args.requests, prompt=args.prompt,
                              max_new=args.tokens, rate=args.rate,
                              seed=args.seed)
    if not reqs:
        print("[serve] no requests to run")
        return {"summary": {}, "results": {}, "verified": 0}
    if args.warmup:
        engine.warmup(prompt_buckets(args.prompt))
    results = engine.run(reqs)
    s = engine.stats.summary()
    print(f"[serve] head={args.head} arch={cfg.name} device={engine.device} "
          f"requests={args.requests} slots={args.max_slots} "
          f"waves={s['waves']} generated={s['generated']} "
          f"tok/s={s['tok_s']} p50={s['p50_ms']}ms p95={s['p95_ms']}ms "
          f"p99={s['p99_ms']}ms")
    n_verify = min(args.verify, len(reqs))
    bad = 0
    for r in reqs[:n_verify]:
        if results[r.rid].status != "ok":
            continue
        if not np.array_equal(results[r.rid].tokens, engine.replay_single(r)):
            bad += 1
            print(f"[serve] VERIFY FAILED rid={r.rid}: batched != solo",
                  file=sys.stderr)
    if n_verify:
        print(f"[serve] verify {n_verify - bad}/{n_verify} requests: "
              f"batched == solo")
    if bad:
        raise SystemExit(1)
    print("[serve] sample output ids:",
          results[reqs[0].rid].tokens[:8].tolist())
    return {"summary": s, "results": results, "verified": n_verify - bad}


if __name__ == "__main__":
    main()
