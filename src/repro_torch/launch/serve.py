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
  --head rff       : the same proposal, drawn by plain torch ops;
  --head midx-learnable : the learnable-codebook index's two-stage draw
                     (the midx_probs kernel on the card), as --head midx;
  --head uniform | unigram | sphere | lsh | tapas : candidates drawn from
                     that contender (`repro_torch.proposals`, its state
                     built from the params; unigram without corpus
                     frequencies is uniform, as in the reference).
Synthetic open-loop traffic (Poisson arrivals at --rate req/s; 0 = all at
t0); reports tokens/s and p50/p95/p99 per-token latency, and replays
--verify requests alone, requiring identical tokens.

The serving tier (reference :15-23, dense family only):
  --spec-decode K    MIDX-draft speculative decoding: K drafts a wave from
                     the midx_probs kernel's tables, one chunked backbone
                     pass and one batched full-head verify; reports the
                     acceptance rate (--head midx; with --greedy the
                     greedy verify, token-identical to greedy full head)
  --prefill-chunk N  page-aligned prefill chunks of N tokens interleaved
                     with decode waves (a chunk of a multiple of 128 runs
                     its attention in the flash kernel)
  --prefix-cache     refcounted prompt-prefix page sharing (chunked, by
                     default one page a chunk)
  --shared-prefix F  that fraction of requests starts with one page-aligned
                     common prefix of ~half the prompt (the same traffic as
                     the reference's generator for the same seed)
  --replicas N       N engine replicas behind the load-weighted router,
                     sharing params and index (on one card, they share it)
  --max-seq, --num-pages, --window  per-slot capacity, pool size and the
                     sliding window, as in the reference.

The index lifecycle (reference :43-63, :236-258, DESIGN §8; --head
midx):
  --swap-step N      hot-swap a freshly rebuilt index (a copy of the
                     restored one with --ckpt) before decode step N; the
                     params are frozen, so the rebuild is the boot index
                     bit for bit and --verify still holds across the swap
  --stale-sigma S    serve from an index fit to the class table plus S
                     times Gaussian noise (simulated staleness), report the
                     proposal KL(softmax ‖ Q) stale against refreshed, and
                     skip --verify (tokens change where the fresh index
                     swaps in)
Both refuse --head full, which has no index.

The other flags are the reference's: --arch --reduced --traffic (its one
choice, synthetic) --requests --rate --prompt --tokens --max-slots
--page-size --head --table-dtype --num-candidates --temperature --greedy
--seed --ckpt --verify --warmup, plus --device (default: the card).
--table-dtype int8 / fp8 serves the MIDX head from a quantized state
(reference `launch/serve.py:139`, `:192`): the draw scores the low-bit
codebooks (the midx_probs kernel's quantized mode on the card, also for
the speculative draft) and the candidates are rescored from residual PQ
codes, not [V, D] rows. --ckpt restores params and head state from a
serving checkpoint dir, e.g. the `<ckpt>/serve` export of either
package's `train_loop` (reference `launch/serve.py:168-169`, `:213-214`).

  python -m repro_torch.launch.serve --arch llama3.2-1b --head midx
  python -m repro_torch.launch.serve --arch llama3.2-1b --spec-decode 4
  python -m repro_torch.launch.serve --arch llama3.2-1b --prompt 2048 --prefill-chunk 512 --prefix-cache --shared-prefix 0.8
  python -m repro_torch.launch.serve --arch llama3.2-1b --replicas 2 --requests 16
  python -m repro_torch.launch.serve --arch llama3.2-1b --head rff-fused
  python -m repro_torch.launch.serve --arch llama3.2-1b --head midx --table-dtype int8
  python -m repro_torch.launch.serve --arch mamba2-370m --prompt 512
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced --spec-decode 4 --prefix-cache --shared-prefix 0.8 --replicas 2
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced --ckpt build/ck-cpu/serve
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m --device cpu --reduced
  python -m repro_torch.launch.serve --arch llama3.2-1b --swap-step 8
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced --stale-sigma 0.5 --swap-step 2
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import pad_to
from repro_torch.core import midx
from repro_torch.index.lifecycle import clone_tensors
from repro_torch.index.quantized import unwrap_index
from repro_torch.models.model import class_embeddings
from repro_torch.proposals import registry as proposals_registry
from repro_torch.serve import Engine, Request, Router


def proposal_kl(cfg, params, index, seed: int, probes: int = 16) -> float:
    """Mean KL(full softmax ‖ MIDX proposal) over `probes` random queries
    drawn from a generator seeded `seed`: the serving-quality number an
    index swap moves (DESIGN §8)."""
    table = class_embeddings(cfg, params).float()
    gen = torch.Generator(device=table.device)
    gen.manual_seed(seed)
    return float(midx.proposal_kl(unwrap_index(index), table, gen, probes))


def make_stale_index(cfg, engine: Engine, sigma: float, seed: int):
    """A head state fit to where the class table was `sigma` of drift ago
    (table + sigma * N(0, 1) noise from a generator seeded
    seed ^ 0x5747A7E), rebuilt by the engine as its boot state was
    (`Engine.rebuild_index(table=)`; a quantized engine's low-bit twins
    come from the same stale table): serving against a stale index, so
    the --swap-step swap has a KL gap to close."""
    table = class_embeddings(cfg, engine.params).float()
    g_noise = torch.Generator(device=table.device)
    g_noise.manual_seed(seed ^ 0x5747A7E)
    noise = torch.randn(table.shape, generator=g_noise, device=table.device)
    return engine.rebuild_index(table=table + sigma * noise)


def prompt_buckets(prompt: int) -> list[int]:
    """Prompt-length bucket set (all <= prompt) — shared by traffic
    generation and warmup."""
    return sorted({max(1, prompt // 2), max(1, (3 * prompt) // 4), prompt})


def synthetic_requests(cfg, *, num: int, prompt: int, max_new: int,
                       rate: float, seed: int,
                       shared_prefix: float = 0.0) -> list[Request]:
    """Open-loop synthetic traffic: prompt lengths from a small bucket set,
    Poisson arrivals at `rate` req/s. With `shared_prefix` in (0, 1] that
    fraction of the requests longer than the prefix start with one
    page-aligned common prefix of ~half the prompt (a shared system
    prompt). The generator is drawn from exactly as the reference's
    (reference :86-113), so a seed gives the reference's traffic."""
    rng = np.random.default_rng(seed)
    buckets = prompt_buckets(prompt)
    arrivals = (np.cumsum(rng.exponential(1.0 / rate, size=num))
                if rate > 0 else np.zeros(num))
    pfx_len = max(cfg.serve.page_size, (prompt // 2)
                  // cfg.serve.page_size * cfg.serve.page_size)
    prefix = rng.integers(0, cfg.vocab_size, size=pfx_len).astype(np.int32)
    reqs = []
    for i in range(num):
        plen = int(rng.choice(buckets))
        toks = rng.integers(0, cfg.vocab_size, size=plen).astype(np.int32)
        if shared_prefix > 0 and rng.random() < shared_prefix \
                and plen > pfx_len:
            toks[:pfx_len] = prefix
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
    # a speculative wave writes up to spec_decode - 1 scratch positions past
    # the committed token, so the fitted per-slot budget covers them too
    max_seq = args.max_seq or pad_to(
        args.prompt + args.tokens + max(args.spec_decode, 1), args.page_size)
    return cfg.with_serve(max_slots=args.max_slots, page_size=args.page_size,
                          max_seq=max_seq, num_pages=args.num_pages,
                          spec_decode=args.spec_decode,
                          prefill_chunk=args.prefill_chunk,
                          prefix_cache=args.prefix_cache)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="paper-lm")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--traffic", default="synthetic", choices=("synthetic",))
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="open-loop arrival rate in req/s (0 = all at t0)")
    ap.add_argument("--prompt", type=int, default=8,
                    help="max prompt length (lengths mix below it)")
    ap.add_argument("--tokens", type=int, default=16,
                    help="tokens per request")
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=0,
                    help="per-slot capacity (0 = fit prompt+tokens)")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="physical pool size (0 = full residency)")
    ap.add_argument("--head", default="midx",
                    choices=proposals_registry.proposal_modes())
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
                    help="temperature-0 decoding; with --spec-decode the "
                         "greedy verify is token-identical to full-head "
                         "greedy decode (needs --head full or --spec-decode)")
    ap.add_argument("--spec-decode", type=int, default=0,
                    help="speculative decoding: K MIDX drafts per wave, one "
                         "batched full-head verify (0 = off)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prefill-token budget per wave: prompts prefill in "
                         "page-aligned chunks interleaved with decode waves "
                         "(0 = whole-prompt batched prefill)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share prompt-prefix KV pages across requests via "
                         "the refcounted prefix trie")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind the load-weighted router; "
                         "replicas share params + index")
    ap.add_argument("--shared-prefix", type=float, default=0.0,
                    help="fraction of requests whose prompt starts with a "
                         "common prefix (exercises --prefix-cache)")
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None,
                    help="restore params+index from a serving checkpoint dir")
    ap.add_argument("--verify", type=int, default=2,
                    help="replay N requests solo and require identical output")
    ap.add_argument("--swap-step", type=int, default=-1,
                    help="hot-swap a freshly rebuilt index before this "
                         "decode step (DESIGN §8); serving params are "
                         "frozen, so the rebuild is bit-identical and "
                         "--verify must still pass across the swap")
    ap.add_argument("--stale-sigma", type=float, default=0.0,
                    help="serve against an index fit to a sigma-perturbed "
                         "class table (simulated staleness) and report the "
                         "proposal KL gap the --swap-step swap closes; "
                         "disables --verify")
    ap.add_argument("--warmup", type=int, default=1,
                    help="run a warmup first so reported latency percentiles "
                         "are steady-state (0 disables)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' must be asked)")
    return ap


def main(argv=None) -> dict:
    """Run the CLI; returns {"summary", "results", "verified"}."""
    args = parser().parse_args(argv)
    swapping = args.swap_step >= 0 or args.stale_sigma > 0
    if swapping and args.head == "full":
        raise SystemExit("--swap-step/--stale-sigma exercise the MIDX index "
                         "lifecycle; --head full has no index to swap")
    cfg = build_config(args)
    window = args.window or None
    if args.ckpt:
        engine = Engine.from_checkpoint(cfg, args.ckpt, head=args.head,
                                        window=window, device=args.device,
                                        seed=args.seed)
    else:
        engine = Engine(cfg, head=args.head, window=window,
                        device=args.device, seed=args.seed)
    replicas = [engine] + [
        Engine(cfg, engine.params, index=engine.index, head=args.head,
               window=window, device=engine.device)
        for _ in range(1, max(args.replicas, 1))]
    router = Router(replicas) if len(replicas) > 1 else None
    reqs = synthetic_requests(cfg, num=args.requests, prompt=args.prompt,
                              max_new=args.tokens, rate=args.rate,
                              seed=args.seed,
                              shared_prefix=args.shared_prefix)
    if not reqs:
        print("[serve] no requests to run")
        return {"summary": {}, "results": {}, "verified": 0}
    if args.warmup:
        for eng in replicas:
            eng.warmup(prompt_buckets(args.prompt))
    kl = None
    if args.head == "midx" and swapping:
        # a restored index was built under the trainer's refresh seed, so a
        # local rebuild would not be bit for bit it: swap a copy instead
        fresh = (clone_tensors(engine.index) if args.ckpt
                 else engine.rebuild_index())
        if args.stale_sigma > 0:
            stale = make_stale_index(cfg, engine, args.stale_sigma,
                                     args.seed)
            kl = {"stale": proposal_kl(cfg, engine.params, stale,
                                       args.seed + 1),
                  "refreshed": proposal_kl(cfg, engine.params, fresh,
                                           args.seed + 1)}
            print(f"[serve] proposal KL(softmax‖Q): stale={kl['stale']:.4f} "
                  f"refreshed={kl['refreshed']:.4f} (gap the swap closes: "
                  f"{kl['stale'] - kl['refreshed']:.4f})")
            for eng in replicas:
                eng.swap_index(stale)
        if args.swap_step >= 0:
            for eng in replicas:
                eng.schedule_swap(fresh, at_step=args.swap_step)
            print(f"[serve] index hot-swap scheduled before decode step "
                  f"{args.swap_step}")
    if router is not None:
        results = router.run(reqs)
        s, stats = router.summary(), router.stats()
    else:
        results = engine.run(reqs)
        s, stats = engine.stats.summary(), engine.stats
    print(f"[serve] head={args.head} arch={cfg.name} device={engine.device} "
          f"requests={args.requests} slots={args.max_slots} "
          f"replicas={len(replicas)} "
          f"waves={s['waves']} generated={s['generated']} "
          f"tok/s={s['tok_s']} p50={s['p50_ms']}ms p95={s['p95_ms']}ms "
          f"p99={s['p99_ms']}ms")
    if args.spec_decode:
        print(f"[serve] speculative: k={args.spec_decode} "
              f"waves={stats.spec_waves} drafted={stats.spec_drafted} "
              f"accepted={stats.spec_accepted} "
              f"acceptance={stats.accept_rate():.3f}")
    if args.prefix_cache:
        counters = {}
        for eng in replicas:
            for k, v in eng.cache.counters().items():
                counters[k] = counters.get(k, 0) + v
        hits, misses = counters["cache_hits"], counters["cache_misses"]
        print(f"[serve] prefix cache: hits={hits} misses={misses} "
              f"hit_rate={hits / max(hits + misses, 1):.3f} "
              f"evictions={counters['cache_evictions']} "
              f"cached_pages={counters['cached_pages']}")
    if router is not None:
        print(f"[serve] router: routed_per_replica="
              f"{router.rstats.per_replica} shed={router.rstats.shed}")
    if swapping:
        print(f"[serve] index swaps={stats.swaps} "
              f"rejected={stats.swap_rejected}")
    n_verify = min(args.verify, len(reqs))
    if args.stale_sigma > 0 and n_verify:
        print("[serve] --stale-sigma active: skipping verify (tokens "
              "legitimately change when the refreshed index swaps in)")
        n_verify = 0
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
    return {"summary": s, "results": results, "verified": n_verify - bad,
            "kl": kl}


if __name__ == "__main__":
    main()
