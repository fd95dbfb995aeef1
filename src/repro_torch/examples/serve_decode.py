"""Serving example: the continuous-batching engine with the exact head
against the MIDX decode head (next-token sampling without the [B, V]
logits matrix; DESIGN §5).

Mirrors `examples/serve_decode.py`: paper-lm on 4 slots, 8 requests of 8
prompt tokens and 24 new ones, served by the full head and then by the
MIDX head on the same weights. Departures: `--device` (default: the
card); the engines draw from their own seed (`Engine(seed=0)`), and
`main` returns each head's summary.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_decode [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.serve import Engine, Request


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "serve_decode")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' must be asked)")
    args = ap.parse_args(argv)
    cfg = get_config("paper-lm").with_serve(max_slots=4, page_size=16,
                                            max_seq=48)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    tokens=rng.integers(0, cfg.vocab_size,
                                        size=8).astype(np.int32),
                    max_new=24) for i in range(8)]
    params, out = None, {}
    for head in ("full", "midx"):
        eng = Engine(cfg, params, head=head, device=args.device)
        params = eng.params          # share weights across both heads
        eng.run(reqs)
        s = out[head] = eng.stats.summary()
        print(f"[serve_decode] head={head}: {s['tok_s']} tok/s over "
              f"{s['generated']} tokens in {s['waves']} admission waves "
              f"(p50 {s['p50_ms']}ms)")
    return out


if __name__ == "__main__":
    main()
