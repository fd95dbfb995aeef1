"""The spread of the pooled-head training losses over seeds, on one CUDA
card, and of the paper-lm per-token runs beside them.

Trains the three pooled-head runs of `chip_smoke.py` as the smoke does
(the same configurations, steps, batch, sequence, learning rate, head
refresh and corpus) once per `--seeds` value, the seed setting the
weights, the batch order and the head's draws (`train_loop(seed=...)`);
the corpus stays the smoke's (drawn from ZipfLM seed 0):

- `llama`: llama3.2-1b, 60 steps of 4 x 256;
- `train_4k`: llama3.2-1b, 20 steps of 2 x 4096;
- `mamba2`: mamba2-370m, 30 steps of 4 x 1024;

and, with `--runs paper_lm paper_lm_rff`, the smoke's two paper-lm
per-token runs (120 steps of 16 x 64, lr 3e-3, the config's refresh, the
corpus `train_loop` draws at seed 0), through the MIDX head and through
the rff-fused proposal.

Each run prints its first step's loss and gradient norm (which two
versions of the port should give alike, up to rounding), its first-5 and
last-5 mean losses (the smoke reads the last) and every step's loss. One
JSON object on stdout at the end.

    PYTHONPATH=src python3 scripts/pooled_loss_spread.py --seeds 0 1 2

It calls only entry points that every version of the port with these
configurations has, so the same file measures an older checkout:
`PYTHONPATH=<checkout>/src python3 scripts/pooled_loss_spread.py`.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

# (config, head mode, steps, batch, seq, lr, refresh every), as
# chip_smoke.py trains; None: the config's own
RUNS = {"llama": ("llama3.2-1b", None, 60, 4, 256, 1e-3, 25),
        "train_4k": ("llama3.2-1b", None, 20, 2, 4096, 1e-3, 10),
        "mamba2": ("mamba2-370m", None, 30, 4, 1024, 1e-3, 10),
        "paper_lm": ("paper-lm", None, 120, 16, 64, 3e-3, None),
        "paper_lm_rff": ("paper-lm", "rff-fused", 120, 16, 64, 3e-3, None)}
POOLED = ("llama", "train_4k", "mamba2")
LLAMA_CORPUS = 32              # the smoke's llama corpus: 32 x 257 tokens


def corpora(get_config, zipf) -> dict:
    """The smoke's corpora: llama's 32 x 257 draw (train_4k cuts 2 x 4097
    out of it), and mamba2's, the draw `train_loop` makes at seed 0."""
    llama = zipf(vocab_size=get_config("llama3.2-1b").vocab_size,
                 num_clusters=64, seq_len=257, seed=0).sample(LLAMA_CORPUS)
    long = llama.reshape(-1)[:2 * 4097].reshape(2, 4097)
    mamba = zipf(vocab_size=get_config("mamba2-370m").vocab_size,
                 num_clusters=64, seq_len=1025, seed=0).sample(512)
    paper = zipf(vocab_size=get_config("paper-lm").vocab_size,
                 num_clusters=64, seq_len=65, seed=0).sample(512)
    return {"llama": llama, "train_4k": long, "mamba2": mamba,
            "paper_lm": paper, "paper_lm_rff": paper}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--runs", nargs="+", default=list(POOLED),
                    choices=list(RUNS))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("pooled_loss_spread: torch sees no CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.data import ZipfLM
    from repro_torch.launch.train import train_loop
    data = corpora(get_config, ZipfLM)
    out = {"label": args.label, "runs": {}}
    for run in args.runs:
        name, mode, steps, batch, seq, lr, refresh = RUNS[run]
        cfg = get_config(name)
        if mode is not None:
            cfg = cfg.with_head(mode=mode)
        out["runs"][run] = {}
        for seed in args.seeds:
            seen = []
            _, _, _, hist = train_loop(
                cfg, steps=steps, batch_size=batch, seq_len=seq,
                lr=lr, corpus=data[run], refresh_every=refresh, seed=seed,
                log_every=1000, device="cuda",
                on_metrics=lambda step, m: seen.append(
                    (float(m["loss"]), float(m["grad_norm"]))))
            torch.cuda.empty_cache()
            got = {"first_loss": seen[0][0], "first_grad_norm": seen[0][1],
                   "first5": float(np.mean(hist[:5])),
                   "last5": float(np.mean(hist[-5:])),
                   "losses": [float(x) for x in hist]}
            out["runs"][run][seed] = got
            print(f"[spread] {args.label} {run} seed {seed}: first step loss "
                  f"{got['first_loss']!r} grad norm "
                  f"{got['first_grad_norm']!r}; first-5 {got['first5']:.4f}"
                  f" -> last-5 {got['last5']:.4f}", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
