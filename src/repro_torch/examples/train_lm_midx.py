"""End-to-end example: train an LM with the MIDX sampled-softmax head, with
index refresh and, given `--ckpt`, checkpoints.

Mirrors `examples/train_lm_midx.py`: smollm-135m, by default cut in depth
and width (4 layers, d=192, a vocabulary of `--vocab` classes) to run on
the CPU in minutes; `--full-width` trains the whole config (30 layers,
d=576, V=49 152) on the card. `--head midx` (per-token proposals, K=64,
M=128, a refresh every 50 steps) or `--head full`. Departures: `--device`
(default: the card); no checkpoints unless `--ckpt` names a directory
(the reference writes `/tmp/repro_ckpt_lm`); `main` returns the losses.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm_midx --steps 200
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.configs import get_config
from repro_torch.data import ZipfLM
from repro_torch.launch.train import train_loop


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "train_lm_midx")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--head", default="midx", choices=("midx", "full"))
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint dir (default: none)")
    ap.add_argument("--full-width", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' must be asked)")
    args = ap.parse_args(argv)

    cfg = get_config("smollm-135m")
    if not args.full_width:
        cfg = dataclasses.replace(
            cfg, num_layers=4, d_model=192, num_heads=3, num_kv_heads=3,
            head_dim=64, d_ff=512, vocab_size=args.vocab,
            vocab_pad_multiple=64)
    cfg = cfg.with_head(mode=args.head, midx_k=64, num_negatives=128,
                        proposal="per_token", refresh_every=50)

    gen = ZipfLM(vocab_size=cfg.vocab_size, num_clusters=128,
                 seq_len=args.seq + 1, seed=0)
    corpus = gen.sample(512)
    _, _, _, hist = train_loop(
        cfg, steps=args.steps, batch_size=args.batch, seq_len=args.seq,
        corpus=corpus, ckpt_dir=args.ckpt, ckpt_every=100,
        head_mode=args.head, lr=1e-3, log_every=10, device=args.device)
    print("done" + (f"; checkpoints in {args.ckpt}" if args.ckpt else ""))
    return {"hist": hist, "head": args.head, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "vocab": cfg.vocab_size,
            "finite": bool(np.all(np.isfinite(hist)))}


if __name__ == "__main__":
    main()
