"""Quickstart: the MIDX sampler as a standalone library component.

Mirrors `examples/quickstart.py`: builds an inverted multi-index over class
embeddings, samples negatives through the two-stage proposal, computes the
corrected sampled-softmax loss against the full softmax, and checks
Theorem 2's closed form and KL(MIDX‖P) against KL(uniform‖P) numerically.
Departures: randomness from explicit `torch.Generator`s and the sampler's
counter-hash row keys (`core.noise`), where the reference splits one JAX
key; `--device` (default: the card).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
import math

import torch

from repro_torch import resolve_device
from repro_torch.core import (build, full_softmax_loss, midx, noise,
                              sampled_softmax_from_embeddings)

N, D, K, M = 5000, 64, 32, 50
Q = 8                        # queries


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "quickstart")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' must be asked)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(seed)

    # 1. class embeddings (your output layer / item table / label embeddings)
    class_emb = torch.randn((N, D), generator=gen(0), device=dev) * 0.3

    # 2. build the inverted multi-index (product or residual quantization)
    index = build(gen(1), class_emb, kind="rq", k=K, iters=10)
    nonempty = int((index.counts > 0).sum())
    print(f"built multi-index: {K} codewords x 2 codebooks over {N} "
          f"classes; non-empty clusters: {nonempty}")

    # 3. queries (e.g. transformer hidden states)
    z = torch.randn((Q, D), generator=gen(2), device=dev) * 0.5

    # 4. sample M negatives per query + proposal log-probs, O(K D + K^2)
    draw = midx.sample_twostage(index, z, M,
                                noise.train_keys(3, 0, Q, device=dev))
    print("sampled ids:", draw.ids[0, :8].tolist())
    print("log q:", [round(float(x), 3) for x in draw.log_q[0, :4]])

    # 5. corrected sampled-softmax loss vs the exact full softmax
    labels = torch.randint(0, N, (Q,), generator=gen(4), device=dev)
    loss_sampled = float(sampled_softmax_from_embeddings(
        z, class_emb, labels, draw.ids, draw.log_q).mean())
    loss_full = float(full_softmax_loss(z @ class_emb.T, labels).mean())
    print(f"sampled-softmax loss {loss_sampled:.4f} vs full "
          f"{loss_full:.4f}")

    # 6. the theory, numerically: Theorem 2's closed form
    lq = midx.log_prob(index, z, torch.arange(N, device=dev).expand(Q, N))
    ref = torch.log_softmax(z @ class_emb.T - z @ index.residuals.T, dim=-1)
    err = float((lq - ref).abs().max())
    print("Theorem 2 max |err|:", err)

    # 7. KL(Q||P) vs uniform — why MIDX converges faster (Theorems 5-9)
    log_p = torch.log_softmax(z @ class_emb.T, dim=-1)
    kl_midx = float(torch.mean(torch.sum(torch.exp(lq) * (lq - log_p), -1)))
    kl_unif = float(torch.mean(torch.sum(
        (-math.log(N) - log_p) / N, -1)))
    print(f"KL(midx||P) = {kl_midx:.4f}  vs  KL(uniform||P) = "
          f"{kl_unif:.4f}")
    return {"nonempty_clusters": nonempty, "loss_sampled": loss_sampled,
            "loss_full": loss_full, "theorem2_err": err,
            "kl_midx": kl_midx, "kl_uniform": kl_unif, "device": str(dev)}


if __name__ == "__main__":
    main()
