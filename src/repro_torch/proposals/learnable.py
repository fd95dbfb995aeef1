"""Learnable-codebook proposal (paper §6.2.3): the trainable contender.

Mirrors `src/repro/proposals/learnable.py:26-84`. K-means init (the
paper's warm start), then the codewords C1, C2 train jointly with the
model through the auxiliary objective
    L_aux = w_r·L_recon + w_k·L_KL
(`core.learnable`): L_recon pulls soft reconstructions toward the table,
L_KL shrinks the proposal-vs-softmax divergence that Theorems 5/13 tie to
estimator bias. The train step exposes the codebooks through split /
merge (`launch.steps.make_train_step`'s trainable branch); `refresh`
hard-assigns the classes against the learned codewords
(`index_from_learnable`, assign-only, no k-means), so the sampling index
follows the gradient-trained geometry.

State: {"cb": LearnableCodebooks (trainable), "index": MultiIndex
(derived)}. Sampling and log_prob go through the index, as midx's do:
the two-stage draw with the midx_probs kernel's tables on the card.

Departures: `aux_loss(state, keys, z2d, class_emb)` takes the step's
token keys where the reference takes a JAX key; above `max_queries` /
`max_classes` rows it keeps the rows with the smallest hash of
(keys[0], ROLE_AUX_ROWS, 0 for queries / 1 for classes, row), a uniform
subset without replacement, in row order, where the reference calls
`jax.random.choice(..., replace=False)`. Below those sizes there is no
subsample, so both packages compute the same objective.
"""
from __future__ import annotations

import torch

from repro_torch.core import midx as midx_mod
from repro_torch.core import noise
from repro_torch.core.learnable import (codebook_losses, from_index,
                                        index_from_learnable)
from repro_torch.index.build import build
from repro_torch.proposals.midx import twostage_draw


def learnable_init_factory(kind: str, k: int, iters: int = 10):
    def init(gen, class_emb, class_freq=None):
        idx = build(gen, class_emb.float(), kind=kind, k=k, iters=iters)
        return {"cb": from_index(idx), "index": idx}
    return init


def learnable_sample(state, keys, z, m):
    return twostage_draw(state["index"], keys, z, m)


def learnable_log_prob(state, z, ids):
    return midx_mod.log_prob(state["index"], z, ids)


def learnable_refresh(state, gen, class_emb):
    return {"cb": state["cb"],
            "index": index_from_learnable(state["cb"], class_emb.float())}


def subsample_rows(key, salt: int, n: int, k: int, device) -> torch.Tensor:
    """k of n row ids, without replacement, uniformly: the k smallest
    hash(key, ROLE_AUX_ROWS, salt, row), in row order."""
    h = noise.hash_bits(key, noise.ROLE_AUX_ROWS, salt,
                        torch.arange(n, device=device))
    return torch.sort(torch.sort(h, stable=True).indices[:k]).values


def learnable_aux_factory(recon_weight: float = 1.0, kl_weight: float = 1.0,
                          max_queries: int = 64, max_classes: int = 512):
    """aux_loss(state, keys, z2d, class_emb) -> (loss, metrics).

    Row-subsamples queries / classes so the z·Cᵀ KL term stays O(q·c) a
    step at any vocabulary; gradients flow into the codebooks only (the
    query and the table are detached: the auxiliary objective trains the
    proposal and must not perturb the model's own loss surface)."""
    def aux_loss(state, keys, z2d, class_emb):
        z = z2d.detach().float()
        q = class_emb.detach().float()
        key = keys.reshape(-1)[0]
        if z.shape[0] > max_queries:
            z = z[subsample_rows(key, 0, z.shape[0], max_queries, z.device)]
        if q.shape[0] > max_classes:
            q = q[subsample_rows(key, 1, q.shape[0], max_classes, q.device)]
        loss, metrics = codebook_losses(state["cb"], z, q, recon_weight,
                                        kl_weight)
        return loss, {"prop_recon": metrics["recon"],
                      "prop_kl": metrics["kl"]}

    return aux_loss


def learnable_split(state):
    return state["cb"], {"index": state["index"]}


def learnable_merge(trainable, rest):
    return {"cb": trainable, "index": rest["index"]}
