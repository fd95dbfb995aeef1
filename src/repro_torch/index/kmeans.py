"""Lloyd's K-means in torch (matmul-based distances).

Mirrors `src/repro/index/kmeans.py` (`_assign` :26, `_update` :34, `kmeans`
:48). Departure: randomness (the initial centroid draw and the empty-cluster
repair) comes from an explicit `torch.Generator` instead of a JAX key, so a
cold fit picks other points than the reference; with `init=` centroids and
no cluster going empty the two fits agree exactly. The centroid sums stay a
one-hot matmul, as in the reference, rather than an atomic `index_add_`:
on the card that keeps a build deterministic.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class KMeansResult(NamedTuple):
    centroids: torch.Tensor      # [K, D]
    assignments: torch.Tensor    # [N] int64
    distortion: torch.Tensor     # scalar: mean squared distance to centroid


def _assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid per row. ||x-c||^2 = ||x||^2 - 2 x.c + ||c||^2."""
    dots = x @ centroids.T                                   # [N, K]
    c_sq = torch.sum(centroids * centroids, dim=-1)          # [K]
    return torch.argmin(c_sq[None, :] - 2.0 * dots, dim=-1)


def _update(x: torch.Tensor, assign: torch.Tensor, k: int,
            gen: torch.Generator) -> torch.Tensor:
    """Recompute centroids; re-seed empty clusters with random points."""
    n = x.shape[0]
    one_hot = torch.nn.functional.one_hot(assign, k).to(x.dtype)  # [N, K]
    counts = torch.sum(one_hot, dim=0)                       # [K]
    sums = one_hot.T @ x                                     # [K, D]
    centroids = sums / torch.clamp(counts, min=1.0)[:, None]
    rand_idx = torch.randint(0, n, (k,), generator=gen, device=x.device)
    repair = x[rand_idx]
    return torch.where((counts > 0)[:, None], centroids, repair)


def kmeans(gen: torch.Generator, x: torch.Tensor, k: int, iters: int = 10,
           init: Optional[torch.Tensor] = None) -> KMeansResult:
    """Lloyd's algorithm. x: [N, D] float. Returns centroids [K, D].

    init: optional [K, D] warm-start centroids; when given, the random-point
    init is skipped and Lloyd's refines from there.
    """
    n = x.shape[0]
    if init is None:
        if n < k:
            init_idx = torch.randint(0, n, (k,), generator=gen,
                                     device=x.device)
        else:
            init_idx = torch.randperm(n, generator=gen, device=x.device)[:k]
        centroids = x[init_idx]
    else:
        if tuple(init.shape) != (k, x.shape[-1]):
            raise ValueError(f"init centroids {tuple(init.shape)} != "
                             f"{(k, x.shape[-1])}")
        centroids = init.to(x.dtype)
    for _ in range(iters):
        centroids = _update(x, _assign(x, centroids), k, gen)
    assign = _assign(x, centroids)
    diff = x - centroids[assign]
    distortion = torch.mean(torch.sum(diff * diff, dim=-1))
    return KMeansResult(centroids, assign, distortion)
