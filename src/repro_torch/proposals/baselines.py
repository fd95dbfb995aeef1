"""Adaptive O(N·D) baselines: sphere kernel and LSH.

Mirrors `src/repro/proposals/baselines.py:20-81`.
  sphere  Blanc & Rendle 2018's quadratic-kernel sampler:
          q(i|z) ∝ α·o_i² + 1.
  LSH     SimHash bucket proposal (Spring & Shrivastava 2017): the mean of
          per-table bucket-uniform distributions, ε-mixed with uniform.
Both score every class per query, faithful to the paper's own GPU
baselines; they are comparison points, not the contribution.

Departures: the LSH planes come from a `torch.Generator` where the
reference calls `jax.random.normal`; codes and bucket sizes are int64
(`torch.bincount`) where the reference keeps int32. `lsh_log_p` sums the
tables' bucket-uniform rows into one [..., N] buffer, table by table,
where the reference materialises [..., T, N] (655 MB at paper-lm
per-token, 8.4 GB at llama); the sum then divides by T, the mean's
order of operations. A code's bit is `proj > 0`, as in the reference; the
projection's summation order differs from XLA's, so a carried-over plane
can give another bit where |proj| is within rounding of 0.
"""
from __future__ import annotations

import torch

from repro_torch.proposals.base import categorical_draw, snapshot, take_along


# ---------------------------------------------------------------------- sphere
def sphere_init(gen, class_emb, class_freq=None, alpha: float = 100.0):
    return {"emb": snapshot(class_emb),
            "alpha": torch.tensor(alpha, dtype=torch.float32,
                                  device=class_emb.device)}


def sphere_log_p(state, z):
    o = z.float() @ state["emb"].float().T
    w = state["alpha"] * o * o + 1.0
    return torch.log(w) - torch.log(torch.sum(w, dim=-1, keepdim=True))


def sphere_sample(state, keys, z, m):
    return categorical_draw(keys, sphere_log_p(state, z), m)


def sphere_log_prob(state, z, ids):
    return take_along(sphere_log_p(state, z), ids)


# ---------------------------------------------------------------------- LSH
def _bucket_sizes(codes: torch.Tensor, n_buckets: int) -> torch.Tensor:
    return torch.stack([torch.bincount(c, minlength=n_buckets)
                        for c in codes])                          # [T, 2^b]


def lsh_init(gen, class_emb, class_freq=None, tables: int = 16,
             bits: int = 4, eps: float = 0.1):
    d = class_emb.shape[-1]
    planes = torch.randn((tables, bits, d), generator=gen,
                         dtype=torch.float32, device=class_emb.device)
    codes = lsh_codes(planes, class_emb).T                        # [T, N]
    return {"planes": planes, "codes": codes,
            "sizes": _bucket_sizes(codes, 2 ** bits),
            "eps": torch.tensor(eps, dtype=torch.float32,
                                device=class_emb.device),
            "n": class_emb.shape[0]}


def lsh_codes(planes: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[T, bits, D] planes, x [..., D] -> sign bits -> bucket code [..., T]."""
    proj = torch.einsum("tbd,...d->...tb", planes, x.float())
    bits = (proj > 0).long()
    weights = 2 ** torch.arange(planes.shape[1], device=planes.device)
    return torch.sum(bits * weights, dim=-1)


def lsh_log_p(state, z):
    zc = lsh_codes(state["planes"], z)                            # [..., T]
    codes, sizes = state["codes"], state["sizes"]
    t = codes.shape[0]
    bucket_sz = torch.clamp(
        sizes[torch.arange(t, device=zc.device).expand_as(zc), zc],
        min=1).float()                                            # [..., T]
    p = torch.zeros((*zc.shape[:-1], codes.shape[1]), device=zc.device)
    for j in range(t):
        match = codes[j] == zc[..., j, None]                      # [..., N]
        p += match.float() / bucket_sz[..., j, None]
    p = p / t
    eps = state["eps"]
    p = (1.0 - eps) * p + eps / state["n"]
    return torch.log(p) - torch.log(torch.sum(p, dim=-1, keepdim=True))


def lsh_sample(state, keys, z, m):
    return categorical_draw(keys, lsh_log_p(state, z), m)


def lsh_log_prob(state, z, ids):
    return take_along(lsh_log_p(state, z), ids)


def lsh_refresh(state, gen, class_emb):
    codes = lsh_codes(state["planes"], class_emb).T
    return {**state, "codes": codes,
            "sizes": _bucket_sizes(codes, state["sizes"].shape[-1])}
