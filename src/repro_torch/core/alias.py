"""Vose alias method (Walker 1977): O(1) categorical draws via two gathers.

Mirrors `src/repro/core/alias.py:16-54`. The table is built on the host in
numpy float64 (O(N), once per distribution change) by the reference's own
loop, line for line (the same `pop()` order, the same `1e-30` floor), so
given the same frequencies the tables equal the reference's bit for bit.
A draw picks a bin u ~ U[0, N) and keeps it if v < prob[u], else takes
alias[u].

Departures: `AliasTable` holds torch tensors (alias int64, torch's
indexing type, where the reference keeps int32), and `sample_alias` draws
from counter-hash noise (`core/noise.py`) keyed per row instead of a JAX
key: bin j of row r is `noise.uniform_ids(keys[r], ROLE_ALIAS_BIN, j, N)`
(a 32-bit multiply-high, bias <= N / 2^32) and its flip the uniform of
`ROLE_ALIAS_FLIP`, so a row's draws are a function of its key alone.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import noise


class AliasTable(NamedTuple):
    prob: torch.Tensor     # [N] float32 acceptance probability per bin
    alias: torch.Tensor    # [N] int64 alias bin
    logq: torch.Tensor     # [N] float32 log of the underlying distribution


def build_alias(p: np.ndarray, device=None) -> AliasTable:
    """Build from an (unnormalized) distribution p >= 0."""
    p = np.asarray(p, dtype=np.float64)
    assert p.ndim == 1 and np.all(p >= 0) and p.sum() > 0
    n = p.shape[0]
    q = p / p.sum()
    scaled = q * n
    prob = np.zeros(n, np.float64)
    alias = np.zeros(n, np.int64)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s, l = small.pop(), large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = scaled[l] - (1.0 - scaled[s])
        (small if scaled[l] < 1.0 else large).append(l)
    for rest in small + large:
        prob[rest] = 1.0
    logq = np.log(np.maximum(q, 1e-30))
    return AliasTable(torch.from_numpy(prob.astype(np.float32)).to(device),
                      torch.from_numpy(alias).to(device),
                      torch.from_numpy(logq.astype(np.float32)).to(device))


def sample_alias(table: AliasTable, keys: torch.Tensor,
                 shape: tuple) -> torch.Tensor:
    """Draw `shape` = (*keys.shape, m) i.i.d. samples, row r keyed by
    keys[r] and draw j the last axis. Two gathers per draw."""
    n = table.prob.shape[0]
    m = shape[-1]
    key = keys.reshape(*keys.shape, 1)
    draw = torch.arange(m, device=table.prob.device)
    bins = noise.uniform_ids(key, noise.ROLE_ALIAS_BIN, draw, n)
    v = noise.uniform_noise(key, noise.ROLE_ALIAS_FLIP, draw, 0)
    accept = v < table.prob[bins]
    return torch.where(accept, bins, table.alias[bins]).reshape(shape)
