"""Static / query-independent proposals: uniform, unigram (Vose alias), full.

Mirrors `src/repro/proposals/static.py:18-67`. `full` is the exact
softmax "proposal", O(N·D) per query, the unbiased reference the sampled
estimators are compared against (its refresh keeps the embedding snapshot
current, so it is marked adaptive).

Departures: the uniform proposal's ids are the 32-bit multiply-high of the
row key's hash under ROLE_UNIFORM_IDS, draw j (`noise.uniform_ids`); the
unigram draw is `core.alias.sample_alias` (counter noise, keyed per row);
the full proposal's draw is the counter-hash `categorical_draw`. The
unigram and full states are built on the table's device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import noise
from repro_torch.core.alias import AliasTable, build_alias, sample_alias
from repro_torch.proposals.base import (Draw, categorical_draw, snapshot,
                                        take_along)


# ---------------------------------------------------------------------- uniform
def uniform_init(gen, class_emb, class_freq=None):
    return {"n": class_emb.shape[0]}


def _neg_log_n(n: int, shape, device) -> torch.Tensor:
    logn = torch.log(torch.tensor(n, dtype=torch.float32, device=device))
    return (-logn).expand(shape)


def uniform_sample(state, keys, z, m):
    n = state["n"]
    ids = noise.uniform_ids(keys[..., None], noise.ROLE_UNIFORM_IDS,
                            torch.arange(m, device=z.device), n)
    return Draw(ids, _neg_log_n(n, ids.shape, z.device))


def uniform_log_prob(state, z, ids):
    return _neg_log_n(state["n"], ids.shape, ids.device)


# ---------------------------------------------------------------------- unigram
def _host_freq(class_freq) -> np.ndarray:
    if isinstance(class_freq, torch.Tensor):
        class_freq = class_freq.detach().cpu().numpy()
    return np.asarray(class_freq, np.float64)


def unigram_init(gen, class_emb, class_freq=None):
    n = class_emb.shape[0]
    freq = np.ones(n) if class_freq is None else _host_freq(class_freq)
    return {"table": build_alias(freq + 1e-12, device=class_emb.device)}


def unigram_sample(state, keys, z, m):
    t: AliasTable = state["table"]
    ids = sample_alias(t, keys, (*keys.shape, m))
    return Draw(ids, t.logq[ids])


def unigram_log_prob(state, z, ids):
    return state["table"].logq[ids]


# ---------------------------------------------------------------------- full
def full_init(gen, class_emb, class_freq=None):
    return {"emb": snapshot(class_emb)}


def full_log_p(state, z):
    return torch.log_softmax(z.float() @ state["emb"].float().T, dim=-1)


def full_sample(state, keys, z, m):
    return categorical_draw(keys, full_log_p(state, z), m)


def full_log_prob(state, z, ids):
    return take_along(full_log_p(state, z), ids)
