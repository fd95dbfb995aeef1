"""TAPAS two-pass adaptive sampling (Bai et al. 2017).

Mirrors `src/repro/proposals/tapas.py:26-95`. Pass 1 (refresh time):
cache a candidate pool of P classes drawn without replacement ∝ unigram
frequency, the cheap query-independent pass. Pass 2 (per query): softmax
over the pool's exact logits, the adaptive query-dependent pass. The
proposal is the ε-mixture
    q(i|z) = ε/N + (1−ε) · softmax_pool(z·c_i) · 1[i ∈ pool]
which is exactly normalised over all N classes (the uniform floor keeps
off-pool classes reachable, so log_prob is finite everywhere). `refresh`
redraws the pool and takes the current table.

State: {pool [P] ids, slot [N] inverse map (−1 off-pool), emb,
freq_logits, eps, n}. Sampling is O(P·D) per query instead of O(N·D).

Departures: the pass-1 pool is a Gumbel top-k over counter noise
(ROLE_TAPAS_PASS1, column = class) seeded by one draw from the
`torch.Generator` that init / refresh take, where the reference draws
JAX Gumbels; a query row's draws are keyed by its own key: the ε-branch
uniform (ROLE_TAPAS_BRANCH), the uniform id (ROLE_TAPAS_UNIFORM, a 32-bit
multiply-high) and the pool categorical (ROLE_TAPAS_POOL, Gumbel-max),
each under its own role; pool and slot are int64.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import noise
from repro_torch.proposals.base import Draw, snapshot, take_along


def _draw_pool(seed: int, freq_logits: torch.Tensor,
               pool: int) -> torch.Tensor:
    """Pass 1: P candidates without replacement ∝ exp(freq_logits), by a
    Gumbel top-k."""
    col = torch.arange(freq_logits.shape[0], device=freq_logits.device)
    g = noise.gumbel_noise(seed, noise.ROLE_TAPAS_PASS1, 0, col)
    return torch.topk(freq_logits + g, pool).indices


def inverse_slots(pool: torch.Tensor, n: int) -> torch.Tensor:
    """slot [N]: each pool id's position in the pool, −1 off the pool."""
    slot = torch.full((n,), -1, dtype=torch.int64, device=pool.device)
    slot[pool] = torch.arange(pool.shape[0], device=pool.device)
    return slot


def _pool_state(gen: torch.Generator, class_emb, freq_logits, pool: int,
                eps) -> dict:
    n = class_emb.shape[0]
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen,
                             device=gen.device))
    ids = _draw_pool(seed, freq_logits, pool)
    return {"pool": ids, "slot": inverse_slots(ids, n),
            "emb": snapshot(class_emb),
            "freq_logits": freq_logits,
            "eps": torch.as_tensor(eps, dtype=torch.float32,
                                   device=class_emb.device).clone(),
            "n": n}


def tapas_init_factory(pool: int = 256, eps: float = 0.05):
    def init(gen, class_emb, class_freq=None):
        n = class_emb.shape[0]
        p = min(pool, n)
        if class_freq is None:
            freq_logits = torch.zeros((n,), device=class_emb.device)
        else:
            if isinstance(class_freq, torch.Tensor):
                class_freq = class_freq.detach().cpu().numpy()
            f = torch.from_numpy(np.asarray(class_freq, np.float32)).to(
                class_emb.device)
            freq_logits = torch.log(torch.clamp(f, min=1e-12))
        return _pool_state(gen, class_emb, freq_logits, p, eps)
    return init


def _pool_log_sm(state, z):
    """log softmax over the pool's exact logits. [..., P]"""
    pe = state["emb"][state["pool"]].float()                      # [P, D]
    return torch.log_softmax(z.float() @ pe.T, dim=-1)


def tapas_log_prob(state, z, ids):
    lp_pool = _pool_log_sm(state, z)                              # [..., P]
    slot = state["slot"][ids]                                     # [..., m]
    on_pool = slot >= 0
    lp_sel = take_along(lp_pool, torch.clamp(slot, min=0))
    eps, n = state["eps"], state["n"]
    floor = eps / torch.tensor(n, dtype=torch.float32, device=ids.device)
    q = floor + torch.where(on_pool, (1.0 - eps) * torch.exp(lp_sel),
                            lp_sel.new_zeros(()))
    return torch.log(q)


def tapas_sample(state, keys, z, m):
    key = keys[..., None]
    draw = torch.arange(m, device=z.device)
    # ε-branch: uniform over all N; else pass-2 softmax over the pool
    use_unif = noise.uniform_noise(key, noise.ROLE_TAPAS_BRANCH, draw,
                                   0) < state["eps"]
    unif = noise.uniform_ids(key, noise.ROLE_TAPAS_UNIFORM, draw,
                             state["n"])
    lp_pool = _pool_log_sm(state, z)                              # [..., P]
    sel = noise.gumbel_max_draws(lp_pool.detach().reshape(
        -1, lp_pool.shape[-1]), keys.reshape(-1), noise.ROLE_TAPAS_POOL, m)
    from_pool = state["pool"][sel].reshape(unif.shape)
    ids = torch.where(use_unif, unif, from_pool)
    return Draw(ids, tapas_log_prob(state, z, ids))


def tapas_refresh(state, gen, class_emb):
    """Redraw the pass-1 candidate pool and take the current table; the
    pool size comes from the state's shape."""
    return _pool_state(gen, class_emb, state["freq_logits"],
                       int(state["pool"].shape[0]), state["eps"])
