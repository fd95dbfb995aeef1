"""The vocab-parallel index build and refresh: each rank fits the codebooks
over its own rows, with the K-means statistics all-reduced, and builds its
CSR natively (DESIGN §8, §9).

Mirrors the vocab part of `src/repro/index/sharded.py`:
`_gather_global_rows` (:47), `kmeans_sharded` (:61), `_fit_assign_sharded`
(:112), `build_vocab_sharded` (:254) and `refresh_vocab_sharded` (:274),
over a `torch.distributed` group (`dist.collectives`) where the reference
runs inside `shard_map`:
  E-step  local argmin over the rank's rows (no communication);
  M-step  all-reduce of the per-rank (Σ one_hot·x, Σ one_hot);
  repair  an empty cluster re-seeds from a globally indexed random row,
          fetched with a masked all-reduce, so every rank keeps the same
          codebooks;
  CSR     each rank sorts its own rows' assignments (local row ids): the
          assignments never travel.
Randomness comes from a `torch.Generator` seeded alike on every rank, in
the order the single-device `index.kmeans` draws it, so a one-rank group
builds the single-device index bit for bit. The data-parallel refresh
(`refresh_sharded`, `_assemble`) is not ported yet (ROADMAP.md Queue 1
item 13), nor the `drift` policy (item 9).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.dist.collectives import (group_rank, group_size,
                                          psum_no_grad)
from repro_torch.dist.vocab_parallel import local_from_build
from repro_torch.index.build import MultiIndex
from repro_torch.index.kmeans import _assign
from repro_torch.index.lifecycle import REFRESH_POLICIES
from repro_torch.index.quantization import assign_against


def _gather_global_rows(x_local: torch.Tensor, idx: torch.Tensor,
                        group) -> torch.Tensor:
    """Rows of the global table by global index: each rank contributes the
    rows it owns, one all-reduce. [len(idx), D]"""
    rows = x_local.shape[0]
    local = idx - group_rank(group) * rows
    ok = (local >= 0) & (local < rows)
    picked = torch.where(ok[:, None], x_local[torch.clamp(local, 0, rows - 1)],
                         torch.zeros((), dtype=x_local.dtype,
                                     device=x_local.device))
    return psum_no_grad(picked, group)


@torch.no_grad()
def kmeans_sharded(gen: torch.Generator, x_local: torch.Tensor, k: int,
                   iters: int, *, group=None,
                   init: Optional[torch.Tensor] = None):
    """Lloyd's over a row-sharded table -> (centroids [K, D], the same on
    every rank; local assignments [rows]; distortion)."""
    rows = x_local.shape[0]
    n_global = rows * group_size(group)
    dev = x_local.device
    if init is None:
        if n_global < k:
            init_idx = torch.randint(0, n_global, (k,), generator=gen,
                                     device=dev)
        else:
            init_idx = torch.randperm(n_global, generator=gen,
                                      device=dev)[:k]
        centroids = _gather_global_rows(x_local, init_idx, group)
    else:
        centroids = init.to(x_local.dtype)
    for _ in range(iters):
        assign = _assign(x_local, centroids)
        one_hot = torch.nn.functional.one_hot(assign, k).to(x_local.dtype)
        counts = psum_no_grad(torch.sum(one_hot, dim=0), group)
        sums = psum_no_grad(one_hot.T @ x_local, group)
        rand_idx = torch.randint(0, n_global, (k,), generator=gen, device=dev)
        repair = _gather_global_rows(x_local, rand_idx, group)
        centroids = torch.where((counts > 0)[:, None],
                                sums / torch.clamp(counts, min=1.0)[:, None],
                                repair)
    assign = _assign(x_local, centroids)
    diff = x_local - centroids[assign]
    distortion = psum_no_grad(torch.sum(diff * diff), group) / n_global
    return centroids, assign, distortion


def _fit_assign_sharded(kind: str, gen: torch.Generator,
                        q_local: torch.Tensor, k: int, iters: int, *,
                        group=None, init=None):
    """The sharded fit of both codebooks -> (cb1, cb2, a1_local,
    a2_local); the two K-means stages draw from `gen` in turn, as
    `index.quantization.fit` does."""
    i1, i2 = (None, None) if init is None else init
    if kind == "pq":
        d = q_local.shape[-1]
        cb1, a1, _ = kmeans_sharded(gen, q_local[:, : d // 2], k, iters,
                                    group=group, init=i1)
        cb2, a2, _ = kmeans_sharded(gen, q_local[:, d // 2:], k, iters,
                                    group=group, init=i2)
    elif kind == "rq":
        cb1, a1, _ = kmeans_sharded(gen, q_local, k, iters, group=group,
                                    init=i1)
        cb2, a2, _ = kmeans_sharded(gen, q_local - cb1[a1], k, iters,
                                    group=group, init=i2)
    else:
        raise ValueError(f"unknown quantizer kind {kind!r}")
    return cb1, cb2, a1, a2


@torch.no_grad()
def build_vocab_sharded(gen: torch.Generator, table_local: torch.Tensor, *,
                        kind: str, k: int, iters: int,
                        group=None) -> MultiIndex:
    """Fit the codebooks over the vocab-sharded table (statistics
    all-reduced, so the codebooks are the same on every rank) and build
    this rank's local view natively: a CSR over its own rows, local row
    ids, its partial counts."""
    cb1, cb2, a1, a2 = _fit_assign_sharded(kind, gen, table_local.float(), k,
                                           iters, group=group)
    return local_from_build(kind, cb1, cb2, a1, a2, k)


def _recon(kind, cb1, cb2, a1, a2):
    return (torch.cat([cb1[a1], cb2[a2]], dim=-1) if kind == "pq"
            else cb1[a1] + cb2[a2])


@torch.no_grad()
def refresh_vocab_sharded(local_idx: MultiIndex, gen: torch.Generator,
                          table_local: torch.Tensor, *, group=None,
                          iters: int = 10, policy: str = "fixed",
                          threshold: float = 0.1):
    """One refresh of a rank's local view: the drift probe (its statistics
    all-reduced, as `lifecycle.drift_metrics` computes them on one device)
    and the warm-started sharded refit, each rank rebuilding only its own
    CSR. -> (new local MultiIndex, metrics). 'drift' raises (ROADMAP.md
    Queue 1 item 9)."""
    del threshold
    if policy not in REFRESH_POLICIES:
        raise ValueError(f"refresh_policy must be one of {REFRESH_POLICIES}, "
                         f"got {policy!r}")
    if policy == "drift":
        raise NotImplementedError("the 'drift' refresh policy is not ported "
                                  "yet (ROADMAP.md Queue 1 item 9)")
    x = table_local.float()
    d_model, rows = x.shape[-1], x.shape[0]
    n_global = rows * group_size(group)
    k = local_idx.num_codewords
    a1_f, a2_f = assign_against(local_idx.kind, local_idx.codebook1,
                                local_idx.codebook2, x)
    changed = (a1_f != local_idx.assign1) | (a2_f != local_idx.assign2)
    frac = psum_no_grad(torch.sum(changed.float()), group) / n_global
    x1 = x[:, : d_model // 2] if local_idx.kind == "pq" else x
    one_hot = torch.nn.functional.one_hot(a1_f, k).to(x1.dtype)
    counts = psum_no_grad(torch.sum(one_hot, dim=0), group)
    sums = psum_no_grad(one_hot.T @ x1, group)
    cb1_next = torch.where((counts > 0)[:, None],
                           sums / torch.clamp(counts, min=1.0)[:, None],
                           local_idx.codebook1)
    move = (torch.sqrt(torch.sum((cb1_next - local_idx.codebook1) ** 2))
            / (torch.sqrt(torch.sum(local_idx.codebook1 ** 2)) + 1e-12))
    cb1, cb2, a1, a2 = _fit_assign_sharded(
        local_idx.kind, gen, x, k, iters, group=group,
        init=(local_idx.codebook1, local_idx.codebook2))
    new = local_from_build(local_idx.kind, cb1, cb2, a1, a2, k)
    diff2 = (x - _recon(local_idx.kind, cb1, cb2, a1, a2)) ** 2
    distortion = psum_no_grad(torch.sum(diff2), group) / n_global
    return new, {"reassigned_frac": frac, "codeword_drift": move,
                 "did_full": torch.ones((), device=x.device),
                 "distortion": distortion}
