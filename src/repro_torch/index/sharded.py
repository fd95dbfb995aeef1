"""The sharded index build and refresh: each rank fits the codebooks over
its own rows of the class table, with the K-means statistics all-reduced
(DESIGN §8, §9).

Mirrors `src/repro/index/sharded.py`: `_gather_global_rows` (:47),
`kmeans_sharded` (:61, with its `valid` / `n_valid` pad-and-mask path),
`_fit_assign_sharded` (:112), `_assemble` (:135), `refresh_sharded`
(:157), `build_vocab_sharded` (:254) and `refresh_vocab_sharded` (:274),
over a `torch.distributed` group (`dist.collectives`) where the reference
runs inside `shard_map`:
  E-step  local argmin over the rank's rows (no communication);
  M-step  all-reduce of the per-rank (Σ one_hot·x, Σ one_hot);
  repair  an empty cluster re-seeds from a globally indexed random row,
          fetched with a masked all-reduce, so every rank keeps the same
          codebooks;
  CSR     vocab-parallel: each rank sorts its own rows' assignments (local
          row ids), which never travel; data-parallel (`refresh_sharded`):
          the assignments are all-gathered and every rank rebuilds the
          replicated CSR (`_assemble`).
Randomness comes from a `torch.Generator` seeded alike on every rank, in
the order the single-device `index.kmeans` draws it, so a one-rank group
builds the single-device index bit for bit. The drift probe's statistics
are all-reduced, so every rank takes the same branch of the `drift`
policy (a host decision on the probe, as `lifecycle.refresh_adaptive`
takes it on one device).

The data-sharded refresh cuts the padded vocab into dp slices of
ceil(Vpad / dp) rows; where dp does not divide it, the caller zero-pads
the table and `n_valid` (the real row count) masks the pad rows out of
every statistic and bounds the random row draws, as the reference's
`refresh_table_spec` path does. A one-rank group refreshes bit for bit as
the single-device `lifecycle.refresh_with_policy` does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.dist.collectives import (all_gather_rows, group_rank,
                                          group_size, psum_no_grad)
from repro_torch.dist.vocab_parallel import local_from_build
from repro_torch.index.build import MultiIndex, _csr_from_assignments
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


def _masked_one_hot(assign, k, dtype, valid):
    one_hot = torch.nn.functional.one_hot(assign, k).to(dtype)
    return one_hot if valid is None else one_hot * valid[:, None].to(dtype)


@torch.no_grad()
def kmeans_sharded(gen: torch.Generator, x_local: torch.Tensor, k: int,
                   iters: int, *, group=None,
                   init: Optional[torch.Tensor] = None,
                   valid: Optional[torch.Tensor] = None,
                   n_valid: Optional[int] = None):
    """Lloyd's over a row-sharded table -> (centroids [K, D], the same on
    every rank; local assignments [rows]; distortion). `valid` [rows]
    masks this rank's pad rows out of the statistics and `n_valid` (the
    global real-row count) bounds the row draws (reference :61); without
    them the draws are those of the unmasked path."""
    rows = x_local.shape[0]
    n_global = n_valid if n_valid is not None else rows * group_size(group)
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
        one_hot = _masked_one_hot(assign, k, x_local.dtype, valid)
        counts = psum_no_grad(torch.sum(one_hot, dim=0), group)
        sums = psum_no_grad(one_hot.T @ x_local, group)
        rand_idx = torch.randint(0, n_global, (k,), generator=gen, device=dev)
        repair = _gather_global_rows(x_local, rand_idx, group)
        centroids = torch.where((counts > 0)[:, None],
                                sums / torch.clamp(counts, min=1.0)[:, None],
                                repair)
    assign = _assign(x_local, centroids)
    diff = x_local - centroids[assign]
    if valid is not None:
        diff = diff * valid[:, None].to(diff.dtype)
    distortion = psum_no_grad(torch.sum(diff * diff), group) / n_global
    return centroids, assign, distortion


def _fit_assign_sharded(kind: str, gen: torch.Generator,
                        q_local: torch.Tensor, k: int, iters: int, *,
                        group=None, init=None, valid=None, n_valid=None):
    """The sharded fit of both codebooks -> (cb1, cb2, a1_local,
    a2_local); the two K-means stages draw from `gen` in turn, as
    `index.quantization.fit` does."""
    i1, i2 = (None, None) if init is None else init
    kw = dict(group=group, valid=valid, n_valid=n_valid)
    if kind == "pq":
        d = q_local.shape[-1]
        cb1, a1, _ = kmeans_sharded(gen, q_local[:, : d // 2], k, iters,
                                    init=i1, **kw)
        cb2, a2, _ = kmeans_sharded(gen, q_local[:, d // 2:], k, iters,
                                    init=i2, **kw)
    elif kind == "rq":
        cb1, a1, _ = kmeans_sharded(gen, q_local, k, iters, init=i1, **kw)
        cb2, a2, _ = kmeans_sharded(gen, q_local - cb1[a1], k, iters,
                                    init=i2, **kw)
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


def _drift_probe(kind: str, cb1, cb2, x, old_a1, old_a2, group, n_global,
                 valid=None):
    """The drift probe over a row-sharded table, its statistics
    all-reduced (`lifecycle.drift_metrics` on one device): the rows'
    frozen assignments and the all-reduced (reassigned_frac,
    codeword_drift)."""
    k = cb1.shape[0]
    a1_f, a2_f = assign_against(kind, cb1, cb2, x)
    changed = (a1_f != old_a1) | (a2_f != old_a2)
    if valid is not None:
        changed = changed & valid
    frac = psum_no_grad(torch.sum(changed.float()), group) / n_global
    x1 = x[:, : x.shape[-1] // 2] if kind == "pq" else x
    one_hot = _masked_one_hot(a1_f, k, x1.dtype, valid)
    counts = psum_no_grad(torch.sum(one_hot, dim=0), group)
    sums = psum_no_grad(one_hot.T @ x1, group)
    cb1_next = torch.where((counts > 0)[:, None],
                           sums / torch.clamp(counts, min=1.0)[:, None], cb1)
    move = (torch.sqrt(torch.sum((cb1_next - cb1) ** 2))
            / (torch.sqrt(torch.sum(cb1 ** 2)) + 1e-12))
    return a1_f, a2_f, frac, move


def _check_policy(policy: str) -> None:
    if policy not in REFRESH_POLICIES:
        raise ValueError(f"refresh_policy must be one of {REFRESH_POLICIES}, "
                         f"got {policy!r}")


def _refit_or_keep(idx: MultiIndex, gen, x, frozen, frac, move, *, group,
                   iters, policy, threshold, valid=None, n_valid=None):
    """The policy's branch: the warm-started sharded refit ('fixed', or
    'drift' above `threshold`) or the frozen codebooks with the probe's
    assignments. -> (cb1, cb2, a1_local, a2_local, did_full). On the
    meta device (the dry run's plan) the probe has no value and 'drift'
    plans its costlier branch, the refit."""
    do_full = policy == "fixed" or frac.is_meta or bool(
        (frac > threshold) | (move > threshold))
    if do_full:
        fit = _fit_assign_sharded(idx.kind, gen, x, idx.num_codewords, iters,
                                  group=group,
                                  init=(idx.codebook1, idx.codebook2),
                                  valid=valid, n_valid=n_valid)
    else:
        fit = (idx.codebook1, idx.codebook2) + tuple(frozen)
    return fit + (do_full,)


def _metrics(kind, x, fit, frac, move, group, n_global, valid=None) -> dict:
    cb1, cb2, a1, a2, do_full = fit
    diff2 = (x - _recon(kind, cb1, cb2, a1, a2)) ** 2
    if valid is not None:
        diff2 = diff2 * valid[:, None].to(diff2.dtype)
    distortion = psum_no_grad(torch.sum(diff2), group) / n_global
    return {"reassigned_frac": frac, "codeword_drift": move,
            "did_full": torch.tensor(float(do_full), device=x.device),
            "distortion": distortion}


@torch.no_grad()
def refresh_vocab_sharded(local_idx: MultiIndex, gen: torch.Generator,
                          table_local: torch.Tensor, *, group=None,
                          iters: int = 10, policy: str = "fixed",
                          threshold: float = 0.1):
    """One refresh of a rank's local view: the drift probe (its statistics
    all-reduced, as `lifecycle.drift_metrics` computes them on one device),
    then under 'fixed' (or 'drift' above `threshold`) the warm-started
    sharded refit, under 'drift' at or below it the cheap branch: the
    codebooks kept, the rank's rows reassigned against them. Either way
    each rank rebuilds only its own CSR. -> (new local MultiIndex,
    metrics)."""
    _check_policy(policy)
    x = table_local.float()
    n_global = x.shape[0] * group_size(group)
    a1_f, a2_f, frac, move = _drift_probe(
        local_idx.kind, local_idx.codebook1, local_idx.codebook2, x,
        local_idx.assign1, local_idx.assign2, group, n_global)
    fit = _refit_or_keep(local_idx, gen, x, (a1_f, a2_f), frac, move,
                         group=group, iters=iters, policy=policy,
                         threshold=threshold)
    new = local_from_build(local_idx.kind, *fit[:4], local_idx.num_codewords)
    return new, _metrics(local_idx.kind, x, fit, frac, move, group, n_global)


def _assemble(index: MultiIndex, cb1, cb2, a1_local, a2_local, group,
              d_model: int, n_valid: Optional[int] = None) -> MultiIndex:
    """The ranks' assignments all-gathered (cut back to `n_valid` rows
    where the table was padded) and the CSR rebuilt, the same on every
    rank (reference :135). Residuals are dropped, as the training head
    state keeps none."""
    a1 = all_gather_rows(a1_local, group)
    a2 = all_gather_rows(a2_local, group)
    if n_valid is not None:
        a1, a2 = a1[:n_valid], a2[:n_valid]
    sorted_ids, offsets, counts, log_counts = _csr_from_assignments(
        a1, a2, index.num_codewords)
    return MultiIndex(index.kind, cb1, cb2, a1, a2,
                      cb1.new_zeros((0, d_model)), sorted_ids, offsets,
                      counts, log_counts)


@torch.no_grad()
def refresh_sharded(index: MultiIndex, gen: torch.Generator,
                    table_local: torch.Tensor, *, group=None,
                    iters: int = 10, policy: str = "fixed",
                    threshold: float = 0.1,
                    n_valid: Optional[int] = None):
    """One refresh of the replicated index over a row-sharded class table
    (reference :157): `table_local` is this data rank's contiguous slice
    of ceil(Vpad / dp) rows (zero-padded past the table where dp does not
    divide it, `n_valid` then the real row count). The drift probe's
    statistics are all-reduced, so every rank takes the same branch of the
    'drift' policy; the refit's statistics too; the assignments are
    all-gathered and every rank rebuilds the same CSR. -> (new index,
    metrics), the index the same on every rank, residuals dropped."""
    _check_policy(policy)
    x = table_local.float()
    rows, d_model = x.shape
    dp, shard = group_size(group), group_rank(group)
    n_global = n_valid if n_valid is not None else rows * dp
    valid = None
    old1, old2 = index.assign1, index.assign2
    if n_valid is not None:
        valid = (shard * rows + torch.arange(rows, device=x.device)
                 < n_valid)
        pad = rows * dp - old1.shape[0]
        old1 = torch.nn.functional.pad(old1, (0, pad))
        old2 = torch.nn.functional.pad(old2, (0, pad))
    lo = shard * rows
    a1_f, a2_f, frac, move = _drift_probe(
        index.kind, index.codebook1, index.codebook2, x,
        old1[lo:lo + rows], old2[lo:lo + rows], group, n_global, valid)
    fit = _refit_or_keep(index, gen, x, (a1_f, a2_f), frac, move,
                         group=group, iters=iters, policy=policy,
                         threshold=threshold, valid=valid, n_valid=n_valid)
    new = _assemble(index, *fit[:4], group, d_model, n_valid=n_valid)
    return new, _metrics(index.kind, x, fit, frac, move, group, n_global,
                         valid)
