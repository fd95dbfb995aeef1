"""Fast MIDX two-stage sampler (paper §4.3) and its closed-form log-prob.

Mirrors `src/repro/core/midx.py`: `log_prob` (:59), `_member_uniform`
(:51), `twostage_tables` (:110), `sample_twostage` (:127), and the
shared-negative samplers `_inverse_cdf_sample` (:168), `_shared_draw`
(:177), `_joint_from_scores` (:191), `sample_pooled` (:201) and
`sample_mixture` (:210), with the quantized head's `scores_fn` hook,
`sample_twostage`'s `return_tables` and the vocab-parallel head's
`member_fn` hook (:118, :161): `member_fn(u, flat_cluster) -> ids`
replaces the CSR member draw, so that a vocab shard can locate each draw
on its owner (`dist.vocab_parallel.make_member_fn`) while the proposal
math stays as it is.
For a query z the proposal is Q(i|z) ∝ exp(s1[k1(i)] + s2[k2(i)]), drawn
as k1 ~ Cat(s1 + logψ), then k2 ~ Cat(s2 + log|Ω(k1,:)|), then a uniform
member of Ω(k1,k2) through the CSR layout.

Departure: where the reference splits a JAX key, every random number here
is counter-based noise (`core/noise.py`) keyed by one int per query row,
so row t's draws are a function of `keys[t]` alone:
  k1 Gumbels [T,m,K]  role ROLE_K1,     draw j, column k
  k2 Gumbels [T,m,K]  role ROLE_K2,     draw j, column k
  member uniform [T,m] role ROLE_MEMBER, draw j, column 0
Categorical draws are argmax(logits + Gumbel), ties to the lowest index.
A sequence's shared draws take uniforms keyed by one int per sequence
(`noise.sequence_keys`):
  cluster uniform [B,m] role ROLE_SHARED_PAIR,   draw j, column 0
  member uniform  [B,m] role ROLE_SHARED_MEMBER, draw j, column 0
log q of a draw stays differentiable in the tables (the reference does not
stop its gradient); its table entries are picked by `_PickRows`, whose
backward sums repeated indices over a stable sort in a fixed order on the
card, where `torch.gather`'s backward adds with atomics — so a train step
replays bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import noise
from repro_torch.index.build import MultiIndex
from repro_torch.index.quantization import query_scores


class Draw(NamedTuple):
    ids: torch.Tensor     # [T, M] int64 sampled class ids
    log_q: torch.Tensor   # [T, M] float32 log proposal prob of each id


def joint_logits(index: MultiIndex, z: torch.Tensor):
    """(J, s1, s2): J[..., K, K] = s1 ⊕ s2 + log|Ω|  (−inf on empties)."""
    s1, s2 = query_scores(index.kind, index.codebook1, index.codebook2,
                          z.float())
    return s1[..., :, None] + s2[..., None, :] + index.log_counts, s1, s2


def log_prob(index: MultiIndex, z: torch.Tensor,
             ids: torch.Tensor) -> torch.Tensor:
    """log Q_midx(ids | z) — closed form of Eq.(6): s1+s2 − lse(J)."""
    j, s1, s2 = joint_logits(index, z)
    lse = torch.logsumexp(j.reshape(*j.shape[:-2], -1), dim=-1)
    k1 = index.assign1[ids]
    k2 = index.assign2[ids]
    return (torch.gather(s1, -1, k1) + torch.gather(s2, -1, k2)
            - lse[..., None])


def member_rank(u: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """The rank r < max(cnt, 1) of a uniform draw in a cluster of cnt
    members, from u in (0, 1)."""
    n = torch.clamp(cnt, min=1)
    return torch.minimum((u * n).long(), n - 1)


def _member_uniform(index: MultiIndex, u: torch.Tensor,
                    flat_cluster: torch.Tensor) -> torch.Tensor:
    """Uniform member of each joint cluster id (CSR O(1) draw), from
    uniforms u in (0, 1) of the same shape."""
    r = member_rank(u, index.counts.reshape(-1)[flat_cluster])
    return index.sorted_ids[index.offsets[flat_cluster] + r]


class _PickRows(torch.autograd.Function):
    """table [B, C], idx [B, m] -> table[b, idx[b, j]]. The backward sums
    the gradient of repeated indices in a fixed order: a stable sort of
    each row's indices, a cumulative sum along it, and each segment's total
    as a difference of two cumulative sums, scattered back with `scatter_`
    (every member of a segment writes the same value). torch.gather's own
    backward adds with atomics on the card."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.width = table.shape[-1]
        return torch.gather(table, 1, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        sidx, order = torch.sort(idx, dim=1, stable=True)
        csum = torch.cumsum(torch.gather(g, 1, order), dim=1)
        start = torch.searchsorted(sidx, sidx, right=False)
        end = torch.searchsorted(sidx, sidx, right=True) - 1
        before = torch.where(start > 0,
                             torch.gather(csum, 1, (start - 1).clamp(min=0)),
                             torch.zeros_like(csum))
        total = torch.gather(csum, 1, end) - before
        out = g.new_zeros((g.shape[0], ctx.width))
        return out.scatter_(1, sidx, total), None


def twostage_tables(index: MultiIndex, z: torch.Tensor):
    """Proposal tables, plain torch ops:
      s1, s2 [..., K];  logψ[..., k1] = log Σ_k2 |Ω(k1,k2)| e^{s2[k2]}
    as exp(s2 − max) @ countsᵀ, and lse = logsumexp_k1(s1 + logψ).
    This is what the midx_probs kernel fuses."""
    s1, s2 = query_scores(index.kind, index.codebook1, index.codebook2,
                          z.float())
    c2 = torch.amax(s2, dim=-1, keepdim=True)
    psi = torch.exp(s2 - c2) @ index.counts.T.float()
    log_psi = torch.log(torch.clamp(psi, min=1e-30)) + c2
    lse = torch.logsumexp(s1 + log_psi, dim=-1)
    return s1, s2, log_psi, lse


def sample_twostage(index: MultiIndex, z: torch.Tensor, m: int,
                    keys: torch.Tensor, *, tables_fn=None, member_fn=None,
                    return_tables: bool = False):
    """z [T, D], keys [T] per-row stream keys -> Draw of [T, m].

    `tables_fn(index, z) -> (s1, s2, log_psi, lse)` replaces
    `twostage_tables` — the hook through which the decode head runs the
    midx_probs kernel (`kernels.midx_probs.ops.proposal_tables`).
    `return_tables=True` also returns the (s1, s2, log_psi, lse) the draw
    consumed, from which the quantized decode head rescores candidates
    (`index.quantized.code_scores`). `member_fn(u, flat_cluster)` replaces
    the CSR member draw."""
    s1, s2, log_psi, lse = (tables_fn or twostage_tables)(index, z)
    kk = index.num_codewords
    dev = z.device
    key = keys.reshape(-1, 1, 1)                                 # [T,1,1]
    draw = torch.arange(m, device=dev).reshape(1, m, 1)
    col = torch.arange(kk, device=dev).reshape(1, 1, kk)
    g1 = noise.gumbel_noise(key, noise.ROLE_K1, draw, col)       # [T,m,K]
    k1 = torch.argmax((s1 + log_psi)[:, None, :] + g1, dim=-1)   # [T,m]
    l2 = s2[:, None, :] + index.log_counts[k1]                   # [T,m,K]
    g2 = noise.gumbel_noise(key, noise.ROLE_K2, draw, col)
    k2 = torch.argmax(l2 + g2, dim=-1)                           # [T,m]
    u = noise.uniform_noise(key[..., 0], noise.ROLE_MEMBER, draw[..., 0], 0)
    ids = (member_fn or (lambda u_, c: _member_uniform(index, u_, c)))(
        u, k1 * kk + k2)
    log_q = (_PickRows.apply(s1, k1) + _PickRows.apply(s2, k2)
             - lse[:, None])
    if return_tables:
        return Draw(ids, log_q), (s1, s2, log_psi, lse)
    return Draw(ids, log_q)


# ----------------------------------------------------------------- shared
def inverse_cdf_sample(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Indices drawn from categorical rows probs [..., C] by uniforms
    u [..., m] in (0, 1): the count of cdf entries strictly below u, as the
    reference's sum(u > cdf), found by binary search instead of a
    [..., C, m] comparison."""
    cdf = torch.cumsum(probs, dim=-1)
    cdf = cdf / cdf[..., -1:]
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=False)
    return torch.clamp(idx, max=probs.shape[-1] - 1)


def _shared_draw(index: MultiIndex, flat_log: torch.Tensor, m: int,
                 keys: torch.Tensor, member_fn=None) -> Draw:
    """m (cluster, member) draws per row of flat_log [B, K²] (log weights,
    −inf on empty clusters), row b keyed by keys[b] -> Draw of [B, m]."""
    lse = torch.logsumexp(flat_log, dim=-1, keepdim=True)
    probs = torch.exp(flat_log - lse)
    key = keys.reshape(-1, 1)
    draw = torch.arange(m, device=flat_log.device).reshape(1, m)
    u = noise.uniform_noise(key, noise.ROLE_SHARED_PAIR, draw, 0)
    cluster = inverse_cdf_sample(probs.detach(), u)
    u = noise.uniform_noise(key, noise.ROLE_SHARED_MEMBER, draw, 0)
    ids = (member_fn or (lambda u_, c: _member_uniform(index, u_, c)))(
        u, cluster)
    log_q = (_PickRows.apply(flat_log, cluster)
             - index.log_counts.reshape(-1)[cluster] - lse)
    return Draw(ids, log_q)


def _joint_from_scores(index: MultiIndex, z: torch.Tensor, scores_fn):
    """`joint_logits` with an optional (index, z) -> (s1, s2) replacement,
    the hook through which the quantized head scores its low-bit
    codebooks."""
    if scores_fn is None:
        return joint_logits(index, z)
    s1, s2 = scores_fn(index, z)
    return s1[..., :, None] + s2[..., None, :] + index.log_counts, s1, s2


def sample_pooled(index: MultiIndex, z_seq: torch.Tensor, m: int,
                  keys: torch.Tensor, *, scores_fn=None,
                  member_fn=None) -> Draw:
    """Pooled proposal: one proposal per sequence from its mean query.
    z_seq [B, S, D], keys [B] -> Draw of [B, m]."""
    z_bar = torch.mean(z_seq.float(), dim=-2)                    # [B,D]
    j, _, _ = _joint_from_scores(index, z_bar, scores_fn)
    return _shared_draw(index, j.reshape(j.shape[0], -1), m, keys,
                        member_fn)


def sample_mixture(index: MultiIndex, z_seq: torch.Tensor, m: int,
                   keys: torch.Tensor, *, scores_fn=None,
                   member_fn=None) -> Draw:
    """Exact token-mixture proposal per sequence:
    P̄[k,k'] ∝ |Ω| ⊙ Σ_t a_t[k] b_t[k'],  a_t = exp(s1_t)/Z_t, b_t = exp(s2_t),
    Z_t the token's joint normaliser — one K×S @ S×K product per sequence.
    z_seq [B, S, D], keys [B] -> Draw of [B, m], log q under the mixture."""
    j, s1, s2 = _joint_from_scores(index, z_seq, scores_fn)      # [B,S,K,K]
    log_z = torch.logsumexp(j.reshape(*j.shape[:-2], -1), dim=-1)  # [B,S]
    c2 = torch.amax(s2, dim=-1, keepdim=True)
    a = torch.exp(s1 - log_z[..., None] + c2)
    b = torch.exp(s2 - c2)
    mix = torch.einsum("bsk,bsl->bkl", a, b)                     # [B,K,K]
    mix_log = torch.log(torch.clamp(mix, min=1e-30)) + index.log_counts
    return _shared_draw(index, mix_log.reshape(mix.shape[0], -1), m, keys,
                        member_fn)
