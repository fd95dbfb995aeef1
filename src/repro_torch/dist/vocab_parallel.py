"""Vocab-parallel MIDX head: the class table and the index row-sharded over
ranks (DESIGN §9).

Mirrors `src/repro/dist/vocab_parallel.py`: `VocabShardedIndex` (:55),
`shard_index` (:93), `unshard_index` (:115), `local_index` (:134),
`proposal_index` (:145), `make_member_fn` (:158), `embed_lookup` (:185),
`_merge_loss` (:203), `loss_midx_vp` (:219) for the three proposals, over
a bf16 / fp32 or an int8 / fp8 table, and `sample_twostage_vp` (:353).

Layout. Rank p of n owns the rows [p·rows, (p+1)·rows) of the padded
vocabulary. The [K, D'] codebooks replicate; the CSR state is local: rank
p's `sorted_ids` are local row ids of its own classes, with its own
`offsets` / `counts`. Between ranks the stacked layout of the reference
(`VocabShardedIndex`, CSR leaves [n, ...]) is what the bridge, the
checkpoints and the serving export carry; inside a run each rank holds its
local view, a `MultiIndex` (`local_index`).

Draws. The global cluster sizes are one integer all-reduce away, so the
proposal (ψ tables, the Eq. (6) normaliser, the k1 / k2 and shared
cluster draws) runs on the exact global counts, and the member draw
locates its owner: the rank r < |Ω(c)| comes from the same counter-hash
uniform as on one device (`core.noise`, `core.midx.member_rank`), the
exclusive prefix of the ranks' counts says which rank holds it, that rank
gathers the member, and an all-reduce of the ids hands it to every rank.
The stable sort of the CSR and the contiguous ownership make the global
within-cluster order the concatenation of the local ones, so the draws
are the replicated sampler's bit for bit.

Loss. Each rank takes the partial lse of the negatives it owns (the
partial modes of the sampled-CE kernels, or `partial_sampled_lse` for a
head without collision masking) and the owner-masked positive logit; the
merge (the pmax of the detached partials as the shift, a psum of the
shifted exponentials) gives the loss on every rank, within fp
reassociation of the replicated loss.

Gradients (`dist.collectives`): the hidden state enters the head through
the copy region, so d(hidden) is the sum of every rank's owner-partial
cotangent and the backbone's gradients are the same on every rank; the
row gradients of the sharded table are local and complete. The
reference gets there by taking every shard's cotangent and dividing
(`launch/steps.py:321-329`); here no gradient needs a scale.

Departures: the reference's `fused` / `interpret` switches are the
device (the kernels on the card, their plain versions on the CPU), and,
as in `models.heads.loss_midx`, a head without collision masking takes
the plain lane (gathered rows and `partial_sampled_lse`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import midx as midx_mod
from repro_torch.core import noise
from repro_torch.core.sampled_softmax import (NEG_INF, NEG_INF_THRESHOLD,
                                              partial_sampled_lse)
from repro_torch.dist.collectives import (all_gather_stack,
                                          copy_to_vocab_region, group_rank,
                                          group_size, pmax, psum,
                                          psum_no_grad)
from repro_torch.index.build import MultiIndex, _csr_from_assignments
from repro_torch.index.quantized import (dequant_rows, quantize_rows,
                                         quantized_query_scores,
                                         resolve_table_dtype)
from repro_torch.kernels.midx_probs.ops import (proposal_tables,
                                                proposal_tables_q)
from repro_torch.kernels.sampled_ce.ops import (sampled_ce_partial_op,
                                                sampled_ce_pt_partial_op,
                                                sampled_ce_pt_q_partial_op,
                                                sampled_ce_q_partial_op)

# the data fields in the reference's order (`vocab_parallel.py:53-56`)
SHARDED_FIELDS = ("codebook1", "codebook2", "assign1", "assign2",
                  "sorted_ids", "offsets", "counts", "log_counts")
# the CSR leaves, stacked over shards [n, ...]
CSR_FIELDS = SHARDED_FIELDS[2:]


@dataclasses.dataclass(frozen=True)
class VocabShardedIndex:
    """Stacked per-shard MIDX state: codebooks replicated, CSR leaves with
    a leading [n] shard dim (local row ids)."""
    kind: str                    # 'pq' | 'rq'
    num_shards: int
    codebook1: torch.Tensor      # [K, D or D/2]
    codebook2: torch.Tensor      # [K, D or D/2]
    assign1: torch.Tensor        # [n, rows]
    assign2: torch.Tensor        # [n, rows]
    sorted_ids: torch.Tensor     # [n, rows]      local row ids
    offsets: torch.Tensor        # [n, K²+1]
    counts: torch.Tensor         # [n, K, K]      Σ_p == the global counts
    log_counts: torch.Tensor     # [n, K, K] fp32

    @property
    def num_codewords(self) -> int:
        return self.codebook1.shape[0]

    @property
    def rows_per_shard(self) -> int:
        return self.sorted_ids.shape[-1]

    @property
    def num_classes(self) -> int:
        return self.num_shards * self.rows_per_shard


def _stack(kind, cb1, cb2, per_shard) -> VocabShardedIndex:
    """VocabShardedIndex from per-shard (a1, a2, sorted_ids, offsets,
    counts, log_counts) tuples."""
    cols = [torch.stack(c) for c in zip(*per_shard)]
    return VocabShardedIndex(kind, len(per_shard), cb1, cb2, *cols)


def shard_index(index: MultiIndex, num_shards: int) -> VocabShardedIndex:
    """A replicated index in the vocab-sharded layout: shard p keeps the
    assignments of its rows and rebuilds a local CSR over them (pure
    re-layout: Σ_p counts_p == index.counts)."""
    n = index.num_classes
    if n % num_shards:
        raise ValueError(f"num_classes {n} must divide num_shards "
                         f"{num_shards}; pad the class table first")
    rows, k = n // num_shards, index.num_codewords
    a1 = index.assign1.reshape(num_shards, rows)
    a2 = index.assign2.reshape(num_shards, rows)
    return _stack(index.kind, index.codebook1, index.codebook2,
                  [(a1[p], a2[p], *_csr_from_assignments(a1[p], a2[p], k))
                   for p in range(num_shards)])


def unshard_index(sharded: VocabShardedIndex) -> MultiIndex:
    """The inverse of `shard_index`: one replicated MultiIndex, its global
    CSR rebuilt from the concatenated assignments, no residuals (the
    serving export: `serve.Engine` takes the replicated layout)."""
    a1 = sharded.assign1.reshape(-1)
    a2 = sharded.assign2.reshape(-1)
    csr = _csr_from_assignments(a1, a2, sharded.num_codewords)
    d = sharded.codebook1.shape[-1]
    return MultiIndex(sharded.kind, sharded.codebook1, sharded.codebook2,
                      a1, a2, sharded.codebook1.new_zeros((0, d)), *csr)


def _local(kind, cb1, cb2, a1, a2, sorted_ids, offsets, counts,
           log_counts) -> MultiIndex:
    d = cb1.shape[-1]
    return MultiIndex(kind, cb1, cb2, a1, a2, cb1.new_zeros((0, d)),
                      sorted_ids, offsets, counts, log_counts)


def local_index(sharded: VocabShardedIndex, rank: int) -> MultiIndex:
    """Shard `rank`'s view: a MultiIndex over its rows, with its partial
    counts and local CSR."""
    return _local(sharded.kind, sharded.codebook1, sharded.codebook2,
                  *(getattr(sharded, f)[rank] for f in CSR_FIELDS))


def stack_local_indexes(local: MultiIndex, group=None) -> VocabShardedIndex:
    """Every rank's local view gathered into the stacked layout, bit for bit
    (collective)."""
    cols = [all_gather_stack(getattr(local, f), group) for f in CSR_FIELDS]
    return VocabShardedIndex(local.kind, group_size(group), local.codebook1,
                             local.codebook2, *cols)


def local_from_build(kind: str, cb1, cb2, a1, a2, k: int) -> MultiIndex:
    """A rank's local view from its codebooks and row assignments."""
    return _local(kind, cb1, cb2, a1, a2, *_csr_from_assignments(a1, a2, k))


def proposal_index(local_idx: MultiIndex, group=None) -> MultiIndex:
    """The local view with the GLOBAL cluster counts (an integer all-reduce,
    exact): the proposal math runs on it as on the replicated index."""
    counts = psum_no_grad(local_idx.counts, group)
    log_counts = torch.where(
        counts > 0, torch.log(torch.clamp(counts, min=1).float()),
        torch.full_like(counts, float("-inf"), dtype=torch.float32))
    return dataclasses.replace(local_idx, counts=counts,
                               log_counts=log_counts)


def make_member_fn(local_idx: MultiIndex, counts_global: torch.Tensor,
                   group=None):
    """The owner-locating member draw, `member_fn(u, flat_cluster) -> ids`,
    bitwise equal to `_member_uniform` on the replicated index: the rank in
    the cluster from its GLOBAL count, its owner from the exclusive prefix
    of the ranks' counts, the member gathered there, the ids all-reduced.
    (An empty cluster, which has probability 0, gives id 0.)"""
    rows = local_idx.sorted_ids.shape[0]
    shard = group_rank(group)
    counts_loc = local_idx.counts.reshape(-1)                     # [K²]
    counts_all = all_gather_stack(counts_loc, group)              # [n, K²]
    prefix_here = (torch.cumsum(counts_all, 0) - counts_all)[shard]
    cnt_g = counts_global.reshape(-1)

    def member_fn(u: torch.Tensor, cluster: torch.Tensor) -> torch.Tensor:
        r = midx_mod.member_rank(u, cnt_g[cluster])
        local_r = r - prefix_here[cluster]
        own = (local_r >= 0) & (local_r < counts_loc[cluster])
        pos = local_idx.offsets[cluster] + torch.where(own, local_r, 0)
        ids = local_idx.sorted_ids[torch.clamp(pos, 0, rows - 1)]
        ids = torch.where(own, ids + shard * rows, torch.zeros_like(ids))
        return psum_no_grad(ids, group)

    return member_fn


def embed_lookup(table_local: torch.Tensor, tokens: torch.Tensor,
                 group=None) -> torch.Tensor:
    """The vocab-parallel embedding (Megatron's): an owner-masked local
    gather and a psum, equal to the replicated `table[tokens]`. Each rank's
    gradient reaches only its own rows."""
    rows = table_local.shape[0]
    loc = tokens - group_rank(group) * rows
    ok = (loc >= 0) & (loc < rows)
    e = F.embedding(torch.clamp(loc, 0, rows - 1), table_local)
    e = torch.where(ok[..., None], e, torch.zeros_like(e))
    return psum(e, group)


def merge_loss(pos_logit: torch.Tensor, partial: torch.Tensor,
               group=None) -> torch.Tensor:
    """The cross-shard merge (reference `_merge_loss`): the loss [...] from
    the replicated positive logit and this rank's partial lse, with the
    detached shift max(pmax(partial), pos)."""
    shift = torch.maximum(pmax(partial.detach(), group), pos_logit.detach())
    term = torch.where(partial > NEG_INF_THRESHOLD,
                       torch.exp(partial - shift), torch.zeros_like(partial))
    total = psum(term, group) + torch.exp(pos_logit - shift)
    return torch.log(torch.clamp(total, min=1e-30)) + shift - pos_logit


def _masked_mean(loss, mask):
    if mask is not None:
        return torch.sum(loss * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(loss)


def loss_midx_vp(cfg, table_local: torch.Tensor, local_idx: MultiIndex,
                 hidden: torch.Tensor, labels: torch.Tensor,
                 keys: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
                 group=None) -> torch.Tensor:
    """This rank's MIDX sampled CE, merged across the vocab ranks: the same
    scalar on every rank, within 1e-5 of `heads.loss_midx` on the
    replicated layout, loss and gradients, for the three proposals.
    hidden [B,S,D] and labels [B,S] replicated; table_local [rows, D] this
    rank's rows; local_idx its local view (`local_index`); keys [B·S] the
    tokens' stream keys, the same on every rank.

    cfg.head.table_dtype int8 / fp8: the rank quantizes its own rows in the
    step (per-row scales are row-local) and the replicated codebooks as
    the replicated head's state does, so the draws stay the replicated
    ones; the partial CE reads the low-bit rows and its straight-through
    gradients land on the master `table_local`."""
    m = cfg.head.num_negatives
    rows = table_local.shape[0]
    shard = group_rank(group)
    h32 = copy_to_vocab_region(hidden.float(), group)
    b, s, d = h32.shape
    fmt = resolve_table_dtype(getattr(cfg.head, "table_dtype", "bf16"))
    quantized = fmt != "bf16"
    if quantized:
        qd, qsc = quantize_rows(table_local.detach().float(), fmt)
        qcb1, scb1 = quantize_rows(local_idx.codebook1, fmt)
        qcb2, scb2 = quantize_rows(local_idx.codebook2, fmt)
    prop = proposal_index(local_idx, group)
    member = make_member_fn(local_idx, prop.counts, group)
    masked = cfg.head.mask_collisions

    def gather(ids):
        if quantized:
            return dequant_rows(table_local, qd, qsc, ids)
        return F.embedding(ids, table_local).float()

    # the owner-masked positive logit, replicated by the psum
    lpos = labels - shard * rows
    okp = (lpos >= 0) & (lpos < rows)
    lpos_c = torch.where(okp, lpos, torch.zeros_like(lpos))
    pid_local = torch.where(okp, lpos_c, torch.full_like(lpos, -1))
    pos_logit = psum(torch.where(okp, torch.sum(h32 * gather(lpos_c), -1),
                                 torch.zeros((), device=h32.device)), group)

    if cfg.head.proposal == "per_token":
        z = h32.reshape(b * s, d)
        tables_fn = proposal_tables
        if quantized:
            def tables_fn(idx, zz):
                return proposal_tables_q(idx, qcb1, scb1, qcb2, scb2, zz)
        draw = midx_mod.sample_twostage(prop, z, m, keys,
                                        tables_fn=tables_fn,
                                        member_fn=member)          # [T,M]
        lneg = draw.ids - shard * rows
        okn = (lneg >= 0) & (lneg < rows)
        lneg_c = torch.where(okn, lneg, torch.zeros_like(lneg))
        if masked:
            lq_m = torch.where(okn, draw.log_q,
                               draw.log_q.new_tensor(-NEG_INF))
            if quantized:
                partial = sampled_ce_pt_q_partial_op(
                    z, table_local, qd, qsc, lq_m, lneg_c,
                    pid_local.reshape(-1), m)
            else:
                partial = sampled_ce_pt_partial_op(
                    z, table_local, lq_m, lneg_c, pid_local.reshape(-1), m)
        else:
            neg_logits = torch.einsum("td,tmd->tm", z, gather(lneg_c))
            partial = partial_sampled_lse(neg_logits, draw.log_q, m,
                                          mask_collisions=False, valid=okn)
        partial = partial.reshape(b, s)
    elif cfg.head.proposal in ("pooled", "mixture"):
        sampler = (midx_mod.sample_pooled if cfg.head.proposal == "pooled"
                   else midx_mod.sample_mixture)
        scores_fn = None
        if quantized:
            def scores_fn(idx, zz):
                return quantized_query_scores(idx.kind, qcb1, scb1, qcb2,
                                              scb2, zz)
        draw = sampler(prop, h32, m, noise.sequence_keys(keys, s),
                       scores_fn=scores_fn, member_fn=member)      # [B,M]
        lneg = draw.ids - shard * rows
        okn = (lneg >= 0) & (lneg < rows)
        lneg_c = torch.where(okn, lneg, torch.zeros_like(lneg))
        if masked:
            lq_m = torch.where(okn, draw.log_q,
                               draw.log_q.new_tensor(-NEG_INF))
            neg_emb = F.embedding(lneg_c, table_local)            # [B,M,D]
            if quantized:
                partial = sampled_ce_q_partial_op(
                    h32, neg_emb, qd[lneg_c], qsc[lneg_c], lq_m, lneg_c,
                    pid_local, m)
            else:
                partial = sampled_ce_partial_op(h32, neg_emb, lq_m, lneg_c,
                                                pid_local, m)
        else:
            neg_logits = torch.einsum("bsd,bmd->bsm", h32, gather(lneg_c))
            partial = partial_sampled_lse(
                neg_logits, draw.log_q[:, None, :], m, mask_collisions=False,
                valid=okn[:, None, :])
    else:
        raise ValueError(f"unknown proposal {cfg.head.proposal!r}")
    return _masked_mean(merge_loss(pos_logit, partial, group), mask)


def sample_twostage_vp(local_idx: MultiIndex, z: torch.Tensor, m: int,
                       keys: torch.Tensor, *, group=None,
                       tables_fn=None) -> midx_mod.Draw:
    """The vocab-parallel two-stage draw: the replicated sampler's ids and
    log_q, given the same keys (collective)."""
    prop = proposal_index(local_idx, group)
    return midx_mod.sample_twostage(
        prop, z, m, keys, tables_fn=tables_fn,
        member_fn=make_member_fn(local_idx, prop.counts, group))
