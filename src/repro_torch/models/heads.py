"""LM heads: the training losses, the MIDX decode head and its index state.

Mirrors `src/repro/models/heads.py`: `init_head_state` (:39-54, the bare
MultiIndex for a bf16 table, a `QuantHeadState` for int8 / fp8),
`_requantized` (:56), `refresh_head_state` (:71),
`refresh_head_state_with_policy` (:86), `loss_full` (:106), `loss_midx`
(:113, the fused lane: per-token, pooled and mixture proposals, with the
table in its native dtype or, over a quantized state, its int8 / fp8
twin), `_gathered_rows` (:219), `_masked_mean` (:232), the generic proposal
heads `_midx_index_of` (:239), `init_proposal_state` (:253),
`refresh_proposal_state` (:260), `loss_sampled` (:267),
`proposal_decode_head` (:538), and `midx_decode_head` (:316, both
branches).

`loss_midx` is the reference's fused lane. Per-token proposals: the
proposal tables come from the midx_probs kernel and the CE from the
per-token sampled-CE kernels (`kernels.sampled_ce.ops.sampled_ce_pt_op`,
forward and backward) — the [T, M, D] gather and the [T, M] logits never
reach device memory on the card. Pooled and mixture proposals: each
sequence draws M shared negatives (`core.midx.sample_pooled` /
`sample_mixture`, plain joint logits as in the reference), their rows and
the positives' are gathered in the table's native dtype, and the CE runs
in the shared-negative kernels (`sampled_ce_op`) — the [B, S, M] logits
never reach device memory. log q stays attached to the graph, as in the
reference, so d(loss)/d log q flows back through the proposal into the
hidden states. The kernels always mask collisions, so, as in the
reference (`kernels/dispatch.py:55-56`), a head with `mask_collisions`
False takes the plain lane instead (reference :214-215): the same draws,
the rows gathered with `F.embedding` (dequantized through `dequant_rows`
over a quantized state), and `sampled_softmax_loss` with collisions left
unmasked.

Over a `QuantHeadState` (cfg.head.table_dtype int8 / fp8, DESIGN §12)
the whole hot path reads the low-bit twins: the proposal scores the
quantized codebooks (`proposal_tables_q`, the midx_probs kernel's
quantized mode; `quantized_query_scores` for the shared draws), the
per-token CE reads int8 / fp8 rows and their scales in the kernels
(`sampled_ce_pt_q_op`), and the shared CE the gathered low-bit rows
(`sampled_ce_q_op`). The master table's gradient is the straight-through
one: the kernels' scale-unaware row gradients. Departure in the shared
lane: the master rows `pos_emb` / `neg_emb` are gathered (torch removes no
dead read; the kernels never read them), as the reference writes
`table[labels]`. The decode head rescores its candidates from the stage
tables of its own draw and the residual PQ codes (`code_scores`), never
from [V, D] rows.

`loss_sampled` and `proposal_decode_head` run any ported registry
proposal (`repro_torch.proposals`): the draws come from the proposal (for
`rff-fused`, the rff_sample kernel on the card), the rows are gathered
with `F.embedding` and the products are plain torch ops, as the reference
computes them outside any Pallas kernel.

The decode head draws `num_candidates` classes through the two-stage MIDX
proposal, rescores them exactly against the class table, IS-corrects
(logit − log q) and samples one — O(K·M + M·D) per row, no [T, V] logits
matrix. Departures:
  - batched over slots: the reference engine vmaps a one-row head per slot
    (`serve/engine.py:139-142`); here one call takes all T = max_slots
    rows, so one midx_probs launch serves a whole decode wave;
  - randomness is counter-based noise keyed per row (`core/noise.py`), so
    a slot's draw is a function of its own (seed, rid, pos) and never of
    the batch it rides in, a training token's negatives a function of
    (seed, step, token index), and a sequence's shared negatives a
    function of (seed, step, b·S) (`noise.sequence_keys`);
  - the gathers use `F.embedding`, whose backward onto the table sums
    repeated ids in a fixed order, where `table[ids]`'s backward adds
    with atomics;
  - the proposal tables always come through `proposal_tables` and
    `kernels.dispatch` (the CUDA kernel on the card, the plain version on
    the CPU); there is no `fused`/`interpret` switch.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import midx as midx_mod
from repro_torch.core import noise
from repro_torch.core.sampled_softmax import (full_softmax_loss,
                                              sampled_softmax_loss)
from repro_torch.index import lifecycle as lifecycle_mod
from repro_torch.index.build import MultiIndex, build, refresh
from repro_torch.index.quantized import (QuantHeadState, code_scores,
                                         dequant_rows, quantize_head_state,
                                         quantized_query_scores,
                                         resolve_table_dtype, unwrap_index)
from repro_torch.kernels.midx_probs.ops import (proposal_tables,
                                                proposal_tables_q)
from repro_torch.kernels.sampled_ce.ops import (sampled_ce_op,
                                                sampled_ce_pt_op,
                                                sampled_ce_pt_q_op,
                                                sampled_ce_q_op)
from repro_torch.models.model import class_embeddings, logits_full


@torch.no_grad()
def init_head_state(cfg: ModelConfig, params: dict, gen: torch.Generator):
    """Build the inverted multi-index over the class-embedding table: the
    bare MultiIndex for table_dtype 'bf16', a QuantHeadState (the index,
    the low-bit table and codebooks, the residual PQ codes) for 'int8' /
    'fp8'. The codes' k-means draw from `gen` after the index's."""
    fmt = resolve_table_dtype(cfg.head.table_dtype)
    table = class_embeddings(cfg, params).float()
    index = build(gen, table, kind=cfg.head.quantizer, k=cfg.head.midx_k,
                  iters=cfg.head.kmeans_iters, keep_residuals=False)
    if fmt == "bf16":
        return index
    return quantize_head_state(index, table, fmt, gen=gen)


def _requantized(cfg: ModelConfig, state: QuantHeadState,
                 new_index: MultiIndex, table: torch.Tensor,
                 gen: torch.Generator) -> QuantHeadState:
    """The low-bit twins rebuilt around a refreshed index. With
    quantize_on_refresh False only the index swaps and the twins stay as
    they were (an approximation knob; the draws use the fresh index)."""
    if not cfg.head.quantize_on_refresh:
        return dataclasses.replace(state, index=new_index)
    rc = state.residual_codes
    return quantize_head_state(new_index, table, state.fmt, gen=gen,
                               n_sub=rc.n_sub, ksub=rc.ksub)


@torch.no_grad()
def refresh_head_state(cfg: ModelConfig, params: dict, state,
                       gen: torch.Generator):
    """Full refit against the current class table, warm-started; a
    quantized state re-derives its twins (`_requantized`)."""
    table = class_embeddings(cfg, params).float()
    new_index = refresh(unwrap_index(state), gen, table,
                        iters=cfg.head.kmeans_iters)
    if isinstance(state, QuantHeadState):
        return _requantized(cfg, state, new_index, table, gen)
    return new_index


@torch.no_grad()
def refresh_head_state_with_policy(cfg: ModelConfig, params: dict, state,
                                   gen: torch.Generator,
                                   policy: Optional[str] = None):
    """One refresh event under cfg.head.refresh_policy (or an override).
    Returns (new_state, metrics): reassigned_frac, codeword_drift, did_full,
    distortion. A quantized state re-derives its twins here, riding the
    lifecycle's swap with its index."""
    table = class_embeddings(cfg, params).float()
    new_index, metrics = lifecycle_mod.refresh_with_policy(
        unwrap_index(state), gen, table, iters=cfg.head.kmeans_iters,
        policy=policy or cfg.head.refresh_policy,
        threshold=cfg.head.refresh_drift_threshold)
    if isinstance(state, QuantHeadState):
        return _requantized(cfg, state, new_index, table, gen), metrics
    return new_index, metrics


def _masked_mean(loss: torch.Tensor,
                 mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is not None:
        return torch.sum(loss * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(loss)


def loss_full(cfg: ModelConfig, params: dict, hidden: torch.Tensor,
              labels: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-softmax CE over the padded vocabulary; [B,S,D] -> scalar."""
    logits = logits_full(cfg, params, hidden)
    return _masked_mean(full_softmax_loss(logits, labels), mask)


def quantized_tables_fn(qs: QuantHeadState):
    """The `tables_fn` hook of a quantized state: the proposal tables from
    its low-bit codebooks (the midx_probs kernel's quantized mode on the
    card, its plain version on the CPU), so that training and serving draw
    from the same distribution."""
    def tables_fn(index, z):
        return proposal_tables_q(index, qs.qcb1, qs.qcb1_scale, qs.qcb2,
                                 qs.qcb2_scale, z)
    return tables_fn


def loss_midx(cfg: ModelConfig, params: dict, index, hidden: torch.Tensor,
              labels: torch.Tensor, keys: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MIDX sampled-softmax CE. `index` is the head state: a MultiIndex,
    or a QuantHeadState whose low-bit twins the whole path then reads.
    hidden [B,S,D], labels [B,S], keys [B·S] the tokens' stream keys
    (`noise.train_keys(seed, step, B·S)`); the shared proposals key
    sequence b by keys[b·S]."""
    qs = index if isinstance(index, QuantHeadState) else None
    index = unwrap_index(index)
    table = class_embeddings(cfg, params)
    m = cfg.head.num_negatives
    b, s, d = hidden.shape
    proposal = cfg.head.proposal
    masked = cfg.head.mask_collisions
    if proposal == "per_token":
        h32 = hidden.float().reshape(b * s, d)
        tables_fn = proposal_tables if qs is None else quantized_tables_fn(qs)
        draw = midx_mod.sample_twostage(index, h32, m, keys,
                                        tables_fn=tables_fn)        # [T,M]
        if masked:
            if qs is None:
                loss = sampled_ce_pt_op(h32, table, draw.log_q, draw.ids,
                                        labels.reshape(b * s))
            else:
                loss = sampled_ce_pt_q_op(h32, table, qs.qdata, qs.qscale,
                                          draw.log_q, draw.ids,
                                          labels.reshape(b * s))
            return _masked_mean(loss.reshape(b, s), mask)
        pos_e, neg_e = _gathered_rows(table, qs, labels, draw.ids)
        neg_logits = torch.einsum("td,tmd->tm", h32, neg_e)
        loss = _unmasked_loss(h32.reshape(b, s, d), pos_e, labels,
                              neg_logits.reshape(b, s, m),
                              draw.log_q.reshape(b, s, m),
                              draw.ids.reshape(b, s, m))
        return _masked_mean(loss, mask)
    if proposal not in ("pooled", "mixture"):
        raise ValueError(f"unknown proposal {proposal!r}")
    sampler = (midx_mod.sample_pooled if proposal == "pooled"
               else midx_mod.sample_mixture)
    scores_fn = None
    if qs is not None:
        def scores_fn(idx, z):
            return quantized_query_scores(idx.kind, qs.qcb1, qs.qcb1_scale,
                                          qs.qcb2, qs.qcb2_scale, z)
    h32 = hidden.float()
    draw = sampler(index, h32, m, noise.sequence_keys(keys, s),
                   scores_fn=scores_fn)                           # [B,M]
    if masked:
        pos_emb = F.embedding(labels, table)              # [B,S,D] native
        neg_emb = F.embedding(draw.ids, table)            # [B,M,D] native
        if qs is None:
            loss = sampled_ce_op(h32, pos_emb, neg_emb, draw.log_q, draw.ids,
                                 labels)
        else:
            loss = sampled_ce_q_op(h32, pos_emb, neg_emb, qs.qdata[labels],
                                   qs.qscale[labels], qs.qdata[draw.ids],
                                   qs.qscale[draw.ids], draw.log_q,
                                   draw.ids, labels)
        return _masked_mean(loss, mask)
    pos_e, neg_e = _gathered_rows(table, qs, labels, draw.ids)
    neg_logits = torch.einsum("bsd,bmd->bsm", h32, neg_e)
    loss = _unmasked_loss(h32, pos_e, labels, neg_logits,
                          draw.log_q[:, None, :], draw.ids[:, None, :])
    return _masked_mean(loss, mask)


def _gathered_rows(table: torch.Tensor, qs: Optional[QuantHeadState],
                   labels: torch.Tensor, neg_ids: torch.Tensor):
    """fp32 (pos_rows, neg_rows) for the plain lane: a quantized state's
    rows dequantized per gathered row with straight-through gradients onto
    the master table; else the rows cast per gathered row (never the whole
    [V, D] table)."""
    if qs is not None:
        return (dequant_rows(table, qs.qdata, qs.qscale, labels),
                dequant_rows(table, qs.qdata, qs.qscale, neg_ids))
    return (F.embedding(labels, table).float(),
            F.embedding(neg_ids, table).float())


def _unmasked_loss(h32, pos_e, labels, neg_logits, log_q, neg_ids):
    """The plain lane of `loss_midx` for `mask_collisions` False: per-token
    sampled CE [B, S] with a negative equal to the positive left in."""
    pos_logit = torch.sum(h32 * pos_e, dim=-1)
    return sampled_softmax_loss(pos_logit, neg_logits, log_q, neg_ids,
                                labels, mask_collisions=False)


class MidxDecodeOut(NamedTuple):
    token: torch.Tensor      # [T] sampled next token
    log_q: torch.Tensor      # [T] proposal log-prob of that token


def candidate_logits(cfg: ModelConfig, params: dict, hidden: torch.Tensor,
                     ids: torch.Tensor, log_q: torch.Tensor,
                     temperature: float) -> torch.Tensor:
    """IS-corrected candidate logits: h·e_i / temperature − log q(i).
    hidden [T, D], ids/log_q [T, M] -> [T, M]. Casts per gathered row,
    never the whole [V, D] table."""
    cand = class_embeddings(cfg, params)[ids].float()            # [T,M,D]
    logits = torch.einsum("td,tmd->tm", hidden.float(), cand) / temperature
    return logits - log_q


def midx_decode_head(cfg: ModelConfig, params: dict, index,
                     hidden: torch.Tensor, keys: torch.Tensor,
                     num_candidates: Optional[int] = None,
                     temperature: Optional[float] = None) -> MidxDecodeOut:
    """Next-token sampling for T rows at once. hidden [T, D]; keys [T] the
    rows' stream keys (`noise.row_keys(seed, rid, pos)`). Over a
    QuantHeadState the draw scores the low-bit codebooks and the candidates
    are rescored from codes: o_i ≈ s1[k1(i)] + s2[k2(i)] + ADC(z, codes_i)
    from the draw's own stage tables, 2 assignments and n_sub code bytes a
    candidate instead of a D-wide row.

    `num_candidates` / `temperature` default to `cfg.head.decode_candidates`
    / `cfg.head.decode_temperature`."""
    if num_candidates is None:
        num_candidates = cfg.head.decode_candidates
    if temperature is None:
        temperature = cfg.head.decode_temperature
    h = hidden.float()
    if isinstance(index, QuantHeadState):
        qs, index = index, index.index
        draw, (s1, s2, _, _) = midx_mod.sample_twostage(
            index, h, num_candidates, keys, tables_fn=quantized_tables_fn(qs),
            return_tables=True)                                     # [T,M]
        scores = code_scores(index, qs.residual_codes, h, draw.ids, s1, s2)
        corrected = scores / temperature - draw.log_q
    else:
        draw = midx_mod.sample_twostage(index, h, num_candidates, keys,
                                        tables_fn=proposal_tables)  # [T,M]
        corrected = candidate_logits(cfg, params, h, draw.ids, draw.log_q,
                                     temperature)
    return _pick(draw, corrected, keys)


def _pick(draw, corrected: torch.Tensor, keys: torch.Tensor) -> MidxDecodeOut:
    """One candidate per row from softmax(corrected) by Gumbel-max under
    the row's key (role ROLE_PICK), with its proposal log-prob."""
    col = torch.arange(corrected.shape[-1], device=corrected.device)
    g = noise.gumbel_noise(keys[:, None], noise.ROLE_PICK, 0, col)   # [T,M]
    pick = torch.argmax(corrected + g, dim=-1, keepdim=True)         # [T,1]
    return MidxDecodeOut(torch.gather(draw.ids, 1, pick)[:, 0],
                         torch.gather(draw.log_q, 1, pick)[:, 0])


# --------------------------------------------------------- generic proposals
def _midx_index_of(proposal, state):
    """The MultiIndex behind a midx-backed proposal state, or None.

    midx-pq/rq keep the index AS the state; midx-learnable derives one from
    the trained codebooks. midx-exact-* is NOT a fast-lane candidate — its
    sampling distribution is the exact softmax, not the index proposal."""
    if proposal is None:
        return state
    if proposal.name in ("midx-pq", "midx-rq"):
        return state
    if proposal.name.startswith("midx-learnable"):
        return state["index"]
    return None


@torch.no_grad()
def init_proposal_state(cfg: ModelConfig, params: dict, gen: torch.Generator,
                        proposal, class_freq: Optional[torch.Tensor] = None):
    """Proposal-state counterpart of init_head_state (any contender)."""
    table = class_embeddings(cfg, params).detach().float()
    return proposal.init(gen, table, class_freq)


@torch.no_grad()
def refresh_proposal_state(cfg: ModelConfig, params: dict, proposal, state,
                           gen: torch.Generator):
    """Refresh any proposal's state against the current class table."""
    table = class_embeddings(cfg, params).detach().float()
    return proposal.refresh(state, gen, table)


def loss_sampled(cfg: ModelConfig, params: dict, proposal, state,
                 hidden: torch.Tensor, labels: torch.Tensor,
                 keys: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sampled softmax CE through any registered proposal. hidden [B,S,D],
    labels [B,S], keys [B·S] the tokens' stream keys.

    MIDX-backed contenders short-circuit to `loss_midx` with their
    MultiIndex as the head state. Everything else runs the plain
    formulation, its products as torch ops, as the reference computes them
    outside any Pallas kernel:
      per_token        draws [B,S,M] negatives from q(·|h_t), token t keyed
                       by keys[t];
      pooled / mixture draws [B,M] shared negatives from q(·|z̄) with
                       z̄ = mean_t h_t, sequence b keyed by keys[b·S]
                       (`noise.sequence_keys`); generic proposals have no
                       per-token mixture form, so 'mixture' pools too."""
    idx = _midx_index_of(proposal, state)
    if idx is not None:
        return loss_midx(cfg, params, idx, hidden, labels, keys, mask)
    table = class_embeddings(cfg, params)
    m = cfg.head.num_negatives
    b, s, _ = hidden.shape
    h32 = hidden.float()
    pos_logit = torch.sum(h32 * F.embedding(labels, table).float(), dim=-1)
    if cfg.head.proposal == "per_token":
        draw = proposal.sample(state, keys.reshape(b, s), h32, m)  # [B,S,M]
        neg_e = F.embedding(draw.ids, table).float()              # [B,S,M,D]
        neg_logits = torch.einsum("bsd,bsmd->bsm", h32, neg_e)
        log_q, neg_ids = draw.log_q, draw.ids
    else:
        z_bar = torch.mean(h32, dim=-2)                           # [B,D]
        draw = proposal.sample(state, noise.sequence_keys(keys, s), z_bar,
                               m)                                 # [B,M]
        neg_e = F.embedding(draw.ids, table).float()              # [B,M,D]
        neg_logits = torch.einsum("bsd,bmd->bsm", h32, neg_e)
        log_q = draw.log_q[:, None, :]                            # over S
        neg_ids = draw.ids[:, None, :]
    loss = sampled_softmax_loss(pos_logit, neg_logits, log_q, neg_ids, labels,
                                cfg.head.mask_collisions)
    return _masked_mean(loss, mask)


def proposal_decode_head(cfg: ModelConfig, params: dict, proposal, state,
                         hidden: torch.Tensor, keys: torch.Tensor,
                         num_candidates: Optional[int] = None,
                         temperature: Optional[float] = None
                         ) -> MidxDecodeOut:
    """midx_decode_head generalised to any proposal: draw candidates from
    q(·|h), rescore exactly, IS-correct, sample. hidden [T, D], keys [T].
    MIDX-backed states keep the dedicated path."""
    idx = _midx_index_of(proposal, state)
    if idx is not None:
        return midx_decode_head(cfg, params, idx, hidden, keys,
                                num_candidates, temperature)
    if num_candidates is None:
        num_candidates = cfg.head.decode_candidates
    if temperature is None:
        temperature = cfg.head.decode_temperature
    h = hidden.float()
    draw = proposal.sample(state, keys, h, num_candidates)          # [T,M]
    corrected = candidate_logits(cfg, params, h, draw.ids, draw.log_q,
                                 temperature)
    return _pick(draw, corrected, keys)
