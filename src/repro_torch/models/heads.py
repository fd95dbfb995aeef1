"""LM heads: the training losses, the MIDX decode head and its index state.

Mirrors `src/repro/models/heads.py`: `init_head_state` (:39-54, the bare
MultiIndex for a bf16 table, a `QuantHeadState` for int8 / fp8),
`_requantized` (:56), `refresh_head_state` (:71),
`refresh_head_state_with_policy` (:86), `loss_full` (:106), `loss_midx`
(:113, both routes: per-token, pooled and mixture proposals, with the
table in its native dtype or, over a quantized state, its int8 / fp8
twin), `_gathered_rows` (:219), `_masked_mean` (:232), the generic proposal
heads `_midx_index_of` (:239), `init_proposal_state` (:253),
`refresh_proposal_state` (:260), `loss_sampled` (:267),
`proposal_decode_head` (:538), `midx_decode_head` (:316, both
branches), and speculative decoding's `_spec_tables_fn` (:377, here
`_decode_tables_fn`, shared with the decode head), `midx_spec_draft`
(:401) and `spec_verify` (:442).

`loss_midx` takes the reference's two routes (`fused=`, defaulting to
`cfg.head.use_fused_head`, through `kernels.dispatch.fused_head_active`).
The fused route, the default: per-token proposals take the proposal
tables from the midx_probs kernel and the CE from the per-token
sampled-CE kernels (`kernels.sampled_ce.ops.sampled_ce_pt_op`, forward and
backward) — the [T, M, D] gather and the [T, M] logits never reach device
memory on the card; pooled and mixture proposals draw M shared negatives
a sequence (`core.midx.sample_pooled` / `sample_mixture`, plain joint
logits as in the reference), gather their rows and the positives' in the
table's native dtype, and run the CE in the shared-negative kernels
(`sampled_ce_op`) — the [B, S, M] logits never reach device memory. The
unfused route (reference :178-216) runs no kernel: the tables from
`core.midx.twostage_tables` (or its quantized twin), the rows gathered
with `F.embedding` (dequantized through `dequant_rows` over a quantized
state), the logits an `einsum`, and `sampled_softmax_loss` with the
head's `mask_collisions`; on the card these are torch's own CUDA ops. The
kernels always mask collisions, so a head with `mask_collisions` False
always takes the unfused route (reference `kernels/dispatch.py:55-56`).
log q stays attached to the graph on both routes, as in the reference, so
d(loss)/d log q flows back through the proposal into the hidden states.

Over a `QuantHeadState` (cfg.head.table_dtype int8 / fp8, DESIGN §12)
the whole hot path reads the low-bit twins: the proposal scores the
quantized codebooks (`proposal_tables_q`, the midx_probs kernel's
quantized mode, on the fused route, `core.midx.twostage_tables_q` on the
unfused; `quantized_query_scores` for the shared draws), the per-token CE
reads int8 / fp8 rows and their scales in the kernels
(`sampled_ce_pt_q_op`), the shared CE the gathered low-bit rows
(`sampled_ce_q_op`), and the unfused CE the rows `dequant_rows` gathers.
The master table's gradient is the straight-through one: the kernels'
scale-unaware row gradients, or `dequant_rows`' gather. Departure in the shared
lane: the master rows `pos_emb` / `neg_emb` are gathered (torch removes no
dead read; the kernels never read them), as the reference writes
`table[labels]`. The decode head rescores its candidates from the stage
tables of its own draw and the residual PQ codes (`code_scores`), never
from [V, D] rows.

`loss_sampled` and `proposal_decode_head` run any registry proposal
(`repro_torch.proposals`): the MIDX-backed ones (midx-pq / -rq and the
learnable midx-learnable-*) through `loss_midx` / `midx_decode_head`, the
others with their own draws (for `rff-fused`, the rff_sample kernel on the
card), the rows gathered with `F.embedding` and the products as plain
torch ops, as the reference computes them outside any Pallas kernel.

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
  - the fused route's proposal tables come through `proposal_tables` and
    `kernels.dispatch` (the CUDA kernel on the card, the plain version on
    the CPU); `fused` has no `interpret` companion (the port has no
    Pallas interpreter);
  - speculative decoding: `midx_spec_draft` draws all B rows' k drafts in
    one `sample_twostage` call (the reference vmaps a one-row draw per
    slot), under the wave key salted by ROLE_SPEC_DRAFT; `spec_verify`'s
    accept uniforms and correction Gumbels are counter noise of the wave
    key under ROLE_SPEC_ACCEPT / ROLE_SPEC_CORRECT and the draft index j
    (the reference folds 2 and 3 into a JAX key). Every random number of
    a wave is so a function of (seed, rid, the wave's start position,
    role, j) alone.
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
from repro_torch.dist import tensor_parallel as tp
from repro_torch.index import lifecycle as lifecycle_mod
from repro_torch.index.build import MultiIndex, build, refresh
from repro_torch.index.quantized import (QuantHeadState, code_scores,
                                         dequant_rows, quantize_head_state,
                                         quantized_query_scores,
                                         resolve_table_dtype, unwrap_index)
from repro_torch.kernels.dispatch import fused_head_active
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
    """Full-softmax CE over the padded vocabulary; [B,S,D] -> scalar.
    Under the model axis a row-split table takes the vocab-split softmax
    (`dist.vocab_parallel.loss_full_vp` over the model group)."""
    if tp.splits(cfg.padded_vocab):
        from repro_torch.dist.vocab_parallel import loss_full_vp
        return loss_full_vp(class_embeddings(cfg, params), hidden, labels,
                            mask, group=tp.model_group())
    logits = logits_full(cfg, params, hidden)
    return _masked_mean(full_softmax_loss(logits, labels), mask)


def route_tables_fn(qs: Optional[QuantHeadState], use_fused: bool):
    """The two-stage draw's `tables_fn` hook on each route (reference
    `kernels/dispatch.py:65-111`): fused, the midx_probs wrappers
    (`proposal_tables`, or `proposal_tables_q` over a quantized state's
    low-bit codebooks); unfused, `core.midx.twostage_tables` (the
    sampler's default, None) or `twostage_tables_q`, plain torch ops on
    the tensors' own device."""
    if qs is None:
        return proposal_tables if use_fused else None
    tables_q = proposal_tables_q if use_fused else midx_mod.twostage_tables_q

    def tables_fn(index, z):
        return tables_q(index, qs.qcb1, qs.qcb1_scale, qs.qcb2,
                        qs.qcb2_scale, z)
    return tables_fn


def quantized_tables_fn(qs: QuantHeadState):
    """The fused route's `tables_fn` hook of a quantized state: the
    proposal tables from its low-bit codebooks (the midx_probs kernel's
    quantized mode on the card, its plain version on the CPU), so that
    training and serving draw from the same distribution."""
    return route_tables_fn(qs, use_fused=True)


def _decode_tables_fn(cfg: ModelConfig, qs: Optional[QuantHeadState],
                      fused: Optional[bool]):
    """The decode head's and the speculative draft's hook (reference
    `_spec_tables_fn` :377-390): both draw from the distribution the
    serving head samples."""
    return route_tables_fn(qs, fused_head_active(cfg.head, fused=fused))


def loss_midx(cfg: ModelConfig, params: dict, index, hidden: torch.Tensor,
              labels: torch.Tensor, keys: torch.Tensor,
              mask: Optional[torch.Tensor] = None, *,
              fused: Optional[bool] = None) -> torch.Tensor:
    """MIDX sampled-softmax CE. `index` is the head state: a MultiIndex,
    or a QuantHeadState whose low-bit twins the whole path then reads.
    hidden [B,S,D], labels [B,S], keys [B·S] the tokens' stream keys
    (`noise.train_keys(seed, step, B·S)`); the shared proposals key
    sequence b by keys[b·S]. `fused` picks the route
    (`kernels.dispatch.fused_head_active`: None defers to
    cfg.head.use_fused_head; a head without collision masking is always
    unfused)."""
    qs = index if isinstance(index, QuantHeadState) else None
    index = unwrap_index(index)
    table = class_embeddings(cfg, params)
    m = cfg.head.num_negatives
    b, s, d = hidden.shape
    proposal = cfg.head.proposal
    use_fused = fused_head_active(cfg.head, fused=fused)
    if proposal == "per_token":
        h32 = hidden.float().reshape(b * s, d)
        draw = midx_mod.sample_twostage(
            index, h32, m, keys,
            tables_fn=route_tables_fn(qs, use_fused))           # [T,M]
        pos_ids = labels.reshape(b * s)
        if not use_fused:
            loss = sampled_ce_unfused(cfg, h32, table, qs, draw.log_q,
                                      draw.ids, pos_ids)
        elif qs is None:
            loss = sampled_ce_pt_op(h32, table, draw.log_q, draw.ids,
                                    pos_ids)
        else:
            loss = sampled_ce_pt_q_op(h32, table, qs.qdata, qs.qscale,
                                      draw.log_q, draw.ids, pos_ids)
        return _masked_mean(loss.reshape(b, s), mask)
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
    if not use_fused:
        return _masked_mean(sampled_ce_unfused(
            cfg, h32, table, qs, draw.log_q, draw.ids, labels), mask)
    pos_emb = F.embedding(labels, table)                  # [B,S,D] native
    neg_emb = F.embedding(draw.ids, table)                # [B,M,D] native
    if qs is None:
        loss = sampled_ce_op(h32, pos_emb, neg_emb, draw.log_q, draw.ids,
                             labels)
    else:
        loss = sampled_ce_q_op(h32, pos_emb, neg_emb, qs.qdata[labels],
                               qs.qscale[labels], qs.qdata[draw.ids],
                               qs.qscale[draw.ids], draw.log_q, draw.ids,
                               labels)
    return _masked_mean(loss, mask)


def _gathered_rows(table: torch.Tensor, qs: Optional[QuantHeadState],
                   labels: torch.Tensor, neg_ids: torch.Tensor):
    """fp32 (pos_rows, neg_rows) for the unfused route: a quantized
    state's rows dequantized per gathered row with straight-through
    gradients onto the master table; else the rows cast per gathered row
    (never the whole [V, D] table)."""
    if qs is not None:
        return (dequant_rows(table, qs.qdata, qs.qscale, labels),
                dequant_rows(table, qs.qdata, qs.qscale, neg_ids))
    return (F.embedding(labels, table).float(),
            F.embedding(neg_ids, table).float())


def sampled_ce_unfused(cfg: ModelConfig, h32: torch.Tensor,
                       table: torch.Tensor, qs: Optional[QuantHeadState],
                       log_q: torch.Tensor, neg_ids: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """The unfused route's sampled CE (reference :178-181, :208-216; the
    generic contenders' too, :289-308): the rows gathered
    (`_gathered_rows`), then `sampled_ce_rows`. Per-token draws: h32
    [..., D], log_q / neg_ids [..., M], labels [...] -> [...]; shared
    draws: h32 [B, S, D], log_q / neg_ids [B, M], labels [B, S] ->
    [B, S]."""
    pos_e, neg_e = _gathered_rows(table, qs, labels, neg_ids)
    return sampled_ce_rows(cfg, h32, pos_e, neg_e, log_q, neg_ids, labels)


def sampled_ce_rows(cfg: ModelConfig, h32: torch.Tensor,
                    pos_e: torch.Tensor, neg_e: torch.Tensor,
                    log_q: torch.Tensor, neg_ids: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """`sampled_ce_unfused` from the gathered fp32 rows (pos_e like h32,
    neg_e [..., M, D] per token or [B, M, D] shared), plain torch ops: the
    logits an einsum, then `sampled_softmax_loss` with the head's
    `mask_collisions`."""
    if neg_ids.dim() == h32.dim():                      # per-token
        neg_logits = torch.einsum("...d,...md->...m", h32, neg_e)
    else:                                               # shared over S
        neg_logits = torch.einsum("bsd,bmd->bsm", h32, neg_e)
        log_q, neg_ids = log_q[:, None, :], neg_ids[:, None, :]
    pos_logit = torch.sum(h32 * pos_e, dim=-1)
    return sampled_softmax_loss(pos_logit, neg_logits, log_q, neg_ids,
                                labels, cfg.head.mask_collisions)


class MidxDecodeOut(NamedTuple):
    token: torch.Tensor      # [T] sampled next token
    log_q: torch.Tensor      # [T] proposal log-prob of that token


def candidate_logits(cfg: ModelConfig, params: dict, hidden: torch.Tensor,
                     ids: torch.Tensor, log_q: torch.Tensor,
                     temperature: float) -> torch.Tensor:
    """IS-corrected candidate logits: h·e_i / temperature − log q(i).
    hidden [T, D], ids/log_q [T, M] -> [T, M]. Casts per gathered row,
    never the whole [V, D] table."""
    cand = tp.table_rows(class_embeddings(cfg, params), ids,
                         cfg.padded_vocab).float()               # [T,M,D]
    logits = torch.einsum("td,tmd->tm", hidden.float(), cand) / temperature
    return logits - log_q


def midx_decode_head(cfg: ModelConfig, params: dict, index,
                     hidden: torch.Tensor, keys: torch.Tensor,
                     num_candidates: Optional[int] = None,
                     temperature: Optional[float] = None, *,
                     fused: Optional[bool] = None) -> MidxDecodeOut:
    """Next-token sampling for T rows at once. hidden [T, D]; keys [T] the
    rows' stream keys (`noise.row_keys(seed, rid, pos)`). Over a
    QuantHeadState the draw scores the low-bit codebooks and the candidates
    are rescored from codes: o_i ≈ s1[k1(i)] + s2[k2(i)] + ADC(z, codes_i)
    from the draw's own stage tables, 2 assignments and n_sub code bytes a
    candidate instead of a D-wide row.

    `num_candidates` / `temperature` default to `cfg.head.decode_candidates`
    / `cfg.head.decode_temperature`; `fused` picks the stage tables' route
    as in `loss_midx`."""
    if num_candidates is None:
        num_candidates = cfg.head.decode_candidates
    if temperature is None:
        temperature = cfg.head.decode_temperature
    h = hidden.float()
    qs = index if isinstance(index, QuantHeadState) else None
    index = unwrap_index(index)
    tables_fn = _decode_tables_fn(cfg, qs, fused)
    if qs is not None:
        draw, (s1, s2, _, _) = midx_mod.sample_twostage(
            index, h, num_candidates, keys, tables_fn=tables_fn,
            return_tables=True)                                     # [T,M]
        scores = code_scores(index, qs.residual_codes, h, draw.ids, s1, s2)
        corrected = scores / temperature - draw.log_q
    else:
        draw = midx_mod.sample_twostage(index, h, num_candidates, keys,
                                        tables_fn=tables_fn)        # [T,M]
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


# ------------------------------------------------------ speculative decoding
class SpecDraftOut(NamedTuple):
    tokens: torch.Tensor     # [B, k] draft tokens, i.i.d. ~ q(.|h)
    log_q: torch.Tensor      # [B, k] their proposal log-probs
    s1: torch.Tensor         # [B, K] stage-1 scores (shared by the k drafts)
    s2: torch.Tensor         # [B, K] stage-2 scores
    lse: torch.Tensor        # [B]    Eq.(6) normaliser


def midx_spec_draft(cfg: ModelConfig, params: dict, index,
                    hidden: torch.Tensor, keys: torch.Tensor,
                    k: int = 1, *,
                    fused: Optional[bool] = None) -> SpecDraftOut:
    """k MIDX draft tokens per row for speculative decoding.

    The whole wave drafts from ONE hidden per slot, the backbone state
    that predicted the slot's last committed token: one stage-table build
    and k two-stage draws, no backbone step. The draws are i.i.d. given
    `hidden`; q is one position stale past the first draft, which costs
    acceptance, not correctness (the verifier scores each draft under the
    q it was drawn from). The stage tables come back so that the verify
    pass rebuilds log q over the whole vocabulary from two assignment
    gathers. hidden [B, D]; keys [B] the wave keys (`noise.row_keys` of
    the wave's start position); the draws run under hash(key,
    ROLE_SPEC_DRAFT, 0, 0), a key no other draw of the wave uses. `fused`
    as in `midx_decode_head`."""
    qs = index if isinstance(index, QuantHeadState) else None
    draw, (s1, s2, _, lse) = midx_mod.sample_twostage(
        unwrap_index(index), hidden.float(), k,
        noise.hash_bits(keys, noise.ROLE_SPEC_DRAFT, 0, 0),
        tables_fn=_decode_tables_fn(cfg, qs, fused), return_tables=True)
    return SpecDraftOut(draw.ids, draw.log_q, s1, s2, lse)


class SpecVerifyOut(NamedTuple):
    tokens: torch.Tensor     # [k, B] committed tokens (rows < n_commit)
    n_commit: torch.Tensor   # [B] tokens to commit this wave (1..k)
    n_accept: torch.Tensor   # [B] accepted drafts


def spec_verify(cfg: ModelConfig, params: dict, index, hiddens: torch.Tensor,
                drafts: torch.Tensor, log_q: torch.Tensor, s1: torch.Tensor,
                s2: torch.Tensor, lse: torch.Tensor, keys: torch.Tensor,
                temperature: Optional[float] = None) -> SpecVerifyOut:
    """Batched full-head verification of k MIDX drafts per slot.

    hiddens [k, B, D] the backbone states at the drafted positions (the
    wave's one chunked backbone pass); drafts / log_q [k, B] from
    `midx_spec_draft`; s1 / s2 [B, K] and lse [B] its stage tables; keys
    [B] the wave keys. One `logits_full` product over the k·B rows gives
    the target p(.|h_j) = softmax(logits[:V] / T). Leviathan-style
    rejection sampling: draft d_j is accepted with probability
    min(1, p(d_j) / q(d_j)) (uniform of draft j under ROLE_SPEC_ACCEPT);
    at the first rejection j* a token ~ max(p − q, 0) / Z is emitted
    (Gumbel-max under ROLE_SPEC_CORRECT and j*) and the wave stops, so the
    committed prefix is distributed exactly as sequential sampling from p.
    The accept tests read two scalars a draft (its target log-prob and the
    row's lse), never a [k, B, V] softmax; the residual is built at j*
    only, with log q over the vocabulary from two assignment gathers of
    s1 / s2. A padded-vocabulary draft (id >= V) has p = 0 and always
    rejects. temperature <= 0 is the greedy verify: accept iff the draft
    is the argmax, else commit the argmax, token-identical to greedy
    full-head decoding."""
    if temperature is None:
        temperature = cfg.head.decode_temperature
    index = unwrap_index(index)
    v = cfg.vocab_size
    k, b = drafts.shape
    dev = hiddens.device
    logits = logits_full(cfg, params, hiddens)[..., :v]            # [k,B,V]
    jrow = torch.arange(k, device=dev)[:, None]                     # [k,1]
    cols = torch.arange(b, device=dev)
    if temperature > 0:
        scaled = logits / temperature
        lse_p = torch.logsumexp(scaled, dim=-1)                     # [k,B]
        dc = torch.clamp(drafts, max=v - 1)[..., None]
        logp_d = torch.gather(scaled, -1, dc)[..., 0] - lse_p
        logp_d = torch.where(drafts < v, logp_d,
                             logp_d.new_tensor(float("-inf")))
        u = noise.uniform_noise(keys[None, :], noise.ROLE_SPEC_ACCEPT, jrow,
                                0)                                  # [k,B]
        accept = torch.log(u) < logp_d - log_q
        n_acc = torch.cumprod(accept.long(), dim=0).sum(dim=0)      # [B]
        jstar = torch.clamp(n_acc, max=k - 1)
        logp_row = scaled[jstar, cols] - lse_p[jstar, cols][:, None]  # [B,V]
        logq_row = (s1[:, index.assign1[:v]] + s2[:, index.assign2[:v]]
                    - lse[:, None])
        resid = torch.clamp(torch.exp(logp_row) - torch.exp(logq_row),
                            min=0.0)
        g = noise.gumbel_noise(keys[:, None], noise.ROLE_SPEC_CORRECT,
                               jstar[:, None],
                               torch.arange(v, device=dev)[None, :])
        c_r = torch.argmax(torch.log(resid) + g, dim=-1)
        # a float-degenerate residual (p <= q everywhere, probability ~0)
        # falls back to the exact target
        c_f = torch.argmax(logp_row + g, dim=-1)
        corr = torch.where(resid.sum(dim=-1) > 0, c_r, c_f)
    else:
        best = torch.argmax(logits, dim=-1)                         # [k,B]
        n_acc = torch.cumprod((drafts == best).long(), dim=0).sum(dim=0)
        corr = best[torch.clamp(n_acc, max=k - 1), cols]
    toks = torch.where(jrow < n_acc[None, :], drafts,
                       torch.where(jrow == n_acc[None, :], corr[None, :], 0))
    return SpecVerifyOut(toks, torch.clamp(n_acc + 1, max=k), n_acc)


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
                 mask: Optional[torch.Tensor] = None, *,
                 fused: Optional[bool] = None) -> torch.Tensor:
    """Sampled softmax CE through any registered proposal. hidden [B,S,D],
    labels [B,S], keys [B·S] the tokens' stream keys.

    MIDX-backed contenders short-circuit to `loss_midx` with their
    MultiIndex as the head state, on the route `fused` picks. Everything
    else runs the plain
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
        return loss_midx(cfg, params, idx, hidden, labels, keys, mask,
                         fused=fused)
    m = cfg.head.num_negatives
    b, s, _ = hidden.shape
    h32 = hidden.float()
    if cfg.head.proposal == "per_token":
        draw = proposal.sample(state, keys.reshape(b, s), h32, m)  # [B,S,M]
    else:
        z_bar = torch.mean(h32, dim=-2)                           # [B,D]
        draw = proposal.sample(state, noise.sequence_keys(keys, s), z_bar,
                               m)                                 # [B,M]
    return _masked_mean(sampled_ce_unfused(
        cfg, h32, class_embeddings(cfg, params), None, draw.log_q, draw.ids,
        labels), mask)


def proposal_decode_head(cfg: ModelConfig, params: dict, proposal, state,
                         hidden: torch.Tensor, keys: torch.Tensor,
                         num_candidates: Optional[int] = None,
                         temperature: Optional[float] = None, *,
                         fused: Optional[bool] = None) -> MidxDecodeOut:
    """midx_decode_head generalised to any proposal: draw candidates from
    q(·|h), rescore exactly, IS-correct, sample. hidden [T, D], keys [T].
    MIDX-backed states keep the dedicated path, on the route `fused`
    picks."""
    idx = _midx_index_of(proposal, state)
    if idx is not None:
        return midx_decode_head(cfg, params, idx, hidden, keys,
                                num_candidates, temperature, fused=fused)
    if num_candidates is None:
        num_candidates = cfg.head.decode_candidates
    if temperature is None:
        temperature = cfg.head.decode_temperature
    h = hidden.float()
    draw = proposal.sample(state, keys, h, num_candidates)          # [T,M]
    corrected = candidate_logits(cfg, params, h, draw.ids, draw.log_q,
                                 temperature)
    return _pick(draw, corrected, keys)
