"""Decode heads: the MIDX sampling head and its index state.

Mirrors `src/repro/models/heads.py`: `init_head_state` (:39, the bf16 table
path only — int8/fp8 tables are a later slice) and `midx_decode_head`
(:316, the unquantized branch). Draw `num_candidates` classes through the
two-stage MIDX proposal, rescore them exactly against the class table,
IS-correct (logit − log q) and sample one — O(K·M + M·D) per row, no [T, V]
logits matrix.

Departures:
  - batched over slots: the reference engine vmaps a one-row head per slot
    (`serve/engine.py:139-142`); here one call takes all T = max_slots
    rows, so one midx_probs launch serves a whole decode wave;
  - randomness is counter-based noise keyed per row (`core/noise.py`), so
    a slot's draw is a function of its own (seed, rid, pos) and never of
    the batch it rides in;
  - the proposal tables always come through `proposal_tables` and
    `kernels.dispatch` (the CUDA kernel on the card, the plain version on
    the CPU); there is no `fused`/`interpret` switch.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import midx as midx_mod
from repro_torch.core import noise
from repro_torch.index.build import MultiIndex, build
from repro_torch.kernels.midx_probs.ops import proposal_tables
from repro_torch.models.model import class_embeddings


def init_head_state(cfg: ModelConfig, params: dict,
                    gen: torch.Generator) -> MultiIndex:
    """Build the inverted multi-index over the class-embedding table."""
    if cfg.head.table_dtype != "bf16":
        raise NotImplementedError(
            f"table_dtype={cfg.head.table_dtype!r}: the quantized hot path "
            "is not ported yet (ROADMAP.md Queue 1 item 8)")
    table = class_embeddings(cfg, params).float()
    return build(gen, table, kind=cfg.head.quantizer, k=cfg.head.midx_k,
                 iters=cfg.head.kmeans_iters, keep_residuals=False)


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


def midx_decode_head(cfg: ModelConfig, params: dict, index: MultiIndex,
                     hidden: torch.Tensor, keys: torch.Tensor,
                     num_candidates: Optional[int] = None,
                     temperature: Optional[float] = None) -> MidxDecodeOut:
    """Next-token sampling for T rows at once. hidden [T, D]; keys [T] the
    rows' stream keys (`noise.row_keys(seed, rid, pos)`).

    `num_candidates` / `temperature` default to `cfg.head.decode_candidates`
    / `cfg.head.decode_temperature`."""
    if num_candidates is None:
        num_candidates = cfg.head.decode_candidates
    if temperature is None:
        temperature = cfg.head.decode_temperature
    h = hidden.float()
    draw = midx_mod.sample_twostage(index, h, num_candidates, keys,
                                    tables_fn=proposal_tables)      # [T,M]
    corrected = candidate_logits(cfg, params, h, draw.ids, draw.log_q,
                                 temperature)
    col = torch.arange(num_candidates, device=h.device)
    g = noise.gumbel_noise(keys[:, None], noise.ROLE_PICK, 0, col)   # [T,M]
    pick = torch.argmax(corrected + g, dim=-1, keepdim=True)         # [T,1]
    return MidxDecodeOut(torch.gather(draw.ids, 1, pick)[:, 0],
                         torch.gather(draw.log_q, 1, pick)[:, 0])
