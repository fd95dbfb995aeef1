"""The Proposal protocol — one interface every sampler contender implements.

Mirrors `src/repro/proposals/base.py`. A proposal is the distribution
Q(i|z) negatives are drawn from in the sampled softmax; train, serve and
the index lifecycle talk to proposals through this one seam:

  init(gen, class_emb, class_freq=None) -> state       (dict of tensors)
  sample(state, keys, z, m)             -> Draw(ids [..., m], log_q [..., m])
  log_prob(state, z, ids)               -> log q(ids | z)
  refresh(state, gen, class_emb)        -> state

`adaptive`: refresh() tracks the moving class table; the train loop
enables the lifecycle only for these. The `trainable` capability of the
reference (learnable codebooks, `aux_loss`, split/merge) belongs to the
unported `midx-learnable-*` contenders and is not carried here.

Departures: where the reference passes a JAX key, `init` and `refresh`
take a `torch.Generator` and `sample` takes `keys [...]`, one counter-hash
stream key per row of z (`core/noise.py`), so a row's draws are a function
of its own key alone. `categorical_draw` is a counter-hash Gumbel-max
(role `noise.ROLE_CATEGORICAL`) where the reference calls
`jax.random.categorical`; its log q stays attached to log p, as the
reference's `take_along_axis` does, through the ordered pick
`core.midx._PickRows`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core import noise
from repro_torch.core.midx import Draw, _PickRows

__all__ = ["Draw", "Proposal", "categorical_draw", "no_refresh",
           "emb_refresh"]


@dataclasses.dataclass(frozen=True)
class Proposal:
    """One registered sampled-softmax proposal (see module docstring)."""
    name: str
    init: Callable[..., Any]
    sample: Callable[..., Draw]
    log_prob: Callable[..., torch.Tensor]
    refresh: Callable[..., Any]
    adaptive: bool = False


def categorical_draw(keys: torch.Tensor, log_p: torch.Tensor,
                     m: int) -> Draw:
    """m iid categorical draws per row of log_p [..., N], row r keyed by
    keys[r] -> Draw [..., m] (int64 ids, log q = log p at each id)."""
    lead, n = log_p.shape[:-1], log_p.shape[-1]
    flat = log_p.reshape(-1, n)
    ids = noise.gumbel_max_draws(flat.detach(), keys.reshape(-1),
                                 noise.ROLE_CATEGORICAL, m)
    log_q = _PickRows.apply(flat, ids)
    return Draw(ids.reshape(*lead, m), log_q.reshape(*lead, m))


def no_refresh(state, gen, class_emb):
    """Refresh for static proposals: the state does not track the table."""
    return state


def emb_refresh(state, gen, class_emb):
    """Refresh for proposals whose only table-dependence is state['emb']:
    a copy, since the table can be the params' tensor the optimizer
    updates in place."""
    return {**state, "emb": class_emb.detach().clone()}
