"""The Proposal protocol — one interface every sampler contender implements.

Mirrors `src/repro/proposals/base.py`. A proposal is the distribution
Q(i|z) negatives are drawn from in the sampled softmax; train, serve and
the index lifecycle talk to proposals through this one seam:

  init(gen, class_emb, class_freq=None) -> state       (dict of tensors)
  sample(state, keys, z, m)             -> Draw(ids [..., m], log_q [..., m])
  log_prob(state, z, ids)               -> log q(ids | z)
  refresh(state, gen, class_emb)        -> state

`adaptive`: refresh() tracks the moving class table; the train loop
enables the lifecycle only for these. `trainable`: the state carries
gradient-trained leaves (the learnable codebooks of `midx-learnable-*`);
`split_trainable` / `merge_trainable` expose them to the train step, and
`aux_loss(state, keys, z2d, class_emb) -> (loss, metrics)` adds the
L_recon + L_KL objective of paper §6.2.3 (reference `base.py:48-62`).

Departures: where the reference passes a JAX key, `init` and `refresh`
take a `torch.Generator` and `sample` takes `keys [...]`, one counter-hash
stream key per row of z (`core/noise.py`), so a row's draws are a function
of its own key alone. `categorical_draw` is a counter-hash Gumbel-max
(role `noise.ROLE_CATEGORICAL`) where the reference calls
`jax.random.categorical` (it lives in `core.midx`, which the exact MIDX
sampler shares); its log q stays attached to log p, as the reference's
`take_along_axis` does, through the ordered pick `core.midx._PickRows`,
and `take_along` is that pick for any [..., C] table (the contenders'
`log_prob`s).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.core.midx import Draw, categorical_draw, take_along

__all__ = ["Draw", "Proposal", "categorical_draw", "take_along",
           "no_refresh", "emb_refresh", "snapshot"]


@dataclasses.dataclass(frozen=True)
class Proposal:
    """One registered sampled-softmax proposal (see module docstring).

    `aux_loss` and the split/merge pair are set only when `trainable`;
    `aux_loss` is differentiable w.r.t. the trainable leaves of `state`."""
    name: str
    init: Callable[..., Any]
    sample: Callable[..., Draw]
    log_prob: Callable[..., torch.Tensor]
    refresh: Callable[..., Any]
    adaptive: bool = False
    trainable: bool = False
    aux_loss: Optional[Callable] = None
    split_trainable: Optional[Callable] = None
    merge_trainable: Optional[Callable] = None


def snapshot(class_emb: torch.Tensor) -> torch.Tensor:
    """The state's copy of the table: the class table can be the params'
    own tensor, which the optimizer updates in place, and a state holds
    the table it was built from, as the reference's immutable arrays do."""
    return class_emb.detach().clone()


def no_refresh(state, gen, class_emb):
    """Refresh for static proposals: the state does not track the table."""
    return state


def emb_refresh(state, gen, class_emb):
    """Refresh for proposals whose only table-dependence is state['emb']
    (a `snapshot`)."""
    return {**state, "emb": snapshot(class_emb)}
