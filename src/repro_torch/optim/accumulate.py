"""Gradient accumulation over microbatches.

Mirrors `src/repro/optim/accumulate.py` (`accumulate_gradients` :14): the
reference scans the microbatches with `lax.scan`; here a Python loop does,
in the same order and precision: a loss sum and an fp32 gradient sum
that start at zero, each microbatch's values added in turn, then both
multiplied by 1/n.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.optim.optimizers import tree_map


def accumulate_gradients(loss_and_grad_fn: Callable, params, batch: dict, *,
                         num_microbatches: int):
    """batch: a dict of tensors with leading dim B = num_microbatches ·
    micro_b. loss_and_grad_fn(params, microbatch) -> (loss, grads).
    Returns (mean loss, mean grads)."""
    if num_microbatches == 1:
        return loss_and_grad_fn(params, batch)
    for k, x in batch.items():
        if x.shape[0] % num_microbatches:
            raise ValueError(f"batch[{k!r}] has {x.shape[0]} rows, not a "
                             f"multiple of {num_microbatches} microbatches")
    loss_sum = torch.zeros((), dtype=torch.float32)
    grad_sum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
    for i in range(num_microbatches):
        mb = {k: x.reshape(num_microbatches, -1, *x.shape[1:])[i]
              for k, x in batch.items()}
        loss, grads = loss_and_grad_fn(params, mb)
        grad_sum = tree_map(lambda a, g: a + g.float(), grad_sum, grads)
        loss_sum = loss_sum.to(loss.device) + loss
    inv = 1.0 / num_microbatches
    return loss_sum * inv, tree_map(lambda g: g * inv, grad_sum)
