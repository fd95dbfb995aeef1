"""Optimizers built from scratch over the port's params dict: AdamW, SGD.

Mirrors `src/repro/optim/optimizers.py` (`clip_by_global_norm` :34,
`adamw` :43, `sgd` :97). Functional, like the reference: `update(grads,
state, params)` returns new params and a new state and leaves its inputs
alone. The moments are fp32 whatever the params' dtype, and AdamW applies
the reference's formula, decay inside the step:
    p ← p − lr · (m̂ / (√v̂ + eps) + wd · p)
(`torch.optim.AdamW` decays p before the step, so it does not stand in).
A params tree is a dict whose values are tensors, dicts or lists of them;
`None` leaves (sgd's missing second moment) are skipped.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch


class OptState(NamedTuple):
    step: int        # updates applied so far
    mu: Any          # first moment (tree of fp32 tensors)
    nu: Any          # second moment (tree of fp32 tensors); None for sgd


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], OptState]
    update: Callable[[Any, OptState, Any], tuple[Any, OptState]]


def tree_map(fn, tree, *rest):
    """fn over the tensor leaves of dict/list trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def _zeros_like_f32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global L2 norm <= max_norm, the norm before)."""
    leaves = tree_leaves(grads)
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def _pick(out, i: int):
    """Element i of every tuple leaf of a tree of tuples."""
    if isinstance(out, dict):
        return {k: _pick(v, i) for k, v in out.items()}
    if isinstance(out, list):
        return [_pick(v, i) for v in out]
    return None if out is None else out[i]


def adamw(lr, *, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    """`lr` is a float or a schedule step -> lr (see `optim.schedule`)."""
    lr_fn = lr if callable(lr) else (lambda step: float(_f32(lr)))

    def init(params):
        return OptState(0, _zeros_like_f32(params), _zeros_like_f32(params))

    @torch.no_grad()
    def update(grads, state, params):
        step = state.step + 1
        lr_t = lr_fn(step)
        b1c = float(1.0 - _f32(b1) ** _f32(step))
        b2c = float(1.0 - _f32(b2) ** _f32(step))

        def upd(g, m, v, p):
            g = g.float()
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mh = m / b1c
            vh = v / b2c
            delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
            return (p.float() - lr_t * delta).to(p.dtype), m, v

        out = tree_map(upd, grads, state.mu, state.nu, params)
        new_params, mu, nu = (_pick(out, i) for i in range(3))
        return new_params, OptState(step, mu, nu)

    return Optimizer(init, update)


def sgd(lr, *, momentum: float = 0.9, nesterov: bool = False) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda step: float(_f32(lr)))

    def init(params):
        return OptState(0, _zeros_like_f32(params), None)

    @torch.no_grad()
    def update(grads, state, params):
        step = state.step + 1
        lr_t = lr_fn(step)

        def upd(g, m, p):
            g = g.float()
            m = momentum * m + g
            d = g + momentum * m if nesterov else m
            return (p.float() - lr_t * d).to(p.dtype), m

        out = tree_map(upd, grads, state.mu, params)
        new_params, mu = (_pick(out, i) for i in range(2))
        return new_params, OptState(step, mu, None)

    return Optimizer(init, update)
