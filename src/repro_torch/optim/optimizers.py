"""Optimizers built from scratch over the port's params dict: AdamW, SGD.

Mirrors `src/repro/optim/optimizers.py` (`clip_by_global_norm` :34,
`adamw` :43, `sgd` :97). The moments are fp32 whatever the params' dtype,
and AdamW applies the reference's formula, decay inside the step:
    p ← p − lr · (m̂ / (√v̂ + eps) + wd · p)
(`torch.optim.AdamW` decays p before the step, so it does not stand in).
A params tree is a dict whose values are tensors, dicts or lists of them;
`None` leaves (sgd's missing second moment) are skipped.

Departure: `update(grads, state, params)` works in place. It writes the
new values into `params` and the moments and returns those same objects
(with the step counter advanced); `clip_by_global_norm` scales the
gradients in place. So an update holds params, m, v and the gradients plus
one group's temporaries, where a functional update also holds new copies
of the first three. The ops are `torch._foreach_*` over groups of leaves
of at most `GROUP_ELEMS` elements (a larger leaf is a group alone), one
launch per op per group rather than per leaf. Each op rounds once, in the
reference's order, so the bits are those of the functional formula
evaluated leaf by leaf with torch's elementwise ops on the same device:
no `alpha=`, `addcmul` or `addcdiv` forms, which would fuse two roundings.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

GROUP_ELEMS = 1 << 26          # 256 MB of fp32 temporaries a group


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


def _groups(*trees) -> list:
    """The leaves of same-structured trees, cut in tree order into groups
    of at most GROUP_ELEMS elements: [[leaves of tree 0, of tree 1, ...],
    ...]."""
    cols = [tree_leaves(t) for t in trees]
    cuts, n = [0], 0
    for i, leaf in enumerate(cols[0]):
        if i > cuts[-1] and n + leaf.numel() > GROUP_ELEMS:
            cuts.append(i)
            n = 0
        n += leaf.numel()
    cuts.append(len(cols[0]))
    return [[c[a:b] for c in cols] for a, b in zip(cuts, cuts[1:]) if b > a]


def _div(xs: list, s: float) -> list:
    """[x / s] with the rounding of torch's `x / s` on the xs' device: the
    CUDA kernel multiplies by the fp32 reciprocal of a host scalar, the
    CPU kernel divides."""
    if xs[0].is_cuda:
        return torch._foreach_mul(xs, float(_f32(1.0) / _f32(s)))
    return torch._foreach_div(xs, s)


def _write_back(ps: list, p32: list) -> None:
    """Round the fp32 results into params of a narrower dtype."""
    for p, q in zip(ps, p32):
        if q is not p:
            p.copy_(q)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, norm=None):
    """Scale grads in place to a global L2 norm <= max_norm; returns
    (grads, the norm before). `norm`: the global norm where the caller
    computed it (the vocab-parallel step sums its shards' squares)."""
    leaves = tree_leaves(grads)
    if norm is None:
        norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    f32 = [g for g in leaves if g.dtype == torch.float32]
    if f32:
        torch._foreach_mul_(f32, scale)
    for g in leaves:
        if g.dtype != torch.float32:
            g.copy_(g.float() * scale)
    return grads, norm


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
        for gs, ms, vs, ps in _groups(grads, state.mu, state.nu, params):
            gs = [g.float() for g in gs]
            p32 = [p.float() for p in ps]
            t = torch._foreach_mul(gs, 1 - b1)          # m ← b1·m + (1−b1)·g
            torch._foreach_mul_(ms, b1)
            torch._foreach_add_(ms, t)
            t = torch._foreach_mul(gs, 1 - b2)          # v ← b2·v + (1−b2)·g·g
            torch._foreach_mul_(t, gs)
            torch._foreach_mul_(vs, b2)
            torch._foreach_add_(vs, t)
            del t
            delta = _div(ms, b1c)                      # m̂
            den = _div(vs, b2c)                        # v̂, then √v̂ + eps
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            torch._foreach_div_(delta, den)
            den = torch._foreach_mul(p32, weight_decay)
            torch._foreach_add_(delta, den)
            del den
            torch._foreach_mul_(delta, lr_t)
            torch._foreach_sub_(p32, delta)
            _write_back(ps, p32)
        return params, OptState(step, state.mu, state.nu)

    return Optimizer(init, update)


def opt_state_specs(param_specs, params_abs, opt_state_abs, *, dp: int,
                    data_axes=("data",)) -> OptState:
    """The specs of an OptState (reference :79): ZeRO-1 moments, the
    params' specs extended over the data axes (`dist.sharding.
    zero1_specs`); the step replicated; sgd's missing nu passes as None."""
    from repro_torch.dist.sharding import zero1_specs
    z = zero1_specs(param_specs, params_abs, dp=dp, data_axes=data_axes)
    return OptState((), z, z if opt_state_abs.nu is not None else None)


def zero1(opt: Optimizer, data_dims, group) -> Optimizer:
    """ZeRO-1 over the data group `group`: each data rank keeps its slice
    of the moments, cut along `data_dims` (a tree like the params of the
    dimension `zero1_specs` splits over the data axis, or None), updates
    its slice of each param with `opt`'s in-place update on views, and
    all-gathers the updated slices. AdamW is elementwise, so the params
    are the unsharded update's bit for bit. Gradients come whole (the data
    group's mean) and params stay whole on every rank."""
    from repro_torch.dist.collectives import (all_gather_dim, group_rank,
                                              group_size)
    n, r = group_size(group), group_rank(group)

    def cut(x, d):
        if d is None or n == 1:
            return x
        w = x.shape[d] // n
        return x.narrow(d, r * w, w)

    def init(params):
        return opt.init(tree_map(cut, params, data_dims))

    def update(grads, state, params):
        views = tree_map(cut, params, data_dims)
        _, state = opt.update(tree_map(cut, grads, data_dims), state, views)
        if n > 1:
            with torch.no_grad():
                tree_map(lambda p, v, d: None if d is None
                         else p.copy_(all_gather_dim(v, d, group)),
                         params, views, data_dims)
        return params, state

    return Optimizer(init, update)


def sgd(lr, *, momentum: float = 0.9, nesterov: bool = False) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda step: float(_f32(lr)))

    def init(params):
        return OptState(0, _zeros_like_f32(params), None)

    @torch.no_grad()
    def update(grads, state, params):
        step = state.step + 1
        lr_t = lr_fn(step)
        for gs, ms, ps in _groups(grads, state.mu, params):
            gs = [g.float() for g in gs]
            p32 = [p.float() for p in ps]
            torch._foreach_mul_(ms, momentum)           # m ← momentum·m + g
            torch._foreach_add_(ms, gs)
            if nesterov:                                # d = g + momentum·m
                d = torch._foreach_mul(ms, momentum)
                torch._foreach_add_(d, gs)
                torch._foreach_mul_(d, lr_t)
            else:
                d = torch._foreach_mul(ms, lr_t)
            torch._foreach_sub_(p32, d)
            _write_back(ps, p32)
        return params, OptState(step, state.mu, None)

    return Optimizer(init, update)
