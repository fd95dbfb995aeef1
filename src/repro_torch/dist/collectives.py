"""The collectives of the vocab-parallel head, over a process group.

Mirrors the parts of `src/repro/dist/collectives.py` (`all_gather_rows`
:73) and of `jax.lax` (`psum`, `pmax`, `all_gather`, and the transpose
rules `shard_map` applies) that `dist.vocab_parallel` uses. Every rank of
the group runs the same program on the same replicated inputs and holds
the same loss; what differs is the rows of the class table it owns.

Gradients. Each rank differentiates its own copy of the (identical) loss,
so a collective's backward must hand each rank exactly the gradient of
its OWN inputs:
  psum(x)      forward all-reduce SUM; backward identity — the output's
               gradient is the same on every rank (the loss downstream is
               replicated), and d(Σ_r x_r)/d x_r = 1. (torch.distributed.
               nn.functional.all_reduce would all-reduce the gradient again
               and give n times it.) The reference reaches the same values
               with psum's transpose followed by a 1/n or a pmean
               (`launch/steps.py:321-329`).
  copy_to_vocab_region(x)
               Megatron's copy region for a replicated input of the
               rank-local head (the hidden state): identity forward,
               all-reduce SUM backward, since each rank's head computes
               only its own shard's part of d(loss)/dx.
  pmax(x), psum_no_grad(x)
               no gradient (the merge's detached shift; integer counts,
               the member ids, norms).

Every collective is an `all_reduce` (SUM or MAX): an all-gather is the
all-reduce of a zeroed buffer in which each rank fills its own slot. So
the code runs on NCCL and on gloo with CUDA tensors alike. A group of one
rank (or no initialised process group) makes every collective the
identity.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group=None) -> int:
    if not dist.is_available() or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def group_rank(group=None) -> int:
    if not dist.is_available() or not dist.is_initialized():
        return 0
    return dist.get_rank(group)


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    """A reduced copy of x (x itself is left as it was)."""
    out = x.detach().clone().contiguous()
    if group_size(group) > 1:
        dist.all_reduce(out, op=op, group=group)
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, dist.ReduceOp.SUM, ctx.group), None


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Σ over ranks of x; the backward hands each rank the output's
    gradient (a replicated loss downstream)."""
    return _Psum.apply(x, group)


def copy_to_vocab_region(x: torch.Tensor, group=None) -> torch.Tensor:
    """x itself; the backward sums the ranks' gradients of x."""
    return _CopyToRegion.apply(x, group)


def psum_no_grad(x: torch.Tensor, group=None) -> torch.Tensor:
    """Σ over ranks of x, detached (integers, norms)."""
    return _all_reduce(x, dist.ReduceOp.SUM, group)


def pmax(x: torch.Tensor, group=None) -> torch.Tensor:
    """Elementwise max over ranks of x, detached."""
    return _all_reduce(x, dist.ReduceOp.MAX, group)


def all_gather_stack(x: torch.Tensor, group=None) -> torch.Tensor:
    """[n, *x.shape]: rank r's x in slot r, detached — the all-reduce SUM
    of a zeroed byte buffer in which each rank fills its own slot with x's
    raw bytes: every other slot adds zero bytes, so each value arrives bit
    for bit (a −0.0 stays −0.0), whatever its dtype."""
    n, r = group_size(group), group_rank(group)
    src = x.detach().contiguous()
    if n == 1:
        return src.clone()[None]
    raw = src.reshape(-1).view(torch.uint8)
    buf = raw.new_zeros((n, raw.numel()))
    buf[r] = raw
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.view(src.dtype).reshape(n, *src.shape)


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """A row-sharded array back in its global row order (reference
    `all_gather_rows` :73): the ranks' [rows, ...] concatenated."""
    return all_gather_stack(x, group).reshape(-1, *x.shape[1:])
