"""The collectives of the vocab-parallel head and of data-parallel
training, over a process group.

Mirrors `src/repro/dist/collectives.py` (`psum_bf16` :38, `psum_int8_ef`
:49, `all_gather_rows` :73) and the parts of `jax.lax` (`psum`, `pmax`,
`pmean`, `all_gather`, and the transpose rules `shard_map` applies) that
`dist.vocab_parallel` and the data-parallel step
(`launch.steps.make_sharded_train_step`) use. Every rank of a vocab group
runs the same program on the same replicated inputs and holds the same
loss; what differs is the rows of the class table it owns. The ranks of a
data group hold different rows of the batch, and their gradients meet in
one of the three transports: `pmean` (fp32), `psum_bf16` and
`psum_int8_ef`.

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

The gradient transports work on trees (dicts and lists of tensors, as
`optim.optimizers.tree_map` walks them) and reduce them in buckets: the
leaves of one dtype are packed into flat buffers of at most
`BUCKET_BYTES`, one all-reduce each, since gloo with CUDA tensors stages
every call through the host. The arithmetic stays per leaf (the int8
transport's scale is a leaf's own). Departure: a leaf whose local |c| max
is NaN enters the int8 scale's MAX as +inf, so the scale is +inf on every
rank whatever order the backend's MAX takes NaN in, and the summed leaf is
non-finite on every rank; the reference's XLA max propagates the NaN to
the same end (the step's guard skips).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.optim.optimizers import tree_leaves, tree_map

#: the most bytes one all-reduce of a bucketed transport carries
BUCKET_BYTES = 1 << 28


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


# ------------------------------------------------------ gradient transports
def _all_reduce_leaves(xs: list, op, group) -> list:
    """Each tensor of `xs` reduced over the group (new tensors; `xs` are
    left as they were), in buckets of one dtype and device of at most
    BUCKET_BYTES, one all-reduce a bucket."""
    if group_size(group) == 1:
        return [x.detach().clone() for x in xs]
    out: list = [None] * len(xs)
    by_kind: dict = {}
    for i, x in enumerate(xs):
        by_kind.setdefault((x.dtype, x.device), []).append(i)
    for ids in by_kind.values():
        bucket, nbytes = [], 0
        for i in ids + [None]:
            size = 0 if i is None else xs[i].numel() * xs[i].element_size()
            if bucket and (i is None or nbytes + size > BUCKET_BYTES):
                flat = torch.cat([xs[j].detach().reshape(-1) for j in bucket])
                dist.all_reduce(flat, op=op, group=group)
                for j, piece in zip(bucket, torch.split(
                        flat, [xs[j].numel() for j in bucket])):
                    out[j] = piece.view(xs[j].shape)
                bucket, nbytes = [], 0
            if i is not None:
                bucket.append(i)
                nbytes += size
    return out


def _rebuild(tree, flat: list):
    it = iter(flat)
    return tree_map(lambda _: next(it), tree)


def pmean(tree, group=None):
    """The mean over ranks of every leaf (reference `lax.pmean`): the
    all-reduce SUM divided by the group's size."""
    n = group_size(group)
    leaves = tree_leaves(tree)
    return _rebuild(tree, [x / n for x in _all_reduce_leaves(
        leaves, dist.ReduceOp.SUM, group)])


def psum_bf16(tree, group=None):
    """Every leaf summed over ranks in bf16, back in its own dtype
    (reference :38): half the wire bytes of fp32; the caller divides by
    the data degree."""
    leaves = tree_leaves(tree)
    summed = _all_reduce_leaves([g.to(torch.bfloat16) for g in leaves],
                                dist.ReduceOp.SUM, group)
    return _rebuild(tree, [s.to(g.dtype) for s, g in zip(summed, leaves)])


def psum_int8_ef(tree, error_feedback, group=None):
    """The error-feedback int8 all-reduce (reference :49). Per leaf:
    c = g + ef; the scale max(|c|) over every rank (MAX) / 127, floored at
    1e-30 / 127; q = clip(round(c / scale), ±127) (round half to even);
    the new ef = c − q·scale; q summed as int32 (an int8 SUM would wrap),
    times the scale. -> (summed tree in the leaves' dtypes, new ef tree,
    fp32). `error_feedback` is `launch.steps.init_grad_transport_state`'s
    zeros at the start. The leaves' maxima travel in one MAX all-reduce."""
    gs, es = tree_leaves(tree), tree_leaves(error_feedback)
    cs = [g.detach().float() + e.float() for g, e in zip(gs, es)]
    amax = torch.stack([torch.amax(torch.abs(c)) if c.numel()
                        else c.new_zeros(()) for c in cs])
    amax = pmax(torch.nan_to_num(amax, nan=float("inf")), group)
    scales = torch.clamp(amax, min=1e-30) / 127.0
    qs = [torch.clamp(torch.round(c / s), -127, 127)
          for c, s in zip(cs, scales)]
    new_ef = [c - q * s for c, q, s in zip(cs, qs, scales)]
    totals = _all_reduce_leaves([q.to(torch.int32) for q in qs],
                                dist.ReduceOp.SUM, group)
    summed = [(t.float() * s).to(g.dtype)
              for t, s, g in zip(totals, scales, gs)]
    return _rebuild(tree, summed), _rebuild(error_feedback, new_ef)
