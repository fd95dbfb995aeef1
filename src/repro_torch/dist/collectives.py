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
  psum_shared(x)
               forward all-reduce SUM; backward all-reduce SUM — for a sum
               that every rank then reads on its own slice of a split
               tensor (the gated norm's mean square over mamba2's split
               d_inner), each rank's gradient of it only its slice's part.
  copy_to_vocab_region(x)
               Megatron's copy region for a replicated input of the
               rank-local head (the hidden state): identity forward,
               all-reduce SUM backward, since each rank's head computes
               only its own shard's part of d(loss)/dx.
  pmax(x), psum_no_grad(x)
               no gradient (the merge's detached shift; integer counts,
               the member ids, norms).

Every collective is an `all_reduce` (SUM or MAX) or an `all_gather` of
raw bytes, the two that NCCL and gloo both run on CUDA tensors. There is
no reduce-scatter (gloo has none for CUDA tensors): a gradient is reduced
whole. A group of one
rank (or no initialised process group) makes every collective the
identity. The model axis (`dist.tensor_parallel`) adds the gather along
a dimension `gather_region`, whose backward sums the ranks' gradients
(an all-reduce) and hands each its slice, a reduce-scatter's result.

`counting()` notes every collective of two or more ranks (its kind, group
size and buffer bytes); a `RecordingGroup` is a group that moves nothing,
over which the dry run's plan runs one rank's program on the meta device,
so the plan's schedule and the ranks' counted one come from the same code.

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

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.optim.optimizers import tree_leaves, tree_map

#: the most bytes one all-reduce of a bucketed transport carries
BUCKET_BYTES = 1 << 28


@dataclasses.dataclass(frozen=True)
class RecordingGroup:
    """A process group that moves nothing: a collective over it returns
    its input (a gather, the input in every slot) and is noted in the
    active `counting()` log with this group's `axis` name. The meta-device
    plan (`launch.dryrun`) runs one rank's program over such groups, so
    the schedule it reads is the one the real ranks run."""
    size: int
    rank: int = 0
    axis: str = "model"


def group_size(group=None) -> int:
    if isinstance(group, RecordingGroup):
        return group.size
    if not dist.is_available() or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def group_rank(group=None) -> int:
    if isinstance(group, RecordingGroup):
        return group.rank
    if not dist.is_available() or not dist.is_initialized():
        return 0
    return dist.get_rank(group)


# ------------------------------------------------------ counting collectives
_LOG: dict = {"events": None}


@dataclasses.dataclass(frozen=True)
class CollectiveEvent:
    """One collective: its kind ('all-reduce' or 'all-gather'), the size
    of its group, the bytes of its buffer (an all-gather's: the gathered
    result) and the axis of a `RecordingGroup` (None for a real group)."""
    kind: str
    group_size: int
    nbytes: int
    axis: Optional[str] = None

    @property
    def ring_bytes(self) -> float:
        """Bytes one rank sends in the ring algorithm: 2 (n - 1) / n of an
        all-reduce's buffer, (n - 1) / n of an all-gather's result."""
        n = self.group_size
        hops = 2.0 if self.kind == "all-reduce" else 1.0
        return hops * self.nbytes * (n - 1) / n


@contextlib.contextmanager
def counting():
    """Note every collective of a group of two or more ranks made inside
    the block into the yielded list of `CollectiveEvent`s (nests: an
    inner block's events reach the outer list too)."""
    outer = _LOG["events"]
    events: list = []
    _LOG["events"] = events
    try:
        yield events
    finally:
        _LOG["events"] = outer
        if outer is not None:
            outer.extend(events)


def _note(kind: str, nbytes: int, group) -> None:
    if _LOG["events"] is not None:
        _LOG["events"].append(CollectiveEvent(
            kind, group_size(group), int(nbytes),
            group.axis if isinstance(group, RecordingGroup) else None))


def summarize(events: list) -> dict:
    """{kind: {"count", "bytes", "ring_bytes"}} over `events`."""
    out: dict = {}
    for e in events:
        k = out.setdefault(e.kind, {"count": 0, "bytes": 0,
                                    "ring_bytes": 0.0})
        k["count"] += 1
        k["bytes"] += e.nbytes
        k["ring_bytes"] += e.ring_bytes
    return out


def _reduce_(buf: torch.Tensor, op, group) -> None:
    """All-reduce `buf` in place over `group` (noted; a recording group
    leaves it as it is)."""
    _note("all-reduce", buf.numel() * buf.element_size(), group)
    if not isinstance(group, RecordingGroup):
        dist.all_reduce(buf, op=op, group=group)


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    """A reduced copy of x (x itself is left as it was)."""
    out = x.detach().clone().contiguous()
    if group_size(group) > 1:
        _reduce_(out, op, group)
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PsumShared(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, dist.ReduceOp.SUM, ctx.group), None


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


def psum_shared(x: torch.Tensor, group=None) -> torch.Tensor:
    """Σ over ranks of x where each rank reads the sum on its own part of
    a split tensor (a normaliser over split columns): the backward sums
    the ranks' gradients of the sum too, since each holds only its part's
    share of d(loss)/d(sum)."""
    return _PsumShared.apply(x, group)


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
    """[n, *x.shape]: rank r's x in slot r, detached — an all-gather of
    x's raw bytes, so each value arrives bit for bit (a −0.0 stays −0.0),
    whatever its dtype."""
    n = group_size(group)
    src = x.detach().contiguous()
    if n == 1:
        return src.clone()[None]
    _note("all-gather", n * src.numel() * src.element_size(), group)
    if isinstance(group, RecordingGroup):
        return src[None].expand(n, *src.shape).clone()
    raw = src.reshape(-1).view(torch.uint8)
    buf = raw.new_empty((n, raw.numel()))
    dist.all_gather(list(buf.unbind(0)), raw, group=group)
    return buf.view(src.dtype).reshape(n, *src.shape)


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """A row-sharded array back in its global row order (reference
    `all_gather_rows` :73): the ranks' [rows, ...] concatenated."""
    return all_gather_stack(x, group).reshape(-1, *x.shape[1:])


def all_gather_dim(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The ranks' x concatenated along `dim` in rank order, detached and
    bit for bit (the inverse of cutting `dim` into equal contiguous
    slices)."""
    dim = dim % x.dim()
    st = all_gather_stack(x, group)                     # [n, *x.shape]
    return torch.movedim(st, 0, dim).reshape(
        *x.shape[:dim], -1, *x.shape[dim + 1:])


class _GatherRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.width = dim, group, x.shape[dim]
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, dist.ReduceOp.SUM, ctx.group)
        r, w = group_rank(ctx.group), ctx.width
        return g.narrow(ctx.dim, r * w, w), None, None


def gather_region(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """x's slices gathered along `dim` into the whole tensor, where what
    follows on each rank uses only part of it: the backward sums the
    ranks' gradients of the whole tensor and hands each rank its slice
    (Megatron's all-gather, whose transpose is a reduce-scatter: here an
    all-reduce, then the rank's slice)."""
    return _GatherRegion.apply(x, dim, group)


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
                _reduce_(flat, op, group)
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
