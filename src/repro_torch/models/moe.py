"""Token-choice top-k MoE with sort-based capacity dispatch (+ shared expert).

Mirrors `src/repro/models/moe.py`: `moe_init` (:17-34), `_capacity`
(:37-39) and `apply_moe` (:156-212), the local path the reference vmaps
over the batch (`model.py:177-182`). Each sequence dispatches alone:
capacity is `capacity(S, E, k, factor)` for its own S tokens, its tokens
compete only with each other, and the aux loss is the batch mean of each
row's.

The sharded dispatch mirrors `set_moe_mesh` / `moe_shard_mode` /
`apply_moe_sharded` / `_local_moe` (:51-153) and the switch at reference
`models/model.py:168-182`: `set_moe_group(model_group, data_group)`
turns it on, and each rank then dispatches its b_loc·S tokens together,
capacity `capacity(b_loc·S, E, k, factor)`, its aux loss the mean over
the data group. So a step with the switch on computes the reference's
sharded function, which equals the per-sequence one only where capacity
is ample (the reference's own test compares at capacity factor 8.0).
Under the model axis (`dist.tensor_parallel`) both paths take the
experts' F split over the model ranks (w_gate / w_up columns, w_down
rows, and the shared expert's gate / up / down alike) and sum the
combined [T, D] token tensor over the model group once, in fp32, after
the combine (the reference psums it in the compute dtype); the combine
weights and the shared-expert gate enter the parallel region so the
router's and the gate's gradients are whole on every rank.

The rows run batched, [B, ...] in every op, with per-row arithmetic only,
so a row's bits do not depend on the other rows' values. Departures, all
exact in value:
  - the dispatch buffer is a gather, not a scatter: slot (e, c) of a row
    reads the c-th selection routed to expert e (in the stable sort's
    order) or a zero row, so no write lands twice (the reference's
    overflow slot e·cap takes every dropped write and is discarded);
  - the combine gathers each token's k expert rows through the inverse
    of the sort and sums them in a fixed order (selection 0, 1, .., k-1)
    in fp32, where the reference scatter-adds them
    (`y.at[sorted_tok].add`): on the card that add is an atomic, whose
    order, and so whose rounding, changes from run to run;
  - a token's k copies are an `expand` of x, so the backward sums them as
    a reduction, not as an atomic index_add.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.dist import tensor_parallel as tp
from repro_torch.models import layers
from repro_torch.models.layers import dense_init

_SHARD_MODE: dict = {"on": False, "data": None}


def set_moe_group(model_group=None, data_group=None, *,
                  on: bool = True) -> None:
    """Turn the sharded dispatch on (reference `set_moe_mesh`): the
    model axis over `model_group` (`dist.tensor_parallel.set_model_group`)
    and the aux loss averaged over `data_group`. `on=False` turns the
    dispatch back to per sequence and leaves the model axis as it is."""
    _SHARD_MODE["on"] = on
    _SHARD_MODE["data"] = data_group if on else None
    if on:
        tp.set_model_group(model_group)


def moe_shard_mode() -> bool:
    return _SHARD_MODE["on"]


@contextlib.contextmanager
def sharded_dispatch(on: bool, data_group=None):
    """The sharded dispatch on (or off) inside the block, the model axis
    left as it is; the mode as it was after."""
    prev = dict(_SHARD_MODE)
    _SHARD_MODE.update(on=on, data=data_group if on else None)
    try:
        yield
    finally:
        _SHARD_MODE.update(prev)


def moe_init(gen: torch.Generator, d_model: int, d_ff: int, num_experts: int,
             shared_d_ff: int = 0, *, device) -> dict:
    """Router and experts; w_gate exists for a gelu MLP too, as in the
    reference."""
    e, d, f = num_experts, d_model, d_ff

    def normal(shape, scale):
        return scale * layers.normal(shape, gen, device)

    p = {"router": dense_init(gen, d, e, scale=0.02, device=device),
         "w_gate": normal((e, d, f), d ** -0.5),
         "w_up": normal((e, d, f), d ** -0.5),
         "w_down": normal((e, f, d), f ** -0.5)}
    if shared_d_ff:
        p["shared"] = {
            "gate": dense_init(gen, d, shared_d_ff, device=device),
            "up": dense_init(gen, d, shared_d_ff, device=device),
            "down": dense_init(gen, shared_d_ff, d, device=device),
            "shared_gate": dense_init(gen, d, 1, device=device)}
    return p


def capacity(t: int, e: int, k: int, factor: float) -> int:
    """Slots per expert for a sequence of t tokens (reference `_capacity`)."""
    c = int(t * k * factor / e) + 1
    return max(4, ((c + 3) // 4) * 4)


class Routing(NamedTuple):
    """One pass's routing, per row b of the batch. Sorted-order fields are
    indexed by position in the stable sort of the row's S·k selections
    (token-major: selection i = token i // k, choice i % k) by expert."""
    probs: torch.Tensor      # [B, S, E] fp32 router softmax
    topw: torch.Tensor       # [B, S, k] renormalised top-k weights
    tope: torch.Tensor       # [B, S, k] chosen experts, by weight descending
    order: torch.Tensor      # [B, S·k] the sort: sorted position -> selection
    starts: torch.Tensor     # [B, E] sorted position of each expert's first
    counts: torch.Tensor     # [B, E] selections routed to each expert
    keep: torch.Tensor       # [B, S·k] sorted order: rank < capacity
    dest: torch.Tensor       # [B, S·k] sorted order: e·cap + rank, or e·cap
    cap: int


def route(p: dict, x: torch.Tensor, *, top_k: int,
          capacity_factor: float) -> Routing:
    """The reference's routing (:162-184) for each row of x [B, S, D]."""
    b, s, _ = x.shape
    e = p["router"].shape[-1]
    probs = torch.softmax(x.float() @ p["router"], dim=-1)       # [B,S,E]
    topw, tope = torch.topk(probs, top_k, dim=-1)
    topw = topw / topw.sum(dim=-1, keepdim=True)
    cap = capacity(s, e, top_k, capacity_factor)
    flat_e = tope.reshape(b, s * top_k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    experts = torch.arange(e, device=x.device).expand(b, e).contiguous()
    starts = torch.searchsorted(sorted_e, experts)               # [B, E]
    counts = torch.searchsorted(sorted_e, experts, right=True) - starts
    rank = (torch.arange(s * top_k, device=x.device)
            - torch.gather(starts, 1, sorted_e))
    keep = rank < cap
    dest = torch.where(keep, sorted_e * cap + rank, e * cap)
    return Routing(probs, topw, tope, order, starts, counts, keep, dest, cap)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, D], idx [B, M] -> x[b, idx[b]] [B, M, D]."""
    b = x.shape[0]
    return x[torch.arange(b, device=x.device)[:, None], idx]


def apply_moe_sharded(p: dict, x: torch.Tensor, *, top_k: int,
                      capacity_factor: float = 1.25, act: str = "silu",
                      d_ff: int | None = None, shared_d_ff: int = 0):
    """x [B, S, D], this rank's rows -> (y [B, S, D], aux scalar): the
    rank's B·S tokens dispatched together (reference `apply_moe_sharded`
    / `_local_moe`), aux averaged over the data group."""
    b, s, d = x.shape
    y, aux = apply_moe(p, x.reshape(1, b * s, d), top_k=top_k,
                       capacity_factor=capacity_factor, act=act, d_ff=d_ff,
                       shared_d_ff=shared_d_ff)
    return y.reshape(b, s, d), tp.mean_over(aux, _SHARD_MODE["data"])


def apply_moe(p: dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, act: str = "silu",
              d_ff: int | None = None, shared_d_ff: int = 0):
    """x [B, S, D] -> (y [B, S, D], aux scalar): each row dispatched alone,
    aux the batch mean of the rows' Switch losses. `d_ff` / `shared_d_ff`,
    the experts' and the shared expert's whole widths, turn on the model
    axis where the model ranks split them."""
    b, s, d = x.shape
    e = p["router"].shape[-1]
    dt = x.dtype
    split = d_ff is not None and tp.splits(d_ff)
    if "shared" in p and split != tp.splits(shared_d_ff):
        raise NotImplementedError(
            f"tp {tp.tp_size()} splits only one of the experts' {d_ff} "
            f"and the shared expert's {shared_d_ff} columns")
    r = route(p, x, top_k=top_k, capacity_factor=capacity_factor)
    xe = tp.region_in(x) if split else x
    cap, n = r.cap, s * top_k

    # Switch-style load-balancing loss, one a row
    me = r.probs.mean(dim=1)                                     # [B, E]
    ce = F.one_hot(r.tope[..., 0], e).float().mean(dim=1)
    aux = torch.mean(e * torch.sum(me * ce, dim=-1))

    # dispatch: slot (e, c) takes sorted position starts[e] + c, if any
    c = torch.arange(cap, device=x.device)
    pos = r.starts[..., None] + c                                # [B, E, cap]
    src = torch.gather(r.order, 1, pos.clamp(max=n - 1).reshape(b, -1))
    src = torch.where((c < r.counts[..., None]).reshape(b, -1), src, n)
    x_sel = xe[:, :, None, :].expand(b, s, top_k, d).reshape(b, n, d)
    x_sel = torch.cat([x_sel, x.new_zeros(b, 1, d)], dim=1)
    h = _rows(x_sel, src).reshape(b, e, cap, d)

    if act == "silu":
        inner = (F.silu(torch.einsum("becd,edf->becf", h,
                                     p["w_gate"].to(dt)))
                 * torch.einsum("becd,edf->becf", h, p["w_up"].to(dt)))
    else:
        inner = F.gelu(torch.einsum("becd,edf->becf", h, p["w_up"].to(dt)),
                       approximate="tanh")
    out = torch.einsum("becf,efd->becd", inner, p["w_down"].to(dt))
    out_flat = torch.cat([out.reshape(b, e * cap, d), out.new_zeros(b, 1, d)],
                         dim=1)

    # combine: selection i reads its expert row through the inverse sort
    dest = torch.empty_like(r.dest).scatter_(1, r.order, r.dest)
    keep = torch.empty_like(r.keep).scatter_(1, r.order, r.keep)
    w = torch.where(keep, r.topw.reshape(b, n), 0.0).reshape(b, s, top_k)
    if split:
        w = tp.region_in(w)
    got = _rows(out_flat, dest).reshape(b, s, top_k, d)
    y = got[:, :, 0].float() * w[..., 0:1]
    for j in range(1, top_k):
        y = y + got[:, :, j].float() * w[..., j:j + 1]

    if "shared" in p:
        sp = p["shared"]
        sh = F.silu(xe @ sp["gate"].to(dt)) * (xe @ sp["up"].to(dt))
        sh = sh @ sp["down"].to(dt)
        sg = torch.sigmoid(x.float() @ sp["shared_gate"])
        y = y + sh.float() * (tp.region_in(sg) if split else sg)
    if split:
        y = tp.sum_ranks(y)
    return y.to(dt), aux
