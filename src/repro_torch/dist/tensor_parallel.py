"""The model axis: tensor-parallel layers over a process group (DESIGN §4).

The reference shards a layer's weights with `param_specs`
(`src/repro/dist/sharding.py:70`) and lets the SPMD partitioner insert the
collectives. The port runs one process per shard, so the layers insert
them, Megatron's way, as the specs lay the weights out:
  column-parallel  wq / wk / wv, the MLP's gate / up, the experts'
                   w_gate / w_up: the rank computes its out-feature slice;
  row-parallel     wo, down, w_down: the rank's partial sum, then one
                   all-reduce over the model group (`row_out`);
  vocab-parallel   the top-level embed / head: the rank's rows
                   (`table_rows`, and the heads' vocab-split losses).
A block's parallel region starts with `region_in` (identity forward,
all-reduce backward: `collectives.copy_to_vocab_region`) and ends with
`row_out` (all-reduce forward, identity backward: `collectives.psum`).
A replicated parameter read inside the region on rank-local activations
(the qk-norm scales, the MoE combine weights and shared-expert gate)
enters through `region_in` too, so its gradient is whole and equal on
every model rank.

Every family runs under the model axis; the hybrid's shared block, the
vlm's cross blocks and whisper's encoder and decoder are built of the
same column / row pieces (the vlm's gates multiply an output already
summed, so they stay replicated outside any region).

The switch is `set_model_group(group)` (module state, as the reference's
`models/moe.py::set_moe_mesh` is): with no group, or a group of one rank,
every function here is the identity and the layers run their one-device
code. With it set, the layers expect the params of `dist.sharding.
shard_by_spec(..., param_specs(...))` for this rank. A dimension is split
exactly where the spec rule splits it, when its whole size divides the
degree (`splits`), so each layer decides from the config's whole sizes.

Attention heads (`head_layout`). The name rules split wq's H·hd columns
and wk / wv's KV·hd whenever they divide tp, even where the cut falls
inside a head (llama3.2-1b at tp 16: wk is [2048, 512] for 8 KV heads of
64, a rank holds half a head). The port computes the same function:
  'heads'    H and KV divide tp: the rank's whole heads, attention local;
  'gather'   the columns divide but the heads do not: the rank's q / k / v
             columns are all-gathered to whole heads over the model group
             (`gather_region`, whose backward sums and slices), qk-norm and
             RoPE then run on whole heads, the attention runs whole on
             every rank, and each rank feeds its own columns of the output
             to its rows of wo;
  'replicated' nothing splits (tp 1, or no column count divides).
A degree at which only one of H·hd and KV·hd divides (no config of
`configs/` at tp 1, 2 or 16) is refused. Cross-attention (the vlm's cross
blocks, whisper's decoder) takes the same layouts, q from the block's
input and k / v from the media, each entering the region on its own.

Mamba2 (`mamba_layout`). The name rules split z_proj / x_proj / conv_x /
conv_x_b / norm_scale over d_inner, dt_proj over the heads and out_proj's
rows; B / C (b_proj, c_proj, conv_b, conv_c) and a_log / dt_bias /
d_skip replicate:
  'heads'      d_inner and H divide tp: the rank scans its H / tp heads;
               every rank computes B and C whole and reads them through
               `region_in` (their gradient is each rank's heads' part),
               takes its heads of a_log / dt_bias / d_skip after
               `region_in`, and sums the gated norm's squares over the
               ranks (`sum_shares`) before dividing by the whole d_inner;
  'replicated' nothing splits.
A degree that splits d_inner but not H (the reduced mamba2's 8 heads at
tp 16; no config of `configs/` at tp 2 or 16) is refused.
Row-parallel partial products are the compute dtype's (a bf16 GEMM at
bf16), their sum over the ranks runs in fp32 and rounds once to the
compute dtype (a departure for bf16, where the reference sums in bf16).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives as coll

_STATE: dict = {"group": None}


def set_model_group(group) -> None:
    """Turn the model axis on over `group` (None: off)."""
    _STATE["group"] = group


def model_group():
    return _STATE["group"]


@contextlib.contextmanager
def model_axis(group):
    """The model axis over `group` inside the block, as it was after."""
    prev = _STATE["group"]
    _STATE["group"] = group
    try:
        yield
    finally:
        _STATE["group"] = prev


def tp_size() -> int:
    g = _STATE["group"]
    return 1 if g is None else coll.group_size(g)


def tp_rank() -> int:
    g = _STATE["group"]
    return 0 if g is None else coll.group_rank(g)


def splits(full: int) -> bool:
    """Whether a dimension of whole size `full` is split over the model
    ranks (the spec rule: it divides the degree)."""
    n = tp_size()
    return n > 1 and full > 0 and full % n == 0


def region_in(x: torch.Tensor) -> torch.Tensor:
    """Entry of a parallel region: x forward, the ranks' gradients summed."""
    if tp_size() == 1:
        return x
    return coll.copy_to_vocab_region(x, _STATE["group"])


def sum_ranks(x: torch.Tensor) -> torch.Tensor:
    """x summed over the model ranks (all-reduce forward, identity
    backward: `collectives.psum`)."""
    return coll.psum(x, _STATE["group"])


def sum_shares(x: torch.Tensor) -> torch.Tensor:
    """x summed over the model ranks where each rank reads the sum on its
    own columns (all-reduce forward and backward: `collectives.
    psum_shared`)."""
    return coll.psum_shared(x, _STATE["group"])


def gather_cols(x: torch.Tensor) -> torch.Tensor:
    """The ranks' column slices of x gathered whole; the backward hands
    each rank its slice of the summed gradient (`collectives.
    gather_region`)."""
    return coll.gather_region(x, -1, _STATE["group"])


def row_out(a: torch.Tensor, w: torch.Tensor, dt: torch.dtype
            ) -> torch.Tensor:
    """a @ w for a row-parallel w: the rank's partial product in `dt` (the
    product tp 1 computes, on the rank's rows), summed over the model
    ranks in fp32, in `dt`."""
    part = a @ w.to(dt)
    if dt == torch.float32:
        return sum_ranks(part)
    return sum_ranks(part.float()).to(dt)


def own_slice(x: torch.Tensor, full: int, dim: int = -1) -> torch.Tensor:
    """This rank's contiguous 1/tp of x's `dim` (of whole size `full`)."""
    w = full // tp_size()
    return x.narrow(dim, tp_rank() * w, w)


def head_layout(num_heads: int, num_kv_heads: int, head_dim: int) -> str:
    """'replicated' | 'heads' | 'gather' (module docstring)."""
    n = tp_size()
    q_split = splits(num_heads * head_dim)
    kv_split = splits(num_kv_heads * head_dim)
    if not q_split and not kv_split:
        return "replicated"
    if q_split != kv_split:
        raise NotImplementedError(
            f"tp {n} splits only one of wq's {num_heads * head_dim} and "
            f"wk / wv's {num_kv_heads * head_dim} columns")
    if num_heads % n == 0 and num_kv_heads % n == 0:
        return "heads"
    return "gather"


def mamba_layout(d_inner: int, num_heads: int) -> str:
    """'replicated' | 'heads': how the model ranks split a mamba2 block
    (module docstring)."""
    if not splits(d_inner):
        return "replicated"
    if num_heads % tp_size():
        raise NotImplementedError(
            f"tp {tp_size()} splits mamba2's d_inner {d_inner} but not its "
            f"{num_heads} heads")
    return "heads"


def local_kv_heads(num_heads: int, num_kv_heads: int, head_dim: int) -> int:
    """KV heads a rank's cache holds: KV / tp under the 'heads' layout,
    else all of them."""
    if head_layout(num_heads, num_kv_heads, head_dim) == "heads":
        return num_kv_heads // tp_size()
    return num_kv_heads


def seq_sharded_cache(num_kv_heads: int, max_seq: int) -> bool:
    """Whether a slot-major decode cache splits its sequence dimension
    over the model ranks (`decode_cache_specs`: KV heads that do not
    divide tp, a sequence that does)."""
    n = tp_size()
    return n > 1 and num_kv_heads % n != 0 and max_seq % n == 0


def table_rows(table: torch.Tensor, ids: torch.Tensor,
               padded_vocab: int) -> torch.Tensor:
    """table[ids] for a class table whose rows may be split over the
    model ranks: the owner-masked gather and its psum
    (`dist.vocab_parallel.embed_lookup`), in the table's dtype."""
    if not splits(padded_vocab):
        return F.embedding(ids, table)
    from repro_torch.dist.vocab_parallel import embed_lookup
    return embed_lookup(table, ids, _STATE["group"])


def gather_logits(logits: torch.Tensor, padded_vocab: int) -> torch.Tensor:
    """Vocab-split logits [..., Vpad / tp] gathered to [..., Vpad]
    (detached: the serving heads read them)."""
    if not splits(padded_vocab):
        return logits
    return coll.all_gather_dim(logits, -1, _STATE["group"])


def mean_over(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of x over `group` in value, x's own gradient in the
    backward (the data-parallel step averages the ranks' gradients
    afterwards, so the mean's 1/n is applied once)."""
    if group is None or coll.group_size(group) == 1:
        return x
    m = coll.psum_no_grad(x, group) / coll.group_size(group)
    return x + (m - x).detach()
