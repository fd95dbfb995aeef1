"""Which rows of the class tables each vocab-parallel rank owns, and
which rows of a batch each data-parallel rank trains on.

Mirrors the runtime part of `src/repro/dist/sharding.py`: `batch_spec`
(:123), `refresh_table_spec` (:144), `refresh_rows_per_shard` (:160), `head_table_spec` (:169),
`head_scale_spec` (:185), `quant_head_specs` (:195), `vocab_param_specs`
(:210) and `vocab_index_specs` (:228). Where the reference writes
PartitionSpecs that `shard_map` slices by, the port cuts a replicated tree
into rank r's rows (`shard_params`, `shard_rows`) and gathers it back
(`gather_params`); the index's own layout is `dist.vocab_parallel`'s
(`shard_index` / `local_index`). Rank r of n owns the contiguous rows
[r·rows, (r+1)·rows) of the padded vocabulary: the top-level class tables
(`embed`, and `head` where the embeddings are untied) with their per-row
quantization scales and codes, and everything else replicates. Data rank
d of dp trains on the contiguous batch rows [d·B/dp, (d+1)·B/dp)
(`data_rows`), as `batch_spec` splits the batch's leading dim; a batch that dp does not divide is refused with the reference CLI's
message (`launch/train.py:150`) rather than replicated. `param_specs`,
`zero1_specs` / `opt_state_specs` and `decode_cache_specs` reach only the
reference's compile-only dry run (`launch/dryrun.py`) and are not ported
(ROADMAP.md Queue 1, the dry-run item).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.dist.collectives import all_gather_rows
from repro_torch.optim.optimizers import OptState

# top-level params that row-shard over the vocab ranks (reference
# `_VOCAB_PARALLEL`)
VOCAB_PARALLEL = ("embed", "head")


def head_rows_per_shard(padded_vocab: int, vp: int) -> int:
    """Rows of the [Vpad, D] class table each of `vp` ranks owns. The loss
    and the index own contiguous row ranges, so the padded vocab must
    divide: raise `vocab_pad_multiple` to a multiple of vp (reference
    `head_table_spec`, whose per-row scales shard alike, `head_scale_spec`)."""
    if vp < 1:
        raise ValueError(f"--vocab-parallel must be >= 1, got {vp}")
    if padded_vocab % vp:
        raise ValueError(
            f"padded_vocab {padded_vocab} must divide --vocab-parallel {vp}; "
            f"raise cfg.vocab_pad_multiple to a multiple of {vp}")
    return padded_vocab // vp


def refresh_rows_per_shard(padded_vocab: int, dp: int) -> int:
    """Rows each shard owns in a data-sharded refresh: the ceiling, the
    last shard's tail rows pad-and-masked."""
    return -(-padded_vocab // max(dp, 1))


def data_rows(batch_size: int, dp: int, rank: int) -> slice:
    """Data rank `rank`'s contiguous rows of a [B, ...] batch."""
    if dp < 1:
        raise ValueError(f"--dp must be >= 1, got {dp}")
    if batch_size % dp:
        raise ValueError(f"--batch {batch_size} must be divisible by the "
                         f"data-parallel degree {dp}")
    rows = batch_size // dp
    return slice(rank * rows, (rank + 1) * rows)


def vocab_param_names(params: dict) -> tuple:
    """The top-level leaves that row-shard: `embed` / `head`, 2-D."""
    return tuple(k for k in VOCAB_PARALLEL
                 if k in params and torch.is_tensor(params[k])
                 and params[k].dim() == 2)


def shard_rows(x: torch.Tensor, vp: int, rank: int) -> torch.Tensor:
    """Rank `rank`'s contiguous rows of x [Vpad, ...] (a copy): a class
    table, its [Vpad, 1] scales or its [Vpad, n_sub] codes."""
    rows = head_rows_per_shard(x.shape[0], vp)
    return x[rank * rows:(rank + 1) * rows].clone()


def _map_vocab(params: dict, fn: Callable) -> dict:
    names = vocab_param_names(params)
    return {k: (fn(v) if k in names else v) for k, v in params.items()}


def shard_params(params: dict, vp: int, rank: int) -> dict:
    """The params tree rank `rank` trains: its rows of the class tables,
    every other leaf as it is (shared, not copied)."""
    return _map_vocab(params, lambda v: shard_rows(v, vp, rank))


def gather_params(params: dict, group=None) -> dict:
    """The replicated params tree from every rank's shard (collective):
    each class table's rows gathered in rank order, bit for bit."""
    return _map_vocab(params, lambda v: all_gather_rows(v, group))


def map_opt_state(opt_state: Any, fn: Callable) -> Any:
    """An `OptState` whose moment trees have `fn` applied (moments mirror
    the params: shard or gather them with the params' functions)."""
    return OptState(opt_state.step,
                    None if opt_state.mu is None else fn(opt_state.mu),
                    None if opt_state.nu is None else fn(opt_state.nu))
