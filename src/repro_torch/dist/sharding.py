"""Which part of every tree a rank holds: the spec trees of the model and
data axes, the rows of the class tables each vocab-parallel rank owns, and
the rows of a batch each data-parallel rank trains on.

Mirrors `src/repro/dist/sharding.py`: the name rules `_COL_PARALLEL` /
`_ROW_PARALLEL` / `_VOCAB_PARALLEL` (:34-47), `param_specs` (:70),
`zero1_specs` (:94), `batch_spec` (:123), `index_specs` (:134),
`refresh_table_spec` (:144), `refresh_rows_per_shard` (:160),
`head_table_spec` (:169), `head_scale_spec` (:185), `quant_head_specs`
(:195), `vocab_param_specs` (:210), `vocab_index_specs` (:228) and
`decode_cache_specs` (:240). A spec is a tuple per leaf with an axis name
(a tuple of names for ("pod", "data")) or None per dimension, where the
reference writes a PartitionSpec; the rules are the reference's over the
same param paths (the port's `blocks` is a list of per-layer dicts, the
reference stacks them [L, ...]; every rule indexes its dimension from the
end, so both give the same dimension). A rule splits only a dimension
that divides the degree, so every rank's slice has the same shape and one
rank's plan is every rank's.

Where the reference hands the specs to `shard_map` / `jit`, the port cuts
rank (data d, model m)'s slice out of a replicated tree (`shard_by_spec`,
also the restore across meshes) and gathers it back bit for bit
(`gather_by_spec`). The vocab-parallel head's layout keeps its own
functions: rank r of n owns the contiguous rows [r·rows, (r+1)·rows) of
the padded vocabulary, the top-level class tables (`embed`, and `head`
where untied) with their per-row quantization scales and codes, and
everything else replicates (`shard_params`, `shard_rows`,
`gather_params`); the index's own layout is `dist.vocab_parallel`'s
(`shard_index` / `local_index`). Data rank d of dp trains on the
contiguous batch rows [d·B/dp, (d+1)·B/dp) (`data_rows`), as
`batch_spec` splits the batch's leading dim; a batch that dp does not
divide is refused with the reference CLI's message
(`launch/train.py:150`) rather than replicated.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.dist.collectives import all_gather_dim, all_gather_rows
from repro_torch.optim.optimizers import OptState, tree_map

# leaf name -> which dim (from the end) shards over the model axis
_COL_PARALLEL = {
    "wq": -1, "wk": -1, "wv": -1,              # attention projections
    "gate": -1, "up": -1,                      # dense / shared-expert MLP
    "w_gate": -1, "w_up": -1,                  # MoE expert stacks [E, D, F]
    "z_proj": -1, "x_proj": -1, "dt_proj": -1,  # mamba2 d_inner projections
    "conv_x": -1, "conv_x_b": -1,              # depthwise conv over d_inner
    "norm_scale": -1,                          # mamba2 gated-norm scale
}
_ROW_PARALLEL = {
    "wo": -2, "down": -2, "w_down": -2, "out_proj": -2,
}
_VOCAB_PARALLEL = {
    "embed": -2, "head": -2,                   # [Vpad, D] class tables
}

# top-level params that row-shard over the vocab ranks
VOCAB_PARALLEL = tuple(_VOCAB_PARALLEL)


def tree_map_with_path(fn: Callable, tree, path: tuple = ()):
    """fn(names, leaf) over a dict / list tree; `names` are the dict keys
    on the way to the leaf (list indices left out, as the reference's
    `_path_names` keeps only string keys). None leaves stay None."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, path) for v in tree]
    if tree is None:
        return None
    return fn(path, tree)


def _shard_dim(leaf, dim_from_end: int, degree: int, axis) -> tuple:
    """A full-rank spec splitting one dim over `axis`, or replicated where
    the dim does not divide `degree`."""
    nd = leaf.dim()
    d = nd + dim_from_end
    entries = [None] * nd
    if 0 <= d < nd and leaf.shape[d] > 0 and leaf.shape[d] % degree == 0:
        entries[d] = axis
    return tuple(entries)


def param_specs(cfg, params_abs, *, tp: int, model_axis: str = "model"):
    """Tensor-parallel specs for a params tree (abstract, on the meta
    device, or real): the reference's name rules."""
    del cfg

    def one(names, leaf):
        name = names[-1] if names else ""
        if name in _COL_PARALLEL:
            return _shard_dim(leaf, _COL_PARALLEL[name], tp, model_axis)
        if name in _ROW_PARALLEL:
            return _shard_dim(leaf, _ROW_PARALLEL[name], tp, model_axis)
        if name in _VOCAB_PARALLEL and len(names) == 1:
            return _shard_dim(leaf, _VOCAB_PARALLEL[name], tp, model_axis)
        return (None,) * leaf.dim()

    return tree_map_with_path(one, params_abs)


def _data_entry(data_axes: Sequence[str]):
    data_axes = tuple(data_axes)
    return data_axes if len(data_axes) > 1 else data_axes[0]


def zero1_specs(specs, params_abs, *, dp: int,
                data_axes: Sequence[str] = ("data",),
                min_size: int = 1 << 16):
    """The specs of the AdamW moments under ZeRO-1: a leaf of at least
    `min_size` elements gains the data axes on its first still-unsplit
    dimension that dp divides; smaller leaves keep their param's spec.
    A layer's leaf (in `blocks` and the other per-layer lists) is sized as
    the reference's stacked [L, ...] leaf, L times its elements; where the
    reference would split that stacked leaf's layer dimension (L divides
    dp), the port's per-layer leaf takes its first dimension dp divides
    (departure: the port holds no stacked layer dimension)."""
    entry = _data_entry(data_axes)

    def one(spec, leaf, layers):
        if leaf.numel() * layers < min_size:
            return spec
        entries = list(spec) + [None] * (leaf.dim() - len(spec))
        for d in range(leaf.dim()):
            if entries[d] is None and leaf.shape[d] > 0 \
                    and leaf.shape[d] % dp == 0:
                entries[d] = entry
                return tuple(entries)
        return spec

    def walk(sp, x, layers):
        if isinstance(x, dict):
            return {k: walk(sp[k], v, layers) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(a, b, len(x)) for a, b in zip(sp, x)]
        return None if x is None else one(sp, x, layers)

    return walk(specs, params_abs, 1)


def batch_spec(multi_pod: bool, *, global_batch: int, dp: int) -> tuple:
    """The spec of every input's leading batch dim: the data axes, or
    replicated where the batch does not divide dp (long_500k's batch 1)."""
    if global_batch % dp:
        return ()
    return (_data_entry(("pod", "data") if multi_pod else ("data",)),)


def index_specs(index_abs):
    """The MIDX index replicates on every rank (DESIGN §4): every field of
    a MultiIndex (or a QuantHeadState) unsplit."""
    fields = {f.name: getattr(index_abs, f.name)
              for f in dataclasses.fields(index_abs)}
    return {k: (index_specs(v) if dataclasses.is_dataclass(v)
                else (None,) * v.dim() if torch.is_tensor(v) else None)
            for k, v in fields.items()}


def decode_cache_specs(cfg, cache_abs, *, tp: int, multi_pod: bool,
                       global_batch: int, dp_degree: int,
                       model_axis: str = "model"):
    """Specs of the slot-major decode state (`models.decode`): K/V caches
    [L, B, Smax, KV, hd] split batch over data and, over the model axis,
    the KV heads where they divide tp, else the sequence dimension; the
    ssm carries split batch over data and their d_inner-derived dims over
    model."""
    del cfg
    dentry = _data_entry(("pod", "data") if multi_pod else ("data",))
    batch_ok = global_batch % dp_degree == 0

    def batch(leaf, entries):
        if batch_ok and leaf.dim() > 1 and leaf.shape[1] == global_batch:
            entries[1] = dentry

    def kv_like(leaf):
        entries = [None] * leaf.dim()
        batch(leaf, entries)
        if leaf.shape[3] % tp == 0:
            entries[3] = model_axis
        elif leaf.shape[2] % tp == 0:
            entries[2] = model_axis
        return tuple(entries)

    def batch_and(dim):
        def rule(leaf):
            entries = [None] * leaf.dim()
            batch(leaf, entries)
            if dim is not None and leaf.shape[dim] % tp == 0:
                entries[dim] = model_axis
            return tuple(entries)
        return rule

    rules = {"k": kv_like, "v": kv_like, "shared_k": kv_like,
             "shared_v": kv_like, "cross_k": kv_like, "cross_v": kv_like,
             "conv_x": batch_and(-1), "conv_b": batch_and(None),
             "conv_c": batch_and(None), "ssm": batch_and(2)}

    def one(names, leaf):
        name = names[-1] if names else ""
        if name in rules:
            return rules[name](leaf)
        return (None,) * leaf.dim()

    return tree_map_with_path(one, cache_abs)


def _axis_extent(entry, sizes: dict, coords: dict) -> tuple[int, int]:
    """(degree, this rank's coordinate) of a spec entry: one axis, or a
    tuple of axes taken row-major (("pod", "data"))."""
    axes = entry if isinstance(entry, tuple) else (entry,)
    n, c = 1, 0
    for a in axes:
        n, c = n * sizes.get(a, 1), c * sizes.get(a, 1) + coords.get(a, 0)
    return n, c


def shard_leaf(x: torch.Tensor, spec: tuple, sizes: dict,
               coords: dict) -> torch.Tensor:
    """The slice of x a rank at `coords` holds under `spec` (a copy)."""
    out = x
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        n, c = _axis_extent(entry, sizes, coords)
        w = x.shape[d] // n
        out = out.narrow(d, c * w, w)
    return out.clone()


def shard_by_spec(tree, specs, sizes: dict, coords: dict):
    """The tree a rank at `coords` (axis -> index, e.g. {"data": d,
    "model": m}) holds on a mesh of `sizes` (axis -> degree): each leaf's
    slice under its spec, a copy (unsplit leaves too, so an in-place
    update of the slices leaves `tree` as it was)."""
    return tree_map(lambda x, s: shard_leaf(x, s, sizes, coords), tree,
                    specs)


def gather_leaf(x: torch.Tensor, spec: tuple, groups: dict) -> torch.Tensor:
    """A rank's slice gathered whole over the process group of each split
    axis (`groups`: axis -> group), bit for bit (collective)."""
    for d, entry in enumerate(spec):
        if entry is not None:
            x = all_gather_dim(x, d, groups[entry])
    return x


def gather_by_spec(tree, specs, groups: dict):
    """The replicated tree from every rank's slices (collective; the
    inverse of `shard_by_spec`)."""
    return tree_map(lambda x, s: gather_leaf(x, s, groups), tree, specs)


def spec_dim(spec: tuple, axis) -> Optional[int]:
    """The dimension a spec splits over `axis`, or None."""
    for d, entry in enumerate(spec):
        if entry == axis or (isinstance(entry, tuple) and axis in entry):
            return d
    return None


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
