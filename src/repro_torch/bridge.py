"""Carry state between the JAX package and the port, as numpy.

`params_from_numpy` / `index_from_numpy` take the JAX package's state into
the port's tensors; `params_to_numpy` / `index_to_numpy` give the port's
state back in the JAX package's layout, so a model the port trained loads
into `repro.models` for comparison. The JAX package's params are a pytree whose `blocks` leaves are stacked
over layers as [L, ...] (`src/repro/models/model.py:81`), with linear
weights laid out [d_in, d_out] for `x @ W`. The port keeps that layout, so
nothing is transposed; it unstacks `blocks` into one dict per layer. The
index is the numpy fields of a `MultiIndex` (`src/repro/index/build.py:36`);
index fields become int64, the port's indexing type. A proposal's state is
a flat dict of arrays (the RFF state `{emb, w, tau, phi_c}`,
`src/repro/proposals/rff.py:36`) and crosses leaf by leaf,
`proposal_state_from_numpy` / `proposal_state_to_numpy`. A quantized head
state (`src/repro/index/quantized.py:259`) crosses as its index's fields
under `index` and its other data fields, `quant_state_from_numpy` /
`quant_state_to_numpy`; fp8 leaves keep their dtype both ways (torch's
`float8_e4m3fn` and `ml_dtypes.float8_e4m3fn` share their bits).

bf16 leaves come out of JAX as `ml_dtypes.bfloat16` numpy arrays, which
`torch.from_numpy` rejects: they cross as their uint16 bit pattern and are
viewed back as torch.bfloat16, so no value is rounded on the way; going
back, bf16 tensors leave as `ml_dtypes.bfloat16` arrays (the numpy dtype
JAX uses), imported only when a bf16 tensor is met.

`to_reference` / `from_reference` carry a whole training state, the
`(params, opt_state, head_state)` tuple or any tree of the port's, into
the reference's layout and back: `blocks` stacked [L, ...], `OptState`'s
step a 0-d int32, a `MultiIndex`'s index fields int32 (the layout
`src/repro/launch/train.py:203-213` checkpoints). The leaves stay torch
tensors, on the host, so a bf16 or fp8 leaf keeps its dtype without
`ml_dtypes`; `checkpoint.manager` writes them in the reference's format.

The vocab-parallel index (`dist.vocab_parallel.VocabShardedIndex`,
reference `src/repro/dist/vocab_parallel.py:55`) crosses in the
reference's stacked layout: replicated codebooks, CSR leaves [n, ...],
int32 index fields on the reference's side
(`sharded_index_from_numpy` / `sharded_index_to_numpy`, and as a node of
`to_reference` / `from_reference`).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.vocab_parallel import (SHARDED_FIELDS,
                                             VocabShardedIndex)
from repro_torch.index.build import MultiIndex
from repro_torch.index.quantized import QUANT_FIELDS, QuantHeadState
from repro_torch.optim.optimizers import OptState

_INDEX_FIELDS = ("codebook1", "codebook2", "assign1", "assign2", "residuals",
                 "sorted_ids", "offsets", "counts", "log_counts")
_INT_FIELDS = ("assign1", "assign2", "sorted_ids", "offsets", "counts")


# ml_dtypes' extension dtypes: (the same-width unsigned view, torch's dtype)
_EXT = {"bfloat16": (np.uint16, torch.bfloat16),
        "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name in _EXT:
        raw, dtype = _EXT[a.dtype.name]
        return torch.from_numpy(np.ascontiguousarray(a).view(raw)
                                .copy()).view(dtype).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _tree(tree, device):
    if isinstance(tree, Mapping):
        return {k: _tree(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def params_from_numpy(cfg: ModelConfig, tree: Mapping, *,
                      device=None) -> dict:
    """The JAX params pytree as numpy (`jax.tree_util.tree_map(np.asarray,
    params)`) -> the port's params on `device` (default: the card)."""
    device = resolve_device(device)
    out = {k: _tree(v, device) for k, v in tree.items() if k != "blocks"}
    stacked = _tree(tree["blocks"], device)

    def layer(sub, i):
        return {k: (layer(v, i) if isinstance(v, dict) else v[i])
                for k, v in sub.items()}

    out["blocks"] = [layer(stacked, i) for i in range(cfg.num_layers)]
    return out


def index_from_numpy(d: Mapping, *, kind: str | None = None,
                     device=None) -> MultiIndex:
    """The fields of a JAX `MultiIndex` as numpy (a mapping of its data
    fields, plus `kind` unless given) -> a port `MultiIndex`."""
    device = resolve_device(device)
    fields = {}
    for name in _INDEX_FIELDS:
        t = tensor_from_numpy(d[name], device)
        fields[name] = t.long() if name in _INT_FIELDS else t
    return MultiIndex(kind=kind or str(d["kind"]), **fields)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    for name, (raw, dtype) in _EXT.items():
        if t.dtype == dtype:
            import ml_dtypes
            bits = t.view(torch.uint16 if raw == np.uint16 else torch.uint8)
            return bits.numpy().view(getattr(ml_dtypes, name))
    return t.numpy()


def params_to_numpy(cfg: ModelConfig, params: Mapping) -> dict:
    """The port's params (one dict per layer in `blocks`) -> the JAX
    package's params as numpy, with `blocks` leaves stacked [L, ...]."""
    del cfg                                  # the layer count is len(blocks)

    def tree(x):
        if isinstance(x, Mapping):
            return {k: tree(v) for k, v in x.items()}
        return tensor_to_numpy(x)

    out = {k: tree(v) for k, v in params.items() if k != "blocks"}
    layers = [tree(bp) for bp in params["blocks"]]

    def stack(subs):
        first = subs[0]
        if isinstance(first, dict):
            return {k: stack([s[k] for s in subs]) for k in first}
        return np.stack(subs)

    out["blocks"] = stack(layers)
    return out


def index_to_numpy(index: MultiIndex) -> dict:
    """A port `MultiIndex` -> its fields as numpy in the JAX package's
    dtypes (int32 index fields), plus `kind`."""
    out = {"kind": index.kind}
    for name in _INDEX_FIELDS:
        a = tensor_to_numpy(getattr(index, name))
        out[name] = a.astype(np.int32) if name in _INT_FIELDS else a
    return out


def sharded_index_from_numpy(d: Mapping, *, kind: str | None = None,
                             num_shards: int | None = None,
                             device=None) -> VocabShardedIndex:
    """The fields of a JAX `VocabShardedIndex` as numpy (a mapping of its
    data fields, plus `kind` / `num_shards` unless given) -> the port's,
    index fields int64."""
    device = resolve_device(device)
    fields = {}
    for name in SHARDED_FIELDS:
        t = tensor_from_numpy(d[name], device)
        fields[name] = t.long() if name in _INT_FIELDS else t
    return VocabShardedIndex(
        kind=kind or str(d["kind"]),
        num_shards=int(num_shards or d.get("num_shards",
                                           fields["sorted_ids"].shape[0])),
        **fields)


def sharded_index_to_numpy(index: VocabShardedIndex) -> dict:
    """A port `VocabShardedIndex` -> its fields as numpy in the JAX
    package's dtypes (int32 index fields), plus `kind` and `num_shards`."""
    out = {"kind": index.kind, "num_shards": index.num_shards}
    for name in SHARDED_FIELDS:
        a = tensor_to_numpy(getattr(index, name))
        out[name] = a.astype(np.int32) if name in _INT_FIELDS else a
    return out


def quant_state_from_numpy(d: Mapping, *, device=None) -> QuantHeadState:
    """A JAX `QuantHeadState` as numpy (`fmt`, `index` the mapping of its
    MultiIndex's fields with `kind`, and the other data fields) -> the
    port's `QuantHeadState` on `device`."""
    device = resolve_device(device)
    return QuantHeadState(
        str(d["fmt"]), index_from_numpy(d["index"], device=device),
        **{f: tensor_from_numpy(d[f], device) for f in QUANT_FIELDS[1:]})


def quant_state_to_numpy(state: QuantHeadState) -> dict:
    """A port `QuantHeadState` -> `fmt`, `index` (`index_to_numpy`) and
    its other data fields as numpy, in the JAX package's dtypes."""
    out = {"fmt": state.fmt, "index": index_to_numpy(state.index)}
    for f in QUANT_FIELDS[1:]:
        out[f] = tensor_to_numpy(getattr(state, f))
    return out


def proposal_state_from_numpy(d: Mapping, *, device=None) -> dict:
    """A JAX proposal state (a dict of arrays, e.g. the RFF state
    `{emb, w, tau, phi_c}`) as numpy -> the port's state on `device`."""
    device = resolve_device(device)
    return {k: tensor_from_numpy(v, device) for k, v in d.items()}


def proposal_state_to_numpy(state: Mapping) -> dict:
    """A port proposal state -> its leaves as numpy, for the JAX package."""
    return {k: tensor_to_numpy(v) for k, v in state.items()}


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return np.asarray(x)


def _stack_host(xs):
    if isinstance(xs[0], torch.Tensor):
        return torch.stack([x.detach().cpu() for x in xs])
    return np.stack([np.asarray(x) for x in xs])


def _int32(x):
    return x.to(torch.int32) if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.int32)


def _layout(tree, leaf, stack, int32):
    """The port's tree in the reference's structure: `leaf` maps a leaf,
    `stack` a list of one leaf per layer, `int32` an integer field."""
    def go(t):
        if isinstance(t, OptState):
            return OptState(int32(leaf(t.step)), go(t.mu), go(t.nu))
        if isinstance(t, MultiIndex):
            return MultiIndex(kind=t.kind, **{
                f: (int32 if f in _INT_FIELDS else (lambda x: x))(
                    leaf(getattr(t, f))) for f in _INDEX_FIELDS})
        if isinstance(t, VocabShardedIndex):
            return VocabShardedIndex(t.kind, t.num_shards, **{
                f: (int32 if f in _INT_FIELDS else (lambda x: x))(
                    leaf(getattr(t, f))) for f in SHARDED_FIELDS})
        if isinstance(t, QuantHeadState):
            return QuantHeadState(t.fmt, **{f: go(getattr(t, f))
                                            for f in QUANT_FIELDS})
        if isinstance(t, Mapping):
            return {k: (zip_layers(v) if k == "blocks" and isinstance(v, list)
                        else go(v)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(go(v) for v in t)
        return None if t is None else leaf(t)

    def zip_layers(layers):
        first = layers[0]
        if isinstance(first, Mapping):
            return {k: zip_layers([l[k] for l in layers]) for k in first}
        return stack(layers)

    return go(tree)


def to_reference(tree):
    """A tree of the port's (the training tuple `(params, opt_state,
    head_state)`, a `{"params", "index"}` serving tree, or any dict / list /
    tuple / `OptState` / `MultiIndex` / `QuantHeadState` tree of tensors,
    numpy arrays or
    numbers) -> the same values in the reference's layout, on the host."""
    return _layout(tree, _host, _stack_host, _int32)


def reference_structure(tree):
    """`to_reference(tree)`'s structure without moving or stacking a
    value (its leaves are placeholders): what a restore target needs."""
    return _layout(tree, lambda x: 0, lambda xs: 0, lambda x: x)


def _torch_dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) \
        else getattr(torch, np.dtype(dtype).name)


def from_reference(ref, like, *, device=None):
    """Inverse of `to_reference`: values in the reference's layout (torch
    or numpy leaves) -> the port's structure of `like`, each tensor on
    `device` (default: the card) in the dtype of `like`'s leaf. `blocks`
    unstacks into as many layers as the values hold; a MultiIndex takes
    `like`'s kind."""
    device = resolve_device(device)

    def leaf(x, lk):
        t = x if isinstance(x, torch.Tensor) else tensor_from_numpy(x, "cpu")
        if isinstance(lk, (bool, int, float)):
            return type(lk)(t.item())
        dtype = _torch_dtype(lk.dtype) if hasattr(lk, "dtype") else t.dtype
        return t.to(device=device, dtype=dtype, copy=True)

    def go(r, lk):
        if isinstance(lk, OptState):
            return OptState(int(leaf(r.step, 0)), go(r.mu, lk.mu),
                            go(r.nu, lk.nu))
        if isinstance(lk, MultiIndex):
            return MultiIndex(kind=lk.kind, **{
                f: go(getattr(r, f), getattr(lk, f)) for f in _INDEX_FIELDS})
        if isinstance(lk, VocabShardedIndex):
            return VocabShardedIndex(lk.kind, lk.num_shards, **{
                f: go(getattr(r, f), getattr(lk, f))
                for f in SHARDED_FIELDS})
        if isinstance(lk, QuantHeadState):
            return QuantHeadState(lk.fmt, **{
                f: go(getattr(r, f), getattr(lk, f)) for f in QUANT_FIELDS})
        if isinstance(lk, Mapping):
            return {k: (unstack(r[k], v) if k == "blocks"
                        and isinstance(v, list) else go(r[k], v))
                    for k, v in lk.items()}
        if isinstance(lk, (list, tuple)):
            return type(lk)(go(a, b) for a, b in zip(r, lk))
        return None if lk is None else leaf(r, lk)

    def layer(r, i):
        return {k: layer(v, i) for k, v in r.items()} \
            if isinstance(r, Mapping) else r[i]

    def unstack(r, like_layers):
        first = r
        while isinstance(first, Mapping):
            first = next(iter(first.values()))
        return [go(layer(r, i), like_layers[0]) for i in range(len(first))]

    return go(ref, like)
