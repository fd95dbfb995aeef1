"""Carry state between the JAX package and the port, as numpy.

`params_from_numpy` / `index_from_numpy` take the JAX package's state into
the port's tensors; `params_to_numpy` / `index_to_numpy` give the port's
state back in the JAX package's layout, so a model the port trained loads
into `repro.models` for comparison. The JAX package's params are a pytree whose `blocks` leaves are stacked
over layers as [L, ...] (`src/repro/models/model.py:81`), with linear
weights laid out [d_in, d_out] for `x @ W`. The port keeps that layout, so
nothing is transposed; it unstacks `blocks` (and the vlm's `cross_blocks`,
the audio encoder's `encoder.blocks`) into one dict per layer. The
index is the numpy fields of a `MultiIndex` (`src/repro/index/build.py:36`);
index fields become int64, the port's indexing type. A proposal's state
crosses node by node, `proposal_state_from_numpy` /
`proposal_state_to_numpy`: a dict of arrays (the RFF state `{emb, w, tau,
phi_c}`, `src/repro/proposals/rff.py:36`), the unigram's nested
`AliasTable`, `{"index": MultiIndex, "emb"}` (midx-exact-*), `{"cb":
LearnableCodebooks, "index": MultiIndex}` (midx-learnable-*), a bare
`MultiIndex` (midx-pq / -rq) or `MultiIndexB`; a 0-d integer (`n`, a
Python int leaf of the reference's state) becomes a Python int and a 0-d
float (`alpha`, `eps`, `tau`) a 0-d tensor. The reference's nodes are
recognised by their fields, so the bridge needs no JAX. A quantized head
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
step a 0-d int32, a `MultiIndex`'s index fields and every other int64
tensor int32, as the reference holds them (the layout
`src/repro/launch/train.py:203-213` checkpoints); `LearnableCodebooks`,
`MultiIndexB` and namedtuples (`AliasTable`) keep their node types. The leaves stay torch
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
from repro_torch.core.alias import AliasTable
from repro_torch.core.learnable import CODEBOOK_FIELDS, LearnableCodebooks
from repro_torch.core.midx_multi import MultiIndexB
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


#: the params' stacked nodes: the reference stacks their leaves over
#: layers [n, ...]; the port keeps a list of one dict a layer
STACKED = ("blocks", "cross_blocks")


def _n_stacked(sub: Mapping) -> int:
    first = sub
    while isinstance(first, Mapping):
        first = next(iter(first.values()))
    return first.shape[0]


def params_from_numpy(cfg: ModelConfig, tree: Mapping, *,
                      device=None) -> dict:
    """The JAX params pytree as numpy (`jax.tree_util.tree_map(np.asarray,
    params)`) -> the port's params on `device` (default: the card): the
    stacked `blocks` (cfg.num_layers), `cross_blocks` (the vlm's cross
    blocks) and `encoder.blocks` (the audio encoder's layers) unstack into
    one dict a layer."""
    del cfg                       # the layer counts are the leaves' own
    device = resolve_device(device)

    def layer(sub, i):
        return {k: (layer(v, i) if isinstance(v, dict) else v[i])
                for k, v in sub.items()}

    def go(t):
        out = {}
        for k, v in t.items():
            if k in STACKED:
                stacked = _tree(v, device)
                out[k] = [layer(stacked, i)
                          for i in range(_n_stacked(stacked))]
            elif isinstance(v, Mapping):
                out[k] = go(v)
            else:
                out[k] = tensor_from_numpy(v, device)
        return out

    return go(tree)


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
    """The port's params (one dict per layer in `blocks`, `cross_blocks`
    and `encoder.blocks`) -> the JAX package's params as numpy, with those
    nodes' leaves stacked [n, ...]."""
    del cfg                                  # the layer count is len(blocks)

    def stack(subs):
        first = subs[0]
        if isinstance(first, dict):
            return {k: stack([s[k] for s in subs]) for k in first}
        return np.stack(subs)

    def tree(x):
        if isinstance(x, Mapping):
            return {k: (stack([tree(l) for l in v]) if k in STACKED
                        else tree(v)) for k, v in x.items()}
        return tensor_to_numpy(x)

    return tree(params)


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


def _is_index(x) -> bool:
    if isinstance(x, Mapping):
        return "sorted_ids" in x and "log_counts" in x
    return hasattr(x, "sorted_ids") and hasattr(x, "log_counts")


def _fields(x, names) -> dict:
    return {f: (x[f] if isinstance(x, Mapping) else getattr(x, f))
            for f in names}


def proposal_state_from_numpy(d, *, device=None):
    """A JAX proposal state as numpy (`jax.tree_util.tree_map(np.asarray,
    state)`, or the nested dicts `proposal_state_to_numpy` gives) -> the
    port's state on `device`: MultiIndex, LearnableCodebooks, AliasTable
    and MultiIndexB nodes, dicts, Python ints for 0-d integers."""
    device = resolve_device(device)

    def go(x):
        if _is_index(x):
            return index_from_numpy(_fields(x, (*_INDEX_FIELDS, "kind")),
                                    device=device)
        if isinstance(x, Mapping) and set(x) == {"kind", *CODEBOOK_FIELDS} \
                or not isinstance(x, Mapping) and hasattr(x, "codebook1"):
            f = _fields(x, ("kind", *CODEBOOK_FIELDS))
            return LearnableCodebooks(str(f["kind"]), *(
                tensor_from_numpy(f[k], device) for k in CODEBOOK_FIELDS))
        if hasattr(x, "assigns") or isinstance(x, Mapping) and "assigns" in x:
            f = _fields(x, ("codebooks", "assigns", "residuals"))
            return MultiIndexB(
                tuple(tensor_from_numpy(c, device) for c in f["codebooks"]),
                tuple(tensor_from_numpy(a, device).long()
                      for a in f["assigns"]),
                tensor_from_numpy(f["residuals"], device))
        if getattr(x, "_fields", None) == AliasTable._fields or \
                isinstance(x, Mapping) and set(x) == set(AliasTable._fields):
            f = _fields(x, AliasTable._fields)
            return AliasTable(tensor_from_numpy(f["prob"], device),
                              tensor_from_numpy(f["alias"], device).long(),
                              tensor_from_numpy(f["logq"], device))
        if isinstance(x, Mapping):
            return {k: go(v) for k, v in x.items()}
        a = np.asarray(x)
        if a.ndim == 0 and a.dtype.kind in "iu":
            return int(a)
        t = tensor_from_numpy(a, device)
        return t.long() if a.dtype.kind in "iu" else t

    return go(d)


def proposal_state_to_numpy(state):
    """A port proposal state -> numpy in the reference's dtypes (int32
    index arrays), its nodes as dicts of their fields (a MultiIndex as
    `index_to_numpy` gives it), Python ints as they are."""
    def go(x):
        if isinstance(x, MultiIndex):
            return index_to_numpy(x)
        if isinstance(x, LearnableCodebooks):
            return {"kind": x.kind, **{f: tensor_to_numpy(getattr(x, f))
                                       for f in CODEBOOK_FIELDS}}
        if isinstance(x, MultiIndexB):
            return {"codebooks": tuple(go(c) for c in x.codebooks),
                    "assigns": tuple(go(a) for a in x.assigns),
                    "residuals": go(x.residuals)}
        if isinstance(x, AliasTable):
            return {f: go(getattr(x, f)) for f in AliasTable._fields}
        if isinstance(x, Mapping):
            return {k: go(v) for k, v in x.items()}
        if isinstance(x, torch.Tensor):
            a = tensor_to_numpy(x)
            return a.astype(np.int32) if a.dtype == np.int64 else a
        return x

    return go(state)


def _host(x):
    """A leaf on the host in the reference's dtype: int64 tensors (the
    port's indexing type) as int32."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.to(torch.int32) if x.dtype == torch.int64 else x
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
        if isinstance(t, LearnableCodebooks):
            return LearnableCodebooks(t.kind, *(go(getattr(t, f))
                                                for f in CODEBOOK_FIELDS))
        if isinstance(t, MultiIndexB):
            return MultiIndexB(go(t.codebooks), go(t.assigns),
                               go(t.residuals))
        if isinstance(t, Mapping):
            return {k: (zip_layers(v) if k in STACKED and isinstance(v, list)
                        else go(v)) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(go(v) for v in t))
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
    tuple / namedtuple / `OptState` / `MultiIndex` / `QuantHeadState` /
    `LearnableCodebooks` / `MultiIndexB` tree of tensors, numpy arrays or
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
    (at any depth: `encoder.blocks` too) and `cross_blocks` unstack into
    as many layers as the values hold; a MultiIndex takes `like`'s
    kind."""
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
        if isinstance(lk, LearnableCodebooks):
            return LearnableCodebooks(lk.kind, *(
                go(getattr(r, f), getattr(lk, f)) for f in CODEBOOK_FIELDS))
        if isinstance(lk, MultiIndexB):
            return MultiIndexB(go(r.codebooks, lk.codebooks),
                               go(r.assigns, lk.assigns),
                               go(r.residuals, lk.residuals))
        if isinstance(lk, tuple) and hasattr(lk, "_fields"):
            return type(lk)(*(go(a, b) for a, b in zip(r, lk)))
        if isinstance(lk, Mapping):
            return {k: (unstack(r[k], v) if k in STACKED
                        and isinstance(v, list) else go(r[k], v))
                    for k, v in lk.items()}
        if isinstance(lk, (list, tuple)):
            return type(lk)(go(a, b) for a, b in zip(r, lk))
        return None if lk is None else leaf(r, lk)

    def layer(r, i):
        return {k: layer(v, i) for k, v in r.items()} \
            if isinstance(r, Mapping) else r[i]

    def unstack(r, like_layers):
        return [go(layer(r, i), like_layers[0])
                for i in range(_n_stacked(r))]

    return go(ref, like)
