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
`proposal_state_from_numpy` / `proposal_state_to_numpy`.

bf16 leaves come out of JAX as `ml_dtypes.bfloat16` numpy arrays, which
`torch.from_numpy` rejects: they cross as their uint16 bit pattern and are
viewed back as torch.bfloat16, so no value is rounded on the way; going
back, bf16 tensors leave as `ml_dtypes.bfloat16` arrays (the numpy dtype
JAX uses), imported only when a bf16 tensor is met.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.index.build import MultiIndex

_INDEX_FIELDS = ("codebook1", "codebook2", "assign1", "assign2", "residuals",
                 "sorted_ids", "offsets", "counts", "log_counts")
_INT_FIELDS = ("assign1", "assign2", "sorted_ids", "offsets", "counts")


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .copy()).view(torch.bfloat16).to(device)
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
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
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


def proposal_state_from_numpy(d: Mapping, *, device=None) -> dict:
    """A JAX proposal state (a dict of arrays, e.g. the RFF state
    `{emb, w, tau, phi_c}`) as numpy -> the port's state on `device`."""
    device = resolve_device(device)
    return {k: tensor_from_numpy(v, device) for k, v in d.items()}


def proposal_state_to_numpy(state: Mapping) -> dict:
    """A port proposal state -> its leaves as numpy, for the JAX package."""
    return {k: tensor_to_numpy(v) for k, v in state.items()}
