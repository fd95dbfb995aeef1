"""Head-state validation: reject degenerate indexes before they go live.

Mirrors `src/repro/resilience/validate.py` (`validate_index` :29,
`_validate_generic` :71, `_validate_like` :85, `validate_state` :108,
`_validate_quant` :120-143) for the port's head states: the `MultiIndex`,
the quantized head's `QuantHeadState` and any proposal's state dict
(e.g. the RFF state). A silently broken index (NaN codebooks after a diverged
refit, a CSR that lost classes) does not crash training — it biases every
sampled-softmax step — so the index lifecycle checks each rebuilt index
before swapping it in; a zero or NaN scale of a quantized state would
silently zero every logit of its row. Each check returns human-readable
reasons; an empty list means the state is safe to install. Checks run on
host copies, once per refresh, off the hot path.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from repro_torch.index.build import MultiIndex
from repro_torch.index.quantized import QUANT_FIELDS, QuantHeadState


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def validate_index(index: MultiIndex) -> list[str]:
    """MultiIndex invariants: finite nonzero codebooks and a CSR layout that
    partitions exactly the class set. Empty individual joint clusters are
    legal; counts that no longer sum to N are not."""
    reasons = []
    for name in ("codebook1", "codebook2"):
        cb = _np(getattr(index, name))
        if not np.all(np.isfinite(cb)):
            reasons.append(f"{name} has non-finite entries")
        elif float(np.abs(cb).sum()) == 0.0:
            reasons.append(f"{name} is all-zero")
    if index.has_residuals and not np.all(np.isfinite(_np(index.residuals))):
        reasons.append("residuals have non-finite entries")
    n = index.num_classes
    counts, offsets = _np(index.counts), _np(index.offsets)
    sorted_ids = _np(index.sorted_ids)
    total = int(counts.sum())
    if total != n:
        reasons.append(f"cluster counts sum to {total}, expected {n} "
                       "(degenerate/empty clusters)")
    if offsets.shape[0] != counts.size + 1:
        reasons.append(f"offsets length {offsets.shape[0]} != K^2+1 "
                       f"({counts.size + 1})")
    else:
        if int(offsets[0]) != 0 or int(offsets[-1]) != n:
            reasons.append(f"offsets span [{int(offsets[0])}, "
                           f"{int(offsets[-1])}], expected [0, {n}]")
        if np.any(np.diff(offsets) < 0):
            reasons.append("offsets are not monotone non-decreasing")
        elif not np.array_equal(np.diff(offsets), counts.reshape(-1)):
            reasons.append("offsets/counts disagree")
    if sorted_ids.shape[0] != n or (
            n and not np.array_equal(np.sort(sorted_ids), np.arange(n))):
        reasons.append("sorted_ids is not a permutation of the class ids")
    return reasons


def _leaves(tree, path: str = ""):
    """(path, leaf) pairs of a state: a MultiIndex's array fields, a dict's
    values in key order (the order JAX flattens a dict in), or a leaf."""
    if isinstance(tree, MultiIndex):
        for f in dataclasses.fields(MultiIndex):
            if f.name != "kind":
                yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")
    elif isinstance(tree, QuantHeadState):
        for name in QUANT_FIELDS:
            yield from _leaves(getattr(tree, name), f"{path}.{name}")
    elif isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    else:
        yield path, tree


def _structure(tree) -> str:
    paths = ", ".join(p for p, _ in _leaves(tree))
    if isinstance(tree, MultiIndex):
        return f"MultiIndex(kind={tree.kind!r}: {paths})"
    if isinstance(tree, QuantHeadState):
        return (f"QuantHeadState(fmt={tree.fmt!r}, "
                f"kind={tree.index.kind!r}: {paths})")
    return f"{type(tree).__name__}({paths})"


def _validate_generic(state: Any) -> list[str]:
    """Any head-state tree: float leaves must be NaN-free. -inf is legal
    (log-probabilities of zero-mass classes), NaN never is."""
    reasons = []
    for path, leaf in _leaves(state):
        if torch.is_tensor(leaf) and leaf.is_floating_point() \
                and bool(torch.isnan(leaf).any()):
            reasons.append(f"NaN values in leaf {path}")
    return reasons


def _validate_like(state: Any, like: Any) -> list[str]:
    """Structure, shape and dtype agreement with the state it replaces: a
    swap never changes what the train step was built for."""
    if _structure(state) != _structure(like):
        return [f"tree structure mismatch: got {_structure(state)}, "
                f"expected {_structure(like)}"]
    reasons = []
    for (path, a), (_, b) in zip(_leaves(state), _leaves(like)):
        if a.shape != b.shape:
            reasons.append(f"leaf {path} shape {tuple(a.shape)} != current "
                           f"{tuple(b.shape)}")
        elif a.dtype != b.dtype:
            reasons.append(f"leaf {path} dtype {a.dtype} != current "
                           f"{b.dtype}")
    return reasons


def validate_state(state: Any, like: Any = None) -> list[str]:
    """Validate any proposal / head state before it goes live; `like` (the
    state being replaced) adds the structural checks, and a MultiIndex gets
    the full CSR / codebook invariants. Returns [] when it is safe."""
    if like is not None:
        reasons = _validate_like(state, like)
        if reasons:
            return reasons          # structure is broken; leaf checks moot
    if isinstance(state, MultiIndex):
        return validate_index(state)
    if isinstance(state, QuantHeadState):
        return validate_index(state.index) + _validate_quant(state)
    return _validate_generic(state)


def _validate_quant(state: QuantHeadState) -> list[str]:
    """The quantized head's checks on top of its index's: every scale
    finite and strictly positive (a zero or NaN scale silently zeroes each
    logit of its row), the residual sub-codebooks NaN-free."""
    reasons = []
    for name in ("qscale", "qcb1_scale", "qcb2_scale"):
        arr = _np(getattr(state, name))
        if arr.size and (not np.all(np.isfinite(arr)) or np.any(arr <= 0)):
            reasons.append(f"{name} has non-finite or non-positive scales")
    if not np.all(np.isfinite(_np(state.sub_codebooks))):
        reasons.append("sub_codebooks have non-finite entries")
    return reasons
