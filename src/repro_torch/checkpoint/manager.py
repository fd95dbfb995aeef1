"""Fault-tolerant checkpointing in the reference's on-disk format.

Mirrors `src/repro/checkpoint/manager.py` (`CheckpointManager` :103,
`save_serving_state` / `restore_serving_state` :318-337), byte for byte in
the format, so a checkpoint written by either package restores in the
other:

  <root>/step_<N>.tmp/...   (being written)
  <root>/step_<N>.old/...   (previous committed dir, mid-swap only)
  <root>/step_<N>/          (atomic rename on completion)
      arrays.npz            the leaves, `leaf_<i>`, in JAX's flatten order
      tree.json             treedef string, num_leaves, shapes, dtypes,
                            per-leaf CRC32s, metadata
      COMMITTED             marker

The protocol is the reference's: every file and the directory entries are
fsynced before the commit rename, a committed dir is renamed aside to
`.old` (never rmtree'd) until the new one has landed and `_recover` heals
either half of that swap, keep-k GC spares the newest complete checkpoint,
`verify` / `restore` recompute the CRC32s and compare the treedef string,
and `latest_verified_step` / `restore_latest_verified` walk back past
corrupt or mismatched steps. `fault_hook(phase, step)` is called at
'arrays' | 'tree' | 'committed' | 'swap' (`resilience.FaultInjector.
attach_checkpoint` sets it).

What the port adds to match the format: `save` takes the port's trees and
writes them in the reference's layout (`bridge.to_reference`: `blocks`
stacked [L, ...], the optimizer step a 0-d int32, index fields int32);
`_treedef_str` prints JAX's `str(treedef)` for that layout (dicts by
sorted key, `OptState` as `CustomNode(namedtuple[OptState], [...])`, a
`MultiIndex` as `CustomNode(MultiIndex[('rq',)], [...])` over the data
fields in the order of `src/repro/index/build.py:30-33`, a quantized head
state as `CustomNode(QuantHeadState[('int8',)], [...])` over its index
and its low-bit twins, `src/repro/index/quantized.py:255-258`; a
vocab-parallel run's stacked index as `CustomNode(VocabShardedIndex[('rq',
2)], [...])`, `src/repro/dist/vocab_parallel.py:50-56`; a learnable
proposal's codebooks as `CustomNode(LearnableCodebooks[('rq',)], [*, *])`,
`src/repro/core/learnable.py:21-24`, a B-book index as
`CustomNode(MultiIndexB[()], [...])`, `src/repro/core/midx_multi.py:30-33`,
and a namedtuple such as the unigram's `AliasTable` as
`CustomNode(namedtuple[AliasTable], [...])`; a Python int, such as a
proposal state's `n`, is a leaf, as it is to JAX); bf16 and fp8
leaves are stored as same-width unsigned raw bits with their true dtype's
name in tree.json, as the reference stores them, without `ml_dtypes`.
`restore(step, like, device=...)` takes `like` in the port's structure
(only its structure and leaf dtypes are read) and returns the port's
tensors on `device`.

Departure: the reference's `shardings=` (elastic re-shard onto a mesh) is
`device=` here. Across meshes a rank of a dp x tp grid saves the gathered
replicated tree (`save_gathered`) and restores its slice for any other
mesh (`restore_sharded`, `dist.sharding.shard_by_spec`), ZeRO-1 moments
gathered to the reference's format first.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.bridge import (_INDEX_FIELDS, from_reference,
                                reference_structure, to_reference)
from repro_torch.core.learnable import CODEBOOK_FIELDS, LearnableCodebooks
from repro_torch.core.midx_multi import MULTI_FIELDS, MultiIndexB
from repro_torch.dist.vocab_parallel import (SHARDED_FIELDS,
                                             VocabShardedIndex)
from repro_torch.index.build import MultiIndex
from repro_torch.index.quantized import QUANT_FIELDS, QuantHeadState

# torch dtypes numpy cannot hold: stored as their raw bits
_RAW_BITS = {torch.bfloat16: (torch.uint16, np.uint16),
             torch.float8_e4m3fn: (torch.uint8, np.uint8),
             torch.float8_e5m2: (torch.uint8, np.uint8)}


class CheckpointError(RuntimeError):
    """A checkpoint failed verification or structural matching."""


# ------------------------------------------------------------------ trees
def _children(t) -> Optional[list]:
    """A node's children in JAX's flatten order; None for a leaf."""
    if isinstance(t, MultiIndex):
        return [getattr(t, f) for f in _INDEX_FIELDS]
    if isinstance(t, VocabShardedIndex):
        return [getattr(t, f) for f in SHARDED_FIELDS]
    if isinstance(t, QuantHeadState):
        return [getattr(t, f) for f in QUANT_FIELDS]
    if isinstance(t, LearnableCodebooks):
        return [getattr(t, f) for f in CODEBOOK_FIELDS]
    if isinstance(t, MultiIndexB):
        return [getattr(t, f) for f in MULTI_FIELDS]
    if isinstance(t, dict):
        return [t[k] for k in sorted(t)]
    if isinstance(t, (list, tuple)):
        return list(t)
    return None


def _flatten(tree) -> list:
    if tree is None:
        return []
    kids = _children(tree)
    return [tree] if kids is None else [x for k in kids for x in _flatten(k)]


def _unflatten(structure, leaves):
    """Leaves (an iterator) into `structure`, as `_flatten` took them."""
    if structure is None:
        return None
    if isinstance(structure, MultiIndex):
        return MultiIndex(kind=structure.kind, **{
            f: _unflatten(getattr(structure, f), leaves)
            for f in _INDEX_FIELDS})
    if isinstance(structure, VocabShardedIndex):
        return VocabShardedIndex(structure.kind, structure.num_shards, **{
            f: _unflatten(getattr(structure, f), leaves)
            for f in SHARDED_FIELDS})
    if isinstance(structure, QuantHeadState):
        return QuantHeadState(structure.fmt, **{
            f: _unflatten(getattr(structure, f), leaves)
            for f in QUANT_FIELDS})
    if isinstance(structure, LearnableCodebooks):
        return LearnableCodebooks(structure.kind, *(
            _unflatten(getattr(structure, f), leaves)
            for f in CODEBOOK_FIELDS))
    if isinstance(structure, MultiIndexB):
        return MultiIndexB(*(_unflatten(getattr(structure, f), leaves)
                             for f in MULTI_FIELDS))
    if isinstance(structure, dict):
        out = {k: _unflatten(structure[k], leaves) for k in sorted(structure)}
        return {k: out[k] for k in structure}
    if isinstance(structure, tuple) and hasattr(structure, "_fields"):
        return type(structure)(*(_unflatten(c, leaves) for c in structure))
    if isinstance(structure, (list, tuple)):
        return type(structure)(_unflatten(c, leaves) for c in structure)
    return next(leaves)


def _treedef_str(tree) -> str:
    """JAX's `str(jax.tree_util.tree_flatten(tree)[1])` for the trees the
    port saves (the tests hold it against jax.tree_util)."""
    def go(t) -> str:
        if t is None:
            return "None"
        if isinstance(t, MultiIndex):
            return (f"CustomNode(MultiIndex[{(t.kind,)!r}], "
                    f"[{', '.join(go(c) for c in _children(t))}])")
        if isinstance(t, VocabShardedIndex):
            return (f"CustomNode(VocabShardedIndex"
                    f"[{(t.kind, t.num_shards)!r}], "
                    f"[{', '.join(go(c) for c in _children(t))}])")
        if isinstance(t, QuantHeadState):
            return (f"CustomNode(QuantHeadState[{(t.fmt,)!r}], "
                    f"[{', '.join(go(c) for c in _children(t))}])")
        if isinstance(t, LearnableCodebooks):
            return (f"CustomNode(LearnableCodebooks[{(t.kind,)!r}], "
                    f"[{', '.join(go(c) for c in _children(t))}])")
        if isinstance(t, MultiIndexB):
            return (f"CustomNode(MultiIndexB[()], "
                    f"[{', '.join(go(c) for c in _children(t))}])")
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {go(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return (f"CustomNode(namedtuple[{type(t).__name__}], "
                    f"[{', '.join(go(c) for c in t)}])")
        if isinstance(t, tuple):
            inner = ", ".join(go(c) for c in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        if isinstance(t, list):
            return "[" + ", ".join(go(c) for c in t) + "]"
        return "*"

    return f"PyTreeDef({go(tree)})"


# ------------------------------------------------------------------ leaves
def _storable(leaf) -> tuple[np.ndarray, str]:
    """(what np.savez stores, the true dtype's name): bf16 / fp8 as a
    same-width unsigned view of their bits, as the reference stores them;
    the bytes, and so the CRC32s, are the value's own."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().contiguous()
        if leaf.dtype in _RAW_BITS:
            return (leaf.view(_RAW_BITS[leaf.dtype][0]).numpy(),
                    str(leaf.dtype).removeprefix("torch."))
        return leaf.numpy(), str(leaf.numpy().dtype)
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V":                  # an ml_dtypes array
        return arr.view(np.dtype(f"u{arr.dtype.itemsize}")), str(arr.dtype)
    return arr, str(arr.dtype)


def _from_storable(arr: np.ndarray, dtype: Optional[str]) -> torch.Tensor:
    """Undo `_storable` given the dtype recorded in tree.json. A leaf of
    an extension dtype written before the raw-bits scheme loads as a void
    field of the same width; it is read as those bits too."""
    if arr.dtype.kind == "V":
        arr = arr.view(np.dtype(f"u{arr.dtype.itemsize}"))
    t = torch.from_numpy(np.array(arr, order="C"))
    true = getattr(torch, dtype, None) if dtype else None
    if true in _RAW_BITS and t.dtype == _RAW_BITS[true][0]:
        return t.view(true)
    return t


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _leaf_crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _parse_step(name: str) -> Optional[int]:
    if not name.startswith("step_") or name.endswith((".tmp", ".old")):
        return None
    try:
        return int(name.split("_")[1])
    except ValueError:
        return None


def _structure_reasons(d: str, spec: dict, like: Any) -> list[str]:
    structure = reference_structure(like)
    n_like = len(_flatten(structure))
    reasons = []
    if spec["num_leaves"] != n_like:
        reasons.append(f"{d}: checkpoint has {spec['num_leaves']} leaves, "
                       f"restore target has {n_like}")
    if spec.get("treedef") and spec["treedef"] != _treedef_str(structure):
        reasons.append(f"{d}: treedef mismatch with restore target")
    return reasons


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        self.fault_hook: Optional[Callable[[str, int], None]] = None
        os.makedirs(root, exist_ok=True)
        self._recover()

    # ------------------------------------------------------------- paths
    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:010d}")

    def _fault(self, phase: str, step: int) -> None:
        if self.fault_hook is not None:
            self.fault_hook(phase, step)

    def _recover(self) -> None:
        """Heal a crash mid-commit: a `.old` dir whose final dir is missing
        was renamed aside but never replaced — put it back. One whose final
        dir exists is debris from a crash after commit — drop it."""
        for name in os.listdir(self.root):
            if not name.endswith(".old"):
                continue
            aside = os.path.join(self.root, name)
            final = aside[: -len(".old")]
            if os.path.exists(final):
                shutil.rmtree(aside, ignore_errors=True)
            else:
                os.rename(aside, final)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return max(steps) if steps else None

    def all_steps(self) -> list[int]:
        out = []
        for name in sorted(os.listdir(self.root)):
            step = _parse_step(name)
            if step is not None and os.path.exists(
                    os.path.join(self.root, name, "COMMITTED")):
                out.append(step)
        return out

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, metadata: Optional[dict] = None) -> str:
        """Write `tree` (a tree of the port's: tensors, numpy arrays,
        numbers) as step `step` in the reference's layout."""
        final = self._dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        ref = to_reference(tree)
        stored = [_storable(leaf) for leaf in _flatten(ref)]
        arrays_path = os.path.join(tmp, "arrays.npz")
        np.savez(arrays_path,
                 **{f"leaf_{i}": a for i, (a, _) in enumerate(stored)})
        self._fault("arrays", step)
        _fsync_path(arrays_path)
        spec = {
            "treedef": _treedef_str(ref),
            "num_leaves": len(stored),
            "shapes": [list(a.shape) for a, _ in stored],
            "dtypes": [d for _, d in stored],
            "crc32": [_leaf_crc(a) for a, _ in stored],
            "metadata": metadata or {},
        }
        tree_path = os.path.join(tmp, "tree.json")
        with open(tree_path, "w") as f:
            json.dump(spec, f)
            f.flush()
            os.fsync(f.fileno())
        self._fault("tree", step)
        with open(os.path.join(tmp, "COMMITTED"), "w") as f:
            f.write("ok")
            f.flush()
            os.fsync(f.fileno())
        _fsync_path(tmp)               # directory entries of the tmp dir
        self._fault("committed", step)
        # commit: never a window without a complete checkpoint on disk —
        # the old dir is renamed aside (not rmtree'd) until the new one has
        # landed; _recover() heals either half of the swap after a crash
        old = final + ".old"
        if os.path.exists(final):
            if os.path.exists(old):
                shutil.rmtree(old)
            os.rename(final, old)
        self._fault("swap", step)
        os.rename(tmp, final)          # atomic commit
        _fsync_path(self.root)
        if os.path.exists(old):
            shutil.rmtree(old)
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._dir(s), ignore_errors=True)

    # ------------------------------------------------------------- verify
    def _spec(self, step: int) -> dict:
        with open(os.path.join(self._dir(step), "tree.json")) as f:
            return json.load(f)

    def verify(self, step: int, like: Any = None) -> list[str]:
        """Check a committed step without building tensors: tree.json
        parses, arrays.npz loads, per-leaf CRC32s match (when recorded),
        and — with `like`, in the port's structure — leaf count and
        treedef string agree. Returns reasons; [] means restorable."""
        d = self._dir(step)
        try:
            spec = self._spec(step)
        except Exception as e:                      # noqa: BLE001
            return [f"{d}: tree.json unreadable ({e!r})"]
        reasons = []
        try:
            with np.load(os.path.join(d, "arrays.npz")) as z:
                names = [f"leaf_{i}" for i in range(spec["num_leaves"])]
                if sorted(z.files) != sorted(names):
                    reasons.append(
                        f"{d}: arrays.npz holds {len(z.files)} leaves, "
                        f"tree.json promises {spec['num_leaves']}")
                else:
                    crcs = spec.get("crc32")
                    for i, name in enumerate(names):
                        leaf = z[name]
                        if crcs is not None and _leaf_crc(leaf) != crcs[i]:
                            reasons.append(
                                f"{d}: CRC32 mismatch on {name} "
                                "(silent corruption)")
        except Exception as e:                      # noqa: BLE001
            reasons.append(f"{d}: arrays.npz unreadable ({e!r})")
        if like is not None:
            reasons += _structure_reasons(d, spec, like)
        return reasons

    def matches(self, step: int, like: Any) -> bool:
        """Whether committed step `step` has the structure of `like` (the
        port's): `verify`'s leaf count and treedef checks, from tree.json
        alone."""
        return not _structure_reasons(self._dir(step), self._spec(step), like)

    def latest_verified_step(self, like: Any = None) -> Optional[int]:
        """Newest step that passes `verify` — the restore-fallback walk:
        corrupt or mismatched steps are skipped (and reported), older
        complete checkpoints remain eligible."""
        for step in reversed(self.all_steps()):
            reasons = self.verify(step, like)
            if not reasons:
                return step
            print(f"[ckpt] skipping step {step}: {'; '.join(reasons)}")
        return None

    # ------------------------------------------------------------- restore
    def metadata(self, step: int) -> dict:
        return self._spec(step)["metadata"]

    def restore(self, step: int, like: Any, *, device=None,
                verify: bool = True) -> Any:
        """Restore into the port's structure of `like` (its leaves give
        only the dtypes to cast to), each tensor on `device` (default: the
        card). verify=True (default) checks the recorded per-leaf CRC32s
        and the treedef string before any value is installed."""
        d = self._dir(step)
        spec = self._spec(step)
        structure = reference_structure(like)
        n_like = len(_flatten(structure))
        if spec["num_leaves"] != n_like:
            raise CheckpointError(
                f"{d}: checkpoint holds {spec['num_leaves']} leaves but the "
                f"restore target has {n_like} — model/checkpoint mismatch")
        if verify and spec.get("treedef") and \
                spec["treedef"] != _treedef_str(structure):
            raise CheckpointError(
                f"{d}: treedef mismatch — the checkpoint was saved from a "
                "different pytree structure than the restore target")
        dtypes = spec.get("dtypes") or [None] * spec["num_leaves"]
        with np.load(os.path.join(d, "arrays.npz")) as z:
            raw = [z[f"leaf_{i}"] for i in range(len(z.files))]
        if verify and spec.get("crc32"):
            for i, leaf in enumerate(raw):
                if _leaf_crc(leaf) != spec["crc32"][i]:
                    raise CheckpointError(
                        f"{d}: CRC32 mismatch on leaf_{i} — silent "
                        "corruption; use restore_latest_verified to walk "
                        "back to an intact checkpoint")
        leaves = [_from_storable(a, dt) for a, dt in zip(raw, dtypes)]
        ref = _unflatten(structure, iter(leaves))
        return from_reference(ref, like, device=device)

    def restore_latest_verified(self, like: Any, *,
                                device=None) -> tuple[int, Any]:
        """Walk back to the newest checkpoint that verifies and restore it.
        Returns (step, tree); raises CheckpointError when nothing under the
        root survives verification."""
        step = self.latest_verified_step(like)
        if step is None:
            raise CheckpointError(
                f"no verifiable checkpoint under {self.root} "
                f"(candidates: {self.all_steps()})")
        return step, self.restore(step, like, device=device)


# ---------------------------------------------------------------------------
# serving checkpoints
# ---------------------------------------------------------------------------
# One atomic step dir holds everything the serving engine needs to restore
# sampling bit-exactly: the params and the head state (the MultiIndex's
# codebooks and CSR layout, or a proposal's state) as ordinary leaves.

def save_serving_state(root: str, step: int, params: Any, index: Any,
                       metadata: Optional[dict] = None) -> str:
    """Save a {"params", "index"} serving tree under `root`."""
    return CheckpointManager(root).save(
        step, {"params": params, "index": index}, metadata)


def restore_serving_state(root: str, like_params: Any, like_index: Any,
                          step: Optional[int] = None, *, device=None):
    """Restore (params, index, metadata) onto `device`. `like_*` only
    provide structure and leaf dtypes. With step=None the newest
    checkpoint that passes verification is used (corrupt ones are walked
    past)."""
    mgr = CheckpointManager(root)
    like = {"params": like_params, "index": like_index}
    if step is None:
        step, tree = mgr.restore_latest_verified(like, device=device)
    else:
        tree = mgr.restore(step, like, device=device)
    return tree["params"], tree["index"], mgr.metadata(step)


# ---------------------------------------------------------------------------
# across meshes
# ---------------------------------------------------------------------------
# A rank of a dp x tp grid holds slices (`dist.sharding.shard_by_spec`);
# the checkpoint holds the replicated tree, so it restores onto any mesh:
# the reference's `restore(..., shardings=...)` (its test_dist.py:149
# saves on 4 x 2 and restores onto 2 x 4 and 8 x 1).

def save_gathered(mgr: CheckpointManager, step: int, tree: Any, specs: Any,
                  groups: dict, *, write: bool,
                  metadata: Optional[dict] = None) -> Any:
    """Gather a rank's slices of `tree` whole (`gather_by_spec` over
    `groups`, axis -> process group; collective, so every rank calls it)
    and, where `write`, save the replicated tree. Returns it."""
    from repro_torch.dist.sharding import gather_by_spec
    full = gather_by_spec(tree, specs, groups)
    if write:
        mgr.save(step, full, metadata)
    return full


def restore_sharded(mgr: CheckpointManager, step: int, like: Any,
                    specs: Any, sizes: dict, coords: dict, *,
                    device=None) -> Any:
    """Restore the replicated tree and cut the slices of the rank at
    `coords` on a mesh of `sizes` (the specs of that mesh's degrees)."""
    from repro_torch.dist.sharding import shard_by_spec
    return shard_by_spec(mgr.restore(step, like, device=device), specs,
                         sizes, coords)
