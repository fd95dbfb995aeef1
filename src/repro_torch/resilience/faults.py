"""Deterministic fault injection.

Mirrors `src/repro/resilience/faults.py` (`FaultSpec` :46, `poison_state`
:68, `FaultInjector` :91 with `loss_scale`, `maybe_sleep`,
`wrap_refresh`, `checkpoint_hook` / `attach_checkpoint`,
`corrupt_checkpoint`, `flood` and `oversized_request`). Every fault is a
pure function of `(seed, step)`: its draws come from
`np.random.default_rng([seed, step])`, the reference's own streams, so
the port corrupts the same bytes and floods the same requests as the
reference for one seed, and never touches the training streams — a
fault-free plan leaves a run's bits unchanged.

Fault surface:
  train        'nan_loss' / 'inf_loss' (the loss, and through the chain
               rule every gradient, made non-finite by the batch's
               `_fault_scale`, `launch/steps.py`), 'loss_spike' (a finite
               ×`arg` blow-up), 'slow_step' (a host sleep).
  checkpoint   'kill_mid_save' (InjectedFault from a save phase hook:
               'arrays' | 'tree' | 'committed' | 'swap'), and
               `corrupt_checkpoint`: 'bitflip', 'silent', 'truncate'.
  index        'degenerate_refresh' (the refresh output rewritten: 'nan'
               codebooks, 'zero' codebooks, 'empty' clusters).
  serve        `flood` / `oversized_request`, deterministic traffic.

`poison_state` maps the port's head states: a `MultiIndex` (int64 index
fields), a quantized head's `QuantHeadState` (its index and its low-bit
twins: fp8 leaves are floats, int8 ones integers, as in the reference's
tree map) or a proposal's dict of tensors.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.index.build import MultiIndex
from repro_torch.index.quantized import QUANT_FIELDS, QuantHeadState


class InjectedFault(RuntimeError):
    """Raised by kill-style faults (e.g. mid-save crash simulation)."""


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault.

    kind   'nan_loss' | 'inf_loss' | 'loss_spike' | 'slow_step' |
           'degenerate_refresh' | 'kill_mid_save'
    step   train step (or save step for 'kill_mid_save') the fault fires at;
           -1 = the first opportunity.
    arg    spike factor ('loss_spike'), sleep seconds ('slow_step').
    mode   sub-mode: degenerate_refresh 'nan'|'zero'|'empty';
           kill_mid_save save phase 'arrays'|'tree'|'committed'|'swap'.
    once   one-shot (default): after firing, the spec is spent — a rolled
           back trajectory that revisits the step replays it clean, so
           recovery cannot livelock on its own fault.
    """
    kind: str
    step: int = -1
    arg: float = 0.0
    mode: str = ""
    once: bool = True
    fired_at: Optional[int] = None


def poison_state(state, mode: str = "nan"):
    """A degenerate copy of a refresh output (a head state).

    'nan'    every float leaf becomes NaN — the NaN-poisoned codebook.
    'zero'   every float leaf becomes 0 — zero codebooks, zero residuals.
    'empty'  integer CSR leaves (counts/offsets) zeroed too: an index whose
             clusters are all empty (counts no longer sum to N).
    """
    if mode not in ("nan", "zero", "empty"):
        raise ValueError(f"unknown degenerate mode {mode!r}")

    def leaf(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.is_floating_point():
            return torch.full_like(x, float("nan") if mode == "nan" else 0.0)
        if mode == "empty" and not x.dtype.is_complex and x.dtype != torch.bool:
            return torch.zeros_like(x)
        return x

    def go(t):
        if isinstance(t, MultiIndex):
            return dataclasses.replace(t, **{
                f.name: go(getattr(t, f.name))
                for f in dataclasses.fields(t) if f.name != "kind"})
        if isinstance(t, QuantHeadState):
            return dataclasses.replace(t, **{f: go(getattr(t, f))
                                             for f in QUANT_FIELDS})
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(go(v) for v in t)
        return leaf(t)

    return go(state)


class FaultInjector:
    """Seeded, deterministic fault injector driven by the train/serve loops.

    The loops push the current step via `note_step`; hooks pull matching
    specs from the plan. `fired` records (kind, step) tuples for assertions
    and the chaos report."""

    def __init__(self, seed: int, plan: Sequence[FaultSpec] = ()):
        self.seed = int(seed)
        self.plan = [dataclasses.replace(s) for s in plan]
        self.fired: list[tuple[str, int]] = []
        self._step = 0

    # ---------------------------------------------------------------- plan
    def note_step(self, step: int) -> None:
        """Advance the injector clock (train loop calls once per step)."""
        self._step = int(step)

    def rng(self, step: Optional[int] = None) -> np.random.Generator:
        """The (seed, step)-keyed stream all byte/traffic draws come from."""
        return np.random.default_rng(
            [self.seed, self._step if step is None else int(step)])

    def _take(self, kinds, step: int) -> Optional[FaultSpec]:
        for spec in self.plan:
            if spec.kind not in kinds:
                continue
            if spec.once and spec.fired_at is not None:
                continue
            if spec.step not in (-1, step):
                continue
            spec.fired_at = step
            self.fired.append((spec.kind, step))
            return spec
        return None

    # ---------------------------------------------------------------- train
    def loss_scale(self, step: int) -> float:
        """Multiplier applied to the loss at `step` (1.0 = no fault).

        NaN/Inf poison both the loss and, through the chain rule, every
        gradient leaf — exactly the failure the non-finite guard must skip.
        A finite spike factor exercises the EWMA detector instead."""
        spec = self._take(("nan_loss", "inf_loss", "loss_spike"), step)
        if spec is None:
            return 1.0
        if spec.kind == "nan_loss":
            return float("nan")
        if spec.kind == "inf_loss":
            return float("inf")
        return float(spec.arg) if spec.arg else 1e4

    def maybe_sleep(self, step: int) -> float:
        """'slow_step': stall the host thread, return seconds slept."""
        spec = self._take(("slow_step",), step)
        if spec is None:
            return 0.0
        secs = float(spec.arg) if spec.arg else 0.05
        time.sleep(secs)
        return secs

    # ---------------------------------------------------------------- index
    def wrap_refresh(self, refresh_fn):
        """Wrap an IndexLifecycle refresh_fn so a 'degenerate_refresh' spec
        rewrites its output at the armed step (clocked by note_step)."""

        def wrapped(params, state, seed):
            new_state, metrics = refresh_fn(params, state, seed)
            spec = self._take(("degenerate_refresh",), self._step)
            if spec is not None:
                new_state = poison_state(new_state, spec.mode or "nan")
            return new_state, metrics

        return wrapped

    # ------------------------------------------------------------ checkpoint
    def checkpoint_hook(self):
        """Hook for CheckpointManager.fault_hook: raises InjectedFault from
        the armed save phase — the kill-mid-save crash simulation."""

        def hook(phase: str, step: int) -> None:
            for spec in self.plan:
                if spec.kind != "kill_mid_save":
                    continue
                if spec.once and spec.fired_at is not None:
                    continue
                if spec.step not in (-1, step) or spec.mode != phase:
                    continue
                spec.fired_at = step
                self.fired.append((spec.kind, step))
                raise InjectedFault(
                    f"injected crash in save(step={step}) at phase {phase!r}")

        return hook

    def attach_checkpoint(self, manager) -> None:
        manager.fault_hook = self.checkpoint_hook()

    def corrupt_checkpoint(self, root: str, step: Optional[int] = None, *,
                           mode: str = "bitflip", nbytes: int = 16) -> int:
        """Deterministically damage the arrays.npz of a committed step dir.

        'bitflip'   XOR `nbytes` bytes at rng-drawn offsets — numpy's zip
                    member CRC rejects the whole file on load (loud).
        'silent'    rewrite one rng-chosen leaf with negated values and
                    re-save — the archive is self-consistent, so only the
                    per-leaf CRC32 recorded in tree.json catches it.
        'truncate'  cut the file in half — torn write.

        Returns the step that was corrupted."""
        from repro_torch.checkpoint.manager import CheckpointManager
        mgr = CheckpointManager.__new__(CheckpointManager)  # paths only
        mgr.root = root
        if step is None:
            steps = []
            for name in os.listdir(root):
                if name.startswith("step_") and \
                        not name.endswith((".tmp", ".old")):
                    steps.append(int(name.split("_")[1]))
            if not steps:
                raise FileNotFoundError(f"no checkpoints under {root}")
            step = max(steps)
        path = os.path.join(mgr._dir(step), "arrays.npz")
        rng = self.rng(step)
        if mode == "bitflip":
            with open(path, "r+b") as f:
                data = bytearray(f.read())
                # skip the zip local header region so the archive still
                # opens and the damage lands in member data
                offs = rng.integers(128, max(len(data), 129), size=nbytes)
                for o in offs:
                    data[int(o) % len(data)] ^= 0xFF
                f.seek(0)
                f.write(data)
        elif mode == "silent":
            with np.load(path) as z:
                leaves = {k: z[k] for k in z.files}
            victim = sorted(leaves)[int(rng.integers(0, len(leaves)))]
            leaves[victim] = -leaves[victim] - 1
            np.savez(path, **leaves)
        elif mode == "truncate":
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                f.truncate(max(size // 2, 1))
        else:
            raise ValueError(f"unknown corruption mode {mode!r}")
        self.fired.append((f"corrupt_checkpoint:{mode}", step))
        return step

    # ---------------------------------------------------------------- serve
    def flood(self, num: int, *, plen: int = 8, max_new: int = 8,
              vocab: int = 256, deadline: Optional[float] = None,
              start_rid: int = 0, seed_step: int = 0) -> list:
        """A deterministic burst of `num` simultaneous requests (arrival 0)
        — the overload a bounded queue must shed instead of raising."""
        from repro_torch.serve.scheduler import Request
        rng = self.rng(seed_step)
        return [Request(rid=start_rid + i,
                        tokens=rng.integers(0, vocab, size=plen)
                        .astype(np.int32),
                        max_new=max_new, seed=self.seed,
                        deadline=deadline)
                for i in range(num)]

    def oversized_request(self, *, factor: int = 4, rid: int = 10 ** 6,
                          slot_capacity: int = 256):
        """A request `factor`x larger than a slot can ever hold — must be
        shed with a structured reason, never crash admission."""
        from repro_torch.serve.scheduler import Request
        rng = self.rng(0)
        plen = slot_capacity * factor
        return Request(rid=rid,
                       tokens=rng.integers(0, 256, size=plen)
                       .astype(np.int32),
                       max_new=1, seed=self.seed)

    # --------------------------------------------------------------- report
    def summary(self) -> dict:
        return {"seed": self.seed,
                "planned": len(self.plan),
                "fired": list(self.fired),
                "unfired": [(s.kind, s.step) for s in self.plan
                            if s.fired_at is None]}
