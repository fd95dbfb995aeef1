"""Index lifecycle: drift metrics, the refresh policies and the overlapped
swap (DESIGN §8).

Mirrors `src/repro/index/lifecycle.py`: `drift_metrics` (:41),
`refresh_adaptive` (:79), `refresh_with_policy` (:112) with
`_refresh_fixed` (:131), `RefreshEvent` (:146) and `IndexLifecycle`
(:163-266: the pending rebuild, `in_flight`, `abort`, `_complete` with the
validation gate against the live state, `step`, `flush`, `summary`), over
any head state.

Departures:
  - randomness: where the reference folds a JAX key with the dispatch
    step, the lifecycle hands the refresh function an int seed,
    hash(seed, step), from which it seeds a `torch.Generator`; two runs
    that refresh at the same steps build identical indexes;
  - the drift branch: the reference takes it on the device with
    `lax.cond`, without a host round-trip. torch has no such branch, so
    `refresh_adaptive` copies the probe's decision (one boolean) to the
    host and runs only the branch it chose;
  - the overlapped refresh (`lag > 0`). The reference leaves its rebuild
    in flight behind JAX's asynchronous dispatch; its arrays are
    immutable. Here the optimizer updates params in place and a rebuild
    syncs the host (the drift decision, `bincount`'s size, the metrics),
    so the lifecycle builds the refresh of step s at dispatch, on the
    loop's thread and stream, and holds the result until the swap after
    step s + lag (or `flush`). The rebuild reads step s's params before
    step s + 1's update is issued, so the result is bit for bit the
    synchronous refresh of step s's params with step s's seed, on every
    device. The reference's schedule, staleness bound and validation at
    completion stay; what is not kept is the overlap itself: a worker
    thread on a side CUDA stream measured slower than lag 0 on
    llama3.2-1b, the refit being host-bound and the worker taking the GIL
    from the steps it ran beside (PERF.md §6).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.core import noise
from repro_torch.index.build import MultiIndex, reassign, refresh
from repro_torch.index.quantization import assign_against, reconstruct
from repro_torch.resilience.validate import validate_state
from repro_torch.utils.metrics import refresh_summary

REFRESH_POLICIES = ("fixed", "drift")


@torch.no_grad()
def drift_metrics(index: MultiIndex,
                  class_embeddings: torch.Tensor) -> dict[str, torch.Tensor]:
    """Drift of the class table relative to the index, without a refit:
      reassigned_frac  fraction of classes whose (k1, k2) changes under the
                       frozen codebooks;
      codeword_drift   relative movement of the stage-1 codebook after one
                       Lloyd update against the new table (an emptied
                       codeword keeps its old value)."""
    a1, a2 = assign_against(index.kind, index.codebook1, index.codebook2,
                            class_embeddings)
    reassigned = (a1 != index.assign1) | (a2 != index.assign2)
    frac = torch.mean(reassigned.float())
    x1 = (class_embeddings[:, : class_embeddings.shape[-1] // 2]
          if index.kind == "pq" else class_embeddings)
    one_hot = torch.nn.functional.one_hot(a1, index.num_codewords).to(x1.dtype)
    counts = torch.sum(one_hot, dim=0)
    cb1_next = torch.where((counts > 0)[:, None],
                           (one_hot.T @ x1)
                           / torch.clamp(counts, min=1.0)[:, None],
                           index.codebook1)
    num = torch.sqrt(torch.sum((cb1_next - index.codebook1) ** 2))
    den = torch.sqrt(torch.sum(index.codebook1 ** 2)) + 1e-12
    return {"reassigned_frac": frac, "codeword_drift": num / den}


def _distortion(index: MultiIndex, class_embeddings: torch.Tensor):
    recon = reconstruct(index.kind, index.codebook1, index.codebook2,
                        index.assign1, index.assign2)
    return torch.mean(torch.sum((class_embeddings - recon) ** 2, dim=-1))


@torch.no_grad()
def refresh_adaptive(index: MultiIndex, gen: torch.Generator,
                     class_embeddings: torch.Tensor, *, iters: int = 10,
                     threshold: float = 0.1):
    """Drift-triggered refresh: the reassign-only rebuild (frozen
    codebooks, `build.reassign`) while both drift metrics stay at or below
    `threshold`, the warm-started full refit (`build.refresh`) above it.
    Returns (new_index, metrics). The branch is a host decision on the
    probe (one device-to-host copy of a boolean), where the reference
    takes it inside `lax.cond`; the cheap branch draws nothing from `gen`."""
    d = drift_metrics(index, class_embeddings)
    do_full = bool((d["reassigned_frac"] > threshold)
                   | (d["codeword_drift"] > threshold))
    if do_full:
        idx = refresh(index, gen, class_embeddings, iters=iters)
    else:
        idx = reassign(index, class_embeddings)
    dev = class_embeddings.device
    return idx, {**d, "did_full": torch.tensor(float(do_full), device=dev),
                 "distortion": _distortion(idx, class_embeddings)}


@torch.no_grad()
def refresh_with_policy(index: MultiIndex, gen: torch.Generator,
                        class_embeddings: torch.Tensor, *, iters: int = 10,
                        policy: str = "fixed", threshold: float = 0.1):
    """One refresh event under `policy`. Returns (new_index, metrics).

    'fixed'  the cadence-only baseline: every event is a warm-started full
             refit; the drift metrics are still reported for the step log.
    'drift'  `refresh_adaptive`: the full refit only when drift exceeds
             `threshold`."""
    if policy not in REFRESH_POLICIES:
        raise ValueError(f"refresh_policy must be one of {REFRESH_POLICIES}, "
                         f"got {policy!r}")
    if policy == "drift":
        return refresh_adaptive(index, gen, class_embeddings, iters=iters,
                                threshold=threshold)
    d = drift_metrics(index, class_embeddings)
    idx = refresh(index, gen, class_embeddings, iters=iters)
    dev = class_embeddings.device
    return idx, {**d, "did_full": torch.ones((), device=dev),
                 "distortion": _distortion(idx, class_embeddings)}


@dataclasses.dataclass
class RefreshEvent:
    """One completed refresh, as reported to the step log."""
    step: int                 # step whose params the rebuild used
    swap_step: int            # step after which the new state went live
    seconds: float            # host seconds the refresh held the loop's
                              # thread: the build at dispatch (the lag
                              # defers only the swap) and the validation
    metrics: dict             # drift / did_full / distortion (floats)
    rejected: bool = False    # validation kept the old state
    reasons: tuple = ()       # why (resilience.validate strings)

    @property
    def mode(self) -> str:
        if self.rejected:
            return "rejected"
        return "full" if self.metrics.get("did_full", 1.0) >= 0.5 \
            else "reassign"


def _tensors(tree):
    """Every tensor of a head state or params tree: dataclass fields (the
    MultiIndex, the QuantHeadState), dict values, list items."""
    if torch.is_tensor(tree):
        yield tree
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def clone_tensors(tree):
    """A copy of a params tree or a head state, every tensor cloned (dicts,
    lists, namedtuples, dataclasses such as the MultiIndex)."""
    if torch.is_tensor(tree):
        return tree.detach().clone()
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: clone_tensors(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: clone_tensors(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(clone_tensors(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tensors(v) for v in tree)
    return tree


@dataclasses.dataclass
class _Pending:
    step: int                 # dispatch step
    ready_at: int             # swap after this step
    state: Any                # the rebuilt head state
    metrics: dict             # its metrics (floats)
    seconds: float            # host seconds the build took


class IndexLifecycle:
    """Double-buffered head-state refresh driver for the train loop.

    `refresh_fn(params, state, seed) -> (state, metrics)` is dispatched
    after every `every`-th step with seed = hash(base_seed, step). The
    state is any head state: the MIDX index (or the quantized head's
    QuantHeadState around it) or a proposal's state (the RFF feature
    re-map). With `lag > 0` the rebuild of step s goes live after step
    s + lag (or at `flush`) while steps s+1..s+lag train against the old
    state, so the live state is at most `every + lag` steps stale; the
    rebuild itself runs at dispatch (module docstring). `lag = 0` is the
    synchronous swap at dispatch. Each rebuilt state passes
    `validate(new, like=live)` (default `resilience.validate_state`; the
    vocab-parallel run's check agrees across ranks) at completion before
    it is swapped in; a degenerate one is rejected and the live state
    kept."""

    def __init__(self, refresh_fn: Callable, *, every: int, base_seed: int,
                 lag: int = 0, enabled: bool = True,
                 validate: Optional[Callable] = None):
        if lag < 0:
            raise ValueError(f"lag must be >= 0, got {lag}")
        self.refresh_fn = refresh_fn
        self.validate = validate or validate_state
        self.every = every
        self.lag = lag
        self.base_seed = base_seed
        self.enabled = enabled and bool(every)
        self.events: list[RefreshEvent] = []
        self._pending: Optional[_Pending] = None

    @property
    def in_flight(self) -> bool:
        return self._pending is not None

    def _dispatch(self, step: int, params: Any, state: Any) -> None:
        seed = int(noise.hash_bits(self.base_seed, step, 0, 0))
        t0 = time.perf_counter()
        new, metrics = self.refresh_fn(params, state, seed)
        metrics = {k: float(v) for k, v in metrics.items()}
        self._pending = _Pending(step, step + self.lag, new, metrics,
                                 time.perf_counter() - t0)

    def _complete(self, swap_step: int, current: Any):
        p, self._pending = self._pending, None
        t0 = time.perf_counter()
        reasons = tuple(self.validate(p.state, like=current))
        ev = RefreshEvent(p.step, swap_step,
                          p.seconds + time.perf_counter() - t0, p.metrics,
                          rejected=bool(reasons), reasons=reasons)
        self.events.append(ev)
        return (current if reasons else p.state), ev

    def step(self, step: int, params: Any,
             index: Any) -> tuple[Any, Optional[RefreshEvent]]:
        """Advance after train step `step`: returns the head state the next
        step uses, and a RefreshEvent when a rebuild went live (or was
        rejected) this step."""
        if not self.enabled:
            return index, None
        event = None
        if self._pending is not None and step >= self._pending.ready_at:
            index, event = self._complete(step, index)
        if (step + 1) % self.every == 0 and self._pending is None:
            self._dispatch(step, params, index)
            if self.lag == 0:
                index, event = self._complete(step, index)
        return index, event

    def flush(self, step: int,
              index: Any) -> tuple[Any, Optional[RefreshEvent]]:
        """Force-complete an in-flight refresh (checkpoint boundaries: the
        saved state must be a function of the saved params, not of a
        rebuild a restore would lose)."""
        if self._pending is None:
            return index, None
        return self._complete(step, index)

    def abort(self) -> None:
        """Discard an in-flight refresh without swapping it in (rollback:
        it was built from params that no longer exist)."""
        self._pending = None

    def summary(self) -> dict:
        return refresh_summary(self.events)
