"""Index lifecycle: drift metrics, the refresh policy and the swap.

Mirrors `src/repro/index/lifecycle.py` (`drift_metrics` :41,
`refresh_with_policy` :112 with `_refresh_fixed` :131, `RefreshEvent` :146,
`IndexLifecycle` :163 with `abort` :202 and `flush` :255, over any head
state) for what single-device
training needs: the `fixed`
policy (a warm-started full refit at every event) and the synchronous swap
(`lag=0`). The `drift` policy (reassign-only with escalation) and `lag>0`
(a rebuild overlapped with training, on a side CUDA stream in the port)
raise NotImplementedError (ROADMAP.md Queue 1 item 9).

Departure: where the reference folds a JAX key with the dispatch step, the
lifecycle hands the refresh function an int seed, hash(seed, step), from
which it seeds a `torch.Generator`; two runs that refresh at the same steps
build identical indexes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.core import noise
from repro_torch.index.build import MultiIndex, refresh
from repro_torch.index.quantization import assign_against, reconstruct
from repro_torch.resilience.validate import validate_state

REFRESH_POLICIES = ("fixed", "drift")


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md "
                               "Queue 1 item 9)")


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
def refresh_with_policy(index: MultiIndex, gen: torch.Generator,
                        class_embeddings: torch.Tensor, *, iters: int = 10,
                        policy: str = "fixed", threshold: float = 0.1):
    """One refresh event under `policy`. Returns (new_index, metrics).
    'fixed': a warm-started full refit every event; drift metrics are still
    reported for the step log."""
    if policy not in REFRESH_POLICIES:
        raise ValueError(f"refresh_policy must be one of {REFRESH_POLICIES}, "
                         f"got {policy!r}")
    if policy == "drift":
        raise _unported("the 'drift' refresh policy")
    d = drift_metrics(index, class_embeddings)
    idx = refresh(index, gen, class_embeddings, iters=iters)
    metrics = {**d, "did_full": torch.ones(()),
               "distortion": _distortion(idx, class_embeddings)}
    return idx, metrics


@dataclasses.dataclass
class RefreshEvent:
    """One completed refresh, as reported to the step log."""
    step: int                 # step whose params the rebuild used (the
                              # index goes live for step + 1)
    seconds: float            # host wall time of the refresh
    metrics: dict             # drift / did_full / distortion (floats)
    rejected: bool = False    # validation kept the old state
    reasons: tuple = ()       # why (resilience.validate strings)

    @property
    def mode(self) -> str:
        if self.rejected:
            return "rejected"
        return "full" if self.metrics.get("did_full", 1.0) >= 0.5 \
            else "reassign"


class IndexLifecycle:
    """Head-state refresh schedule for the train loop, synchronous (`lag=0`).

    `refresh_fn(params, state, seed) -> (state, metrics)` runs after every
    `every`-th step with seed = hash(base_seed, step). The state is any
    head state: the MIDX index or a proposal's state (the RFF feature
    re-map). Each rebuilt state passes `resilience.validate_state` against
    the live one before it is swapped in (or `validate(new, like)`, the
    vocab-parallel run's check, which every rank must agree on); a
    degenerate one is rejected and the old state kept."""

    def __init__(self, refresh_fn: Callable, *, every: int, base_seed: int,
                 lag: int = 0, enabled: bool = True,
                 validate: Optional[Callable] = None):
        if lag < 0:
            raise ValueError(f"lag must be >= 0, got {lag}")
        if lag > 0:
            raise _unported("an overlapped refresh (refresh_lag > 0)")
        self.refresh_fn = refresh_fn
        self.validate = validate or validate_state
        self.every = every
        self.base_seed = base_seed
        self.enabled = enabled and bool(every)
        self.events: list[RefreshEvent] = []

    def step(self, step: int, params: Any,
             index: Any) -> tuple[Any, Optional[RefreshEvent]]:
        """Advance after train step `step`: returns the head state the next
        step uses, and the RefreshEvent when a refresh ran."""
        if not self.enabled or (step + 1) % self.every:
            return index, None
        t0 = time.perf_counter()
        seed = int(noise.hash_bits(self.base_seed, step, 0, 0))
        new_index, metrics = self.refresh_fn(params, index, seed)
        metrics = {k: float(v) for k, v in metrics.items()}
        reasons = tuple(self.validate(new_index, like=index))
        ev = RefreshEvent(step, time.perf_counter() - t0, metrics,
                          rejected=bool(reasons), reasons=reasons)
        self.events.append(ev)
        return (index if reasons else new_index), ev

    def abort(self) -> None:
        """Discard an in-flight refresh (rollback). At lag 0 a refresh
        completes within `step`, so nothing is ever in flight; the train
        loop calls it where the reference does."""

    def flush(self, step: int,
              index: Any) -> tuple[Any, Optional[RefreshEvent]]:
        """Force-complete an in-flight refresh before a checkpoint; at lag 0
        there is none, so the live state comes back unchanged."""
        del step
        return index, None
