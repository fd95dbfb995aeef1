"""Training guardrails: skip, spike detection, bounded rollback.

Mirrors `src/repro/resilience/guardrails.py` (`GuardrailConfig` :26,
`GuardrailEvent` :35, `TrainGuardrails` :42) line for line: it is host
Python over floats. The train step already refuses to apply a
non-finite update (`launch.steps`: params and optimizer state unchanged,
metrics['skipped'] = 1). This module is the host-side policy layered on
top of that mechanism:

  - every observed loss feeds an EWMA; a finite loss more than
    `spike_factor` x the EWMA (after `warmup_steps` good steps) is a spike
    — the update already happened, so a spike can only be healed by
    rollback, not by skipping;
  - skipped steps and spikes both count as *bad*; `max_consecutive_bad`
    bad steps in a row escalate to a rollback request — the train loop
    restores the newest checkpoint that verifies and replays from there;
  - `max_rollbacks` bounds the total rollback budget so a persistent fault
    (bad data shard, broken kernel) fails loudly instead of livelocking
    the job on restore-replay-crash cycles.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class GuardrailConfig:
    ewma_alpha: float = 0.1       # loss EWMA smoothing
    spike_factor: float = 5.0     # loss > factor * ewma -> spike
    warmup_steps: int = 10        # good steps before spike detection arms
    max_consecutive_bad: int = 3  # bad streak that triggers rollback
    max_rollbacks: int = 5        # total budget before giving up


@dataclasses.dataclass
class GuardrailEvent:
    step: int
    kind: str                     # 'skip' | 'spike' | 'rollback'
    loss: float
    ewma: float


class TrainGuardrails:
    """Host-side loss monitor; `observe` returns the action for this step:
    'ok', 'bad' (skip/spike recorded, keep going) or 'rollback'."""

    def __init__(self, config: Optional[GuardrailConfig] = None):
        self.cfg = config or GuardrailConfig()
        self.ewma: Optional[float] = None
        self.good_steps = 0
        self.consecutive_bad = 0
        self.rollbacks = 0
        self.events: list[GuardrailEvent] = []

    def observe(self, step: int, loss: float, skipped: bool = False) -> str:
        cfg = self.cfg
        ewma = self.ewma if self.ewma is not None else float("nan")
        if skipped or not math.isfinite(loss):
            self.events.append(GuardrailEvent(step, "skip", loss, ewma))
            bad = True
        elif (self.ewma is not None and self.good_steps >= cfg.warmup_steps
              and loss > cfg.spike_factor * max(self.ewma, 1e-9)):
            self.events.append(GuardrailEvent(step, "spike", loss, ewma))
            bad = True
        else:
            self.ewma = loss if self.ewma is None else \
                (1 - cfg.ewma_alpha) * self.ewma + cfg.ewma_alpha * loss
            self.good_steps += 1
            self.consecutive_bad = 0
            return "ok"
        del bad
        self.consecutive_bad += 1
        if self.consecutive_bad < cfg.max_consecutive_bad:
            return "bad"
        # escalate: the streak is over budget — request a rollback and
        # reset the streak so the replayed steps get a fresh allowance
        self.consecutive_bad = 0
        self.rollbacks += 1
        self.events.append(GuardrailEvent(step, "rollback", loss, ewma))
        if self.rollbacks > cfg.max_rollbacks:
            raise RuntimeError(
                f"guardrails: {self.rollbacks} rollbacks exceed the budget "
                f"of {cfg.max_rollbacks} — persistent fault, giving up "
                f"(last loss {loss} at step {step})")
        return "rollback"

    def summary(self) -> dict:
        from repro_torch.utils.metrics import guardrail_summary
        return guardrail_summary(self.events)
