"""repro_torch.resilience — deterministic fault injection, recovery
guardrails and head-state validation (mirrors `src/repro/resilience/`).

  faults      seeded FaultInjector — NaN/Inf/spiked losses, slow steps,
              kill-mid-save, checkpoint byte corruption, degenerate refresh
              output, serve-side floods and oversized requests; every fault
              reproducible from (seed, step).
  guardrails  TrainGuardrails — EWMA spike detection + bounded
              consecutive-bad-step escalation to checkpoint rollback,
              layered on the in-step non-finite skip guard.
  validate    validate_state / validate_index — the gate a new head state
              must pass before the index lifecycle installs it.
"""
from repro_torch.resilience.faults import (FaultInjector, FaultSpec,
                                           InjectedFault, poison_state)
from repro_torch.resilience.guardrails import (GuardrailConfig,
                                               GuardrailEvent,
                                               TrainGuardrails)
from repro_torch.resilience.validate import validate_index, validate_state

__all__ = [
    "FaultInjector", "FaultSpec", "InjectedFault", "poison_state",
    "GuardrailConfig", "GuardrailEvent", "TrainGuardrails",
    "validate_index", "validate_state",
]
