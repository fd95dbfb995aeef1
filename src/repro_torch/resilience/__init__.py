"""Head-state validation (mirrors `src/repro/resilience/`; the fault
injector and the train guardrails are not ported yet)."""
from repro_torch.resilience.validate import validate_index, validate_state
