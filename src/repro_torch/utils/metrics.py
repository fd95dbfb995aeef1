"""Serving latency and training guardrail metrics.

Mirrors `src/repro/utils/metrics.py`: `percentiles` (:37),
`latency_summary` (:45) and `guardrail_summary` (:123) only — the ranking,
load-test, speculative and refresh summaries arrive with the slices that
need them.
"""
from __future__ import annotations

import numpy as np


def percentiles(xs, qs=(50, 95, 99)) -> dict[int, float]:
    """{q: percentile} over a sample; empty input gives NaNs."""
    if len(xs) == 0:
        return {int(q): float("nan") for q in qs}
    arr = np.asarray(xs, np.float64)
    return {int(q): float(np.percentile(arr, q)) for q in qs}


def latency_summary(latencies_s, qs=(50, 95, 99),
                    counters: dict | None = None) -> dict[str, float]:
    """Per-token latency summary in milliseconds, with optional counters
    (shed / timeouts) merged into the same report."""
    pct = percentiles(np.asarray(latencies_s, np.float64) * 1e3, qs)
    out = {f"p{q}_ms": v for q, v in pct.items()}
    if counters:
        out.update({k: float(v) for k, v in counters.items()})
    return out


def guardrail_summary(events) -> dict[str, float]:
    """Aggregate TrainGuardrails events: how many updates the non-finite
    guard skipped, how many finite losses tripped the EWMA spike detector,
    and how many streaks escalated to a rollback."""
    kinds = [e.kind for e in events]
    return {
        "guard_events": len(kinds),
        "skips": kinds.count("skip"),
        "spikes": kinds.count("spike"),
        "rollbacks": kinds.count("rollback"),
    }
