"""Serving latency and training guardrail metrics.

Mirrors `src/repro/utils/metrics.py`: `percentiles` (:37),
`latency_summary` (:45), `refresh_summary` (:93) and `guardrail_summary`
(:123) only — the ranking, load-test and speculative summaries arrive with
the slices that need them.
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


def refresh_summary(events) -> dict[str, float]:
    """Aggregate index-refresh events from the train loop (DESIGN §8):
    the total host seconds spent on refreshes, the full-refit /
    reassign-only / rejected split and the mean drift — the numbers the
    refresh-policy comparison is judged on. `events` are
    `index.lifecycle.RefreshEvent`s (anything with .seconds, .mode,
    .metrics)."""
    events = list(events)
    n = len(events)
    if n == 0:
        return {"refreshes": 0, "refresh_s": 0.0, "full_refits": 0,
                "reassign_only": 0, "rejected": 0,
                "mean_reassigned_frac": float("nan"),
                "mean_codeword_drift": float("nan")}
    full = sum(1 for e in events if e.mode == "full")
    rejected = sum(1 for e in events if getattr(e, "rejected", False))
    return {
        "refreshes": n,
        "refresh_s": float(sum(e.seconds for e in events)),
        "full_refits": full,
        "reassign_only": n - full - rejected,
        "rejected": rejected,
        "mean_reassigned_frac": float(np.mean(
            [e.metrics.get("reassigned_frac", np.nan) for e in events])),
        "mean_codeword_drift": float(np.mean(
            [e.metrics.get("codeword_drift", np.nan) for e in events])),
    }


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
