"""Ranking, serving-latency and training guardrail metrics (paper
§6.3–6.4).

A copy of `src/repro/utils/metrics.py`, numpy only (the reference module
imports jax): `rank_of_target` (:8), `recall_at_k` (:14), `ndcg_at_k`
(:18), `precision_at_k` (:24), `perplexity` (:33), `percentiles` (:37),
`latency_summary` (:45), `serving_load_summary` (:59),
`spec_decode_summary` (:85), `refresh_summary` (:93) and
`guardrail_summary` (:123).
"""
from __future__ import annotations

import numpy as np


def rank_of_target(scores: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """scores [B, N]; targets [B] -> 0-based rank of the target per row."""
    t_score = np.take_along_axis(scores, targets[:, None], axis=1)
    return (scores > t_score).sum(axis=1)


def recall_at_k(scores: np.ndarray, targets: np.ndarray, k: int) -> float:
    return float((rank_of_target(scores, targets) < k).mean())


def ndcg_at_k(scores: np.ndarray, targets: np.ndarray, k: int) -> float:
    ranks = rank_of_target(scores, targets)
    gains = np.where(ranks < k, 1.0 / np.log2(ranks + 2.0), 0.0)
    return float(gains.mean())


def precision_at_k(scores: np.ndarray, label_sets: list[set[int]],
                   k: int) -> float:
    """Multi-label P@k: fraction of the top-k that are true labels."""
    topk = np.argsort(-scores, axis=1)[:, :k]
    hits = [len(set(row.tolist()) & labels) / k
            for row, labels in zip(topk, label_sets)]
    return float(np.mean(hits))


def perplexity(mean_ce: float) -> float:
    return float(np.exp(mean_ce))


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


def serving_load_summary(results, wall_s: float,
                         deadline_ms: float | None = None) -> dict[str, float]:
    """Open-loop load-test summary over a dict of engine `RequestResult`s
    (DESIGN §13): admitted / shed / timeout split, token throughput, and
    goodput — tokens that landed inside their request's latency budget
    (all ok-status tokens when `deadline_ms` is None, since shed and
    timed-out requests already fell out of the ok bucket)."""
    rs = list(results.values())
    ok = [r for r in rs if r.status == "ok"]
    shed = sum(1 for r in rs if r.status == "shed")
    timeout = sum(1 for r in rs if r.status == "timeout")
    tokens = sum(len(r.tokens) for r in ok)
    good = tokens
    if deadline_ms is not None:
        good = sum(
            sum(1 for lat in r.latencies_s if lat * 1e3 <= deadline_ms)
            for r in ok)
    lats = [lat for r in ok for lat in r.latencies_s]
    out = {"admitted": len(ok), "shed": shed, "timeouts": timeout,
           "tokens": tokens,
           "tok_s": tokens / max(wall_s, 1e-9),
           "goodput_tok_s": good / max(wall_s, 1e-9)}
    out.update(latency_summary(lats, qs=(50, 99)))
    return out


def spec_decode_summary(stats) -> dict[str, float]:
    """Speculative-decoding report off an EngineStats (DESIGN §13)."""
    return {"spec_waves": stats.spec_waves,
            "spec_drafted": stats.spec_drafted,
            "spec_accepted": stats.spec_accepted,
            "accept_rate": stats.accept_rate()}


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
