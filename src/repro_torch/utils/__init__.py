"""Metrics helpers (mirrors `src/repro/utils/`)."""
