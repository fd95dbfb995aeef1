"""Command-line entry points (mirrors `src/repro/launch/`)."""
