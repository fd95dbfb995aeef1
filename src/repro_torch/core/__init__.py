"""MIDX sampler core and counter-based noise (mirrors `src/repro/core/`)."""
