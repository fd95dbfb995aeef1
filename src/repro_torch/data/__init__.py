"""Synthetic corpora and the deterministic token stream (copies of
`src/repro/data/`, numpy only)."""
from repro_torch.data.pipeline import TokenStream, make_lm_stream
from repro_torch.data.synthetic import ZipfLM, zipf_tokens
