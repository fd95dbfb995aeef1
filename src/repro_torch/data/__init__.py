"""Synthetic corpora and the deterministic token stream (copies of
`src/repro/data/`, numpy only)."""
from repro_torch.data.pipeline import (TokenStream, global_batch_iterator,
                                       make_lm_stream)
from repro_torch.data.synthetic import (ZipfLM, recsys_interactions,
                                        xmc_dataset, zipf_tokens)
