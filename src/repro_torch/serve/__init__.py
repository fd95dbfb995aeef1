"""Continuous-batching serving engine over a paged KV pool around the MIDX
decode head, with chunked prefill, the prompt-prefix cache, MIDX
speculative decoding and the multi-replica router. Mirrors
`src/repro/serve/__init__.py`."""
from repro_torch.serve.kv_pool import (CacheMatch, PagePool, PrefixCache,
                                      TRASH_PAGE)
from repro_torch.serve.scheduler import Rejection, Request, Scheduler, SlotState
from repro_torch.serve.engine import Engine, EngineStats, RequestResult
from repro_torch.serve.router import Router, RouterStats
