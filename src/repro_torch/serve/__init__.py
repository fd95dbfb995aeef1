"""Continuous-batching serving engine over a paged KV pool around the MIDX
decode head. Mirrors `src/repro/serve/__init__.py`; the router and the
DESIGN §13 serving tier are later slices."""
from repro_torch.serve.kv_pool import PagePool, TRASH_PAGE
from repro_torch.serve.scheduler import Rejection, Request, Scheduler, SlotState
from repro_torch.serve.engine import Engine, EngineStats, RequestResult
