"""Multi-replica serving router.

Mirrors `src/repro/serve/router.py` (the whole file). One submit surface
over N independent `Engine` replicas:

  - admission is load-weighted: each request goes to the replica with the
    most headroom, free KV pages minus the pages its queued requests will
    take (queue depth in pages, not requests); ties break on replica id,
    so routing is deterministic for a fixed submission sequence;
  - shedding is structured: a request no replica could hold, or one that
    only fits replicas whose bounded queues are full, comes back as a
    shed result carrying the `scheduler.Rejection`; the router never
    raises on bad traffic;
  - `run` drives every replica's resumable `tick` round-robin on one wall
    clock (replica i's decode wave overlaps replica j's prefill chunk in
    program order);
  - `stats()` merges the replicas' stats (wall time the max, not the sum)
    and `summary()` adds per-replica routing and prefix-cache counters;
  - `swap_index` / `schedule_swap` fan a head-state swap out to every
    replica (each behind its own validation gate), and the merged stats
    add up their `swaps` and `swap_rejected`.

Each engine keeps its own page pool, scheduler and prefix cache. On one
card the replicas share it: their waves run one after another on the
card's default stream.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.serve.engine import Engine, EngineStats, RequestResult
from repro_torch.serve.scheduler import Rejection, Request


@dataclasses.dataclass
class RouterStats:
    routed: int = 0                 # requests placed on a replica
    shed: int = 0                   # requests no replica would take
    per_replica: list = dataclasses.field(default_factory=list)


class Router:
    """Load-weighted admission router over N engine replicas."""

    def __init__(self, engines: list[Engine]):
        if not engines:
            raise ValueError("router needs at least one engine replica")
        self.engines = list(engines)
        self.rstats = RouterStats(per_replica=[0] * len(self.engines))

    # ------------------------------------------------------------- admission
    def _score(self, eng: Engine) -> int:
        """Replica headroom in pages: free pool pages minus what the queued
        (not yet admitted) requests will take once admitted."""
        pending = sum(eng.pool.pages_needed(eng.sched._need(r))
                      for r in eng.sched.queue)
        return eng.pool.free_pages - pending

    def route(self, req: Request) -> "int | Rejection":
        """Submit `req` to the replica with the most headroom. Returns the
        replica id, or the last structured Rejection when every replica
        refuses (bounded queue full / oversized)."""
        order = sorted(range(len(self.engines)),
                       key=lambda i: (-self._score(self.engines[i]), i))
        last: Optional[Rejection] = None
        for i in order:
            rej = self.engines[i].sched.submit(req)
            if rej is None:
                self.rstats.routed += 1
                self.rstats.per_replica[i] += 1
                return i
            last = rej
        self.rstats.shed += 1
        return last

    # ------------------------------------------------------------- serving
    def run(self, requests: list[Request]) -> dict[int, RequestResult]:
        """Serve `requests` across all replicas to completion: route them in
        arrival order, then tick every replica round-robin on one clock
        until all are done."""
        results: dict[int, RequestResult] = {}
        for eng in self.engines:
            eng.start_run([])
        t0 = time.perf_counter()
        for req in sorted(requests, key=lambda r: (r.arrival, r.rid)):
            placed = self.route(req)
            if isinstance(placed, Rejection):
                results[req.rid] = RequestResult(
                    req.rid, np.zeros(0, np.int32), [], status="shed",
                    reason=f"{placed.reason}: {placed.detail}")
        while True:
            now = time.perf_counter() - t0
            acts = [eng.tick(now) for eng in self.engines]
            if all(a == "done" for a in acts):
                break
            if all(a in ("done", "idle") for a in acts):
                nxts = [eng.sched.next_arrival() for eng in self.engines]
                nxts = [x for x in nxts if x is not None and x > now]
                time.sleep(min(min(nxts) - now, 0.05) if nxts else 0.001)
        for eng in self.engines:
            results.update(eng.finish_run())
        return results

    # ------------------------------------------------------------- lifecycle
    def swap_index(self, index, validate: bool = True) -> list[bool]:
        """Install `index` on every replica (between their waves). Returns
        each replica's outcome of its validation gate."""
        return [eng.swap_index(index, validate=validate)
                for eng in self.engines]

    def schedule_swap(self, index, at_step: int) -> None:
        """Schedule the swap before decode step `at_step` of every
        replica."""
        for eng in self.engines:
            eng.schedule_swap(index, at_step)

    # ------------------------------------------------------------- telemetry
    def stats(self) -> EngineStats:
        """Merged engine stats across replicas (wall_s the max, not the sum:
        the replicas ran on one shared clock)."""
        out = EngineStats()
        for eng in self.engines:
            s = eng.stats
            out.generated += s.generated
            out.wall_s = max(out.wall_s, s.wall_s)
            out.waves += s.waves
            out.steps += s.steps
            out.shed += s.shed
            out.timeouts += s.timeouts
            out.swap_rejected += s.swap_rejected
            out.swaps += s.swaps
            out.spec_waves += s.spec_waves
            out.spec_drafted += s.spec_drafted
            out.spec_accepted += s.spec_accepted
            out.prefill_chunks += s.prefill_chunks
            out.latencies_s.extend(s.latencies_s)
        out.shed += self.rstats.shed
        return out

    def summary(self) -> dict:
        out = self.stats().summary()
        out["replicas"] = len(self.engines)
        out["routed_per_replica"] = list(self.rstats.per_replica)
        caches = [eng.cache.counters() for eng in self.engines
                  if eng.cache is not None]
        if caches:
            out["cache_hits"] = sum(c["cache_hits"] for c in caches)
            out["cache_misses"] = sum(c["cache_misses"] for c in caches)
        return out
