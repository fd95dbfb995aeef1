"""Continuous-batching scheduler (DESIGN §5).

A copy of `src/repro/serve/scheduler.py` (numpy-only; copied, not imported,
because `repro/__init__.py` imports jax). The port's engine uses it
unchanged; its prefix cache waits for the chunked-prefill slice.

FIFO admission into `cfg.serve.max_slots` decode slots, gated by page
availability in the shared `kv_pool.PagePool`. Admission is strict FIFO (no
overtaking: a large request at the queue head blocks smaller ones behind it,
so no request can starve). Finished slots are recycled mid-flight — the
engine calls `admit` again after every decode step that frees a slot.

Resilience (DESIGN §11): `submit` never raises on bad traffic — a request
that can never fit a slot/pool, or that arrives when the bounded queue is
full, comes back as a structured `Rejection` the engine reports instead of
crashing admission. Requests carry an optional `deadline` (seconds on the
same clock as `arrival`); `drop_expired` sheds queued requests whose
deadline passed before they were ever admitted, and the engine retires
active over-deadline slots with partial results.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np

from repro_torch.serve.kv_pool import PagePool, PrefixCache


@dataclasses.dataclass
class Request:
    """One generation request. `seed`/`rid` define the request's private PRNG
    stream — outputs depend only on (rid, seed, tokens), never on batch
    composition (DESIGN §5)."""
    rid: int
    tokens: np.ndarray              # [plen] int32 prompt
    max_new: int                    # tokens to generate (incl. first)
    seed: int = 0
    arrival: float = 0.0            # open-loop arrival time (s since start)
    deadline: Optional[float] = None  # same clock as arrival; None = never
    image_emb: Optional[np.ndarray] = None   # vlm: [num_image_tokens, D]
    frames: Optional[np.ndarray] = None      # audio: [encoder_seq, D]


@dataclasses.dataclass(frozen=True)
class Rejection:
    """A request the scheduler refused to take (DESIGN §11).

    reason  'oversized_slot' | 'oversized_pool' | 'queue_full' | 'expired'
    """
    rid: int
    reason: str
    detail: str = ""


@dataclasses.dataclass
class SlotState:
    """A request bound to a decode slot."""
    slot: int
    request: Request
    key: object                     # per-request PRNG key (engine fills in)
    pos: int                        # next cache write position
    out: list = dataclasses.field(default_factory=list)
    latencies: list = dataclasses.field(default_factory=list)
    # chunked-prefill progress (DESIGN §13): next prompt position still to
    # prefill. == len(request.tokens) means the prompt is fully prefilled
    # (always true under the legacy whole-prompt batched prefill path).
    prefill_pos: int = 0
    prefill_s: float = 0.0          # wall seconds spent in prefill chunks
    shared_tokens: int = 0          # prompt tokens reused from the prefix cache
    # speculative-decoding accounting (per-slot acceptance rate)
    drafted: int = 0
    accepted: int = 0

    @property
    def done(self) -> bool:
        return len(self.out) >= self.request.max_new

    @property
    def prefilling(self) -> bool:
        return self.prefill_pos < len(self.request.tokens)


class Scheduler:
    """FIFO continuous batching over a fixed slot set + page pool."""

    def __init__(self, num_slots: int, pool: PagePool,
                 max_queue: Optional[int] = None,
                 cache: Optional[PrefixCache] = None,
                 token_slack: int = 0):
        self.num_slots = num_slots
        self.pool = pool
        self.max_queue = max_queue  # None = unbounded intake
        self.cache = cache          # prefix cache (DESIGN §13); None = off
        # extra page budget per request: a speculative wave of k drafts may
        # write up to k-1 positions past the last committed token, so those
        # scratch writes must land in owned pages, not clip the page table
        self.token_slack = token_slack
        self.queue: collections.deque[Request] = collections.deque()
        self.active: dict[int, SlotState] = {}
        self._free_slots = sorted(range(num_slots), reverse=True)
        self.waves = 0              # admission waves (nonempty admits)

    def _need(self, req: Request) -> int:
        return len(req.tokens) + req.max_new + self.token_slack

    # ------------------------------------------------------------- intake
    def submit(self, req: Request) -> Optional[Rejection]:
        """Queue `req`, or return a structured Rejection (never raises on
        bad traffic — a flood or a malformed giant request must degrade the
        service, not crash it). A config error still raises."""
        if req.max_new < 1:
            raise ValueError(f"request {req.rid}: max_new must be >= 1 "
                             "(prefill always samples the first token)")
        need = self._need(req)
        if not self.pool.fits(need):
            return Rejection(
                req.rid, "oversized_slot",
                f"{need} tokens exceeds per-slot capacity "
                f"{self.pool.pages_per_slot * self.pool.page_size}")
        # must also fit the *total* pool (minus the trash page), or the
        # request could never be admitted even with every slot idle and the
        # engine loop would spin forever waiting for pages
        usable = self.pool.num_pages - 1
        if self.pool.pages_needed(need) > usable:
            return Rejection(
                req.rid, "oversized_pool",
                f"needs {self.pool.pages_needed(need)} pages but the pool "
                f"only has {usable} usable pages")
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            return Rejection(
                req.rid, "queue_full",
                f"bounded queue at capacity {self.max_queue}")
        self.queue.append(req)
        return None

    def drop_expired(self, now: float) -> list[Request]:
        """Shed queued requests whose deadline already passed — they would
        waste prefill work only to be retired immediately."""
        keep, dropped = collections.deque(), []
        for req in self.queue:
            if req.deadline is not None and now > req.deadline:
                dropped.append(req)
            else:
                keep.append(req)
        self.queue = keep
        return dropped

    def next_arrival(self) -> Optional[float]:
        """Arrival time of the queue head — the FIFO admission gate `admit`
        waits on (not the queue-wide minimum: with out-of-order arrivals the
        engine must sleep until the *head* arrives, or it would busy-spin)."""
        return self.queue[0].arrival if self.queue else None

    @property
    def done(self) -> bool:
        return not self.queue and not self.active

    # ------------------------------------------------------------- admission
    def admit(self, now: float = float("inf")) -> list[SlotState]:
        """Admit arrived queue-head requests while slots and pages last.

        With a prefix cache attached, admission first matches the prompt
        against the trie: shared pages don't draw on the free list, and a
        fresh-page shortfall triggers LRU eviction of cache-only pages
        before the FIFO head is declared blocked."""
        admitted = []
        while self.queue and self._free_slots:
            req = self.queue[0]
            if req.arrival > now:
                break
            need = self._need(req)
            # NB: PrefixCache has __len__, so an *empty* cache is falsy —
            # gate on identity, never truthiness
            match = (self.cache.match(req.tokens)
                     if self.cache is not None else None)
            n_shared = len(match.pages) if match is not None else 0
            if not self.pool.can_alloc(need, shared_pages=n_shared):
                if self.cache is not None:
                    shortfall = (self.pool.pages_needed(need) - n_shared
                                 - self.pool.free_pages)
                    if shortfall > 0:
                        self.cache.evict(shortfall)
                if not self.pool.can_alloc(need, shared_pages=n_shared):
                    break           # strict FIFO: wait for pages, no overtaking
            self.queue.popleft()
            slot = self._free_slots.pop()
            self.pool.alloc(slot, need,
                            shared=match.pages if match is not None else ())
            if match is not None:
                self.cache.commit_match(match)
            shared_tokens = n_shared * self.pool.page_size
            ss = SlotState(slot=slot, request=req, key=None,
                           pos=len(req.tokens),
                           prefill_pos=shared_tokens,
                           shared_tokens=shared_tokens)
            self.active[slot] = ss
            admitted.append(ss)
        if admitted:
            self.waves += 1
        return admitted

    def finish(self, slot: int) -> SlotState:
        ss = self.active.pop(slot)
        self.pool.free(slot)
        self._free_slots.append(slot)
        self._free_slots.sort(reverse=True)
        return ss
