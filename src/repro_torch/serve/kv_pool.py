"""Paged KV-cache pool allocator + prompt-prefix cache (DESIGN §5, §13).

A copy of `src/repro/serve/kv_pool.py` (numpy-only; copied, not imported,
because `repro/__init__.py` imports jax). The port's engine uses it
unchanged; its prefix cache waits for the chunked-prefill slice.

Host-side bookkeeping for the physical page pool that
`models.decode.init_paged_state` lays out on device: fixed-size pages of
`page_size` tokens, a per-slot page table, all-or-nothing alloc at request
admission and full free at request finish. The device never sees the free
list — only the `[num_slots, pages_per_slot]` page table, re-uploaded after
each admission wave.

Pages are refcounted (DESIGN §13): a page may be held by one *writer* slot
plus any number of read-only holders (other slots sharing a prompt prefix,
and the `PrefixCache` trie). A page returns to the free list exactly when
its refcount drops to zero. `PrefixCache` keys full prompt pages on a
chained page-aligned token hash so a request whose prompt shares a
page-aligned prefix with an earlier one reuses the donor's physical pages —
the page-table indirection makes the reuse free. The partial tail page is
never shared: reuse is capped strictly below the final prompt position, so
the admitted request always gets a fresh tail page to write
(copy-on-write by recomputation — a shared page is never mutated).
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib

import numpy as np

#: Physical page 0 is reserved: never allocated, the target of every
#: unallocated page-table entry, and the write sink for inactive slots in a
#: packed decode step. Its contents are garbage by design and never readable
#: (attention masks everything beyond a slot's own writes).
TRASH_PAGE = 0


class PagePool:
    """Refcounted fixed-size page allocator with per-slot page tables.

    Invariants (property-tested in tests/test_serve_pool.py):
      - page ``TRASH_PAGE`` is never handed out and never refcounted;
      - for every real page, ``refcount == 0``  ⟺  the page is on the free
        list (a page is never free and owned at the same time, and never
        handed out twice without an intervening release);
      - ``alloc`` is all-or-nothing for a request's full token budget, so a
        request can never run out of pages mid-decode;
      - a page with ``refcount > 1`` is *shared* and read-only: it only ever
        appears in the leading (prefix) entries of a slot's page table,
        before every position the slot will write;
      - ``free`` releases every page the slot holds and points the slot's
        table back at the trash page.
    """

    def __init__(self, num_pages: int, page_size: int, pages_per_slot: int,
                 num_slots: int):
        if num_pages < 2:
            raise ValueError("need at least one real page beyond the trash page")
        self.num_pages = num_pages
        self.page_size = page_size
        self.pages_per_slot = pages_per_slot
        self.num_slots = num_slots
        self._free = collections.deque(range(1, num_pages))
        self._ref = np.zeros(num_pages, np.int32)
        self._owned: dict[int, list[int]] = {}
        self._shared: dict[int, int] = {}   # slot -> leading read-only pages
        self.table = np.full((num_slots, pages_per_slot), TRASH_PAGE, np.int32)

    # ------------------------------------------------------------- queries
    def pages_needed(self, num_tokens: int) -> int:
        return -(-num_tokens // self.page_size)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    def shared_count(self, slot: int) -> int:
        """How many leading pages of `slot`'s table are read-only shares."""
        return self._shared.get(slot, 0)

    def fits(self, num_tokens: int) -> bool:
        """Could this request *ever* be admitted (slot capacity)?"""
        return self.pages_needed(num_tokens) <= self.pages_per_slot

    def can_alloc(self, num_tokens: int, shared_pages: int = 0) -> bool:
        n = self.pages_needed(num_tokens)
        return (n <= self.pages_per_slot
                and n - shared_pages <= len(self._free))

    # ------------------------------------------------------------- refcounts
    def retain(self, page: int) -> None:
        """Add a read-only hold on a live page (prefix cache / shared slot)."""
        if page == TRASH_PAGE:
            raise ValueError("the trash page is never retained")
        if self._ref[page] == 0:
            raise ValueError(f"retain of free page {page}")
        self._ref[page] += 1

    def release(self, page: int) -> None:
        if self._ref[page] <= 0:
            raise ValueError(f"release of free page {page}")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._free.append(page)

    # ------------------------------------------------------------- alloc/free
    def alloc(self, slot: int, num_tokens: int,
              shared: "list[int] | tuple[int, ...]" = ()) -> np.ndarray:
        """Reserve pages for `num_tokens` total (prompt + generation) in
        `slot`'s page table. `shared` is an optional list of live physical
        pages (a cached prompt prefix) that become the slot's leading
        read-only table entries; the remainder is popped fresh from the free
        list. Returns the slot's physical page ids."""
        if slot in self._owned:
            raise ValueError(f"slot {slot} already holds pages")
        n = self.pages_needed(num_tokens)
        if len(shared) > n:
            raise ValueError(f"{len(shared)} shared pages exceed the "
                             f"{n}-page budget")
        if not self.can_alloc(num_tokens, shared_pages=len(shared)):
            raise ValueError(f"cannot allocate {num_tokens} tokens "
                             f"({self.free_pages} pages free)")
        for p in shared:
            self.retain(p)
        fresh = [self._free.popleft() for _ in range(n - len(shared))]
        for p in fresh:
            self._ref[p] = 1
        pages = list(shared) + fresh
        self._owned[slot] = pages
        self._shared[slot] = len(shared)
        self.table[slot] = TRASH_PAGE
        self.table[slot, :n] = pages
        return np.asarray(pages, np.int32)

    def free(self, slot: int) -> None:
        for p in self._owned.pop(slot):
            self.release(p)
        self._shared.pop(slot, None)
        self.table[slot] = TRASH_PAGE


# ---------------------------------------------------------------- prefix cache
def _page_hash(prev: int, tokens: np.ndarray) -> int:
    """Chained content hash of one full page of prompt tokens: a page's key
    commits to every token before it, so equal keys ⇒ equal page-aligned
    prefixes (modulo hash collisions at 2^-64)."""
    h = hashlib.blake2b(digest_size=8)
    h.update(prev.to_bytes(8, "little", signed=False))
    h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
    return int.from_bytes(h.digest(), "little")


@dataclasses.dataclass
class _Node:
    page: int
    parent: int          # parent chain hash (0 = root)
    children: int = 0
    tick: int = 0


@dataclasses.dataclass
class CacheMatch:
    """Result of a prefix lookup: the reusable physical pages, their chain
    hashes, and how many full pages the prompt *could* have matched."""
    pages: list
    hashes: list
    limit: int


class PrefixCache:
    """Prompt-prefix trie over full KV pages (DESIGN §13).

    Nodes are keyed by the chained hash of each *full* page of prompt
    tokens and hold one read-only refcount on their physical page. Reuse is
    capped at ``(plen - 1) // page_size`` pages so the final prompt position
    is always recomputed (the engine needs its hidden state to sample the
    first token) and the partial tail page is never shared. Eviction is
    LRU over childless nodes whose page nobody else holds (refcount == 1),
    walked iteratively so a cold chain unwinds leaf-first.
    """

    def __init__(self, pool: PagePool):
        self.pool = pool
        self._nodes: dict[int, _Node] = {}
        self._tick = 0
        self.hits = 0          # pages reused across admissions
        self.misses = 0        # full prompt pages that had to be computed
        self.evictions = 0     # pages evicted to make room

    def __len__(self) -> int:
        return len(self._nodes)

    # ------------------------------------------------------------- lookup
    def match(self, tokens: np.ndarray) -> CacheMatch:
        """Longest cached page-aligned strict prefix of `tokens`."""
        P = self.pool.page_size
        limit = max(0, (len(tokens) - 1) // P)
        pages, hashes = [], []
        h = 0
        for i in range(limit):
            h = _page_hash(h, tokens[i * P:(i + 1) * P])
            node = self._nodes.get(h)
            if node is None:
                break
            pages.append(node.page)
            hashes.append(h)
        return CacheMatch(pages=pages, hashes=hashes, limit=limit)

    def commit_match(self, m: CacheMatch) -> None:
        """Account a successful admission that reused `m` and refresh LRU."""
        self._tick += 1
        for h in m.hashes:
            self._nodes[h].tick = self._tick
        self.hits += len(m.pages)
        self.misses += m.limit - len(m.pages)

    # ------------------------------------------------------------- insert
    def insert(self, tokens: np.ndarray, pages: np.ndarray) -> int:
        """Cache every *full* page of a just-prefilled prompt. `pages` is the
        slot's physical page list (leading entries cover the prompt). A chain
        hash already present keeps its existing physical page (first writer
        wins; the newcomer's private copy is freed with its slot). Returns
        the number of pages newly cached."""
        P = self.pool.page_size
        self._tick += 1
        h, added = 0, 0
        for i in range(len(tokens) // P):
            parent = h
            h = _page_hash(h, tokens[i * P:(i + 1) * P])
            node = self._nodes.get(h)
            if node is None:
                self.pool.retain(int(pages[i]))
                node = _Node(page=int(pages[i]), parent=parent)
                self._nodes[h] = node
                if parent in self._nodes:
                    self._nodes[parent].children += 1
                added += 1
            node.tick = self._tick
        return added

    # ------------------------------------------------------------- eviction
    def evictable(self) -> int:
        """Pages the cache could give back right now (cache-only holds)."""
        return sum(1 for n in self._nodes.values()
                   if self.pool.refcount(n.page) == 1)

    def evict(self, need: int) -> int:
        """Release up to `need` pages, LRU-first over childless nodes whose
        page has no other holder. Unwinds chains leaf-first (evicting a
        parent would strand unreachable children)."""
        freed = 0
        while freed < need:
            victims = sorted(
                (n.tick, h) for h, n in self._nodes.items()
                if n.children == 0 and self.pool.refcount(n.page) == 1)
            if not victims:
                break
            for _, h in victims:
                if freed >= need:
                    break
                node = self._nodes.pop(h)
                self.pool.release(node.page)
                if node.parent in self._nodes:
                    self._nodes[node.parent].children -= 1
                freed += 1
                self.evictions += 1
        return freed

    def drop(self) -> None:
        """Release every cached page (engine shutdown / tests)."""
        for node in self._nodes.values():
            self.pool.release(node.page)
        self._nodes.clear()

    def counters(self) -> dict:
        return {"cache_hits": self.hits, "cache_misses": self.misses,
                "cache_evictions": self.evictions,
                "cached_pages": len(self._nodes)}
