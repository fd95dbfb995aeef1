"""The port's refcounted PagePool and PrefixCache driven through the same
operations as the JAX package's (ports of the PrefixCache and refcount
tests of `tests/test_serve_pool.py`): after every operation both packages
hold the same page tables, free lists, refcounts, shared counts and cache
counters, and the port's pool keeps the reference test's invariants."""
import random

import numpy as np
import pytest

from repro.serve import kv_pool as jpool
from repro_torch.serve import kv_pool as tpool

PAGE = 4
SLOTS = 3
PPS = 6                      # pages per slot
NPAGES = 12                  # incl. trash
KINDS = ["alloc", "free", "cache_insert", "cache_evict", "alloc_shared"]


def _pair():
    return [(m.PagePool(NPAGES, PAGE, PPS, SLOTS), m) for m in (jpool, tpool)]


def _snapshot(pool, cache):
    return (pool.table.tolist(), sorted(pool._free),
            [pool.refcount(p) for p in range(pool.num_pages)],
            {s: (list(map(int, pages)), pool.shared_count(s))
             for s, pages in pool._owned.items()},
            cache.counters() if cache is not None else None)


def _check_invariants(pool):
    free = set(pool._free)
    assert tpool.TRASH_PAGE not in free
    assert pool.refcount(tpool.TRASH_PAGE) == 0
    for p in range(1, pool.num_pages):
        assert (pool.refcount(p) == 0) == (p in free), p
    fresh = []
    for slot, pages in pool._owned.items():
        shared = pool.shared_count(slot)
        fresh.extend(pages[shared:])
        for q in pages[:shared]:
            assert pool.refcount(q) >= 2
        np.testing.assert_array_equal(pool.table[slot, :len(pages)], pages)
        assert np.all(pool.table[slot, len(pages):] == tpool.TRASH_PAGE)
    assert len(fresh) == len(set(fresh)), "page owned twice"


def _run_ops(pool, mod, ops, seed):
    """The reference test's interpreter of one op list; yields a snapshot
    after every op."""
    rnd = random.Random(seed)
    cache = mod.PrefixCache(pool)
    next_tok = [0]
    inserted = []
    for kind, slot, tokens in ops:
        if kind == "alloc" and slot not in pool._owned:
            if pool.can_alloc(tokens):
                pool.alloc(slot, tokens)
        elif kind == "alloc_shared" and slot not in pool._owned and inserted:
            toks, _ = inserted[rnd.randrange(len(inserted))]
            m = cache.match(toks)
            need = max(tokens, len(toks) + 1)
            if need <= PPS * PAGE and pool.can_alloc(
                    need, shared_pages=len(m.pages)):
                pool.alloc(slot, need, shared=m.pages)
                cache.commit_match(m)
        elif kind == "free" and slot in pool._owned:
            pool.free(slot)
        elif kind == "cache_insert" and slot in pool._owned:
            shared = pool.shared_count(slot)
            own = pool._owned[slot]
            nfull = len(own) - shared
            if nfull > 0:
                toks = np.arange(next_tok[0], next_tok[0] + nfull * PAGE,
                                 dtype=np.int32)
                next_tok[0] += nfull * PAGE
                cache.insert(toks, np.asarray(own[shared:], np.int32))
                inserted.append((toks, nfull))
        elif kind == "cache_evict":
            cache.evict(tokens // PAGE + 1)
        yield _snapshot(pool, cache)
    for slot in list(pool._owned):
        pool.free(slot)
    cache.drop()
    yield _snapshot(pool, cache)


@pytest.mark.parametrize("seed", range(40))
def test_pool_and_cache_match_reference_under_random_ops(seed):
    rnd = random.Random(seed)
    ops = [(rnd.choice(KINDS), rnd.randrange(SLOTS),
            rnd.randint(1, PPS * PAGE)) for _ in range(rnd.randrange(31))]
    (jp, jm), (tp, tm) = _pair()
    for a, b in zip(_run_ops(jp, jm, ops, seed), _run_ops(tp, tm, ops, seed),
                    strict=True):
        assert a == b
        _check_invariants(tp)
    assert tp.free_pages == tp.num_pages - 1


@pytest.mark.parametrize("mod", [jpool, tpool], ids=["reference", "port"])
def test_refusals(mod):
    pool = mod.PagePool(NPAGES, PAGE, PPS, SLOTS)
    pool.alloc(0, 8)
    with pytest.raises(ValueError, match="already holds"):
        pool.alloc(0, 4)
    with pytest.raises(ValueError):
        pool.retain(mod.TRASH_PAGE)
    with pytest.raises(ValueError):
        pool.release(mod.TRASH_PAGE)
    with pytest.raises(ValueError, match="free page"):
        pool.retain(NPAGES - 1)


def _shared_pages_survive_owner_free(mod):
    pool = mod.PagePool(NPAGES, PAGE, PPS, SLOTS)
    cache = mod.PrefixCache(pool)
    toks = np.arange(2 * PAGE, dtype=np.int32)
    pages = pool.alloc(0, len(toks) + 2)
    cache.insert(toks, pages)
    pool.free(0)
    out = [cache.counters()["cached_pages"],
           [pool.refcount(int(p)) for p in pages[:2]]]
    m = cache.match(np.concatenate([toks, np.arange(5, dtype=np.int32)]))
    out.append([int(p) for p in m.pages] == [int(p) for p in pages[:2]])
    before = pool.free_pages
    pool.alloc(1, len(toks) + 2, shared=m.pages)
    out.append(before - pool.free_pages)
    pool.free(1)
    cache.drop()
    out.append(pool.free_pages == pool.num_pages - 1)
    return out


def _match_is_strict_prefix_only(mod):
    pool = mod.PagePool(NPAGES, PAGE, PPS, SLOTS)
    cache = mod.PrefixCache(pool)
    toks = np.arange(2 * PAGE, dtype=np.int32)
    pages = pool.alloc(0, len(toks) + 1)
    cache.insert(toks, pages)
    m = cache.match(toks)
    pool.free(0)
    cache.drop()
    return [m.limit, len(m.pages)]


def _eviction_is_leaf_first(mod):
    pool = mod.PagePool(NPAGES, PAGE, PPS, SLOTS)
    cache = mod.PrefixCache(pool)
    toks = np.arange(3 * PAGE, dtype=np.int32)
    pages = pool.alloc(0, len(toks) + 1)
    cache.insert(toks, pages)
    pool.free(0)
    m = cache.match(np.concatenate([toks, toks[:1]]))
    out = [len(m.pages)]
    pool.alloc(1, 4 * PAGE, shared=m.pages[:1])
    out += [cache.evict(3), cache.counters()["cache_evictions"],
            pool.refcount(int(pages[0]))]
    pool.free(1)
    cache.drop()
    out.append(pool.free_pages == pool.num_pages - 1)
    return out


@pytest.mark.parametrize("case,want", [
    (_shared_pages_survive_owner_free, [2, [1, 1], True, 1, True]),
    (_match_is_strict_prefix_only, [1, 1]),
    (_eviction_is_leaf_first, [3, 2, 2, 2, True])],
    ids=["shared_pages_survive_owner_free", "match_is_strict_prefix_only",
         "eviction_is_leaf_first_and_skips_held_pages"])
def test_cache_cases_equal_reference(case, want):
    assert case(tpool) == case(jpool) == want
