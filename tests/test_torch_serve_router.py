"""The port's multi-replica router on the CPU (ports of
`tests/test_serve_router.py`): load-weighted admission, structured
shedding, merged stats, outputs equal to one engine's, the swap fan-out
to every replica with merged swap counters, and routing decisions equal
to the reference router's on the same traffic."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.configs.base import ModelConfig as JModelConfig
from repro_torch import serve as tserve
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.serve.scheduler import Rejection


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: when test files run in parallel worker
    processes, torch's thread pools oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(mod=TModelConfig, **serve_kw):
    cfg = mod(name="router-test", family="dense", num_layers=2, d_model=32,
              num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=96,
              head_dim=16, vocab_pad_multiple=16, remat=False,
              dtype="float32")
    cfg = cfg.with_head(midx_k=4, decode_candidates=8, kmeans_iters=2)
    kw = dict(max_slots=2, page_size=4, max_seq=48)
    kw.update(serve_kw)
    return cfg.with_serve(**kw)


@functools.lru_cache(maxsize=None)
def _params():
    e = tserve.Engine(_cfg(), head="midx", device="cpu", seed=3)
    return e.params, e.index


def _replicas(n=2, **serve_kw):
    params, index = _params()
    return [tserve.Engine(_cfg(**serve_kw), params, index=index, head="midx",
                          device="cpu") for _ in range(n)]


def _reqs(mod, n, plen=7, max_new=4, seed=1):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, tokens=rng.integers(0, 96, size=plen)
                        .astype(np.int32), max_new=max_new, seed=1)
            for i in range(n)]


def _drain(engines):
    for e in engines:
        e.start_run([])
        while not e.sched.done:
            e.tick(0.0)
        e.finish_run()


def test_router_balances_and_completes():
    router = tserve.Router(_replicas())
    res = router.run(_reqs(tserve, 6))
    assert sorted(res) == list(range(6))
    assert all(r.status == "ok" for r in res.values())
    assert router.rstats.per_replica == [3, 3]
    s = router.stats()
    assert s.generated == 24
    summary = router.summary()
    assert summary["routed_per_replica"] == [3, 3]
    assert summary["replicas"] == 2


@pytest.mark.parametrize("serve_kw", [{}, {"spec_decode": 2,
                                           "prefix_cache": True}])
def test_router_output_identical_to_solo_engine(serve_kw):
    engines = _replicas(**serve_kw)
    router = tserve.Router(engines)
    reqs = _reqs(tserve, 4, seed=7)
    res = router.run(reqs)
    params, index = _params()
    ref = tserve.Engine(_cfg(**serve_kw), params, index=index, head="midx",
                        device="cpu")
    for r in reqs:
        np.testing.assert_array_equal(res[r.rid].tokens, ref.replay_single(r))
    if serve_kw:
        assert router.stats().spec_waves > 0
        assert "cache_hits" in router.summary()


def test_router_sheds_oversized_structurally():
    router = tserve.Router(_replicas())
    big = tserve.Request(rid=99, tokens=np.zeros(500, np.int32), max_new=4)
    out = router.route(big)
    assert isinstance(out, Rejection) and out.reason == "oversized_slot"
    res = router.run([big])
    assert res[99].status == "shed" and "oversized" in res[99].reason
    assert router.stats().shed == 2


def test_router_sheds_when_all_queues_full():
    engines = _replicas(max_queue=1)
    router = tserve.Router(engines)
    outs = [router.route(r) for r in _reqs(tserve, 4, max_new=2)]
    placed = [o for o in outs if not isinstance(o, Rejection)]
    rejected = [o for o in outs if isinstance(o, Rejection)]
    assert len(placed) == 2 and len(rejected) == 2
    assert all(o.reason == "queue_full" for o in rejected)
    assert router.rstats.shed == 2
    _drain(engines)


def test_router_admission_prefers_freer_replica_as_the_reference():
    """Tie to replica 0, then away from the replica with pending pages; the
    reference router makes the same choices on the same traffic."""
    engines = _replicas()
    router = tserve.Router(engines)
    r0 = _reqs(tserve, 1, seed=11)[0]
    assert router.route(r0) == 0
    r1 = tserve.Request(rid=50, tokens=np.arange(7, dtype=np.int32),
                        max_new=4)
    assert router.route(r1) == 1
    _drain(engines)
    jcfg = _cfg(JModelConfig)
    je = jserve.Engine(jcfg, head="midx", init_key=jax.random.PRNGKey(3))
    jrouter = jserve.Router([je, jserve.Engine(jcfg, je.params,
                                               index=je.index, head="midx")])
    trouter = tserve.Router(_replicas())
    placed = {}
    for mod, rt in ((jserve, jrouter), (tserve, trouter)):
        reqs = [mod.Request(rid=i, tokens=np.zeros(n, np.int32), max_new=m)
                for i, (n, m) in enumerate([(7, 4), (20, 8), (3, 2), (11, 9),
                                            (30, 10), (5, 5)])]
        placed[mod] = [rt.route(r) for r in reqs]
    assert placed[tserve] == placed[jserve]
    _drain(trouter.engines)


def test_router_swap_fans_out_to_every_replica():
    """The swap fans out to every replica: a valid index goes live on
    each, a None is refused by each gate, and the merged stats count
    both."""
    engines = _replicas()
    router = tserve.Router(engines)
    assert router.swap_index(engines[0].index) == [True, True]
    assert router.swap_index(None) == [False, False]
    router.schedule_swap(engines[0].index, at_step=3)
    assert all(e._pending_swap == (3, engines[0].index) for e in engines)
    merged = router.stats()
    assert (merged.swaps, merged.swap_rejected) == (2, 2)
    assert merged.health()["ok"] is False


def test_router_requires_engines():
    with pytest.raises(ValueError):
        tserve.Router([])
