"""The slice end to end on the CPU: the port's `Engine` against the JAX
package's `Engine` (greedy full head, token for token, from the same
params), the MIDX head's batched output against the port's own solo
replay, the serve CLI, and the copied pool and scheduler against theirs."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro import serve as jserve
from repro.models.model import init_params as jinit
from repro_torch import configs as tcfg
from repro_torch import serve as tserve
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels.midx_probs import cuda as midx_cuda
from repro_torch.launch import serve as serve_cli

SHAPES = [(6, 5), (9, 7), (6, 3), (11, 6), (4, 6), (9, 2)]  # (plen, max_new)


def _requests(mod, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, tokens=rng.integers(0, vocab, size=plen)
                        .astype(np.int32), max_new=n, seed=3)
            for i, (plen, n) in enumerate(SHAPES)]


def _configs(arch, reduced):
    out = []
    for mod in (jcfg, tcfg):
        c = mod.get_config(arch)
        c = c.reduced() if reduced else c
        c = dataclasses.replace(c, dtype="float32")
        out.append(c.with_head(decode_temperature=0.0)
                   .with_serve(max_slots=3, page_size=4, max_seq=20))
    return out


@pytest.mark.parametrize("arch,reduced", [("paper-lm", False),
                                          ("llama3.2-1b", True)])
def test_greedy_full_head_is_token_identical_to_reference_engine(arch,
                                                                 reduced):
    jc, tc = _configs(arch, reduced)
    jp = jinit(jc, jax.random.PRNGKey(5))
    tp = params_from_numpy(tc, jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    jeng = jserve.Engine(jc, jp, head="full")
    teng = tserve.Engine(tc, tp, head="full", device="cpu")
    jres = jeng.run(_requests(jserve, jc.vocab_size))
    tres = teng.run(_requests(tserve, tc.vocab_size))
    assert teng.stats.waves >= 2             # continuous batching engaged
    for rid, (_, n) in enumerate(SHAPES):
        assert tres[rid].status == "ok"
        assert tres[rid].tokens.shape == (n,)
        np.testing.assert_array_equal(tres[rid].tokens, jres[rid].tokens,
                                      err_msg=f"rid {rid}")


@pytest.mark.parametrize("quantizer", ["rq", "pq"])
def test_midx_head_batched_equals_solo_replay(quantizer):
    cfg = tcfg.get_config("paper-lm").with_head(quantizer=quantizer) \
        .with_serve(max_slots=3, page_size=4, max_seq=20)
    eng = tserve.Engine(cfg, head="midx", device="cpu", seed=1)
    reqs = _requests(tserve, cfg.vocab_size, seed=1)
    launches = midx_cuda.midx_probs_cuda.launches
    res = eng.run(reqs)
    assert eng.stats.waves >= 2
    assert eng.stats.health()["ok"]
    for r in reqs:
        assert res[r.rid].tokens.shape == (r.max_new,)
        assert res[r.rid].tokens.max() < cfg.padded_vocab
        np.testing.assert_array_equal(res[r.rid].tokens,
                                      eng.replay_single(r))
    # the head's tables ran through the dispatcher's CPU branch, never the
    # CUDA wrapper, whose count stays untouched on a CPU tensor
    assert midx_cuda.midx_probs_cuda.launches == launches


def test_midx_head_sampling_depends_on_the_request_seed():
    cfg = tcfg.get_config("paper-lm").reduced().with_serve(
        max_slots=2, page_size=4, max_seq=20)
    eng = tserve.Engine(cfg, head="midx", device="cpu")
    req = _requests(tserve, cfg.vocab_size)[1]
    a = eng.replay_single(req)
    b = eng.replay_single(dataclasses.replace(req, seed=req.seed + 1))
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(a, eng.replay_single(req))


def test_serve_cli_on_cpu():
    out = serve_cli.main(["--device", "cpu", "--reduced", "--requests", "5",
                          "--max-slots", "2", "--tokens", "4", "--verify",
                          "2", "--warmup", "1", "--num-candidates", "8"])
    assert out["verified"] == 2
    assert out["summary"]["generated"] == 20
    assert all(r.status == "ok" for r in out["results"].values())
    out = serve_cli.main(["--device", "cpu", "--reduced", "--requests", "3",
                          "--max-slots", "2", "--tokens", "4",
                          "--stale-sigma", "0.5", "--swap-step", "1"])
    assert out["verified"] == 0             # skipped under --stale-sigma
    assert out["kl"]["stale"] > out["kl"]["refreshed"]


def test_synthetic_traffic_matches_the_reference_generator():
    from repro.launch import serve as jcli
    jc = jcfg.get_config("paper-lm").with_serve(page_size=4)
    tc = tcfg.get_config("paper-lm").with_serve(page_size=4)
    for shared in (0.0, 0.8):
        a = jcli.synthetic_requests(jc, num=7, prompt=10, max_new=3,
                                    rate=5.0, seed=4, shared_prefix=shared)
        b = serve_cli.synthetic_requests(tc, num=7, prompt=10, max_new=3,
                                         rate=5.0, seed=4,
                                         shared_prefix=shared)
        for x, y in zip(a, b, strict=True):
            assert (x.rid, x.max_new, x.seed, x.arrival) == \
                (y.rid, y.max_new, y.seed, y.arrival)
            np.testing.assert_array_equal(x.tokens, y.tokens)


def test_engine_page_pressure_queues_requests():
    cfg = tcfg.get_config("paper-lm").reduced().with_serve(
        max_slots=4, page_size=4, max_seq=16, num_pages=9)  # 2 slots' worth
    rng = np.random.default_rng(1)
    reqs = [tserve.Request(rid=i, tokens=rng.integers(0, cfg.vocab_size,
                                                      size=6).astype(np.int32),
                           max_new=4) for i in range(6)]
    eng = tserve.Engine(cfg, head="midx", device="cpu")
    res = eng.run(reqs)
    assert sorted(res) == list(range(6))
    assert eng.stats.waves >= 3
    assert eng.pool.free_pages == eng.pool.num_pages - 1
    assert torch.all(eng.state["page_table"] == 0)   # all back on trash


def test_pool_and_scheduler_copies_match_the_reference():
    """The same arrival/finish sequence drives the reference's and the
    port's scheduler to the same admissions and page tables."""
    rng = np.random.default_rng(2)
    sched = []
    for mod in (jserve, tserve):
        pool = mod.PagePool(13, 4, 4, 3)
        sched.append(mod.Scheduler(3, pool, max_queue=5))
    for step in range(30):
        if rng.random() < 0.6:
            plen, n = int(rng.integers(1, 9)), int(rng.integers(1, 9))
            toks = np.zeros(plen, np.int32)
            rej = [s.submit(m.Request(rid=step, tokens=toks, max_new=n))
                   for s, m in zip(sched, (jserve, tserve))]
            assert (rej[0] is None) == (rej[1] is None)
            if rej[0] is not None:
                assert rej[0].reason == rej[1].reason
        adm = [[ss.slot for ss in s.admit()] for s in sched]
        assert adm[0] == adm[1]
        if sched[0].active and rng.random() < 0.5:
            slot = sorted(sched[0].active)[0]
            for s in sched:
                s.finish(slot)
        np.testing.assert_array_equal(sched[0].pool.table,
                                      sched[1].pool.table)


def test_expired_and_single_token_requests_retire():
    """A request whose deadline passed before admission comes back as a
    'timeout', a max_new=1 request finishes at prefill, and an oversized
    one is shed — the engine keeps serving the rest."""
    cfg = tcfg.get_config("paper-lm").reduced().with_serve(
        max_slots=2, page_size=4, max_seq=12)
    toks = np.arange(5, dtype=np.int32)
    reqs = [tserve.Request(rid=0, tokens=toks, max_new=3, deadline=-1.0),
            tserve.Request(rid=1, tokens=toks, max_new=1),
            tserve.Request(rid=2, tokens=np.arange(20, dtype=np.int32),
                           max_new=2),
            tserve.Request(rid=3, tokens=toks, max_new=4)]
    eng = tserve.Engine(cfg, head="midx", device="cpu")
    res = eng.run(reqs)
    assert res[0].status == "timeout" and len(res[0].tokens) == 0
    assert res[1].status == "ok" and len(res[1].tokens) == 1
    assert res[2].status == "shed" and "oversized" in res[2].reason
    assert res[3].status == "ok" and len(res[3].tokens) == 4
    assert eng.stats.health() == {"ok": False, "shed": 1, "timeouts": 1,
                                  "swap_rejected": 0, "swaps": 0}
    np.testing.assert_array_equal(res[3].tokens, eng.replay_single(reqs[3]))
