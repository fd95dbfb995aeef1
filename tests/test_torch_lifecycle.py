"""The port's index lifecycle on the CPU, held to the JAX package on the
same numpy inputs (ports of `tests/test_index_lifecycle.py`):

  - `refresh_adaptive`'s cheap branch (threshold 0.5, unchanged table):
    codebooks, the drift metrics and distortion within 1e-5, assignments
    and CSR exact; its full branch on a moved table: did_full 1 on both,
    reassigned_frac within 1e-5, and the warm-started refit (no codeword
    empties, so it draws nothing random) element-wise the reference's;
  - the vocab-sharded drift branch on two gloo CPU ranks, held to the
    single-device branch;
  - `IndexLifecycle` beside the reference's on a toy refresh: the same
    (step, swap_step) lists at lag 2, lag 0 and disabled, `flush`,
    `abort` and `summary()`; a degenerate refresh rejected at its swap
    step at lag 2; an overlapped refresh bitwise the synchronous one;
  - `train_loop` at the drift policy and lag 1, and a resume at lag 2
    bit for bit the uninterrupted run;
  - `proposal_kl` against the reference's formula at the same probes.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_vp_ranks as ranks

from repro.core import midx as jmidx
from repro.index import lifecycle as jlc
from repro.index.build import build as jbuild
from repro.resilience import FaultInjector as JFaultInjector
from repro.resilience import FaultSpec as JFaultSpec
from repro_torch.bridge import index_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import midx as tmidx
from repro_torch.dist import vocab_parallel as vp
from repro_torch.index import lifecycle as tlc
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.launch.train import train_loop
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.resilience import FaultInjector, FaultSpec

TOL = 1e-5
INTS = ("assign1", "assign2", "sorted_ids", "offsets", "counts")
FIELDS = ("kind", "codebook1", "codebook2", "assign1", "assign2",
          "residuals", "sorted_ids", "offsets", "counts", "log_counts")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: when test files run in parallel worker
    processes, torch's thread pools oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair():
    """The reference's index on the unchanged table and the port's copy of
    it, with the tables: (jidx, tidx, x, moved)."""
    x, moved, c1, c2 = ranks.drift_tables()
    jidx = jbuild(jax.random.PRNGKey(1), jnp.asarray(x), kind="rq",
                  k=ranks.DRIFT_K, iters=3, keep_residuals=False,
                  init=(jnp.asarray(c1), jnp.asarray(c2)))
    tidx = index_from_numpy({f: (getattr(jidx, f) if f == "kind"
                                 else np.asarray(getattr(jidx, f)))
                             for f in FIELDS}, device="cpu")
    return jidx, tidx, x, moved


def _hold_index(t, j):
    for f in INTS:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    for f in ("codebook1", "codebook2"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), atol=TOL,
                                   rtol=TOL, err_msg=f)


def _hold_metrics(tm, jm, keys=("reassigned_frac", "codeword_drift",
                                "did_full", "distortion")):
    for k in keys:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=TOL,
                                   rtol=TOL, err_msg=k)


def test_drift_cheap_branch_matches_reference():
    jidx, tidx, x, _ = _pair()
    jnew, jm = jlc.refresh_adaptive(jidx, jax.random.PRNGKey(2),
                                    jnp.asarray(x), iters=3, threshold=0.5)
    tnew, tm = tlc.refresh_adaptive(tidx, torch.Generator().manual_seed(2),
                                    torch.from_numpy(x), iters=3,
                                    threshold=0.5)
    assert float(jm["did_full"]) == float(tm["did_full"]) == 0.0
    _hold_index(tnew, jnew)
    _hold_metrics(tm, jm)
    # the cheap branch keeps the codebooks themselves
    assert torch.equal(tnew.codebook1, tidx.codebook1)
    # and refresh_with_policy's drift branch is refresh_adaptive
    pnew, pm = tlc.refresh_with_policy(tidx, torch.Generator(),
                                       torch.from_numpy(x), iters=3,
                                       policy="drift", threshold=0.5)
    assert torch.equal(pnew.sorted_ids, tnew.sorted_ids) and pm == tm


def test_drift_full_branch_matches_reference():
    jidx, tidx, _, moved = _pair()
    jnew, jm = jlc.refresh_adaptive(jidx, jax.random.PRNGKey(3),
                                    jnp.asarray(moved), iters=3,
                                    threshold=0.5)
    tnew, tm = tlc.refresh_adaptive(tidx, torch.Generator().manual_seed(3),
                                    torch.from_numpy(moved), iters=3,
                                    threshold=0.5)
    assert float(jm["did_full"]) == float(tm["did_full"]) == 1.0
    assert float(tm["reassigned_frac"]) > 0.5
    # warm-started from codebooks whose clusters all stay populated, the
    # refit draws nothing random: held element-wise
    _hold_index(tnew, jnew)
    _hold_metrics(tm, jm)
    # and it is the fixed policy's refit (the same draws from one seed)
    fnew, fm = tlc.refresh_with_policy(tidx, torch.Generator().manual_seed(3),
                                       torch.from_numpy(moved), iters=3,
                                       policy="fixed")
    assert torch.equal(fnew.codebook1, tnew.codebook1) and fm == tm


def test_drift_policy_rejects_unknown():
    _, tidx, x, _ = _pair()
    with pytest.raises(ValueError, match="refresh_policy"):
        tlc.refresh_with_policy(tidx, torch.Generator(), torch.from_numpy(x),
                                policy="bogus")


def test_vocab_sharded_drift_matches_single_device(tmp_path):
    out = str(tmp_path)
    spawn_ranks(ranks.drift_scenario, 2, (out,), device="cpu",
                backend="gloo", threads=1)
    res = [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in (0, 1)]
    x, moved, _, _ = ranks.drift_tables()
    idx = ranks.drift_index()
    for tag, table, full in (("same", x, 0.0), ("moved", moved, 1.0)):
        want, wm = tlc.refresh_with_policy(
            idx, torch.Generator().manual_seed(3), torch.from_numpy(table),
            iters=3, policy="drift", threshold=0.5)
        for r in (0, 1):            # every rank took the same branch
            assert float(res[r][f"{tag}_did_full"]) == full
            for f in vp.CSR_FIELDS:
                assert res[r][f"{tag}_{f}"].tobytes() == \
                    res[0][f"{tag}_{f}"].tobytes()
        merged = vp.unshard_index(vp.VocabShardedIndex(
            "rq", 2, torch.from_numpy(res[0][f"{tag}_codebook1"]),
            torch.from_numpy(res[0][f"{tag}_codebook2"]),
            *(torch.from_numpy(res[0][f"{tag}_{f}"])
              for f in vp.CSR_FIELDS)))
        _hold_index(merged, want)
        _hold_metrics({k: res[0][f"{tag}_{k}"] for k in wm}, wm)


# ------------------------------------------------------------ the lifecycle
def _toy(tag: float):
    """The reference's `_toy_refresh`, in each package's currency."""
    def jfn(params, index, key):
        return index, {"reassigned_frac": jnp.float32(0.0),
                       "codeword_drift": jnp.float32(0.0),
                       "did_full": jnp.float32(tag),
                       "distortion": jnp.float32(1.0)}

    def tfn(params, index, seed):
        return index, {"reassigned_frac": torch.tensor(0.0),
                       "codeword_drift": torch.tensor(0.0),
                       "did_full": torch.tensor(tag),
                       "distortion": torch.tensor(1.0)}
    return jfn, tfn


def _drive(lc, idx, steps):
    events, cur = [], idx
    for step in range(steps):
        cur, ev = lc.step(step, None, cur)
        if ev is not None:
            events.append((ev.step, ev.swap_step, ev.mode))
    return events, cur


@pytest.mark.parametrize("lag,every,steps,tag",
                         [(2, 4, 12, 1.0), (0, 3, 9, 0.0)])
def test_lifecycle_schedule_matches_reference(lag, every, steps, tag):
    jidx, tidx, _, _ = _pair()
    jfn, tfn = _toy(tag)
    jl = jlc.IndexLifecycle(jfn, every=every, lag=lag,
                            base_key=jax.random.PRNGKey(0))
    tl = tlc.IndexLifecycle(tfn, every=every, lag=lag, base_seed=0)
    jev, _ = _drive(jl, jidx, steps)
    tev, cur = _drive(tl, tidx, steps)
    assert tev == jev
    assert tl.in_flight == jl.in_flight
    if lag:
        # dispatch at 3 and 7 -> swap at 5 and 9; the step-11 dispatch is
        # still in flight at the end, and a flush completes it
        assert [e[:2] for e in tev] == [(3, 5), (7, 9)]
        jcur, jfl = jl.flush(11, jidx)
        cur, fl = tl.flush(11, cur)
        assert (fl.step, fl.swap_step) == (jfl.step, jfl.swap_step) == \
            (11, 11)
        assert not tl.in_flight
    else:
        assert [e[:2] for e in tev] == [(2, 2), (5, 5), (8, 8)]
        assert all(e[2] == "reassign" for e in tev)
        assert tl.flush(8, cur) == (cur, None)
    js, ts = jl.summary(), tl.summary()
    assert set(ts) == set(js)
    for k in ("refreshes", "full_refits", "reassign_only", "rejected"):
        assert ts[k] == js[k], k


def test_lifecycle_disabled_and_abort():
    _, tidx, _, _ = _pair()
    calls = []

    def fn(params, index, seed):
        calls.append(seed)
        return index, {}

    lc = tlc.IndexLifecycle(fn, every=1, base_seed=0, enabled=False)
    for step in range(5):
        assert lc.step(step, None, tidx) == (tidx, None)
    assert not calls
    lc = tlc.IndexLifecycle(fn, every=2, base_seed=0, lag=3)
    lc.step(1, None, tidx)
    assert lc.in_flight and len(calls) == 1
    lc.abort()                      # rollback: dropped, never swapped in
    assert not lc.in_flight and lc.flush(4, tidx) == (tidx, None)
    assert lc.events == [] and lc.summary()["refreshes"] == 0


def test_degenerate_refresh_rejected_at_swap_step():
    """At lag 2 the poisoned rebuild dispatched after step 3 is refused at
    its swap step 5, the live index kept — as in the reference."""
    jidx, tidx, _, _ = _pair()
    jfn, tfn = _toy(1.0)
    spec = dict(kind="degenerate_refresh", step=3, mode="nan")
    jinj, tinj = JFaultInjector(0, [JFaultSpec(**spec)]), \
        FaultInjector(0, [FaultSpec(**spec)])
    jl = jlc.IndexLifecycle(jinj.wrap_refresh(jfn), every=4, lag=2,
                            base_key=jax.random.PRNGKey(0))
    tl = tlc.IndexLifecycle(tinj.wrap_refresh(tfn), every=4, lag=2,
                            base_seed=0)
    got = {}
    for name, lc, inj, idx in (("j", jl, jinj, jidx), ("t", tl, tinj, tidx)):
        cur, evs = idx, []
        for step in range(8):
            inj.note_step(step)
            cur, ev = lc.step(step, None, cur)
            if ev is not None:
                evs.append((ev.step, ev.swap_step, ev.rejected))
        got[name] = (evs, cur is idx)
    assert got["t"] == got["j"] == ([(3, 5, True)], True)
    assert tl.events[0].reasons and tl.events[0].mode == "rejected"


def test_overlapped_refresh_equals_synchronous():
    """A rebuild dispatched after step s is built from step s's params and
    seed: the optimizer's in-place writes after the dispatch change
    nothing, and the swapped index is the synchronous refresh's bits."""
    cfg = get_config("paper-lm").reduced()
    from repro_torch.models import heads, init_params
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    idx = heads.init_head_state(cfg, params, torch.Generator().manual_seed(1))

    def refresh(p, state, seed):
        return heads.refresh_head_state_with_policy(
            cfg, p, state, torch.Generator().manual_seed(seed),
            policy="drift")

    lc = tlc.IndexLifecycle(refresh, every=2, base_seed=5, lag=2)
    cur, _ = lc.step(1, params, idx)            # dispatched from these params
    want, _ = refresh({"embed": params["embed"].clone()}, idx,
                      int(tlc.noise.hash_bits(5, 1, 0, 0)))
    params["embed"].add_(0.5)                   # the next steps' updates
    cur, _ = lc.step(2, params, cur)
    cur, ev = lc.step(3, params, cur)
    assert (ev.step, ev.swap_step) == (1, 3) and not ev.rejected
    for f in ("codebook1", "codebook2", "sorted_ids", "counts"):
        assert torch.equal(getattr(cur, f), getattr(want, f)), f


# ------------------------------------------------------------- train loop
def test_train_loop_drift_policy_smoke(capsys):
    cfg = get_config("paper-lm").reduced()
    events = []
    _, _, index, history = train_loop(
        cfg, steps=10, batch_size=4, seq_len=16, log_every=100,
        refresh_every=3, refresh_policy="drift", refresh_lag=1,
        on_refresh=events.append, device="cpu")
    assert np.isfinite(history).all()
    assert [(e.step, e.swap_step) for e in events] == [(2, 3), (5, 6),
                                                      (8, 9)]
    assert {e.mode for e in events} <= {"full", "reassign"}
    assert int(index.counts.sum()) == cfg.padded_vocab
    assert "refresh summary: 3 events" in capsys.readouterr().out


def test_resume_at_lag_2_is_bitwise(tmp_path):
    """8 + 8 steps through a checkpoint at step 8 against 16 straight, at
    lag 2 with a rebuild in flight at the save (the save flushes it in
    both runs)."""
    cfg = get_config("paper-lm").reduced()
    kw = dict(batch_size=4, seq_len=16, log_every=1000, total_steps=16,
              refresh_every=4, refresh_lag=2, refresh_policy="drift",
              ckpt_every=8, device="cpu")
    straight = train_loop(cfg, steps=16, ckpt_dir=str(tmp_path / "a"), **kw)
    first = train_loop(cfg, steps=8, ckpt_dir=str(tmp_path / "b"), **kw)
    second = train_loop(cfg, steps=16, ckpt_dir=str(tmp_path / "b"), **kw)
    assert first[3] + second[3] == straight[3]
    for a, b in zip(tree_leaves(second[0]) + tree_leaves(second[1].mu)
                    + tree_leaves(second[1].nu),
                    tree_leaves(straight[0]) + tree_leaves(straight[1].mu)
                    + tree_leaves(straight[1].nu)):
        assert torch.equal(a, b)
    for f in ("codebook1", "codebook2", "sorted_ids", "counts"):
        assert torch.equal(getattr(second[2], f), getattr(straight[2], f))


# ------------------------------------------------------------- proposal KL
def test_proposal_kl_matches_reference_formula():
    jidx, tidx, x, moved = _pair()
    z = 0.5 * np.random.default_rng(4).standard_normal(
        (16, x.shape[1])).astype(np.float32)
    for table in (x, moved):
        log_p = jax.nn.log_softmax(jnp.asarray(z) @ jnp.asarray(table).T,
                                   axis=-1)
        ids = jnp.broadcast_to(jnp.arange(table.shape[0]), log_p.shape)
        log_q = jmidx.log_prob(jidx, jnp.asarray(z), ids)
        want = float(jnp.mean(jnp.sum(jnp.exp(log_p) * (log_p - log_q),
                                      axis=-1)))
        got = float(tmidx.proposal_kl_at(tidx, torch.from_numpy(table),
                                         torch.from_numpy(z)))
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    # the probes come from a torch.Generator: one seed, one number
    a = tmidx.proposal_kl(tidx, torch.from_numpy(moved),
                          torch.Generator().manual_seed(1))
    b = tmidx.proposal_kl(tidx, torch.from_numpy(moved),
                          torch.Generator().manual_seed(1))
    assert float(a) == float(b) > float(tmidx.proposal_kl(
        tidx, torch.from_numpy(x), torch.Generator().manual_seed(1)))
