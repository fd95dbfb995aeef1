"""MIDX-draft speculative decoding in the port against the JAX package on the
CPU (ports of `tests/test_serve_spec.py`), at the reference test's size.

Bars: greedy speculative decoding token for token equal to the port's
greedy full head and to the reference `Engine` with spec_decode=3, from the
same params and index; sampled speculative decoding batched == solo, over
a bf16 and an int8 head state; the acceptance counters; the head, family
and greedy refusals; the rejection sampler's committed tokens within TV
0.12 of the target and 0.02 closer to it than the raw drafts (4096 draws
in one batched call); the greedy verify commits the argmax;
`midx_spec_draft`'s stage tables within 1e-5 of the reference's for the
same hidden; the draft hidden after every wave equal (1e-5) to the hidden
that predicted the last committed token, and the acceptance rate near the
reference's. Params and indexes are the reference's init, carried over
through `repro_torch.bridge`."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import heads as jheads
from repro_torch import serve as tserve
from repro_torch.bridge import (index_from_numpy, params_from_numpy,
                                quant_state_from_numpy)
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.core import noise
from repro_torch.index.quantized import QUANT_FIELDS
from repro_torch.models import heads, logits_full, prefill

TOL = 1e-5
FIELDS = ("codebook1", "codebook2", "assign1", "assign2", "residuals",
          "sorted_ids", "offsets", "counts", "log_counts")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: when test files run in parallel worker
    processes, torch's thread pools oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(mod, fmt="bf16", **serve_kw):
    cfg = mod(name="spec-test", family="dense", num_layers=2, d_model=32,
              num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=96,
              head_dim=16, vocab_pad_multiple=16, remat=False,
              dtype="float32")
    cfg = cfg.with_head(midx_k=4, decode_candidates=8, kmeans_iters=2,
                        table_dtype=fmt)
    return cfg.with_serve(max_slots=2, page_size=4, max_seq=48, **serve_kw)


def _index_np(idx):
    return {"kind": idx.kind, **{f: np.asarray(getattr(idx, f))
                                 for f in FIELDS}}


@functools.lru_cache(maxsize=None)
def _base(fmt="bf16"):
    """The reference engine's params and head state (PRNGKey(3), as the
    reference test) and the port's copies of them."""
    jeng = jserve.Engine(_cfg(JModelConfig, fmt), head="midx",
                         init_key=jax.random.PRNGKey(3))
    tcfg = _cfg(TModelConfig, fmt)
    tp = params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray,
                                                        jeng.params),
                           device="cpu")
    js = jeng.index
    if fmt == "bf16":
        ts = index_from_numpy(_index_np(js), device="cpu")
    else:
        ts = quant_state_from_numpy(
            {"fmt": js.fmt, "index": _index_np(js.index),
             **{f: np.asarray(getattr(js, f)) for f in QUANT_FIELDS[1:]}},
            device="cpu")
    rng = np.random.default_rng(0)
    toks = [rng.integers(0, 96, size=9).astype(np.int32) for _ in range(3)]
    return jeng.params, js, tp, ts, toks


def _reqs(mod, toks, max_new=6):
    return [mod.Request(rid=i, tokens=t, max_new=max_new, seed=1)
            for i, t in enumerate(toks)]


def _engine(cfg, tp, ts, head="midx"):
    return tserve.Engine(cfg, tp, index=ts, head=head, device="cpu")


def test_greedy_spec_token_identical_to_full_head_and_reference():
    jp, js, tp, ts, toks = _base()
    greedy = dict(decode_temperature=0.0)
    spec = _engine(_cfg(TModelConfig, spec_decode=3).with_head(**greedy),
                   tp, ts)
    full = _engine(_cfg(TModelConfig).with_head(**greedy), tp, ts, "full")
    jspec = jserve.Engine(_cfg(JModelConfig, spec_decode=3)
                          .with_head(**greedy), jp, index=js, head="midx")
    rs = spec.run(_reqs(tserve, toks))
    rf = full.run(_reqs(tserve, toks))
    rj = jspec.run(_reqs(jserve, toks))
    for rid in rs:
        np.testing.assert_array_equal(rs[rid].tokens, rf[rid].tokens)
        np.testing.assert_array_equal(rs[rid].tokens, rj[rid].tokens)
    assert spec.stats.spec_drafted > 0


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_spec_sampling_batched_equals_solo(fmt):
    _, _, tp, ts, toks = _base(fmt)
    eng = _engine(_cfg(TModelConfig, fmt, spec_decode=3), tp, ts)
    res = eng.run(_reqs(tserve, toks))
    assert eng.stats.spec_waves > 0
    for r in _reqs(tserve, toks):
        assert res[r.rid].tokens.shape == (r.max_new,)
        np.testing.assert_array_equal(res[r.rid].tokens, eng.replay_single(r))


def test_spec_acceptance_stats():
    _, _, tp, ts, toks = _base()
    eng = _engine(_cfg(TModelConfig, spec_decode=3), tp, ts)
    eng.run(_reqs(tserve, toks))
    s = eng.stats
    assert s.spec_waves > 0 and s.spec_drafted > 0
    assert s.spec_drafted % 3 == 0
    assert 0.0 <= s.accept_rate() <= 1.0
    assert s.spec_accepted <= s.spec_drafted
    assert s.steps == 3 * s.spec_waves
    # the reference's counters() contract, swap counters included
    assert set(s.counters()) == {"shed", "timeouts", "swap_rejected",
                                 "swaps"}
    assert "accept_rate" in s.summary() and "spec_waves" in s.summary()


@pytest.mark.parametrize("case", ["full_head", "ssm", "greedy_midx"])
def test_spec_refusals(case):
    _, _, tp, ts, _ = _base()
    if case == "full_head":
        with pytest.raises(ValueError, match="MIDX"):
            _engine(_cfg(TModelConfig, spec_decode=2), tp, ts, "full")
    elif case == "ssm":
        cfg = dataclasses.replace(_cfg(TModelConfig, spec_decode=2),
                                  family="ssm", ssm_state=16,
                                  ssm_head_dim=16)
        with pytest.raises(ValueError, match="rollback-free"):
            tserve.Engine(cfg, head="midx", device="cpu")
    else:
        with pytest.raises(ValueError, match="greedy"):
            _engine(_cfg(TModelConfig).with_head(decode_temperature=0.0),
                    tp, ts)


def _last_hidden(tp, tok):
    cfg = _cfg(TModelConfig)
    return prefill(cfg, tp, torch.from_numpy(tok[None]).long())[0][:, -1]


def test_rejection_sampler_preserves_target_distribution():
    """draft ~ q (two-stage MIDX), verify via spec_verify => committed
    first token ~ p = softmax(logits[:V] / T). TV between the committed
    histogram and p is small and well below TV(q, p): accepting drafts
    blindly would fail the second bound. All 4096 draws run as the rows of
    one draft call and one verify call, each row under its own wave key."""
    _, _, tp, ts, toks = _base()
    cfg = _cfg(TModelConfig)
    hidden = _last_hidden(tp, toks[0])                               # [1,D]
    v, n, temp = cfg.vocab_size, 4096, 0.5
    logits = logits_full(cfg, tp, hidden)[0, :v].double().numpy() / temp
    p = np.exp(logits - logits.max())
    p /= p.sum()
    h = hidden.expand(n, -1)
    keys = noise.row_keys(7, torch.arange(n), 0)
    d = heads.midx_spec_draft(cfg, tp, ts, h, keys, 1)
    ver = heads.spec_verify(cfg, tp, ts, h[None], d.tokens.T, d.log_q.T,
                            d.s1, d.s2, d.lse, keys, temperature=temp)
    committed = ver.tokens[0].numpy()
    drafted = d.tokens[:, 0].numpy()
    hist = np.bincount(committed, minlength=v)[:v] / n
    tv_committed = 0.5 * np.abs(hist - p).sum()
    qhist = np.bincount(drafted, minlength=v)[:v] / n
    tv_draft = 0.5 * np.abs(qhist - p).sum()
    assert tv_committed < 0.12, (tv_committed, tv_draft)
    assert tv_committed < tv_draft - 0.02, (tv_committed, tv_draft)


def test_spec_verify_greedy_commits_argmax():
    _, _, tp, ts, toks = _base()
    cfg = _cfg(TModelConfig)
    hidden = _last_hidden(tp, toks[1])
    best = int(torch.argmax(logits_full(cfg, tp, hidden)[0, :cfg.vocab_size]))
    for s in range(8):
        keys = noise.row_keys(s, 0, 0).reshape(1)
        d = heads.midx_spec_draft(cfg, tp, ts, hidden, keys, 1)
        ver = heads.spec_verify(cfg, tp, ts, hidden[None], d.tokens.T,
                                d.log_q.T, d.s1, d.s2, d.lse, keys,
                                temperature=0.0)
        assert int(ver.tokens[0, 0]) == best
        assert int(ver.n_commit[0]) == 1


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_spec_draft_tables_match_reference(fmt):
    jp, js, tp, ts, toks = _base(fmt)
    jcfg, tcfg = _cfg(JModelConfig, fmt), _cfg(TModelConfig, fmt)
    hidden = np.random.default_rng(5).standard_normal((3, 32)).astype(
        np.float32)
    jd = jheads.midx_spec_draft(jcfg, jp, js, jnp.asarray(hidden),
                                jax.random.split(jax.random.PRNGKey(0), 3),
                                4)
    td = heads.midx_spec_draft(tcfg, tp, ts, torch.from_numpy(hidden),
                               noise.row_keys(0, torch.arange(3), 0), 4)
    for name in ("s1", "s2", "lse"):
        np.testing.assert_allclose(getattr(td, name).numpy(),
                                   np.asarray(getattr(jd, name)), atol=TOL,
                                   rtol=TOL, err_msg=name)
    assert td.tokens.shape == (3, 4) and td.log_q.shape == (3, 4)
    # each draft's log q is the closed form over the returned tables
    idx = ts if fmt == "bf16" else ts.index
    lq = (td.s1.gather(1, idx.assign1[td.tokens])
          + td.s2.gather(1, idx.assign2[td.tokens]) - td.lse[:, None])
    np.testing.assert_allclose(td.log_q.numpy(), lq.numpy(), atol=TOL,
                               rtol=TOL)


def test_draft_hidden_follows_the_last_commit_and_rate_near_reference():
    """After every wave the slot's draft hidden is the backbone state at
    the last committed token's input position: the hidden that predicted
    the newest token (recomputed here by a whole prefill). The acceptance
    rate at T = 0.5 over 6 requests x 20 tokens lies within 0.15 of the
    reference engine's on the same params, index and prompts."""
    jp, js, tp, ts, _ = _base()
    rng = np.random.default_rng(11)
    toks = [rng.integers(0, 96, size=n).astype(np.int32)
            for n in (5, 9, 7, 11, 6, 8)]
    temp = dict(decode_temperature=0.5)
    tcfg = _cfg(TModelConfig, spec_decode=3).with_head(**temp)
    eng = _engine(tcfg, tp, ts)
    eng.start_run(_reqs(tserve, toks[:1], max_new=20))
    checked = 0
    while not eng.sched.done:
        eng.tick(0.0)
        for slot, ss in eng.sched.active.items():
            seq = np.concatenate([ss.request.tokens, ss.out[:-1]])
            want = _last_hidden(tp, seq.astype(np.int32))[0]
            np.testing.assert_allclose(eng._hdraft[slot].numpy(),
                                       want.numpy(), atol=TOL, rtol=TOL)
            checked += 1
    eng.finish_run()
    assert checked >= 3
    eng = _engine(tcfg, tp, ts)
    eng.run(_reqs(tserve, toks, max_new=20))
    jeng = jserve.Engine(_cfg(JModelConfig, spec_decode=3).with_head(**temp),
                         jp, index=js, head="midx")
    jeng.run(_reqs(jserve, toks, max_new=20))
    assert abs(eng.stats.accept_rate() - jeng.stats.accept_rate()) < 0.15, \
        (eng.stats.accept_rate(), jeng.stats.accept_rate())
