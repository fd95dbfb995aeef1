"""The mamba2 (`ssm`) slice of the port against the JAX package on the CPU,
from the same params carried across by `repro_torch.bridge`: the block and
its decode carry, the forward, the losses and every gradient, prefill and
paged decode, greedy serving through `Engine`, and `train_loop`.

The config is `mamba2-370m` reduced (2 layers, d=64, N=16, P=16, H=8,
chunk 8), fp32. Inputs are made with numpy from a seed. Tolerances: 1e-5
(atol and rtol) on outputs, carries, losses and gradients, the
reference's own bar. At a chunk of 32 the reference's gradients are NaN
(its `where(mask, exp(decay), 0)` overflows above the diagonal); the
port's are held to the reference's at chunk 8 within
1e-4·max(1, max |ref|) per leaf (chunkings differ only in rounding), and
to the reference's at chunk 32 within 1e-5 on the leaves that are finite
there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro import serve as jserve
from repro.core import midx as jmidx
from repro.models import decode as jdecode
from repro.models import heads as jheads
from repro.models import mamba2 as jmamba
from repro.models.model import forward as jforward
from repro.models.model import init_params as jinit
from repro_torch import configs as tcfg
from repro_torch import serve as tserve
from repro_torch.bridge import (index_from_numpy, params_from_numpy,
                                params_to_numpy)
from repro_torch.core import midx, noise
from repro_torch.kernels.ssd_scan import cuda as ssd_cuda
from repro_torch.launch.train import train_loop
from repro_torch.models import decode as tdecode
from repro_torch.models import heads
from repro_torch.models import mamba2 as tmamba
from repro_torch.models.model import forward as tforward
from repro_torch.optim.optimizers import tree_leaves, tree_map

TOL = 1e-5
ARCH = "mamba2-370m"
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


def _cfgs(**kw):
    out = []
    for mod in (jcfg, tcfg):
        c = dataclasses.replace(mod.get_config(ARCH).reduced(),
                                dtype="float32", **kw)
        out.append(c)
    return out


def _setup(seed=0, **kw):
    jc, tc = _cfgs(**kw)
    jp = jinit(jc, jax.random.PRNGKey(seed))
    tp = params_from_numpy(tc, jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jc, tc, jp, tp


def _close(a, b, err_msg="", tol=TOL):
    np.testing.assert_allclose(np.asarray(a.detach() if torch.is_tensor(a)
                                          else a),
                               np.asarray(b), atol=tol, rtol=tol,
                               err_msg=err_msg)


def _grads(loss, leaves):
    got = iter(torch.autograd.grad(loss, tree_leaves(leaves)))
    return params_to_numpy(None, tree_map(lambda _: next(got), leaves))


def _paths(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in
            jax.tree_util.tree_leaves_with_path(tree)]


def _trees_close(port_np, jax_tree, tol=TOL):
    a, b = _paths(port_np), _paths(jax_tree)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        np.testing.assert_allclose(x, y, atol=tol, rtol=tol, err_msg=path)


def _mamba_kw(c):
    return dict(d_state=c.ssm_state, head_dim=c.ssm_head_dim,
                expand=c.ssm_expand)


def test_bridge_carries_the_mamba_leaves_both_ways_bit_for_bit():
    jc, tc, jp, tp = _setup()
    assert set(tp["blocks"][0]) == {"ln1", "mamba"}
    back = params_to_numpy(tc, tp)
    for (path, x), (_, y) in zip(_paths(back), _paths(jp)):
        assert x.dtype == y.dtype and np.array_equal(x, y), path
    np.testing.assert_array_equal(tp["blocks"][1]["mamba"]["a_log"].numpy(),
                                  np.log(np.arange(1, 9, dtype=np.float32)))


@pytest.mark.parametrize("s,chunk", [(16, 8), (2, 2)])
def test_block_output_and_decode_carry_match(s, chunk):
    """apply_mamba2 with return_state: the output and the carry (the last
    W−1 pre-conv inputs, left-padded when S < W−1, and h_last)."""
    jc, tc, jp, tp = _setup(seed=1)
    x = np.random.default_rng(1).standard_normal((2, s, tc.d_model)) \
        .astype(np.float32)
    jblock = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["mamba"])
    jy, jst = jmamba.apply_mamba2(jblock, jnp.asarray(x), chunk=chunk,
                                  return_state=True, **_mamba_kw(jc))
    ty, tst = tmamba.apply_mamba2(tp["blocks"][0]["mamba"],
                                  torch.from_numpy(x), chunk=chunk,
                                  return_state=True, **_mamba_kw(tc))
    _close(ty, jy, "out")
    assert set(tst) == set(jst)
    empty = tmamba.mamba2_decode_state(
        2, tc.d_model, conv_width=tc.ssm_conv_width, **_mamba_kw(tc))
    for k in jst:
        assert tuple(tst[k].shape) == jst[k].shape == tuple(empty[k].shape)
        _close(tst[k], jst[k], k)
    # one decode step from the carry
    x1 = np.random.default_rng(2).standard_normal((2, 1, tc.d_model)) \
        .astype(np.float32)
    jy1, jst1 = jmamba.decode_mamba2(jblock, jnp.asarray(x1), jst,
                                     **_mamba_kw(jc))
    ty1, tst1 = tmamba.decode_mamba2(tp["blocks"][0]["mamba"],
                                     torch.from_numpy(x1), tst,
                                     **_mamba_kw(tc))
    _close(ty1, jy1, "decode out")
    for k in jst1:
        _close(tst1[k], jst1[k], f"decode {k}")


def test_forward_hidden_states_match():
    jc, tc, jp, tp = _setup(seed=2)
    toks = np.random.default_rng(2).integers(0, jc.vocab_size, (2, 16))
    jh = jforward(jc, jp, jnp.asarray(toks, jnp.int32))["hidden"]
    th = tforward(tc, tp, torch.from_numpy(toks))["hidden"]
    _close(th, jh)


def _batch(jc, seed, s=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jc.vocab_size, (2, s)).astype(np.int32)
    labels = rng.integers(0, jc.vocab_size, (2, s)).astype(np.int32)
    return toks, labels


def _port_full_loss_and_grads(tc, tp, toks, labels):
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), tp)
    hidden = tforward(tc, leaves, torch.from_numpy(toks).long())["hidden"]
    loss = heads.loss_full(tc, leaves, hidden,
                           torch.from_numpy(labels).long())
    return loss, _grads(loss, leaves)


def _jax_full_loss_and_grads(jc, jp, toks, labels):
    def jloss(p):
        h = jforward(jc, p, jnp.asarray(toks))["hidden"]
        return jheads.loss_full(jc, p, h, jnp.asarray(labels))
    return jax.value_and_grad(jloss)(jp)


def test_loss_full_and_every_grad_match():
    jc, tc, jp, tp = _setup(seed=3)
    toks, labels = _batch(jc, 3)
    loss, grads = _port_full_loss_and_grads(tc, tp, toks, labels)
    jl, jg = _jax_full_loss_and_grads(jc, jp, toks, labels)
    _close(loss, jl, "loss")
    _trees_close(grads, jg)


def test_loss_midx_pooled_and_every_grad_match_given_the_same_negatives(
        monkeypatch):
    """The config's own head (pooled MIDX): the reference draws the port's
    negatives and takes log q from its own proposal table for them, as
    `test_torch_sampled_ce_shared.py` does for the dense family."""
    jc, tc, jp, tp = _setup(seed=4)
    assert tc.head.proposal == "pooled"
    jidx = jheads.init_head_state(jc, jp, jax.random.PRNGKey(5))
    tidx = index_from_numpy(
        {f: (getattr(jidx, f) if f == "kind" else np.asarray(getattr(jidx, f)))
         for f in FIELDS}, device="cpu")
    toks, labels = _batch(jc, 4)
    keys = noise.train_keys(0, 3, toks.size)
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), tp)
    hidden = tforward(tc, leaves, torch.from_numpy(toks).long())["hidden"]
    loss = heads.loss_midx(tc, leaves, tidx, hidden,
                           torch.from_numpy(labels).long(), keys)
    grads = _grads(loss, leaves)
    draw = midx.sample_pooled(tidx, hidden.detach(), tc.head.num_negatives,
                              noise.sequence_keys(keys, toks.shape[1]))
    ids = jnp.asarray(draw.ids.numpy().astype(np.int32))
    kk = jidx.codebook1.shape[0]
    cluster = jidx.assign1[ids] * kk + jidx.assign2[ids]

    def same_negatives(index, key, flat_log, m, member_fn=None):
        lse = jax.nn.logsumexp(flat_log, axis=-1, keepdims=True)
        log_q = (jnp.take_along_axis(flat_log, cluster, axis=-1)
                 - index.log_counts.reshape(-1)[cluster] - lse)
        return jmidx.Draw(ids, log_q)

    monkeypatch.setattr(jmidx, "_shared_draw", same_negatives)

    def jloss(p):
        h = jforward(jc, p, jnp.asarray(toks))["hidden"]
        return jheads.loss_midx(jc, p, jidx, h, jnp.asarray(labels),
                                jax.random.PRNGKey(0), fused=False)

    jl, jg = jax.value_and_grad(jloss)(jp)
    _close(loss, jl, "loss")
    _trees_close(grads, jg)


def test_long_chunk_gradients_are_finite_where_the_reference_is_nan():
    """Chunk 32 at S = 64: the reference's a_log, dt_bias and dt_proj
    gradients are NaN; the port's are all finite, equal the reference's at
    chunk 8, and equal the reference's at chunk 32 on every leaf that is
    finite there."""
    jc32, tc32, jp, tp = _setup(seed=6, ssm_chunk=32)
    jc8 = dataclasses.replace(jc32, ssm_chunk=8)
    toks, labels = _batch(jc32, 6, s=64)
    _, jg32 = _jax_full_loss_and_grads(jc32, jp, toks, labels)
    _, jg8 = _jax_full_loss_and_grads(jc8, jp, toks, labels)
    loss, grads = _port_full_loss_and_grads(tc32, tp, toks, labels)
    assert np.isfinite(float(loss.detach()))
    ref32 = dict(_paths(jg32))
    for leaf in ("a_log", "dt_bias", "dt_proj"):
        assert np.isnan(ref32[f"['blocks']['mamba']['{leaf}']"]).any(), leaf
    finite32 = 0
    for (path, x), (_, y8) in zip(_paths(grads), _paths(jg8)):
        assert np.isfinite(x).all(), path
        assert np.isfinite(y8).all(), path
        np.testing.assert_allclose(
            x, y8, atol=1e-4 * max(1.0, float(np.abs(y8).max())), rtol=0,
            err_msg=path)
        y32 = ref32[path]
        if np.isfinite(y32).all():
            finite32 += 1
            np.testing.assert_allclose(x, y32, atol=TOL, rtol=TOL,
                                       err_msg=path)
    assert finite32 > 0


def test_prefill_and_paged_decode_match():
    """Prefill two prompts (6 tokens: one chunk of 6; 16 tokens: two
    chunks of 8) into slots 1 and 0 of a paged state, then 4 decode steps
    of both slots: hidden states and carries within 1e-5."""
    jc, tc, jp, tp = _setup(seed=7)
    rng = np.random.default_rng(7)
    jstate = jdecode.init_paged_state(jc, 2, 9, 4, 4)
    tstate = tdecode.init_paged_state(tc, 2, 9, 4, 4, device="cpu")
    assert "page_table" not in tstate and set(tstate) == set(jstate)
    for slot, plen in ((1, 6), (0, 16)):
        toks = rng.integers(0, jc.vocab_size, (1, plen)).astype(np.int32)
        jh, jcache = jdecode.prefill(jc, jp, jnp.asarray(toks))
        th, tcache = tdecode.prefill(tc, tp, torch.from_numpy(toks).long())
        _close(th, jh, f"prefill {plen} hidden")
        for k in jcache:
            _close(tcache[k], jcache[k], f"prefill {plen} {k}")
        jstate = jdecode.write_prefill(jc, jstate, jcache, [slot], plen=plen)
        tdecode.write_prefill(tc, tstate, tcache, torch.tensor([slot]),
                              plen=plen)
    pos = np.array([16, 6], np.int32)
    for step in range(4):
        tok = rng.integers(0, jc.vocab_size, 2).astype(np.int32)
        jh, jstate = jdecode.paged_decode_step(jc, jp, jnp.asarray(tok),
                                               jnp.asarray(pos), jstate)
        th, tstate = tdecode.paged_decode_step(
            tc, tp, torch.from_numpy(tok).long(),
            torch.from_numpy(pos).long(), tstate)
        _close(th, jh, f"decode {step}")
        pos = pos + 1
    for k in jstate:
        _close(tstate[k], jstate[k], f"carry {k}")
    tdecode.reset_slot(tstate, 1)
    assert all(float(tstate[k][:, 1].abs().max()) == 0 for k in tstate)


def _serve_cfgs():
    return [c.with_head(decode_temperature=0.0)
            .with_serve(max_slots=3, page_size=4, max_seq=28)
            for c in _cfgs()]


def _requests(mod, vocab):
    rng = np.random.default_rng(8)
    return [mod.Request(rid=i, tokens=rng.integers(0, vocab, size=plen)
                        .astype(np.int32), max_new=n, seed=3)
            for i, (plen, n) in enumerate(((5, 6), (16, 5), (5, 3),
                                           (16, 7)))]


def test_greedy_full_head_is_token_identical_to_reference_engine():
    """Prompts of 5 (one chunk of 5) and 16 tokens (two chunks of 8)."""
    jc, tc = _serve_cfgs()
    jp = jinit(jc, jax.random.PRNGKey(9))
    tp = params_from_numpy(tc, jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    jres = jserve.Engine(jc, jp, head="full").run(
        _requests(jserve, jc.vocab_size))
    teng = tserve.Engine(tc, tp, head="full", device="cpu")
    tres = teng.run(_requests(tserve, tc.vocab_size))
    assert teng.stats.waves >= 2
    for rid in jres:
        assert tres[rid].status == "ok"
        np.testing.assert_array_equal(tres[rid].tokens, jres[rid].tokens,
                                      err_msg=f"rid {rid}")


@pytest.mark.parametrize("head", ["midx", "rff-fused"])
def test_engine_batched_equals_solo(head):
    tc = dataclasses.replace(tcfg.get_config(ARCH).reduced(),
                             dtype="float32").with_serve(
        max_slots=3, page_size=4, max_seq=28)
    eng = tserve.Engine(tc, head=head, device="cpu", seed=1)
    reqs = _requests(tserve, tc.vocab_size)
    before = ssd_cuda.ssd_scan_cuda.launches
    res = eng.run(reqs)
    assert ssd_cuda.ssd_scan_cuda.launches == before    # the CPU path
    for r in reqs:
        assert res[r.rid].status == "ok"
        np.testing.assert_array_equal(res[r.rid].tokens,
                                      eng.replay_single(r))


def test_train_loop_is_finite_applied_and_replays_bit_for_bit():
    tc = tcfg.get_config(ARCH).reduced()
    kw = dict(steps=4, batch_size=2, seq_len=16, lr=1e-3, refresh_every=2,
              device="cpu", log_every=1000)
    seen = []
    runs = [train_loop(tc, on_metrics=lambda s, m: seen.append(m), **kw),
            train_loop(tc, **kw)]
    assert len(seen) == 4 and not any(m["skipped"] for m in seen)
    assert np.all(np.isfinite(runs[0][3]))
    assert runs[0][3] == runs[1][3]
    p0 = runs[0][0]
    for a, b in zip(tree_leaves(p0), tree_leaves(runs[1][0])):
        assert torch.equal(a, b)
    init = train_loop(tc, **{**kw, "steps": 0})[0]
    assert not torch.equal(init["blocks"][0]["mamba"]["a_log"],
                           p0["blocks"][0]["mamba"]["a_log"])
