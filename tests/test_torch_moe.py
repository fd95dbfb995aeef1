"""The moe family of the port (`models/moe.py`, the moe branches of
`models/model.py`, `models/decode.py` and the engine) against the JAX
package on the CPU, at the reduced configs of `qwen2-moe-a2.7b` (a shared
expert, untied head) and `granite-moe-1b-a400m`, fp32.

Bars: the routing (each token's experts, and in the stable sort's order
each selection's keep and destination slot) exactly the reference's; the
expert output and the aux loss within 1e-4, as are `forward`'s hidden
and aux, `prefill`'s hidden and K/V and the paged decode steps; one train
step's loss within 1e-5 and every gradient within 1e-4 given the same
negatives (the pooled head, the router aux in the loss); the moe chunk
step's valid rows and pool K/V within 1e-4 of the reference's at
capacity factor 0.5 (capacity binds); the port's chunked greedy engine
and its greedy speculative engine (k = 4) token for token the
reference's at 0.5; interleaved serving equal to solo replays at 0.5.
Params and head states are the reference's init, carried over through
`repro_torch.bridge`. Inputs come from numpy seeds."""
import dataclasses
import functools

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
from repro.models import moe as jmoe
from repro.models.model import forward as jforward
from repro.models.model import init_params as jinit
from repro_torch import configs as tcfg
from repro_torch import serve as tserve
from repro_torch.bridge import (index_from_numpy, params_from_numpy,
                                params_to_numpy, tensor_from_numpy)
from repro_torch.core import midx, noise
from repro_torch.launch import steps
from repro_torch.models import decode as tdecode
from repro_torch.models.model import forward as tforward
from repro_torch.models.moe import apply_moe, capacity, route
from repro_torch.optim.optimizers import tree_leaves, tree_map

TOL, LOSS_TOL = 1e-4, 1e-5
ARCHS = ("qwen2-moe-a2.7b", "granite-moe-1b-a400m")
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


def _cfgs(arch, **kw):
    j = dataclasses.replace(jcfg.get_config(arch).reduced(), dtype="float32",
                            **kw)
    t = dataclasses.replace(tcfg.get_config(arch).reduced(), dtype="float32",
                            **kw)
    return j, t


def _params(jc, tc, seed):
    jp = jinit(jc, jax.random.PRNGKey(seed))
    tp = params_from_numpy(tc, jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jp, tp


def _index(jidx):
    return index_from_numpy({f: (getattr(jidx, f) if f == "kind"
                                 else np.asarray(getattr(jidx, f)))
                             for f in FIELDS}, device="cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jax_routing(p, x, top_k, factor):
    """The reference's routing of one sequence x [T, D] (`apply_moe`
    :162-184): (tope, keep, dest, the k-th minus the (k+1)-th prob)."""
    t = x.shape[0]
    e = p["router"].shape[-1]
    probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], axis=-1)
    _, tope = jax.lax.top_k(probs, top_k)
    cap = jmoe._capacity(t, e, top_k, factor)
    flat_e = tope.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = jnp.zeros((e,), jnp.int32).at[flat_e].add(1)
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                              jnp.cumsum(counts)[:-1]])
    rank = jnp.arange(t * top_k, dtype=jnp.int32) - starts[sorted_e]
    keep = rank < cap
    dest = jnp.where(keep, sorted_e * cap + rank, e * cap)
    srt = jnp.sort(probs, axis=-1)[:, ::-1]
    gap = srt[:, top_k - 1] - srt[:, top_k]
    return (np.asarray(tope), np.asarray(keep), np.asarray(dest),
            np.asarray(gap))


@pytest.mark.parametrize("factor", [0.5, 1.25])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_and_routing_match_reference(arch, factor):
    """Three sequences of 16 tokens dispatched at once, each alone: the
    routing exactly the reference's (vmapped over the rows, as its
    `_apply_ffn_part`), the output and the batch-mean aux within 1e-4."""
    jc, tc = _cfgs(arch)
    k = jc.num_experts_per_tok
    jp = jmoe.moe_init(jax.random.PRNGKey(7), jc.d_model, jc.d_ff,
                       jc.num_experts, jc.shared_expert_d_ff, jc.act)
    tp = jax.tree_util.tree_map(
        lambda a: tensor_from_numpy(np.asarray(a), "cpu"), jp)
    x = np.random.default_rng(7).standard_normal((3, 16, jc.d_model)) \
        .astype(np.float32)
    jy, jaux = jax.vmap(lambda xb: jmoe.apply_moe(
        jp, xb, top_k=k, capacity_factor=factor, act=jc.act))(jnp.asarray(x))
    ty, taux = apply_moe(tp, _t(x), top_k=k, capacity_factor=factor,
                         act=tc.act)
    r = route(tp, _t(x), top_k=k, capacity_factor=factor)
    assert r.cap == jmoe._capacity(16, jc.num_experts, k, factor) \
        == capacity(16, tc.num_experts, k, factor)
    dropped = 0
    for b in range(3):
        tope, keep, dest, gap = _jax_routing(jp, jnp.asarray(x[b]), k, factor)
        bad = np.flatnonzero((r.tope[b].numpy() != tope).any(-1))
        assert bad.size == 0, (
            f"row {b}: tokens {bad.tolist()} routed differently; k-th minus "
            f"(k+1)-th prob there {gap[bad].tolist()}"
            + (" (a near tie, within 1e-6)" if (gap[bad] < 1e-6).any()
               else ""))
        np.testing.assert_array_equal(r.keep[b].numpy(), keep)
        np.testing.assert_array_equal(r.dest[b].numpy(), dest)
        dropped += int((~keep).sum())
    assert (dropped > 0) == (factor < 1)     # 0.5 drops, 1.25 does not here
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(taux), float(jnp.mean(jaux)), atol=TOL,
                               rtol=TOL)
    # a row's bits do not depend on the other rows' values
    x2 = x.copy()
    x2[[0, 2]] = np.random.default_rng(8).standard_normal(x2[[0, 2]].shape)
    y2, _ = apply_moe(tp, _t(x2), top_k=k, capacity_factor=factor,
                      act=tc.act)
    assert torch.equal(y2[1], ty[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    """Hidden states and aux_loss (summed over layers / num_layers) at the
    config's capacity factor 1.25, two sequences of 24 (capacity 16 an
    expert for 48 selections over 4)."""
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc, tc, 1)
    toks = np.random.default_rng(1).integers(0, jc.vocab_size, (2, 24))
    jo = jforward(jc, jp, jnp.asarray(toks, jnp.int32))
    to = tforward(tc, tp, _t(toks).long())
    np.testing.assert_allclose(to["hidden"].numpy(), np.asarray(jo["hidden"]),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(to["aux_loss"]), float(jo["aux_loss"]),
                               atol=TOL, rtol=TOL)
    assert float(to["aux_loss"]) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_paged_decode_match_reference(arch):
    """Prefill (6 and 5 tokens into slots 0 and 1) hidden and K/V, then 4
    paged decode steps at per-slot positions and the pool, within 1e-4."""
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc, tc, 2)
    rng = np.random.default_rng(2)
    page, pps = 4, 4
    table = np.arange(1, 2 * pps + 1, dtype=np.int32).reshape(2, pps)
    jstate = jdecode.init_paged_state(jc, 2, 2 * pps + 1, page, pps)
    jstate["page_table"] = jnp.asarray(table)
    tstate = tdecode.init_paged_state(tc, 2, 2 * pps + 1, page, pps,
                                      device="cpu")
    tstate["page_table"][:] = _t(table).long()
    plens = (6, 5)
    for slot, plen in enumerate(plens):
        toks = rng.integers(0, jc.vocab_size, (1, plen))
        jh, jc_ = jdecode.prefill(jc, jp, jnp.asarray(toks, jnp.int32))
        th, tc_ = tdecode.prefill(tc, tp, _t(toks).long())
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL,
                                   rtol=TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(tc_[name].numpy(),
                                       np.asarray(jc_[name]), atol=TOL,
                                       rtol=TOL, err_msg=name)
        jstate = jdecode.write_prefill(jc, jstate, jc_, [slot], plen=plen)
        tdecode.write_prefill(tc, tstate, tc_, torch.tensor([slot]),
                              plen=plen)
    pos = np.asarray(plens)
    for step in range(4):
        tok = rng.integers(0, jc.vocab_size, 2)
        jh, jstate = jdecode.paged_decode_step(
            jc, jp, jnp.asarray(tok, jnp.int32), jnp.asarray(pos, jnp.int32),
            jstate)
        th, tstate = tdecode.paged_decode_step(tc, tp, _t(tok).long(),
                                               _t(pos).long(), tstate)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL,
                                   rtol=TOL, err_msg=f"decode {step}")
        pos = pos + 1
    for name in ("k", "v"):
        np.testing.assert_allclose(tstate[name][:, 1:].numpy(),
                                   np.asarray(jstate[name])[:, 1:],
                                   atol=TOL, rtol=TOL, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_loss_and_grads_match_reference(monkeypatch, arch):
    """The port's loss (pooled MIDX CE + router_aux_weight · aux) and every
    gradient against the reference's, its draw replaced by the port's
    negatives with log q from its own proposal table; then one AdamW step
    of the port is finite and moves the params."""
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc, tc, 3)
    jidx = jheads.init_head_state(jc, jp, jax.random.PRNGKey(4))
    tidx = _index(jidx)
    rng = np.random.default_rng(3)
    b, s = 2, 16
    toks = rng.integers(0, jc.vocab_size, (b, s))
    labels = rng.integers(0, jc.vocab_size, (b, s))
    batch = {"tokens": _t(toks).long(), "labels": _t(labels).long()}
    keys = noise.train_keys(0, 3, b * s)
    loss_fn = steps.make_loss_fn(tc)
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), tp)
    loss, metrics = loss_fn(leaves, tidx, batch, keys)
    flat = tree_leaves(leaves)
    got = iter(torch.autograd.grad(loss, flat))
    grads = tree_map(lambda _: next(got), leaves)
    assert float(metrics["aux"].detach()) > 0

    hidden = tforward(tc, tp, batch["tokens"])["hidden"]
    draw = midx.sample_pooled(tidx, hidden.float(), tc.head.num_negatives,
                              noise.sequence_keys(keys, s))
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
        out = jforward(jc, p, jnp.asarray(toks, jnp.int32))
        ce = jheads.loss_midx(jc, p, jidx, out["hidden"],
                              jnp.asarray(labels, jnp.int32),
                              jax.random.PRNGKey(0), fused=False)
        return ce + jc.router_aux_weight * out["aux_loss"]

    jl, jg = jax.value_and_grad(jloss)(jp)
    np.testing.assert_allclose(float(loss.detach()), float(jl), atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    a = params_to_numpy(tc, grads)
    bt = jax.tree_util.tree_map(np.asarray, jg)
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(bt)
    for (path, x), y in zip(jax.tree_util.tree_leaves_with_path(a),
                            jax.tree_util.tree_leaves(bt)):
        np.testing.assert_allclose(x, y, atol=TOL, rtol=TOL,
                                   err_msg=jax.tree_util.keystr(path))

    from repro_torch.optim import adamw
    opt = adamw(1e-3)
    before = tp["blocks"][0]["ffn"]["w_up"].clone()
    tstep = steps.make_train_step(tc, opt)
    _, _, m = tstep(tp, opt.init(tp), tidx, batch, keys)
    assert np.isfinite(float(m["loss"])) and m["skipped"] == 0.0
    assert not torch.equal(before, tp["blocks"][0]["ffn"]["w_up"])


def test_decode_matches_forward():
    """Teacher-forced decode steps reproduce forward() (qwen2-moe at its
    working dtype and capacity, reference `test_models.py:74`): 5e-2."""
    cfg = tcfg.get_config("qwen2-moe-a2.7b").reduced()
    from repro_torch.models import init_params
    params = init_params(cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 8))).long()
    ref = tforward(cfg, params, toks)["hidden"].float()
    state = tdecode.init_decode_state(cfg, 2, 8, device="cpu")
    outs = []
    for t in range(8):
        h, state = tdecode.decode_step(cfg, params, toks[:, t],
                                       torch.full((2,), t), state)
        outs.append(h.float())
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), ref.numpy(),
                               atol=5e-2, rtol=5e-2)


def test_chunk_prefill_step_matches_reference_at_binding_capacity():
    """Two moe chunk waves of 8 at capacity factor 0.5 (capacity 4 of 16
    selections: tokens dropped), both slots mid-prompt in the second:
    valid hidden rows and every pool page but the trash page within
    1e-4."""
    jc, tc = _cfgs("qwen2-moe-a2.7b", capacity_factor=0.5)
    jc = jc.with_serve(max_slots=2, page_size=4, max_seq=32)
    tc = tc.with_serve(max_slots=2, page_size=4, max_seq=32)
    jp, tp = _params(jc, tc, 6)
    sv = tc.serve
    rng = np.random.default_rng(6)
    table = (1 + rng.permutation(sv.resolved_num_pages - 1)
             [:2 * sv.pages_per_slot]).reshape(2, -1).astype(np.int32)
    state = tdecode.init_paged_state(tc, 2, sv.resolved_num_pages,
                                     sv.page_size, sv.pages_per_slot,
                                     device="cpu")
    state["page_table"].copy_(_t(table).long())
    jstate = jdecode.init_paged_state(jc, 2, sv.resolved_num_pages,
                                      sv.page_size, sv.pages_per_slot)
    jstate["page_table"] = jnp.asarray(table)
    for starts, lens in (((0, 0), (8, 0)), ((8, 0), (5, 8))):
        toks = rng.integers(0, jc.vocab_size, (2, 8)).astype(np.int32)
        start, length = np.asarray(starts), np.asarray(lens)
        jh, jstate = jdecode.chunk_prefill_step(
            jc, jp, jnp.asarray(toks), jnp.asarray(start),
            jnp.asarray(length), jstate)
        th, state = tdecode.chunk_prefill_step(
            tc, tp, _t(toks).long(), _t(start).long(), _t(length).long(),
            state)
        valid = np.arange(8)[None, :] < length[:, None]
        np.testing.assert_allclose(th.numpy()[valid], np.asarray(jh)[valid],
                                   atol=TOL, rtol=TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(state[name][:, 1:].numpy(),
                                       np.asarray(jstate[name])[:, 1:],
                                       atol=TOL, rtol=TOL, err_msg=name)


@functools.lru_cache(maxsize=None)
def _engines_base():
    """The reference engine's params and MIDX index for the reduced qwen2
    at capacity factor 0.5 (PRNGKey(8)), and the port's copies."""
    jc, tc = _cfgs("qwen2-moe-a2.7b", capacity_factor=0.5)
    serve = dict(max_slots=2, page_size=4, max_seq=48)
    jeng = jserve.Engine(jc.with_serve(**serve), head="midx",
                         init_key=jax.random.PRNGKey(8))
    tp = params_from_numpy(tc, jax.tree_util.tree_map(np.asarray,
                                                      jeng.params),
                           device="cpu")
    return jc, tc, serve, jeng.params, jeng.index, tp, _index(jeng.index)


def _reqs(mod, toks, max_new):
    return [mod.Request(rid=i, tokens=np.asarray(t, np.int32),
                        max_new=max_new, seed=2) for i, t in enumerate(toks)]


def test_chunked_and_speculative_greedy_match_reference_engines():
    """At capacity factor 0.5: the greedy full head prefilled in chunks of
    8 (a 13-token prompt in two chunks, a 7-token one in one chunk beside
    it decoding) token for token the reference's chunked engine; greedy
    speculative decoding (k = 4: a verify pass of 4 tokens dispatches at
    capacity 4, which never binds) token for token the reference's
    speculative engine and the port's plain greedy full head."""
    jc, tc, serve, jp, ji, tp, ti = _engines_base()
    greedy = dict(decode_temperature=0.0)
    rng = np.random.default_rng(9)
    toks = [rng.integers(0, jc.vocab_size, size=n) for n in (13, 7)]
    chunked = dict(serve, prefill_chunk=8)
    jres = jserve.Engine(jc.with_serve(**chunked).with_head(**greedy), jp,
                         index=ji, head="full").run(_reqs(jserve, toks, 6))
    teng = tserve.Engine(tc.with_serve(**chunked).with_head(**greedy), tp,
                         index=ti, head="full", device="cpu")
    tres = teng.run(_reqs(tserve, toks, 6))
    assert teng.stats.prefill_chunks == 3
    for rid in tres:
        np.testing.assert_array_equal(tres[rid].tokens, jres[rid].tokens)
    spec = dict(serve, spec_decode=4)
    jspec = jserve.Engine(jc.with_serve(**spec).with_head(**greedy), jp,
                          index=ji, head="midx").run(_reqs(jserve, toks, 9))
    tspec_eng = tserve.Engine(tc.with_serve(**spec).with_head(**greedy), tp,
                              index=ti, head="midx", device="cpu")
    tspec = tspec_eng.run(_reqs(tserve, toks, 9))
    plain = tserve.Engine(tc.with_serve(**serve).with_head(**greedy), tp,
                          index=ti, head="full", device="cpu").run(
        _reqs(tserve, toks, 9))
    assert tspec_eng.stats.spec_drafted > 0
    for rid in tspec:
        np.testing.assert_array_equal(tspec[rid].tokens, jspec[rid].tokens)
        np.testing.assert_array_equal(tspec[rid].tokens, plain[rid].tokens)


def test_engine_interleaved_matches_single():
    """qwen2-moe at capacity factor 0.5 (reference `test_serve.py:197`):
    requests of different lengths interleaved on 2 slots give each
    request's solo replay, token for token: dispatch stays in a row."""
    cfg = dataclasses.replace(tcfg.get_config("qwen2-moe-a2.7b").reduced(),
                              capacity_factor=0.5)
    cfg = cfg.with_serve(max_slots=2, page_size=4, max_seq=32)
    rng = np.random.default_rng(0)
    reqs = [tserve.Request(rid=i, tokens=rng.integers(
        0, cfg.vocab_size, size=int(n)).astype(np.int32), max_new=int(m),
        seed=3) for i, (n, m) in enumerate([(6, 5), (9, 7), (6, 3), (11, 6)])]
    eng = tserve.Engine(cfg, head="midx", device="cpu", seed=1)
    res = eng.run(reqs)
    assert eng.stats.waves >= 2
    for r in reqs:
        assert res[r.rid].tokens.shape == (r.max_new,)
        np.testing.assert_array_equal(res[r.rid].tokens,
                                      eng.replay_single(r))
