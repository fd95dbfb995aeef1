"""The training slice of the port against the JAX package on the CPU: the
data pipeline, the weights carried both ways, the heads' losses and every
parameter gradient, the optimizer and schedule, a train step, the index
refresh and lifecycle, and `train_loop` end to end.

Inputs are made with numpy from a seed. Tolerances: 1e-5 (atol and rtol)
on fp32 losses and gradients given the same negatives, the bar of
`tests/test_fused_head.py`; 1e-6 on the optimizer's params over 5 steps;
1e-5 on params after one full-head train step; exact on integer index
fields, batches and the corpus."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.core import midx as jmidx
from repro.data import ZipfLM as JZipfLM
from repro.data import make_lm_stream as jstream
from repro.index import lifecycle as jlifecycle
from repro.index.build import build as jbuild
from repro.index.build import reassign as jreassign
from repro.index.build import refresh as jrefresh
from repro.kernels.sampled_ce.ref import sampled_ce_pt_ref as jce_ref
from repro.launch import steps as jsteps
from repro.models import heads as jheads
from repro.models.model import class_embeddings as jclass_embeddings
from repro.models.model import forward as jforward
from repro.models.model import init_params as jinit
from repro.optim import adamw as jadamw
from repro.optim import clip_by_global_norm as jclip
from repro.optim import cosine_schedule as jcosine
from repro.optim import sgd as jsgd
from repro.resilience.validate import validate_index as jvalidate_index
from repro_torch import configs as tcfg
from repro_torch.bridge import (index_from_numpy, index_to_numpy,
                                params_from_numpy, params_to_numpy)
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import midx, noise
from repro_torch.data import ZipfLM, make_lm_stream
from repro_torch.index import lifecycle
from repro_torch.index.build import build, reassign, refresh
from repro_torch.kernels.midx_probs.ops import proposal_tables
from repro_torch.launch import steps
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import train_loop
from repro_torch.models import heads
from repro_torch.models.model import forward as tforward
from repro_torch.optim import (adamw, clip_by_global_norm, cosine_schedule,
                               sgd)
from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.proposals import registry as proposals_registry
from repro_torch.resilience.validate import validate_index, validate_state

TOL = 1e-5
FIELDS = ("kind", "codebook1", "codebook2", "assign1", "assign2",
          "residuals", "sorted_ids", "offsets", "counts", "log_counts")
B, S = 2, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: when test files run in parallel worker
    processes, torch's thread pools oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**head):
    j = jcfg.get_config("paper-lm").reduced()
    t = tcfg.get_config("paper-lm").reduced()
    j = dataclasses.replace(j, dtype="float32").with_head(**head)
    t = dataclasses.replace(t, dtype="float32").with_head(**head)
    return j, t


def _jax_index_np(jidx):
    return {f: (getattr(jidx, f) if f == "kind" else np.asarray(getattr(jidx, f)))
            for f in FIELDS}


def _setup(seed=0, **head):
    jc, tc = _cfgs(**head)
    jp = jinit(jc, jax.random.PRNGKey(seed))
    tp = params_from_numpy(tc, jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    jidx = jheads.init_head_state(jc, jp, jax.random.PRNGKey(seed + 1))
    tidx = index_from_numpy(_jax_index_np(jidx), device="cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    return jc, tc, jp, tp, jidx, tidx, toks, labels


def _grad_tree(loss, leaves):
    flat = tree_leaves(leaves)
    got = iter(torch.autograd.grad(loss, flat))
    return tree_map(lambda _: next(got), leaves)


def _assert_trees_close(tc, port_tree, jax_tree, atol=TOL, rtol=TOL):
    a = params_to_numpy(tc, port_tree)
    b = jax.tree_util.tree_map(np.asarray, jax_tree)
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for (path, x), y in zip(jax.tree_util.tree_leaves_with_path(a),
                            jax.tree_util.tree_leaves(b)):
        np.testing.assert_allclose(x, y, atol=atol, rtol=rtol,
                                   err_msg=jax.tree_util.keystr(path))


# ------------------------------------------------------------------ data
def test_zipf_corpus_and_batches_match():
    kw = dict(vocab_size=300, num_clusters=8, seq_len=17, seed=3)
    a, b = ZipfLM(**kw).sample(24), JZipfLM(**kw).sample(24)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ZipfLM(**kw).sample(5, seed=9),
                                  JZipfLM(**kw).sample(5, seed=9))
    ts, js = make_lm_stream(a, 4, seed=2), jstream(b, 4, seed=2)
    for step in (0, 1, 57):
        tb, jb = ts.batch_at(step), js.batch_at(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(tb[k], jb[k])
            assert tb[k].dtype == jb[k].dtype


# ------------------------------------------------------------------ bridge
def test_weights_round_trip_bitwise():
    jc, tc, jp, tp, jidx, tidx, _, _ = _setup()
    back = params_to_numpy(tc, tp)
    want = jax.tree_util.tree_map(np.asarray, jp)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(want)
    for x, y in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    got = index_to_numpy(tidx)
    for f, v in _jax_index_np(jidx).items():
        if f == "kind":
            assert got[f] == v
        else:
            assert got[f].dtype == v.dtype and np.array_equal(got[f], v), f
    # and a bf16 leaf crosses both ways unrounded
    bf = jnp.asarray(np.linspace(-3, 3, 7, dtype=np.float32)).astype(
        jnp.bfloat16)
    tree = {"embed": np.asarray(bf), "blocks": {"w": np.asarray(bf)[None]}}
    back = params_to_numpy(tc, params_from_numpy(
        dataclasses.replace(tc, num_layers=1), tree, device="cpu"))
    assert back["embed"].dtype == np.asarray(bf).dtype
    assert np.array_equal(back["embed"], np.asarray(bf))


# ------------------------------------------------------------------ heads
def test_loss_midx_and_every_grad_match_jax_given_the_same_negatives():
    jc, tc, jp, tp, jidx, tidx, toks, labels = _setup(proposal="per_token")
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), tp)
    tt = torch.from_numpy(toks).long()
    tl = torch.from_numpy(labels).long()
    keys = noise.train_keys(0, 3, B * S)
    hidden = tforward(tc, leaves, tt)["hidden"]
    loss = heads.loss_midx(tc, leaves, tidx, hidden, tl, keys)
    grads = _grad_tree(loss, leaves)
    h32 = hidden.detach().reshape(B * S, -1)
    draw = midx.sample_twostage(tidx, h32, tc.head.num_negatives, keys,
                                tables_fn=proposal_tables)
    ids = jnp.asarray(draw.ids.numpy().astype(np.int32))

    def jloss(p):
        h = jforward(jc, p, jnp.asarray(toks))["hidden"].astype(jnp.float32)
        h = h.reshape(B * S, -1)
        lq = jmidx.log_prob(jidx, h, ids)
        return jnp.mean(jce_ref(h, jclass_embeddings(jc, p), lq, ids,
                                jnp.asarray(labels).reshape(-1)))

    jl, jg = jax.value_and_grad(jloss)(jp)
    np.testing.assert_allclose(float(loss.detach()), float(jl), atol=TOL,
                               rtol=TOL)
    _assert_trees_close(tc, grads, jg)


def test_loss_midx_gradient_reaches_hidden_through_log_q():
    """log q is not stop-gradient'ed: detaching it changes d(loss)/dh."""
    jc, tc, jp, tp, jidx, tidx, toks, labels = _setup(seed=1)
    rng = np.random.default_rng(1)
    hidden = torch.from_numpy(rng.standard_normal((B, S, tc.d_model))
                              .astype(np.float32)).requires_grad_(True)
    keys = noise.train_keys(0, 0, B * S)
    tl = torch.from_numpy(labels).long()
    g1, = torch.autograd.grad(heads.loss_midx(tc, tp, tidx, hidden, tl, keys),
                              hidden)
    draw = midx.sample_twostage(tidx, hidden.detach().reshape(B * S, -1),
                                tc.head.num_negatives, keys,
                                tables_fn=proposal_tables)
    from repro_torch.kernels.sampled_ce.ops import sampled_ce_pt_op
    l2 = sampled_ce_pt_op(hidden.reshape(B * S, -1), tp["embed"], draw.log_q,
                          draw.ids, tl.reshape(-1)).mean()
    g2, = torch.autograd.grad(l2, hidden)
    assert float((g1 - g2).abs().max()) > 1e-6


def test_loss_full_and_every_grad_match_jax():
    jc, tc, jp, tp, _, _, toks, labels = _setup(seed=2)
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), tp)
    hidden = tforward(tc, leaves, torch.from_numpy(toks).long())["hidden"]
    loss = heads.loss_full(tc, leaves, hidden,
                           torch.from_numpy(labels).long())
    grads = _grad_tree(loss, leaves)

    def jloss(p):
        h = jforward(jc, p, jnp.asarray(toks))["hidden"]
        return jheads.loss_full(jc, p, h, jnp.asarray(labels))

    jl, jg = jax.value_and_grad(jloss)(jp)
    np.testing.assert_allclose(float(loss.detach()), float(jl), atol=TOL,
                               rtol=TOL)
    _assert_trees_close(tc, grads, jg)


def test_unported_heads_raise():
    _, tc, _, tp, _, tidx, toks, labels = _setup()
    # the drift policy is ported: it runs and reports its branch
    _, m = heads.refresh_head_state_with_policy(
        tc, tp, tidx, torch.Generator().manual_seed(0), policy="drift")
    assert float(m["did_full"]) in (0.0, 1.0)
    # the generic contenders train: a uniform head's loss runs
    loss_fn = steps.make_loss_fn(tc, head_mode="uniform")
    assert loss_fn.proposal.name == "uniform"
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()}
    loss, m = loss_fn(tp, {"n": tc.padded_vocab}, batch,
                      noise.train_keys(0, 0, B * S))
    assert torch.isfinite(loss) and float(m["ce"]) > 0


# ------------------------------------------------------------------ optim
@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_optimizer_schedule_and_clip_match_over_five_steps(name):
    rng = np.random.default_rng(4)
    def tree(scale):
        def leaf(*shape):
            return (scale * rng.standard_normal(shape)).astype(np.float32)
        return {"a": leaf(3, 4), "blocks": [{"w": leaf(5)}, {"w": leaf(5)}]}

    p0 = tree(1.0)
    grads = [tree(3.0) for _ in range(5)]
    sched = dict(warmup_steps=2, total_steps=5)
    jmake, tmake = {"adamw": (jadamw, adamw), "sgd": (jsgd, sgd)}[name]
    jopt = jmake(jcosine(1e-2, **sched))
    topt = tmake(cosine_schedule(1e-2, **sched))
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = tree_map(torch.from_numpy, p0)
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        jg, jn = jclip(jax.tree_util.tree_map(jnp.asarray, g), 1.0)
        tg, tn = clip_by_global_norm(tree_map(torch.from_numpy, g), 1.0)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        jp, js = jopt.update(jg, js, jp)
        tp, ts = topt.update(tg, ts, tp)
    for x, y in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-6,
                                   rtol=1e-6)
    assert ts.step == int(js.step) == 5
    for s in (0, 1, 2, 3, 5, 9):
        np.testing.assert_allclose(cosine_schedule(3e-3, 2, 5)(s),
                                   float(jcosine(3e-3, 2, 5)(jnp.int32(s))),
                                   rtol=1e-6)


# The functional AdamW and SGD the port had before its optimizer updated in
# place (`src/repro_torch/optim/optimizers.py` of that tree): the oracle
# the in-place update must equal bit for bit.
def _oracle_adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01):
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)      # noqa: E731

    def update(grads, state, params):
        step = state.step + 1
        lr_t = lr(step)
        b1c = float(1.0 - f32(b1) ** f32(step))
        b2c = float(1.0 - f32(b2) ** f32(step))

        def upd(g, m, v, p):
            g = g.float()
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mh = m / b1c
            vh = v / b2c
            delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
            return (p.float() - lr_t * delta).to(p.dtype), m, v

        out = tree_map(upd, grads, state.mu, state.nu, params)
        pick = lambda i: tree_map(lambda o: o[i], out)      # noqa: E731
        return pick(0), type(state)(step, pick(1), pick(2))

    return update


def _oracle_sgd(lr, momentum=0.9, nesterov=False):
    def update(grads, state, params):
        step = state.step + 1
        lr_t = lr(step)

        def upd(g, m, p):
            g = g.float()
            m = momentum * m + g
            d = g + momentum * m if nesterov else m
            return (p.float() - lr_t * d).to(p.dtype), m

        out = tree_map(upd, grads, state.mu, params)
        pick = lambda i: tree_map(lambda o: o[i], out)      # noqa: E731
        return pick(0), type(state)(step, pick(1), None)

    return update


def _oracle_clip(grads, max_norm):
    leaves = tree_leaves(grads)
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["adamw", "sgd", "sgd-nesterov"])
def test_in_place_optimizer_equals_the_functional_one_bitwise(
        monkeypatch, name, dtype):
    """Five clipped steps of the in-place update, in groups small enough
    that the leaves split over several, give the functional version's
    bits: params, moments and the clip's norm; the update returns the
    objects it was given."""
    from repro_torch.optim import optimizers
    monkeypatch.setattr(optimizers, "GROUP_ELEMS", 50)
    rng = np.random.default_rng(4)

    def tree(scale):
        def leaf(*shape):
            return torch.from_numpy((scale * rng.standard_normal(shape))
                                    .astype(np.float32)).to(dtype)
        return {"a": leaf(3, 40), "blocks": [{"w": leaf(5)}, {"w": leaf(70)}],
                "c": leaf(2)}

    sched = cosine_schedule(1e-2, warmup_steps=2, total_steps=5)
    opt, oracle = {
        "adamw": (adamw(sched), _oracle_adamw(sched)),
        "sgd": (sgd(sched), _oracle_sgd(sched)),
        "sgd-nesterov": (sgd(sched, nesterov=True),
                         _oracle_sgd(sched, nesterov=True))}[name]
    p0 = tree(1.0)
    tp, op = tree_map(torch.clone, p0), tree_map(torch.clone, p0)
    ts, os_ = opt.init(tp), opt.init(op)
    for _ in range(5):
        g = tree(3.0)
        og, on = _oracle_clip(g, 1.0)
        tg, tn = clip_by_global_norm(tree_map(torch.clone, g), 1.0)
        assert torch.equal(tn, on)
        mu, nu = ts.mu, ts.nu
        tp2, ts = opt.update(tg, ts, tp)
        assert tp2 is tp and ts.mu is mu and ts.nu is nu
        op, os_ = oracle(og, os_, op)
    assert ts.step == os_.step == 5
    for a, b in zip(tree_leaves([tp, ts.mu, ts.nu]),
                    tree_leaves([op, os_.mu, os_.nu])):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_rff_state_does_not_follow_the_table_updated_in_place():
    """The RFF state keeps the class table of its init / refresh: an
    in-place update of params["embed"] leaves state["emb"] unchanged."""
    _, tc, _, tp, _, _, _, _ = _setup(seed=5)
    prop = proposals_registry.from_config(tc.head, "rff")
    state = heads.init_proposal_state(tc, tp, torch.Generator().manual_seed(0),
                                      prop)
    emb0 = state["emb"].clone()
    opt = adamw(1e-2)
    grads = tree_map(torch.ones_like, tp)
    opt.update(grads, opt.init(tp), tp)
    assert not torch.equal(tp["embed"], emb0)
    assert torch.equal(state["emb"], emb0)
    state = heads.refresh_proposal_state(tc, tp, prop, state,
                                         torch.Generator().manual_seed(1))
    emb1 = state["emb"].clone()
    opt.update(grads, opt.init(tp), tp)
    assert torch.equal(state["emb"], emb1)


def test_full_head_train_step_matches():
    jc, tc, jp, tp, _, _, toks, labels = _setup(seed=3)
    sched = dict(warmup_steps=2, total_steps=10)
    jstep = jsteps.make_train_step(jc, jadamw(jcosine(3e-3, **sched)),
                                   head_mode="full")
    topt = adamw(cosine_schedule(3e-3, **sched))
    tstep = steps.make_train_step(tc, topt, head_mode="full")
    jopt = jadamw(jcosine(3e-3, **sched))
    jp2, _, jm = jstep(jp, jopt.init(jp), None,
                       {"tokens": jnp.asarray(toks),
                        "labels": jnp.asarray(labels)},
                       jax.random.PRNGKey(0))
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()}
    tp2, ts, tm = tstep(tp, topt.init(tp), None, batch, None)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               atol=TOL, rtol=TOL)
    assert tm["skipped"] == float(jm["skipped"]) == 0.0 and ts.step == 1
    _assert_trees_close(tc, tp2, jp2)


def test_non_finite_step_is_skipped():
    _, tc, _, tp, _, tidx, toks, labels = _setup(seed=4)
    opt = adamw(1e-3)
    step = steps.make_train_step(tc, opt)
    bad = tree_map(lambda p: p.clone(), tp)
    bad["final_norm"]["scale"][0] = float("nan")
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()}
    st = opt.init(bad)
    p2, st2, m = step(bad, st, tidx, batch, noise.train_keys(0, 0, B * S))
    assert m["skipped"] == 1.0 and st2 is st and p2 is bad


# ------------------------------------------------------------------ index
def _clustered(seed=0, k=8, d=16, n=300):
    rng = np.random.default_rng(seed)
    c1 = 4.0 * rng.standard_normal((k, d))
    c2 = 1.0 * rng.standard_normal((k, d))
    a1, a2 = rng.integers(0, k, n), rng.integers(0, k, n)
    a1[:k], a2[:k] = np.arange(k), np.arange(k)
    x = c1[a1] + c2[a2] + 0.05 * rng.standard_normal((n, d))
    return x.astype(np.float32), c1.astype(np.float32), c2.astype(np.float32)


@pytest.mark.parametrize("how", ["refresh", "reassign"])
def test_refresh_from_the_same_codebooks_matches(how):
    x, c1, c2 = _clustered()
    jidx = jbuild(jax.random.PRNGKey(0), jnp.asarray(x), kind="rq", k=8,
                  iters=3, init=(jnp.asarray(c1), jnp.asarray(c2)))
    tidx = index_from_numpy(_jax_index_np(jidx), device="cpu")
    moved = x + 0.3 * np.random.default_rng(1).standard_normal(
        x.shape).astype(np.float32)
    if how == "refresh":
        j = jrefresh(jidx, jax.random.PRNGKey(2), jnp.asarray(moved), iters=3)
        t = refresh(tidx, torch.Generator().manual_seed(2),
                    torch.from_numpy(moved), iters=3)
    else:
        j = jreassign(jidx, jnp.asarray(moved))
        t = reassign(tidx, torch.from_numpy(moved))
    for name in ("assign1", "assign2", "sorted_ids", "offsets", "counts"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)
    for name in ("codebook1", "codebook2", "residuals"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), atol=TOL,
                                   rtol=TOL, err_msg=name)
    jd = jlifecycle.drift_metrics(jidx, jnp.asarray(moved))
    td = lifecycle.drift_metrics(tidx, torch.from_numpy(moved))
    for k in ("reassigned_frac", "codeword_drift"):
        np.testing.assert_allclose(float(td[k]), float(jd[k]), rtol=1e-5)


def test_refresh_head_state_is_the_fixed_policy_refit():
    _, tc, _, tp, _, tidx, _, _ = _setup(seed=5)
    a = heads.refresh_head_state(tc, tp, tidx,
                                 torch.Generator().manual_seed(3))
    b, metrics = heads.refresh_head_state_with_policy(
        tc, tp, tidx, torch.Generator().manual_seed(3))
    for f in FIELDS[1:]:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert set(metrics) == {"reassigned_frac", "codeword_drift", "did_full",
                            "distortion"} and float(metrics["did_full"]) == 1


def test_validation_and_lifecycle_reject_a_degenerate_index():
    x, c1, c2 = _clustered(seed=3)
    tidx = build(torch.Generator().manual_seed(0), torch.from_numpy(x),
                 kind="rq", k=8, iters=2, keep_residuals=False,
                 init=(torch.from_numpy(c1), torch.from_numpy(c2)))
    assert validate_index(tidx) == [] and validate_state(tidx, like=tidx) == []
    broken = dataclasses.replace(tidx, codebook1=tidx.codebook1 * np.nan,
                                 counts=tidx.counts * 0)
    jbroken = jbuild(jax.random.PRNGKey(0), jnp.asarray(x), kind="rq", k=8,
                     iters=2, keep_residuals=False,
                     init=(jnp.asarray(c1), jnp.asarray(c2)))
    jbroken = dataclasses.replace(jbroken, codebook1=jbroken.codebook1 * np.nan,
                                  counts=jbroken.counts * 0)
    assert validate_index(broken) == jvalidate_index(jbroken)
    calls = []

    def refresh_fn(params, state, seed):
        calls.append(seed)
        return broken, {"did_full": 1.0}

    lc = lifecycle.IndexLifecycle(refresh_fn, every=3, base_seed=7)
    for step in range(6):
        out, ev = lc.step(step, None, tidx)
        assert out is tidx
        assert (ev is not None) == (step in (2, 5))
    assert all(e.rejected for e in lc.events) and len(calls) == 2
    assert len(set(calls)) == 2          # one seed per dispatch step
    # lag > 0 and the drift policy are ported
    lc = lifecycle.IndexLifecycle(refresh_fn, every=3, base_seed=0, lag=2)
    out, ev = lc.step(2, None, tidx)
    assert out is tidx and ev is None and lc.in_flight
    _, m = lifecycle.refresh_with_policy(tidx, torch.Generator(),
                                         torch.from_numpy(x), policy="drift")
    assert float(m["did_full"]) in (0.0, 1.0)


def test_train_keys_are_a_function_of_seed_step_and_row():
    a = noise.train_keys(0, 5, 12)
    assert torch.equal(a[3:7], noise.train_keys(0, 5, 7)[3:7])
    assert not torch.equal(a, noise.train_keys(0, 6, 12))
    assert not torch.equal(a, noise.train_keys(1, 5, 12))
    assert not torch.equal(a, noise.row_keys(0, 5, torch.arange(12)))


# ------------------------------------------------------------------ loop
@pytest.fixture(scope="module")
def tiny_cfg():
    return tcfg.get_config("paper-lm").reduced().with_head(
        num_negatives=32, refresh_every=25, proposal="per_token")


@pytest.fixture(scope="module")
def corpus(tiny_cfg):
    return ZipfLM(vocab_size=tiny_cfg.vocab_size, num_clusters=16,
                  seq_len=33, seed=0).sample(256)


def test_loss_decreases_midx(tiny_cfg, corpus):
    """The port of `tests/test_train_e2e.py::test_loss_decreases_midx`."""
    _, _, _, hist = train_loop(tiny_cfg, steps=60, batch_size=16, seq_len=32,
                               corpus=corpus, lr=3e-3, log_every=1000,
                               device="cpu")
    assert np.mean(hist[-5:]) < np.mean(hist[:5]) - 0.1, hist


def test_two_train_runs_are_bitwise_equal(tiny_cfg, corpus):
    runs = [train_loop(tiny_cfg, steps=12, batch_size=4, seq_len=32,
                       corpus=corpus, lr=3e-3, log_every=1000,
                       refresh_every=5, device="cpu") for _ in range(2)]
    (p1, o1, i1, h1), (p2, o2, i2, h2) = runs
    assert h1 == h2
    for a, b in zip(tree_leaves(p1) + tree_leaves(o1.mu) + tree_leaves(o1.nu),
                    tree_leaves(p2) + tree_leaves(o2.mu) + tree_leaves(o2.nu)):
        assert torch.equal(a, b)
    for f in FIELDS[1:]:
        assert torch.equal(getattr(i1, f), getattr(i2, f)), f
    assert not any(p.requires_grad for p in tree_leaves(p1))


def test_trained_model_serves_on_the_cpu(tiny_cfg, corpus):
    from repro_torch.serve import Engine, Request
    cfg = tiny_cfg.with_serve(max_slots=2, page_size=4, max_seq=16)
    params, _, index, _ = train_loop(cfg, steps=3, batch_size=4, seq_len=32,
                                     corpus=corpus, log_every=1000,
                                     device="cpu")
    eng = Engine(cfg, params, index=index, head="midx", device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, tokens=rng.integers(0, cfg.vocab_size, 5)
                    .astype(np.int32), max_new=4, seed=1) for i in range(3)]
    res = eng.run(reqs)
    for r in reqs:
        assert res[r.rid].status == "ok" and len(res[r.rid].tokens) == 4
        np.testing.assert_array_equal(res[r.rid].tokens, eng.replay_single(r))


def test_cli_defaults_to_the_card_and_refuses_unported_flags():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_main(["--reduced", "--steps", "1"])
    base = ["--device", "cpu", "--reduced", "--steps", "1", "--batch", "2",
            "--seq", "8"]
    # --dp runs on the CPU (two gloo ranks); an unknown transport is refused
    assert train_main(base + ["--dp", "2"]) is None
    with pytest.raises(SystemExit):
        train_main(base + ["--dp", "2", "--grad-transport", "fp16"])
    # the lifecycle flags are ported and run
    for flags in (["--refresh-lag", "2", "--refresh-every", "1"],
                  ["--refresh-policy", "drift", "--refresh-every", "1"]):
        *_, hist = train_main(base + flags)
        assert len(hist) == 1 and np.isfinite(hist).all()


def test_cli_resumes_from_ckpt(tmp_path, capsys):
    """`--ckpt <dir>` twice: the second run resumes from the first's final
    checkpoint, and both export <ckpt>/serve."""
    base = ["--device", "cpu", "--reduced", "--steps", "2", "--batch", "2",
            "--seq", "8", "--ckpt", str(tmp_path)]
    train_main(base)
    assert "resumed" not in capsys.readouterr().out
    train_main(base + ["--chaos", "slow_step@3:0.01"])
    out = capsys.readouterr().out
    assert "[train] resumed from step 2" in out and "chaos report" in out
    assert CheckpointManager(str(tmp_path)).all_steps() == [2]
    assert CheckpointManager(os.path.join(str(tmp_path), "serve")
                             ).all_steps() == [2]
