"""The port's fourteen proposal contenders on the CPU, held to the JAX
package on the same numpy inputs (ports of `tests/test_proposals.py` and
more):

  - the reference's contract and normalisation sweep over every name, on
    the port's own states, and static refresh idempotent;
  - deterministic stages element-wise, on state carried over by `bridge`:
    the alias tables bit for bit, every contender's `log_prob` within
    1e-5, the LSH codes and bucket sizes (equal except at sign near-ties,
    |proj| < 1e-5), the TAPAS slot map, `exact_decomposition`'s four
    outputs and Theorem 1's identity, the learnable codebooks' losses and
    their gradients, `index_from_learnable`'s assignments and CSR;
  - sampled outputs by distribution: 2^16 draws of every contender follow
    exp(log q), the pass-1 pool follows the frequencies, and a row's draws
    ignore the rest of the batch;
  - `loss_sampled` and its gradients given the reference's own draws, for
    uniform, unigram, sphere, lsh, tapas and midx-learnable-rq, per-token
    and pooled; one trainable step of midx-learnable-rq against
    the reference's `train_step`, and its skip guard;
  - training and resume bit for bit, checkpoints of every contender's
    state in the reference's format both ways (treedef strings against
    `jax.tree_util`), validation reasons, the engine and both CLIs.

Tolerances: 1e-5 (atol and rtol) on fp32 values, losses and gradients,
the bar of `tests/test_fused_head.py`; frequencies within 6 standard
errors.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint import save_serving_state as jsave_serving
from repro.core import alias as jalias
from repro.core import learnable as jlearn
from repro.core import midx as jmidx
from repro.index.build import build as jbuild
from repro.launch import steps as jsteps
from repro.models import heads as jheads
from repro.models.model import init_params as jinit
from repro.optim import adamw as jadamw
from repro.optim import cosine_schedule as jcosine
from repro.optim import sgd as jsgd
from repro.proposals import baselines as jbase
from repro.proposals import registry as jregistry
from repro.resilience.validate import validate_state as jvalidate
from repro_torch import configs as tcfg
from repro_torch.bridge import (index_from_numpy, params_from_numpy,
                                params_to_numpy, proposal_state_from_numpy,
                                proposal_state_to_numpy, to_reference)
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import _flatten, _treedef_str
from repro_torch.core import alias, learnable, midx, noise
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import steps
from repro_torch.launch import train as train_cli
from repro_torch.launch.train import train_loop
from repro_torch.models import heads
from repro_torch.optim import adamw, cosine_schedule, sgd
from repro_torch.optim.optimizers import OptState, tree_leaves, tree_map
from repro_torch.proposals import PROPOSAL_NAMES, baselines, registry, tapas
from repro_torch.proposals.base import Draw
from repro_torch.resilience.validate import validate_state
from repro_torch.serve import Engine, Request

TOL = 1e-5
N, D, K = 160, 16, 4
KNOBS = dict(k=K, kmeans_iters=4, tapas_pool=32)
B, S = 2, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: when test files run in parallel worker
    processes, torch's thread pools oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _emb(seed=0):
    rng = np.random.default_rng(seed)
    centers = 2.0 * rng.standard_normal((K, D))
    cl = rng.integers(0, K, N)
    return (centers[cl] + 0.1 * rng.standard_normal((N, D))).astype(
        np.float32)


EMB = _emb()
FREQ = np.random.default_rng(0).random(N) + 0.1


def _close(a, b, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol, err_msg=msg)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _both(name, seed=3):
    """The reference's proposal and state (built from a JAX key), and the
    port's proposal with that state carried over by the bridge."""
    jp = jregistry.make_proposal(name, **KNOBS)
    jstate = jp.init(jax.random.PRNGKey(seed), jnp.asarray(EMB), FREQ)
    tstate = proposal_state_from_numpy(_np_tree(jstate), device="cpu")
    return jp, jstate, registry.make_proposal(name, **KNOBS), tstate


def _own(name, seed=3, emb=EMB, freq=FREQ):
    """The port's proposal and its own state."""
    p = registry.make_proposal(name, **KNOBS)
    return p, p.init(torch.Generator().manual_seed(seed),
                     torch.from_numpy(emb), freq)


# ------------------------------------------------------------ the contract
@pytest.mark.parametrize("name", PROPOSAL_NAMES)
def test_proposal_contract(name):
    p, st = _own(name)
    z = torch.from_numpy(np.random.default_rng(4).standard_normal((5, D))
                         .astype(np.float32))
    d = p.sample(st, torch.arange(5) * 7 + 1, z, 12)
    assert d.ids.shape == (5, 12) and d.log_q.shape == (5, 12)
    assert d.ids.dtype == torch.int64
    assert bool(((d.ids >= 0) & (d.ids < N)).all())
    _close(p.log_prob(st, z, d.ids), d.log_q, tol=1e-4)
    st2 = p.refresh(st, torch.Generator().manual_seed(6),
                    torch.from_numpy(EMB + 0.01))
    assert p.sample(st2, torch.arange(5), z, 12).ids.shape == (5, 12)


@pytest.mark.parametrize("name", PROPOSAL_NAMES)
def test_proposal_normalized(name):
    """Σ_i q(i|z) == 1 over the whole vocabulary, every contender."""
    p, st = _own(name, freq=np.ones(N))
    z = torch.from_numpy(np.random.default_rng(4).standard_normal((3, D))
                         .astype(np.float32))
    total = torch.exp(p.log_prob(st, z, torch.arange(N).expand(3, N))).sum(-1)
    _close(total, np.ones(3), tol=1e-3)


@pytest.mark.parametrize("name", ["uniform", "unigram"])
def test_static_refresh_idempotent(name):
    p, st = _own(name, freq=np.ones(N) + 1.0)
    assert not p.adaptive and not p.trainable
    st2 = p.refresh(st, torch.Generator().manual_seed(6),
                    torch.from_numpy(EMB * 3.0))
    for a, b in zip(_flatten(st), _flatten(st2)):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b)


# --------------------------------------------------- deterministic stages
def test_alias_tables_equal_the_reference_bitwise():
    rng = np.random.default_rng(5)
    for p in (rng.random(300), rng.zipf(1.5, 257).astype(np.float64),
              np.r_[np.zeros(7), rng.random(50)], np.ones(64)):
        ours, ref = alias.build_alias(p), jalias.build_alias(p)
        for f in ("prob", "alias", "logq"):
            a, b = getattr(ours, f).numpy(), np.asarray(getattr(ref, f))
            assert np.array_equal(a, b.astype(a.dtype)), f
        assert ours.alias.dtype == torch.int64


@pytest.mark.parametrize("name", PROPOSAL_NAMES)
def test_log_prob_matches_the_reference(name):
    """Every contender's log q over the whole vocabulary, on the
    reference's state carried over."""
    jp, jstate, tp, tstate = _both(name)
    # the state crossed unchanged, in the reference's dtypes, and crosses
    # back through the numpy form
    got = [np.asarray(x) for x in _flatten(to_reference(tstate))]
    want = jax.tree_util.tree_leaves(_np_tree(jstate))
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    again = proposal_state_from_numpy(proposal_state_to_numpy(tstate),
                                      device="cpu")
    assert all(np.array_equal(np.asarray(x), y) for x, y in zip(
        _flatten(to_reference(again)), got))
    z = np.random.default_rng(1).standard_normal((3, D)).astype(np.float32)
    ids = np.broadcast_to(np.arange(N), (3, N))
    _close(tp.log_prob(tstate, torch.from_numpy(z),
                       torch.from_numpy(ids.copy())),
           jp.log_prob(jstate, jnp.asarray(z), jnp.asarray(ids)), msg=name)


def test_lsh_codes_and_sizes_match_but_at_sign_near_ties():
    _, jstate, _, tstate = _both("lsh")
    planes = np.asarray(jstate["planes"], np.float64)
    moved = EMB + 0.3 * np.random.default_rng(2).standard_normal(
        EMB.shape).astype(np.float32)
    for x in (EMB, moved):
        jnew = jbase.lsh_refresh(jstate, None, jnp.asarray(x))
        tnew = baselines.lsh_refresh(tstate, None, torch.from_numpy(x))
        proj = np.einsum("tbd,nd->tnb", planes, x.astype(np.float64))
        near = np.any(np.abs(proj) < 1e-5, axis=-1)               # [T, N]
        same = tnew["codes"].numpy() == np.asarray(jnew["codes"])
        assert np.all(same | near)
        for t in np.flatnonzero(same.all(axis=1)):
            np.testing.assert_array_equal(tnew["sizes"][t].numpy(),
                                          np.asarray(jnew["sizes"])[t])
    z = np.random.default_rng(3).standard_normal((4, 5, D)).astype(np.float32)
    np.testing.assert_array_equal(
        baselines.lsh_codes(tstate["planes"], torch.from_numpy(z)).numpy(),
        np.asarray(jbase.lsh_codes(jstate["planes"], jnp.asarray(z))))


def test_tapas_slot_pool_and_pass_one_frequencies():
    _, jstate, _, tstate = _both("tapas")
    np.testing.assert_array_equal(
        tapas.inverse_slots(tstate["pool"], N).numpy(),
        np.asarray(jstate["slot"]))
    # the port's own pool: P distinct ids and their inverse map
    _, own = _own("tapas")
    pool = own["pool"].numpy()
    assert len(set(pool.tolist())) == 32
    assert np.array_equal(own["slot"].numpy()[pool], np.arange(32))
    assert (own["slot"] >= 0).sum() == 32
    # pass 1 draws ∝ freq: the first of a pool of one, over seeds
    f = np.array([1.0, 2.0, 4.0, 8.0, 1.0, 0.5, 3.0, 0.5])
    logits = torch.log(torch.from_numpy(f.astype(np.float32)))
    first = tapas._draw_pool(torch.arange(8192)[:, None], logits, 1)[:, 0]
    freq = np.bincount(first.numpy(), minlength=8) / 8192
    p = f / f.sum()
    assert np.all(np.abs(freq - p) <= 6 * np.sqrt(p * (1 - p) / 8192))


def _jax_index(kind, seed=1, emb=EMB):
    return jbuild(jax.random.PRNGKey(seed), jnp.asarray(emb), kind=kind,
                  k=K, iters=4)


def _carry_index(jidx):
    return index_from_numpy({"kind": jidx.kind, **{
        f: np.asarray(getattr(jidx, f)) for f in (
            "codebook1", "codebook2", "assign1", "assign2", "residuals",
            "sorted_ids", "offsets", "counts", "log_counts")}}, device="cpu")


@pytest.mark.parametrize("kind", ["pq", "rq"])
def test_exact_decomposition_matches_and_holds_theorem_one(kind):
    jidx = _jax_index(kind)
    tidx = _carry_index(jidx)
    z = np.random.default_rng(6).standard_normal((3, D)).astype(np.float32)
    got = midx.exact_decomposition(tidx, torch.from_numpy(z),
                                   torch.from_numpy(EMB))
    want = jmidx.exact_decomposition(jidx, jnp.asarray(z), jnp.asarray(EMB))
    for f in got._fields:
        _close(getattr(got, f), getattr(want, f), msg=f)
    k1, k2 = tidx.assign1, tidx.assign2
    ident = (got.log_p1[:, k1] + got.log_p2[:, k1, k2] + got.log_p3)
    _close(ident, got.log_softmax)
    _close(midx.exact_log_prob(tidx, torch.from_numpy(z),
                               torch.from_numpy(EMB)), got.log_softmax)


@pytest.mark.parametrize("kind", ["pq", "rq"])
def test_learnable_losses_and_their_codebook_grads_match(kind):
    jcb = jlearn.from_index(_jax_index(kind))
    cb = proposal_state_from_numpy(_np_tree(jcb), device="cpu")
    assert isinstance(cb, learnable.LearnableCodebooks) and cb.kind == kind
    rng = np.random.default_rng(7)
    z = rng.standard_normal((6, D)).astype(np.float32)
    tz, tq = torch.from_numpy(z), torch.from_numpy(EMB)
    _close(learnable.soft_reconstruct(cb, tq),
           jlearn.soft_reconstruct(jcb, jnp.asarray(EMB)))

    def ours(fn):
        c1 = cb.codebook1.clone().requires_grad_(True)
        c2 = cb.codebook2.clone().requires_grad_(True)
        v = fn(learnable.LearnableCodebooks(kind, c1, c2))
        return (v.detach(), *torch.autograd.grad(v, (c1, c2)))

    for label, fn, jfn in (
            ("recon", lambda c: learnable.reconstruction_loss(c, tq),
             lambda c: jlearn.reconstruction_loss(c, jnp.asarray(EMB))),
            ("kl", lambda c: learnable.kl_loss(c, tz, tq),
             lambda c: jlearn.kl_loss(c, jnp.asarray(z), jnp.asarray(EMB))),
            ("both", lambda c: learnable.codebook_losses(c, tz, tq, 0.5,
                                                         2.0)[0],
             lambda c: jlearn.codebook_losses(c, jnp.asarray(z),
                                              jnp.asarray(EMB), 0.5,
                                              2.0)[0])):
        v, g1, g2 = ours(fn)
        jv, jg = jax.value_and_grad(jfn)(jcb)
        _close(v, jv, msg=label)
        _close(g1, jg.codebook1, msg=f"{label} d/dC1")
        _close(g2, jg.codebook2, msg=f"{label} d/dC2")


@pytest.mark.parametrize("kind", ["pq", "rq"])
def test_index_from_learnable_assigns_and_builds_the_csr_alike(kind):
    jcb = jlearn.from_index(_jax_index(kind))
    rng = np.random.default_rng(8)
    jcb = dataclasses.replace(jcb, **{
        f: getattr(jcb, f) + 0.05 * jnp.asarray(rng.standard_normal(
            getattr(jcb, f).shape).astype(np.float32))
        for f in ("codebook1", "codebook2")})
    cb = proposal_state_from_numpy(_np_tree(jcb), device="cpu")
    moved = EMB + 0.2 * rng.standard_normal(EMB.shape).astype(np.float32)
    got = learnable.index_from_learnable(cb, torch.from_numpy(moved))
    want = jlearn.index_from_learnable(jcb, jnp.asarray(moved))
    for f in ("assign1", "assign2", "sorted_ids", "offsets", "counts"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    for f in ("codebook1", "codebook2", "residuals", "log_counts"):
        _close(getattr(got, f), getattr(want, f), msg=f)


# ------------------------------------------------------- draws, by law
@pytest.mark.parametrize("name", PROPOSAL_NAMES)
def test_draw_frequencies_follow_exp_log_q(name):
    """2^16 draws of one query: each class's frequency within 6 standard
    errors of its q, and the draw's log q its log_prob."""
    p, st = _own(name)
    z = torch.from_numpy(0.5 * np.random.default_rng(9).standard_normal(
        (1, D)).astype(np.float32))
    n = 1 << 16
    d = p.sample(st, torch.tensor([12345]), z, n)
    q = torch.exp(p.log_prob(st, z, torch.arange(N)[None]))[0].double()
    freq = np.bincount(d.ids[0].numpy(), minlength=N) / n
    bound = 6 * np.sqrt(q.numpy() * (1 - q.numpy()) / n) + 1e-4
    assert np.all(np.abs(freq - q.numpy()) <= bound), name
    _close(d.log_q, p.log_prob(st, z, d.ids), tol=1e-4)


@pytest.mark.parametrize("name", PROPOSAL_NAMES)
def test_a_rows_draws_ignore_the_rest_of_the_batch(name):
    p, st = _own(name)
    rng = np.random.default_rng(5)
    z = torch.from_numpy(rng.standard_normal((4, D)).astype(np.float32))
    keys = noise.row_keys(0, torch.tensor([3, 9, 1, 4]),
                          torch.tensor([5, 2, 7, 11]))
    batched = p.sample(st, keys, z, 16)
    for r in range(4):
        other = torch.from_numpy(rng.standard_normal((4, D))
                                 .astype(np.float32))
        other[r] = z[r]
        okeys = noise.row_keys(5, torch.arange(4) + 100, torch.arange(4))
        okeys[r] = keys[r]
        solo = p.sample(st, okeys, other, 16)
        assert torch.equal(solo.ids[r], batched.ids[r])
        _close(solo.log_q[r], batched.log_q[r], tol=1e-6)


# ------------------------------------------------------------ the heads
@functools.lru_cache(maxsize=None)
def _jax_params(seed):
    jc = dataclasses.replace(jcfg.get_config("paper-lm").reduced(),
                             dtype="float32")
    return jax.jit(lambda k: jinit(jc, k))(jax.random.PRNGKey(seed))


@functools.lru_cache(maxsize=None)
def _jax_state(mode, seed):
    """The reference's proposal state for `mode` at the reduced paper-lm,
    from `_jax_params(seed)` and the frequencies of a seeded corpus."""
    jc = dataclasses.replace(jcfg.get_config("paper-lm").reduced(),
                             dtype="float32")
    freq = np.random.default_rng(seed).random(jc.padded_vocab) + 0.1
    return jheads.init_proposal_state(
        jc, _jax_params(seed), jax.random.PRNGKey(seed + 1),
        jregistry.from_config(jc.head, mode), freq)


def _setup(mode, proposal, seed=0):
    cfgs = []
    for mod in (jcfg, tcfg):
        c = dataclasses.replace(mod.get_config("paper-lm").reduced(),
                                dtype="float32")
        cfgs.append(c.with_head(mode=mode, proposal=proposal))
    jc, tc = cfgs
    jp = _jax_params(seed)
    tp = params_from_numpy(tc, _np_tree(jp), device="cpu")
    jprop = jregistry.from_config(jc.head)
    jstate = _jax_state(mode, seed)
    tstate = proposal_state_from_numpy(_np_tree(jstate), device="cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    return jc, tc, jp, tp, jprop, jstate, tstate, toks, labels


class _FixedIds:
    """The port's `sample_twostage` (or, `pooled`, `sample_pooled`)
    replaced by one that returns given ids, their log q from the closed
    form (`core.midx.log_prob`) at the row's query (the pooled one: the
    sequence's mean hidden state)."""

    def __init__(self, ids, pooled=False):
        self.ids, self.pooled = ids, pooled

    def __call__(self, index, z, m, keys, **kw):
        if self.pooled:
            z = torch.mean(z.float(), dim=-2)
        ids = self.ids.reshape(z.shape[0], m)
        return midx.Draw(ids, midx.log_prob(index, z, ids))


@pytest.mark.parametrize("mode,proposal", [
    (m, p) for m in ("uniform", "unigram", "sphere", "lsh", "tapas")
    for p in ("per_token", "pooled")] + [("midx-learnable", "per_token"),
                                         ("midx-learnable", "pooled")])
def test_loss_sampled_and_grads_match_given_the_reference_draws(
        monkeypatch, mode, proposal):
    """The loss and its gradients in the hidden states and in the table,
    from one hidden tensor, the reference's draws given to the port (its
    own log q of them)."""
    jc, tc, jp, tp, jprop, jstate, tstate, _, labels = _setup(mode, proposal)
    prop = registry.from_config(tc.head)
    h = np.random.default_rng(8).standard_normal(
        (B, S, tc.d_model)).astype(np.float32)
    key, m = jax.random.PRNGKey(11), tc.head.num_negatives
    if mode == "midx-learnable":
        pooled = proposal == "pooled"
        sampler = "sample_pooled" if pooled else "sample_twostage"
        jd = jax.jit(getattr(jmidx, sampler), static_argnums=3)(
            jstate["index"], key, jnp.asarray(h), m)
        monkeypatch.setattr(midx, sampler, _FixedIds(
            torch.from_numpy(np.asarray(jd.ids).astype(np.int64)), pooled))
    else:
        z = jnp.asarray(h if proposal == "per_token" else h.mean(1))
        jd = jax.jit(jprop.sample, static_argnums=3)(jstate, key, z, m)
        ids = torch.from_numpy(np.asarray(jd.ids).astype(np.int64))
        prop = dataclasses.replace(prop, sample=lambda st, k, zz, mm: Draw(
            ids, prop.log_prob(st, zz, ids)))
    hl = torch.from_numpy(h).requires_grad_(True)
    el = tp["embed"].clone().requires_grad_(True)
    loss = heads.loss_sampled(tc, {**tp, "embed": el}, prop, tstate, hl,
                              torch.from_numpy(labels).long(),
                              noise.train_keys(0, 1, B * S))
    gh, ge = torch.autograd.grad(loss, (hl, el))

    def jloss(hj, ej):
        return jheads.loss_sampled(jc, {**jp, "embed": ej}, jprop, jstate, hj,
                                   jnp.asarray(labels), key, fused=False)

    jl, (jgh, jge) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jnp.asarray(h), jp["embed"])
    _close(float(loss.detach()), float(jl))
    _close(gh, jgh, msg="d/dh")
    _close(ge, jge, msg="d/dtable")


def _step_inputs(seed=2):
    jc, tc, jp, tp, jprop, jstate, tstate, toks, labels = _setup(
        "midx-learnable", "per_token", seed)
    sched = dict(warmup_steps=2, total_steps=10)
    jopt = jsgd(jcosine(3e-2, **sched))
    topt = sgd(cosine_schedule(3e-2, **sched))
    return jc, tc, jp, tp, jstate, tstate, toks, labels, jopt, topt


def test_one_trainable_step_matches_the_reference(monkeypatch):
    """midx-learnable-rq at the reduced paper-lm, the reference's draws
    given to the port: loss, grad norm, the aux metrics, every param, the
    optimizer's momentum and the SGD-stepped codebooks within 1e-5. The
    params' optimizer is SGD with momentum: AdamW's first step,
    g / (|g| + 1e-8), turns a 1e-9 rounding difference of a gradient
    element near 1e-8 into a 1e-5 move of the param, and the test holds
    the trainable step, not the optimizer (held on its own in
    `tests/test_torch_train.py`)."""
    jc, tc, jp, tp, jstate, tstate, toks, labels, jopt, topt = _step_inputs()
    jstep = jsteps.make_train_step(jc, jopt, head_mode="midx-learnable")
    tstep = steps.make_train_step(tc, topt, head_mode="midx-learnable")
    assert jstep.returns_state and tstep.returns_state
    key = jax.random.PRNGKey(0)
    from repro.models.model import forward as jforward
    jd = jax.jit(lambda p, st: jmidx.sample_twostage(
        st["index"], key, jforward(jc, p, jnp.asarray(toks))["hidden"]
        .astype(jnp.float32), tc.head.num_negatives))(jp, jstate)
    monkeypatch.setattr(midx, "sample_twostage", _FixedIds(
        torch.from_numpy(np.asarray(jd.ids).astype(np.int64))))
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    jp2, jo2, js2, jm = jax.jit(jstep)(jp, jopt.init(jp), jstate, jbatch,
                                       key)
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()}
    tp2, to2, ts2, tm = tstep(tree_map(torch.clone, tp), topt.init(tp),
                              tstate, batch, noise.train_keys(0, 0, B * S))
    assert tm["skipped"] == float(jm["skipped"]) == 0.0
    for k in ("loss", "ce", "grad_norm", "prop_recon", "prop_kl"):
        _close(float(tm[k]), float(jm[k]), msg=k)
    assert to2.nu is None and jo2.nu is None
    for a, b in ((tp2, jp2), (to2.mu, jo2.mu)):
        x, y = params_to_numpy(tc, a), _np_tree(b)
        for (path, u), v in zip(jax.tree_util.tree_leaves_with_path(x),
                                jax.tree_util.tree_leaves(y)):
            _close(u, v, msg=jax.tree_util.keystr(path))
    assert to2.step == int(jo2.step) == 1
    for f in ("codebook1", "codebook2"):
        _close(getattr(ts2["cb"], f), getattr(js2["cb"], f), msg=f)
        assert not torch.equal(getattr(ts2["cb"], f),
                               getattr(tstate["cb"], f))
    assert ts2["index"] is tstate["index"]


def test_trainable_step_skips_a_non_finite_loss():
    _, tc, _, tp, _, tstate, toks, labels, _, topt = _step_inputs(seed=4)
    step = steps.make_train_step(tc, topt, head_mode="midx-learnable")
    st = topt.init(tp)
    before = [t.clone() for t in tree_leaves(tp)]
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long(),
             "_fault_scale": torch.full((B,), float("nan"))}
    p2, st2, s2, m = step(tp, st, tstate, batch,
                          noise.train_keys(0, 0, B * S))
    assert m["skipped"] == 1.0 and p2 is tp and st2 is st and st.step == 0
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(p2)))
    assert s2["cb"] is tstate["cb"] and s2["index"] is tstate["index"]


# ------------------------------------------------- loop, resume, format
def _cfg(**head):
    return tcfg.get_config("paper-lm").reduced().with_head(
        mode="midx-learnable", refresh_every=3, **head)


CORPUS = np.random.default_rng(0).integers(0, 512, (16, 17)).astype(np.int32)


def _run(cfg, steps_, **kw):
    return train_loop(cfg, steps=steps_, batch_size=2, seq_len=16, lr=3e-3,
                      log_every=1000, device="cpu", corpus=CORPUS, **kw)


def _same(a, b):
    la = _flatten(to_reference((a[0], a[1], a[2])))
    lb = _flatten(to_reference((b[0], b[1], b[2])))
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else
        np.array_equal(x, y) for x, y in zip(la, lb))


def test_learnable_training_repeats_and_resumes_bit_for_bit(tmp_path):
    cfg = _cfg()
    one, two = _run(cfg, 6), _run(cfg, 6)
    assert one[3] == two[3] and np.all(np.isfinite(one[3]))
    assert _same(one, two)
    cb = one[2]["cb"]
    # the codebooks trained, and the refresh after step 5 re-assigned the
    # classes to them
    init = heads.init_proposal_state(
        cfg, train_loop(cfg, steps=0, batch_size=2, seq_len=16,
                        device="cpu", corpus=CORPUS)[0],
        torch.Generator(), registry.from_config(cfg.head))
    assert not torch.equal(cb.codebook1, init["cb"].codebook1)
    assert torch.equal(one[2]["index"].codebook1, cb.codebook1)
    root = str(tmp_path / "ck")
    _run(cfg, 3, ckpt_dir=root, total_steps=6)
    resumed = _run(cfg, 6, ckpt_dir=root)
    assert resumed[3] == one[3][3:]
    assert _same(resumed, one)


def test_reference_learnable_checkpoint_restores_and_serves(tmp_path):
    """The reference's state after one trainable step (params, AdamW's
    moments, the stepped codebooks) restores in the port bit for bit and
    serves from its serving export."""
    jc, tc, jp, tp, _, jstate, tstate, toks, labels = _setup(
        "midx-learnable", "per_token", seed=5)
    jstep = jax.jit(jsteps.make_train_step(jc, jadamw(1e-3),
                                           head_mode="midx-learnable"))
    jp, jopt, jstate, _ = jstep(jp, jadamw(1e-3).init(jp), jstate,
                                {"tokens": jnp.asarray(toks),
                                 "labels": jnp.asarray(labels)},
                                jax.random.PRNGKey(3))
    JManager(str(tmp_path / "t")).save(4, (jp, jopt, jstate),
                                       metadata={"next_step": 4})
    like = (tree_map(torch.zeros_like, tp),
            OptState(0, tree_map(torch.zeros_like, tp),
                     tree_map(torch.zeros_like, tp)),
            heads.init_proposal_state(tc, tp, torch.Generator(),
                                      registry.from_config(tc.head)))
    mgr = CheckpointManager(str(tmp_path / "t"))
    assert mgr.verify(4, like) == []
    p, o, st = mgr.restore(4, like, device="cpu")
    assert o.step == 1 and isinstance(st["cb"], learnable.LearnableCodebooks)
    for a, b in zip(_flatten(to_reference((p, o, st))),
                    jax.tree_util.tree_leaves(_np_tree((jp, jopt, jstate)))):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    jsave_serving(str(tmp_path / "serve"), 4, jp, jstate)
    cfg = tc.with_serve(max_slots=2, page_size=4, max_seq=16)
    eng = Engine.from_checkpoint(cfg, str(tmp_path / "serve"),
                                 head="midx-learnable", device="cpu", seed=2)
    assert torch.equal(eng.index["cb"].codebook2, st["cb"].codebook2)
    reqs = [Request(rid=i, tokens=np.arange(5 + i, dtype=np.int32),
                    max_new=4, seed=1) for i in range(3)]
    res = eng.run(reqs)
    for r in reqs:
        np.testing.assert_array_equal(res[r.rid].tokens, eng.replay_single(r))


@pytest.mark.parametrize("name", PROPOSAL_NAMES)
def test_state_treedef_validation_and_checkpoint_cross(tmp_path, name):
    """Each contender's state: the port's treedef string is JAX's, the port
    and the reference give the same reasons for a NaN-poisoned state, and
    a port checkpoint of it restores in the reference."""
    jp, jstate, _, tstate = _both(name)
    assert _treedef_str(to_reference(tstate)) == \
        str(jax.tree_util.tree_structure(jstate))
    assert validate_state(tstate, like=tstate) == \
        jvalidate(jstate, like=jstate) == []
    bad = jax.tree_util.tree_map(np.array, jstate)
    floats = [x for x in jax.tree_util.tree_leaves(bad)
              if x.dtype.kind == "f" and x.size]
    assert floats or name == "uniform"        # {"n"}: nothing to poison
    for leaf in floats[:1]:
        leaf.reshape(-1)[0] = np.nan
        want = jvalidate(jax.tree_util.tree_map(jnp.asarray, bad))
        assert want and validate_state(
            proposal_state_from_numpy(bad, device="cpu")) == want
    CheckpointManager(str(tmp_path)).save(2, tstate)
    like = jax.tree_util.tree_map(
        lambda x: jnp.zeros_like(x) if hasattr(x, "dtype") else x, jstate)
    got = JManager(str(tmp_path)).restore(2, like, verify=True)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jstate)):
        # a Python int leaf (`n`) comes back as JAX's int32 array, as from
        # the reference's own checkpoint
        assert not hasattr(b, "dtype") or np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_learnable_training_tuple_treedef_is_jax_s():
    _, tc, jp, tp, _, jstate, tstate, _, _ = _setup("midx-learnable",
                                                    "per_token")
    jopt = jadamw(1e-3).init(jp)
    topt = adamw(1e-3).init(tp)
    assert _treedef_str(to_reference((tp, topt, tstate))) == \
        str(jax.tree_util.tree_structure((jp, jopt, jstate)))


# ------------------------------------------------------- engine and CLIs
@pytest.mark.parametrize("head", ["uniform", "unigram", "sphere", "lsh",
                                  "tapas", "midx-learnable"])
def test_engine_serves_each_contender_batched_equal_solo(head):
    cfg = tcfg.get_config("paper-lm").reduced().with_serve(
        max_slots=3, page_size=4, max_seq=20)
    eng = Engine(cfg, head=head, device="cpu", seed=1)
    assert eng.proposal.name.startswith(head)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, tokens=rng.integers(0, cfg.vocab_size, size=p)
                    .astype(np.int32), max_new=n, seed=3)
            for i, (p, n) in enumerate([(6, 5), (9, 7), (6, 3), (11, 6)])]
    res = eng.run(reqs)
    assert eng.stats.waves >= 2
    for r in reqs:
        toks = res[r.rid].tokens
        assert res[r.rid].status == "ok" and len(toks) == r.max_new
        assert toks.min() >= 0 and toks.max() < cfg.padded_vocab
        np.testing.assert_array_equal(toks, eng.replay_single(r))


def test_clis_take_every_head_mode_and_the_reference_flags():
    modes = registry.proposal_modes()
    assert modes == jregistry.proposal_modes()
    for mode in modes:
        assert train_cli.parser().parse_args(["--head", mode]).head == mode
        out = serve_cli.main(["--device", "cpu", "--reduced", "--head", mode,
                              "--requests", "2", "--tokens", "2", "--prompt",
                              "4", "--warmup", "0", "--verify", "1"]
                             + (["--greedy"] if mode == "full" else []))
        assert out["verified"] == 1, mode
    # reference command lines: --traffic synthetic, --fused-head auto / on
    assert serve_cli.parser().parse_args(
        ["--traffic", "synthetic"]).traffic == "synthetic"
    for route in ("auto", "on", "off"):
        assert train_cli.parser().parse_args(
            ["--fused-head", route]).fused_head == route
    _, _, _, hist = train_cli.main(
        ["--device", "cpu", "--reduced", "--steps", "2", "--batch", "2",
         "--seq", "8", "--fused-head", "off"])
    assert len(hist) == 2 and np.all(np.isfinite(hist))
    with pytest.raises(SystemExit, match="no Pallas interpreter"):
        train_cli.main(["--device", "cpu", "--reduced", "--fused-head",
                        "interpret", "--steps", "1"])
    _, _, state, hist = train_cli.main(
        ["--device", "cpu", "--reduced", "--head", "unigram", "--steps", "2",
         "--batch", "2", "--seq", "8", "--fused-head", "on"])
    assert len(hist) == 2 and isinstance(state["table"], alias.AliasTable)
