"""The RFF proposal slice of the port against the JAX package on the CPU:
the feature map, state, log-probs and refresh; the plain Gumbel-top-m
sampler against the reference's kernel (interpret mode) and oracle; the
draws' distribution and independence; `loss_sampled` and
`proposal_decode_head` given the same draws; the engine, the train loop,
the registry and state validation.

Inputs are made with numpy from a seed and the RFF state crosses through
the bridge. Tolerances: 1e-5 (atol and rtol) on fp32 values, losses and
gradients, the bar of `tests/test_fused_head.py`. Draws: the hash bits
match the reference's bit for bit, but the float32 `log` of two libraries
and the dot's order can move a perturbed value by an ulp, so two ids may
differ only where the reference's perturbed values of both lie within
1e-5·max(1, |v|) of each other (a near-tie), and on at most 1e-3 of the
draws."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.kernels.rff_sample.ops import rff_gumbel_sample as jrff_sample
from repro.models import heads as jheads
from repro.models.model import class_embeddings as jclass_embeddings
from repro.models.model import forward as jforward
from repro.models.model import init_params as jinit
from repro.proposals import base as jbase
from repro.proposals import registry as jregistry
from repro.proposals import rff as jrff
from repro.resilience.validate import validate_state as jvalidate_state
from repro_torch import configs as tcfg
from repro_torch.bridge import (params_from_numpy, params_to_numpy,
                                proposal_state_from_numpy,
                                proposal_state_to_numpy)
from repro_torch.core import noise
from repro_torch.index.lifecycle import IndexLifecycle
from repro_torch.kernels.rff_sample.ops import rff_gumbel_sample
from repro_torch.kernels.rff_sample.ref import (perturbed_values,
                                                rff_gumbel_ref, rff_scores)
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import steps
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import train_loop
from repro_torch.models import heads
from repro_torch.models.model import forward as tforward
from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.proposals import registry, rff
from repro_torch.resilience.validate import validate_state
from repro_torch.serve import Engine, Request

TOL = 1e-5
B, S = 2, 8


def _np(x):
    return np.asarray(x)


def _jax_state(n=300, d=16, seed=0):
    rng = np.random.default_rng(seed)
    emb = (0.7 * rng.standard_normal((n, d))).astype(np.float32)
    jstate = jrff.rff_init(jax.random.PRNGKey(seed), jnp.asarray(emb))
    tstate = proposal_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    return emb, jstate, tstate


def _close(a, b, tol=TOL, msg=""):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=tol,
                               err_msg=msg)


# ------------------------------------------------------------ proposal math
def test_rff_map_state_log_probs_and_refresh_match_jax():
    emb, jstate, tstate = _jax_state()
    assert set(tstate) == {"emb", "w", "tau", "phi_c"}
    back = proposal_state_to_numpy(tstate)
    for k, v in jstate.items():
        assert back[k].dtype == _np(v).dtype and np.array_equal(back[k],
                                                                _np(v)), k
    rng = np.random.default_rng(1)
    z = rng.standard_normal((2, 3, 16)).astype(np.float32)
    tz = torch.from_numpy(z)
    _close(rff.rff_map(tz, tstate["w"], tstate["tau"]),
           jrff.rff_map(jnp.asarray(z), jstate["w"], jstate["tau"]))
    _close(rff.rff_log_p(tstate, tz), jrff.rff_log_p(jstate, jnp.asarray(z)))
    ids = rng.integers(0, 300, (2, 3, 5))
    _close(rff.rff_log_prob(tstate, tz, torch.from_numpy(ids)),
           jrff.rff_log_prob(jstate, jnp.asarray(z), jnp.asarray(ids)))
    moved = emb + 0.3 * rng.standard_normal(emb.shape).astype(np.float32)
    tnew = rff.rff_refresh(tstate, None, torch.from_numpy(moved))
    jnew = jrff.rff_refresh(jstate, None, jnp.asarray(moved))
    for k in jstate:
        _close(tnew[k], jnew[k], msg=k)
    # the port's own init: its W, mapped by the reference, is its phi_c
    init = rff.rff_init(torch.Generator().manual_seed(3),
                        torch.from_numpy(emb))
    for k, v in jstate.items():
        assert tuple(init[k].shape) == v.shape, k
        assert str(init[k].dtype).split(".")[-1] == str(v.dtype), k
    _close(init["phi_c"], jrff.rff_map(jnp.asarray(emb),
                                       jnp.asarray(init["w"].numpy()),
                                       jnp.float32(4.0)))


# ------------------------------------------------------------ the sampler
def _assert_same_draws(ids, log_q, want_ids, want_lq, logits, seeds, t_ids):
    """ids equal except at near-ties of the perturbed values (at most 1e-3
    of the draws); log_q within 1e-5 where the ids agree."""
    ids = torch.from_numpy(np.array(ids))
    want_ids = torch.from_numpy(np.array(want_ids))
    same = ids == want_ids
    a = perturbed_values(logits, seeds, t_ids, ids)
    b = perturbed_values(logits, seeds, t_ids, want_ids)
    near = (a - b).abs() <= TOL * torch.clamp(b.abs(), min=1.0)
    assert bool((same | near).all())
    assert float((~same).float().mean()) <= 1e-3
    _close(_np(log_q)[same.numpy()], _np(want_lq)[same.numpy()])


@pytest.mark.parametrize("t,n,r,m", [
    (8, 128, 64, 16),     # block-aligned
    (13, 200, 32, 5),     # T, N and m all ragged vs the block sizes
    (1, 64, 16, 3),       # single query row
    (20, 130, 64, 17),    # N pad crosses a block boundary
])
def test_plain_sampler_matches_the_reference_kernel_and_oracle(t, n, r, m):
    """The sweep of `tests/test_kernels.py::test_rff_sample_sweep`, in the
    reference's seed form: seeds = full(7), t_ids = arange(T)."""
    rng = np.random.default_rng(t * 1000 + n)
    pz = (np.abs(rng.standard_normal((t, r))) * 0.3).astype(np.float32)
    pc = np.abs(rng.standard_normal((n, r))).astype(np.float32)
    seeds = torch.full((t,), 7, dtype=torch.int64)
    t_ids = torch.arange(t)
    ids, lq = rff_gumbel_sample(torch.from_numpy(pz), torch.from_numpy(pc),
                                seeds, t_ids, m)
    assert ids.dtype == torch.int32 and tuple(ids.shape) == (t, m)
    assert bool(((ids >= 0) & (ids < n)).all()) and bool((lq < 1e-5).all())
    logits = rff_scores(torch.from_numpy(pz), torch.from_numpy(pc))
    for use_kernel in (True, False):
        jids, jlq = jrff_sample(jnp.asarray(pz), jnp.asarray(pc),
                                jnp.int32(7), m, use_kernel=use_kernel,
                                interpret=use_kernel)
        _assert_same_draws(ids, lq, jids, jlq, logits, seeds, t_ids)


def _ratio_draws(pz, pc, seeds, t_ids, m, chunk=512):
    """The CUDA sampler's argmax (`rff_sample/csrc/rff_sample.cu`), written
    out in torch: in each chunk of `chunk` columns a scan in ascending order
    keeps the first maximum of s / E, s = max(φ(z)·φ(c), 1e-8), E = −log u,
    compared as s·E_best > s_best·E; the chunks' winners are then compared
    by log s − log E, the earlier chunk kept on a tie."""
    s = torch.clamp(pz @ pc.T, min=1e-8)                         # [T, N]
    t, n = s.shape
    e = -torch.log(noise.uniform_noise(
        seeds.reshape(-1, 1, 1), t_ids.reshape(-1, 1, 1),
        torch.arange(m).reshape(1, -1, 1), torch.arange(n).reshape(1, 1, -1)))
    best_v = torch.full((t, m), -float("inf"))
    best_c = torch.zeros((t, m), dtype=torch.int64)
    for c0 in range(0, n, chunk):
        bs, be = torch.zeros((t, m)), torch.ones((t, m))
        bc = torch.full((t, m), c0)
        for j in range(c0, min(n, c0 + chunk)):
            sj, ej = s[:, j:j + 1].expand(t, m), e[:, :, j]
            win = sj * be > bs * ej
            bs, be = torch.where(win, sj, bs), torch.where(win, ej, be)
            bc = torch.where(win, j, bc)
        v = torch.log(bs) - torch.log(be)
        take = v > best_v
        best_v = torch.where(take, v, best_v)
        best_c = torch.where(take, bc, best_c)
    return best_c


@pytest.mark.parametrize("t,n,r,m,form", [
    (8, 128, 64, 16, "reference"), (13, 200, 32, 5, "reference"),
    (1, 64, 16, 3, "reference"), (20, 130, 64, 17, "reference"),
    (4, 2500, 64, 64, "rows"),              # five chunks of 512 columns
    (3, 300, 16, 40, "duplicates"),         # equal logits: the first column
])
def test_ratio_argmax_draws_what_the_plain_sampler_draws(t, n, r, m, form):
    """The kernel's form of the Gumbel-max — one log per evaluation, the
    argmax of s / (−log u) by cross-multiplying — picks the plain
    `rff_gumbel_ref`'s column except where the two columns' perturbed
    values are within 1e-5·max(1, |v|) (a near-tie). "duplicates": φ(C)
    repeats each of 30 rows 10 times, so equal logits must give the
    minimum column among equal perturbed values."""
    rng = np.random.default_rng(t * 1000 + n)
    pz = torch.from_numpy((np.abs(rng.standard_normal((t, r))) * 0.3)
                          .astype(np.float32))
    pc = torch.from_numpy(np.abs(rng.standard_normal((n, r)))
                          .astype(np.float32))
    if form == "duplicates":
        pc = pc[:30].repeat(10, 1)
    if form == "reference":
        seeds, t_ids = torch.full((t,), 7), torch.arange(t)
    else:
        seeds = torch.from_numpy(rng.integers(0, 2**32, t))
        t_ids = torch.zeros(t, dtype=torch.int64)
    got = _ratio_draws(pz, pc, seeds, t_ids, m)
    want, _, _ = rff_gumbel_ref(pz, pc, seeds, t_ids, m)
    logits = rff_scores(pz, pc)
    a = perturbed_values(logits, seeds, t_ids, got)
    b = perturbed_values(logits, seeds, t_ids, want)
    same = got == want.long()
    assert bool((same | ((a - b).abs() <= TOL * b.abs().clamp(min=1))).all())
    assert float((~same).float().mean()) <= 1e-3


def test_the_kernels_filter_lets_through_every_column_that_can_win():
    """The CUDA sampler skips the log of a column unless u passes a cheap
    bound, ub > 2^(−s·ρ − c) with ub = 1.m − (1 − 2^-22) from the hash's
    top 23 bits, ρ = fl(fl(E_best / s_best) · SLOPE) and c = 2^-16
    (`rff_sample.cu`, `consider`). It must never refuse a column that the
    exact compare s·E_best > s_best·E takes: checked here at u within a few
    24-bit steps of the boundary, with 2^x computed 2^-21 high (a worse
    error than ex2.approx's) and the exponent rounded twice (the kernel
    fuses it)."""
    slope = np.float32(1.4426950408889634 * (1.0 + 2e-6))
    rng = np.random.default_rng(9)
    n = 200_000
    s = np.float32(10.0) ** rng.uniform(-8, 0.5, n).astype(np.float32)
    bs = np.float32(10.0) ** rng.uniform(-8, 0.5, n).astype(np.float32)
    be = rng.uniform(1e-7, 17.5, n).astype(np.float32)
    thr = np.exp(-s.astype(np.float64) * be / bs)       # u at the boundary
    k = np.clip(np.floor((thr - 2.0**-25) * 2**24) + rng.integers(-3, 4, n),
                0, 2**24 - 1).astype(np.uint32)
    h = (k << np.uint32(8)) | rng.integers(0, 256, n).astype(np.uint32)
    u = (k.astype(np.float32) * np.float32(2.0**-24)
         + np.float32(2.0**-25))
    e = -np.log(u)
    exact = s * be > bs * e
    ub = ((np.uint32(0x3F800000) | (h >> np.uint32(9))).view(np.float32)
          - np.float32(1 - 2.0**-22))
    rho = (be / bs) * slope
    p = np.exp2(-s * rho - np.float32(2.0**-16)) * np.float32(1 + 2.0**-21)
    assert exact.sum() > 1000 and (~exact).sum() > 1000
    assert not np.any(exact & ~(ub > p))


def test_sampler_seeds_decorrelate_and_repeat():
    rng = np.random.default_rng(2)
    pz = torch.from_numpy(np.abs(rng.standard_normal((4, 32)))
                          .astype(np.float32))
    pc = torch.from_numpy(np.abs(rng.standard_normal((100, 32)))
                          .astype(np.float32))

    def draw(seed):
        return rff_gumbel_sample(pz, pc, torch.full((4,), seed),
                                 torch.arange(4), 8)[0]

    assert torch.equal(draw(1), draw(1))
    assert not torch.equal(draw(1), draw(2))


@pytest.mark.parametrize("name", ["rff-fused", "rff"])
def test_draw_frequencies_follow_the_proposal(name):
    """4096 draws of one query track softmax(rff_scores) at atol 0.03 (the
    port of `test_rff_fused_proposal_matches_oracle_distribution`), through
    the fused sampler and through the unfused categorical draw."""
    rng = np.random.default_rng(3)
    emb = (0.7 * rng.standard_normal((32, 16))).astype(np.float32)
    state = rff.rff_init(torch.Generator().manual_seed(0),
                         torch.from_numpy(emb), r=8)
    z = torch.from_numpy(rng.standard_normal((1, 16)).astype(np.float32))
    prop = registry.make_proposal(name, rff_dim=8)
    draw = prop.sample(state, torch.tensor([12345]), z, 4096)
    q = torch.softmax(rff.rff_log_p(state, z), dim=-1)[0].numpy()
    freq = np.bincount(draw.ids[0].numpy(), minlength=32) / 4096.0
    np.testing.assert_allclose(freq, q, atol=0.03)
    _close(draw.log_q, rff.rff_log_prob(state, z, draw.ids))


@pytest.mark.parametrize("name", ["rff-fused", "rff"])
def test_a_rows_draws_ignore_the_rest_of_the_batch(name):
    """Each row under its own key (row counter 0): at a fixed batch shape,
    a row's draws depend only on its own query and key."""
    _, _, state = _jax_state(seed=4)
    prop = registry.make_proposal(name)
    rng = np.random.default_rng(5)
    z = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
    keys = noise.row_keys(0, torch.tensor([3, 9, 1, 4]),
                          torch.tensor([5, 2, 7, 11]))
    batched = prop.sample(state, keys, z, 16)
    for r in range(4):
        other = torch.from_numpy(rng.standard_normal((4, 16))
                                 .astype(np.float32))
        other[r] = z[r]
        okeys = noise.row_keys(5, torch.arange(4) + 100, torch.arange(4))
        okeys[r] = keys[r]
        solo = prop.sample(state, okeys, other, 16)
        assert torch.equal(solo.ids[r], batched.ids[r])
        assert torch.equal(solo.log_q[r], batched.log_q[r])


# ------------------------------------------------------------ heads
def _setup(mode, proposal, seed=0):
    cfgs = []
    for mod in (jcfg, tcfg):
        c = dataclasses.replace(mod.get_config("paper-lm").reduced(),
                                dtype="float32")
        cfgs.append(c.with_head(mode=mode, proposal=proposal))
    jc, tc = cfgs
    jp = jinit(jc, jax.random.PRNGKey(seed))
    tp = params_from_numpy(tc, jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    jstate = jrff.rff_init(jax.random.PRNGKey(seed + 1),
                           jclass_embeddings(jc, jp).astype(jnp.float32))
    tstate = proposal_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    return jc, tc, jp, tp, jstate, tstate, toks, labels


def _jax_proposal(name, ids):
    """A JAX Proposal that draws the port's ids: log q a constant for the
    fused sampler, log p(ids | z) for the unfused one, as each computes
    it."""
    ids = jnp.asarray(ids.numpy().astype(np.int32))

    def sample(state, key, z, m):
        if name == "rff":
            return jbase.Draw(ids, jrff.rff_log_prob(state, z, ids))
        lq = jax.lax.stop_gradient(jrff.rff_log_prob(state, z, ids))
        return jbase.Draw(ids, lq)

    return jbase.Proposal(name, None, sample, jrff.rff_log_prob,
                          jrff.rff_refresh, adaptive=True)


def _port_draw(prop, state, keys, h, proposal, m):
    if proposal == "per_token":
        return prop.sample(state, keys.reshape(B, S), h, m)
    return prop.sample(state, noise.sequence_keys(keys, S), h.mean(1), m)


@pytest.mark.parametrize("proposal", ["per_token", "pooled"])
def test_loss_sampled_and_every_grad_match_jax_given_the_same_draws(
        proposal):
    """rff-fused, whose log q is a constant: the loss and every parameter
    gradient through the whole model."""
    jc, tc, jp, tp, jstate, tstate, toks, labels = _setup("rff-fused",
                                                          proposal)
    prop = registry.from_config(tc.head)
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), tp)
    keys = noise.train_keys(0, 3, B * S)
    hidden = tforward(tc, leaves, torch.from_numpy(toks).long())["hidden"]
    loss = heads.loss_sampled(tc, leaves, prop, tstate, hidden,
                              torch.from_numpy(labels).long(), keys)
    flat = tree_leaves(leaves)
    got = iter(torch.autograd.grad(loss, flat))
    grads = tree_map(lambda _: next(got), leaves)
    draw = _port_draw(prop, tstate, keys, hidden.detach().float(), proposal,
                      tc.head.num_negatives)
    jprop = _jax_proposal("rff-fused", draw.ids)

    def jloss(p):
        hj = jforward(jc, p, jnp.asarray(toks))["hidden"]
        return jheads.loss_sampled(jc, p, jprop, jstate, hj,
                                   jnp.asarray(labels), jax.random.PRNGKey(0))

    jl, jg = jax.value_and_grad(jloss)(jp)
    _close(float(loss.detach()), float(jl))
    a = params_to_numpy(tc, grads)
    b = jax.tree_util.tree_map(np.asarray, jg)
    for (path, x), y in zip(jax.tree_util.tree_leaves_with_path(a),
                            jax.tree_util.tree_leaves(b)):
        _close(x, y, msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("proposal", ["per_token", "pooled"])
def test_unfused_loss_sampled_grads_match_jax_given_the_same_hidden(
        proposal):
    """rff, whose log q = log p(id | h) stays differentiable: the loss and
    its gradients in the hidden states and in the table, from one hidden
    tensor given to both packages. Through the whole model the two
    backbones' 1e-6 differences in h move d log q/dh by ~1e-6 (its
    curvature in h is large where φ(h)·φ(c) is small), which the
    backward amplifies past 1e-5 in the input embedding rows; the head
    itself agrees to ~1e-7."""
    jc, tc, jp, tp, jstate, tstate, toks, labels = _setup("rff", proposal)
    prop = registry.from_config(tc.head)
    h = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (B, S, tc.d_model)).astype(np.float32))
    keys = noise.train_keys(0, 4, B * S)
    draw = _port_draw(prop, tstate, keys, h, proposal, tc.head.num_negatives)
    jprop = _jax_proposal("rff", draw.ids)
    hl, el = h.clone().requires_grad_(True), tp["embed"].clone()
    el.requires_grad_(True)
    loss = heads.loss_sampled(tc, {**tp, "embed": el}, prop, tstate, hl,
                              torch.from_numpy(labels).long(), keys)
    gh, ge = torch.autograd.grad(loss, (hl, el))

    def jloss(hj, ej):
        return jheads.loss_sampled(jc, {**jp, "embed": ej}, jprop, jstate, hj,
                                   jnp.asarray(labels), jax.random.PRNGKey(0))

    jl, (jgh, jge) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h.numpy()), jp["embed"])
    _close(float(loss.detach()), float(jl))
    _close(gh, jgh, msg="d/dh")
    _close(ge, jge, msg="d/dtable")
    # log q is attached: detaching it changes d(loss)/dh
    det = registry.from_config(tc.head, "rff-fused")
    h2 = h.clone().requires_grad_(True)
    g2, = torch.autograd.grad(heads.loss_sampled(
        tc, tp, det, tstate, h2, torch.from_numpy(labels).long(), keys), h2)
    assert float((g2 - gh).abs().max()) > 1e-4


def test_proposal_decode_head_matches_jax_given_the_same_draw():
    """At temperature 1e-4 the Gumbel pick of both packages is the argmax
    of the IS-corrected candidate logits, so the tokens must agree."""
    jc, tc, jp, tp, jstate, tstate, _, _ = _setup("rff-fused", "per_token",
                                                  seed=6)
    prop = registry.from_config(tc.head)
    h = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (5, tc.d_model)).astype(np.float32))
    keys = noise.row_keys(2, torch.arange(5), torch.tensor([3, 1, 4, 1, 5]))
    out = heads.proposal_decode_head(tc, tp, prop, tstate, h, keys, 32, 1e-4)
    draw = prop.sample(tstate, keys, h, 32)
    for r in range(5):
        # the reference engine calls its head one row at a time
        jprop = _jax_proposal("rff-fused", draw.ids[r:r + 1])
        jout = jheads.proposal_decode_head(
            jc, jp, jprop, jstate, jnp.asarray(h.numpy()[r:r + 1]),
            jax.random.PRNGKey(r), 32, 1e-4)
        assert int(out.token[r]) == int(jout.token[0])
        _close(float(out.log_q[r]), float(jout.log_q[0]))


# ------------------------------------------------------------ engine, loop
@pytest.mark.parametrize("head", ["rff-fused", "rff"])
def test_engine_serves_the_rff_heads_batched_equal_solo(head):
    cfg = tcfg.get_config("paper-lm").reduced().with_serve(
        max_slots=3, page_size=4, max_seq=20)
    eng = Engine(cfg, head=head, device="cpu", seed=1)
    assert eng.proposal.name == head and set(eng.index) == {
        "emb", "w", "tau", "phi_c"}
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, tokens=rng.integers(0, cfg.vocab_size, size=p)
                    .astype(np.int32), max_new=n, seed=3)
            for i, (p, n) in enumerate([(6, 5), (9, 7), (6, 3), (11, 6)])]
    res = eng.run(reqs)
    assert eng.stats.waves >= 2
    for r in reqs:
        assert res[r.rid].status == "ok"
        toks = res[r.rid].tokens
        assert toks.min() >= 0 and toks.max() < cfg.padded_vocab
        np.testing.assert_array_equal(toks, eng.replay_single(r))


def test_two_rff_fused_train_runs_are_bitwise_equal():
    cfg = tcfg.get_config("paper-lm").reduced().with_head(
        mode="rff-fused", refresh_every=3)
    runs = [train_loop(cfg, steps=7, batch_size=2, seq_len=16, lr=3e-3,
                       log_every=1000, device="cpu",
                       corpus=np.random.default_rng(0).integers(
                           0, cfg.vocab_size, (16, 17)).astype(np.int32))
            for _ in range(2)]
    (p1, o1, s1, h1), (p2, o2, s2, h2) = runs
    assert h1 == h2 and np.all(np.isfinite(h1))
    for a, b in zip(tree_leaves(p1) + tree_leaves(o1.mu) + tree_leaves(o1.nu),
                    tree_leaves(p2) + tree_leaves(o2.mu) + tree_leaves(o2.nu)):
        assert torch.equal(a, b)
    assert set(s1) == {"emb", "w", "tau", "phi_c"}
    for k in s1:
        assert torch.equal(s1[k], s2[k]), k
    # the refresh after step 5 re-mapped φ(C) from that step's table
    _close(s1["phi_c"], rff.rff_map(s1["emb"], s1["w"], s1["tau"]))


def test_clis_take_the_rff_heads():
    out = serve_cli.main(["--device", "cpu", "--reduced", "--head",
                          "rff-fused", "--requests", "3", "--tokens", "3",
                          "--prompt", "4", "--warmup", "0"])
    assert out["verified"] == 2
    _, _, state, hist = train_main(["--device", "cpu", "--reduced", "--head",
                                    "rff-fused", "--steps", "2", "--batch",
                                    "2", "--seq", "8"])
    assert len(hist) == 2 and set(state) == {"emb", "w", "tau", "phi_c"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_main(["--reduced", "--head", "rff-fused", "--steps", "1"])


# ------------------------------------------------------------ registry
def test_registry_builds_rff_and_raises_like_the_reference():
    """The registry builds every name as the reference's does; unknown
    names and modes raise the reference's errors."""
    head = tcfg.get_config("paper-lm").head
    for name in ("rff", "rff-fused"):
        p = registry.make_proposal(name)
        assert p.name == name and p.adaptive
    assert registry.from_config(head, "rff-fused").name == "rff-fused"
    assert registry.PROPOSAL_NAMES == jregistry.PROPOSAL_NAMES
    assert registry.proposal_modes() == jregistry.proposal_modes()
    # every other registered name builds, with the reference's capabilities
    for name in jregistry.PROPOSAL_NAMES:
        p, jp = registry.make_proposal(name), jregistry.make_proposal(name)
        assert (p.name, p.adaptive, p.trainable) == (jp.name, jp.adaptive,
                                                     jp.trainable)
    for mode in ("uniform", "midx-learnable", "tapas"):
        loss_fn = steps.make_loss_fn(tcfg.get_config("paper-lm").reduced(),
                                     head_mode=mode)
        assert loss_fn.proposal.name == registry.from_config(
            tcfg.get_config("paper-lm").head, mode).name
    for fn, jfn, arg in ((registry.make_proposal, jregistry.make_proposal,
                          "nope"),
                         (registry.validate_mode, jregistry.validate_mode,
                          "nope")):
        with pytest.raises(ValueError) as ours:
            fn(arg)
        with pytest.raises(ValueError) as theirs:
            jfn(arg)
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="unknown head mode"):
        Engine(tcfg.get_config("paper-lm").reduced(), head="nope",
               device="cpu")


# ------------------------------------------------------------ validation
def test_validate_state_on_rff_states_matches_the_reference():
    _, jstate, tstate = _jax_state(seed=7)
    assert validate_state(tstate) == [] == jvalidate_state(jstate)
    assert validate_state(tstate, like=tstate) == []
    bad = {**tstate, "phi_c": tstate["phi_c"].clone()}
    bad["phi_c"][3, 1] = float("nan")
    jbad = {**jstate, "phi_c": jstate["phi_c"].at[3, 1].set(jnp.nan)}
    assert validate_state(bad) == jvalidate_state(jbad) == [
        "NaN values in leaf ['phi_c']"]
    neg = {**tstate, "phi_c": tstate["phi_c"].clone()}
    neg["phi_c"][0, 0] = float("-inf")                  # legal: not NaN
    assert validate_state(neg) == []
    _, jsmall, small = _jax_state(n=200, seed=7)
    assert validate_state(small, like=tstate) == \
        jvalidate_state(jsmall, like=jstate) != []
    # the lifecycle keeps the live state when a refresh comes back broken
    lc = IndexLifecycle(lambda p, s, seed: (bad, {}), every=2, base_seed=0)
    kept, ev = lc.step(1, None, tstate)
    assert kept is tstate and ev.rejected
