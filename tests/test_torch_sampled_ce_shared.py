"""Shared-negative sampled CE and the pooled / mixture proposals: the port's
plain versions and samplers against the JAX package on the CPU. The CUDA
kernels are held to the plain versions in `test_torch_cuda.py`.

Inputs are made with numpy from a seed. Tolerances:
  - 1e-5 (atol and rtol) on fp32 forward values, and on the losses and
    every parameter gradient of `loss_midx` given the same negatives (the
    bar of `tests/test_fused_head.py`); for bf16 rows both sides upcast the
    same bf16 values and compute in fp32, so the same bar holds;
  - the CE backward: atol 1e-5, rtol 1e-4, the bar of the reference's own
    kernel-vs-oracle backward test (`tests/test_kernels.py:178-180`);
  - the inverse-CDF draw: the normalised CDF within 1e-6; the indices
    exactly, on inputs where no uniform lies within 1e-6 of a CDF edge
    (there a one-ulp difference between torch's and XLA's cumsum could
    flip a draw; the test asserts the margin before it compares);
  - draw frequencies against exp(log q): total variation below 0.05 over
    50 000 draws (its expected size there is about 0.02).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.core import midx as jmidx
from repro.kernels.sampled_ce.ref import sampled_ce_ref as jref
from repro.kernels.sampled_ce.sampled_ce import sampled_ce as jkernel
from repro.kernels.sampled_ce.sampled_ce import sampled_ce_bwd as jkernel_bwd
from repro.models import heads as jheads
from repro.models.model import forward as jforward
from repro.models.model import init_params as jinit
from repro_torch import configs as tcfg
from repro_torch.bridge import (index_from_numpy, params_from_numpy,
                                params_to_numpy, tensor_from_numpy)
from repro_torch.core import midx, noise
from repro_torch.kernels import dispatch
from repro_torch.kernels.sampled_ce.cuda import (sampled_ce_bwd_cuda,
                                                 sampled_ce_cuda)
from repro_torch.kernels.sampled_ce.ops import sampled_ce_op
from repro_torch.core.sampled_softmax import (NEG_INF, NEG_INF_THRESHOLD,
                                              corrected_logits)
from repro_torch.kernels.sampled_ce.ref import sampled_ce_ref
from repro_torch.models import heads
from repro_torch.models.model import forward as tforward
from repro_torch.optim.optimizers import tree_leaves, tree_map

TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
FIELDS = ("kind", "codebook1", "codebook2", "assign1", "assign2",
          "residuals", "sorted_ids", "offsets", "counts", "log_counts")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: when test files run in parallel worker
    processes, torch's thread pools oversubscribe the cores, and the TF32
    emulation test's deep products slow down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(b, s, m, d, v, seed, dtype=jnp.float32, hot=False):
    """Numpy inputs of one shared-negative CE call. hot=True forces
    duplicate negatives, negatives that collide with positives, and a
    token whose every negative collides (sequence 0, token 0)."""
    rng = np.random.default_rng(seed)
    h = (0.3 * rng.standard_normal((b, s, d))).astype(np.float32)
    table = np.asarray(jnp.asarray(
        (0.3 * rng.standard_normal((v, d))).astype(np.float32)).astype(dtype))
    pos = rng.integers(0, v, (b, s)).astype(np.int32)
    neg = rng.integers(0, v, (b, m)).astype(np.int32)
    if hot:
        neg[:, 1] = neg[:, 0]                       # duplicates
        neg[:, 2] = pos[:, min(1, s - 1)]           # collides with a token
        neg[0, :] = 7                               # every negative collides
        pos[0, 0] = 7                               # ... with token (0, 0)
    lq = (-np.log(v) + 0.1 * rng.standard_normal((b, m))).astype(np.float32)
    return h, table, lq, neg, pos


def _rows(table, neg, pos):
    return table[pos], table[neg]


def _torch(h, table, lq, neg, pos):
    pe, ne = _rows(table, neg, pos)
    return (torch.from_numpy(h), tensor_from_numpy(np.ascontiguousarray(pe),
                                                   "cpu"),
            tensor_from_numpy(np.ascontiguousarray(ne), "cpu"),
            torch.from_numpy(lq), torch.from_numpy(neg.astype(np.int64)),
            torch.from_numpy(pos.astype(np.int64)))


def _jax_seq(h, table, lq, neg, pos, b):
    pe, ne = _rows(table, neg, pos)
    return [jnp.asarray(x) for x in (h[b], pe[b], ne[b], lq[b], neg[b],
                                     pos[b])]


CASES = [
    (2, 16, 16, 32, 500, jnp.float32, False),
    (3, 7, 13, 24, 60, jnp.float32, False),      # odd S and M
    (1, 1, 20, 16, 100, jnp.float32, False),     # one token
    (2, 9, 11, 40, 200, jnp.bfloat16, False),    # native bf16 rows
    (2, 10, 12, 16, 9, jnp.float32, True),       # V << M: duplicates, hits
    (2, 5, 6, 8, 50, jnp.bfloat16, True),
]


@pytest.mark.parametrize("b,s,m,d,v,dtype,hot", CASES)
def test_plain_forward_matches_jax_kernel_and_oracle(b, s, m, d, v, dtype,
                                                     hot):
    h, table, lq, neg, pos = _case(b, s, m, d, v, seed=s + m, dtype=dtype,
                                   hot=hot)
    loss, lse = dispatch.sampled_ce(*_torch(h, table, lq, neg, pos))
    assert loss.shape == lse.shape == (b, s)
    for i in range(b):
        args = _jax_seq(h, table, lq, neg, pos, i)
        kl, klse = jkernel(*args, block_t=8, block_m=8, interpret=True)
        np.testing.assert_allclose(loss[i].numpy(), np.asarray(kl), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(lse[i].numpy(), np.asarray(klse),
                                   atol=TOL, rtol=TOL)
        np.testing.assert_allclose(loss[i].numpy(), np.asarray(jref(*args)),
                                   atol=TOL, rtol=TOL)
    if hot:                         # all negatives masked: the loss is 0
        assert abs(float(loss[0, 0])) <= TOL


@pytest.mark.parametrize("b,s,m,d,v,dtype,hot", CASES)
def test_plain_backward_matches_jax_kernel_and_grad(b, s, m, d, v, dtype,
                                                    hot):
    h, table, lq, neg, pos = _case(b, s, m, d, v, seed=3 * s + m,
                                   dtype=dtype, hot=hot)
    g = np.random.default_rng(s).random((b, s)).astype(np.float32)
    th, tpe, tne, tlq, tneg, tpos = _torch(h, table, lq, neg, pos)
    _, lse = dispatch.sampled_ce(th, tpe, tne, tlq, tneg, tpos)
    got = dispatch.sampled_ce_bwd(torch.from_numpy(g), th, tpe, tne, tlq,
                                  tneg, tpos, lse)
    # and through the autograd wrapper, as the head calls it
    leaves = [x.float().requires_grad_(True) for x in (th, tpe, tne, tlq)]
    sampled_ce_op(*leaves, tneg, tpos).backward(torch.from_numpy(g))
    for i in range(b):
        args = _jax_seq(h, table, lq, neg, pos, i)
        _, jlse = jkernel(*args, block_t=8, block_m=8, interpret=True)
        ker = jkernel_bwd(jnp.asarray(g[i]), *args, jlse, block_t=8,
                          block_m=8, interpret=True)
        f32 = [a.astype(jnp.float32) for a in args[:4]]
        grad = jax.grad(lambda a, p, n, q: jnp.sum(
            jnp.asarray(g[i]) * jref(a, p, n, q, args[4], args[5])),
            argnums=(0, 1, 2, 3))(*f32)
        for name, x, y, z, leaf in zip(("dh", "dpe", "dne", "dlq"), got, ker,
                                       grad, leaves):
            for want in (y, z):
                np.testing.assert_allclose(x[i].numpy(), np.asarray(want),
                                           atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                           err_msg=name)
            np.testing.assert_allclose(leaf.grad[i].numpy(), np.asarray(y),
                                       atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                       err_msg=name)


def test_plain_backward_is_autograd_of_the_plain_forward():
    h, table, lq, neg, pos = _case(2, 6, 9, 12, 30, seed=4, hot=True)
    th, tpe, tne, tlq, tneg, tpos = _torch(h, table, lq, neg, pos)
    g = torch.rand((2, 6), generator=torch.Generator().manual_seed(0))
    leaves = [x.clone().requires_grad_(True) for x in (th, tpe, tne, tlq)]
    want = torch.autograd.grad(sampled_ce_ref(*leaves, tneg, tpos), leaves, g)
    _, lse = dispatch.sampled_ce(th, tpe, tne, tlq, tneg, tpos)
    got = dispatch.sampled_ce_bwd(g, th, tpe, tne, tlq, tneg, tpos, lse)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_dispatch_and_cuda_wrappers_refuse_what_they_cannot_take():
    args = _torch(*_case(2, 4, 3, 8, 20, seed=2))
    with pytest.raises(RuntimeError, match="no implementation"):
        dispatch.sampled_ce(*(x.to("meta") for x in args))
    with pytest.raises(ValueError, match="CUDA device"):
        sampled_ce_cuda(*args)
    g = torch.ones((2, 4))
    with pytest.raises(ValueError, match="CUDA device"):
        sampled_ce_bwd_cuda(g, *args, g)


def _tiled_forward(hidden, pos_emb, neg_emb, log_q, neg_ids, pos_ids,
                   tile=64):
    """The CUDA forward's order of operations on the CPU: per 64-negative
    tile, each token's max m of its corrected, collision-masked logits and
    its sum l of exp(corr − m) over the valid entries (corr >
    NEG_INF_THRESHOLD); the tiles' (m, l) merged in ascending tile order
    by the online rule; the positive joined last. -> (loss, lse) [B, S]."""
    b, s, _ = hidden.shape
    m = neg_emb.shape[1]
    logits = torch.matmul(hidden.float(), neg_emb.float().transpose(-1, -2))
    corr = corrected_logits(logits, log_q.float()[:, None, :], m)
    corr = torch.where(neg_ids[:, None, :] == pos_ids[:, :, None],
                       corr.new_tensor(NEG_INF), corr)
    nt = -(-m // tile)
    corr = torch.cat([corr, corr.new_full((b, s, nt * tile - m), NEG_INF)],
                     dim=-1).reshape(b, s, nt, tile)
    m_t = corr.amax(dim=-1)                                   # [B, S, nt]
    l_t = torch.where(corr > NEG_INF_THRESHOLD,
                      torch.exp(corr - m_t[..., None]),
                      torch.zeros_like(corr)).sum(dim=-1)
    run_m = torch.full((b, s), NEG_INF)
    run_l = torch.zeros((b, s))
    for k in range(nt):
        new_m = torch.maximum(run_m, m_t[..., k])
        run_l = (run_l * torch.exp(run_m - new_m)
                 + l_t[..., k] * torch.exp(m_t[..., k] - new_m))
        run_m = new_m
    pos = torch.sum(hidden.float() * pos_emb.float(), dim=-1)
    m_fin = torch.maximum(run_m, pos)
    l_fin = run_l * torch.exp(run_m - m_fin) + torch.exp(pos - m_fin)
    lse = torch.log(torch.clamp(l_fin, min=1e-30)) + m_fin
    return lse - pos, lse


TILED_CASES = [
    (2, 5, 20, 24, 300, jnp.float32, "hot"),      # one ragged tile
    (2, 9, 130, 16, 5000, jnp.float32, "tile"),   # three tiles, one masked
    (1, 3, 64, 8, 900, jnp.bfloat16, "tile"),     # one whole tile, masked
    (3, 7, 70, 40, 200, jnp.bfloat16, "hot"),
]


@pytest.mark.parametrize("b,s,m,d,v,dtype,mask", TILED_CASES)
def test_tiled_forward_order_matches_jax_kernel_and_plain(b, s, m, d, v,
                                                          dtype, mask):
    """The forward's per-tile partials and their merge give the JAX
    kernel's and the plain version's loss and lse within 1e-5, with a
    ragged last tile (M = 20, 70, 130), a token whose negatives of one
    whole tile all collide with it, and a token whose negatives all
    collide (loss exactly 0)."""
    h, table, lq, neg, pos = _case(b, s, m, d, v, seed=m + d, dtype=dtype,
                                   hot=mask == "hot")
    if mask == "tile":                  # tile 1 (or 0) of token (0, 1)
        lo = 64 if m > 64 else 0
        neg[0, lo:lo + 64] = pos[0, 1]
    args = _torch(h, table, lq, neg, pos)
    loss, lse = _tiled_forward(*args)
    want_loss, want_lse = dispatch.sampled_ce(*args)
    torch.testing.assert_close(loss, want_loss, atol=TOL, rtol=TOL)
    torch.testing.assert_close(lse, want_lse, atol=TOL, rtol=TOL)
    for i in range(b):
        kl, klse = jkernel(*_jax_seq(h, table, lq, neg, pos, i), block_t=8,
                           block_m=8, interpret=True)
        np.testing.assert_allclose(loss[i].numpy(), np.asarray(kl), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(lse[i].numpy(), np.asarray(klse),
                                   atol=TOL, rtol=TOL)
    if mask == "hot":                   # every negative of token (0, 0)
        assert float(loss[0, 0]) == 0.0
        assert float(lse[0, 0]) == float(torch.sum(args[0][0, 0]
                                                   * args[1][0, 0].float()))


# ------------------------------------------------------------- samplers
def test_inverse_cdf_sample_matches_jax_given_the_same_uniforms():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 50)).astype(np.float32)
    logits[:, 5] = -np.inf                          # empty clusters
    logits[1, :10] = -np.inf
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    key = jax.random.PRNGKey(3)
    m = 400
    want = np.asarray(jmidx._inverse_cdf_sample(key, jnp.asarray(probs), m))
    u = np.asarray(jax.random.uniform(key, (3, m)))  # the reference's u
    jcdf = np.asarray(jnp.cumsum(jnp.asarray(probs), axis=-1))
    jcdf = jcdf / jcdf[:, -1:]
    tcdf = torch.cumsum(torch.from_numpy(probs), -1)
    tcdf = (tcdf / tcdf[:, -1:]).numpy()
    np.testing.assert_allclose(tcdf, jcdf, atol=1e-6, rtol=0)
    margin = np.abs(u[:, :, None] - jcdf[:, None, :]).min()
    assert margin > 1e-6, "a uniform sits on a CDF edge: pick another seed"
    got = midx.inverse_cdf_sample(torch.from_numpy(probs), torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.all(probs[np.arange(3)[:, None], want] > 0)


def test_pick_rows_gradient_is_the_gather_gradient():
    """The shared draws' log q pick: a repeated index gets the sum of its
    gradients, as torch.gather's backward gives, in a fixed order."""
    rng = np.random.default_rng(6)
    table = torch.from_numpy(rng.standard_normal((3, 40)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 40, (3, 200)))
    idx[:, :50] = 5                                  # a hot entry
    g = torch.from_numpy(rng.standard_normal((3, 200)).astype(np.float32))
    a = table.clone().requires_grad_(True)
    b = table.clone().requires_grad_(True)
    out = midx._PickRows.apply(a, idx)
    assert torch.equal(out, torch.gather(table, 1, idx))
    out.backward(g)
    torch.gather(b, 1, idx).backward(g)
    torch.testing.assert_close(a.grad, b.grad, atol=1e-5, rtol=1e-5)


def _index(seed=0, v=120, d=16, k=6, kind="rq"):
    rng = np.random.default_rng(seed)
    table = (rng.standard_normal((v, d))).astype(np.float32)
    from repro.index.build import build as jbuild
    jidx = jbuild(jax.random.PRNGKey(seed), jnp.asarray(table), kind=kind,
                  k=k, iters=3)
    tidx = index_from_numpy(
        {f: (getattr(jidx, f) if f == "kind" else np.asarray(getattr(jidx, f)))
         for f in FIELDS}, device="cpu")
    return jidx, tidx


def _jax_flat(monkeypatch, proposal, jidx, z):
    """The reference sampler's [B, K²] log table (the `flat_log` its
    `_shared_draw` receives)."""
    seen = {}

    def capture(index, key, flat_log, m, member_fn=None):
        seen["flat"] = flat_log
        return jmidx.Draw(jnp.zeros(flat_log.shape[:-1] + (m,), jnp.int32),
                          jnp.zeros(flat_log.shape[:-1] + (m,)))

    monkeypatch.setattr(jmidx, "_shared_draw", capture)
    sampler = jmidx.sample_pooled if proposal == "pooled" \
        else jmidx.sample_mixture
    sampler(jidx, jax.random.PRNGKey(0), jnp.asarray(z), 4)
    return np.asarray(seen["flat"])


def _jax_log_q(flat, jidx, ids):
    """log q of class ids [B, m] under the [B, K²] table, as `_shared_draw`
    computes it: flat[c] − log|Ω(c)| − lse(flat)."""
    k = jidx.codebook1.shape[0]
    c = np.asarray(jidx.assign1)[ids] * k + np.asarray(jidx.assign2)[ids]
    lse = np.asarray(jax.nn.logsumexp(jnp.asarray(flat), axis=-1))
    logc = np.asarray(jidx.log_counts).reshape(-1)
    return np.take_along_axis(flat, c, -1) - logc[c] - lse[:, None]


@pytest.mark.parametrize("proposal", ["pooled", "mixture"])
@pytest.mark.parametrize("kind", ["rq", "pq"])
def test_shared_log_q_matches_the_jax_tables(monkeypatch, proposal, kind):
    jidx, tidx = _index(kind=kind)
    z = np.random.default_rng(1).standard_normal((3, 5, 16)).astype(
        np.float32)
    sampler = midx.sample_pooled if proposal == "pooled" \
        else midx.sample_mixture
    keys = noise.sequence_keys(noise.train_keys(0, 2, 15), 5)
    draw = sampler(tidx, torch.from_numpy(z), 64, keys)
    assert draw.ids.shape == draw.log_q.shape == (3, 64)
    ids = draw.ids.numpy()
    flat = _jax_flat(monkeypatch, proposal, jidx, z)
    np.testing.assert_allclose(draw.log_q.numpy(),
                               _jax_log_q(flat, jidx, ids), atol=TOL,
                               rtol=TOL)
    if proposal == "pooled":
        want = jmidx.log_prob(jidx, jnp.asarray(z.mean(1)), jnp.asarray(ids))
        np.testing.assert_allclose(draw.log_q.numpy(), np.asarray(want),
                                   atol=TOL, rtol=TOL)


@pytest.mark.parametrize("proposal", ["pooled", "mixture"])
def test_shared_draws_follow_exp_log_q(proposal):
    _, tidx = _index(seed=2, v=80, k=4)
    z = 0.5 * torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 4, 16)).astype(np.float32))
    sampler = midx.sample_pooled if proposal == "pooled" \
        else midx.sample_mixture
    n = 50_000
    draw = sampler(tidx, z, n, noise.sequence_keys(noise.train_keys(1, 0, 4),
                                                   4))
    ids, lq = draw.ids[0].numpy(), draw.log_q[0].detach().numpy()
    q = {}
    for i, l in zip(ids, lq):
        q[i] = float(np.exp(l))
    freq = np.bincount(ids, minlength=80) / n
    seen = np.array(sorted(q))
    tv = 0.5 * (np.abs(freq[seen] - np.array([q[i] for i in seen])).sum()
                + (1.0 - sum(q.values())))
    assert tv < 0.05, tv


@pytest.mark.parametrize("proposal", ["pooled", "mixture"])
def test_a_sequence_draws_the_same_negatives_whatever_the_batch(proposal):
    _, tidx = _index(seed=4)
    z = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, 6, 16)).astype(np.float32))
    sampler = midx.sample_pooled if proposal == "pooled" \
        else midx.sample_mixture
    small = sampler(tidx, z[:2], 32, noise.sequence_keys(
        noise.train_keys(0, 9, 2 * 6), 6))
    other = z.clone()
    other[2:] = -other[2:]                          # other sequences differ
    big = sampler(tidx, other, 32, noise.sequence_keys(
        noise.train_keys(0, 9, 4 * 6), 6))
    assert torch.equal(small.ids, big.ids[:2])
    assert torch.equal(small.log_q, big.log_q[:2])
    assert not torch.equal(big.ids[0], big.ids[1])
    again = sampler(tidx, z[:2], 32, noise.sequence_keys(
        noise.train_keys(0, 10, 2 * 6), 6))         # another step
    assert not torch.equal(small.ids, again.ids)


# ------------------------------------------------------------- the head
B, S = 2, 8


def _setup(proposal, seed=0):
    j = jcfg.get_config("paper-lm").reduced()
    t = tcfg.get_config("paper-lm").reduced()
    head = dict(proposal=proposal, num_negatives=24)
    jc = dataclasses.replace(j, dtype="float32").with_head(**head)
    tc = dataclasses.replace(t, dtype="float32").with_head(**head)
    jp = jinit(jc, jax.random.PRNGKey(seed))
    tp = params_from_numpy(tc, jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    jidx = jheads.init_head_state(jc, jp, jax.random.PRNGKey(seed + 1))
    tidx = index_from_numpy(
        {f: (getattr(jidx, f) if f == "kind" else np.asarray(getattr(jidx, f)))
         for f in FIELDS}, device="cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    labels[0, :3] = labels[0, 3]                    # repeated labels
    return jc, tc, jp, tp, jidx, tidx, toks, labels


@pytest.mark.parametrize("proposal", ["pooled", "mixture"])
def test_loss_midx_and_every_grad_match_jax_given_the_same_negatives(
        monkeypatch, proposal):
    jc, tc, jp, tp, jidx, tidx, toks, labels = _setup(proposal)
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), tp)
    keys = noise.train_keys(0, 3, B * S)
    hidden = tforward(tc, leaves, torch.from_numpy(toks).long())["hidden"]
    loss = heads.loss_midx(tc, leaves, tidx, hidden,
                           torch.from_numpy(labels).long(), keys)
    flat = tree_leaves(leaves)
    got = iter(torch.autograd.grad(loss, flat))
    grads = tree_map(lambda _: next(got), leaves)

    sampler = midx.sample_pooled if proposal == "pooled" \
        else midx.sample_mixture
    draw = sampler(tidx, hidden.detach(), tc.head.num_negatives,
                   noise.sequence_keys(keys, S))
    ids = jnp.asarray(draw.ids.numpy().astype(np.int32))
    kk = jidx.codebook1.shape[0]
    cluster = jidx.assign1[ids] * kk + jidx.assign2[ids]
    # the loss to compare draws the port's negatives, and takes log q from
    # the reference's own proposal table for them (`_shared_draw`'s line)
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
    np.testing.assert_allclose(float(loss.detach()), float(jl), atol=TOL,
                               rtol=TOL)
    a = params_to_numpy(tc, grads)
    b = jax.tree_util.tree_map(np.asarray, jg)
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for (path, x), y in zip(jax.tree_util.tree_leaves_with_path(a),
                            jax.tree_util.tree_leaves(b)):
        np.testing.assert_allclose(x, y, atol=TOL, rtol=TOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("proposal", ["pooled", "mixture"])
def test_loss_midx_gradient_reaches_hidden_through_log_q(proposal):
    """log q is not stop-gradient'ed: detaching it changes d(loss)/dh."""
    _, tc, _, tp, _, tidx, _, labels = _setup(proposal, seed=1)
    hidden = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, S, tc.d_model)).astype(np.float32)).requires_grad_(True)
    keys = noise.train_keys(0, 0, B * S)
    tl = torch.from_numpy(labels).long()
    g1, = torch.autograd.grad(heads.loss_midx(tc, tp, tidx, hidden, tl, keys),
                              hidden)
    sampler = midx.sample_pooled if proposal == "pooled" \
        else midx.sample_mixture
    draw = sampler(tidx, hidden.detach(), tc.head.num_negatives,
                   noise.sequence_keys(keys, S))
    table = tp["embed"]
    l2 = sampled_ce_op(hidden, table[tl], table[draw.ids],
                       draw.log_q.detach(), draw.ids, tl).mean()
    g2, = torch.autograd.grad(l2, hidden)
    assert float((g1 - g2).abs().max()) > 1e-6


def _tf32(a: torch.Tensor, nearest: bool = True) -> torch.Tensor:
    """a cut to TF32 (a 10-bit mantissa): rounded to nearest, ties away
    from 0, as the kernels round the big part; or truncated, as the tensor
    core reads the fp32 small part."""
    bits = a.float().contiguous().view(torch.int32)
    return (((bits + 0x1000) if nearest else bits) & ~0x1FFF).view(
        torch.float32)


def _rz(a: torch.Tensor) -> torch.Tensor:
    """a (fp64) to fp32 rounded toward zero, as the tensor core rounds the
    sum it accumulates."""
    r = a.float()
    return torch.where(r.double().abs() > a.abs(),
                       torch.nextafter(r, torch.zeros_like(r)), r)


def _emulated(matmul, model: str):
    """matmul over TF32 operands. "one": one product of the roundings,
    exact. The rest are 3xTF32, small·big + big·small + big·big with the
    small parts the TF32 parts of the remainders, as the kernels' `split`
    and the tensor core form them, and differ in how the sums are kept:
    "exact" sums them in fp64 and rounds once; "truncating" adds each
    mma's 8-deep sum into an fp32 accumulator rounded toward zero, as the
    tensor core does, over the whole depth; "slabs" does that within each
    32-deep slab, from zero, and adds the slabs into an fp32 sum rounded to
    nearest, as `kernels/common/tf32x3.cuh::product` does."""
    def product(a, b):
        ab, bb = _tf32(a), _tf32(b)
        if model == "one":
            return matmul(ab.double(), bb.double()).float()
        pairs = [(_tf32(a - ab, False), bb), (ab, _tf32(b - bb, False)),
                 (ab, bb)]
        if model == "exact":
            return sum(matmul(u.double(), v.double())
                       for u, v in pairs).float()
        k = a.shape[-1]
        slab = 32 if model == "slabs" else k
        acc = 0.0
        for kb in range(0, k, slab):
            part = 0.0
            for k0 in range(kb, min(kb + slab, k), 8):
                for u, v in pairs:
                    part = _rz(part + matmul(u[..., k0:k0 + 8].double(),
                                             v[..., k0:k0 + 8, :].double()))
            acc = acc + part
        return acc
    return product


def test_tf32x3_products_meet_the_hold(monkeypatch):
    """The precision design of the CUDA kernels, on the CPU: the plain
    backward with its three products (the logits h·neᵀ, w·ne and
    (g·w)ᵀ·h) on TF32 operands, from the plain forward's lse, against the
    plain fp32 backward, and the forward's per-tile partials and merge
    (`_tiled_forward`) with its logit product on TF32 operands against the
    plain fp32 forward, under the kernels' hold 1e-4·max(|plain|, min(1,
    max |plain|)) per tensor. One sequence at llama3.2-1b's width (S=256,
    M=1024, D=2048, inputs drawn as `chip_smoke.py` draws them). One TF32
    product misses the hold in dh (~4x), dne (~14x) and dlq (~6x), and
    takes ~0.8 of it in the forward's loss and lse; 3xTF32 summed exactly
    meets it with a margin of 5x or more (0.02 of it; the forward ~0.002).
    The tensor core truncates as it accumulates: over the logits'
    2048-deep reduction (768 mma) that alone misses the hold in dne
    (~1.8x; an H100 read 1.6x before the kernels took slabs), and summing
    32-deep slabs into fp32, as the kernels do, brings it back inside by 5x
    (~0.05; the forward ~0.003)."""
    from repro_torch.kernels.sampled_ce.ref import (sampled_ce_bwd_ref,
                                                    sampled_ce_fwd_ref)
    rng = np.random.default_rng(5)
    s, m, d, v = 256, 1024, 2048, 5000
    h = torch.from_numpy((0.5 * rng.standard_normal((1, s, d)))
                         .astype(np.float32))
    table = (0.1 * rng.standard_normal((v, d))).astype(np.float32)
    neg = rng.integers(0, v, (1, m))
    pos = rng.integers(0, v, (1, s))
    neg[:, 2] = pos[:, -1]                         # a collision
    lq = torch.from_numpy((-9.0 + 0.5 * rng.standard_normal((1, m)))
                          .astype(np.float32))
    g = torch.from_numpy(rng.random((1, s)).astype(np.float32))
    args = (h, torch.from_numpy(table[pos]), torch.from_numpy(table[neg]), lq,
            torch.from_numpy(neg), torch.from_numpy(pos))
    want_f = sampled_ce_fwd_ref(*args)
    lse = want_f[1]
    want = sampled_ce_bwd_ref(g, *args, lse)
    matmul = torch.matmul
    ratios, fwd = {}, {}
    for model in ("one", "exact", "truncating", "slabs"):
        monkeypatch.setattr(torch, "matmul", _emulated(matmul, model))
        got = sampled_ce_bwd_ref(g, *args, lse)
        got_f = _tiled_forward(*args)
        monkeypatch.setattr(torch, "matmul", matmul)
        ratios[model], fwd[model] = {}, {}
        for out, names, gots, wants in ((ratios, ("dh", "dpe", "dne", "dlq"),
                                         got, want),
                                        (fwd, ("loss", "lse"), got_f,
                                         want_f)):
            for name, a, b in zip(names, gots, wants):
                limit = 1e-4 * b.abs().clamp(
                    min=min(1.0, float(b.abs().max())))
                out[model][name] = float(((a - b).abs() / limit).max())
    assert ratios["one"]["dh"] > 2.0 and ratios["one"]["dne"] > 2.0, ratios
    assert max(ratios["exact"].values()) < 0.2, ratios     # 5x inside
    assert ratios["truncating"]["dne"] > 1.0, ratios       # misses
    assert max(ratios["slabs"].values()) < 0.2, ratios     # 5x inside
    assert min(fwd["one"].values()) > 0.3, fwd             # near the hold
    assert max(fwd["exact"].values()) < 0.02, fwd          # 50x inside
    assert max(fwd["slabs"].values()) < 0.02, fwd          # 50x inside
