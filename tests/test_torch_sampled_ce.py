"""Per-token sampled CE: the port's plain version and differentiable wrapper
against the JAX package's Pallas kernels (interpret mode) and its jnp
oracle, plus the order of the CUDA backward's segmented reduction. The
CUDA kernels are held to the plain version in `test_torch_cuda.py`.

Tolerances: 1e-5 (atol and rtol) on fp32 forward values; for a bf16 table
both sides upcast the same bf16 values and compute in fp32, so the same
1e-5 holds. Gradients: atol 1e-5, rtol 1e-4, the bar of the reference's
own kernel-vs-oracle backward test (`tests/test_kernels.py:178-180`)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sampled_softmax as jss
from repro.kernels.sampled_ce.ops import sampled_ce_pt_op as jop
from repro.kernels.sampled_ce.ref import sampled_ce_pt_ref as jref
from repro_torch.bridge import tensor_from_numpy
from repro_torch.core import sampled_softmax as tss
from repro_torch.kernels import dispatch
from repro_torch.kernels.sampled_ce.cuda import (sampled_ce_pt_bwd_cuda,
                                                 sampled_ce_pt_cuda)
from repro_torch.kernels.sampled_ce.ops import sampled_ce_pt_op
from repro_torch.kernels.sampled_ce.ref import sampled_ce_pt_ref

TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4


def _case(t, d, m, v, seed, dtype=jnp.float32, hot=False):
    """Inputs made with numpy. hot=True forces duplicate ids within rows,
    repeats across rows and negative == positive collisions."""
    rng = np.random.default_rng(seed)
    h = (0.3 * rng.standard_normal((t, d))).astype(np.float32)
    table = np.asarray(jnp.asarray(
        (0.3 * rng.standard_normal((v, d))).astype(np.float32)).astype(dtype))
    pos = rng.integers(0, v, t).astype(np.int32)
    neg = rng.integers(0, v, (t, m)).astype(np.int32)
    if hot:
        neg[:, 1] = neg[:, 0]                      # duplicate within a row
        neg[:, 2] = neg[0, 2]                      # repeated across rows
        neg[::2, 3] = pos[::2]                     # collides with positive
    lq = (-np.log(v) + 0.1 * rng.standard_normal((t, m))).astype(np.float32)
    return h, table, lq, neg, pos


def _torch(h, table, lq, neg, pos):
    return (torch.from_numpy(h), tensor_from_numpy(table, "cpu"),
            torch.from_numpy(lq), torch.from_numpy(neg.astype(np.int64)),
            torch.from_numpy(pos.astype(np.int64)))


@pytest.mark.parametrize("t,d,m,v,dtype,hot", [
    (64, 32, 16, 500, jnp.float32, False),
    (36, 16, 10, 50, jnp.float32, False),     # ragged T and M
    (32, 64, 8, 200, jnp.bfloat16, False),    # native bf16 table
    (20, 16, 12, 8, jnp.float32, True),       # V << M: duplicates, hits
])
def test_forward_matches_jax_kernel_and_oracle(t, d, m, v, dtype, hot):
    h, table, lq, neg, pos = _case(t, d, m, v, seed=t + m, dtype=dtype,
                                   hot=hot)
    j = [jnp.asarray(x) for x in (h, table, lq, neg, pos)]
    ker = np.asarray(jop(*j, True, 16, 4))
    orc = np.asarray(jref(*j))
    loss, lse = dispatch.sampled_ce_pt(*_torch(h, table, lq, neg, pos))
    np.testing.assert_allclose(loss.numpy(), ker, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(loss.numpy(), orc, atol=TOL, rtol=TOL)
    # lse is the loss plus the positive logit
    pos_logit = np.sum(h * np.asarray(table, np.float32)[pos], axis=-1)
    np.testing.assert_allclose(lse.numpy() - pos_logit, ker, atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("hot", [False, True])
def test_backward_matches_jax_grad(hot):
    t, d, m, v = 48, 24, 12, (9 if hot else 100)
    h, table, lq, neg, pos = _case(t, d, m, v, seed=5, hot=hot)
    gj = jax.grad(lambda a, b, c: jop(a, b, c, jnp.asarray(neg),
                                      jnp.asarray(pos), True, 16, 4).mean(),
                  argnums=(0, 1, 2))(jnp.asarray(h), jnp.asarray(table),
                                     jnp.asarray(lq))
    th, ttab, tlq, tneg, tpos = _torch(h, table, lq, neg, pos)
    leaves = [x.requires_grad_(True) for x in (th, ttab, tlq)]
    sampled_ce_pt_op(*leaves, tneg, tpos).mean().backward()
    for name, a, b in zip(("dh", "dtab", "dlq"), leaves, gj):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)


def test_collisions_contribute_nothing():
    """A negative equal to its positive is masked: its dlq is exactly 0 and
    the loss equals the loss without that column."""
    h, table, lq, neg, pos = _case(6, 8, 4, 30, seed=1)
    neg[:, 2] = pos
    th, ttab, tlq, tneg, tpos = _torch(h, table, lq, neg, pos)
    tlq.requires_grad_(True)
    loss = sampled_ce_pt_op(th, ttab, tlq, tneg, tpos)
    loss.sum().backward()
    assert torch.all(tlq.grad[:, 2] == 0)
    keep = [0, 1, 3]
    ref = sampled_ce_pt_ref(th, ttab, tlq.detach()[:, keep] + np.log(4 / 3),
                            tneg[:, keep], tpos)
    np.testing.assert_allclose(loss.detach().numpy(), ref.numpy(), atol=TOL,
                               rtol=TOL)


def segments(neg_ids: torch.Tensor, pos_ids: torch.Tensor, v: int):
    """The order in which the CUDA backward sums d(table), stated plainly
    (`csrc/sampled_ce_pt.cu` builds it on the card). The occurrences of
    token t are its M negatives then its positive, flat index t·(M+1) + j.
    Returns (order, seg): the occurrence indices sorted stably by row id,
    and seg [V+1] with row v's occurrences at order[seg[v] : seg[v+1]], in
    ascending occurrence index. A row of at most 64 occurrences is summed
    in that order in one chain; a longer one in up to 8 runs of
    consecutive ranks, whose sums are then added in rank order."""
    ids = torch.cat([neg_ids, pos_ids[:, None]], dim=1).reshape(-1)
    sorted_ids, order = torch.sort(ids, stable=True)
    seg = torch.searchsorted(
        sorted_ids, torch.arange(v + 1, device=ids.device, dtype=ids.dtype))
    return order, seg


def test_segments_give_the_scatter_in_a_fixed_order():
    """The order of the CUDA d(table) reduction, stated plainly: summing
    coef·h over each row's segment, in the order `segments` returns, is the
    scatter-add that autograd computes."""
    t, m, v, d = 16, 6, 10, 5
    rng = np.random.default_rng(0)
    neg = torch.from_numpy(rng.integers(0, v, (t, m)))
    pos = torch.from_numpy(rng.integers(0, v, t))
    h = torch.from_numpy(rng.standard_normal((t, d)))
    coef = torch.from_numpy(rng.standard_normal((t, m + 1)))
    order, seg = segments(neg, pos, v)
    assert seg.shape == (v + 1,) and seg[0] == 0 and seg[-1] == t * (m + 1)
    ids = torch.cat([neg, pos[:, None]], 1).reshape(-1)
    got = torch.zeros((v, d), dtype=torch.float64)
    for row in range(v):
        occ = order[seg[row]:seg[row + 1]]
        assert torch.all(ids[occ] == row)
        assert torch.all(occ[1:] > occ[:-1])          # ascending: fixed order
        for o in occ:
            got[row] += coef.reshape(-1)[o] * h[o // (m + 1)]
    want = torch.zeros((v, d), dtype=torch.float64).index_add_(
        0, ids, coef.reshape(-1, 1) * h.repeat_interleave(m + 1, 0))
    torch.testing.assert_close(got, want)


def test_dispatch_and_cuda_wrappers_refuse_what_they_cannot_take():
    args = _torch(*_case(4, 8, 3, 20, seed=2))
    with pytest.raises(RuntimeError, match="no implementation"):
        dispatch.sampled_ce_pt(*(x.to("meta") for x in args))
    with pytest.raises(ValueError, match="CUDA device"):
        sampled_ce_pt_cuda(*args)
    g = torch.ones(4)
    with pytest.raises(ValueError, match="CUDA device"):
        sampled_ce_pt_bwd_cuda(g, *args, g)


@pytest.mark.parametrize("mask", [True, False])
def test_core_losses_match_jax(mask):
    rng = np.random.default_rng(7)
    t, m, n = 9, 6, 11
    pos_logit = rng.standard_normal(t).astype(np.float32)
    neg_logits = rng.standard_normal((t, m)).astype(np.float32)
    log_q = (-np.log(n) + 0.2 * rng.standard_normal((t, m))).astype(
        np.float32)
    pos = rng.integers(0, n, t)
    neg = rng.integers(0, n, (t, m))
    neg[:, 0] = pos
    got = tss.sampled_softmax_loss(*(torch.from_numpy(x) for x in (
        pos_logit, neg_logits, log_q, neg, pos)), mask_collisions=mask)
    want = jss.sampled_softmax_loss(*(jnp.asarray(x) for x in (
        pos_logit, neg_logits, log_q, neg, pos)), mask_collisions=mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    logits = rng.standard_normal((t, n)).astype(np.float32)
    np.testing.assert_allclose(
        tss.full_softmax_loss(torch.from_numpy(logits),
                              torch.from_numpy(pos)).numpy(),
        np.asarray(jss.full_softmax_loss(jnp.asarray(logits),
                                         jnp.asarray(pos))),
        atol=TOL, rtol=TOL)
    assert tss.NEG_INF == jss.NEG_INF
    assert tss.NEG_INF_THRESHOLD == jss.NEG_INF_THRESHOLD
