"""The backward of the MIDX proposal tables: the port's closed form
(`kernels/midx_probs/ref.py::midx_probs_bwd_ref`) and the autograd
wrappers that now take it (`proposal_tables`, `proposal_tables_q`) against
the JAX package on the CPU: `jax.vjp` of its oracle `midx_probs_ref`, and
the gradients of its own `proposal_tables(use_kernel=True,
interpret=True)` / `proposal_tables_q` (their custom VJPs, which
differentiate a recompute through that oracle).

Cases: PQ and RQ; fp32, int8 and fp8 codebooks; the four cotangents
together and each alone; dz alone and with d(codebooks); a row of counts
zeroed (a stage-1 codeword no class uses), alone and with the maximum of
s2 tied between two codewords. Indexes are built by the reference and
carried across through `repro_torch.bridge`; inputs come from numpy with
a seed. Bar: 1e-5 atol and rtol (`tests/test_fused_head.py`'s). The CUDA
kernel is held to the plain closed form in `test_torch_cuda.py` and
`chip_smoke.py`."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build as jbuild
from repro.index import quantized as jq
from repro.kernels.midx_probs.ops import proposal_tables as jtables
from repro.kernels.midx_probs.ops import proposal_tables_q as jtables_q
from repro.kernels.midx_probs.ref import midx_probs_ref as jref
from repro_torch.bridge import index_from_numpy, tensor_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.kernels.midx_probs.ops import (proposal_tables,
                                                proposal_tables_q)
from repro_torch.kernels.midx_probs.ref import (midx_probs_bwd_ref,
                                                midx_probs_ref)

TOL = 1e-5
T, D, K = 7, 24, 8
FIELDS = ("codebook1", "codebook2", "assign1", "assign2", "residuals",
          "sorted_ids", "offsets", "counts", "log_counts")
COTS = ("all", "s1", "s2", "log_psi", "lse")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tier-1 run puts test files in parallel
    workers, and torch's thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _built(kind):
    rng = np.random.default_rng(11)
    emb = (0.5 * rng.standard_normal((300, D))).astype(np.float32)
    return jbuild(jax.random.PRNGKey(3), jnp.asarray(emb), kind=kind, k=K,
                  iters=3)


def _case(kind, fmt, zero_row=False, tie=False, seed=0):
    """(reference index, port index, query z, the codebooks each side
    hands the tables: (cb1, sc1, cb2, sc2), scales None in fp32).
    zero_row: counts row 1 zeroed. tie: codewords 0 and 1 of the second
    stage made equal and large, so max s2 is tied between them."""
    jidx = _built(kind)
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((T, D)).astype(np.float32)
    if tie:
        cb2 = np.array(jidx.codebook2)
        cb2[:2] = 0.3
        jidx = dataclasses.replace(jidx, codebook2=jnp.asarray(cb2))
        z = z + 1.0                       # z · cb2[0] = z · cb2[1], the max
    if zero_row:
        jidx = dataclasses.replace(jidx, counts=jidx.counts.at[1].set(0))
    tidx = index_from_numpy({"kind": kind, **{f: np.asarray(getattr(jidx, f))
                                              for f in FIELDS}},
                            device="cpu")
    if fmt == "fp32":
        jcb = (jidx.codebook1, None, jidx.codebook2, None)
        tcb = (tidx.codebook1, None, tidx.codebook2, None)
    else:
        q1, s1 = jq.quantize_rows(jidx.codebook1, fmt)
        q2, s2 = jq.quantize_rows(jidx.codebook2, fmt)
        jcb = (q1, s1, q2, s2)
        tcb = tuple(tensor_from_numpy(np.asarray(x), "cpu")
                    for x in (q1, s1, q2, s2))
    return jidx, tidx, z, jcb, tcb


def _cotangents(which, seed=1):
    rng = np.random.default_rng(seed)
    cot = [rng.standard_normal((T, K)).astype(np.float32) for _ in range(3)]
    cot.append(rng.standard_normal((T,)).astype(np.float32))
    if which != "all":
        keep = COTS.index(which) - 1
        cot = [c if i == keep else np.zeros_like(c)
               for i, c in enumerate(cot)]
    return cot


def _oracle_vjp(jidx, z, jcb, cot, with_cb: bool):
    """jax.vjp of the reference's oracle: dz, and in fp32 with_cb dcb1 and
    dcb2."""
    cb1, sc1, cb2, sc2 = jcb
    counts = jidx.counts.astype(jnp.float32)
    kw = {} if sc1 is None else {"scale1": sc1, "scale2": sc2}

    def f(zz, c1, c2):
        return jref(zz, c1, c2, counts, split=jidx.kind == "pq", **kw)

    if with_cb:
        _, vjp = jax.vjp(f, jnp.asarray(z), cb1, cb2)
    else:
        _, vjp = jax.vjp(lambda zz: f(zz, cb1, cb2), jnp.asarray(z))
    return [np.asarray(g) for g in vjp(tuple(jnp.asarray(c) for c in cot))]


def _kernel_vjp(jidx, z, jcb, cot, with_cb: bool):
    """The gradients of the reference's kernel-backed tables (Pallas in
    interpret mode, its custom VJP)."""
    cb1, sc1, cb2, sc2 = jcb
    cot = tuple(jnp.asarray(c) for c in cot)
    if sc1 is not None:
        def f(zz):
            return jtables_q(jidx, cb1, sc1, cb2, sc2, zz, block_t=8,
                             interpret=True)
        _, vjp = jax.vjp(f, jnp.asarray(z))
    elif with_cb:
        def f(zz, c1, c2):
            idx = dataclasses.replace(jidx, codebook1=c1, codebook2=c2)
            return jtables(idx, zz, block_t=8, interpret=True)
        _, vjp = jax.vjp(f, jnp.asarray(z), cb1, cb2)
    else:
        def f(zz):
            return jtables(jidx, zz, block_t=8, interpret=True)
        _, vjp = jax.vjp(f, jnp.asarray(z))
    return [np.asarray(g) for g in vjp(cot)]


def _plain(tidx, z, tcb, cot, with_cb: bool):
    """The port's closed form from its forward's outputs: dz, and with_cb
    dcb = dsᵀ·z."""
    cb1, sc1, cb2, sc2 = tcb
    split = tidx.kind == "pq"
    kw = {} if sc1 is None else {"scale1": sc1.reshape(-1),
                                 "scale2": sc2.reshape(-1)}
    zt = torch.from_numpy(z)
    counts = tidx.counts.float()
    out = midx_probs_ref(zt, cb1, cb2, counts, split=split, **kw)
    dz, ds1, ds2 = midx_probs_bwd_ref(
        *out, *(torch.from_numpy(c) for c in cot), cb1, cb2, counts,
        split=split, with_ds=with_cb, **kw)
    if not with_cb:
        return [dz]
    z1, z2 = (zt[:, :D // 2], zt[:, D // 2:]) if split else (zt, zt)
    return [dz, ds1.T @ z1, ds2.T @ z2]


def _wrapper(tidx, z, tcb, cot, with_cb: bool):
    """The gradients of the port's autograd wrapper on CPU tensors."""
    cb1, sc1, cb2, sc2 = tcb
    zt = torch.from_numpy(z).requires_grad_(True)
    if sc1 is not None:
        outs = proposal_tables_q(tidx, cb1, sc1, cb2, sc2, zt)
        leaves = [zt]
    else:
        c1 = cb1.clone().requires_grad_(with_cb)
        c2 = cb2.clone().requires_grad_(with_cb)
        outs = proposal_tables(dataclasses.replace(tidx, codebook1=c1,
                                                   codebook2=c2), zt)
        leaves = [zt, c1, c2] if with_cb else [zt]
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cot])
    return [x.grad.numpy() for x in leaves]


def _hold(label, got, want):
    for name, a, b in zip(("dz", "dcb1", "dcb2"), got, want):
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        assert np.isfinite(a).all(), f"{label} {name}: not finite"
        np.testing.assert_allclose(a, np.asarray(b).reshape(a.shape),
                                   atol=TOL, rtol=TOL,
                                   err_msg=f"{label} {name}")


@pytest.mark.parametrize("cot", COTS)
@pytest.mark.parametrize("fmt", ["fp32", "int8", "fp8"])
@pytest.mark.parametrize("kind", ["pq", "rq"])
def test_closed_form_matches_the_reference_vjp(kind, fmt, cot):
    """The plain closed form and the wrapper against jax.vjp of the
    reference's oracle and against its kernel-backed tables' own VJP:
    dz, and in fp32 also with d(codebooks)."""
    jidx, tidx, z, jcb, tcb = _case(kind, fmt)
    cots = _cotangents(cot)
    for with_cb in ((False, True) if fmt == "fp32" else (False,)):
        oracle = _oracle_vjp(jidx, z, jcb, cots, with_cb)
        kernel = _kernel_vjp(jidx, z, jcb, cots, with_cb)
        tag = f"{kind} {fmt} {cot} with_cb={with_cb}"
        for label, got in (("plain", _plain(tidx, z, tcb, cots, with_cb)),
                           ("wrapper", _wrapper(tidx, z, tcb, cots,
                                                with_cb))):
            _hold(f"{label} vs oracle, {tag}", got, oracle)
            _hold(f"{label} vs kernel VJP, {tag}", got, kernel)


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("fmt", ["fp32", "int8", "fp8"])
@pytest.mark.parametrize("kind", ["pq", "rq"])
def test_zeroed_counts_row_gives_the_reference_gradient(kind, fmt, tie):
    """A row of counts zeroed floors its psi at 1e-30: the gradients stay
    finite and equal the reference's, the floored row's log_psi
    cotangent reaching s2's maximum through the shift (split between two
    tied codewords where tie)."""
    jidx, tidx, z, jcb, tcb = _case(kind, fmt, zero_row=True, tie=tie)
    if tie:
        s2 = np.asarray(jref(jnp.asarray(z), *jcb[::2],
                             jidx.counts.astype(jnp.float32),
                             split=kind == "pq",
                             **({} if jcb[1] is None else
                                {"scale1": jcb[1], "scale2": jcb[3]}))[1])
        assert (s2[:, 0] == s2[:, 1]).all() and (s2.argmax(1) == 0).all()
    cots = _cotangents("all", seed=5)
    with_cb = fmt == "fp32"
    oracle = _oracle_vjp(jidx, z, jcb, cots, with_cb)
    kernel = _kernel_vjp(jidx, z, jcb, cots, with_cb)
    for label, got in (("plain", _plain(tidx, z, tcb, cots, with_cb)),
                       ("wrapper", _wrapper(tidx, z, tcb, cots, with_cb))):
        _hold(f"{label} vs oracle", got, oracle)
        _hold(f"{label} vs kernel VJP", got, kernel)


@pytest.mark.parametrize("fmt", ["fp32", "int8"])
def test_backward_recomputes_nothing(monkeypatch, fmt):
    """The wrappers' backward runs `dispatch.midx_probs_bwd` once, from
    the forward's saved outputs: neither the plain forward nor
    torch.autograd.grad runs in it."""
    _, tidx, z, _, tcb = _case("rq", fmt)
    cb1, sc1, cb2, sc2 = tcb
    zt = torch.from_numpy(z).requires_grad_(True)
    outs = (proposal_tables(tidx, zt) if sc1 is None else
            proposal_tables_q(tidx, cb1, sc1, cb2, sc2, zt))
    calls = []
    bwd = dispatch.midx_probs_bwd

    def counted(*a, **kw):
        calls.append(bool(kw.get("with_ds")))
        return bwd(*a, **kw)

    def refuse(*a, **kw):
        raise AssertionError("the backward recomputed through autograd or "
                             "the plain forward")

    monkeypatch.setattr(dispatch, "midx_probs_bwd", counted)
    monkeypatch.setattr(dispatch, "midx_probs_ref", refuse)
    monkeypatch.setattr(torch.autograd, "grad", refuse)
    lse = outs[3]
    lse.sum().backward()
    assert calls == [False] and zt.grad is not None
    assert torch.isfinite(zt.grad).all()


def test_empty_rows_and_other_devices():
    """T = 0 gives empty gradients; a meta tensor outside the dry run's
    scope has no implementation."""
    _, tidx, _, _, _ = _case("rq", "fp32")
    zt = torch.zeros((0, D), requires_grad=True)
    outs = proposal_tables(tidx, zt)
    torch.autograd.backward(outs, [torch.zeros_like(x) for x in outs])
    assert zt.grad.shape == (0, D)
    meta = [torch.empty((2, K), device="meta") for _ in range(6)]
    with pytest.raises(RuntimeError, match="no implementation"):
        dispatch.midx_probs_bwd(
            *meta[:3], torch.empty(2, device="meta"), *meta[3:],
            torch.empty(2, device="meta"), tidx.codebook1, tidx.codebook2,
            tidx.counts.float(), split=False)
