"""midx_probs: the port's plain version and differentiable wrapper against
the JAX package's Pallas kernel (interpret mode) and its jnp oracle, and a
model of the CUDA kernel's order of sums (fixed slices of the products'
depth). The CUDA kernel is held to the plain version in
`test_torch_cuda.py`."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build as jbuild
from repro.kernels.midx_probs.ops import proposal_tables as jproposal_tables
from repro.kernels.midx_probs.ref import midx_probs_ref as jref
from repro_torch.bridge import index_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.kernels.midx_probs.ops import proposal_tables
from repro_torch.kernels.midx_probs.ref import midx_probs_ref

FIELDS = ("kind", "codebook1", "codebook2", "assign1", "assign2",
          "residuals", "sorted_ids", "offsets", "counts", "log_counts")
TOL = 1e-5


def numpy_index(idx):
    return {f: (getattr(idx, f) if f == "kind" else np.asarray(getattr(idx, f)))
            for f in FIELDS}


@functools.lru_cache(maxsize=None)
def _case(kind, d, k, seed):
    rng = np.random.default_rng(seed)
    emb = (0.5 * rng.standard_normal((400, d))).astype(np.float32)
    jidx = jbuild(jax.random.PRNGKey(seed), jnp.asarray(emb), kind=kind, k=k,
                  iters=3)
    return jidx, index_from_numpy(numpy_index(jidx), device="cpu")


@pytest.mark.parametrize("t", [1, 7, 130])
@pytest.mark.parametrize("d,k", [(16, 8), (200, 32)])
@pytest.mark.parametrize("kind", ["pq", "rq"])
def test_tables_match_jax_kernel_and_oracle(kind, d, k, t):
    jidx, tidx = _case(kind, d, k, seed=d + k)
    z = np.random.default_rng(t).standard_normal((t, d)).astype(np.float32)
    ker = jproposal_tables(jidx, jnp.asarray(z), use_kernel=True,
                           block_t=128, interpret=True)
    orc = jref(jnp.asarray(z), jidx.codebook1, jidx.codebook2,
               jidx.counts.astype(jnp.float32), split=kind == "pq")
    port = proposal_tables(tidx, torch.from_numpy(z))
    for name, a, b, c in zip(("s1", "s2", "log_psi", "lse"), port, ker, orc):
        a = a.numpy()
        np.testing.assert_allclose(a, np.asarray(b).reshape(a.shape),
                                   atol=TOL, rtol=TOL, err_msg=f"kernel {name}")
        np.testing.assert_allclose(a, np.asarray(c).reshape(a.shape),
                                   atol=TOL, rtol=TOL, err_msg=f"oracle {name}")


@pytest.mark.parametrize("kind", ["pq", "rq"])
def test_wrapper_gradient_matches_jax_vjp(kind):
    d, k, t = 24, 8, 5
    jidx, tidx = _case(kind, d, k, seed=3)
    rng = np.random.default_rng(4)
    z = rng.standard_normal((t, d)).astype(np.float32)
    cot = [rng.standard_normal((t, k)).astype(np.float32) for _ in range(3)]
    cot.append(rng.standard_normal((t,)).astype(np.float32))

    def jfn(zz, c1, c2):
        return jref(zz, c1, c2, jidx.counts.astype(jnp.float32),
                    split=kind == "pq")

    _, vjp = jax.vjp(jfn, jnp.asarray(z), jidx.codebook1, jidx.codebook2)
    jdz, jdc1, jdc2 = vjp(tuple(jnp.asarray(c) for c in cot))

    zt = torch.from_numpy(z).requires_grad_(True)
    cb1 = tidx.codebook1.clone().requires_grad_(True)
    cb2 = tidx.codebook2.clone().requires_grad_(True)
    outs = proposal_tables(dataclasses.replace(tidx, codebook1=cb1,
                                               codebook2=cb2), zt)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cot])
    for name, a, b in (("dz", zt.grad, jdz), ("dcb1", cb1.grad, jdc1),
                       ("dcb2", cb2.grad, jdc2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL,
                                   rtol=1e-4, err_msg=name)


def test_dispatch_takes_the_plain_version_for_cpu_tensors():
    rng = np.random.default_rng(0)
    z = torch.from_numpy(rng.standard_normal((3, 8)).astype(np.float32))
    cb = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    cnt = torch.ones((4, 4))
    got = dispatch.midx_probs(z, cb, cb, cnt, split=False)
    want = midx_probs_ref(z, cb, cb, cnt, split=False)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError, match="no implementation"):
        dispatch.midx_probs(z.to("meta"), cb, cb, cnt, split=False)


SLICE = 64      # columns of a slice of the CUDA kernel's products (its DS)


def _sliced(z, cb1, cb2, counts, split):
    """The CUDA kernel's order of sums on the CPU, by elementwise ops only
    (so each row's bits are its own, whatever T): per slice of 64 columns
    of the codeword width (ceil(Dc / 64) of them, whatever T), each (row,
    codeword) dot in ascending d; the slices summed in ascending order;
    then ψ as a K-long chain per k1 and the max-shifted logsumexp, each in
    ascending k."""
    dc = cb1.shape[1]
    z1, z2 = (z[:, :dc], z[:, dc:]) if split else (z, z)
    s1 = torch.zeros((z.shape[0], cb1.shape[0]))
    s2 = torch.zeros_like(s1)
    for j in range(-(-dc // SLICE)):
        p1, p2 = torch.zeros_like(s1), torch.zeros_like(s2)
        for c in range(j * SLICE, min(dc, (j + 1) * SLICE)):
            p1 = p1 + z1[:, c:c + 1] * cb1[None, :, c]
            p2 = p2 + z2[:, c:c + 1] * cb2[None, :, c]
        s1, s2 = s1 + p1, s2 + p2
    c2 = s2.amax(dim=-1, keepdim=True)
    e2 = torch.exp(s2 - c2)
    psi = torch.zeros_like(s1)
    for k2 in range(counts.shape[1]):
        psi = psi + e2[:, k2:k2 + 1] * counts[None, :, k2]
    lpsi = torch.log(torch.clamp(psi, min=1e-30)) + c2
    l1 = s1 + lpsi
    m = l1.amax(dim=-1)
    acc = torch.zeros_like(m)
    for k in range(l1.shape[1]):
        acc = acc + torch.exp(l1[:, k] - m)
    return s1, s2, lpsi, torch.log(acc) + m


@pytest.mark.parametrize("d,k", [(16, 8), (200, 32)])
@pytest.mark.parametrize("kind", ["pq", "rq"])
def test_sliced_order_matches_jax_kernel_and_is_bitwise_free_of_t(kind, d,
                                                                   k):
    """The kernel's slices over D and their fixed order of sums give the
    JAX kernel's tables within 1e-5, and a row the same bits whether it is
    computed alone (T = 1) or among T = 4 or 33 rows."""
    jidx, tidx = _case(kind, d, k, seed=d + k)
    z = np.random.default_rng(9).standard_normal((33, d)).astype(np.float32)
    tables = (tidx.codebook1, tidx.codebook2, tidx.counts.float())
    got = _sliced(torch.from_numpy(z), *tables, split=kind == "pq")
    ker = jproposal_tables(jidx, jnp.asarray(z), use_kernel=True,
                           block_t=128, interpret=True)
    for name, a, b in zip(("s1", "s2", "log_psi", "lse"), got, ker):
        np.testing.assert_allclose(a.numpy(), np.asarray(b).reshape(a.shape),
                                   atol=TOL, rtol=TOL, err_msg=name)
    for r in (0, 3, 32):
        solo = _sliced(torch.from_numpy(z[r:r + 1]), *tables,
                       split=kind == "pq")
        for t in (4, 33):
            if r >= t:
                continue
            some = _sliced(torch.from_numpy(z[:t]), *tables,
                           split=kind == "pq")
            for a, b in zip(solo, some):
                assert torch.equal(a[0], b[r])
