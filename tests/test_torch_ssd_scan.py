"""The chunked SSD scan's plain version and its differentiable wrapper
against the JAX package on the CPU. The CUDA kernel is held to the plain
version in `test_torch_cuda.py` and `chip_smoke.py`.

Inputs are made with numpy from a seed, drawn as `tests/test_ssd_kernel.py`
draws them (x, B, C ~ 0.5·N(0, 1); adt = −softplus(N(0, 1)); dt =
softplus(N(0, 1))). Tolerances:
  - y within 1e-5 (atol and rtol) of the Pallas kernel (interpret mode)
    and of its oracle in fp32, and 5e-2 for bf16 inputs: the bars of
    `tests/test_ssd_kernel.py`;
  - h_last, which the JAX package does not return, within
    1e-5·max(1, |ref|) of a per-step float64 numpy recurrence
    h_t = e^{adt_t}·h_{t−1} + dt_t·B_t·x_tᵀ;
  - the gradients of every input within 1e-5 (atol and rtol) of the JAX
    op's (`ssd_scan_op`, whose backward recomputes through its oracle) at
    a chunk where the oracle's gradients are finite, the bar of
    `test_ssd_kernel_grads`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_scan_batched_ref, ssd_scan_op
from repro.kernels.ssd_scan.ssd_scan import ssd_scan
from repro_torch.bridge import tensor_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.kernels.ssd_scan import cuda as ssd_cuda
from repro_torch.kernels.ssd_scan.ops import SsdScanFn, ssd_scan_op as tssd_op
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: when test files run in parallel worker
    processes, torch's thread pools oversubscribe the cores, and the TF32
    emulation test's deep products slow down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-5


def _softplus(x):
    return np.log1p(np.exp(-np.abs(x))) + np.maximum(x, 0)


def _inputs(seed, bt, s, h, p, n):
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((bt, s, h, p))).astype(np.float32)
    bm = (0.5 * rng.standard_normal((bt, s, n))).astype(np.float32)
    cm = (0.5 * rng.standard_normal((bt, s, n))).astype(np.float32)
    adt = (-_softplus(rng.standard_normal((bt, s, h)))).astype(np.float32)
    dt = _softplus(rng.standard_normal((bt, s, h))).astype(np.float32)
    return x, bm, cm, adt, dt


def _recurrence(x, bm, adt, dt):
    """h_last by the per-step recurrence, float64."""
    x, bm, adt, dt = (a.astype(np.float64) for a in (x, bm, adt, dt))
    bt, s, h, p = x.shape
    state = np.zeros((bt, h, bm.shape[-1], p))
    for t in range(s):
        state = (np.exp(adt[:, t])[:, :, None, None] * state
                 + dt[:, t][:, :, None, None] * bm[:, t][:, None, :, None]
                 * x[:, t][:, :, None, :])
    return state


@pytest.mark.parametrize("bt,s,h,p,n,q,dtype", [
    (2, 64, 3, 16, 8, 16, "float32"),      # the JAX test's three shapes
    (1, 128, 2, 32, 16, 32, "float32"),
    (1, 64, 4, 8, 8, 8, "bfloat16"),
    (2, 26, 3, 16, 8, 13, "float32"),      # a ragged chunk
    (1, 48, 2, 16, 8, 48, "float32"),      # one chunk of S
])
def test_plain_version_matches_pallas_kernel_and_oracle(bt, s, h, p, n, q,
                                                        dtype):
    x, bm, cm, adt, dt = _inputs(s + q, bt, s, h, p, n)
    jx, jbm, jcm = (jnp.asarray(a).astype(dtype) for a in (x, bm, cm))
    jadt, jdt = jnp.asarray(adt), jnp.asarray(dt)
    y_k = ssd_scan(jx, jbm, jcm, jadt, jdt, chunk=q, interpret=True)
    y_r = ssd_scan_batched_ref(jx, jbm, jcm, jadt, jdt, chunk=q)
    args = [tensor_from_numpy(np.asarray(a), "cpu")
            for a in (jx, jbm, jcm, jadt, jdt)]
    y, h_last = ssd_scan_ref(*args, chunk=q)
    assert y.dtype == h_last.dtype == torch.float32
    assert tuple(y.shape) == (bt, s, h, p)
    assert tuple(h_last.shape) == (bt, h, n, p)
    tol = 5e-2 if dtype == "bfloat16" else TOL
    for want in (y_k, y_r):
        np.testing.assert_allclose(y.numpy(), np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)
    want_h = _recurrence(*(np.asarray(a, np.float32)
                           for a in (jx, jbm, jadt, jdt)))
    assert np.all(np.abs(h_last.numpy() - want_h)
                  <= TOL * np.maximum(1.0, np.abs(want_h)))


def test_gradients_match_the_jax_op():
    """d(Σ g·y)/d(x, B, C, adt, dt) through SsdScanFn (the CPU forward and
    the recompute backward) against `ssd_scan_op`'s, chunk 8."""
    x, bm, cm, adt, dt = _inputs(3, 2, 32, 3, 8, 8)
    g = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    jg = jax.grad(lambda *a: jnp.sum(ssd_scan_op(*a, 8, True) * g),
                  argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (x, bm, cm, adt, dt)))
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, bm, cm, adt, dt)]
    y, _ = tssd_op(*leaves, 8)
    tg = torch.autograd.grad(y, leaves, torch.from_numpy(g))
    for name, a, b in zip(("x", "bmat", "cmat", "adt", "dt"), tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL,
                                   rtol=TOL, err_msg=name)


@pytest.mark.parametrize("use_h", [True, False])
def test_gradient_for_h_last_or_none(use_h):
    """The backward takes a gradient for h_last (or none when only y is
    used) and gives what autograd through the plain version gives."""
    x, bm, cm, adt, dt = _inputs(5, 1, 24, 2, 8, 8)
    rng = np.random.default_rng(6)
    gy = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    gh = torch.from_numpy(rng.standard_normal((1, 2, 8, 8))
                          .astype(np.float32))
    grads = []
    for fn in (lambda *a: SsdScanFn.apply(*a, 8),
               lambda *a: ssd_scan_ref(*a, chunk=8)):
        leaves = [torch.from_numpy(a).requires_grad_(True)
                  for a in (x, bm, cm, adt, dt)]
        y, h_last = fn(*leaves)
        loss = (y * gy).sum() + ((h_last * gh).sum() if use_h else 0.0)
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_long_chunk_gradients_stay_finite():
    """Masking before the exponential: at a chunk of 64 with steep decays
    (|a·dt| up to ~5 a step) the JAX oracle's gradient in adt is NaN, the
    port's is finite, and both agree with the short-chunk gradient."""
    x, bm, cm, adt, dt = _inputs(7, 1, 64, 2, 8, 8)
    adt = (adt * np.array([1.0, 6.0], np.float32)).astype(np.float32)
    g = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)
    j = [jnp.asarray(a) for a in (x, bm, cm, adt, dt)]

    def jgrad(chunk):
        return jax.grad(lambda a: jnp.sum(ssd_scan_batched_ref(
            j[0], j[1], j[2], a, j[4], chunk=chunk) * g))(j[3])

    assert np.isnan(np.asarray(jgrad(64))).any()
    want = np.asarray(jgrad(8))
    assert np.isfinite(want).all()
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, bm, cm, adt, dt)]
    y, _ = tssd_op(*leaves, 64)
    got = torch.autograd.grad(y, leaves[3], torch.from_numpy(g))[0].numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4 * max(1.0, np.abs(want)
                                                          .max()), rtol=0)


def test_dispatch_by_device():
    """A CPU tensor runs the plain version (the kernel's counter does not
    move); the kernel's wrapper refuses a CPU tensor; another device
    raises."""
    args = [torch.from_numpy(a) for a in _inputs(9, 1, 16, 2, 8, 8)]
    before = ssd_cuda.ssd_scan_cuda.launches
    got = dispatch.ssd_scan(*args, chunk=8)
    want = ssd_scan_ref(*args, chunk=8)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ssd_cuda.ssd_scan_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA device"):
        ssd_cuda.ssd_scan_cuda(*args, chunk=8)
    with pytest.raises(RuntimeError, match="no implementation for meta"):
        dispatch.ssd_scan(*(a.to("meta") for a in args), chunk=8)
    with pytest.raises(ValueError, match="S % chunk"):
        ssd_scan_ref(*args, chunk=5)


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


def _emulated(einsum, model: str):
    """einsum over TF32 operands, for the plain version's products, each of
    which reduces over one index. "one": one product of the roundings,
    exact. The rest are 3xTF32, small·big + big·small + big·big with the
    small parts the TF32 parts of the remainders, as the kernels' `split`
    and the tensor core form them, and differ in how the sums are kept:
    "exact" sums them in fp64 and rounds once; "truncating" adds each
    mma's 8-deep sum into an fp32 accumulator rounded toward zero, as the
    tensor core does, over the whole depth; "slabs" does that within each
    32-deep slab, from zero, and adds the slabs into an fp32 sum rounded to
    nearest, as `kernels/common/tf32x3.cuh::product` does."""
    def product(eq, a, b):
        ab, bb = _tf32(a), _tf32(b)
        if model == "one":
            return einsum(eq, ab.double(), bb.double()).float()
        pairs = [(_tf32(a - ab, False), bb), (ab, _tf32(b - bb, False)),
                 (ab, bb)]
        if model == "exact":
            return sum(einsum(eq, u.double(), v.double())
                       for u, v in pairs).float()
        ins, out = eq.split("->")
        ia, ib = ins.split(",")
        (kl,) = set(ia) & set(ib) - set(out)
        da, db, k = ia.index(kl), ib.index(kl), a.shape[ia.index(kl)]
        slab = 32 if model == "slabs" else k
        acc = 0.0
        for kb in range(0, k, slab):
            part = 0.0
            for k0 in range(kb, min(kb + slab, k), 8):
                w = min(8, k - k0)
                for u, v in pairs:
                    part = _rz(part + einsum(eq, u.narrow(da, k0, w).double(),
                                             v.narrow(db, k0, w).double()))
            acc = acc + part
        return acc
    return product


@pytest.mark.parametrize("steep", [False, True])
def test_tf32x3_products_meet_the_hold(monkeypatch, steep):
    """The precision design of the CUDA kernels, on the CPU: the plain
    version with its four products (C·Bᵀ, (CB ⊙ L)·(dt x), Bᵀ·w, C·h) on
    TF32 operands, against the plain fp32 version, under the kernels' hold
    1e-4·max(1, |plain|). One TF32 product misses it (y by 36-50x,
    h_last by ~7x); 3xTF32 summed exactly meets it with a margin of 5x or
    more (0.02-0.03 of it). The tensor core truncates as it accumulates;
    at the scan's depths (N=128, Q=256: at most 96 mma a sum) that keeps
    inside the margin (~0.1 of the hold) with or without the 32-deep slabs
    the kernels sum into fp32 (~0.05 with them)."""
    x, bm, cm, adt, dt = (torch.from_numpy(a) for a in
                          _inputs(11, 1, 512, 2, 64, 128))
    if steep:
        adt = adt - 20.0
    want = ssd_scan_ref(x, bm, cm, adt, dt, chunk=256)
    einsum = torch.einsum
    ratios = {}
    for model in ("one", "exact", "truncating", "slabs"):
        monkeypatch.setattr(torch, "einsum", _emulated(einsum, model))
        got = ssd_scan_ref(x, bm, cm, adt, dt, chunk=256)
        monkeypatch.setattr(torch, "einsum", einsum)
        ratios[model] = [float(((a - b).abs() / b.abs().clamp(min=1)).max()
                               / 1e-4) for a, b in zip(got, want)]
    one = ratios.pop("one")
    assert one[0] > 10.0 and one[1] > 2.0, one   # one TF32 product misses
    for model, r in ratios.items():              # 3xTF32: 5x inside it
        assert max(r) < 0.2, (model, r)
