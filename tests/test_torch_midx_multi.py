"""The port's B > 2 codebook MIDX (`core/midx_multi.py`) on the CPU: the
five cases of `tests/test_midx_multi.py` on the port's own indexes
(distribution, residual identity, sample consistency, more books give a
lower KL, B = 2 is the RQ MIDX proposal), its draws by distribution and
independent of the batch, and `log_prob` / `kl_to_softmax` element-wise
against the reference's on a `MultiIndexB` carried over by the bridge
(1e-5, the fp32 bar of `tests/test_fused_head.py`)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import midx_multi as jmm
from repro_torch.bridge import proposal_state_from_numpy, to_reference
from repro_torch.checkpoint.manager import _treedef_str
from repro_torch.core import midx, midx_multi as mm, noise
from repro_torch.index.build import from_quantization
from repro_torch.index.quantization import Quantization

N, D = 300, 32
TOL = 1e-5


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
    centers = 1.5 * rng.standard_normal((16, D))
    cl = rng.integers(0, 16, N)
    return (centers[cl] + 0.2 * rng.standard_normal((N, D))).astype(
        np.float32)


EMB = torch.from_numpy(_emb())


def _z(rows, seed=2):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (rows, D)).astype(np.float32))


def _build(b, k=8, iters=4, seed=1):
    return mm.build_b(torch.Generator().manual_seed(seed), EMB, b=b, k=k,
                      iters=iters)


def _all(rows):
    return torch.arange(N).expand(rows, N)


def test_proposal_is_distribution():
    idx = _build(3)
    assert (idx.num_books, idx.num_codewords, idx.num_classes) == (3, 8, N)
    total = torch.exp(mm.log_prob(idx, _z(4), _all(4))).sum(-1)
    np.testing.assert_allclose(total.numpy(), 1.0, atol=1e-3)


def test_closed_form_matches_residual_identity():
    """Q(i|z) ∝ exp(o_i − õ_i) with õ the B-level residual score."""
    idx = _build(3)
    z = _z(3)
    ref = torch.log_softmax(z @ EMB.T - z @ idx.residuals.T, dim=-1)
    np.testing.assert_allclose(mm.log_prob(idx, z, _all(3)).numpy(),
                               ref.numpy(), atol=1e-3)


def test_sample_consistency():
    idx = _build(4)
    z = _z(3)
    d = mm.sample(idx, torch.tensor([5, 6, 7]), z, 32)
    assert d.ids.shape == (3, 32) and d.ids.dtype == torch.int64
    np.testing.assert_allclose(mm.log_prob(idx, z, d.ids).numpy(),
                               d.log_q.numpy(), atol=1e-4)


def test_more_books_tighter_kl():
    """Deeper residual quantization: smaller distortion, smaller KL(Q‖P)
    (the Theorem-5 mechanism); B = 4 beats B = 2 at the same K."""
    z = _z(8)
    kls = {b: float(torch.mean(mm.kl_to_softmax(_build(b, iters=6), z, EMB)))
           for b in (1, 2, 4)}
    assert kls[4] <= kls[2] <= kls[1] * 1.05, kls


def test_b2_matches_rq_midx():
    """B = 2 is the standard RQ MIDX proposal: the closed form with its own
    residuals, and `core.midx.log_prob` over an RQ MultiIndex of the same
    codebooks and assignments."""
    idx = _build(2, iters=5, seed=7)
    z = _z(2)
    lq = mm.log_prob(idx, z, _all(2))
    ref = torch.log_softmax(z @ EMB.T - z @ idx.residuals.T, dim=-1)
    np.testing.assert_allclose(lq.numpy(), ref.numpy(), atol=1e-3)
    rq = from_quantization(Quantization("rq", *idx.codebooks, *idx.assigns,
                                        idx.residuals))
    np.testing.assert_allclose(lq.numpy(), midx.log_prob(rq, z, _all(2))
                               .numpy(), atol=TOL, rtol=TOL)


def test_levels_draw_from_their_own_streams():
    """One generator stream a level: a build repeats from its seed, and
    another seed fits other codebooks."""
    a, b, c = _build(3, seed=4), _build(3, seed=4), _build(3, seed=5)
    for x, y in zip(a.codebooks + a.assigns, b.codebooks + b.assigns):
        assert torch.equal(x, y)
    assert not torch.equal(a.codebooks[0], c.codebooks[0])


def test_draw_frequencies_follow_the_proposal_and_ignore_the_batch():
    idx = _build(4)
    z = 0.3 * _z(1, seed=9)
    n = 1 << 16
    d = mm.sample(idx, torch.tensor([4242]), z, n)
    q = torch.exp(mm.log_prob(idx, z, _all(1)))[0].double().numpy()
    freq = np.bincount(d.ids[0].numpy(), minlength=N) / n
    assert np.all(np.abs(freq - q) <= 6 * np.sqrt(q * (1 - q) / n) + 1e-4)
    keys = noise.row_keys(0, torch.arange(3), torch.tensor([2, 7, 1]))
    zb = _z(3, seed=3)
    batched = mm.sample(idx, keys, zb, 16)
    other = _z(3, seed=4)
    other[1] = zb[1]
    okeys = keys.clone()
    okeys[0], okeys[2] = 99, 98
    assert torch.equal(mm.sample(idx, okeys, other, 16).ids[1],
                       batched.ids[1])


@pytest.mark.parametrize("b", [2, 4])
def test_log_prob_and_kl_match_the_reference_on_a_carried_index(b):
    jidx = jmm.build_b(jax.random.PRNGKey(3), jnp.asarray(EMB.numpy()), b=b,
                       k=8, iters=4)
    idx = proposal_state_from_numpy(jax.tree_util.tree_map(np.asarray, jidx),
                                    device="cpu")
    assert isinstance(idx, mm.MultiIndexB) and idx.num_books == b
    assert _treedef_str(to_reference(idx)) == \
        str(jax.tree_util.tree_structure(jidx))
    z = np.random.default_rng(5).standard_normal((3, D)).astype(np.float32)
    ids = np.random.default_rng(6).integers(0, N, (3, 40))
    tz = torch.from_numpy(z)
    np.testing.assert_allclose(
        mm.log_prob(idx, tz, torch.from_numpy(ids)).numpy(),
        np.asarray(jmm.log_prob(jidx, jnp.asarray(z), jnp.asarray(ids))),
        atol=TOL, rtol=TOL)
    np.testing.assert_allclose(
        mm.kl_to_softmax(idx, tz, EMB).numpy(),
        np.asarray(jmm.kl_to_softmax(jidx, jnp.asarray(z),
                                     jnp.asarray(EMB.numpy()))),
        atol=TOL, rtol=TOL)
    np.testing.assert_allclose(
        mm.scores(idx, tz).numpy(),
        np.asarray(jmm.scores(jidx, jnp.asarray(z))), atol=TOL, rtol=TOL)
