"""Index build: the port's K-means, quantizers and CSR layout against the
JAX package's, from the same data and the same init centroids."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.index.build import build as jbuild
from repro.index.kmeans import kmeans as jkmeans
from repro.index.quantization import assign_against as jassign_against
from repro.index.quantization import query_scores as jquery_scores
from repro_torch.index.build import build, _csr_from_assignments
from repro_torch.index.kmeans import kmeans
from repro_torch.index.quantization import assign_against, query_scores

K = 8


def _clustered(kind: str, seed: int):
    """Classes built as well-separated codeword sums (RQ) or concatenations
    (PQ), so no cluster goes empty and no assignment sits near a tie; the
    init centroids are the generating codewords, slightly moved."""
    rng = np.random.default_rng(seed)
    d, n = 16, 300
    half = d // 2 if kind == "pq" else d
    c1 = 4.0 * rng.standard_normal((K, half))
    c2 = 1.0 * rng.standard_normal((K, half))
    a1 = rng.integers(0, K, n)
    a2 = rng.integers(0, K, n)
    a1[:K], a2[:K] = np.arange(K), np.arange(K)
    if kind == "pq":
        x = np.concatenate([c1[a1], c2[a2]], axis=1)
    else:
        x = c1[a1] + c2[a2]
    x = x + 0.05 * rng.standard_normal(x.shape)
    init = (c1 + 0.01 * rng.standard_normal(c1.shape),
            c2 + 0.01 * rng.standard_normal(c2.shape))
    return (x.astype(np.float32), init[0].astype(np.float32),
            init[1].astype(np.float32))


def test_kmeans_from_same_init_matches():
    x, init, _ = _clustered("rq", seed=0)
    j = jkmeans(jax.random.PRNGKey(0), jnp.asarray(x), K, 5,
                init=jnp.asarray(init))
    t = kmeans(torch.Generator().manual_seed(0), torch.from_numpy(x), K, 5,
               init=torch.from_numpy(init))
    np.testing.assert_array_equal(t.assignments.numpy(),
                                  np.asarray(j.assignments))
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(t.distortion), float(j.distortion),
                               rtol=1e-5)


@pytest.mark.parametrize("kind", ["pq", "rq"])
def test_build_from_same_init_matches(kind):
    x, i1, i2 = _clustered(kind, seed=1)
    j = jbuild(jax.random.PRNGKey(1), jnp.asarray(x), kind=kind, k=K,
               iters=4, init=(jnp.asarray(i1), jnp.asarray(i2)))
    t = build(torch.Generator().manual_seed(1), torch.from_numpy(x),
              kind=kind, k=K, iters=4,
              init=(torch.from_numpy(i1), torch.from_numpy(i2)))
    for name in ("assign1", "assign2", "sorted_ids", "offsets", "counts"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)
    # log|Ω|: the same -inf pattern; finite values to an ulp (XLA's float32
    # log and torch's round differently in the last bit)
    np.testing.assert_allclose(t.log_counts.numpy(), np.asarray(j.log_counts),
                               rtol=1e-6, atol=0)
    for name in ("codebook1", "codebook2", "residuals"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


def test_csr_is_a_stable_sort_with_empty_clusters():
    rng = np.random.default_rng(2)
    a1 = rng.integers(0, 3, 50)
    a2 = rng.integers(0, 2, 50)          # k2 in {0, 1}: columns 2..3 empty
    from repro.index.build import _csr_from_assignments as jcsr
    jo = jcsr(jnp.asarray(a1), jnp.asarray(a2), 4)
    to = _csr_from_assignments(torch.from_numpy(a1), torch.from_numpy(a2), 4)
    for a, b in zip(to[:3], jo[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(to[3].numpy(), np.asarray(jo[3]), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("kind", ["pq", "rq"])
def test_query_scores_match(kind):
    rng = np.random.default_rng(3)
    d = 32
    dc = d // 2 if kind == "pq" else d
    c1 = rng.standard_normal((K, dc)).astype(np.float32)
    c2 = rng.standard_normal((K, dc)).astype(np.float32)
    z = rng.standard_normal((5, 3, d)).astype(np.float32)
    js = jquery_scores(kind, jnp.asarray(c1), jnp.asarray(c2), jnp.asarray(z))
    ts = query_scores(kind, torch.from_numpy(c1), torch.from_numpy(c2),
                      torch.from_numpy(z))
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("kind", ["pq", "rq"])
def test_assign_against_frozen_codebooks_matches(kind):
    x, c1, c2 = _clustered(kind, seed=5)
    ja = jassign_against(kind, jnp.asarray(c1), jnp.asarray(c2),
                         jnp.asarray(x))
    ta = assign_against(kind, torch.from_numpy(c1), torch.from_numpy(c2),
                        torch.from_numpy(x))
    for a, b in zip(ta, ja):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_cold_build_is_a_valid_index():
    """Without init the port draws its own centroids (torch.Generator):
    the CSR must still partition the classes."""
    x = np.random.default_rng(4).standard_normal((200, 12)).astype(np.float32)
    idx = build(torch.Generator().manual_seed(0), torch.from_numpy(x),
                kind="rq", k=K, iters=3, keep_residuals=False)
    assert idx.residuals.shape == (0, 12)
    assert sorted(idx.sorted_ids.tolist()) == list(range(200))
    assert int(idx.counts.sum()) == 200
    assert int(idx.offsets[-1]) == 200
    joint = idx.joint_cluster()[idx.sorted_ids]
    assert torch.all(joint[1:] >= joint[:-1])
