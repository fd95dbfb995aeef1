"""Two-stage MIDX sampler and counter-based noise: the port against the JAX
package element-wise where the math is deterministic, by distribution where
it draws, and bit for bit on the hash."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build as jbuild
from repro.core import midx as jmidx
from repro.kernels.rff_sample import ref as jnoise
from repro_torch.bridge import index_from_numpy
from repro_torch.core import midx, noise
from repro_torch.models import heads
from repro_torch.configs import get_config

FIELDS = ("kind", "codebook1", "codebook2", "assign1", "assign2",
          "residuals", "sorted_ids", "offsets", "counts", "log_counts")


def _indexes(kind, n=300, d=16, k=8, seed=0):
    rng = np.random.default_rng(seed)
    emb = (0.7 * rng.standard_normal((n, d))).astype(np.float32)
    jidx = jbuild(jax.random.PRNGKey(seed), jnp.asarray(emb), kind=kind, k=k,
                  iters=4)
    fields = {f: (getattr(jidx, f) if f == "kind"
                  else np.asarray(getattr(jidx, f))) for f in FIELDS}
    return emb, jidx, index_from_numpy(fields, device="cpu")


@pytest.mark.parametrize("kind", ["pq", "rq"])
def test_twostage_tables_match(kind):
    _, jidx, tidx = _indexes(kind)
    z = np.random.default_rng(1).standard_normal((6, 16)).astype(np.float32)
    jt = jmidx.twostage_tables(jidx, jnp.asarray(z))
    tt = midx.twostage_tables(tidx, torch.from_numpy(z))
    for name, a, b in zip(("s1", "s2", "log_psi", "lse"), tt, jt):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("kind", ["pq", "rq"])
def test_log_q_of_jax_draws_matches(kind):
    _, jidx, tidx = _indexes(kind, seed=2)
    z = np.random.default_rng(3).standard_normal((5, 16)).astype(np.float32)
    draw = jmidx.sample_twostage(jidx, jax.random.PRNGKey(7), jnp.asarray(z),
                                 32)
    ids = torch.from_numpy(np.asarray(draw.ids).astype(np.int64))
    lq = midx.log_prob(tidx, torch.from_numpy(z), ids)
    np.testing.assert_allclose(lq.numpy(), np.asarray(draw.log_q),
                               atol=1e-5, rtol=1e-5)
    # and the port's closed form agrees with the reference's on every class
    all_ids = np.broadcast_to(np.arange(300), (5, 300))
    np.testing.assert_allclose(
        midx.log_prob(tidx, torch.from_numpy(z),
                      torch.from_numpy(all_ids.copy())).numpy(),
        np.asarray(jmidx.log_prob(jidx, jnp.asarray(z),
                                  jnp.asarray(all_ids))),
        atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kind", ["pq", "rq"])
def test_draw_frequencies_follow_the_proposal(kind):
    """20 000 port draws for one query: total variation to exp(log_prob)
    under 0.02 (about 0.013 is the sampling noise at V=20)."""
    _, _, tidx = _indexes(kind, n=20, d=8, k=4, seed=4)
    z = torch.from_numpy(
        np.random.default_rng(5).standard_normal((1, 8)).astype(np.float32))
    m = 20_000
    draw = midx.sample_twostage(tidx, z, m, torch.tensor([12345]))
    freq = np.bincount(draw.ids[0].numpy(), minlength=20) / m
    p = torch.exp(midx.log_prob(tidx, z, torch.arange(20)[None])).numpy()[0]
    assert abs(p.sum() - 1.0) < 1e-5
    tv = 0.5 * np.abs(freq - p).sum()
    assert tv < 0.02, tv
    # each draw's log_q is the closed form at its id
    np.testing.assert_allclose(
        draw.log_q.numpy(),
        midx.log_prob(tidx, z, draw.ids).numpy(), atol=1e-5)


def test_noise_matches_the_reference_hash():
    rng = np.random.default_rng(6)
    shape = (64, 33)
    seed = np.int32(-123456789)
    t = rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    d = rng.integers(0, 2**20, shape).astype(np.int32)
    n = rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    # the reference's hash bits and uniforms, from its own _mix and constants
    h = jnoise._mix(jnp.int32(seed) ^ (jnp.asarray(t) * jnoise._C_T))
    h = jnoise._mix(h ^ (jnp.asarray(d) * jnoise._C_J))
    h = jnoise._mix(h ^ (jnp.asarray(n) * jnoise._C_N))
    jbits = np.asarray(h).view(np.uint32).astype(np.int64)
    tt, td, tn = (torch.from_numpy(a) for a in (t, d, n))
    bits = noise.hash_bits(int(seed), tt, td, tn)
    np.testing.assert_array_equal(bits.numpy(), jbits)
    u24 = np.asarray(jax.lax.shift_right_logical(h, 8)).astype(np.float32)
    ju = u24 * np.float32(1.0 / (1 << 24)) + np.float32(1.0 / (1 << 25))
    tu = noise.uniform_noise(int(seed), tt, td, tn).numpy()
    np.testing.assert_array_equal(tu.view(np.int32), ju.view(np.int32))
    jg = np.asarray(jnoise.gumbel_noise(jnp.int32(seed), jnp.asarray(t),
                                        jnp.asarray(d), jnp.asarray(n)))
    tg = noise.gumbel_noise(int(seed), tt, td, tn).numpy()
    # the same uniforms through XLA's and torch's float32 log: equal bits, or
    # an ulp apart where the two libraries round the log differently
    np.testing.assert_allclose(tg, jg, rtol=1e-6, atol=1e-6)
    assert np.mean(tg == jg) > 0.5


def test_a_rows_draw_ignores_the_rest_of_the_batch():
    """The engine's guarantee: at a fixed batch shape (max_slots rows), a
    row's draw depends only on its own query and key."""
    _, _, tidx = _indexes("rq", seed=7)
    rng = np.random.default_rng(8)
    z = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
    keys = noise.row_keys(0, torch.tensor([3, 9, 1, 4]),
                          torch.tensor([5, 2, 7, 11]))
    batched = midx.sample_twostage(tidx, z, 16, keys)
    for r in range(4):
        other = torch.from_numpy(
            rng.standard_normal((4, 16)).astype(np.float32))
        other[r] = z[r]
        okeys = noise.row_keys(5, torch.arange(4) + 100, torch.arange(4))
        okeys[r] = keys[r]
        solo = midx.sample_twostage(tidx, other, 16, okeys)
        assert torch.equal(solo.ids[r], batched.ids[r])
        assert torch.equal(solo.log_q[r], batched.log_q[r])


def test_decode_head_row_ignores_the_rest_of_the_batch():
    cfg = get_config("paper-lm").reduced()
    emb, _, tidx = _indexes("rq", n=cfg.padded_vocab, d=cfg.d_model, k=8,
                            seed=9)
    params = {"embed": torch.from_numpy(emb)}
    rng = np.random.default_rng(10)
    h = torch.from_numpy(rng.standard_normal((3, cfg.d_model))
                         .astype(np.float32))
    keys = noise.row_keys(1, torch.tensor([0, 1, 2]), torch.tensor([4, 4, 9]))
    out = heads.midx_decode_head(cfg, params, tidx, h, keys, 8, 1.0)
    for r in range(3):
        other = torch.zeros_like(h)
        other[r] = h[r]
        okeys = torch.zeros_like(keys)
        okeys[r] = keys[r]
        solo = heads.midx_decode_head(cfg, params, tidx, other, okeys, 8, 1.0)
        assert int(solo.token[r]) == int(out.token[r])
        assert float(solo.log_q[r]) == float(out.log_q[r])
    assert torch.all((out.token >= 0) & (out.token < cfg.padded_vocab))
