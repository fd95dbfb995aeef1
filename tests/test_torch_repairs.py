"""Two repairs of the port against the JAX package on the CPU.

1. `loss_midx` with `mask_collisions=False` takes the plain lane, as the
   reference does (`kernels/dispatch.py:55-56`, `models/heads.py:214-215`):
   the loss and every gradient within 1e-5 (atol and rtol, the bar of
   `tests/test_fused_head.py`) of the reference's `loss_midx(fused=False)`
   given the same negatives, for the per-token and pooled proposals, on
   labels chosen to collide with drawn negatives.
2. `ZipfLM.sample` (one CDF per cluster, built once) equals the reference's
   draw bit for bit, with and without an explicit seed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.core import midx as jmidx
from repro.data import ZipfLM as JZipfLM
from repro.models import heads as jheads
from repro.models.model import forward as jforward
from repro.models.model import init_params as jinit
from repro_torch import configs as tcfg
from repro_torch.bridge import (index_from_numpy, params_from_numpy,
                                params_to_numpy)
from repro_torch.core import midx, noise
from repro_torch.data import ZipfLM
from repro_torch.kernels.midx_probs.ops import proposal_tables
from repro_torch.models import heads
from repro_torch.models.model import forward as tforward
from repro_torch.optim.optimizers import tree_leaves, tree_map

TOL = 1e-5
B, S = 2, 8
FIELDS = ("kind", "codebook1", "codebook2", "assign1", "assign2",
          "residuals", "sorted_ids", "offsets", "counts", "log_counts")


def _setup(proposal, mask_collisions, seed=0):
    cfgs = [dataclasses.replace(mod.get_config("paper-lm").reduced(),
                                dtype="float32")
            .with_head(proposal=proposal, mask_collisions=mask_collisions)
            for mod in (jcfg, tcfg)]
    jc, tc = cfgs
    jp = jinit(jc, jax.random.PRNGKey(seed))
    tp = params_from_numpy(tc, jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    jidx = jheads.init_head_state(jc, jp, jax.random.PRNGKey(seed + 1))
    tidx = index_from_numpy(
        {f: (getattr(jidx, f) if f == "kind" else np.asarray(getattr(jidx, f)))
         for f in FIELDS}, device="cpu")
    toks = np.random.default_rng(seed).integers(0, jc.vocab_size, (B, S)) \
        .astype(np.int32)
    return jc, tc, jp, tp, jidx, tidx, toks


def _port(tc, tp, tidx, toks, labels, keys):
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), tp)
    hidden = tforward(tc, leaves, torch.from_numpy(toks).long())["hidden"]
    loss = heads.loss_midx(tc, leaves, tidx, hidden,
                           torch.from_numpy(labels).long(), keys)
    got = iter(torch.autograd.grad(loss, tree_leaves(leaves)))
    return loss.detach(), params_to_numpy(tc, tree_map(lambda _: next(got),
                                                       leaves))


@pytest.mark.parametrize("proposal", ["per_token", "pooled"])
def test_loss_midx_without_collision_masking_matches_the_jax_plain_lane(
        monkeypatch, proposal):
    jc, tc, jp, tp, jidx, tidx, toks = _setup(proposal, False)
    m = tc.head.num_negatives
    keys = noise.train_keys(0, 3, B * S)
    h = tforward(tc, tp, torch.from_numpy(toks).long())["hidden"].float()
    if proposal == "per_token":
        draw = midx.sample_twostage(tidx, h.reshape(B * S, -1), m, keys,
                                    tables_fn=proposal_tables)
        ids = draw.ids.numpy().reshape(B, S, m)
        labels = ids[:, :, 3].astype(np.int32)       # every token collides
    else:
        draw = midx.sample_pooled(tidx, h, m, noise.sequence_keys(keys, S))
        ids = draw.ids.numpy()
        labels = np.repeat(ids[:, :1], S, axis=1).astype(np.int32)
        labels[:, ::2] = toks[:, ::2]                # half of them collide
    loss, grads = _port(tc, tp, tidx, toks, labels, keys)
    masked, _ = _port(dataclasses.replace(
        tc, head=dataclasses.replace(tc.head, mask_collisions=True)),
        tp, tidx, toks, labels, keys)
    assert abs(float(loss) - float(masked)) > 1e-3   # the flag matters
    jids = jnp.asarray(ids.astype(np.int32))

    if proposal == "per_token":
        def same_draw(index, key, z, m, tables_fn=None):
            return jmidx.Draw(jids, jmidx.log_prob(index, z, jids))
        monkeypatch.setattr(jmidx, "sample_twostage", same_draw)
    else:
        kk = jidx.codebook1.shape[0]
        cluster = jidx.assign1[jids] * kk + jidx.assign2[jids]

        def same_draw(index, key, flat_log, m, member_fn=None):
            lse = jax.nn.logsumexp(flat_log, axis=-1, keepdims=True)
            return jmidx.Draw(jids, jnp.take_along_axis(flat_log, cluster, -1)
                              - index.log_counts.reshape(-1)[cluster] - lse)
        monkeypatch.setattr(jmidx, "_shared_draw", same_draw)

    def jloss(p):
        hh = jforward(jc, p, jnp.asarray(toks))["hidden"]
        return jheads.loss_midx(jc, p, jidx, hh, jnp.asarray(labels),
                                jax.random.PRNGKey(0), fused=False)

    jl, jg = jax.value_and_grad(jloss)(jp)
    np.testing.assert_allclose(float(loss), float(jl), atol=TOL, rtol=TOL)
    b = jax.tree_util.tree_map(np.asarray, jg)
    assert jax.tree_util.tree_structure(grads) == \
        jax.tree_util.tree_structure(b)
    for (path, x), y in zip(jax.tree_util.tree_leaves_with_path(grads),
                            jax.tree_util.tree_leaves(b)):
        np.testing.assert_allclose(x, y, atol=TOL, rtol=TOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("vocab,clusters,seq,num", [(10000, 64, 65, 64),
                                                    (50280, 64, 33, 24)])
@pytest.mark.parametrize("seed", [None, 11])
def test_zipf_sample_is_the_reference_draw_bit_for_bit(vocab, clusters, seq,
                                                       num, seed):
    kw = dict(vocab_size=vocab, num_clusters=clusters, seq_len=seq, seed=2)
    got = ZipfLM(**kw).sample(num, seed=seed)
    want = JZipfLM(**kw).sample(num, seed=seed)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
