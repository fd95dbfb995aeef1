"""The vocab-parallel MIDX head of the port (DESIGN §9) on the CPU.

Single process, against the JAX package: the partial modes of the four
sampled-CE ops (the plain versions, which the CPU runs) against the
reference's partial ops in interpret mode, given the same draws, at 1e-5
(partial lse, dh, d(table) / dne, dlq; R = 1, 2 and 4 shards of one table;
owner-masked ids as `loss_midx_vp` builds them, a token with no owned
negative, a colliding positive; int8 / fp8 given the same low-bit rows),
and the shards' partials merged against the full-mode CE; the partial lse
and the merge of `core.sampled_softmax`; the sharding arithmetic,
`shard_index` / `unshard_index` bit for bit against the reference's own on
a reference-built index, and the checkpoint's treedef of the stacked index.

Ranks as gloo CPU processes (`tests/torch_vp_ranks.py`), R = 2 and 4,
spawned once per R for the file: each scenario is held to the port's
replicated path, which the earlier slices hold to the reference — the
draws (ids bitwise, log_q 1e-5), the embedding lookup (1e-6), the loss and
its gradients for the three proposals, unmasked, int8 and fp8 (1e-5), one
train step (loss, grad norm, every updated param 1e-5), the backbone
bitwise equal across ranks, the native index init and refresh, and, at
R = 2, the serving export restored into `Engine` and a 3 + 3 step resume
equal to 6 steps bit for bit; then the training CLI with
`--vocab-parallel 2`. Inputs are made from numpy seeds."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_vp_ranks as ranks
from repro.core import sampled_softmax as jss
from repro.dist import vocab_parallel as jvp
from repro.kernels.sampled_ce import ops as jops
from repro_torch.bridge import (index_from_numpy, sharded_index_to_numpy,
                                tensor_from_numpy, tensor_to_numpy)
from repro_torch.checkpoint.manager import _treedef_str
from repro_torch.core import midx
from repro_torch.core import sampled_softmax as tss
from repro_torch.core.sampled_softmax import NEG_INF
from repro_torch.dist import sharding as shd
from repro_torch.dist import vocab_parallel as vp
from repro_torch.index.quantized import quantize_rows
from repro_torch.kernels.sampled_ce import ops
from repro_torch.launch import steps
from repro_torch.launch.mesh import choose_backend, spawn_ranks
from repro_torch.launch.train import main as train_main
from repro_torch.models import heads
from repro_torch.models.model import class_embeddings
from repro_torch.optim import adamw
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.serve import Engine, Request

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tier-1 run puts test files in parallel
    workers, and torch's thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=tol,
                               err_msg=msg)


# ------------------------------------------------ the partial modes, R shards
T, M, D, V = 12, 10, 16, 64


def _draws(seed=0):
    """Global draws: ids, log q, labels, hidden, table; token 1 collides
    with its positive, token 2 draws only from rows [0, V/4) (no owned
    negative on any other shard when R >= 2)."""
    rng = np.random.default_rng(seed)
    h = (0.3 * rng.standard_normal((T, D))).astype(np.float32)
    table = (0.3 * rng.standard_normal((V, D))).astype(np.float32)
    ids = rng.integers(0, V, (T, M))
    labels = rng.integers(0, V, T)
    ids[1, 3] = labels[1]
    ids[2] = rng.integers(0, V // 4, M)
    lq = (-np.log(V) + 0.1 * rng.standard_normal((T, M))).astype(np.float32)
    return h, table, ids, labels, lq


def _owner_masked(ids, labels, lq, r, rows):
    """As `loss_midx_vp` builds them for shard r: local ids (non-owned
    clipped to row 0 with log q = −NEG_INF) and the local positive or −1."""
    lneg = ids - r * rows
    okn = (lneg >= 0) & (lneg < rows)
    lpos = labels - r * rows
    okp = (lpos >= 0) & (lpos < rows)
    return (np.where(okn, lneg, 0), np.where(okn, lq, -NEG_INF)
            .astype(np.float32), np.where(okp, lpos, -1), okn)


def _pt_port(h, tab, lq, nid, pid, g, qd=None, qs=None):
    hh = torch.from_numpy(h).requires_grad_(True)
    tt = torch.from_numpy(tab).requires_grad_(True)
    ll = torch.from_numpy(lq).requires_grad_(True)
    nid, pid = torch.from_numpy(nid), torch.from_numpy(pid)
    if qd is None:
        lse = ops.sampled_ce_pt_partial_op(hh, tt, ll, nid, pid, M)
    else:
        lse = ops.sampled_ce_pt_q_partial_op(
            hh, tt, tensor_from_numpy(qd, "cpu"), torch.from_numpy(qs), ll,
            nid, pid, M)
    grads = torch.autograd.grad(lse, (hh, tt, ll), torch.from_numpy(g))
    return [lse.detach().numpy()] + [x.numpy() for x in grads]


def _pt_ref(h, tab, lq, nid, pid, g, qd=None, qs=None):
    args = [jnp.asarray(nid, jnp.int32), jnp.asarray(pid, jnp.int32)]
    if qd is None:
        def f(hh, tt, ll):
            return jops.sampled_ce_pt_partial_op(hh, tt, ll, *args, M, True,
                                                 8, 8)
    else:
        def f(hh, tt, ll):
            return jops.sampled_ce_pt_q_partial_op(
                hh, tt, jnp.asarray(qd), jnp.asarray(qs), ll, *args, M, True,
                8, 8)
    lse, vjp = jax.vjp(f, jnp.asarray(h), jnp.asarray(tab), jnp.asarray(lq))
    return [np.asarray(lse)] + [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("fmt", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("r_shards", [1, 2, 4])
def test_per_token_partial_matches_reference(r_shards, fmt):
    """The per-token partial op (plain versions) == the reference's, shard
    by shard; a token with no owned negative gives exactly NEG_INF and
    zero gradients; the shards' partials merged == the full-mode CE."""
    h, table, ids, labels, lq = _draws()
    rows = V // r_shards
    g = np.linspace(0.5, 1.5, T).astype(np.float32)
    partials = []
    for r in range(r_shards):
        tab = table[r * rows:(r + 1) * rows]
        nid, lqm, pid, okn = _owner_masked(ids, labels, lq, r, rows)
        q = ()
        if fmt != "bf16":
            qd, qs = quantize_rows(torch.from_numpy(tab), fmt)
            q = (tensor_to_numpy(qd), qs.numpy())
        got = _pt_port(h, tab, lqm, nid, pid, g, *q)
        want = _pt_ref(h, tab, lqm, nid, pid, g, *q)
        for name, a, b in zip(("lse", "dh", "dtab", "dlq"), got, want):
            _close(a, b, msg=f"shard {r} {name}")
        empty = ~okn.any(1)
        if r > 0:
            assert empty[2]
        assert np.all(got[0][empty] == np.float32(NEG_INF))
        assert not np.any(got[1][empty]) and not np.any(got[3][empty])
        partials.append(got[0])
    if fmt == "bf16":
        full = ops.sampled_ce_pt_op(
            torch.from_numpy(h), torch.from_numpy(table), torch.from_numpy(lq),
            torch.from_numpy(ids), torch.from_numpy(labels))
        pos = torch.from_numpy(np.sum(h * table[labels], -1))
        merged = tss.merge_sampled_softmax_loss(
            pos, torch.from_numpy(np.stack(partials, -1)))
        _close(merged.numpy(), full.numpy())


B, S, MS = 2, 6, 10


def _shared_case(seed=1):
    rng = np.random.default_rng(seed)
    h = (0.3 * rng.standard_normal((B, S, D))).astype(np.float32)
    table = (0.3 * rng.standard_normal((V, D))).astype(np.float32)
    ids = rng.integers(0, V, (B, MS))
    labels = rng.integers(0, V, (B, S))
    labels[0, 2] = ids[0, 4]                       # a colliding positive
    ids[1] = rng.integers(0, V // 4, MS)           # sequence 1: shard 0 only
    lq = (-np.log(V) + 0.1 * rng.standard_normal((B, MS))).astype(np.float32)
    return h, table, ids, labels, lq


@pytest.mark.parametrize("fmt", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("r_shards", [1, 2, 4])
def test_shared_partial_matches_reference(r_shards, fmt):
    """The shared-negative partial op (plain versions) == the reference's
    (vmapped over sequences, zero positive rows), shard by shard; the
    shards' partials merged == the full-mode CE."""
    h, table, ids, labels, lq = _shared_case()
    rows = V // r_shards
    g = np.linspace(0.5, 1.5, B * S).reshape(B, S).astype(np.float32)
    partials = []
    for r in range(r_shards):
        tab = table[r * rows:(r + 1) * rows]
        nid, lqm, pid, okn = _owner_masked(ids, labels, lq, r, rows)
        ne = tab[nid]                                          # [B,M,D]
        hh = torch.from_numpy(h).requires_grad_(True)
        nn_ = torch.from_numpy(ne).requires_grad_(True)
        ll = torch.from_numpy(lqm).requires_grad_(True)
        if fmt == "bf16":
            lse = ops.sampled_ce_partial_op(hh, nn_, ll, torch.from_numpy(nid),
                                            torch.from_numpy(pid), MS)
        else:
            qd, qs = quantize_rows(torch.from_numpy(tab), fmt)
            lse = ops.sampled_ce_q_partial_op(
                hh, nn_, qd[torch.from_numpy(nid)],
                qs[torch.from_numpy(nid)], ll, torch.from_numpy(nid),
                torch.from_numpy(pid), MS)
        got = [lse.detach().numpy()] + [x.numpy() for x in torch.autograd.grad(
            lse, (hh, nn_, ll), torch.from_numpy(g))]
        want = [[], [], [], []]
        for b in range(B):
            nidb = jnp.asarray(nid[b], jnp.int32)
            pidb = jnp.asarray(pid[b], jnp.int32)
            zeros = jnp.zeros((S, D), jnp.float32)
            if fmt == "bf16":
                def f(x, e, lq_b):
                    return jops.sampled_ce_partial_op(x, zeros, e, lq_b, nidb,
                                                      pidb, MS, True)
            else:
                qdb = jnp.asarray(tensor_to_numpy(qd[torch.from_numpy(
                    nid[b])]))
                qsb = jnp.asarray(qs[torch.from_numpy(nid[b])].numpy())
                zq = jnp.zeros((S, D), qdb.dtype)
                ones = jnp.ones((S, 1), jnp.float32)

                def f(x, e, lq_b):
                    return jops.sampled_ce_q_partial_op(
                        x, zeros, e, zq, ones, qdb, qsb, lq_b, nidb, pidb,
                        MS, True)
            lse_b, vjp = jax.vjp(f, jnp.asarray(h[b]), jnp.asarray(ne[b]),
                                 jnp.asarray(lqm[b]))
            for i, x in enumerate([lse_b, *vjp(jnp.asarray(g[b]))]):
                want[i].append(np.asarray(x))
        for name, a, b in zip(("lse", "dh", "dne", "dlq"), got, want):
            _close(a, np.stack(b), msg=f"shard {r} {name}")
        empty = ~okn.any(1)                               # [B]
        assert np.all(got[0][empty] == np.float32(NEG_INF))
        partials.append(got[0])
    if fmt == "bf16":
        full = ops.sampled_ce_op(
            torch.from_numpy(h), torch.from_numpy(table[labels]),
            torch.from_numpy(table[ids]), torch.from_numpy(lq),
            torch.from_numpy(ids), torch.from_numpy(labels))
        pos = torch.from_numpy(np.sum(h * table[labels], -1))
        merged = tss.merge_sampled_softmax_loss(
            pos, torch.from_numpy(np.stack(partials, -1)))
        _close(merged.numpy(), full.detach().numpy())


def test_partial_lse_and_merge_match_reference():
    """`partial_sampled_lse` (with owner masks, collisions and an
    all-masked row) and `merge_sampled_softmax_loss` (with an empty shard)
    == the reference's, values and gradients."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((5, 8)).astype(np.float32)
    lq = (-3.0 + 0.1 * rng.standard_normal((5, 8))).astype(np.float32)
    ids = rng.integers(0, 20, (5, 8))
    pos = rng.integers(0, 20, 5)
    ids[0, 1] = pos[0]
    valid = rng.random((5, 8)) < 0.6
    valid[3] = False                                      # all masked
    tl = torch.from_numpy(logits).requires_grad_(True)
    got = tss.partial_sampled_lse(tl, torch.from_numpy(lq), 16,
                                  torch.from_numpy(ids), torch.from_numpy(pos),
                                  True, torch.from_numpy(valid))
    g_got, = torch.autograd.grad(got.sum(), tl)
    want, vjp = jax.vjp(lambda x: jss.partial_sampled_lse(
        x, lq, 16, ids, pos, True, valid), jnp.asarray(logits))
    _close(got.detach().numpy(), want)
    _close(g_got.numpy(), vjp(jnp.ones(5))[0])
    assert got[3].item() == np.float32(NEG_INF)
    parts = np.stack([got.detach().numpy(), got.detach().numpy() - 1.0,
                      np.full(5, NEG_INF, np.float32)], -1)
    pl = rng.standard_normal(5).astype(np.float32)
    tp = torch.from_numpy(parts).requires_grad_(True)
    m_got = tss.merge_sampled_softmax_loss(torch.from_numpy(pl), tp)
    gp, = torch.autograd.grad(m_got.sum(), tp)
    m_want, vjp = jax.vjp(lambda x: jss.merge_sampled_softmax_loss(pl, x),
                          jnp.asarray(parts))
    _close(m_got.detach().numpy(), m_want)
    _close(gp.numpy(), vjp(jnp.ones(5))[0])


# ------------------------------------------------------ sharding arithmetic
def test_head_rows_and_refresh_rows():
    assert shd.head_rows_per_shard(200, 1) == 200
    assert shd.head_rows_per_shard(200, 8) == 25
    with pytest.raises(ValueError):
        shd.head_rows_per_shard(201, 8)
    assert shd.refresh_rows_per_shard(96, 8) == 12
    assert shd.refresh_rows_per_shard(100, 8) == 13      # tail pad-and-masked
    assert shd.refresh_rows_per_shard(7, 1) == 7


def test_shard_params_cuts_only_class_tables():
    cfg = ranks.make_cfg()
    params, *_ = ranks.setup(cfg)
    assert shd.vocab_param_names(params) == ("embed",)
    local = shd.shard_params(params, 4, 1)
    assert local["embed"].shape == (cfg.padded_vocab // 4, cfg.d_model)
    assert torch.equal(local["embed"], params["embed"][50:100])
    for k in params:
        if k != "embed":
            assert local[k] is params[k]
    two = {"embed": params["embed"], "head": params["embed"].clone(),
           "final_norm": params["final_norm"]}
    assert shd.vocab_param_names(two) == ("embed", "head")
    assert choose_backend(2, torch.device("cpu")) == "gloo"
    with pytest.raises(ValueError):
        choose_backend(2, torch.device("cpu"), "nccl")


def _jax_index():
    """A reference-built index (the reference's init) as numpy, and the
    same carried into the port by the bridge."""
    from repro.configs.base import HeadConfig as JHead
    from repro.configs.base import ModelConfig as JCfg
    from repro.models import heads as jheads
    from repro.models import init_params as jinit
    cfg = JCfg(name="vp-test", family="dense", num_layers=1, d_model=32,
               num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=200,
               head_dim=16, vocab_pad_multiple=8, remat=False,
               dtype="float32",
               head=JHead(mode="midx", midx_k=8, num_negatives=12,
                          kmeans_iters=2))
    key = jax.random.PRNGKey(0)
    jidx = jheads.init_head_state(cfg, jinit(cfg, key),
                                  jax.random.fold_in(key, 1))
    d = {f: np.asarray(getattr(jidx, f)) for f in (
        "codebook1", "codebook2", "assign1", "assign2", "residuals",
        "sorted_ids", "offsets", "counts", "log_counts")}
    return jidx, index_from_numpy(d, kind=jidx.kind, device="cpu")


def _same_index_field(f, got, want, msg):
    """Bitwise, but log_counts (torch's and XLA's log may differ by an
    ulp) within 1e-6."""
    if f == "log_counts":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                   err_msg=msg)
    else:
        np.testing.assert_array_equal(got, want, err_msg=msg)


def test_shard_and_unshard_index_match_reference_bitwise():
    """Every integer leaf and the codebooks bit for bit (log_counts to
    the ulp of the two libraries' log)."""
    jidx, tidx = _jax_index()
    for n in (2, 4, 8):
        want = jvp.shard_index(jidx, n)
        got = sharded_index_to_numpy(vp.shard_index(tidx, n))
        for f in vp.SHARDED_FIELDS:
            _same_index_field(f, got[f], np.asarray(getattr(want, f)),
                              f"{n} {f}")
        assert got["num_shards"] == want.num_shards
        back = vp.unshard_index(vp.shard_index(tidx, n))
        jback = jvp.unshard_index(want)
        for f in ("assign1", "assign2", "sorted_ids", "offsets", "counts",
                  "log_counts"):
            _same_index_field(f, tensor_to_numpy(getattr(back, f)).astype(
                np.asarray(getattr(jback, f)).dtype),
                np.asarray(getattr(jback, f)), f)
        local = vp.local_index(vp.shard_index(tidx, n), n - 1)
        assert sorted(local.sorted_ids.tolist()) == list(range(200 // n))
    with pytest.raises(ValueError):
        vp.shard_index(tidx, 3)
    # the checkpoint layout: JAX's treedef string of the stacked index
    assert _treedef_str(vp.shard_index(tidx, 4)) == str(
        jax.tree_util.tree_structure(jvp.shard_index(jidx, 4)))


# --------------------------------------------- ranks as gloo CPU processes
@pytest.fixture(scope="module", params=[2, 4])
def ranked(request, tmp_path_factory):
    """Spawn R ranks once: every scenario of `torch_vp_ranks.scenarios`,
    each rank's results as numpy, and the replicated path's."""
    n = request.param
    out = str(tmp_path_factory.mktemp(f"vp{n}"))
    spawn_ranks(ranks.scenarios, n, (out, n == 2), device="cpu",
                backend="gloo", threads=1)
    res = [dict(np.load(os.path.join(out, f"rank{r}.npz")))
           for r in range(n)]
    return n, out, res


def _replicated():
    cfg = ranks.make_cfg()
    return cfg, ranks.setup(cfg)


def test_vp_draws_equal_replicated(ranked):
    n, _, res = ranked
    cfg, (params, index, h, labels, tokens, keys) = _replicated()
    m = cfg.head.num_negatives
    d = midx.sample_twostage(index, h.reshape(-1, cfg.d_model), m, keys)
    for r in range(n):
        np.testing.assert_array_equal(res[r]["twostage_ids"], d.ids.numpy())
        _close(res[r]["twostage_lq"], d.log_q.detach().numpy())
    seq = ranks.noise.sequence_keys(keys, ranks.S)
    for name, sampler in (("pooled", midx.sample_pooled),
                          ("mixture", midx.sample_mixture)):
        d = sampler(index, h, m, seq)
        for r in range(n):
            np.testing.assert_array_equal(res[r][f"{name}_ids"],
                                          d.ids.numpy())
            _close(res[r][f"{name}_lq"], d.log_q.detach().numpy())


def test_vp_embed_lookup_equals_gather(ranked):
    n, _, res = ranked
    cfg, (params, _, _, _, tokens, _) = _replicated()
    want = params["embed"][tokens].numpy()
    for r in range(n):
        _close(res[r]["embed"], want, 1e-6)


@pytest.mark.parametrize("case", list(ranks.LOSS_CASES))
def test_vp_loss_and_grads_match_replicated(ranked, case):
    n, _, res = ranked
    proposal, fmt, mask = ranks.LOSS_CASES[case]
    cfg = ranks.make_cfg(proposal, fmt, mask)
    params, index, h, labels, _, keys = ranks.setup(cfg)
    state = index
    table = class_embeddings(cfg, params).detach()
    if fmt != "bf16":
        from repro_torch.index.quantized import quantize_head_state
        state = quantize_head_state(index, table, fmt,
                                    gen=torch.Generator().manual_seed(2))
    t = table.clone().requires_grad_(True)
    hh = h.clone().requires_grad_(True)
    loss = heads.loss_midx(cfg, {**params, "embed": t}, state, hh, labels,
                           keys)
    dt, dh = torch.autograd.grad(loss, (t, hh))
    for r in range(n):
        assert abs(float(res[r][f"loss_{case}"]) - float(loss)) < TOL
        assert res[r][f"loss_{case}"] == res[0][f"loss_{case}"]
        assert np.max(np.abs(res[r][f"dtab_{case}"] - dt.numpy())) < TOL
        assert np.max(np.abs(res[r][f"dh_{case}"] - dh.numpy())) < TOL


def test_vp_train_step_matches_replicated(ranked):
    n, _, res = ranked
    cfg, (params, index, h, labels, tokens, keys) = _replicated()
    opt = adamw(1e-3)
    p = ranks._clone(params)
    step = steps.make_train_step(cfg, opt)
    p, _, met = step(p, opt.init(p), index,
                     {"tokens": tokens, "labels": labels}, keys)
    for r in range(n):
        assert abs(float(res[r]["step_loss"]) - float(met["loss"])) < TOL
        assert abs(float(res[r]["step_gnorm"])
                   - float(met["grad_norm"])) < TOL
        for i, leaf in enumerate(tree_leaves(p)):
            assert np.max(np.abs(res[r][f"step_param_{i}"]
                                 - leaf.numpy())) < TOL, i


def test_vp_backbone_bitwise_equal_across_ranks(ranked):
    n, _, res = ranked
    for r in range(1, n):
        assert res[r]["backbone"].tobytes() == res[0]["backbone"].tobytes()
        for i in range(len([k for k in res[0] if
                            k.startswith("step_param_")])):
            key = f"step_param_{i}"
            assert res[r][key].tobytes() == res[0][key].tobytes()


def test_vp_native_index_init_and_refresh(ranked):
    n, _, res = ranked
    cfg = ranks.make_cfg()
    vpad, rows = cfg.padded_vocab, cfg.padded_vocab // n
    for tag in ("init", "refresh"):
        st = res[0]
        for r in range(n):
            for f in vp.CSR_FIELDS:
                assert res[r][f"{tag}_{f}"].tobytes() == st[f"{tag}_{f}"] \
                    .tobytes()
        assert st[f"{tag}_counts"].sum() == vpad
        for i in range(n):
            assert int(st[f"{tag}_offsets"][i][-1]) == rows
            assert sorted(st[f"{tag}_sorted_ids"][i].tolist()) == \
                list(range(rows))
            cnt, lc = st[f"{tag}_counts"][i], st[f"{tag}_log_counts"][i]
            np.testing.assert_allclose(lc[cnt > 0], np.log(cnt[cnt > 0]),
                                       atol=1e-5)
            assert np.all(np.isneginf(lc[cnt == 0]))
        loss = float(st[f"{tag}_loss"])
        assert np.isfinite(loss) and 0.0 < loss < 20.0
    assert np.all(np.isfinite(res[0]["refresh_metrics"]))


@pytest.mark.parametrize("ranked", [2], indirect=True)
def test_vp_export_restores_into_engine(ranked):
    n, out, res = ranked
    cfg = ranks.make_cfg()
    merged = vp.unshard_index(vp.VocabShardedIndex(
        "rq", n, torch.zeros(cfg.head.midx_k, 1),
        torch.zeros(cfg.head.midx_k, 1),
        *(torch.from_numpy(res[0][f"export_{f}"]) for f in vp.CSR_FIELDS)))
    eng = Engine.from_checkpoint(
        cfg.with_serve(max_slots=1, page_size=4, max_seq=32),
        os.path.join(out, "export", "serve"), head="midx", device="cpu")
    np.testing.assert_array_equal(eng.index.assign1.numpy(),
                                  merged.assign1.numpy())
    np.testing.assert_array_equal(eng.index.counts.numpy(),
                                  merged.counts.numpy())
    result = eng.run([Request(rid=0, tokens=np.arange(7, dtype=np.int32),
                              max_new=4, seed=1)])[0]
    assert result.status == "ok" and len(result.tokens) == 4
    assert all(0 <= t < cfg.vocab_size for t in result.tokens)


@pytest.mark.parametrize("ranked", [2], indirect=True)
def test_vp_resume_equals_uninterrupted(ranked):
    n, _, res = ranked
    for r in range(n):
        assert bool(res[r]["resume_same"])
        assert res[r]["resume_hist"].tobytes() == \
            res[r]["whole_hist"][3:].tobytes()


def test_train_cli_vocab_parallel_exports(tmp_path):
    """`--vocab-parallel 2` on the CPU through `train_main` (gloo ranks):
    the serving export loads into `Engine` and decodes."""
    ck = str(tmp_path / "ck")
    assert train_main(["--device", "cpu", "--reduced", "--vocab-parallel",
                       "2", "--steps", "2", "--batch", "4", "--seq", "16",
                       "--ckpt", ck]) is None
    from repro_torch.configs import get_config
    cfg = get_config("paper-lm").reduced().with_serve(max_slots=1,
                                                      page_size=4,
                                                      max_seq=32)
    eng = Engine.from_checkpoint(cfg, os.path.join(ck, "serve"), head="midx",
                                 device="cpu")
    result = eng.run([Request(rid=0, tokens=np.arange(5, dtype=np.int32),
                              max_new=3, seed=0)])[0]
    assert result.status == "ok" and len(result.tokens) == 3
