"""The unfused MIDX head route of the port (`fused=False`,
`HeadConfig.use_fused_head=False`, `--fused-head off`) against the JAX
package's unfused route on the CPU.

Inputs are made with numpy from a seed; index states are built by the
reference and carried into the port through `repro_torch.bridge`, or the
other way. Both sides take the same negatives: the port draws them, and
the reference's sampler is replaced by one that returns those ids with
the log q of its own formulation (as `tests/test_torch_repairs.py`
does). Held at the reference's bar, 1e-5 (atol and rtol) on values and
gradients (`tests/test_fused_head.py`):
  - `loss_midx(fused=False)`, its value and its gradients with respect
    to the hidden states, the class table and the codebooks, for the
    per-token, pooled and mixture proposals over fp32 and bf16 tables
    with collisions masked and not, and over int8 and fp8 head states
    (the reference's state carried across, so its low-bit rows are
    shared: 1e-5, inside the reference's quantized bars 5e-3 and 3e-2 of
    `tests/test_quantized_head.py`);
  - `core.midx.twostage_tables_q` against the reference's
    `proposal_tables_q(use_kernel=False)`;
  - `midx_decode_head(fused=False)` and `proposal_decode_head` at a near
    zero temperature (a greedy pick) against the reference's
    `midx_decode_head(fused=False)`;
  - `loss_midx_vp(fused=False)` on two gloo ranks against the reference's
    single-device unfused loss (the reference's own vocab-parallel tests
    fail here, ROADMAP.md Queue 3 fact a);
  - `train_loop(fused_head=False)`, 3 steps on one device and at dp 2,
    against the reference's `train_loop(fused_head=False)` started from
    the port's params and index and fed the port's draws;
  - `fused_head_active`'s truth table; the fused and unfused routes of the
    port within 1e-5 of each other on the same draws; the unfused route
    calling no kernel wrapper.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_ranks as dp_ranks
import torch_vp_ranks as vp_ranks
from repro.configs.base import HeadConfig as JHeadConfig
from repro.configs.base import ModelConfig as JModelConfig
from repro.core import midx as jmidx
from repro.index import quantized as jq
from repro.index.build import MultiIndex as JMultiIndex
from repro.kernels import dispatch as jdispatch
from repro.kernels.midx_probs.ops import proposal_tables_q as jtables_q
from repro.launch import train as jtrain
from repro.models import heads as jheads
from repro_torch.bridge import (index_from_numpy, index_to_numpy,
                                params_to_numpy, quant_state_from_numpy,
                                tensor_from_numpy, tensor_to_numpy)
from repro_torch.configs.base import HeadConfig, ModelConfig
from repro_torch.core import midx, noise
from repro_torch.index import quantized as tq
from repro_torch.kernels import dispatch
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.launch.train import train_loop
from repro_torch.models import heads
from repro_torch.proposals import registry

TOL = 1e-5
B, S, D, V, K, M = 2, 8, 32, 200, 8, 12
FIELDS = ("codebook1", "codebook2", "assign1", "assign2", "residuals",
          "sorted_ids", "offsets", "counts", "log_counts")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tier-1 run puts test files in parallel
    workers, and torch's thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(proposal="per_token", table_dtype="bf16", dtype="float32",
          mask=True, **head):
    kw = dict(name="unfused-test", family="dense", num_layers=1,
              d_model=D, num_heads=2, num_kv_heads=2, d_ff=64,
              vocab_size=V, head_dim=16, vocab_pad_multiple=8, remat=False,
              dtype=dtype)
    hk = dict(mode="midx", midx_k=K, num_negatives=M, proposal=proposal,
              kmeans_iters=2, table_dtype=table_dtype,
              mask_collisions=mask, **head)
    return (JModelConfig(**kw, head=JHeadConfig(**hk)),
            ModelConfig(**kw, head=HeadConfig(**hk)))


def _jindex(d):
    """A reference MultiIndex from `index_to_numpy`'s mapping."""
    return JMultiIndex(d["kind"], **{f: jnp.asarray(d[f]) for f in FIELDS})


def _jstate_np(js):
    """A reference QuantHeadState as the bridge's numpy mapping."""
    return {"fmt": js.fmt,
            "index": {"kind": js.index.kind,
                      **{f: np.asarray(getattr(js.index, f))
                         for f in FIELDS}},
            **{f: np.asarray(getattr(js, f)) for f in tq.QUANT_FIELDS[1:]}}


def _inputs(dtype, fmt, seed=0):
    """The class table (numpy, in the config's dtype), hidden states and
    the reference's head state with the port's copy of it."""
    jc, _ = _cfgs(table_dtype=fmt, dtype=dtype)
    rng = np.random.default_rng(seed)
    table = (0.3 * rng.standard_normal((V, D))).astype(np.float32)
    table = np.asarray(jnp.asarray(table).astype(jnp.dtype(dtype)))
    h = (0.5 * rng.standard_normal((B, S, D))).astype(np.float32)
    js = jheads.init_head_state(jc, {"embed": jnp.asarray(table)},
                                jax.random.PRNGKey(seed + 1))
    if fmt == "bf16":
        ts = index_from_numpy({"kind": js.kind, **{
            f: np.asarray(getattr(js, f)) for f in FIELDS}}, device="cpu")
    else:
        ts = quant_state_from_numpy(_jstate_np(js), device="cpu")
    return table, h, js, ts


def _with_cbs(state, cb1, cb2):
    """The head state with its MultiIndex's codebooks replaced (the
    leaves the gradients are taken with respect to)."""
    if hasattr(state, "qdata"):
        return dataclasses.replace(state, index=dataclasses.replace(
            state.index, codebook1=cb1, codebook2=cb2))
    return dataclasses.replace(state, codebook1=cb1, codebook2=cb2)


def _index_of(state):
    return state.index if hasattr(state, "qdata") else state


def _port_loss(tc, table, h, state, labels, keys, fused):
    """The port's loss and its gradients (hidden, table, codebook1,
    codebook2) as numpy; a leaf the loss does not reach gets zeros."""
    tab = tensor_from_numpy(table, "cpu").requires_grad_(True)
    hh = torch.from_numpy(h).requires_grad_(True)
    idx = _index_of(state)
    cbs = [idx.codebook1.clone().requires_grad_(True),
           idx.codebook2.clone().requires_grad_(True)]
    loss = heads.loss_midx(tc, {"embed": tab}, _with_cbs(state, *cbs), hh,
                           torch.from_numpy(labels).long(), keys,
                           fused=fused)
    leaves = [hh, tab] + cbs
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), [np.zeros(tuple(x.shape), np.float32)
                         if g is None else tensor_to_numpy(g.float())
                         for x, g in zip(leaves, grads)]


def _record_draws(monkeypatch):
    """Keep every draw the port's samplers return (`box` grows a list of
    ids per call)."""
    box = []
    for name in ("sample_twostage", "_shared_draw"):
        fn = getattr(midx, name)

        def rec(*a, _fn=fn, **kw):
            out = _fn(*a, **kw)
            box.append((out[0] if isinstance(out, tuple)
                        and not isinstance(out, midx.Draw) else out).ids)
            return out
        monkeypatch.setattr(midx, name, rec)
    return box


def _feed_reference(monkeypatch, draws, keys=None):
    """Replace the reference's samplers by ones that return the given ids
    (numpy [.., M] arrays) with the log q of the reference's own
    formulation: the draws in call order, or, with `keys` (one JAX key a
    draw), the draw whose key the sampler is called with (a jitted step
    traces its sampler once)."""
    calls = iter(draws)
    tables = jmidx.twostage_tables

    def pick(key):
        if keys is None:
            return jnp.asarray(next(calls).astype(np.int32))
        sel = jnp.argmax(jnp.all(jnp.stack(keys) == key, axis=-1))
        return jnp.asarray(np.stack(draws).astype(np.int32))[sel]

    def twostage(index, key, z, m, *, tables_fn=None, member_fn=None,
                 return_tables=False):
        ids = pick(key).reshape(*z.shape[:-1], m)
        s1, s2, lpsi, lse = (tables_fn or tables)(index, z)
        lq = (jnp.take_along_axis(s1, index.assign1[ids], -1)
              + jnp.take_along_axis(s2, index.assign2[ids], -1)
              - lse[..., None])
        draw = jmidx.Draw(ids, lq)
        return (draw, (s1, s2, lpsi, lse)) if return_tables else draw

    def shared(index, key, flat_log, m, member_fn=None):
        ids = pick(key)
        kk = index.codebook1.shape[0]
        cluster = index.assign1[ids] * kk + index.assign2[ids]
        lse = jax.nn.logsumexp(flat_log, axis=-1, keepdims=True)
        return jmidx.Draw(ids, jnp.take_along_axis(flat_log, cluster, -1)
                          - index.log_counts.reshape(-1)[cluster] - lse)

    monkeypatch.setattr(jmidx, "sample_twostage", twostage)
    monkeypatch.setattr(jmidx, "_shared_draw", shared)


def _reference_loss(jc, table, h, js, labels):
    """The reference's `loss_midx(fused=False)` and its gradients with
    respect to (hidden, table, codebook1, codebook2)."""
    idx = _index_of(js)

    def f(hh, tab, cb1, cb2):
        return jheads.loss_midx(jc, {"embed": tab}, _with_cbs(js, cb1, cb2),
                                hh, jnp.asarray(labels),
                                jax.random.PRNGKey(0), fused=False)

    loss, grads = jax.value_and_grad(f, argnums=(0, 1, 2, 3))(
        jnp.asarray(h), jnp.asarray(table), idx.codebook1, idx.codebook2)
    return float(loss), [np.asarray(g.astype(jnp.float32)) for g in grads]


def _colliding_labels(proposal, ids, seed=5):
    """Labels some of which equal a drawn negative (a collision for every
    other token), the rest from numpy."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, V, (B, S))
    ids = ids.numpy()
    if proposal == "per_token":
        labels[:, ::2] = ids.reshape(B, S, M)[:, ::2, 3]
    else:
        labels[:, ::2] = ids[:, 3:4]
    return labels


def _hold(got, want):
    np.testing.assert_allclose(got[0], want[0], atol=TOL, rtol=TOL)
    for name, a, b in zip(("dh", "dtable", "dcb1", "dcb2"), got[1], want[1]):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL, err_msg=name)


CASES = [(p, dt, "bf16", mask) for p in ("per_token", "pooled", "mixture")
         for dt in ("float32", "bfloat16") for mask in (True, False)] + [
         (p, "float32", fmt, True) for p in ("per_token", "pooled",
                                             "mixture")
         for fmt in ("int8", "fp8")]


@pytest.mark.parametrize("proposal,dtype,fmt,mask", CASES)
def test_unfused_loss_matches_the_reference(monkeypatch, proposal, dtype,
                                            fmt, mask):
    jc, tc = _cfgs(proposal, fmt, dtype, mask)
    table, h, js, ts = _inputs(dtype, fmt)
    keys = noise.train_keys(0, 3, B * S)
    box = _record_draws(monkeypatch)
    _port_loss(tc, table, h, ts, np.zeros((B, S), np.int64), keys, False)
    labels = _colliding_labels(proposal, box[0])
    got = _port_loss(tc, table, h, ts, labels, keys, False)
    assert all(torch.equal(a, box[0]) for a in box[1:])
    _feed_reference(monkeypatch, [box[0].numpy()])
    want = _reference_loss(jc, table, h, js, labels)
    _hold(got, want)


@pytest.mark.parametrize("proposal", ["per_token", "pooled", "mixture"])
@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_fused_and_unfused_routes_agree_on_the_same_draws(proposal, fmt):
    """On the CPU the fused route runs the kernels' plain versions: the
    two routes take the same draws (per-token tables bit for bit) and
    agree on the loss and every gradient within 1e-5."""
    _, tc = _cfgs(proposal, fmt)
    table, h, _, ts = _inputs("float32", fmt, seed=1)
    keys = noise.train_keys(0, 7, B * S)
    labels = np.random.default_rng(2).integers(0, V, (B, S))
    fused = _port_loss(tc, table, h, ts, labels, keys, True)
    unfused = _port_loss(tc, table, h, ts, labels, keys, False)
    _hold(unfused, fused)
    if proposal == "per_token":
        idx = _index_of(ts)
        z = torch.from_numpy(h).reshape(B * S, D)
        a = heads.route_tables_fn(None if fmt == "bf16" else ts, True)
        b = heads.route_tables_fn(None if fmt == "bf16" else ts, False)
        da = midx.sample_twostage(idx, z, M, keys, tables_fn=a)
        db = midx.sample_twostage(idx, z, M, keys, tables_fn=b)
        assert torch.equal(da.ids, db.ids)
        assert torch.equal(da.log_q, db.log_q)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("kind", ["pq", "rq"])
def test_twostage_tables_q_matches_the_reference(fmt, kind):
    rng = np.random.default_rng(3)
    table = (0.3 * rng.standard_normal((V, D))).astype(np.float32)
    z = (0.5 * rng.standard_normal((5, 3, D))).astype(np.float32)
    jc, _ = _cfgs(table_dtype=fmt, quantizer=kind)
    js = jheads.init_head_state(jc, {"embed": jnp.asarray(table)},
                                jax.random.PRNGKey(4))
    ts = quant_state_from_numpy(_jstate_np(js), device="cpu")
    got = midx.twostage_tables_q(ts.index, ts.qcb1, ts.qcb1_scale, ts.qcb2,
                                 ts.qcb2_scale, torch.from_numpy(z))
    want = jtables_q(js.index, js.qcb1, js.qcb1_scale, js.qcb2,
                     js.qcb2_scale, jnp.asarray(z), use_kernel=False)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL,
                                   rtol=TOL)
    # the gradient reaches z (and nothing of the low-bit state)
    zt = torch.from_numpy(z).requires_grad_(True)
    dz, = torch.autograd.grad(sum(x.sum() for x in midx.twostage_tables_q(
        ts.index, ts.qcb1, ts.qcb1_scale, ts.qcb2, ts.qcb2_scale, zt)), zt)
    jdz = jax.grad(lambda zz: sum(jnp.sum(x) for x in jtables_q(
        js.index, js.qcb1, js.qcb1_scale, js.qcb2, js.qcb2_scale, zz,
        use_kernel=False)))(jnp.asarray(z))
    np.testing.assert_allclose(dz.numpy(), np.asarray(jdz), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
@pytest.mark.parametrize("generic", [False, True])
def test_unfused_decode_head_matches_the_reference(monkeypatch, fmt,
                                                   generic):
    """At temperature 1e-6 the IS-corrected pick is the candidate of the
    largest logit: the token and its log q equal the reference's on the
    same candidates."""
    jc, tc = _cfgs(table_dtype=fmt)
    table, h, js, ts = _inputs("float32", fmt, seed=6)
    z = 4.0 * h[:, 0]                                    # [B, D]
    keys = noise.row_keys(torch.zeros(B, dtype=torch.long),
                          torch.arange(B), torch.full((B,), 5))
    box = _record_draws(monkeypatch)
    params = {"embed": tensor_from_numpy(table, "cpu")}
    zt = torch.from_numpy(z)
    if generic:
        prop = registry.from_config(tc.head, "midx")          # midx-rq
        out = heads.proposal_decode_head(tc, params, prop, ts, zt, keys, M,
                                         1e-6, fused=False)
    else:
        out = heads.midx_decode_head(tc, params, ts, zt, keys, M, 1e-6,
                                     fused=False)
    _feed_reference(monkeypatch, [box[0].numpy()])
    want = jheads.midx_decode_head(jc, {"embed": jnp.asarray(table)}, js,
                                   jnp.asarray(z), jax.random.PRNGKey(0),
                                   M, 1e-6, fused=False)
    np.testing.assert_array_equal(out.token.numpy(), np.asarray(want.token))
    np.testing.assert_allclose(out.log_q.numpy(), np.asarray(want.log_q),
                               atol=TOL, rtol=TOL)


def test_fused_head_active_truth_table(monkeypatch):
    """Collision masking off: unfused. Else an explicit `fused` wins, else
    `use_fused_head`. The reference agrees wherever it decides without
    its backend gate (which sends `fused=None` to the unfused route on a
    CPU; the port's CPU runs the fused route's plain versions)."""
    monkeypatch.delenv("REPRO_FUSED_HEAD", raising=False)
    monkeypatch.delenv("REPRO_PALLAS_INTERPRET", raising=False)
    for mask in (True, False):
        for use in (True, False):
            for fused in (None, True, False):
                _, tc = _cfgs(mask=mask, use_fused_head=use)
                jc, _ = _cfgs(mask=mask, use_fused_head=use)
                want = mask and (use if fused is None else fused)
                got = dispatch.fused_head_active(tc.head, fused=fused)
                assert got is want, (mask, use, fused)
                if fused is not None or not mask or not use:
                    assert jdispatch.fused_head_active(
                        jc.head, fused=fused) is want


def test_unfused_route_calls_no_kernel_wrapper(monkeypatch):
    """With use_fused_head False, training (all three proposals) and
    serving go through no wrapper of `kernels.dispatch`; batched == solo
    holds for the served tokens."""
    from repro_torch.serve import Engine, Request
    called = []
    for name in ("midx_probs", "sampled_ce_pt", "sampled_ce_pt_bwd",
                 "sampled_ce", "sampled_ce_bwd"):
        fn = getattr(dispatch, name)

        def spy(*a, _n=name, _fn=fn, **kw):
            called.append(_n)
            return _fn(*a, **kw)
        monkeypatch.setattr(dispatch, name, spy)
    for proposal in ("per_token", "pooled", "mixture"):
        _, tc = _cfgs(proposal, use_fused_head=False)
        table, h, _, ts = _inputs("float32", "bf16", seed=8)
        _port_loss(tc, table, h, ts, np.ones((B, S), np.int64),
                   noise.train_keys(0, 1, B * S), None)
    _, tc = _cfgs(use_fused_head=False)
    cfg = tc.with_serve(max_slots=2, page_size=8, max_seq=24)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, tokens=rng.integers(0, V, 6).astype(np.int32),
                    max_new=5) for i in range(3)]
    eng = Engine(cfg, device="cpu")
    res = eng.run(reqs)
    assert called == []
    for r in reqs[:2]:
        np.testing.assert_array_equal(res[r.rid].tokens, eng.replay_single(r))
    # the default route does call the wrappers
    _, on = _cfgs()
    table, h, _, ts = _inputs("float32", "bf16", seed=8)
    _port_loss(on, table, h, ts, np.ones((B, S), np.int64),
               noise.train_keys(0, 1, B * S), None)
    assert "midx_probs" in called and "sampled_ce_pt" in called


# ------------------------------------------------------- vocab parallel
def test_unfused_vp_loss_on_two_ranks_matches_the_reference(tmp_path,
                                                            monkeypatch):
    spawn_ranks(vp_ranks.unfused_scenario, 2, (str(tmp_path),),
                device="cpu", backend="gloo", threads=1)
    res = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for name, (proposal, fmt, mask) in vp_ranks.UNFUSED_CASES.items():
        cfg = vp_ranks.make_cfg(proposal, fmt, mask)
        jc, _ = _cfgs(proposal, fmt, mask=mask)
        params, index, h, labels, _, keys = vp_ranks.setup(cfg)
        table = params["embed"].detach().numpy()
        jidx = _jindex(index_to_numpy(index))
        js = jidx if fmt == "bf16" else jq.quantize_head_state(
            jidx, jnp.asarray(table), fmt, key=jax.random.PRNGKey(0))
        # the replicated unfused route's draws are the ranks' bit for bit
        box = _record_draws(monkeypatch)
        state = index if fmt == "bf16" else tq.quantize_head_state(
            index, params["embed"].detach(), fmt,
            gen=torch.Generator().manual_seed(0))
        heads.loss_midx(cfg, params, state, h, labels, keys, fused=False)
        monkeypatch.undo()
        _feed_reference(monkeypatch, [box[-1].numpy()])
        wl, (wdh, wdt, _, _) = _reference_loss(jc, table, h.numpy(), js,
                                               labels.numpy())
        monkeypatch.undo()
        for r in range(2):
            np.testing.assert_allclose(res[r][f"loss_{name}"], wl,
                                       atol=TOL, rtol=TOL, err_msg=name)
            np.testing.assert_allclose(res[r][f"dh_{name}"], wdh, atol=TOL,
                                       rtol=TOL, err_msg=name)
            np.testing.assert_allclose(res[r][f"dtab_{name}"], wdt,
                                       atol=TOL, rtol=TOL, err_msg=name)


# ------------------------------------------------------------ train_loop
TRAIN = dp_ranks.UNFUSED_TRAIN


def _reference_train(monkeypatch, tc, params, index, draws, corpus):
    """The reference's `train_loop(fused_head=False)` started from the
    port's params and index and fed the port's draws, step s's by its step
    key (`fold_in(k_loop, s)`, reference `launch/train.py:118, :232`)."""
    jc, _ = _cfgs()
    jp = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(tc, params))
    jidx = _jindex(index_to_numpy(index))
    monkeypatch.setattr(jtrain, "init_params", lambda cfg, key: jp)
    monkeypatch.setattr(jheads, "init_head_state",
                        lambda cfg, p, key: jidx)
    k_loop = jax.random.split(jax.random.PRNGKey(TRAIN["seed"]), 3)[2]
    _feed_reference(monkeypatch, draws, [jax.random.fold_in(k_loop, s)
                                         for s in range(len(draws))])
    _, _, _, hist = jtrain.train_loop(jc, corpus=corpus, fused_head=False,
                                      **TRAIN)
    return np.asarray(hist)


def test_unfused_train_loop_matches_the_reference(monkeypatch, tmp_path):
    """3 steps of `train_loop(fused_head=False)`: on one device and at dp 2
    (two gloo ranks, each on its rows of the batch, drawing the
    single-device negatives), the losses within 1e-5 of the reference's
    loop on the same params, index, batches and negatives."""
    tc = vp_ranks.make_cfg()
    corpus = dp_ranks.unfused_corpus(tc)
    p0, _, i0, _ = train_loop(tc, corpus=corpus, device="cpu",
                              **{**TRAIN, "steps": 0})
    box = _record_draws(monkeypatch)
    _, _, _, hist = train_loop(tc, corpus=corpus, device="cpu",
                               fused_head=False, **TRAIN)
    assert len(box) == 3
    monkeypatch.undo()
    want = _reference_train(monkeypatch, tc, p0, i0,
                            [b.numpy() for b in box], corpus)
    np.testing.assert_allclose(hist, want, atol=TOL, rtol=TOL)
    spawn_ranks(dp_ranks.unfused_train_scenario, 1, (str(tmp_path),), dp=2,
                device="cpu", backend="gloo", threads=1)
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")["hist"]
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
