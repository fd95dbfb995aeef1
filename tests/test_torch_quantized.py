"""The quantized head (int8 and fp8 class tables) of the port against the JAX
package on the CPU, at the reference test's size (`tests/test_quantized_head.py`:
d_model 32, V 200, K 8, M 12, one layer).

Bars: `quantize_rows` bit for bit (fp8 by its raw bits); the plain versions
of the quantized kernel modes (midx_probs, the per-token and the shared
sampled CE, forward and backward) against the JAX kernels in interpret mode
within 1e-5; `dequant_rows`' straight-through gradient, `code_scores` and
`residual_scores` within 1e-5; `loss_midx` over a quantized state, given the
port's draws, against the reference's formulation within 1e-5, value and
gradients; the quantized loss against the bf16 one within the reference's
`LOSS_TOL`; checkpoints of int8, fp8 and bf16 states byte for byte both ways.
Inputs are made with numpy from a seed or by the reference's init."""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.configs.base import HeadConfig as JHeadConfig
from repro.configs.base import ModelConfig as JModelConfig
from repro.core import midx as jmidx
from repro.core.sampled_softmax import sampled_softmax_loss as jssl
from repro.index import quantized as jq
from repro.kernels.midx_probs.midx_probs import midx_probs as jmidx_probs
from repro.kernels.midx_probs.ops import proposal_tables_q as jtables_q
from repro.kernels.sampled_ce.per_token import sampled_ce_pt as jce_pt
from repro.kernels.sampled_ce.per_token import \
    sampled_ce_pt_bwd as jce_pt_bwd
from repro.kernels.sampled_ce.sampled_ce import sampled_ce as jce
from repro.kernels.sampled_ce.sampled_ce import sampled_ce_bwd as jce_bwd
from repro.models import heads as jheads
from repro.models import init_params as jinit
from repro.models.model import class_embeddings as jclass_embeddings
from repro.models.model import forward as jforward
from repro_torch.bridge import (params_from_numpy, params_to_numpy,
                                quant_state_from_numpy, quant_state_to_numpy,
                                to_reference)
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import _flatten, _treedef_str
from repro_torch.configs.base import HeadConfig, ModelConfig
from repro_torch.core import midx, noise
from repro_torch.index import quantized as tq
from repro_torch.kernels.midx_probs.ref import midx_probs_ref
from repro_torch.kernels.sampled_ce.ref import (sampled_ce_bwd_ref,
                                                sampled_ce_fwd_ref,
                                                sampled_ce_pt_bwd_ref,
                                                sampled_ce_pt_fwd_ref)
from repro_torch.launch import steps
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import main as train_main
from repro_torch.models import heads, init_params
from repro_torch.models.model import class_embeddings
from repro_torch.models.model import forward as tforward
from repro_torch.optim import adamw
from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.resilience.validate import validate_state
from repro_torch.serve import Engine, Request

TOL = 1e-5
# quantized-against-bf16 loss bars of the reference (`LOSS_TOL`)
LOSS_TOL = {"int8": 5e-3, "fp8": 3e-2}
FMTS = ("int8", "fp8")
B, S = 2, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tier-1 run puts test files in parallel
    workers, and torch's thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(proposal="per_token", table_dtype="int8", **head):
    kw = dict(name="quant-test", family="dense", num_layers=1, d_model=32,
              num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=200,
              head_dim=16, vocab_pad_multiple=8, remat=False,
              dtype="float32")
    hk = dict(mode="midx", midx_k=8, num_negatives=12, proposal=proposal,
              kmeans_iters=2, table_dtype=table_dtype, **head)
    return (JModelConfig(**kw, head=JHeadConfig(**hk)),
            ModelConfig(**kw, head=HeadConfig(**hk)))


def _np(x):
    return np.asarray(x)


def _jstate_np(js):
    """A JAX QuantHeadState as the bridge's numpy mapping."""
    idx = js.index
    return {"fmt": js.fmt,
            "index": {"kind": idx.kind, **{
                f: _np(getattr(idx, f)) for f in (
                    "codebook1", "codebook2", "assign1", "assign2",
                    "residuals", "sorted_ids", "offsets", "counts",
                    "log_counts")}},
            **{f: _np(getattr(js, f)) for f in tq.QUANT_FIELDS[1:]}}


@functools.lru_cache(maxsize=None)
def _jax_side(fmt):
    """The reference's params and head state at seed 0 (they depend on the
    table format, not on the proposal): built once a format."""
    jc, _ = _cfgs(table_dtype=fmt)
    key = jax.random.PRNGKey(0)
    jp = jinit(jc, key)
    return jp, jheads.init_head_state(jc, jp, jax.random.fold_in(key, 1))


def _setup(fmt="int8", proposal="per_token", **head):
    """Both packages' params and the reference's head state (carried into
    the port), tokens and labels."""
    jc, tc = _cfgs(proposal, fmt, **head)
    jp, js = _jax_side(fmt)
    tp = params_from_numpy(tc, jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    ts = quant_state_from_numpy(_jstate_np(js), device="cpu") \
        if fmt != "bf16" else None
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    return jc, tc, jp, tp, js, ts, toks, labels


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=tol)


def _bits(x):
    """Raw bits of a low-bit array (numpy or torch) for a bitwise compare."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.uint8) if x.dtype == torch.float8_e4m3fn else x
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint8) if x.dtype.name == "float8_e4m3fn" else x


# --------------------------------------------------------------- formats
def test_unknown_table_dtype_raises_at_init_and_at_step_build():
    with pytest.raises(ValueError, match="table_dtype"):
        tq.resolve_table_dtype("int4")
    _, tc = _cfgs(table_dtype="int3")
    with pytest.raises(ValueError, match="table_dtype"):
        heads.init_head_state(tc, init_params(tc, torch.Generator(),
                                              device="cpu"),
                              torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="table_dtype"):
        steps.make_train_step(tc, adamw(1e-3))
    assert tq.storage_dtype("fp8") == torch.float8_e4m3fn
    assert tq.storage_dtype("int8") == torch.int8


def _rows(case, d=16):
    rng = np.random.default_rng(7)
    return {
        "zero_row": np.zeros((3, d)),
        "outlier_row": np.concatenate(
            [np.full((1, d), 1e-3), np.eye(1, d) * 1e4], 0),
        "tiny_row": np.full((2, d), 1e-20),
        "mixed_sign": np.stack([np.linspace(-5, 5, d),
                                -np.linspace(-5, 5, d)]),
        "normal": rng.standard_normal((64, d)) * 0.3,
        "wide_range": rng.standard_normal((64, d))
        * np.exp(rng.uniform(-30, 30, (64, 1))),
    }[case].astype(np.float32)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("case", ["zero_row", "outlier_row", "tiny_row",
                                  "mixed_sign", "normal", "wide_range"])
def test_quantize_rows_is_the_reference_bit_for_bit(fmt, case):
    x = _rows(case)
    jqd, jsc = jq.quantize_rows(jnp.asarray(x), fmt)
    q, s = tq.quantize_rows(torch.from_numpy(x), fmt)
    assert q.dtype == tq.storage_dtype(fmt) and s.dtype == torch.float32
    np.testing.assert_array_equal(_bits(q), _bits(jqd))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  _np(jsc).view(np.uint32))
    deq = tq.dequantize(q, s).numpy()
    assert np.all(np.isfinite(s.numpy())) and np.all(s.numpy() > 0)
    if case == "zero_row":
        np.testing.assert_array_equal(deq, 0.0)
    elif case != "wide_range":
        amax = np.max(np.abs(x), axis=-1, keepdims=True)
        tol = {"int8": 1 / 127, "fp8": 1 / 16}[fmt]
        np.testing.assert_allclose(deq, x, atol=float(np.max(amax)) * tol)


# ------------------------------------------------------------ midx_probs
def _midx_inputs(split, fmt, t=16, d=32, k=8, seed=0):
    rng = np.random.default_rng(seed)
    dc = d // 2 if split else d
    z = rng.standard_normal((t, d)).astype(np.float32)
    cb = [(0.3 * rng.standard_normal((k, dc))).astype(np.float32)
          for _ in range(2)]
    counts = rng.integers(0, 4, (k, k)).astype(np.float32)
    counts[:, 0] = 0
    qs = [jq.quantize_rows(jnp.asarray(c), fmt) for c in cb]
    return z, qs, counts


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("split", [False, True])
def test_quantized_midx_probs_plain_version_matches_the_kernel(fmt, split):
    z, ((q1, s1), (q2, s2)), counts = _midx_inputs(split, fmt)
    want = jmidx_probs(jnp.asarray(z), q1, q2, jnp.asarray(counts),
                       scale1=s1, scale2=s2, split=split, interpret=True,
                       block_t=8)
    tt = lambda a: torch.from_numpy(np.array(_bits(a)))   # noqa: E731
    view = (lambda t: t.view(torch.float8_e4m3fn)) if fmt == "fp8" \
        else (lambda t: t)
    got = midx_probs_ref(torch.from_numpy(z), view(tt(q1)), view(tt(q2)),
                         torch.from_numpy(counts), split=split,
                         scale1=tt(s1), scale2=tt(s2))
    for a, b in zip(got, want):
        _close(a.numpy().reshape(-1), _np(b).reshape(-1))


@pytest.mark.parametrize("fmt", FMTS)
def test_proposal_tables_q_gradient_matches_the_reference_vjp(fmt):
    jc, tc, jp, tp, js, ts, _, _ = _setup(fmt)
    rng = np.random.default_rng(1)
    z = (0.5 * rng.standard_normal((8, 32))).astype(np.float32)
    cts = [rng.standard_normal((8, 8)).astype(np.float32) for _ in range(3)]
    cts.append(rng.standard_normal(8).astype(np.float32))

    def jf(zz):
        # the plain route: the kernel route's VJP (`_tables_q_bwd`) is this
        # very recompute; its forward is held above
        return jtables_q(js.index, js.qcb1, js.qcb1_scale, js.qcb2,
                         js.qcb2_scale, zz, use_kernel=False)

    jout, vjp = jax.vjp(jf, jnp.asarray(z))
    (jdz,) = vjp(tuple(jnp.asarray(c) for c in cts))
    zt = torch.from_numpy(z).requires_grad_(True)
    out = heads.quantized_tables_fn(ts)(ts.index, zt)
    for a, b in zip(out, jout):
        _close(a.detach().numpy(), _np(b))
    dz, = torch.autograd.grad(out, (zt,),
                              tuple(torch.from_numpy(c) for c in cts))
    _close(dz.numpy(), _np(jdz))


# ---------------------------------------------------- the per-token CE
def _ce_inputs(js, fmt, t=8, d=32, m=12, seed=2):
    """Hidden rows, the reference's own draws (its quantized tables, its
    key) with a duplicate and a collision forced in, g."""
    rng = np.random.default_rng(seed)
    h = (0.5 * rng.standard_normal((t, d))).astype(np.float32)
    tf = lambda idx, z: jtables_q(idx, js.qcb1, js.qcb1_scale,  # noqa: E731
                                  js.qcb2, js.qcb2_scale, z,
                                  use_kernel=False)
    draw = jmidx.sample_twostage(js.index, jax.random.PRNGKey(seed),
                                 jnp.asarray(h), m, tables_fn=tf)
    ids = np.array(draw.ids)
    pos = rng.integers(0, 200, t).astype(np.int32)
    ids[:, 1] = ids[:, 0]                  # a duplicate within a row
    ids[0, 2] = pos[0]                     # a collision with the positive
    ids[3:, 4] = ids[1, 4]                 # an id repeated across rows
    g = rng.uniform(0.2, 1.0, t).astype(np.float32)
    return h, np.array(draw.log_q), ids, pos, g


@pytest.mark.parametrize("fmt", FMTS)
def test_quantized_per_token_ce_matches_the_kernels(fmt):
    _, _, _, _, js, ts, _, _ = _setup(fmt)
    h, lq, ids, pos, g = _ce_inputs(js, fmt)
    jl, jlse = jce_pt(jnp.asarray(h), js.qdata, jnp.asarray(lq),
                      jnp.asarray(ids), jnp.asarray(pos), scale=js.qscale,
                      interpret=True, block_t=8, chunk=8)
    jdh, jdtab, jdlq = jce_pt_bwd(jnp.asarray(g), jnp.asarray(h), js.qdata,
                                  jnp.asarray(lq), jnp.asarray(ids),
                                  jnp.asarray(pos), jlse, scale=js.qscale,
                                  interpret=True, block_t=8, chunk=8)
    args = (torch.from_numpy(h), ts.qdata, torch.from_numpy(lq),
            torch.from_numpy(ids).long(), torch.from_numpy(pos).long())
    loss, lse = sampled_ce_pt_fwd_ref(*args, scale=ts.qscale)
    _close(loss, jl)
    _close(lse, jlse)
    dh, dtab, dlq = sampled_ce_pt_bwd_ref(torch.from_numpy(g), *args, lse,
                                          scale=ts.qscale)
    _close(dh, jdh)
    _close(dtab, jdtab)
    _close(dlq, jdlq)


@pytest.mark.parametrize("fmt", FMTS)
def test_quantized_shared_ce_matches_the_kernels(fmt):
    _, _, _, _, js, ts, _, _ = _setup(fmt)
    h, lq, ids, pos, g = _ce_inputs(js, fmt, t=16)
    nid, nlq = ids[0], lq[0]                  # one sequence's M negatives
    nid[3] = pos[5]                           # a collision
    pj = lambda a, i: a[jnp.asarray(i)]       # noqa: E731
    jl, jlse = jce(jnp.asarray(h), pj(js.qdata, pos), pj(js.qdata, nid),
                   jnp.asarray(nlq), jnp.asarray(nid), jnp.asarray(pos),
                   pos_scale=pj(js.qscale, pos), neg_scale=pj(js.qscale, nid),
                   interpret=True)
    jgrads = jce_bwd(jnp.asarray(g), jnp.asarray(h), pj(js.qdata, pos),
                     pj(js.qdata, nid), jnp.asarray(nlq), jnp.asarray(nid),
                     jnp.asarray(pos), jlse, pos_scale=pj(js.qscale, pos),
                     neg_scale=pj(js.qscale, nid), interpret=True)
    pt, nt = torch.from_numpy(pos).long(), torch.from_numpy(nid).long()
    args = (torch.from_numpy(h)[None], ts.qdata[pt][None],
            ts.qdata[nt][None], torch.from_numpy(nlq)[None], nt[None],
            pt[None])
    sc = (ts.qscale[pt][None], ts.qscale[nt][None])
    loss, lse = sampled_ce_fwd_ref(*args, *sc)
    _close(loss[0], jl)
    _close(lse[0], jlse)
    got = sampled_ce_bwd_ref(torch.from_numpy(g)[None], *args, lse, *sc)
    for a, b in zip(got, jgrads):
        _close(a[0], b)


# ------------------------------------------------ straight-through gather
@pytest.mark.parametrize("fmt", FMTS)
def test_dequant_rows_gradient_is_the_references(fmt):
    _, _, jp, tp, js, ts, _, _ = _setup(fmt)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 200, (5, 7)).astype(np.int32)
    ids[1, :3] = ids[0, 0]                            # repeated rows
    ct = rng.standard_normal((5, 7, 32)).astype(np.float32)
    master = jnp.asarray(_np(js.qdata), jnp.float32)

    def jf(t):
        return jq.dequant_rows(t, js.qdata, js.qscale, jnp.asarray(ids))

    jrows, vjp = jax.vjp(jf, master)
    (jg,) = vjp(jnp.asarray(ct))
    tm = torch.from_numpy(np.array(master)).requires_grad_(True)
    rows = tq.dequant_rows(tm, ts.qdata, ts.qscale,
                           torch.from_numpy(ids).long())
    _close(rows.detach(), jrows)
    g, = torch.autograd.grad(rows, (tm,), torch.from_numpy(ct))
    _close(g, jg)


# ------------------------------------------------------- code rescoring
@pytest.mark.parametrize("fmt", FMTS)
def test_code_and_residual_scores_match_the_reference(fmt):
    _, _, _, _, js, ts, _, _ = _setup(fmt)
    rng = np.random.default_rng(5)
    z = (0.5 * rng.standard_normal((6, 32))).astype(np.float32)
    ids = rng.integers(0, 200, (6, 16)).astype(np.int32)
    s1, s2 = jq.quantized_query_scores(js.index.kind, js.qcb1, js.qcb1_scale,
                                       js.qcb2, js.qcb2_scale,
                                       jnp.asarray(z))
    want = jq.code_scores(js.index, js.residual_codes, jnp.asarray(z),
                          jnp.asarray(ids), s1, s2)
    want_r = jq.residual_scores(js.residual_codes, jnp.asarray(z),
                                jnp.asarray(ids))
    zt, it = torch.from_numpy(z), torch.from_numpy(ids).long()
    t1, t2 = tq.quantized_query_scores(ts.index.kind, ts.qcb1, ts.qcb1_scale,
                                       ts.qcb2, ts.qcb2_scale, zt)
    _close(t1, s1)
    _close(t2, s2)
    _close(tq.code_scores(ts.index, ts.residual_codes, zt, it, t1, t2), want)
    _close(tq.residual_scores(ts.residual_codes, zt, it), want_r)


def test_port_residual_codes_meet_the_reference_criterion():
    """The port's own fit (its k-means, its generator): the code rescore is
    within half the coarse term's error of the exact logits
    (`test_code_scores_approximate_exact_logits`)."""
    _, tc = _cfgs()
    tp = init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    state = heads.init_head_state(tc, tp, torch.Generator().manual_seed(1))
    assert isinstance(state, tq.QuantHeadState)
    assert state.qdata.dtype == torch.int8 and state.codes.dtype == torch.int8
    assert tuple(state.qscale.shape) == (tc.padded_vocab, 1)
    table = class_embeddings(tc, tp).float()
    idx = state.index
    z = 0.3 * torch.randn((8, 32), generator=torch.Generator().manual_seed(2))
    ids = torch.arange(64).expand(8, 64)
    s1, s2 = midx.query_scores(idx.kind, idx.codebook1, idx.codebook2, z)
    approx = tq.code_scores(idx, state.residual_codes, z, ids, s1, s2)
    exact = z @ table[:64].T
    coarse = (torch.gather(s1, -1, idx.assign1[ids])
              + torch.gather(s2, -1, idx.assign2[ids]))
    err_pq = float((approx - exact).abs().mean())
    err_coarse = float((coarse - exact).abs().mean())
    assert err_pq < 0.5 * err_coarse
    assert err_pq < float(exact.abs().mean()) + 1e-3


# --------------------------------------------------------------- the head
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("proposal", ["per_token", "pooled", "mixture"])
def test_quantized_loss_tracks_bf16(proposal, fmt):
    _, tq_cfg = _cfgs(proposal, fmt)
    _, tb_cfg = _cfgs(proposal, "bf16")
    tp = init_params(tb_cfg, torch.Generator().manual_seed(0), device="cpu")
    sq = heads.init_head_state(tq_cfg, tp, torch.Generator().manual_seed(1))
    sb = heads.init_head_state(tb_cfg, tp, torch.Generator().manual_seed(1))
    assert torch.equal(sq.index.codebook1, sb.codebook1)
    h = 0.3 * torch.randn((B, S, 32), generator=torch.Generator()
                          .manual_seed(2))
    labels = torch.randint(0, 200, (B, S),
                           generator=torch.Generator().manual_seed(3))
    keys = noise.train_keys(0, 1, B * S)
    lq = heads.loss_midx(tq_cfg, tp, sq, h, labels, keys)
    lb = heads.loss_midx(tb_cfg, tp, sb, h, labels, keys)
    assert abs(float(lq) - float(lb)) < LOSS_TOL[fmt], (float(lq), float(lb))


def _reference_loss(jc, js, proposal, masked, ids, toks, labels):
    """The reference's loss given the port's negatives: its forward, its
    quantized tables' log q, and its unfused lane (`dequant_rows`, then
    `sampled_softmax_loss`), which its own tests hold to its kernels
    within 1e-5 (`test_quantized_fused_unfused_parity`); the port's
    kernels' plain versions are held to the reference's kernels above."""
    def loss(p):
        h = jforward(jc, p, jnp.asarray(toks))["hidden"].astype(jnp.float32)
        table = jclass_embeddings(jc, p)
        lab = jnp.asarray(labels)
        pe = jq.dequant_rows(table, js.qdata, js.qscale, lab)
        if proposal == "per_token":
            h2 = h.reshape(B * S, -1)
            s1, s2, _, lse = jtables_q(js.index, js.qcb1, js.qcb1_scale,
                                       js.qcb2, js.qcb2_scale, h2,
                                       use_kernel=False)
            lq = (jnp.take_along_axis(s1, js.index.assign1[ids], -1)
                  + jnp.take_along_axis(s2, js.index.assign2[ids], -1)
                  - lse[:, None])
            ne = jq.dequant_rows(table, js.qdata, js.qscale,
                                 ids.reshape(B, S, -1))
            neg_logits = jnp.einsum("bsd,bsmd->bsm", h, ne)
            lq, nid = lq.reshape(B, S, -1), ids.reshape(B, S, -1)
        else:
            sf = lambda idx, z: jq.quantized_query_scores(  # noqa: E731
                idx.kind, js.qcb1, js.qcb1_scale, js.qcb2, js.qcb2_scale, z)
            j, s1, s2 = jmidx._joint_from_scores(
                js.index, h if proposal == "mixture" else h.mean(1), sf)
            lq = _shared_log_q(js.index, j, s1, s2, ids, proposal)
            ne = jq.dequant_rows(table, js.qdata, js.qscale, ids)
            neg_logits = jnp.einsum("bsd,bmd->bsm", h, ne)
            lq, nid = lq[:, None, :], ids[:, None, :]
        out = jssl(jnp.sum(h * pe, -1), neg_logits, lq, nid, lab, masked)
        return jnp.mean(out)
    return loss


def _shared_log_q(index, j, s1, s2, ids, proposal):
    """log q of the shared draws' ids under the reference's formulation:
    the pooled joint, or the token mixture (`sample_mixture`)."""
    kk = index.num_codewords
    if proposal == "pooled":
        flat = j.reshape(j.shape[0], -1)
    else:
        log_z = jax.nn.logsumexp(j.reshape(*j.shape[:-2], -1), axis=-1)
        c2 = jnp.max(s2, axis=-1, keepdims=True)
        a = jnp.exp(s1 - log_z[..., None] + c2)
        bb = jnp.exp(s2 - c2)
        mix = jnp.einsum("bsk,bsl->bkl", a, bb)
        flat = (jnp.log(jnp.maximum(mix, 1e-30))
                + index.log_counts).reshape(j.shape[0], -1)
    lse = jax.nn.logsumexp(flat, axis=-1, keepdims=True)
    cluster = index.assign1[ids] * kk + index.assign2[ids]
    return (jnp.take_along_axis(flat, cluster, -1)
            - index.log_counts.reshape(-1)[cluster] - lse)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("proposal,masked", [("per_token", True),
                                             ("per_token", False),
                                             ("pooled", True),
                                             ("mixture", True)])
def test_loss_midx_over_a_quantized_state_matches_the_reference(
        fmt, proposal, masked):
    """The slice end to end: the port's `loss_midx` over the reference's
    quantized state (carried across), its forward and every gradient, given
    the port's own negatives, against the reference's formulation on those
    negatives."""
    jc, tc, jp, tp, js, ts, toks, labels = _setup(
        fmt, proposal, mask_collisions=masked)
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), tp)
    keys = noise.train_keys(0, 3, B * S)
    hidden = tforward(tc, leaves, torch.from_numpy(toks).long())["hidden"]
    loss = heads.loss_midx(tc, leaves, ts, hidden,
                           torch.from_numpy(labels).long(), keys)
    flat = tree_leaves(leaves)
    it = iter(torch.autograd.grad(loss, flat))
    grads = tree_map(lambda _: next(it), leaves)
    h32 = hidden.detach().float()
    m = tc.head.num_negatives
    if proposal == "per_token":
        draw = midx.sample_twostage(ts.index, h32.reshape(B * S, -1), m,
                                    keys,
                                    tables_fn=heads.quantized_tables_fn(ts))
    else:
        sampler = midx.sample_pooled if proposal == "pooled" \
            else midx.sample_mixture
        sf = lambda idx, z: tq.quantized_query_scores(  # noqa: E731
            idx.kind, ts.qcb1, ts.qcb1_scale, ts.qcb2, ts.qcb2_scale, z)
        draw = sampler(ts.index, h32, m, noise.sequence_keys(keys, S),
                       scores_fn=sf)
    ids = jnp.asarray(draw.ids.numpy().astype(np.int32))
    jl, jg = jax.value_and_grad(_reference_loss(
        jc, js, proposal, masked, ids, toks, labels))(jp)
    _close(float(loss.detach()), float(jl))
    a = params_to_numpy(tc, grads)
    for x, y in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(jax.tree_util.tree_map(
                        np.asarray, jg))):
        _close(x, y)


@pytest.mark.parametrize("quantize_on_refresh", [True, False])
def test_refresh_keeps_the_quantized_state(quantize_on_refresh):
    _, tc = _cfgs(quantize_on_refresh=quantize_on_refresh)
    tp = init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    state = heads.init_head_state(tc, tp, torch.Generator().manual_seed(1))
    with torch.no_grad():
        tp["embed"].add_(0.05)                 # the table moves
    new, metrics = heads.refresh_head_state_with_policy(
        tc, tp, state, torch.Generator().manual_seed(5))
    assert isinstance(new, tq.QuantHeadState) and "reassigned_frac" in metrics
    assert validate_state(new, like=state) == []
    same = torch.equal(new.qdata, state.qdata)
    if quantize_on_refresh:
        want, _ = tq.quantize_rows(class_embeddings(tc, tp), "int8")
        assert torch.equal(new.qdata, want) and not same
    else:
        assert same and new.codes is state.codes
    again = heads.refresh_head_state(tc, tp, state,
                                     torch.Generator().manual_seed(5))
    assert torch.equal(again.qdata, new.qdata)


def test_validate_state_flags_a_zero_scale():
    _, tc = _cfgs()
    tp = init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    state = heads.init_head_state(tc, tp, torch.Generator().manual_seed(1))
    assert validate_state(state, like=state) == []
    bad = state.qscale.clone()
    bad[3] = 0.0
    reasons = validate_state(dataclasses.replace(state, qscale=bad))
    assert any("qscale" in r for r in reasons)
    fp8 = dataclasses.replace(state, qdata=state.qdata.to(torch.float32)
                              .to(torch.float8_e4m3fn))
    assert any("dtype" in r for r in validate_state(fp8, like=state))
    from repro_torch.resilience.faults import poison_state
    nan = validate_state(poison_state(state, "nan"), like=state)
    assert any("qscale" in r for r in nan) and any("codebook1" in r
                                                   for r in nan)


# ------------------------------------------------------------ checkpoints
@pytest.mark.parametrize("fmt", ["int8", "fp8", "bf16"])
def test_head_state_checkpoint_crosses_both_ways_bitwise(tmp_path, fmt):
    jc, tc, jp, tp, js, ts, _, _ = _setup(fmt)
    if fmt == "bf16":
        from repro_torch.bridge import index_from_numpy
        ts = index_from_numpy({"kind": js.kind, **{
            f: _np(getattr(js, f)) for f in (
                "codebook1", "codebook2", "assign1", "assign2", "residuals",
                "sorted_ids", "offsets", "counts", "log_counts")}},
            device="cpu")
    jtree = {"params": jp, "index": js}
    ttree = {"params": tp, "index": ts}
    assert _treedef_str(to_reference(ttree)) == \
        str(jax.tree_util.tree_flatten(jtree)[1])
    JManager(str(tmp_path / "j")).save(2, jtree, metadata={"next_step": 2})
    CheckpointManager(str(tmp_path / "t")).save(2, ttree,
                                                metadata={"next_step": 2})
    dirs = [next((tmp_path / w).glob("step_*")) for w in ("j", "t")]
    specs = [json.loads((d / "tree.json").read_text()) for d in dirs]
    assert specs[0] == specs[1]                  # treedef, dtypes, CRC32s
    with np.load(dirs[0] / "arrays.npz") as za, \
            np.load(dirs[1] / "arrays.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:                       # the same bytes written
            assert za[k].dtype == zb[k].dtype
            assert za[k].tobytes() == zb[k].tobytes()
    got = CheckpointManager(str(tmp_path / "j")).restore(2, ttree,
                                                         device="cpu")
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                            jtree))
    for x, y in zip(_flatten(to_reference(got)), want):
        assert x.dtype == torch.float8_e4m3fn or x.numpy().dtype == y.dtype
        np.testing.assert_array_equal(_bits(x), _bits(y))
    like = jax.tree_util.tree_map(jnp.zeros_like, jtree)
    back = JManager(str(tmp_path / "t")).restore(2, like, verify=True)
    for x, y in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jtree)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(_bits(x), _bits(y))
    if fmt != "bf16":
        again = quant_state_from_numpy(quant_state_to_numpy(got["index"]),
                                       device="cpu")
        for f in tq.QUANT_FIELDS[1:]:
            assert torch.equal(_t8(getattr(again, f)),
                               _t8(getattr(got["index"], f)))


# ---------------------------------------------------------------- serving
@pytest.mark.parametrize("fmt", FMTS)
def test_engine_serves_a_quantized_state_batched_equals_solo(tmp_path, fmt):
    _, tc = _cfgs(table_dtype=fmt)
    tc = tc.with_serve(max_slots=2, page_size=4, max_seq=16)
    eng = Engine(tc, head="midx", device="cpu", seed=3)
    assert isinstance(eng.index, tq.QuantHeadState)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, tokens=rng.integers(0, 200, 5).astype(np.int32),
                    max_new=4, seed=1) for i in range(3)]
    res = eng.run(reqs)
    for r in reqs:
        assert res[r.rid].status == "ok" and len(res[r.rid].tokens) == 4
        np.testing.assert_array_equal(res[r.rid].tokens, eng.replay_single(r))
    eng.save_checkpoint(str(tmp_path), step=1)
    back = Engine.from_checkpoint(tc, str(tmp_path), head="midx",
                                  device="cpu", seed=3)
    assert back.index.fmt == fmt
    for f in tq.QUANT_FIELDS[1:]:
        a, b = getattr(back.index, f), getattr(eng.index, f)
        assert a.dtype == b.dtype and torch.equal(_t8(a), _t8(b))
    res2 = back.run(reqs)
    for r in reqs:
        np.testing.assert_array_equal(res2[r.rid].tokens, res[r.rid].tokens)


def _t8(x):
    return x.view(torch.uint8) if x.dtype == torch.float8_e4m3fn else x


def test_quantized_decode_head_rescores_from_codes():
    """The decode head over a quantized state scores its candidates as
    `code_scores` over the draw's own stage tables (reference
    `heads.py:345-356`)."""
    _, tc = _cfgs()
    tp = init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    st = heads.init_head_state(tc, tp, torch.Generator().manual_seed(1))
    h = 0.3 * torch.randn((4, 32), generator=torch.Generator().manual_seed(2))
    keys = noise.row_keys(0, torch.arange(4), 5)
    out = heads.midx_decode_head(tc, tp, st, h, keys, 16, 1.0)
    draw, (s1, s2, _, _) = midx.sample_twostage(
        st.index, h, 16, keys, tables_fn=heads.quantized_tables_fn(st),
        return_tables=True)
    corrected = tq.code_scores(st.index, st.residual_codes, h, draw.ids, s1,
                               s2) - draw.log_q
    want = heads._pick(draw, corrected, keys)
    assert torch.equal(out.token, want.token)


# -------------------------------------------------------------------- CLI
@pytest.mark.parametrize("fmt", FMTS)
def test_cli_trains_and_serves_with_a_quantized_table(tmp_path, fmt):
    base = ["--device", "cpu", "--reduced", "--steps", "2", "--batch", "2",
            "--seq", "8", "--table-dtype", fmt, "--ckpt", str(tmp_path)]
    params, _, index, hist = train_main(base)
    assert isinstance(index, tq.QuantHeadState) and index.fmt == fmt
    assert len(hist) == 2 and all(np.isfinite(hist))
    out = serve_main(["--device", "cpu", "--reduced", "--requests", "2",
                      "--tokens", "3", "--table-dtype", fmt, "--ckpt",
                      str(tmp_path / "serve")])
    assert out["verified"] == 2
