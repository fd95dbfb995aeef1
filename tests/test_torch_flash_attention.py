"""The long-context attention path of the port against the JAX package on
the CPU: the flash kernel's plain version against the Pallas kernel (in
interpret mode) and the jnp oracle, the chunked path of `attention` with
its blockwise-recompute backward against the reference's XLA path, a
reduced llama3.2-1b at S = 2048 (where both packages take the chunked
path at their default thresholds) through prefill, the full-softmax loss
with every gradient and the serving engine, and the device dispatch.

Inputs are made with numpy from a seed. Tolerances: the bars of
`tests/test_kernels.py` for the kernel sweep (2e-5 fp32, 2e-2 bf16), 1e-5
(atol and rtol) in fp32 for the chunked path and the slice; greedy tokens
exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro import serve as jserve
from repro.kernels.flash_attention.flash_attention import \
    flash_attention as jflash
from repro.kernels.flash_attention.ref import attention_ref as jattention_ref
from repro.models import attention as jattn
from repro.models.decode import prefill as jprefill
from repro.models.heads import loss_full as jloss_full
from repro.models.model import forward as jforward
from repro.models.model import init_params as jinit
from repro_torch import configs as tcfg
from repro_torch import serve as tserve
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import cuda as flash_cuda
from repro_torch.kernels.flash_attention.ops import FlashAttentionFn
from repro_torch.kernels.flash_attention.ref import (NEG_INF, block_mask,
                                                     flash_fwd_ref)
from repro_torch.launch import train as train_cli
from repro_torch.models import attention as tattn
from repro_torch.models.decode import prefill as tprefill
from repro_torch.models.heads import loss_full as tloss_full
from repro_torch.models.model import forward as tforward
from repro_torch.optim.optimizers import tree_leaves, tree_map

TOL = 1e-5
LONG = 2048                    # > direct_threshold 1024, a multiple of both
                               # default chunks (512, 1024)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: when test files run in parallel worker
    processes, torch's thread pools oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed, b, sq, sk, h, kv, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, sq, h, hd), (b, sk, kv, hd),
                               (b, sk, kv, hd)))


def _both(x, dtype):
    """The same values in both frameworks: fp32 numpy, rounded to bf16 on
    each side (both round to nearest even) when asked."""
    t = torch.from_numpy(x)
    j = jnp.asarray(x)
    if dtype == "bfloat16":
        return t.to(torch.bfloat16), j.astype(jnp.bfloat16)
    return t, j


# ------------------------------------------------------------ (a) kernel
@pytest.mark.parametrize("b,s,h,kv,hd,dtype", [
    (2, 256, 4, 2, 64, "float32"),
    (1, 256, 4, 4, 32, "float32"),
    (2, 384, 6, 3, 64, "float32"),
    (1, 128, 2, 1, 128, "bfloat16"),
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_matches_pallas_kernel_and_oracle(b, s, h, kv, hd,
                                                        dtype, causal):
    """`flash_fwd_ref` in the Pallas kernel's own case (window None,
    q_offset = Sk - Sq = 0) against the kernel in interpret mode and the
    jnp oracle, and the port's dense path (the oracle's counterpart)
    against the jnp oracle, on the sweep of `tests/test_kernels.py`."""
    (tq, jq), (tk, jk), (tv, jv) = (_both(x, dtype) for x in
                                    _qkv(s + hd, b, s, s, h, kv, hd))
    out, lse = flash_fwd_ref(tq, tk, tv, causal=causal, window=None,
                             q_offset=0, q_chunk=128, kv_chunk=128)
    assert out.dtype == tq.dtype and lse.shape == (b, kv, h // kv, s)
    o_k = jflash(jq, jk, jv, causal=causal, block_q=128, block_k=128,
                 interpret=True)
    o_r = jattention_ref(jq, jk, jv, causal=causal)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    got = out.float().numpy()
    for want in (o_k, o_r):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)
    np.testing.assert_allclose(
        tattn._direct_attention(tq, tk, tv, causal, None).float().numpy(),
        np.asarray(o_r, np.float32), atol=tol, rtol=tol)


def test_plain_version_with_fewer_queries_than_keys():
    """sq < sk with q_offset = sk - sq: the Pallas kernel's causal form."""
    q, k, v = _qkv(7, 2, 128, 384, 4, 2, 32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, _ = flash_fwd_ref(tq, tk, tv, causal=True, window=None,
                           q_offset=256, q_chunk=64, kv_chunk=128)
    want = np.asarray(jattention_ref(*map(jnp.asarray, (q, k, v)),
                                     causal=True))
    for got in (out, tattn._direct_attention(tq, tk, tv, True, None,
                                             q_offset=256)):
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def _pv_emulated(q, k, v, rounding, kv_block=128):
    """`ref.flash_fwd_ref`'s loop for causal attention in one query chunk
    and kv blocks of `kv_block` keys (the CUDA kernel's at hd = 64), with
    P . V done three ways: "fp32" keeps p (the plain version), "single"
    rounds p once to bf16, "split" adds bf16(p) . V and bf16(p - bf16(p))
    . V, as the kernel's tensor-core products do."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    qs = q.reshape(b, s, kv, g, hd).float() * hd ** -0.5
    acc = torch.zeros((b, kv, g, s, hd))
    m = torch.full((b, kv, g, s), NEG_INF)
    l = torch.zeros((b, kv, g, s))
    for ik in range(s // kv_block):
        cols = slice(ik * kv_block, (ik + 1) * kv_block)
        ks, vs = k[:, cols].float(), v[:, cols].float()
        sc = torch.einsum("bqkgh,bmkh->bkgqm", qs, ks)
        ok = block_mask(0, ik, s, kv_block, 0, True, None, "cpu")
        sc = torch.where(ok, sc, sc.new_tensor(NEG_INF))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        if rounding == "fp32":
            terms = [p]
        else:
            hi = p.bfloat16().float()
            terms = [hi] if rounding == "single" else \
                [hi, (p - hi).bfloat16().float()]
        acc = acc * alpha[..., None]
        for t in terms:
            acc = acc + torch.einsum("bkgqm,bmkh->bkgqh", t, vs)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd).to(q.dtype)


def test_pv_rounding_meets_the_bf16_hold():
    """How the CUDA kernel's bf16 route rounds p for its tensor-core P . V:
    the hi/lo split meets the card's bf16 hold, 2^-7·|plain| + 1e-5, on
    every element at B=1, S=1024, H=4, KV=1, hd=64, causal; one rounding
    of p to bf16 does not. On these inputs (torch 2.13 on the CPU) the
    single rounding puts 27 034 of 262 144 elements outside the hold, the
    worst at 108x it (an error of 7.8e-3); the split's worst element uses
    0.97 of it and fp32 (the kernel's 128-key blocks against the plain
    version's single block) 0.84: a one-ulp bf16 difference just above a
    power of two."""
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in _qkv(0, 1, 1024, 1024, 4, 1, 64))
    want, _ = flash_fwd_ref(q, k, v, causal=True, window=None, q_offset=0,
                            q_chunk=512, kv_chunk=1024)
    want = want.float()
    worst = {}
    for rounding in ("fp32", "single", "split"):
        got = _pv_emulated(q, k, v, rounding).float()
        worst[rounding] = float(((got - want).abs()
                                 / (2.0 ** -7 * want.abs() + 1e-5)).max())
    assert worst["split"] <= 1.0 and worst["fp32"] <= 1.0
    assert worst["single"] > 1.0, "the single rounding would do"


# ------------------------------------------------------- (b) chunked path
CHUNKED = dict(direct_threshold=8, q_chunk=16, kv_chunk=16)


@pytest.mark.parametrize("causal,window,sq,q_offset", [
    (True, None, 64, 0), (True, 16, 64, 0), (False, None, 64, 0),
    (False, 16, 64, 0),
    (True, None, 32, 32),       # the last 32 queries of 64 keys
    (True, 16, 32, -8),         # rows with no allowed key at all
])
def test_chunked_attention_forward_lse_and_grads_match_jax(causal, window,
                                                           sq, q_offset):
    q, k, v = _qkv(sq + (window or 0) + q_offset, 2, sq, 64, 4, 2, 16)
    rng = np.random.default_rng(99)
    cot = rng.standard_normal(q.shape).astype(np.float32)
    jargs = (causal, window, CHUNKED["q_chunk"], CHUNKED["kv_chunk"],
             q_offset)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    out = tattn.attention(tq, tk, tv, causal=causal, window=window,
                          q_offset=q_offset, **CHUNKED)
    assert out.grad_fn is not None and "FlashAttention" in \
        type(out.grad_fn).__name__
    want = jattn.attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                           window=window, q_offset=q_offset, **CHUNKED)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)
    _, lse = flash_fwd_ref(*map(torch.from_numpy, (q, k, v)), causal=causal,
                           window=window, q_offset=q_offset, q_chunk=16,
                           kv_chunk=16)
    jlse = jattn._flash_fwd(*map(jnp.asarray, (q, k, v)), causal, window,
                            16, 16, q_offset)[1]
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=TOL,
                               rtol=TOL)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(cot))
    _, vjp = jax.vjp(lambda a, b, c: jattn._flash_attention_xla(
        a, b, c, *jargs), *map(jnp.asarray, (q, k, v)))
    for name, got, jg in zip("qkv", grads, vjp(jnp.asarray(cot))):
        np.testing.assert_allclose(got.numpy(), np.asarray(jg), atol=TOL,
                                   rtol=TOL, err_msg=f"d{name}")


def test_dispatch_rule_is_the_reference_rule():
    """Direct at or below the threshold or off the chunk grid, chunked
    otherwise; both give the same values."""
    q, k, v = map(torch.from_numpy, _qkv(3, 1, 48, 48, 2, 1, 8))
    for kw, chunked in ((dict(direct_threshold=48, q_chunk=16,
                              kv_chunk=16), False),
                        (dict(direct_threshold=8, q_chunk=32, kv_chunk=16),
                         False),
                        (dict(direct_threshold=8, q_chunk=16, kv_chunk=32),
                         False),
                        (dict(direct_threshold=8, q_chunk=16, kv_chunk=16),
                         True)):
        out = tattn.attention(q.requires_grad_(True), k, v, **kw)
        assert ("FlashAttention" in type(out.grad_fn).__name__) == chunked
        np.testing.assert_allclose(
            out.detach().numpy(),
            tattn._direct_attention(q.detach(), k, v, True, None).numpy(),
            atol=TOL, rtol=TOL)


# ------------------------------------------------------------ (c) slice
def _llama(dtype="float32"):
    out = []
    for mod in (jcfg, tcfg):
        c = dataclasses.replace(mod.get_config("llama3.2-1b").reduced(),
                                dtype=dtype)
        out.append(c)
    return out


def test_reduced_llama_prefill_at_2048_matches_jax():
    jc, tc = _llama()
    jp = jinit(jc, jax.random.PRNGKey(11))
    tp = params_from_numpy(tc, jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    toks = np.random.default_rng(11).integers(
        0, jc.vocab_size, (2, LONG)).astype(np.int32)
    launches = flash_cuda.flash_attention_cuda.launches
    th, tcache = tprefill(tc, tp, torch.from_numpy(toks).long())
    jh, jcache = jprefill(jc, jp, jnp.asarray(toks))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL,
                               rtol=TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), atol=TOL,
                                   rtol=TOL, err_msg=name)
    # the CPU tensors ran the plain version, never the CUDA wrapper
    assert flash_cuda.flash_attention_cuda.launches == launches


def test_reduced_llama_loss_full_and_every_grad_at_2048_match_jax():
    jc, tc = _llama()
    jp = jinit(jc, jax.random.PRNGKey(12))
    tp = params_from_numpy(tc, jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    rng = np.random.default_rng(12)
    toks = rng.integers(0, jc.vocab_size, (1, LONG)).astype(np.int32)
    labels = rng.integers(0, jc.vocab_size, (1, LONG)).astype(np.int32)
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), tp)
    hidden = tforward(tc, leaves, torch.from_numpy(toks).long())["hidden"]
    loss = tloss_full(tc, leaves, hidden, torch.from_numpy(labels).long())
    flat = tree_leaves(leaves)
    it = iter(torch.autograd.grad(loss, flat))
    grads = tree_map(lambda _: next(it), leaves)

    def jloss(p):
        h = jforward(jc, p, jnp.asarray(toks))["hidden"]
        return jloss_full(jc, p, h, jnp.asarray(labels))

    jl, jg = jax.value_and_grad(jloss)(jp)
    np.testing.assert_allclose(float(loss.detach()), float(jl), atol=TOL,
                               rtol=TOL)
    a = params_to_numpy(tc, grads)
    b = jax.tree_util.tree_map(np.asarray, jg)
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for (path, x), y in zip(jax.tree_util.tree_leaves_with_path(a),
                            jax.tree_util.tree_leaves(b)):
        np.testing.assert_allclose(x, y, atol=TOL, rtol=TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_greedy_engine_after_a_2048_token_prompt_matches_jax():
    """The whole-prompt prefill of a 2048-token prompt takes the chunked
    path in both engines; greedy full-head tokens agree exactly."""
    jc, tc = (c.with_head(decode_temperature=0.0)
              .with_serve(max_slots=2, page_size=16, max_seq=LONG + 16)
              for c in _llama())
    jp = jinit(jc, jax.random.PRNGKey(13))
    tp = params_from_numpy(tc, jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, jc.vocab_size, size=n).astype(np.int32)
               for n in (LONG, LONG, 16)]
    shapes = list(zip(prompts, (6, 4, 5)))

    def reqs(mod):
        return [mod.Request(rid=i, tokens=p, max_new=n, seed=3)
                for i, (p, n) in enumerate(shapes)]

    jres = jserve.Engine(jc, jp, head="full").run(reqs(jserve))
    teng = tserve.Engine(tc, tp, head="full", device="cpu")
    tres = teng.run(reqs(tserve))
    for rid, (_, n) in enumerate(shapes):
        assert tres[rid].status == "ok"
        assert tres[rid].tokens.shape == (n,)
        np.testing.assert_array_equal(tres[rid].tokens, jres[rid].tokens,
                                      err_msg=f"rid {rid}")


def test_train_cli_at_2048_takes_the_chunked_path(monkeypatch):
    """`launch.train --arch llama3.2-1b --reduced --seq 2048 --batch 2`
    trains through the chunked path, on `train_loop`'s default corpus,
    the reference's at every length: max(512, 4 x 2) = 512 sequences of
    2049."""
    calls, drawn = [], []
    real_fa, real_sample = dispatch.flash_attention, train_cli.ZipfLM.sample

    def counting_fa(q, *a, **kw):
        calls.append(tuple(q.shape))
        return real_fa(q, *a, **kw)

    def recording_sample(self, n, seed=None):
        drawn.append((n, self.seq_len))
        return real_sample(self, n, seed)

    monkeypatch.setattr(dispatch, "flash_attention", counting_fa)
    monkeypatch.setattr(train_cli.ZipfLM, "sample", recording_sample)
    _, _, _, hist = train_cli.main(["--arch", "llama3.2-1b", "--reduced",
                                    "--device", "cpu", "--seq", str(LONG),
                                    "--batch", "2", "--steps", "2"])
    assert drawn == [(512, LONG + 1)]
    assert len(calls) == 2 * 2 and set(calls) == {(2, LONG, 4, 16)}
    assert np.all(np.isfinite(hist))


# ---------------------------------------------------------- (d) dispatch
def test_dispatch_by_device_and_what_the_function_saves():
    q, k, v = map(torch.from_numpy, _qkv(5, 1, 64, 64, 4, 2, 8))
    kw = dict(causal=True, window=None, q_offset=0, q_chunk=16, kv_chunk=32)
    launches = flash_cuda.flash_attention_cuda.launches
    out, lse = dispatch.flash_attention(q, k, v, **kw)
    want = flash_fwd_ref(q, k, v, **kw)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    assert flash_cuda.flash_attention_cuda.launches == launches
    with pytest.raises(RuntimeError, match="no implementation for meta"):
        dispatch.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"),
                                 **kw)
    with pytest.raises(ValueError, match="CUDA"):
        flash_cuda.flash_attention_cuda(q, k, v, causal=True, window=None,
                                        q_offset=0)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    qg = q.clone().requires_grad_(True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = FlashAttentionFn.apply(qg, k, v, True, None, 16, 32, 0)
    assert sorted(saved) == sorted([tuple(q.shape), tuple(k.shape),
                                    tuple(v.shape), tuple(q.shape),
                                    (1, 2, 2, 64)])
    out.sum().backward()
    assert qg.grad.shape == q.shape
