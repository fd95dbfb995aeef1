"""Card-only checks of the torch port: the CUDA midx_probs, per-token and
shared-negative sampled-CE, RFF sampling, flash-attention and SSD-scan
kernels against their plain versions, the engine on the card, short
training runs through the kernels of the per-token, the pooled and the
rff-fused heads and of mamba2, the chunked attention's backward on the
card against the CPU, the index lifecycle's overlapped refresh and
mid-stream swap, and the fused MIDX head route against the unfused one on
the same draws. This
file imports no JAX, so it runs on a machine that has a card and no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Without a CUDA device every test here skips."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.midx_probs.ref import midx_probs_ref


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel runs only on a card")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("kind", ["pq", "rq"])
def test_cuda_kernel_matches_plain_version(kind):
    _need_card()
    from repro_torch.kernels.midx_probs.cuda import midx_probs_cuda
    for t, d, k in ((1, 200, 32), (33, 2048, 64), (130, 16, 8), (0, 16, 8),
                    (1024, 200, 32)):
        g = torch.Generator(device="cuda").manual_seed(t)
        dc = d // 2 if kind == "pq" else d
        z = torch.randn((t, d), generator=g, device="cuda")
        cb1 = 0.1 * torch.randn((k, dc), generator=g, device="cuda")
        cb2 = 0.1 * torch.randn((k, dc), generator=g, device="cuda")
        cnt = torch.randint(0, 3, (k, k), generator=g, device="cuda").float()
        got = midx_probs_cuda(z, cb1, cb2, cnt, split=kind == "pq")
        want = midx_probs_ref(z, cb1, cb2, cnt, split=kind == "pq")
        for a, b in zip(got, want):
            assert a.shape == b.shape
            assert torch.all((a - b).abs() <= 1e-4 * b.abs().clamp(min=1))


@pytest.mark.parametrize("kind", ["pq", "rq"])
def test_cuda_kernel_rows_do_not_depend_on_t(kind):
    """A row's outputs are the same bits alone (T = 1) as inside calls of
    T = 4, 8, 33 and 512 rows (the kernel slices the products by D alone),
    and the 16-byte and plain-load routes (z off a 16-byte boundary) give
    the same bits."""
    _need_card()
    from repro_torch.kernels.midx_probs.cuda import midx_probs_cuda
    for d, k in ((200, 32), (2048, 64)):
        g = torch.Generator(device="cuda").manual_seed(d)
        dc = d // 2 if kind == "pq" else d
        z = torch.randn((512, d), generator=g, device="cuda")
        cb1 = 0.1 * torch.randn((k, dc), generator=g, device="cuda")
        cb2 = 0.1 * torch.randn((k, dc), generator=g, device="cuda")
        cnt = torch.randint(0, 3, (k, k), generator=g, device="cuda").float()
        outs = {t: midx_probs_cuda(z[:t], cb1, cb2, cnt, split=kind == "pq")
                for t in (4, 8, 33, 512)}
        for r in (0, 3, 7, 32, 511):
            solo = midx_probs_cuda(z[r:r + 1], cb1, cb2, cnt,
                                   split=kind == "pq")
            for t, got in outs.items():
                if r < t:
                    assert all(torch.equal(a[0], b[r])
                               for a, b in zip(solo, got)), (d, r, t)
        shifted = torch.empty(512 * d + 1, device="cuda")[1:].view(512, d)
        shifted.copy_(z)
        plain = midx_probs_cuda(shifted, cb1, cb2, cnt, split=kind == "pq")
        assert all(torch.equal(a, b) for a, b in zip(plain, outs[512]))


def test_cuda_kernel_rejects_what_it_cannot_take():
    _need_card()
    from repro_torch.kernels.midx_probs.cuda import midx_probs_cuda
    z = torch.randn((4, 16), device="cuda")
    cb = torch.randn((8, 16), device="cuda")
    cnt = torch.ones((8, 8), device="cuda")
    with pytest.raises(ValueError):
        midx_probs_cuda(z.cpu(), cb, cb, cnt, split=False)
    with pytest.raises(ValueError):
        midx_probs_cuda(z.double(), cb, cb, cnt, split=False)
    with pytest.raises(ValueError):
        midx_probs_cuda(z, cb[:, :8], cb[:, :8], cnt, split=False)
    big = torch.randn((65, 16), device="cuda")
    with pytest.raises(ValueError, match="K <="):
        midx_probs_cuda(z, big, big, torch.ones((65, 65), device="cuda"),
                        split=False)


def _bwd_case(t, d, k, split, fmt, seed):
    """The backward's inputs on the card: the forward kernel's outputs at
    random z, codebooks (fp32, or int8 / fp8 with [K] scales) and counts
    with row 1 zeroed (its psi floored), and random cotangents."""
    from repro_torch.index.quantized import quantize_rows
    from repro_torch.kernels.midx_probs.cuda import midx_probs_cuda
    g = torch.Generator(device="cuda").manual_seed(seed)
    dc = d // 2 if split else d
    z = torch.randn((t, d), generator=g, device="cuda")
    cbs = [0.1 * torch.randn((k, dc), generator=g, device="cuda")
           for _ in range(2)]
    kw = {"split": split}
    if fmt != "fp32":
        (q1, s1), (q2, s2) = (quantize_rows(c, fmt) for c in cbs)
        cbs = [q1, q2]
        kw.update(scale1=s1.reshape(-1), scale2=s2.reshape(-1))
    cnt = torch.randint(0, 3, (k, k), generator=g, device="cuda").float()
    cnt[1] = 0
    out = midx_probs_cuda(z, *cbs, cnt, **kw)
    cot = [torch.randn(x.shape, generator=g, device="cuda") for x in out]
    return z, out, cot, cbs, cnt, kw


@pytest.mark.parametrize("fmt", ["fp32", "int8", "fp8"])
@pytest.mark.parametrize("kind", ["pq", "rq"])
def test_cuda_backward_matches_plain_version(kind, fmt):
    """The backward kernel (dz, and ds for d(codebooks)) within
    1e-5·max(1, |plain|) of its plain closed form, finite with a zeroed
    row of counts, bitwise repeatable, and a row alone equal to that row
    inside the call; T = 0 launches nothing."""
    _need_card()
    from repro_torch.kernels.midx_probs.cuda import midx_probs_bwd_cuda
    from repro_torch.kernels.midx_probs.ref import midx_probs_bwd_ref
    for t, d, k in ((1, 200, 32), (33, 2048, 64), (130, 20, 8),
                    (1024, 200, 32), (0, 16, 8)):
        z, out, cot, cbs, cnt, kw = _bwd_case(t, d, k, kind == "pq", fmt,
                                              seed=t + d)
        got = midx_probs_bwd_cuda(*out, *cot, *cbs, cnt, with_ds=True, **kw)
        want = midx_probs_bwd_ref(*out, *cot, *cbs, cnt, with_ds=True, **kw)
        for a, b in zip(got, want):
            assert a.shape == b.shape and torch.isfinite(a).all()
            assert torch.all((a - b).abs() <= 1e-5 * b.abs().clamp(min=1))
        again = midx_probs_bwd_cuda(*out, *cot, *cbs, cnt, with_ds=True,
                                    **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        if t:
            solo = midx_probs_bwd_cuda(*(x[t - 1:] for x in out),
                                       *(x[t - 1:] for x in cot), *cbs, cnt,
                                       with_ds=True, **kw)
            assert all(torch.equal(a[0], b[t - 1]) for a, b in zip(solo, got))


def test_tables_backward_on_the_card_launches_the_kernel(monkeypatch):
    """`proposal_tables` / `proposal_tables_q` on CUDA tensors: the backward
    launches the kernel once a call and runs neither the plain forward nor
    torch.autograd.grad; a refused launch raises."""
    _need_card()
    from repro_torch.index.build import MultiIndex
    from repro_torch.index.quantized import quantize_rows
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.midx_probs import cuda
    from repro_torch.kernels.midx_probs.ops import (proposal_tables,
                                                    proposal_tables_q)
    z, _, _, (cb1, cb2), cnt, _ = _bwd_case(64, 200, 32, False, "fp32", 3)
    e = torch.empty(0, dtype=torch.long, device="cuda")
    idx = MultiIndex("rq", cb1, cb2, e, e, e, e, e, cnt.long(),
                     torch.log(cnt))

    def refuse(*a, **kw):
        raise AssertionError("recomputed")

    monkeypatch.setattr(dispatch, "midx_probs_ref", refuse)
    monkeypatch.setattr(torch.autograd, "grad", refuse)
    (q1, s1), (q2, s2) = (quantize_rows(c, "int8") for c in (cb1, cb2))
    for fn in (lambda zz: proposal_tables(idx, zz),
               lambda zz: proposal_tables_q(idx, q1, s1, q2, s2, zz)):
        zl = z.clone().requires_grad_(True)
        before = cuda.midx_probs_bwd_cuda.launches
        fn(zl)[3].sum().backward()
        torch.cuda.synchronize()
        assert cuda.midx_probs_bwd_cuda.launches == before + 1
        assert torch.isfinite(zl.grad).all()
    assert cuda.midx_probs_bwd_cuda.quant_launches["int8"] >= 1
    with pytest.raises(ValueError):
        cuda.midx_probs_bwd_cuda(*(torch.zeros((4, 32), device="cuda"),) * 3,
                                 torch.zeros(4, device="cuda"),
                                 *(torch.zeros((4, 32), device="cuda"),) * 3,
                                 torch.zeros(4, device="cuda").double(),
                                 cb1, cb2, cnt, split=False)


def test_engine_on_the_card_goes_through_the_kernel():
    _need_card()
    from repro_torch.kernels.midx_probs.cuda import midx_probs_cuda
    from repro_torch.serve import Engine, Request
    cfg = get_config("paper-lm").with_serve(max_slots=3, page_size=4,
                                            max_seq=20)
    eng = Engine(cfg, head="midx")            # the default device: the card
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, tokens=rng.integers(0, cfg.vocab_size, size=p)
                    .astype(np.int32), max_new=n, seed=3)
            for i, (p, n) in enumerate([(6, 5), (9, 7), (6, 3), (11, 6)])]
    before = midx_probs_cuda.launches
    res = eng.run(reqs)
    assert midx_probs_cuda.launches > before
    for r in reqs:
        assert res[r.rid].status == "ok"
        np.testing.assert_array_equal(res[r.rid].tokens,
                                      eng.replay_single(r))


def _sce_inputs(t, d, m, v, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.randn((t, d), generator=g, device="cuda")
    tab = (0.2 * torch.randn((v, d), generator=g, device="cuda")).to(dtype)
    lq = -5.0 + torch.randn((t, m), generator=g, device="cuda")
    neg = torch.randint(0, v, (t, m), generator=g, device="cuda")
    pos = torch.randint(0, v, (t,), generator=g, device="cuda")
    if m > 3:
        neg[:, 1] = neg[:, 0]                    # duplicate within a row
        neg[::2, 2] = pos[::2]                   # collision with the positive
    return h, tab, lq, neg, pos, torch.rand((t,), generator=g, device="cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sampled_ce_kernels_match_plain_version(dtype):
    """Forward and backward within 1e-4·max(1, |plain|); the backward
    bitwise repeatable; ragged T and M, D with and without 16-byte
    vectors, and V smaller than M (every row drawn many times)."""
    _need_card()
    from repro_torch.kernels.sampled_ce.cuda import (sampled_ce_pt_bwd_cuda,
                                                     sampled_ce_pt_cuda)
    from repro_torch.kernels.sampled_ce.ref import (sampled_ce_pt_bwd_ref,
                                                    sampled_ce_pt_fwd_ref)
    for t, d, m, v in ((1, 200, 20, 10000), (37, 24, 13, 7), (130, 30, 9, 50),
                       (64, 2048, 64, 5000), (0, 16, 4, 10),
                       (1024, 200, 20, 10000)):
        h, tab, lq, neg, pos, g = _sce_inputs(t, d, m, v, dtype, seed=t + d)
        got_f = sampled_ce_pt_cuda(h, tab, lq, neg, pos)
        want_f = sampled_ce_pt_fwd_ref(h, tab, lq, neg, pos)
        got_b = sampled_ce_pt_bwd_cuda(g, h, tab, lq, neg, pos, got_f[1])
        again = sampled_ce_pt_bwd_cuda(g, h, tab, lq, neg, pos, got_f[1])
        want_b = sampled_ce_pt_bwd_ref(g, h, tab, lq, neg, pos, want_f[1])
        torch.cuda.synchronize()
        for a, b in zip((*got_f, *got_b), (*want_f, *want_b)):
            assert a.shape == b.shape
            assert torch.all((a - b).abs() <= 1e-4 * b.abs().clamp(min=1))
        assert all(torch.equal(a, b) for a, b in zip(got_b, again))


def _hold_pt_bwd(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        scale = min(1.0, float(b.abs().max()))
        assert torch.all((a - b).abs()
                         <= 1e-4 * b.abs().clamp(min=max(scale, 1e-30)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sampled_ce_bwd_with_one_hot_row(dtype):
    """One id takes about half of all occurrences (every other negative
    from column 3 on, every other positive): the long segment that the
    d(table) reduction sorts through its bitmap and splits over warps. Held
    to the plain version and bitwise repeatable."""
    _need_card()
    from repro_torch.kernels.sampled_ce.cuda import (sampled_ce_pt_bwd_cuda,
                                                     sampled_ce_pt_cuda)
    from repro_torch.kernels.sampled_ce.ref import (sampled_ce_pt_bwd_ref,
                                                    sampled_ce_pt_fwd_ref)
    for t, d, m, v in ((1024, 200, 20, 10000), (96, 64, 20, 500),
                       (300, 30, 9, 50)):
        h, tab, lq, neg, pos, g = _sce_inputs(t, d, m, v, dtype, seed=t)
        neg[:, 3::2] = 7
        pos[1::2] = 7
        _, lse = sampled_ce_pt_cuda(h, tab, lq, neg, pos)
        got = sampled_ce_pt_bwd_cuda(g, h, tab, lq, neg, pos, lse)
        again = sampled_ce_pt_bwd_cuda(g, h, tab, lq, neg, pos, lse)
        want = sampled_ce_pt_bwd_ref(g, h, tab, lq, neg, pos,
                                     sampled_ce_pt_fwd_ref(h, tab, lq, neg,
                                                           pos)[1])
        torch.cuda.synchronize()
        assert int(torch.bincount(torch.cat([neg.reshape(-1), pos]))[7]) \
            > t * (m + 1) // 3
        _hold_pt_bwd(got, want)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sampled_ce_bwd_load_routes_hold(dtype):
    """`bwd_rows_kernel`'s 16-byte-vector route at several widths, and its
    scalar route (D not a multiple of the vector, or an unaligned table),
    each held to the plain version and bitwise repeatable."""
    _need_card()
    from repro_torch.kernels.sampled_ce import cuda as sce
    from repro_torch.kernels.sampled_ce.ref import sampled_ce_pt_bwd_ref
    for t, d, m, v in ((1024, 200, 20, 10000), (37, 64, 13, 7),
                       (130, 128, 64, 300), (5, 16, 1, 10)):
        h, tab, lq, neg, pos, g = _sce_inputs(t, d, m, v, dtype, seed=d + m)
        _, lse = sce.sampled_ce_pt_cuda(h, tab, lq, neg, pos)
        got = sce.sampled_ce_pt_bwd_cuda(g, h, tab, lq, neg, pos, lse)
        again = sce.sampled_ce_pt_bwd_cuda(g, h, tab, lq, neg, pos, lse)
        want = sampled_ce_pt_bwd_ref(g, h, tab, lq, neg, pos, lse)
        torch.cuda.synchronize()
        _hold_pt_bwd(got, want)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    h, tab, lq, neg, pos, g = _sce_inputs(64, 30, 9, 50, dtype, seed=3)
    shifted = torch.empty(tab.numel() + 1, dtype=dtype,
                          device="cuda")[1:].view(tab.shape)
    shifted.copy_(tab)
    for table in (tab, shifted):               # D = 30: no vectors
        _, lse = sce.sampled_ce_pt_cuda(h, table, lq, neg, pos)
        got = sce.sampled_ce_pt_bwd_cuda(g, h, table, lq, neg, pos, lse)
        _hold_pt_bwd(got, sampled_ce_pt_bwd_ref(g, h, table, lq, neg, pos,
                                                lse))


def _hold_pt_fwd(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        assert torch.all((a - b).abs() <= 1e-4 * b.abs().clamp(min=1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sampled_ce_fwd_routes_hold(dtype):
    """The forward against its plain version, bitwise repeatable, on each
    route: the ring of bulk copies (all of a token's rows in one flight; a
    ring that refills its stages, M = 64 at D = 128 and 2048), and the
    plain-load kernel (D not a multiple of the vector, a table off a
    16-byte boundary, a stage too large for shared memory at D = 8192
    fp32); M = 1, JG = 8, JG + 1 and 64; T = 1 and 1024."""
    _need_card()
    from repro_torch.kernels.sampled_ce.cuda import sampled_ce_pt_cuda
    from repro_torch.kernels.sampled_ce.ref import sampled_ce_pt_fwd_ref
    for t, d, m, v in ((1024, 200, 20, 10000), (1, 200, 20, 10000),
                       (33, 64, 1, 50), (40, 64, 8, 100), (40, 64, 9, 100),
                       (130, 128, 64, 300), (64, 2048, 64, 5000),
                       (1024, 2048, 64, 128256), (5, 8192, 20, 100),
                       (37, 30, 13, 7), (1, 30, 64, 90), (0, 16, 4, 10)):
        h, tab, lq, neg, pos, _ = _sce_inputs(t, d, m, v, dtype, seed=d + m)
        got = sampled_ce_pt_cuda(h, tab, lq, neg, pos)
        again = sampled_ce_pt_cuda(h, tab, lq, neg, pos)
        want = sampled_ce_pt_fwd_ref(h, tab, lq, neg, pos)
        torch.cuda.synchronize()
        _hold_pt_fwd(got, want)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    h, tab, lq, neg, pos, _ = _sce_inputs(64, 64, 20, 50, dtype, seed=5)
    shifted = torch.empty(tab.numel() + 1, dtype=dtype,
                          device="cuda")[1:].view(tab.shape)
    shifted.copy_(tab)                          # D = 64, unaligned rows
    got = sampled_ce_pt_cuda(h, shifted, lq, neg, pos)
    again = sampled_ce_pt_cuda(h, shifted, lq, neg, pos)
    _hold_pt_fwd(got, sampled_ce_pt_fwd_ref(h, shifted, lq, neg, pos))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sampled_ce_fwd_rows_do_not_depend_on_t(dtype):
    """A token's loss and lse alone (T = 1), and inside a call of 7 tokens,
    are bit for bit those it gets in a call of T = 1024."""
    _need_card()
    from repro_torch.kernels.sampled_ce.cuda import sampled_ce_pt_cuda
    for d, m, v in ((200, 20, 10000), (2048, 64, 128256), (30, 13, 50)):
        h, tab, lq, neg, pos, _ = _sce_inputs(1024, d, m, v, dtype, seed=m)
        full = sampled_ce_pt_cuda(h, tab, lq, neg, pos)
        for r in (0, 1, 2, 500, 1023):
            solo = sampled_ce_pt_cuda(h[r:r + 1], tab, lq[r:r + 1],
                                      neg[r:r + 1], pos[r:r + 1])
            assert all(torch.equal(a[0], b[r]) for a, b in zip(solo, full))
        part = sampled_ce_pt_cuda(h[9:16], tab, lq[9:16], neg[9:16],
                                  pos[9:16])
        assert all(torch.equal(a, b[9:16]) for a, b in zip(part, full))


def test_sampled_ce_kernels_reject_what_they_cannot_take():
    _need_card()
    from repro_torch.kernels.sampled_ce.cuda import sampled_ce_pt_cuda
    h, tab, lq, neg, pos, _ = _sce_inputs(4, 16, 5, 20, torch.float32, 0)
    with pytest.raises(ValueError, match="int64"):
        sampled_ce_pt_cuda(h, tab, lq, neg.int(), pos)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        sampled_ce_pt_cuda(h, tab.half(), lq, neg, pos)
    with pytest.raises(ValueError, match="bad shapes"):
        sampled_ce_pt_cuda(h, tab[:, :8].contiguous(), lq, neg, pos)
    with pytest.raises(ValueError, match="contiguous"):
        sampled_ce_pt_cuda(h, tab, lq.t().contiguous().t(), neg, pos)


def test_training_on_the_card_goes_through_all_three_kernels():
    _need_card()
    from repro_torch.kernels.midx_probs.cuda import midx_probs_cuda
    from repro_torch.kernels.sampled_ce.cuda import (sampled_ce_pt_bwd_cuda,
                                                     sampled_ce_pt_cuda)
    from repro_torch.launch.train import train_loop
    from repro_torch.serve import Engine, Request
    counters = (midx_probs_cuda, sampled_ce_pt_cuda, sampled_ce_pt_bwd_cuda)
    before = [c.launches for c in counters]
    cfg = get_config("paper-lm").with_serve(max_slots=2, page_size=4,
                                            max_seq=16)
    params, _, index, hist = train_loop(cfg, steps=6, batch_size=4,
                                        seq_len=16, lr=3e-3,
                                        refresh_every=3)
    assert all(c.launches > b for c, b in zip(counters, before))
    assert np.all(np.isfinite(hist))
    eng = Engine(cfg, params, index=index, head="midx")
    req = Request(rid=0, tokens=np.arange(5, dtype=np.int32), max_new=4,
                  seed=1)
    res = eng.run([req])
    np.testing.assert_array_equal(res[0].tokens, eng.replay_single(req))


def _shared_inputs(b, s, m, d, v, dtype, seed):
    """Shared-negative CE inputs on the card: duplicate negatives, negatives
    that collide with positives, and a token all of whose negatives
    collide (sequence 0, token 0)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.randn((b, s, d), generator=g, device="cuda")
    tab = (0.2 * torch.randn((v, d), generator=g, device="cuda")).to(dtype)
    lq = -5.0 + torch.randn((b, m), generator=g, device="cuda")
    neg = torch.randint(0, v, (b, m), generator=g, device="cuda")
    pos = torch.randint(0, v, (b, s), generator=g, device="cuda")
    if m > 2 and s > 0:
        neg[:, 1] = neg[:, 0]                    # duplicates
        neg[:, 2] = pos[:, -1]                   # collisions
        neg[0] = pos[0, 0]                       # every negative collides
    return (h, tab[pos].contiguous(), tab[neg].contiguous(), lq, neg, pos,
            torch.rand((b, s), generator=g, device="cuda"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shared_sampled_ce_kernels_match_plain_version(dtype):
    """Forward and the backward's kernels within 1e-4·max(1, |plain|); both
    bitwise repeatable, and each sequence of a batch equal to that sequence
    alone; the all-colliding token's loss exactly 0; ragged S, M and D (S and M off the backward's 64-row
    tiles, D = 200 and 30 off its 64-column tiles, D = 30 also off the
    16-byte loads), and an empty S."""
    _need_card()
    from repro_torch.kernels.sampled_ce.cuda import (sampled_ce_bwd_cuda,
                                                     sampled_ce_cuda)
    from repro_torch.kernels.sampled_ce.ref import (sampled_ce_bwd_ref,
                                                    sampled_ce_fwd_ref)
    for b, s, m, d, v in ((1, 1, 20, 200, 10000), (2, 7, 13, 30, 9),
                          (3, 70, 130, 2048, 5000), (2, 256, 1024, 200, 10000),
                          (2, 100, 70, 200, 5000), (1, 0, 8, 16, 20)):
        h, pe, ne, lq, neg, pos, g = _shared_inputs(b, s, m, d, v, dtype,
                                                    seed=s + m + d)
        got_f = sampled_ce_cuda(h, pe, ne, lq, neg, pos)
        again_f = sampled_ce_cuda(h, pe, ne, lq, neg, pos)
        want_f = sampled_ce_fwd_ref(h, pe, ne, lq, neg, pos)
        got_b = sampled_ce_bwd_cuda(g, h, pe, ne, lq, neg, pos, got_f[1])
        again = sampled_ce_bwd_cuda(g, h, pe, ne, lq, neg, pos, got_f[1])
        want_b = sampled_ce_bwd_ref(g, h, pe, ne, lq, neg, pos, want_f[1])
        torch.cuda.synchronize()
        for a, w in zip((*got_f, *got_b), (*want_f, *want_b)):
            assert a.shape == w.shape
            assert torch.all((a - w).abs() <= 1e-4 * w.abs().clamp(min=1))
        assert all(torch.equal(a, w) for a, w in zip(got_b, again))
        assert all(torch.equal(a, w) for a, w in zip(got_f, again_f))
        if s > 0 and m > 2:             # the all-colliding token
            assert float(got_f[0][0, 0]) == 0.0
        for row in range(b if b > 1 else 0):
            one = [t[row:row + 1].contiguous()
                   for t in (g, h, pe, ne, lq, neg, pos, got_f[1])]
            solo = sampled_ce_bwd_cuda(*one)
            assert all(torch.equal(a[0], w[row])
                       for a, w in zip(solo, got_b))
            solo_f = sampled_ce_cuda(*one[1:7])
            assert all(torch.equal(a[0], w[row])
                       for a, w in zip(solo_f, got_f))


def test_shared_sampled_ce_kernels_reject_what_they_cannot_take():
    _need_card()
    from repro_torch.kernels.sampled_ce.cuda import (sampled_ce_bwd_cuda,
                                                     sampled_ce_cuda)
    h, pe, ne, lq, neg, pos, g = _shared_inputs(2, 4, 5, 16, 20,
                                                torch.float32, 0)
    with pytest.raises(ValueError, match="CUDA device"):
        sampled_ce_cuda(h.cpu(), pe, ne, lq, neg, pos)
    with pytest.raises(ValueError, match="int64"):
        sampled_ce_cuda(h, pe, ne, lq, neg.int(), pos)
    with pytest.raises(ValueError, match="both fp32 or both bf16"):
        sampled_ce_cuda(h, pe, ne.bfloat16(), lq, neg, pos)
    with pytest.raises(ValueError, match="both fp32 or both bf16"):
        sampled_ce_cuda(h, pe.half(), ne.half(), lq, neg, pos)
    with pytest.raises(ValueError, match="bad shapes"):
        sampled_ce_cuda(h, pe, ne[:, :, :8].contiguous(), lq, neg, pos)
    with pytest.raises(ValueError, match="contiguous"):
        sampled_ce_cuda(h.transpose(0, 1).contiguous().transpose(0, 1), pe,
                        ne, lq, neg, pos)
    with pytest.raises(ValueError, match="fp32"):
        sampled_ce_bwd_cuda(g.double(), h, pe, ne, lq, neg, pos, g)
    with pytest.raises(ValueError, match="M >= 1"):
        sampled_ce_cuda(h, pe, ne[:, :0].contiguous(), lq[:, :0].contiguous(),
                        neg[:, :0].contiguous(), pos)


def test_pooled_llama_train_step_goes_through_the_shared_kernels():
    _need_card()
    import dataclasses
    from repro_torch.kernels.sampled_ce.cuda import (sampled_ce_bwd_cuda,
                                                     sampled_ce_cuda)
    from repro_torch.launch.train import train_loop
    cfg = dataclasses.replace(get_config("llama3.2-1b"), num_layers=2)
    assert cfg.head.proposal == "pooled"
    corpus = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 65)).astype(np.int32)
    before = sampled_ce_cuda.launches, sampled_ce_bwd_cuda.launches
    _, _, _, hist = train_loop(cfg, steps=2, batch_size=2, seq_len=64,
                               corpus=corpus, log_every=1000)
    assert sampled_ce_cuda.launches > before[0]
    assert sampled_ce_bwd_cuda.launches > before[1]
    assert np.all(np.isfinite(hist))


RFF_SHAPES = ((8, 128, 64, 16), (13, 200, 32, 5), (1, 64, 16, 3),
              (20, 130, 64, 17),                # the reference's sweep
              (4, 128256, 64, 64),               # serving llama3.2-1b
              (1024, 10000, 64, 20),             # paper-lm per-token training
              (4, 128256, 64, 1024))             # llama3.2-1b pooled training


def _rff_inputs(t, n, r2, form, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    pz = 0.3 * torch.rand((t, r2), generator=g, device="cuda")
    pc = torch.rand((n, r2), generator=g, device="cuda")
    if form == "reference":              # one seed, rows counted 0..T-1
        seeds = torch.full((t,), 7, dtype=torch.int64, device="cuda")
        t_ids = torch.arange(t, device="cuda")
    else:                                # each row its own key, counter 0
        seeds = torch.randint(0, 2**32, (t,), generator=g, device="cuda")
        t_ids = torch.zeros(t, dtype=torch.int64, device="cuda")
    return pz, pc, seeds, t_ids


@pytest.mark.parametrize("form", ["reference", "rows"])
def test_rff_sample_kernel_matches_plain_version(form):
    """ids equal to the plain version's except at near-ties of the
    perturbed values (|v_kernel − v_plain| <= 1e-5·max(1, |v_plain|));
    log_q within 1e-5·max(1, |plain|) of the plain log q of the drawn id;
    bitwise repeatable."""
    _need_card()
    from repro_torch.kernels.rff_sample.cuda import rff_sample_cuda
    from repro_torch.kernels.rff_sample.ref import (perturbed_values,
                                                    rff_gumbel_ref,
                                                    rff_scores)
    for t, n, r2, m in RFF_SHAPES:
        pz, pc, seeds, t_ids = _rff_inputs(t, n, r2, form, seed=t + n)
        before = rff_sample_cuda.launches
        ids, lq = rff_sample_cuda(pz, pc, seeds, t_ids, m)
        again = rff_sample_cuda(pz, pc, seeds, t_ids, m)
        want_ids, _, lse = rff_gumbel_ref(pz, pc, seeds, t_ids, m)
        torch.cuda.synchronize()
        assert rff_sample_cuda.launches == before + 2
        assert torch.equal(ids, again[0]) and torch.equal(lq, again[1])
        assert ids.dtype == torch.int32 and tuple(ids.shape) == (t, m)
        assert bool(((ids >= 0) & (ids < n)).all())
        logits = rff_scores(pz, pc)
        a = perturbed_values(logits, seeds, t_ids, ids)
        b = perturbed_values(logits, seeds, t_ids, want_ids)
        near = (a - b).abs() <= 1e-5 * b.abs().clamp(min=1)
        assert bool(((ids == want_ids) | near).all())
        want_lq = torch.gather(logits, 1, ids.long()) - lse[:, None]
        assert torch.all((lq - want_lq).abs()
                         <= 1e-5 * want_lq.abs().clamp(min=1))


def test_rff_sample_kernel_on_equal_logits():
    """φ(C) holds each of 50 rows 40 times over (N = 2000, four chunks), and
    φ(z) of row 0 is 0, so that every logit of the row is log 1e-8: many
    columns share a logit and only the noise (and, on an exact tie, the
    minimum column) decides. The draws equal the plain version's but at
    near-ties, at most 1e-3 of them; log q holds."""
    _need_card()
    from repro_torch.kernels.rff_sample.cuda import rff_sample_cuda
    from repro_torch.kernels.rff_sample.ref import (perturbed_values,
                                                    rff_gumbel_ref,
                                                    rff_scores)
    pz, pc, seeds, t_ids = _rff_inputs(16, 50, 64, "rows", seed=11)
    pc = pc.repeat(40, 1).contiguous()
    pz[0] = 0.0
    ids, lq = rff_sample_cuda(pz, pc, seeds, t_ids, 256)
    want, _, lse = rff_gumbel_ref(pz, pc, seeds, t_ids, 256)
    torch.cuda.synchronize()
    logits = rff_scores(pz, pc)
    a = perturbed_values(logits, seeds, t_ids, ids)
    b = perturbed_values(logits, seeds, t_ids, want)
    same = ids == want
    assert bool((same | ((a - b).abs() <= 1e-5 * b.abs().clamp(min=1))).all())
    assert float((~same).float().mean()) <= 1e-3
    want_lq = torch.gather(logits, 1, ids.long()) - lse[:, None]
    assert torch.all((lq - want_lq).abs() <= 1e-5 * want_lq.abs().clamp(min=1))


@pytest.mark.parametrize("m", [20, 64, 1024])
def test_rff_sample_rows_do_not_depend_on_t(m):
    """Each row of a T = 4, 8 and 33 call is, bit for bit, that row drawn
    alone (T = 1): the chunks, the blocks' draws and the merge's order
    follow N and m alone."""
    _need_card()
    from repro_torch.kernels.rff_sample.cuda import rff_sample_cuda
    pz, pc, seeds, t_ids = _rff_inputs(33, 5000, 64, "rows", seed=m)
    outs = {t: rff_sample_cuda(pz[:t].contiguous(), pc, seeds[:t].contiguous(),
                               t_ids[:t].contiguous(), m) for t in (4, 8, 33)}
    for r in (0, 3, 7, 32):
        solo = rff_sample_cuda(pz[r:r + 1].contiguous(), pc,
                               seeds[r:r + 1].contiguous(),
                               t_ids[r:r + 1].contiguous(), m)
        for t, got in outs.items():
            if r < t:
                assert torch.equal(got[0][r], solo[0][0]), (m, r, t)
                assert torch.equal(got[1][r], solo[1][0]), (m, r, t)


def test_rff_sample_kernel_rejects_what_it_cannot_take():
    _need_card()
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.rff_sample.cuda import rff_sample_cuda
    pz, pc, seeds, t_ids = _rff_inputs(4, 50, 64, "rows", 0)
    with pytest.raises(ValueError, match="CUDA device"):
        rff_sample_cuda(pz.cpu(), pc, seeds, t_ids, 3)
    with pytest.raises(ValueError, match="fp32"):
        rff_sample_cuda(pz.double(), pc, seeds, t_ids, 3)
    with pytest.raises(ValueError, match="int64"):
        rff_sample_cuda(pz, pc, seeds.int(), t_ids, 3)
    with pytest.raises(ValueError, match="bad shapes"):
        rff_sample_cuda(pz, pc[:, :32].contiguous(), seeds, t_ids, 3)
    with pytest.raises(ValueError, match="contiguous"):
        rff_sample_cuda(pz.t().contiguous().t(), pc, seeds, t_ids, 3)
    with pytest.raises(ValueError, match="R2 <="):
        big = torch.rand((4, 300), device="cuda")
        rff_sample_cuda(big, torch.rand((50, 300), device="cuda"), seeds,
                        t_ids, 3)
    before = rff_sample_cuda.launches      # a CUDA tensor reaches the kernel
    dispatch.rff_sample(pz, pc, seeds, t_ids, 3)
    assert rff_sample_cuda.launches == before + 1


def test_rff_fused_serving_and_training_go_through_the_kernel():
    _need_card()
    from repro_torch.kernels.rff_sample.cuda import rff_sample_cuda
    from repro_torch.launch.train import train_loop
    from repro_torch.serve import Engine, Request
    cfg = get_config("paper-lm").with_head(mode="rff-fused").with_serve(
        max_slots=2, page_size=4, max_seq=16)
    before = rff_sample_cuda.launches
    params, _, state, hist = train_loop(cfg, steps=6, batch_size=4,
                                        seq_len=16, lr=3e-3, refresh_every=3)
    assert rff_sample_cuda.launches > before and np.all(np.isfinite(hist))
    eng = Engine(cfg, params, index=state, head="rff-fused")
    reqs = [Request(rid=i, tokens=np.arange(3 + i, dtype=np.int32),
                    max_new=4, seed=1) for i in range(3)]
    before = rff_sample_cuda.launches
    res = eng.run(reqs)
    assert rff_sample_cuda.launches > before
    for r in reqs:
        np.testing.assert_array_equal(res[r.rid].tokens, eng.replay_single(r))


FLASH_SHAPES = (   # B, Sq, Sk, H, KV, hd, dtype, causal, window, q_offset
    (2, 128, 128, 4, 4, 50, torch.float32, True, None, 0),
    (2, 384, 384, 6, 3, 64, torch.bfloat16, False, 16, 0),
    (1, 1024, 1024, 2, 1, 128, torch.float32, True, 16, 0),
    (2, 512, 2048, 32, 8, 64, torch.bfloat16, True, None, 1536),
    (1, 384, 384, 6, 3, 64, torch.float32, True, 16, -100),  # rows with no
    (4, 2048, 2048, 32, 8, 64, torch.bfloat16, True, None, 0),  # allowed key
    (2, 256, 256, 6, 3, 50, torch.bfloat16, True, None, 0),   # plain loads
    (2, 1024, 1024, 8, 2, 64, torch.bfloat16, True, 16, 0))   # G = 4


def _flash_inputs(b, sq, sk, h, kv, hd, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device="cuda").to(dtype)
                 for shape in ((b, sq, h, hd), (b, sk, kv, hd),
                               (b, sk, kv, hd)))


def test_flash_attention_kernel_matches_plain_version():
    """out within 1e-4·max(1, |plain|) in fp32 and 2^-7·|plain| + 1e-5
    (one bf16 ulp, both round an fp32 result) in bf16; lse within
    1e-4·max(1, |plain|); bitwise repeatable; row b of a batch equal to
    that row alone."""
    _need_card()
    from repro_torch.kernels.flash_attention.cuda import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import flash_fwd_ref
    for b, sq, sk, h, kv, hd, dt, causal, window, off in FLASH_SHAPES:
        q, k, v = _flash_inputs(b, sq, sk, h, kv, hd, dt, seed=sq + hd)
        kw = dict(causal=causal, window=window, q_offset=off)
        before = flash_attention_cuda.launches
        out, lse = flash_attention_cuda(q, k, v, **kw)
        again = flash_attention_cuda(q, k, v, **kw)
        want, want_lse = flash_fwd_ref(q, k, v, q_chunk=min(512, sq),
                                       kv_chunk=min(1024, sk), **kw)
        torch.cuda.synchronize()
        assert flash_attention_cuda.launches == before + 2
        assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
        assert out.dtype == dt and lse.shape == (b, kv, h // kv, sq)
        err, ref = (out.float() - want.float()).abs(), want.float().abs()
        if dt == torch.bfloat16:
            assert torch.all(err <= 2.0 ** -7 * ref + 1e-5)
        else:
            assert torch.all(err <= 1e-4 * ref.clamp(min=1))
        assert torch.all((lse - want_lse).abs()
                         <= 1e-4 * want_lse.abs().clamp(min=1))
        for row in range(b):
            solo, _ = flash_attention_cuda(q[row:row + 1].contiguous(),
                                           k[row:row + 1].contiguous(),
                                           v[row:row + 1].contiguous(), **kw)
            assert torch.equal(solo[0], out[row])


def test_flash_attention_kernel_rejects_what_it_cannot_take():
    _need_card()
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention.cuda import flash_attention_cuda
    q, k, v = _flash_inputs(1, 128, 128, 4, 2, 64, torch.float32, 0)
    kw = dict(causal=True, window=None, q_offset=0)
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_cuda(q.cpu(), k, v, **kw)
    with pytest.raises(ValueError, match="fp32 or all bf16"):
        flash_attention_cuda(q.half(), k.half(), v.half(), **kw)
    with pytest.raises(ValueError, match="fp32 or all bf16"):
        flash_attention_cuda(q, k.bfloat16(), v, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(q.transpose(1, 2).contiguous().transpose(1, 2),
                             k, v, **kw)
    with pytest.raises(ValueError, match="bad shapes"):
        flash_attention_cuda(q, k[:, :, :1].contiguous(), v, **kw)
    with pytest.raises(ValueError, match="multiples of 128"):
        flash_attention_cuda(q[:, :96].contiguous(), k, v, **kw)
    big = _flash_inputs(1, 192, 192, 4, 2, 64, torch.bfloat16, 0)
    with pytest.raises(ValueError, match="multiples of 128"):
        flash_attention_cuda(*big, **kw)     # 3 x 64 rows: no longer taken
    with pytest.raises(ValueError, match="hd <= 128"):
        big = torch.randn((1, 64, 2, 160), device="cuda")
        flash_attention_cuda(big, big, big, **kw)
    before = flash_attention_cuda.launches   # a CUDA tensor reaches the kernel
    dispatch.flash_attention(q, k, v, q_chunk=64, kv_chunk=128, **kw)
    assert flash_attention_cuda.launches == before + 1


@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_load_routes_agree_bit_for_bit(hd):
    """The bf16 route copies tiles with TMA when hd is a multiple of 8 and
    q, k and v start on 16-byte boundaries, and with plain loads into the
    same shared-memory layout otherwise: the same values one element past
    such a boundary give the same bits."""
    _need_card()
    from repro_torch.kernels.flash_attention.cuda import flash_attention_cuda
    q, k, v = _flash_inputs(2, 1024, 1024, 32, 8, hd, torch.bfloat16, hd)

    def shifted(x):                          # data_ptr 2 bytes past 16
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        out = flat[1:].view(x.shape)
        out.copy_(x)
        return out

    kw = dict(causal=True, window=None, q_offset=0)
    out, lse = flash_attention_cuda(q, k, v, **kw)
    out2, lse2 = flash_attention_cuda(*map(shifted, (q, k, v)), **kw)
    assert shifted(q).data_ptr() % 16 == 2
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


def test_flash_attention_backward_on_the_card_matches_the_cpu():
    """One FlashAttentionFn forward and backward at S = 2048 (fp32, the
    default chunks): the card (kernel forward, blockwise backward) against
    the CPU (plain forward, the same backward), within 1e-4·max(1, |cpu|)."""
    _need_card()
    from repro_torch.kernels.flash_attention.cuda import flash_attention_cuda
    from repro_torch.models.attention import attention
    q, k, v = _flash_inputs(1, 2048, 2048, 8, 2, 64, torch.float32, 3)
    g = torch.randn(q.shape, generator=torch.Generator(device="cuda")
                    .manual_seed(4), device="cuda")
    grads = []
    for dev in ("cuda", "cpu"):
        leaves = [x.to(dev).requires_grad_(True) for x in (q, k, v)]
        before = flash_attention_cuda.launches
        out = attention(*leaves, causal=True)
        assert flash_attention_cuda.launches == before + (dev == "cuda")
        grads.append([out] + list(torch.autograd.grad(out, leaves, g.to(dev))))
    for a, b in zip(*grads):
        a, b = a.detach().cpu(), b.detach()
        assert torch.all((a - b).abs() <= 1e-4 * b.abs().clamp(min=1))


SSD_SHAPES = (     # Bt, S, H, P, N, chunk, steep
    (2, 64, 3, 16, 16, 8, False),
    (1, 26, 2, 16, 16, 13, False),        # a ragged chunk
    (2, 39, 3, 64, 128, 13, False),       # ragged chunks at full N and P
    (4, 1024, 32, 64, 128, 256, False),   # mamba2-370m training
    (2, 512, 4, 64, 128, 256, True),      # masked exps would overflow
    (1, 200, 2, 64, 128, 200, False),     # one chunk of S
    (2, 400, 2, 64, 128, 200, False),     # ragged query tiles, carried
    (2, 80, 3, 50, 30, 40, False))        # P, N off 16 bytes: plain loads


def _ssd_inputs(bt, s, h, p, n, steep, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = 0.5 * torch.randn((bt, s, h, p), generator=g, device="cuda")
    bm = 0.5 * torch.randn((bt, s, n), generator=g, device="cuda")
    cm = 0.5 * torch.randn((bt, s, n), generator=g, device="cuda")
    adt = -torch.nn.functional.softplus(torch.randn((bt, s, h), generator=g,
                                                    device="cuda"))
    if steep:
        adt = adt - 20.0
    dt = torch.nn.functional.softplus(torch.randn((bt, s, h), generator=g,
                                                  device="cuda"))
    return x, bm, cm, adt, dt


def test_ssd_scan_kernel_matches_plain_version():
    """y and h_last within 1e-4·max(1, |plain|); bitwise repeatable; row
    b of a batch equal to that row alone."""
    _need_card()
    from repro_torch.kernels.ssd_scan.cuda import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    for bt, s, h, p, n, q, steep in SSD_SHAPES:
        args = _ssd_inputs(bt, s, h, p, n, steep, seed=s + q)
        before = ssd_scan_cuda.launches
        y, h_last = ssd_scan_cuda(*args, chunk=q)
        again = ssd_scan_cuda(*args, chunk=q)
        want = ssd_scan_ref(*args, chunk=q)
        torch.cuda.synchronize()
        assert ssd_scan_cuda.launches == before + 2
        assert torch.equal(y, again[0]) and torch.equal(h_last, again[1])
        for a, b in zip((y, h_last), want):
            assert a.shape == b.shape and bool(torch.isfinite(a).all())
            assert torch.all((a - b).abs() <= 1e-4 * b.abs().clamp(min=1))
        for row in range(bt):
            solo = ssd_scan_cuda(*(t[row:row + 1].contiguous()
                                   for t in args), chunk=q)
            assert torch.equal(solo[0][0], y[row])
            assert torch.equal(solo[1][0], h_last[row])


def test_ssd_scan_kernel_rejects_what_it_cannot_take():
    _need_card()
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.ssd_scan.cuda import ssd_scan_cuda
    x, bm, cm, adt, dt = _ssd_inputs(1, 64, 2, 16, 16, False, 0)
    with pytest.raises(ValueError, match="CUDA device"):
        ssd_scan_cuda(x.cpu(), bm, cm, adt, dt, chunk=8)
    with pytest.raises(ValueError, match="fp32 only"):
        ssd_scan_cuda(x.bfloat16(), bm, cm, adt, dt, chunk=8)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan_cuda(x.transpose(1, 2).contiguous().transpose(1, 2), bm,
                      cm, adt, dt, chunk=8)
    with pytest.raises(ValueError, match="bad shapes"):
        ssd_scan_cuda(x, bm[:, :, :8].contiguous(), cm, adt, dt, chunk=8)
    with pytest.raises(ValueError, match="S % chunk"):
        ssd_scan_cuda(x, bm, cm, adt, dt, chunk=24)
    with pytest.raises(ValueError, match="P <= 64"):
        big = torch.zeros((1, 64, 2, 80), device="cuda")
        ssd_scan_cuda(big, bm, cm, adt, dt, chunk=8)
    before = ssd_scan_cuda.launches     # a CUDA tensor reaches the kernel
    dispatch.ssd_scan(x, bm, cm, adt, dt, chunk=8)
    assert ssd_scan_cuda.launches == before + 1


def test_mamba2_serving_and_training_go_through_the_kernel():
    """The reduced mamba2 on the card: serving (batched == solo) and two
    training steps launch the scan kernel; one forward per layer."""
    _need_card()
    from repro_torch.kernels.ssd_scan.cuda import ssd_scan_cuda
    from repro_torch.launch.train import train_loop
    from repro_torch.serve import Engine, Request
    cfg = get_config("mamba2-370m").reduced().with_serve(
        max_slots=2, page_size=4, max_seq=32)
    eng = Engine(cfg, device="cuda", seed=0)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, tokens=rng.integers(0, cfg.vocab_size, size=n)
                    .astype(np.int32), max_new=4, seed=1)
            for i, n in enumerate((5, 16))]
    before = ssd_scan_cuda.launches
    res = eng.run(reqs)
    assert ssd_scan_cuda.launches - before == 2 * cfg.num_layers
    for r in reqs:
        np.testing.assert_array_equal(res[r.rid].tokens, eng.replay_single(r))
    before = ssd_scan_cuda.launches
    _, _, _, hist = train_loop(cfg, steps=2, batch_size=2, seq_len=16,
                               device="cuda", log_every=1000)
    assert ssd_scan_cuda.launches - before == 2 * cfg.num_layers
    assert np.all(np.isfinite(hist))


def _functional_update(name, grads, state, params, lr_t, step):
    """One step of the port's optimizers as they were before they updated
    in place: the formula leaf by leaf with torch's elementwise ops, new
    tensors out. Returns (params, mu, nu)."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)      # noqa: E731
    b1c = float(1.0 - f32(0.9) ** f32(step))
    b2c = float(1.0 - f32(0.999) ** f32(step))
    out = []
    for i, (g, p) in enumerate(zip(grads, params)):
        g, m = g.float(), state.mu[i]
        if name == "adamw":
            m = 0.9 * m + (1 - 0.9) * g
            v = 0.999 * state.nu[i] + (1 - 0.999) * g * g
            delta = (m / b1c) / (torch.sqrt(v / b2c) + 1e-8) \
                + 0.01 * p.float()
        else:
            m, v = 0.9 * m + g, None
            delta = m
        out.append(((p.float() - lr_t * delta).to(p.dtype), m, v))
    return [list(x) for x in zip(*out)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_in_place_optimizer_gives_the_functional_bits_on_the_card(
        monkeypatch, name, dtype):
    """On the card, five clipped in-place steps (`torch._foreach_*` over
    groups, a division by a host scalar as the multiplication by its fp32
    reciprocal that torch's CUDA kernel does) give the bits of the
    functional update."""
    _need_card()
    from repro_torch.optim import adamw, clip_by_global_norm, optimizers, sgd
    monkeypatch.setattr(optimizers, "GROUP_ELEMS", 1 << 12)
    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = ((64, 200), (200,), (3000,), (5, 7), (4096,))
    params = [torch.randn(s, generator=g, device="cuda").to(dtype)
              for s in shapes]
    ref = [p.clone() for p in params]
    opt = (adamw if name == "adamw" else sgd)(lambda s: 1e-2 / s)
    state = opt.init(params)
    mu = [m.clone() for m in state.mu]
    nu = None if state.nu is None else [v.clone() for v in state.nu]
    for step in range(1, 6):
        grads = [3 * torch.randn(s, generator=g, device="cuda").to(dtype)
                 for s in shapes]
        norm = torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in grads))
        scale = torch.clamp(1.0 / torch.clamp(norm, min=1e-9), max=1.0)
        want = [(x.float() * scale).to(x.dtype) for x in grads]
        got, got_norm = clip_by_global_norm(grads, 1.0)
        assert torch.equal(got_norm, norm)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        ref, mu, nu = _functional_update(
            name, want, optimizers.OptState(step - 1, mu, nu), ref,
            1e-2 / step, step)
        params, state = opt.update(got, state, params)
    for a, b in zip(params + state.mu + (state.nu or []),
                    ref + mu + (nu if name == "adamw" else [])):
        assert a.dtype == b.dtype and torch.equal(a, b)


# --------------------------------------------- the quantized kernel modes
def _quantized(x, fmt):
    from repro_torch.index.quantized import quantize_rows
    return quantize_rows(x, fmt)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("kind", ["pq", "rq"])
def test_quantized_midx_probs_matches_plain_version(fmt, kind):
    """The quantized mode (1-byte codebooks, [K] scales after the slices'
    sum) against its plain version, over 16-byte, 8-byte and plain codebook
    loads (Dc 1024, 100, 10), and a row alone equal to that row inside a
    call bit for bit."""
    _need_card()
    from repro_torch.kernels.midx_probs.cuda import midx_probs_cuda
    split = kind == "pq"
    for t, d, k in ((1, 2048, 64), (33, 200, 32), (130, 20, 8),
                    (1024, 200, 32)):
        g = torch.Generator(device="cuda").manual_seed(t + d)
        dc = d // 2 if split else d
        z = torch.randn((t, d), generator=g, device="cuda")
        (q1, s1), (q2, s2) = (_quantized(0.1 * torch.randn(
            (k, dc), generator=g, device="cuda"), fmt) for _ in range(2))
        cnt = torch.randint(0, 3, (k, k), generator=g, device="cuda").float()
        kw = dict(split=split, scale1=s1.reshape(-1), scale2=s2.reshape(-1))
        got = midx_probs_cuda(z, q1, q2, cnt, **kw)
        want = midx_probs_ref(z, q1, q2, cnt, **kw)
        for a, b in zip(got, want):
            assert a.shape == b.shape
            assert torch.all((a - b).abs() <= 1e-4 * b.abs().clamp(min=1))
        solo = midx_probs_cuda(z[t - 1:], q1, q2, cnt, **kw)
        assert all(torch.equal(a[0], b[t - 1]) for a, b in zip(solo, got))


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantized_sampled_ce_pt_kernels_match_plain_version(fmt):
    """The per-token forward and backward over an int8 / fp8 table with row
    scales, at every copy route of the forward (D = 2048: a 2 KB row, the
    TMA; 48: 16-byte cp.async; 200: 8-byte cp.async; 44: the plain-load
    kernel), with duplicate and colliding ids and one hot row; the
    backward's d(table) is scale-unaware and bitwise repeatable."""
    _need_card()
    from repro_torch.kernels.sampled_ce.cuda import (sampled_ce_pt_bwd_cuda,
                                                     sampled_ce_pt_cuda)
    from repro_torch.kernels.sampled_ce.ref import (sampled_ce_pt_bwd_ref,
                                                    sampled_ce_pt_fwd_ref)
    for t, d, m, v in ((64, 2048, 64, 5000), (300, 48, 20, 700),
                       (1024, 200, 20, 10000), (7, 44, 12, 50)):
        h, tab, lq, neg, pos, g = _sce_inputs(t, d, m, v, torch.float32,
                                              seed=d)
        neg[:, 3::2] = 7                         # one hot row
        q, sc = _quantized(tab, fmt)
        loss, lse = sampled_ce_pt_cuda(h, q, lq, neg, pos, scale=sc)
        wl, wlse = sampled_ce_pt_fwd_ref(h, q, lq, neg, pos, scale=sc)
        _hold_pt_fwd((loss, lse), (wl, wlse))
        got = sampled_ce_pt_bwd_cuda(g, h, q, lq, neg, pos, lse, scale=sc)
        again = sampled_ce_pt_bwd_cuda(g, h, q, lq, neg, pos, lse, scale=sc)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        _hold_pt_bwd(got, sampled_ce_pt_bwd_ref(g, h, q, lq, neg, pos, wlse,
                                                scale=sc))


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantized_shared_sampled_ce_kernels_match_plain_version(fmt):
    """The shared-negative forward and backward over gathered int8 / fp8
    rows with their scales, dequantized before the 3xTF32 split: D = 2048
    (16-byte staging) and D = 40 (plain loads), duplicates, collisions and
    an all-colliding token; dpe and dne scale-unaware."""
    _need_card()
    from repro_torch.kernels.sampled_ce.cuda import (sampled_ce_bwd_cuda,
                                                     sampled_ce_cuda)
    from repro_torch.kernels.sampled_ce.ref import (sampled_ce_bwd_ref,
                                                    sampled_ce_fwd_ref)
    for b, s, m, d in ((2, 70, 100, 2048), (3, 5, 7, 40)):
        h, pe, ne, lq, neg, pos, g = _shared_inputs(b, s, m, d, 500,
                                                    torch.float32, seed=d)
        (pq, ps), (nq, ns) = (_quantized(x.reshape(-1, d), fmt)
                              for x in (pe, ne))
        args = (h, pq.reshape(pe.shape), nq.reshape(ne.shape), lq, neg, pos)
        kw = dict(pos_scale=ps.reshape(b, s, 1), neg_scale=ns.reshape(b, m, 1))
        loss, lse = sampled_ce_cuda(*args, **kw)
        wl, wlse = sampled_ce_fwd_ref(*args, **kw)
        assert torch.all((loss - wl).abs() <= 1e-4 * wl.abs().clamp(min=1))
        assert torch.all((lse - wlse).abs() <= 1e-4 * wlse.abs().clamp(min=1))
        got = sampled_ce_bwd_cuda(g, *args, lse, **kw)
        assert all(torch.equal(x, y) for x, y in zip(
            got, sampled_ce_bwd_cuda(g, *args, lse, **kw)))
        for x, y in zip(got, sampled_ce_bwd_ref(g, *args, wlse, **kw)):
            s_ = min(1.0, float(y.abs().max()))
            assert torch.all((x - y).abs()
                             <= 1e-4 * y.abs().clamp(min=max(s_, 1e-30)))


def test_quantized_kernels_reject_what_they_cannot_take():
    _need_card()
    from repro_torch.kernels.midx_probs.cuda import midx_probs_cuda
    from repro_torch.kernels.sampled_ce.cuda import (sampled_ce_cuda,
                                                     sampled_ce_pt_cuda)
    z = torch.randn((4, 16), device="cuda")
    q, sc = _quantized(torch.randn((8, 16), device="cuda"), "int8")
    cnt = torch.ones((8, 8), device="cuda")
    with pytest.raises(ValueError, match="both scales"):
        midx_probs_cuda(z, q, q, cnt, split=False, scale1=sc.reshape(-1))
    with pytest.raises(ValueError, match="codebooks"):
        midx_probs_cuda(z, q, q, cnt, split=False)        # no scales
    with pytest.raises(ValueError, match="bad shapes"):
        midx_probs_cuda(z, q, q, cnt, split=False, scale1=sc[:4].reshape(-1),
                        scale2=sc[:4].reshape(-1))
    h, tab, lq, neg, pos, _ = _sce_inputs(4, 16, 5, 20, torch.float32, 0)
    tq, tsc = _quantized(tab, "fp8")
    with pytest.raises(ValueError, match="with scales"):
        sampled_ce_pt_cuda(h, tq, lq, neg, pos)           # no scales
    with pytest.raises(ValueError, match="with scales"):
        sampled_ce_pt_cuda(h, tab, lq, neg, pos, scale=tsc)
    with pytest.raises(ValueError, match="bad shapes"):
        sampled_ce_pt_cuda(h, tq, lq, neg, pos, scale=tsc[:5])
    h, pe, ne, lq, neg, pos, _ = _shared_inputs(2, 4, 5, 16, 20,
                                                torch.float32, 0)
    with pytest.raises(ValueError, match="both scales"):
        sampled_ce_cuda(h, pe, ne, lq, neg, pos,
                        pos_scale=torch.ones((2, 4, 1), device="cuda"))


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantized_training_and_serving_go_through_the_kernels(fmt):
    """The reduced paper-lm trained 3 steps over an int8 / fp8 table
    (per-token head), then served from the trained quantized state
    (batched == solo); and the reduced llama pooled 2 steps: every
    quantized kernel mode launched in the run's format, losses finite."""
    _need_card()
    from repro_torch.kernels.midx_probs.cuda import midx_probs_cuda
    from repro_torch.kernels.sampled_ce import cuda as sce
    from repro_torch.launch.train import train_loop
    from repro_torch.serve import Engine, Request
    counters = (midx_probs_cuda, sce.sampled_ce_pt_cuda,
                sce.sampled_ce_pt_bwd_cuda)
    for c in counters + (sce.sampled_ce_cuda, sce.sampled_ce_bwd_cuda):
        c.quant_launches = {"int8": 0, "fp8": 0}
    cfg = get_config("paper-lm").reduced().with_head(table_dtype=fmt)
    params, _, index, hist = train_loop(cfg, steps=3, batch_size=4,
                                        seq_len=16, log_every=1000,
                                        device="cuda")
    assert np.all(np.isfinite(hist)) and index.fmt == fmt
    assert all(c.quant_launches[fmt] >= 3 for c in counters)
    served = cfg.with_serve(max_slots=2, page_size=4, max_seq=16)
    eng = Engine(served, params, index=index, head="midx", device="cuda")
    reqs = [Request(rid=i, tokens=np.arange(3 + i, dtype=np.int32),
                    max_new=4, seed=1) for i in range(3)]
    res = eng.run(reqs)
    for r in reqs:
        np.testing.assert_array_equal(res[r.rid].tokens, eng.replay_single(r))
    llama = get_config("llama3.2-1b").reduced().with_head(table_dtype=fmt)
    _, _, _, hist = train_loop(llama, steps=2, batch_size=2, seq_len=16,
                               log_every=1000, device="cuda")
    assert np.all(np.isfinite(hist))
    assert sce.sampled_ce_cuda.quant_launches[fmt] >= 2
    assert sce.sampled_ce_bwd_cuda.quant_launches[fmt] >= 2


def _owner_masked(neg, lq, pos, r, rows):
    """Shard r's view of global draws, as `loss_midx_vp` builds it."""
    lneg = neg - r * rows
    okn = (lneg >= 0) & (lneg < rows)
    lpos = pos - r * rows
    okp = (lpos >= 0) & (lpos < rows)
    return (torch.where(okn, lneg, 0).contiguous(),
            torch.where(okn, lq, 1e30).contiguous(),
            torch.where(okp, lpos, -1).contiguous(), okn)


@pytest.mark.parametrize("fmt", ["fp32", "bf16", "int8", "fp8"])
def test_partial_sampled_ce_pt_kernels_match_plain_version(fmt):
    """The per-token forward and backward in the partial mode (a vocab
    shard's rows, owner-masked ids, the global M), each shard of two, at
    the TMA, 16-byte and 8-byte copy routes and the plain-load kernel: held
    to the plain partial versions, the backward bitwise repeatable, a token
    with no owned negative at exactly NEG_INF with zero gradients."""
    _need_card()
    from repro_torch.kernels.sampled_ce.cuda import (sampled_ce_pt_bwd_cuda,
                                                     sampled_ce_pt_cuda)
    from repro_torch.kernels.sampled_ce.ref import (
        sampled_ce_pt_partial_bwd_ref, sampled_ce_pt_partial_ref)
    for t, d, m, v in ((64, 2048, 64, 5000), (300, 48, 20, 700),
                       (1024, 200, 20, 10000), (7, 44, 12, 50)):
        h, tab, lq, neg, pos, g = _sce_inputs(t, d, m, v, torch.float32,
                                              seed=d)
        rows = v // 2
        neg[1] = torch.arange(m, device="cuda") % rows   # shard 0's only
        for r in range(2):
            part = tab[r * rows:(r + 1) * rows].contiguous()
            sc = None
            if fmt == "bf16":
                part = part.to(torch.bfloat16)
            elif fmt != "fp32":
                part, sc = _quantized(part, fmt)
            nid, lqm, pid, okn = _owner_masked(neg, lq, pos, r, rows)
            args = (h, part, lqm, nid, pid)
            loss, lse = sampled_ce_pt_cuda(*args, scale=sc,
                                           include_pos=False, num_neg=m)
            want = sampled_ce_pt_partial_ref(*args, m, scale=sc)
            assert torch.equal(loss, lse)
            _hold_pt_fwd((lse,), (want,))
            got = sampled_ce_pt_bwd_cuda(g, *args, lse, scale=sc,
                                         include_pos=False, num_neg=m)
            again = sampled_ce_pt_bwd_cuda(g, *args, lse, scale=sc,
                                           include_pos=False, num_neg=m)
            assert all(torch.equal(a, b) for a, b in zip(got, again))
            _hold_pt_bwd(got, sampled_ce_pt_partial_bwd_ref(
                g, *args, want, m, scale=sc))
            empty = ~okn.any(1)
            assert bool(empty.any()) == (r == 1)
            assert bool((lse[empty] == -1e30).all())
            assert not got[0][empty].any() and not got[2][empty].any()


@pytest.mark.parametrize("fmt", ["fp32", "int8"])
def test_partial_shared_sampled_ce_kernels_match_plain_version(fmt):
    """The shared-negative forward and backward in the partial mode (no
    positive rows, owner-masked ids, the global M), each shard of two, at
    D = 2048 and D = 40: held to the plain partial versions, both bitwise
    repeatable, a sequence with no owned negative at exactly NEG_INF."""
    _need_card()
    from repro_torch.kernels.sampled_ce.cuda import (sampled_ce_bwd_cuda,
                                                     sampled_ce_cuda)
    from repro_torch.kernels.sampled_ce.ref import (
        sampled_ce_partial_bwd_ref, sampled_ce_partial_fwd_ref)
    for b, s, m, d in ((2, 70, 100, 2048), (3, 5, 7, 40)):
        v = 500
        g0 = torch.Generator(device="cuda").manual_seed(d)
        table = 0.2 * torch.randn((v, d), generator=g0, device="cuda")
        h = torch.randn((b, s, d), generator=g0, device="cuda")
        lq = -6.0 + 0.5 * torch.randn((b, m), generator=g0, device="cuda")
        neg = torch.randint(0, v, (b, m), generator=g0, device="cuda")
        pos = torch.randint(0, v, (b, s), generator=g0, device="cuda")
        neg[0, 1] = pos[0, 2]                    # a colliding positive
        neg[1] = torch.arange(m, device="cuda") % (v // 2)
        g = torch.rand((b, s), generator=g0, device="cuda")
        for r in range(2):
            nid, lqm, pid, okn = _owner_masked(neg, lq, pos, r, v // 2)
            ne = table[r * (v // 2):(r + 1) * (v // 2)][nid].contiguous()
            ns = None
            if fmt != "fp32":
                ne, ns = _quantized(ne.reshape(-1, d), fmt)
                ne, ns = ne.reshape(b, m, d), ns.reshape(b, m, 1)
            args = (h, ne, lqm, nid, pid)
            kw = dict(neg_scale=ns, include_pos=False, num_neg=m)
            loss, lse = sampled_ce_cuda(h, None, *args[1:], **kw)
            want = sampled_ce_partial_fwd_ref(*args, m, ns)
            assert torch.equal(loss, lse) and torch.equal(
                lse, sampled_ce_cuda(h, None, *args[1:], **kw)[1])
            _hold_pt_fwd((lse,), (want,))
            dh, dpe, dne, dlq = sampled_ce_bwd_cuda(g, h, None, *args[1:],
                                                    lse, **kw)
            assert dpe is None
            again = sampled_ce_bwd_cuda(g, h, None, *args[1:], lse, **kw)
            assert torch.equal(dh, again[0]) and torch.equal(dne, again[2])
            _hold_pt_bwd((dh, dne, dlq), sampled_ce_partial_bwd_ref(
                g, *args, want, m, ns))
            empty = ~okn.any(1)
            assert bool((lse[empty] == -1e30).all())
            assert not dh[empty].any()


def _chunk_hidden(cfg, params, toks, pool, solo):
    """Slot 1's 100 valid rows of a 128-token chunk at start 144 (a page
    boundary, not a multiple of the flash tile) over the prefix `pool`."""
    from repro_torch.models import chunk_prefill_step, init_paged_state
    sv = cfg.serve
    state = init_paged_state(cfg, 2, sv.resolved_num_pages, sv.page_size,
                             sv.pages_per_slot, device="cuda")
    state["page_table"].copy_(torch.arange(
        1, 1 + 2 * sv.pages_per_slot, device="cuda").reshape(2, -1))
    for name in ("k", "v"):
        state[name].copy_(pool[name])
    h, _ = chunk_prefill_step(cfg, params, toks,
                              torch.tensor([0, 144], device="cuda"),
                              torch.tensor([0, 100], device="cuda"), state,
                              solo=solo)
    return h[1, :100].float()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_prefill_flash_route_on_the_card(dtype):
    """The flash kernel's route of a chunk against the plain route, the
    same prefix in the pool (hd 16 and 64): fp32 within 1e-4 of
    max(1, |plain|); in bf16, where the plain route rounds the attention
    probabilities to bf16 and the kernel keeps them in two bf16 terms,
    each route is held to the same chunk computed in fp32 (the same
    weights, the prefix's bf16 values), the kernel's largest error at most
    1.25x the plain route's. The kernel's route repeats bit for bit."""
    _need_card()
    import dataclasses
    from repro_torch.kernels.flash_attention.cuda import flash_attention_cuda
    from repro_torch.models import cast_blocks, init_params
    for hd, d in ((16, 64), (64, 256)):
        base = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                                   d_model=d, head_dim=hd).with_serve(
            max_slots=2, page_size=16, max_seq=512)
        cfg = dataclasses.replace(base, dtype=dtype)
        master = init_params(cfg, device="cuda")
        params = cast_blocks(cfg, master)
        g = torch.Generator(device="cuda").manual_seed(1)
        shape = (cfg.num_layers, cfg.serve.resolved_num_pages, 16,
                 cfg.num_kv_heads, hd)
        pool = {n: torch.randn(shape, generator=g, device="cuda")
                .to(getattr(torch, dtype)) for n in ("k", "v")}
        toks = torch.randint(0, cfg.vocab_size, (2, 128), device="cuda",
                             generator=g)
        before = flash_attention_cuda.launches
        flash = _chunk_hidden(cfg, params, toks, pool, (1, 144))
        assert flash_attention_cuda.launches == before + cfg.num_layers
        assert torch.equal(flash, _chunk_hidden(cfg, params, toks, pool,
                                                (1, 144)))
        plain = _chunk_hidden(cfg, params, toks, pool, None)
        if dtype == "float32":
            assert torch.all((flash - plain).abs()
                             <= 1e-4 * plain.abs().clamp(min=1)), hd
            continue
        f32 = dataclasses.replace(base, dtype="float32")
        want = _chunk_hidden(f32, cast_blocks(f32, master), toks,
                             {n: x.float() for n, x in pool.items()}, None)
        err_flash = float((flash - want).abs().max())
        err_plain = float((plain - want).abs().max())
        assert err_flash <= 1.25 * err_plain, (hd, err_flash, err_plain)


def test_serving_tier_on_the_card_batched_equals_solo():
    """Speculative decoding with chunked prefill and the prefix cache on
    the card: batched == solo, midx_probs launched by the draft."""
    _need_card()
    from repro_torch.kernels.midx_probs.cuda import midx_probs_cuda
    from repro_torch.serve import Engine, Request
    cfg = get_config("paper-lm").with_serve(
        max_slots=2, page_size=4, max_seq=64, spec_decode=3,
        prefill_chunk=8, prefix_cache=True)
    eng = Engine(cfg, head="midx")
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, size=12)
    reqs = [Request(rid=i, tokens=np.concatenate(
        [shared, rng.integers(0, cfg.vocab_size, size=5)]).astype(np.int32),
        max_new=8, seed=1) for i in range(3)]
    before = midx_probs_cuda.launches
    res = eng.run(reqs[:1])
    res.update(eng.run(reqs[1:]))
    assert midx_probs_cuda.launches > before
    assert eng.cache.counters()["cache_hits"] > 0
    assert eng.stats.spec_waves > 0
    for r in reqs:
        np.testing.assert_array_equal(res[r.rid].tokens, eng.replay_single(r))


def test_overlapped_refresh_equals_synchronous_on_the_card():
    """`train_loop` at lag 2 on the card (the rebuild built at its
    dispatch step and swapped in two steps later): two runs agree bit for
    bit, and the first swap is, bit for bit, the synchronous refresh of a
    params snapshot from its dispatch step with its seed."""
    _need_card()
    from repro_torch.core import noise
    from repro_torch.index.lifecycle import IndexLifecycle, clone_tensors
    from repro_torch.launch import train as train_mod
    from repro_torch.models import heads
    from repro_torch.optim.optimizers import tree_leaves
    cfg = get_config("paper-lm").reduced().with_head(refresh_policy="drift")
    kw = dict(steps=8, batch_size=4, seq_len=16, log_every=1000,
              refresh_every=4, refresh_lag=2, device="cuda")
    seen = {}

    class Spy(IndexLifecycle):
        """Keeps the first dispatch's inputs and the state it swapped in."""

        def _dispatch(self, step, params, state):
            seen.setdefault("dispatch", (step, clone_tensors(params),
                                         clone_tensors(state)))
            super()._dispatch(step, params, state)

        def _complete(self, swap_step, current):
            out = super()._complete(swap_step, current)
            seen.setdefault("live", (self.events[-1], out[0]))
            return out

    runs = [train_mod.train_loop(cfg, **kw) for _ in range(2)]
    assert runs[0][3] == runs[1][3]
    for a, b in zip(tree_leaves(runs[0][0]), tree_leaves(runs[1][0])):
        assert torch.equal(a, b)
    train_mod.IndexLifecycle = Spy
    try:
        train_mod.train_loop(cfg, **kw)
    finally:
        train_mod.IndexLifecycle = IndexLifecycle
    step, params, state = seen["dispatch"]
    ev, got = seen["live"]
    assert (step, ev.step, ev.swap_step) == (3, 3, 5) and not ev.rejected
    gen = torch.Generator(device="cuda")
    gen.manual_seed(int(noise.hash_bits(
        int(noise.hash_bits(0, train_mod._STREAM_REFRESH, 0, 0)), 3, 0, 0)))
    want, _ = heads.refresh_head_state_with_policy(cfg, params, state, gen)
    for f in ("codebook1", "codebook2", "assign1", "sorted_ids", "counts"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_mid_stream_swap_on_the_card():
    """An unchanged-index swap mid-stream on the card keeps every token; a
    poisoned one is refused with the tokens unchanged."""
    _need_card()
    from repro_torch.resilience import poison_state
    from repro_torch.serve import Engine, Request
    cfg = get_config("paper-lm").reduced().with_serve(
        max_slots=2, page_size=4, max_seq=32)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, tokens=rng.integers(0, cfg.vocab_size, 6)
                    .astype(np.int32), max_new=10) for i in range(3)]
    plain = Engine(cfg, head="midx", device="cuda", seed=5).run(reqs)
    for make, swaps, rejected in (
            (lambda e: e.rebuild_index(), 1, 0),
            (lambda e: poison_state(e.index, "nan"), 0, 1)):
        eng = Engine(cfg, head="midx", device="cuda", seed=5)
        eng.schedule_swap(make(eng), at_step=3)
        out = eng.run(reqs)
        assert (eng.stats.swaps, eng.stats.swap_rejected) == (swaps,
                                                              rejected)
        for r in reqs:
            np.testing.assert_array_equal(plain[r.rid].tokens,
                                          out[r.rid].tokens)


@pytest.mark.parametrize("proposal", ["per_token", "pooled", "mixture"])
def test_fused_route_matches_the_unfused_route_on_the_card(monkeypatch,
                                                           proposal):
    """paper-lm's head on the card, one step's draws fed to both routes:
    the per-token proposal tables of the kernel within 1e-5·max(1, |x|) of
    `twostage_tables`; the loss and its gradients (hidden, table and, for
    per-token draws, log q: pinned as a leaf) of the fused route within
    1e-4·max(|x|, min(1, max |x|)) of the unfused route's, which launches
    no head kernel."""
    _need_card()
    from repro_torch.core import midx, noise
    from repro_torch.kernels.midx_probs.cuda import midx_probs_cuda
    from repro_torch.kernels.midx_probs.ops import proposal_tables
    from repro_torch.kernels.sampled_ce.cuda import (sampled_ce_bwd_cuda,
                                                     sampled_ce_cuda,
                                                     sampled_ce_pt_bwd_cuda,
                                                     sampled_ce_pt_cuda)
    from repro_torch.models import heads, init_params
    cfg = get_config("paper-lm").with_head(proposal=proposal)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, device="cuda")
    index = heads.init_head_state(cfg, params, gen)
    b, s = 4, 64
    h = 0.5 * torch.randn((b, s, cfg.d_model), generator=gen, device="cuda")
    labels = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device="cuda")
    keys = noise.train_keys(0, 1, b * s, device="cuda")
    leaves = []
    if proposal == "per_token":
        z = h.reshape(b * s, -1)
        for a, c in zip(proposal_tables(index, z),
                        midx.twostage_tables(index, z)):
            assert torch.all((a - c).abs() <= 1e-5 * c.abs().clamp(min=1))
        draw = midx.sample_twostage(index, z, cfg.head.num_negatives, keys,
                                    tables_fn=proposal_tables)
        lq = draw.log_q.detach().clone().requires_grad_(True)
        monkeypatch.setattr(midx, "sample_twostage",
                            lambda *a, **kw: midx.Draw(draw.ids, lq))
        leaves = [lq]
    counters = (midx_probs_cuda, sampled_ce_pt_cuda, sampled_ce_pt_bwd_cuda,
                sampled_ce_cuda, sampled_ce_bwd_cuda)

    def run(fused):
        before = [c.launches for c in counters]
        hh = h.clone().requires_grad_(True)
        tab = params["embed"].detach().clone().requires_grad_(True)
        loss = heads.loss_midx(cfg, {**params, "embed": tab}, index, hh,
                               labels, keys, fused=fused)
        grads = torch.autograd.grad(loss, [hh, tab] + leaves)
        torch.cuda.synchronize()
        return [loss] + list(grads), [c.launches - n
                                      for c, n in zip(counters, before)]

    fused, n_fused = run(True)
    unfused, n_unfused = run(False)
    assert n_unfused == [0] * 5 and sum(n_fused) > 0
    for a, c in zip(fused, unfused):
        scale = min(1.0, float(c.abs().max()))
        assert torch.all((a - c).abs()
                         <= 1e-4 * c.abs().clamp(min=max(scale, 1e-30)))
