"""Card-only checks of the torch port: the CUDA midx_probs, per-token and
shared-negative sampled-CE, RFF sampling, flash-attention and SSD-scan
kernels against their plain versions, the engine on the card, short
training runs through the kernels of the per-token, the pooled and the
rff-fused heads and of mamba2, and the chunked attention's backward on the
card against the CPU. This
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
