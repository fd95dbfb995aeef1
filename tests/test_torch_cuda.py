"""Card-only checks of the torch port: the CUDA midx_probs kernel against
its plain version, and the engine on the card. This file imports no JAX, so
it runs on a machine that has a card and no JAX:

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
    for t, d, k in ((1, 200, 32), (33, 2048, 64), (130, 16, 8), (0, 16, 8)):
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
