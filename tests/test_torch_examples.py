"""The port's examples (`src/repro_torch/examples/`, mirroring the
README's `examples/quickstart.py`, `serve_decode.py` and
`train_lm_midx.py`) on the CPU at their small defaults: quickstart's
Theorem 2 error within 1e-5 and KL(MIDX‖P) below KL(uniform‖P);
serve_decode returning both heads' summaries; train_lm_midx's 3 steps
finite with the CE falling; and each refusing the CPU unless asked."""
import numpy as np
import pytest
import torch

from repro_torch.examples import quickstart, serve_decode, train_lm_midx


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tier-1 run puts test files in parallel
    workers, and torch's thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart():
    out = quickstart.main(["--device", "cpu"])
    assert out["theorem2_err"] <= 1e-5
    assert out["kl_midx"] < out["kl_uniform"]
    assert np.isfinite(out["loss_sampled"]) and np.isfinite(out["loss_full"])
    assert 0 < out["nonempty_clusters"] <= quickstart.K ** 2


def test_serve_decode_returns_both_heads_summaries():
    out = serve_decode.main(["--device", "cpu"])
    assert set(out) == {"full", "midx"}
    for s in out.values():
        assert s["generated"] == 8 * 24 and s["tok_s"] > 0


def test_train_lm_midx_three_steps():
    out = train_lm_midx.main(["--device", "cpu", "--steps", "3"])
    hist = out["hist"]
    assert len(hist) == 3 and out["finite"]
    assert hist[-1] < hist[0]
    assert (out["layers"], out["d_model"], out["vocab"]) == (4, 192, 8192)


@pytest.mark.parametrize("example", [quickstart, serve_decode,
                                     train_lm_midx])
def test_examples_default_to_the_card(example):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is legitimate")
    with pytest.raises(RuntimeError, match="cpu"):
        example.main(["--steps", "1"] if example is train_lm_midx else [])
