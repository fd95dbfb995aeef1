"""The port's index hot-swap on the CPU (ports of
`tests/test_index_lifecycle.py:347-382` and `tests/test_resilience.py:
397-426`): `Engine.rebuild_index` rebuilds the boot state bit for bit; an
unchanged-index swap mid-stream keeps every token, in the plain engine,
a speculative one, a chunked prefix-cache one, an int8 one and across the
router; a different index changes only the tokens after the swap; a
degenerate swap is refused with the tokens unchanged and the counters and
health the reference's; and the serve CLI's --swap-step, --stale-sigma
and their refusal of --head full."""
import jax
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.configs import get_config as jget_config
from repro.resilience import poison_state as jpoison_state
from repro_torch import serve as tserve
from repro_torch.configs import get_config
from repro_torch.index.quantized import QuantHeadState
from repro_torch.launch import serve as serve_cli
from repro_torch.resilience import poison_state
from repro_torch.resilience.validate import _leaves


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: when test files run in parallel worker
    processes, torch's thread pools oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(slots=2, **serve):
    return get_config("paper-lm").reduced().with_serve(
        max_slots=slots, page_size=4, max_seq=32, **serve)


def _reqs(mod, cfg, num, plen, max_new, seed=0):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, tokens=rng.integers(0, cfg.vocab_size,
                                                   size=plen).astype(np.int32),
                        max_new=max_new, seed=seed)
            for i in range(num)]


def _same_state(a, b) -> bool:
    la, lb = list(_leaves(a)), list(_leaves(b))
    return len(la) == len(lb) and all(
        pa == pb and torch.equal(x, y) for (pa, x), (pb, y) in zip(la, lb))


def _swap_run(cfg, at_step, state_fn=None, num=3, plen=6, max_new=10,
              **kw):
    """(tokens without a swap, tokens with state_fn(engine) swapped in at
    decode step at_step, the swapping engine)."""
    base = tserve.Engine(cfg, head="midx", device="cpu", seed=5, **kw)
    plain = base.run(_reqs(tserve, cfg, num, plen, max_new))
    eng = tserve.Engine(cfg, head="midx", device="cpu", seed=5, **kw)
    eng.schedule_swap((state_fn or (lambda e: e.rebuild_index()))(eng),
                      at_step=at_step)
    out = eng.run(_reqs(tserve, cfg, num, plen, max_new))
    return plain, out, eng


def _assert_same_tokens(a, b):
    assert set(a) == set(b)
    for rid in a:
        np.testing.assert_array_equal(a[rid].tokens, b[rid].tokens)


def test_engine_swap_unchanged_index_token_identical():
    cfg = _cfg()
    eng = tserve.Engine(cfg, head="midx", device="cpu", seed=5)
    assert _same_state(eng.rebuild_index(), eng.index)   # the boot index
    plain, out, eng = _swap_run(cfg, 3)
    assert eng._pending_swap is None and eng.stats.swaps == 1
    _assert_same_tokens(plain, out)


def test_engine_swap_changes_future_tokens_only():
    cfg = _cfg(slots=1)
    plain, out, eng = _swap_run(
        cfg, 4, lambda e: e.rebuild_index(torch.Generator().manual_seed(123)),
        num=1, max_new=12)
    assert eng.stats.swaps == 1
    # 1 prefill token + 4 decode steps before the swap
    np.testing.assert_array_equal(plain[0].tokens[:5], out[0].tokens[:5])


def test_degenerate_swap_rejected_decode_token_identical():
    plain, out, eng = _swap_run(_cfg(), 3,
                                lambda e: poison_state(e.index, "nan"))
    assert eng._pending_swap is None                 # the attempt happened
    assert eng.stats.swap_rejected == 1 and eng.stats.swaps == 0
    assert eng.stats.health()["ok"] is False
    _assert_same_tokens(plain, out)


def test_swap_counters_and_health_match_reference():
    """The same scenario in both packages: one valid swap, one poisoned
    one; the counters and the health report agree."""
    jcfg = jget_config("paper-lm").reduced().with_serve(
        max_slots=2, page_size=4, max_seq=32)
    je = jserve.Engine(jcfg, init_key=jax.random.PRNGKey(2), head="midx")
    te = tserve.Engine(_cfg(), head="midx", device="cpu", seed=2)
    for eng, poison in ((je, jpoison_state), (te, poison_state)):
        assert eng.swap_index(eng.rebuild_index()) is True
        assert eng.swap_index(poison(eng.index, "zero")) is False
    assert te.stats.counters() == je.stats.counters()
    assert te.stats.health() == je.stats.health()
    assert te.stats.summary()["swaps"] == 1


def test_swap_index_accepts_valid_rebuild():
    eng = tserve.Engine(_cfg(), head="midx", device="cpu", seed=2)
    assert eng.swap_index(eng.rebuild_index()) is True
    assert eng.stats.swaps == 1 and eng.stats.swap_rejected == 0


def test_swap_follows_into_the_solo_replay():
    """After a swap the solo replay engine serves the swapped index."""
    cfg = _cfg()
    eng = tserve.Engine(cfg, head="midx", device="cpu", seed=5)
    req = _reqs(tserve, cfg, 1, 6, 6)[0]
    before = eng.replay_single(req)
    other = eng.rebuild_index(torch.Generator().manual_seed(9))
    assert eng.swap_index(other)
    assert eng._solo.index is other
    after = eng.replay_single(req)
    np.testing.assert_array_equal(eng.run([req])[req.rid].tokens, after)
    assert before.shape == after.shape


@pytest.mark.parametrize("case", ["spec", "chunked_prefix", "int8"])
def test_unchanged_swap_token_identical_per_engine(case):
    cfg = {"spec": _cfg(spec_decode=3),
           "chunked_prefix": _cfg(prefix_cache=True, prefill_chunk=4),
           "int8": _cfg().with_head(table_dtype="int8")}[case]
    plain, out, eng = _swap_run(cfg, 3, plen=9)
    if case == "int8":
        assert isinstance(eng.index, QuantHeadState)
    # the rebuild is the boot state, bit for bit (the int8 twins included)
    assert _same_state(eng.rebuild_index(), eng.index)
    assert eng.stats.swaps == 1 and eng._pending_swap is None
    _assert_same_tokens(plain, out)


def test_unchanged_swap_across_the_router():
    cfg = _cfg()
    one = tserve.Engine(cfg, head="midx", device="cpu", seed=5)
    reqs = _reqs(tserve, cfg, 4, 6, 8)
    plain = tserve.Router([one, tserve.Engine(
        cfg, one.params, index=one.index, head="midx",
        device="cpu")]).run(reqs)
    two = tserve.Engine(cfg, head="midx", device="cpu", seed=5)
    router = tserve.Router([two, tserve.Engine(
        cfg, two.params, index=two.index, head="midx", device="cpu")])
    router.schedule_swap(two.rebuild_index(), at_step=2)
    out = router.run(reqs)
    merged = router.stats()
    assert merged.swaps == 2 and merged.swap_rejected == 0
    assert router.summary()["swaps"] == 2
    _assert_same_tokens(plain, out)


# --------------------------------------------------------------------- CLI
def _cli(*flags):
    return serve_cli.main(["--device", "cpu", "--reduced", "--requests", "4",
                           "--max-slots", "2", "--tokens", "6", *flags])


def test_cli_swap_step_keeps_verify():
    out = _cli("--swap-step", "2", "--verify", "2", "--traffic",
               "synthetic")
    assert out["verified"] == 2 and out["summary"]["swaps"] == 1


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_cli_stale_sigma_reports_a_gap_and_skips_verify(dtype, capsys):
    """A quantized engine's stale state (index and low-bit twins fit to
    the stale table, by `Engine.rebuild_index(table=)`) has the live
    state's structure, so both swaps pass the gate."""
    out = _cli("--stale-sigma", "0.5", "--swap-step", "2", "--table-dtype",
               dtype)
    assert out["summary"]["swaps"] == 2
    assert out["summary"]["swap_rejected"] == 0
    assert out["verified"] == 0
    assert out["kl"]["stale"] - out["kl"]["refreshed"] > 0
    text = capsys.readouterr().out
    assert "skipping verify" in text and "proposal KL" in text


def test_cli_refuses_swaps_with_the_full_head():
    for flags in (["--swap-step", "2"], ["--stale-sigma", "0.5"]):
        with pytest.raises(SystemExit, match="--head full"):
            _cli("--head", "full", "--greedy", *flags)


def test_cli_swaps_a_copy_of_a_restored_index(tmp_path):
    eng = tserve.Engine(_cfg(), head="midx", device="cpu", seed=3)
    eng.save_checkpoint(str(tmp_path), step=1)
    out = _cli("--ckpt", str(tmp_path), "--swap-step", "1", "--page-size",
               "4")
    assert out["verified"] == 2 and out["summary"]["swaps"] == 1
