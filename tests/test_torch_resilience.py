"""The port's chaos suite, ported from `tests/test_resilience.py`: every
injected fault is recovered from, and none takes down the process. Faults
are drawn from the same (seed, step) streams as the reference's, so the
bytes a corruption damages are compared with the reference's injector.

  checkpoint   kill-mid-save at each of the four commit phases leaves the
               previous checkpoint; a killed re-save of a step is healed
               from the aside dir; a bitflip walks back; silent corruption
               is caught by the per-leaf CRC32; a structural mismatch
               raises an informative CheckpointError.
  train        a NaN loss poisons every gradient and the step is skipped
               bitwise; the guardrails escalate a bad streak to a rollback
               whose replay is bitwise the uninterrupted run; a quiet
               injector changes no bit; the training leg of the end-to-end
               scenario (a corrupt newest checkpoint walked past, a NaN
               step rolled back and replayed).
  index        a degenerate refresh is rejected by the lifecycle's gate.
  serve        floods against a bounded queue and oversized requests are
               shed, with the reference's deterministic traffic.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.resilience import FaultInjector as JFaultInjector
from repro_torch.checkpoint import CheckpointError, CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import noise
from repro_torch.data import ZipfLM, make_lm_stream
from repro_torch.index.build import build
from repro_torch.index.lifecycle import IndexLifecycle
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.train import StragglerWatchdog, train_loop
from repro_torch.models import heads, init_params
from repro_torch.optim import adamw
from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.resilience import (FaultInjector, FaultSpec,
                                    GuardrailConfig, InjectedFault,
                                    TrainGuardrails, poison_state,
                                    validate_index, validate_state)
from repro_torch.serve import Engine



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tier-1 run puts test files in parallel
    workers, and torch's thread pools then oversubscribe the cores and
    these small train steps crawl (~50x)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def tiny_cfg():
    return get_config("paper-lm").reduced().with_head(
        num_negatives=32, refresh_every=50, proposal="per_token")


@pytest.fixture(scope="module")
def corpus(tiny_cfg):
    return ZipfLM(vocab_size=tiny_cfg.vocab_size, num_clusters=16,
                  seq_len=33, seed=0).sample(256)


def _tree(val: float):
    return {"w": torch.full((4, 3), val, dtype=torch.float32),
            "b": torch.arange(5, dtype=torch.int32)}


def _leaves_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def _restore(mgr, step):
    return mgr.restore(step, _tree(0.0), device="cpu")


# ------------------------------------------------------------ checkpoint
@pytest.mark.parametrize("phase", ["arrays", "tree", "committed", "swap"])
def test_kill_mid_save_keeps_previous_checkpoint(tmp_path, phase):
    """A crash at any phase of the commit leaves latest_step() at the
    previous complete checkpoint, and the retried save commits."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(1.0))
    inj = FaultInjector(0, [FaultSpec("kill_mid_save", step=2, mode=phase)])
    inj.attach_checkpoint(mgr)
    with pytest.raises(InjectedFault):
        mgr.save(2, _tree(2.0))
    assert mgr.latest_step() == 1
    assert CheckpointManager(str(tmp_path)).latest_step() == 1
    _leaves_equal(_restore(mgr, 1), _tree(1.0))
    mgr.save(2, _tree(2.0))                  # the one-shot spec is spent
    assert mgr.latest_step() == 2
    assert inj.fired == [("kill_mid_save", 2)]


def test_kill_mid_swap_heals_aside_dir(tmp_path):
    """Re-saving a step renames the old dir aside before the commit
    rename; a crash between the two is healed on restart."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(1.0))
    inj = FaultInjector(0, [FaultSpec("kill_mid_save", step=1, mode="swap")])
    inj.attach_checkpoint(mgr)
    with pytest.raises(InjectedFault):
        mgr.save(1, _tree(9.0))
    mgr2 = CheckpointManager(str(tmp_path))
    assert mgr2.latest_step() == 1
    _leaves_equal(_restore(mgr2, 1), _tree(1.0))


def test_corrupt_bitflip_triggers_walkback(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(1.0))
    mgr.save(2, _tree(2.0))
    inj = FaultInjector(3)
    assert inj.corrupt_checkpoint(str(tmp_path), mode="bitflip") == 2
    like = _tree(0.0)
    assert mgr.verify(2, like)
    assert mgr.latest_verified_step(like) == 1
    step, tree = mgr.restore_latest_verified(like, device="cpu")
    assert step == 1
    _leaves_equal(tree, _tree(1.0))


def test_corrupt_silent_caught_by_leaf_crc(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(1.0))
    FaultInjector(5).corrupt_checkpoint(str(tmp_path), mode="silent")
    reasons = mgr.verify(1)
    assert reasons and any("CRC32" in r for r in reasons)
    with pytest.raises(CheckpointError, match="CRC32"):
        _restore(mgr, 1)
    mgr.restore(1, _tree(0.0), device="cpu", verify=False)


@pytest.mark.parametrize("mode", ["bitflip", "silent", "truncate"])
def test_corruption_is_the_reference_s(tmp_path, mode):
    """Same (seed, step) -> the same damage, and the same damage as the
    reference's injector does to the same values saved by the reference:
    the same bytes flipped, the same leaf rewritten, the same cut."""
    damage = []
    for leg, inj in (("a", FaultInjector(11)), ("b", FaultInjector(11)),
                     ("j", JFaultInjector(11))):
        root = str(tmp_path / leg)
        if leg == "j":
            JManager(root).save(3, {"w": jnp.full((4, 3), 1.0, jnp.float32),
                                    "b": jnp.arange(5, dtype=jnp.int32)})
        else:
            CheckpointManager(root).save(3, _tree(1.0))
        path = f"{root}/step_{3:010d}/arrays.npz"
        with open(path, "rb") as f:
            before = np.frombuffer(f.read(), np.uint8)
        assert inj.corrupt_checkpoint(root, mode=mode) == 3
        with open(path, "rb") as f:
            after = np.frombuffer(f.read(), np.uint8)
        if mode == "bitflip":        # the zip headers hold the save's time
            damage.append(np.flatnonzero(before != after).tolist())
        elif mode == "truncate":
            damage.append((before.size, after.size))
        else:
            with np.load(path) as z:
                damage.append({k: z[k].tobytes() for k in z.files})
    assert damage[0] == damage[1] == damage[2] and damage[0]
    assert CheckpointManager(str(tmp_path / "a")).latest_verified_step() \
        is None


def test_restore_mismatch_error_is_informative(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(1.0))                  # 2 leaves
    like = {**_tree(0.0), "extra": torch.zeros(2)}
    with pytest.raises(CheckpointError) as ei:
        mgr.restore(1, like, device="cpu")
    msg = str(ei.value)
    assert "2 leaves" in msg and "3" in msg and "step_" in msg


# ------------------------------------------------------------------ train
def test_nan_step_skipped_params_unchanged(tiny_cfg, corpus):
    """A NaN loss (which NaN-poisons every gradient) leaves params and the
    optimizer state bitwise unchanged, with metrics['skipped'] raised; a
    healthy step updates them (in place)."""
    cfg = tiny_cfg
    opt = adamw(1e-3)
    step_fn = steps_mod.make_train_step(cfg, opt)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt_state = opt.init(params)
    index = heads.init_head_state(cfg, params,
                                  torch.Generator().manual_seed(1))
    batch = {k: torch.from_numpy(v).long() for k, v in
             make_lm_stream(corpus, 4, seed=0).batch_at(0).items()}
    b, s = batch["tokens"].shape
    keys = noise.train_keys(0, 0, b * s, "cpu")
    before = tree_map(torch.clone, [params, opt_state.mu, opt_state.nu])

    poisoned = {**batch, "_fault_scale": torch.full((b,), float("nan"))}
    p1, o1, m1 = step_fn(params, opt_state, index, poisoned, keys)
    assert m1["skipped"] == 1.0 and not np.isfinite(float(m1["loss"]))
    assert o1 is opt_state and o1.step == 0
    _leaves_equal([p1, o1.mu, o1.nu], before)

    healthy = {**batch, "_fault_scale": torch.ones(b)}
    p2, o2, m2 = step_fn(params, opt_state, index, healthy, keys)
    assert m2["skipped"] == 0.0 and o2.step == 1 and p2 is params
    assert any(not torch.equal(x, y) for x, y in
               zip(tree_leaves(p2), tree_leaves(before[0])))


def test_guardrails_spike_and_rollback_budget():
    g = TrainGuardrails(GuardrailConfig(warmup_steps=2, spike_factor=3.0,
                                        max_consecutive_bad=2,
                                        max_rollbacks=1))
    for s in range(4):
        assert g.observe(s, 1.0) == "ok"
    assert g.observe(4, 10.0) == "bad"            # spike, streak 1
    assert g.observe(5, 10.0) == "rollback"       # streak hits the bound
    assert g.rollbacks == 1
    assert g.observe(6, float("nan")) == "bad"    # fresh streak after reset
    with pytest.raises(RuntimeError, match="rollbacks exceed"):
        g.observe(7, float("inf"))                # budget exhausted
    s = g.summary()
    assert s["spikes"] == 2 and s["skips"] == 2 and s["rollbacks"] == 2


def test_straggler_watchdog_detection():
    wd = StragglerWatchdog(alpha=0.5, threshold=1.5)
    for _ in range(10):
        assert not wd.observe(1.0)
    assert wd.observe(5.0)                    # injected delay trips it
    assert wd.rebalance_plan(8)["shed_microbatches"] == 1


def _run_kw(corpus, total):
    return dict(batch_size=4, seq_len=16, corpus=corpus[:, :17], lr=1e-3,
                log_every=1000, total_steps=total, device="cpu",
                refresh_every=5)


def _assert_runs_equal(a, b):
    assert a[3] == b[3]
    for x, y in zip(tree_leaves(a[0]) + tree_leaves(a[1].mu)
                    + tree_leaves(a[1].nu),
                    tree_leaves(b[0]) + tree_leaves(b[1].mu)
                    + tree_leaves(b[1].nu)):
        assert torch.equal(x, y)
    assert torch.equal(a[2].sorted_ids, b[2].sorted_ids)
    assert torch.equal(a[2].codebook1, b[2].codebook1)


def test_rollback_replay_is_bit_exact(tiny_cfg, corpus, tmp_path):
    """NaN at step 9 -> skip -> guardrail rollback to the step-8 checkpoint
    -> replay. The one-shot fault replays clean, so the run ends bitwise
    the uninterrupted run at the same horizon, history included."""
    kw = _run_kw(corpus, 12)
    clean = train_loop(tiny_cfg, steps=12, **kw)
    inj = FaultInjector(1, [FaultSpec("nan_loss", step=9)])
    chaos = train_loop(
        tiny_cfg, steps=12, ckpt_dir=str(tmp_path / "ck"), ckpt_every=4,
        injector=inj,
        guardrails=GuardrailConfig(max_consecutive_bad=1, warmup_steps=10 ** 6),
        **kw)
    assert inj.fired == [("nan_loss", 9)]
    _assert_runs_equal(clean, chaos)


def test_quiet_injector_leaves_trajectory_bit_identical(tiny_cfg, corpus):
    """An injector with an empty plan perturbs nothing: the loss is
    multiplied by exactly 1.0."""
    kw = _run_kw(corpus, 6)
    _assert_runs_equal(train_loop(tiny_cfg, steps=6, **kw),
                       train_loop(tiny_cfg, steps=6,
                                  injector=FaultInjector(0), **kw))


def test_no_checkpoint_rollback_continues_degraded(tiny_cfg, corpus, capsys):
    inj = FaultInjector(0, [FaultSpec("nan_loss", step=1)])
    _, _, _, hist = train_loop(
        tiny_cfg, steps=3, injector=inj,
        guardrails=GuardrailConfig(max_consecutive_bad=1), **_run_kw(corpus, 3))
    assert len(hist) == 3 and not np.isfinite(hist[1])
    assert "continuing degraded" in capsys.readouterr().out


def test_e2e_chaos_recovery_training_leg(tiny_cfg, corpus, tmp_path):
    """The training leg of `tests/test_resilience.py::
    test_e2e_chaos_recovery`: the newest checkpoint is corrupted, resume
    walks back past it, a NaN step mid-run is skipped, rolled back and
    replayed, and the run ends bitwise the uninterrupted one. (The serving
    leg needs Engine.schedule_swap, ROADMAP.md Queue 1 item 9.)"""
    kw = _run_kw(corpus, 16)
    ref = train_loop(tiny_cfg, steps=16, **kw)
    ck = str(tmp_path / "ck")
    train_loop(tiny_cfg, steps=8, ckpt_dir=ck, ckpt_every=4, **kw)
    inj = FaultInjector(7, [FaultSpec("nan_loss", step=11)])
    assert inj.corrupt_checkpoint(ck, mode="bitflip") == 8
    chaos = train_loop(
        tiny_cfg, steps=16, ckpt_dir=ck, ckpt_every=4, injector=inj,
        guardrails=GuardrailConfig(max_consecutive_bad=1,
                                   warmup_steps=10 ** 6), **kw)
    assert ("nan_loss", 11) in inj.fired
    assert chaos[3] == ref[3][4:]            # resumed at step 4
    _assert_runs_equal([*chaos[:3], []], [*ref[:3], []])


# ------------------------------------------------------------------ index
N, D, K = 300, 16, 4


@pytest.fixture(scope="module")
def idx():
    g = torch.Generator().manual_seed(0)
    emb = 0.5 * torch.randn((N, D), generator=g)
    return build(torch.Generator().manual_seed(1), emb, kind="rq", k=K,
                 iters=3, keep_residuals=False)


@pytest.mark.parametrize("mode", ["nan", "zero", "empty"])
def test_validate_index_catches_degeneracy(idx, mode):
    assert validate_index(idx) == []
    assert validate_state(idx, like=idx) == []
    assert validate_state(poison_state(idx, mode), like=idx), mode


def test_poison_state_maps_a_proposal_state():
    state = {"emb": torch.ones(3, 2), "tau": torch.tensor(4.0),
             "ids": torch.arange(3)}
    bad = poison_state(state, "empty")
    assert torch.equal(bad["emb"], torch.zeros(3, 2))
    assert torch.equal(bad["ids"], torch.zeros(3, dtype=torch.int64))
    assert torch.isnan(poison_state(state, "nan")["tau"])
    with pytest.raises(ValueError, match="degenerate"):
        poison_state(state, "bogus")


def test_lifecycle_rejects_degenerate_refresh(idx):
    """A refresh that returns a poisoned index does not go live: the old
    index stays and the event records the rejection and its reasons."""
    inj = FaultInjector(0, [FaultSpec("degenerate_refresh", step=3,
                                      mode="empty")])

    def good_refresh(params, index, seed):
        return index, {"did_full": torch.tensor(0.0)}

    lc = IndexLifecycle(inj.wrap_refresh(good_refresh), every=2, lag=0,
                        base_seed=0)
    cur, events = idx, []
    for step in range(6):
        inj.note_step(step)
        cur, ev = lc.step(step, None, cur)
        if ev is not None:
            events.append(ev)
    rejected = [e for e in events if e.rejected]
    assert len(rejected) == 1 and rejected[0].step == 3
    assert rejected[0].mode == "rejected" and rejected[0].reasons
    assert cur is idx
    assert sum(1 for e in events if not e.rejected) == 2
    lc.abort()                               # nothing in flight at lag 0
    assert lc.flush(5, cur) == (cur, None)


# ------------------------------------------------------------------ serve
def test_flood_bounded_queue_sheds_structured():
    cfg = get_config("paper-lm").reduced().with_serve(
        max_slots=1, page_size=4, max_seq=32, max_queue=2)
    eng = Engine(cfg, head="midx", device="cpu")
    reqs = FaultInjector(0).flood(6, plen=4, max_new=2, vocab=cfg.vocab_size)
    res = eng.run(reqs)
    assert len(res) == 6
    shed = [r for r in res.values() if r.status == "shed"]
    ok = [r for r in res.values() if r.status == "ok"]
    assert len(shed) == 4 and len(ok) == 2
    assert all(r.reason.startswith("queue_full") for r in shed)
    assert all(len(r.tokens) == 2 for r in ok)
    assert eng.stats.shed == 4
    # the reference's injector draws the same traffic
    for a, b in zip(reqs, JFaultInjector(0).flood(6, plen=4, max_new=2,
                                                  vocab=cfg.vocab_size)):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_oversized_request_shed_not_raised():
    cfg = get_config("paper-lm").reduced().with_serve(
        max_slots=2, page_size=4, max_seq=32)
    eng = Engine(cfg, head="midx", device="cpu")
    big = FaultInjector(0).oversized_request(factor=4,
                                             slot_capacity=cfg.serve.max_seq)
    res = eng.run([big])
    assert res[big.rid].status == "shed"
    assert res[big.rid].reason.startswith("oversized_slot")
    assert eng.stats.health()["shed"] == 1
    np.testing.assert_array_equal(
        big.tokens, JFaultInjector(0).oversized_request(
            factor=4, slot_capacity=cfg.serve.max_seq).tokens)
