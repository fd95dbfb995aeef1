"""Data-parallel training in the port (DESIGN §4) on the CPU.

Ranks are gloo CPU processes (`tests/torch_dp_ranks.py`, which imports no
JAX), spawned once per grid for the file: dp = 2 and dp = 4, dp = 3 for
the pad-and-mask refresh, and a dp 2 x vp 2 grid. The reference runs in a
subprocess with two forced host devices and a hand-built
`jax.sharding.Mesh` (its own multi-device tests build theirs with
`jax.make_mesh`, which this jax does not run; ROADMAP.md Queue 3 fact a),
started beside the ranks. Held:
  - the collectives bit for bit against `jax.vmap` of the reference's
    `psum_bf16` / `psum_int8_ef` / `lax.pmean` on the same numpy inputs
    (an all-zero leaf, ties at .5, a nonzero carried ef), at dp 2 and 4;
  - one step of the full head against the reference's
    `make_sharded_train_step` on the bridged params, in each transport
    (SGD at lr 1 without momentum, so the optimizer's moment is the
    reduced, clipped gradient): fp32 within 1e-5, bf16 within 1.5 bf16
    ulp of the ranks' Σ|g| (where the ranks' gradients cancel, one ulp of
    the value does not hold: both packages' bf16 casts of fp32 gradients
    that agree to 1e-7 may round one ulp apart), int8 EF within one
    quantization step;
  - the MIDX step (per-token, pooled, mixture) at dp 2 and 4 against the
    port's single-device step over the same 8-sequence batches, 3 steps:
    loss, grad norm and params within 1e-6·max(1, |x|);
  - the data-sharded refresh: a group of one bit for bit the
    single-device refresh; dp 2 against the reference's `refresh_sharded`
    (the drift policy's cheap branch equal, the fixed policy's refit
    within 1e-5 with equal assignments); dp 3 on a table 3 does not
    divide against the single-device refresh; an int8 head state's
    refresh at dp 2 bit for bit the single-device one, twins included;
  - a NaN fault under int8_ef skipped on every rank with params, the
    optimizer state and ef unchanged; a dp 2 x vp 2 step against the
    replicated step; checkpoints across dp; the CLI in each transport and
    its refusals; chaos under --dp and --vocab-parallel.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_ranks as ranks
import torch_vp_ranks as vp_ranks
from repro.dist import collectives as jcoll
from repro_torch.bridge import index_to_numpy, params_to_numpy
from repro_torch.checkpoint import CheckpointManager
from repro_torch.index.lifecycle import refresh_with_policy
from repro_torch.index.sharded import refresh_sharded
from repro_torch.launch import steps
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import train_loop
from repro_torch.optim import adamw
from repro_torch.optim.optimizers import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tier-1 run puts test files in parallel
    workers, and torch's thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------- the reference, 2 devices
def _reference_program(inp: str, outp: str) -> None:
    """Run in a subprocess with two forced host devices: the reference's
    `make_sharded_train_step` in each transport and its `refresh_sharded`
    on a hand-built ("data",) mesh, from the inputs the test wrote."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_config
    from repro.index.build import MultiIndex
    from repro.index.sharded import refresh_sharded as jrefresh
    from repro.launch.steps import (init_grad_transport_state,
                                    make_sharded_train_step)
    from repro.models import init_params
    from repro.optim import sgd

    d = dict(np.load(inp))
    cfg = dataclasses.replace(get_config("paper-lm").reduced(),
                              dtype="float32").with_head(mode="full")
    like, tdef = jax.tree_util.tree_flatten(
        init_params(cfg, jax.random.PRNGKey(0)))
    params = tdef.unflatten([jnp.asarray(d[f"p{i}"])
                             for i in range(len(like))])
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    opt = sgd(1.0, momentum=0.0)
    batch = {"tokens": jnp.asarray(d["tokens"], jnp.int32),
             "labels": jnp.asarray(d["labels"], jnp.int32)}
    out = {}
    for t in ranks.TRANSPORTS:
        step = jax.jit(make_sharded_train_step(cfg, opt, mesh,
                                               grad_transport=t,
                                               head_mode="full"))
        ef = init_grad_transport_state(params, t, 2)
        _, o, m, _ = step(params, opt.init(params), jnp.zeros(()), batch,
                          jax.random.PRNGKey(0), ef)
        out[f"full_{t}_loss"] = np.asarray(m["loss"])
        out[f"full_{t}_gnorm"] = np.asarray(m["grad_norm"])
        for i, x in enumerate(jax.tree_util.tree_leaves(o.mu)):
            out[f"full_{t}_grad_{i}"] = np.asarray(x)
    ints = ("assign1", "assign2", "sorted_ids", "offsets", "counts")
    idx = MultiIndex("rq", *(jnp.asarray(d[f"idx_{f}"], jnp.int32 if f in
                                         ints else jnp.float32)
                             for f in ("codebook1", "codebook2", "assign1",
                                       "assign2", "residuals",
                                       "sorted_ids", "offsets", "counts",
                                       "log_counts")))
    for name, (_, policy) in ranks.refresh_cases().items():
        def body(index, key, table, policy=policy):
            return jrefresh(index, key, table, axis="data", iters=3,
                            policy=policy, threshold=0.5)
        fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(), P(),
                                                          P("data")),
                               out_specs=(P(), P()), check_rep=False))
        new, m = fn(idx, jax.random.PRNGKey(3), jnp.asarray(d[f"t_{name}"]))
        for f in ranks.INDEX_FIELDS:
            out[f"refresh_{name}_{f}"] = np.asarray(getattr(new, f))
        for k, v in m.items():
            out[f"refresh_{name}_{k}"] = np.asarray(v)
    np.savez(outp, **out)


class _Reference:
    """The reference subprocess, started when the fixture is first asked
    for and read when a test needs its results."""

    def __init__(self, tmp: str):
        cfg = ranks.full_cfg()
        params, toks, labels = ranks.full_setup(cfg)
        leaves = jax.tree_util.tree_leaves(params_to_numpy(cfg, params))
        inp = {f"p{i}": x for i, x in enumerate(leaves)}
        inp.update(tokens=toks, labels=labels)
        for f, x in index_to_numpy(ranks.refresh_index()).items():
            if f != "kind":
                inp[f"idx_{f}"] = x
        for name, (table, _) in ranks.refresh_cases().items():
            inp[f"t_{name}"] = table
        self.inp = os.path.join(tmp, "in.npz")
        self.out = os.path.join(tmp, "out.npz")
        np.savez(self.inp, **inp)
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = os.pathsep.join(
            [os.path.join(REPO, "src"), os.path.join(REPO, "tests")])
        code = ("import sys, test_torch_dp as t; "
                "t._reference_program(sys.argv[1], sys.argv[2])")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", code, self.inp, self.out], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self._res = None

    def result(self) -> dict:
        if self._res is None:
            log, _ = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, log
            self._res = dict(np.load(self.out))
        return self._res


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ref = _Reference(str(tmp_path_factory.mktemp("ref")))
    yield ref
    if ref.proc.poll() is None:
        ref.proc.kill()
        ref.proc.communicate()


@pytest.fixture(scope="module", params=[2, 4])
def ranked(request, reference, tmp_path_factory):
    """Spawn dp ranks once: every scenario of `torch_dp_ranks.scenarios`,
    each rank's results as numpy (the reference runs meanwhile)."""
    n = request.param
    out = str(tmp_path_factory.mktemp(f"dp{n}"))
    spawn_ranks(ranks.scenarios, 1, (out, n == 2), dp=n, device="cpu",
                backend="gloo", threads=1)
    return n, out, [dict(np.load(os.path.join(out, f"rank{r}.npz")))
                    for r in range(n)]


# --------------------------------------------------------------- collectives
def _vmapped(n: int):
    g, ef = ranks.coll_inputs(n)
    g = jax.tree_util.tree_map(jnp.asarray, g)
    ef = jax.tree_util.tree_map(jnp.asarray, ef)
    bf16 = jax.vmap(lambda x: jcoll.psum_bf16(x, "data"),
                    axis_name="data")(g)
    s, e = jax.vmap(lambda x, y: jcoll.psum_int8_ef(x, y, "data"),
                    axis_name="data")(g, ef)
    mean = jax.vmap(lambda x: jax.tree_util.tree_map(
        lambda t: jax.lax.pmean(t, "data"), x), axis_name="data")(g)
    return {k: [np.asarray(x) for x in jax.tree_util.tree_leaves(t)]
            for k, t in (("bf16", bf16), ("int8", s), ("ef", e),
                         ("mean", mean))}


def test_collectives_bitwise_equal_reference(ranked):
    """int8 EF (sums and new carries) bit for bit at dp 2 and 4; the fp32
    mean and the bf16 sum bit for bit at dp 2, and at dp 4, where gloo's
    ring and XLA add in other orders, within 3 ulp (of the type) of the
    sum of the ranks' |x|: each of the 3 additions rounds once."""
    n, _, res = ranked
    want = _vmapped(n)
    g, _ = ranks.coll_inputs(n)
    mags = [np.sum(np.abs(x), axis=0) for x in jax.tree_util.tree_leaves(g)]
    for r in range(n):
        for kind in ("int8", "ef", "mean", "bf16"):
            for i, w in enumerate(want[kind]):
                got = res[r][f"coll_{kind}_{i}"]
                if kind in ("int8", "ef") or n == 2:
                    assert got.tobytes() == w[r].tobytes(), (kind, i, r)
                    continue
                ulp = np.spacing(mags[i].astype(np.float32))
                if kind == "bf16":
                    ulp = ulp * 2 ** 16
                else:
                    ulp = ulp / n
                assert np.all(np.abs(got - w[r]) <= 3 * ulp), (kind, i, r)
    # the all-zero leaf (second in key order, a/zero): sum and carry 0
    assert not np.any(res[0]["coll_int8_1"]) and \
        not np.any(res[0]["coll_ef_1"])


# ----------------------------------------------------- full head vs the ref
@pytest.mark.parametrize("ranked", [2], indirect=True)
@pytest.mark.parametrize("transport", ranks.TRANSPORTS)
def test_full_head_step_matches_reference(ranked, reference, transport):
    _, _, res = ranked
    ref = reference.result()
    t = transport
    for r in range(2):
        assert abs(float(res[r][f"full_{t}_loss"])
                   - float(ref[f"full_{t}_loss"])) < TOL
        assert abs(float(res[r][f"full_{t}_gnorm"])
                   - float(ref[f"full_{t}_gnorm"])) < TOL
        i = 0
        while f"full_{t}_grad_{i}" in ref:
            got, want = res[r][f"full_{t}_grad_{i}"], ref[f"full_{t}_grad_{i}"]
            assert got.shape == want.shape
            if t == "fp32":
                bar = TOL
            elif t == "bf16":
                # each rank's bf16 cast of a gradient that agrees with the
                # reference's to 1e-7 may round one ulp apart, and so may
                # the sum: 1.5 ulp of the ranks' Σ|g| after the 1/dp
                absum = res[r][f"full_absum_{i}"].astype(np.float32)
                bar = 1.5 * np.spacing(absum) * 2 ** 16 + 1e-6 * np.abs(want)
            else:
                scale = res[r][f"full_scale_{i}"]      # one a layer
                bar = scale.reshape(scale.shape + (1,) * (
                    want.ndim - scale.ndim)) * (1 + 1e-5)
            assert np.all(np.abs(got - want) <= bar), (t, i)
            i += 1
        assert i > 10


# ------------------------------------------- MIDX step vs the single device
@pytest.mark.parametrize("proposal", ranks.PROPOSALS)
def test_midx_dp_step_equals_single_device(ranked, proposal):
    """Every rank draws the single-device run's negatives (the global
    per-token keys): 3 steps over the 8-sequence batches at dp 2 and 4."""
    n, _, res = ranked
    cfg = ranks.midx_cfg(proposal)
    params, index, toks, labels = ranks.midx_setup(cfg)
    opt = ranks.midx_opt()
    p = vp_ranks._clone(params)
    o = opt.init(p)
    step = steps.make_train_step(cfg, opt)
    losses, gnorms = [], []
    for batch, keys in ranks.midx_batches(toks, labels, 1, 0):
        p, o, met = step(p, o, index, batch, keys)
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))

    def close(got, want):
        want = np.asarray(want, np.float64)
        assert np.all(np.abs(np.asarray(got, np.float64) - want)
                      <= 1e-6 * np.maximum(1.0, np.abs(want)))

    for r in range(n):
        close(res[r][f"midx_{proposal}_loss"], losses)
        close(res[r][f"midx_{proposal}_gnorm"], gnorms)
        for i, leaf in enumerate(tree_leaves(p)):
            close(res[r][f"midx_{proposal}_param_{i}"], leaf.numpy())
            assert res[r][f"midx_{proposal}_param_{i}"].tobytes() == \
                res[0][f"midx_{proposal}_param_{i}"].tobytes()


# -------------------------------------------------------------- the refresh
@pytest.mark.parametrize("policy", ["drift", "fixed"])
def test_refresh_one_rank_bitwise_single_device(policy):
    """`refresh_sharded` with a group of one == `refresh_with_policy`."""
    x, moved, _, _ = ranks.refresh_tables()
    table = torch.from_numpy(x if policy == "drift" else moved)
    idx = ranks.refresh_index()
    a, ma = refresh_sharded(idx, torch.Generator().manual_seed(3), table,
                            iters=3, policy=policy, threshold=0.5)
    b, mb = refresh_with_policy(idx, torch.Generator().manual_seed(3), table,
                                iters=3, policy=policy, threshold=0.5)
    for f in ranks.INDEX_FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.residuals.shape == b.residuals.shape == (0, x.shape[1])
    for k in ("reassigned_frac", "codeword_drift", "did_full"):
        assert float(ma[k]) == float(mb[k]), k
    assert abs(float(ma["distortion"]) - float(mb["distortion"])) < 1e-6


@pytest.mark.parametrize("ranked", [2], indirect=True)
def test_refresh_matches_reference(ranked, reference):
    """dp 2 against the reference's `refresh_sharded` on 2 devices: the
    drift policy below its threshold (the cheap branch) equal field by
    field (log_counts, the fp32 log of equal counts, within 1e-6); the
    fixed policy's warm-started refit within 1e-5, its
    assignments equal (no two codewords tie within 1e-6 on this table:
    0 ties)."""
    _, _, res = ranked
    ref = reference.result()
    for r in range(2):
        for f in ranks.INDEX_FIELDS:
            got, want = res[r][f"refresh_drift_{f}"], ref[f"refresh_drift_{f}"]
            if f == "log_counts":     # torch's fp32 log and XLA's
                np.testing.assert_allclose(got, want, atol=1e-6)
            else:
                np.testing.assert_array_equal(got, want.astype(got.dtype),
                                              err_msg=f)
        for k in ("reassigned_frac", "codeword_drift", "did_full"):
            assert float(res[r][f"refresh_drift_{k}"]) == \
                float(ref[f"refresh_drift_{k}"]), k
        assert float(res[r]["refresh_drift_did_full"]) == 0.0
        assert float(res[r]["refresh_fixed_did_full"]) == 1.0
        for f in ("codebook1", "codebook2"):
            np.testing.assert_allclose(res[r][f"refresh_fixed_{f}"],
                                       ref[f"refresh_fixed_{f}"], atol=TOL)
        for f in ("assign1", "assign2", "sorted_ids", "offsets", "counts"):
            np.testing.assert_array_equal(res[r][f"refresh_fixed_{f}"],
                                          ref[f"refresh_fixed_{f}"], f)
        assert abs(float(res[r]["refresh_fixed_distortion"])
                   - float(ref["refresh_fixed_distortion"])) < TOL


@pytest.mark.parametrize("ranked", [2], indirect=True)
def test_quantized_refresh_rederives_twins(ranked):
    """An int8 head state refreshed data-sharded at dp 2 (the drift
    policy's cheap branch) == the single-device refresh, the index and
    every low-bit twin bit for bit."""
    from repro_torch.index.quantized import QUANT_FIELDS
    from repro_torch.models import heads
    _, _, res = ranked
    cfg = ranks.quant_cfg()
    params, state = ranks.quant_setup(cfg)
    want, _ = heads.refresh_head_state_with_policy(
        cfg, params, state, torch.Generator().manual_seed(4))
    for r in range(2):
        for f in QUANT_FIELDS[1:]:
            w = getattr(want, f)
            w = w.view(torch.uint8) if w.dtype.itemsize == 1 else w
            assert res[r][f"quant_{f}"].tobytes() == w.numpy().tobytes(), f
        for f in ranks.INDEX_FIELDS:
            assert res[r][f"quant_index_{f}"].tobytes() == \
                getattr(want.index, f).numpy().tobytes(), f


def test_refresh_pad_and_mask_dp3(tmp_path):
    """dp 3 on a 256-row table (3 does not divide it: 86 rows a rank, the
    last two pad rows masked): the drift branch equal to the single-device
    refresh field by field, the refit within 1e-5 with equal assignments,
    and the index the same on every rank."""
    n = ranks.REFRESH_N
    spawn_ranks(ranks.padded_refresh_scenario, 1, (str(tmp_path), n), dp=3,
                device="cpu", backend="gloo", threads=1)
    res = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(3)]
    for name, (table, policy) in ranks.refresh_cases(n).items():
        want, m = refresh_with_policy(
            ranks.refresh_index(n), torch.Generator().manual_seed(3),
            torch.from_numpy(table), iters=3, policy=policy, threshold=0.5)
        for r in range(3):
            for f in ranks.INDEX_FIELDS:
                got = res[r][f"refresh_{name}_{f}"]
                assert got.tobytes() == res[0][f"refresh_{name}_{f}"] \
                    .tobytes()
                w = getattr(want, f).numpy()
                if f.startswith("codebook") and name == "fixed":
                    np.testing.assert_allclose(got, w, atol=TOL)
                else:
                    np.testing.assert_array_equal(got, w, err_msg=f)
            assert abs(float(res[r][f"refresh_{name}_reassigned_frac"])
                       - float(m["reassigned_frac"])) < 1e-6
            assert float(res[r][f"refresh_{name}_did_full"]) == \
                float(m["did_full"])


# --------------------------------------------------------- guard and resume
@pytest.mark.parametrize("ranked", [2], indirect=True)
def test_nan_fault_int8_ef_skipped_on_every_rank(ranked):
    _, _, res = ranked
    for r in range(2):
        np.testing.assert_array_equal(res[r]["guard_skipped"], [0, 0, 1])
        assert bool(res[r]["guard_unchanged"])
        assert bool(res[r]["guard_ef_nonzero"])
        assert int(res[r]["guard_opt_step"]) == 2


@pytest.mark.parametrize("ranked", [2], indirect=True)
def test_checkpoint_resumes_across_dp(ranked):
    """dp 2: 3 steps + a resume to 6 == 6 uninterrupted steps bit for bit,
    and the params the same on both ranks; the dp 2 step-3 checkpoint
    resumes at dp 1 and trains on to step 6 within 1e-5 of the dp 2 run
    (the same draws; the gradients meet in another summation order)."""
    _, out, res = ranked
    for r in range(2):
        assert bool(res[r]["resume_same"])
        assert bool(res[r]["params_same_across_ranks"])
        assert res[r]["resume_hist"].tobytes() == \
            res[r]["whole_hist"][3:].tobytes()
    legs = os.path.join(out, "legs3")
    assert CheckpointManager(legs).all_steps() == [3]
    _, _, _, hist = train_loop(
        ranks.midx_cfg("per_token"), steps=6, total_steps=6, ckpt_dir=legs,
        ckpt_every=3, batch_size=ranks.MIDX_B, seq_len=ranks.MIDX_S,
        lr=1e-3, log_every=1000, seed=0, refresh_every=2, device="cpu")
    assert len(hist) == 3
    np.testing.assert_allclose(hist, res[0]["whole_hist"][3:], atol=TOL)


# ---------------------------------------------------------------- dp x vp
def test_dp2_vp2_step_matches_replicated(tmp_path):
    """A dp 2 x vp 2 grid (4 ranks): each data row trains on its rows with
    its vocab shards; loss, grad norm and every param within 1e-5 of the
    replicated step on the whole batch, and equal on the 4 ranks."""
    spawn_ranks(ranks.grid_scenario, 2, (str(tmp_path),), dp=2,
                device="cpu", backend="gloo", threads=1)
    res = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    cfg = vp_ranks.make_cfg()
    params, index, _, _, _, _ = vp_ranks.setup(cfg)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 8)))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 8)))
    opt = adamw(1e-3)
    p = vp_ranks._clone(params)
    p, _, met = steps.make_train_step(cfg, opt)(
        p, opt.init(p), index, {"tokens": toks, "labels": labels},
        ranks.noise.train_keys(0, 0, 32))
    for r in range(4):
        assert abs(float(res[r]["loss"]) - float(met["loss"])) < TOL
        assert abs(float(res[r]["gnorm"]) - float(met["grad_norm"])) < TOL
        for i, leaf in enumerate(tree_leaves(p)):
            np.testing.assert_allclose(res[r][f"param_{i}"], leaf.numpy(),
                                       atol=TOL)
            assert res[r][f"param_{i}"].tobytes() == \
                res[0][f"param_{i}"].tobytes()


# --------------------------------------------------------------------- CLI
BASE = ["--device", "cpu", "--reduced", "--steps", "3", "--batch", "4",
        "--seq", "16"]


@pytest.mark.parametrize("transport", ranks.TRANSPORTS)
def test_cli_dp2_each_transport_with_a_nan_fault(transport, tmp_path, capfd):
    """`--dp 2` in each transport, with a NaN fault at step 1 and a
    checkpoint: rank 0 reports the skip and the chaos report, and the
    serving export loads."""
    assert train_main(BASE + ["--dp", "2", "--grad-transport", transport,
                              "--chaos", "nan_loss@1", "--ckpt",
                              str(tmp_path)]) is None
    out = capfd.readouterr().out
    assert "step 1: non-finite update skipped" in out
    assert "chaos report" in out and "('nan_loss', 1)" in out
    assert CheckpointManager(os.path.join(str(tmp_path), "serve")
                             ).all_steps() == [3]


def test_cli_refusals():
    with pytest.raises(ValueError, match="divisible by the data-parallel"):
        train_main(BASE + ["--dp", "3"])
    with pytest.raises(ValueError, match="vocab-parallel step; use fp32"):
        train_main(BASE + ["--dp", "2", "--vocab-parallel", "2",
                           "--grad-transport", "bf16"])
    with pytest.raises(SystemExit):
        train_main(BASE + ["--grad-transport", "int4"])


def test_cli_chaos_dp2_vp2_and_vp2(capfd):
    """Chaos under `--vocab-parallel 2` (alone and on a dp 2 grid) runs
    and reports, as on one device."""
    for grid in (["--vocab-parallel", "2"],
                 ["--dp", "2", "--vocab-parallel", "2"]):
        assert train_main(BASE + grid + ["--chaos",
                                         "nan_loss@1,slow_step@2:0.01"]) \
            is None
        out = capfd.readouterr().out
        assert "step 1: non-finite update skipped" in out
        assert "chaos report" in out and "('slow_step', 2)" in out


def test_cli_int8_ef_without_dp_quantizes_on_one_process():
    """A non-fp32 transport without --dp: a data group over every local
    card, one process on the CPU, where int8 EF still quantizes (its loss
    curve departs from fp32's)."""
    *_, h8 = train_main(BASE + ["--grad-transport", "int8_ef"])
    *_, h32 = train_main(BASE)
    assert len(h8) == 3 and np.isfinite(h8).all()
    assert h8[0] == h32[0] and h8[-1] != h32[-1]
