"""The model axis of the port for the ssm, hybrid, vlm and audio families
(mamba2 split over d_inner, the hybrid's shared block, the vlm's cross
blocks, whisper's encoder and cross attention) against the reference and
the port's one-device path, on the CPU.

The ranks are gloo CPU processes spawned once per grid for the file
(`tests/torch_tp_family_ranks.py`, which imports no JAX): dp 1 x tp 2 and
dp 2 x tp 2. The reference's single-device steps run meanwhile in a
subprocess (one forced host device is enough: nothing of it is sharded).
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_tp_family_ranks as ranks
from repro_torch.bridge import params_to_numpy
from repro_torch.checkpoint import CheckpointManager, restore_sharded
from repro_torch.configs import get_config
from repro_torch.dist import sharding as shd
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist.collectives import RecordingGroup
from repro_torch.launch import dryrun
from repro_torch.launch import steps
from repro_torch.launch.mesh import MeshDesc, spawn_ranks
from repro_torch.models import init_params
from repro_torch.models.decode import init_decode_state
from repro_torch.models.model import forward

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


# ------------------------------------------------------------ the reference
def _reference_program(inp: str, outp: str) -> None:
    """In a subprocess: the reference's single-device full-head SGD step
    (lr 1) of each `ranks.FAMILY_CFGS` config on the bridged params."""
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.launch.steps import make_train_step
    from repro.models import init_params as jinit
    from repro.optim import sgd

    d = dict(np.load(inp))
    out = {}
    for name in ranks.FAMILY_CFGS:
        cfg = dataclasses.replace(jget(name).reduced(),
                                  dtype="float32").with_head(mode="full")
        like, tdef = jax.tree_util.tree_flatten(jax.eval_shape(
            lambda: jinit(cfg, jax.random.PRNGKey(0))))
        params = tdef.unflatten([jnp.asarray(d[f"{name}_p{i}"])
                                 for i in range(len(like))])
        opt = sgd(1.0, momentum=0.0)
        pre = f"{name}_b_"
        batch = {k[len(pre):]: jnp.asarray(v) for k, v in d.items()
                 if k.startswith(pre)}
        for k in ("tokens", "labels"):
            batch[k] = batch[k].astype(jnp.int32)
        new, _, m = jax.jit(make_train_step(cfg, opt, head_mode="full"))(
            params, opt.init(params), jnp.zeros(()), batch,
            jax.random.PRNGKey(0))
        out[f"{name}_loss"] = np.asarray(m["loss"])
        for i, x in enumerate(jax.tree_util.tree_leaves(new)):
            out[f"{name}_param_{i}"] = np.asarray(x)
    np.savez(outp, **out)


class _Reference:
    def __init__(self, tmp: str):
        inp = {}
        for name in ranks.FAMILY_CFGS:
            cfg = ranks.cfg_of(name)
            params, batch = ranks.setup(cfg)
            leaves = jax.tree_util.tree_leaves(params_to_numpy(cfg, params))
            inp.update({f"{name}_p{i}": x for i, x in enumerate(leaves)})
            inp.update({f"{name}_b_{k}": v for k, v in batch.items()})
        self.inp = os.path.join(tmp, "in.npz")
        self.out = os.path.join(tmp, "out.npz")
        np.savez(self.inp, **inp)
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = os.pathsep.join(
            [os.path.join(REPO, "src"), os.path.join(REPO, "tests")])
        code = ("import sys, test_torch_tp_families as t; "
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


@pytest.fixture(scope="module")
def grids(reference, tmp_path_factory):
    """Spawn the dp 1 x tp 2 and dp 2 x tp 2 grids once, side by side
    (the reference runs meanwhile): dp -> (outdir, each rank's results as
    numpy)."""
    del reference
    outs = {dp: str(tmp_path_factory.mktemp(f"fam_tp2dp{dp}"))
            for dp in (1, 2)}

    def spawn(dp):
        spawn_ranks(ranks.scenarios, 1, (outs[dp],), dp=dp, tp=2,
                    device="cpu", backend="gloo", threads=1)

    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        for f in [ex.submit(spawn, dp) for dp in outs]:
            f.result()
    return {dp: (out, [dict(np.load(os.path.join(out, f"rank{r}.npz")))
                       for r in range(2 * dp)])
            for dp, out in outs.items()}


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# --------------------------------------- the tp 2 step vs the reference
def _one_device_step(name: str) -> dict:
    """The port's one-device full-head SGD step of a `ranks` config, in
    the reference's leaf order."""
    from repro_torch.optim import sgd
    cfg = ranks.cfg_of(name)
    params, batch = ranks.setup(cfg)
    opt = sgd(1.0, momentum=0.0)
    p, _, m = steps.make_train_step(cfg, opt)(
        params, opt.init(params), None, ranks.torch_batch(batch), None)
    out = {f"{name}_loss": np.asarray(float(m["loss"]))}
    for i, x in enumerate(ranks.flat_np(params_to_numpy(cfg, p))):
        out[f"{name}_param_{i}"] = x
    return out


@pytest.mark.parametrize("dp", [1, 2])
@pytest.mark.parametrize("name", ranks.STEP_CFGS)
def test_family_step_matches_reference(grids, reference, name, dp):
    """dp 1 x tp 2 and dp 2 x tp 2: the loss and every updated param (SGD
    at lr 1: the clipped gradient) within 1e-5 of the reference's
    single-device step on the bridged params; the replicated leaves
    (mamba2's B / C projections and convs, a_log, dt_bias, d_skip, the
    norms, the vlm gates) the same bits on every model rank. The gated
    norm's sum over the ranks must sum its gradient too, and B / C's
    gradient must be summed once, or the params part. 'vlm-gather' (6
    heads over 3 KV heads) is held to the port's one-device step."""
    _, res = grids[dp]
    ref = (reference.result() if name in ranks.FAMILY_CFGS
           else _one_device_step(name))
    for r, got in enumerate(res):
        assert abs(float(got[f"{name}_loss"])
                   - float(ref[f"{name}_loss"])) < TOL
        i = 0
        while f"{name}_param_{i}" in ref:
            want = ref[f"{name}_param_{i}"]
            have = got[f"{name}_param_{i}"]
            assert have.shape == want.shape, (name, i)
            assert np.all(np.abs(have - want)
                          <= TOL * np.maximum(1.0, np.abs(want))), (name, i)
            i += 1
        assert i > 5
        mate = res[r ^ 1]
        assert got[f"{name}_replicated"].tobytes() == \
            mate[f"{name}_replicated"].tobytes()


def test_vlm_gather_layout_is_taken():
    """The 'vlm-gather' config's attention and cross-attention take the
    'gather' layout at tp 2 (its step is held above); the reduced vlm's
    take 'heads', mamba2's blocks 'heads'."""
    with tp.model_axis(RecordingGroup(2, 0, "model")):
        g = ranks.cfg_of("vlm-gather")
        assert tp.head_layout(g.num_heads, g.num_kv_heads,
                              g.resolved_head_dim) == "gather"
        v = ranks.cfg_of("llama-3.2-vision-11b")
        assert tp.head_layout(v.num_heads, v.num_kv_heads,
                              v.resolved_head_dim) == "heads"
        m = ranks.cfg_of("mamba2-370m")
        d_inner = m.ssm_expand * m.d_model
        assert tp.mamba_layout(d_inner, d_inner // m.ssm_head_dim) == "heads"


# ------------------------------------------------------ the mixed mamba case
def _mixed_cfg():
    """d_inner 96 over 3 heads of 32: tp 2 divides d_inner, not H."""
    return dataclasses.replace(ranks.cfg_of("mamba2-370m"), d_model=48,
                               ssm_head_dim=32)


@pytest.mark.parametrize("entry", ["forward", "decode_state"])
def test_mixed_mamba_split_is_refused(entry):
    """A degree that splits mamba2's d_inner but not its heads (96 over 3
    at tp 2) is refused naming both counts; at tp 1 the config runs."""
    cfg = _mixed_cfg()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.long)

    def run():
        if entry == "forward":
            return forward(cfg, params, toks)["hidden"]
        return init_decode_state(cfg, 1, 16, device="cpu")["ssm"]

    assert torch.isfinite(run()).all()
    with tp.model_axis(RecordingGroup(2, 0, "model")), \
            pytest.raises(NotImplementedError,
                          match="d_inner 96 but not its 3 heads"):
        run()


# ---------------------------------------------------------------- ZeRO-1
def test_zero1_mamba2_bitwise_dp2(grids):
    """dp 2 x tp 2 mamba2, three AdamW steps with ZeRO-1 moments: the
    params and the gathered moments the same bits as the step without,
    each rank's moment bytes smaller."""
    _, res = grids[2]
    for r in res:
        i = 0
        while f"z_plain_param_{i}" in r:
            assert r[f"z_plain_param_{i}"].tobytes() == \
                r[f"z_zero1_param_{i}"].tobytes(), i
            assert r[f"z_plain_nu_{i}"].tobytes() == \
                r[f"z_zero1_nu_{i}"].tobytes(), i
            i += 1
        assert i > 5
        assert int(r["z_zero1_moment_bytes"]) < \
            int(r["z_plain_moment_bytes"])


# ---------------------------------------------------------------- decode
@pytest.mark.parametrize("name", ranks.ENGINE_CFGS)
def test_tp_engine_tokens_equal_tp1(grids, name):
    """tp 2: the engine's MIDX-head tokens (the ssm carries split over
    d_inner and heads, zamba2's ring over its KV heads) equal tp 1's on
    both ranks."""
    from repro_torch.serve.engine import Engine
    _, res = grids[1]
    cfg, params, index = ranks.engine_setup(name)
    want = ranks.engine_tokens(Engine(cfg, params, index=index,
                                      device="cpu", seed=0))
    for r in res:
        assert np.array_equal(r[f"{name}_engine_tokens"], want)


@pytest.mark.parametrize("name", ranks.MEDIA_CFGS)
def test_tp_greedy_with_media_equal_tp1(grids, name):
    """tp 2: `make_decode_step`'s greedy tokens over a state whose cross
    K/V the ranks hold by KV head, or ('vlm-gather': 3 KV heads, 8 image
    tokens) by slices of the image tokens merged over the ranks, equal
    tp 1's."""
    _, res = grids[1]
    cfg = ranks.cfg_of(name)
    params, batch = ranks.setup(cfg)
    want = ranks.greedy(cfg, params, batch)
    for r in res:
        assert np.array_equal(r[f"{name}_greedy"], want)


def test_cross_cache_split_over_the_sequence():
    """Where the KV heads do not divide tp but the media's length does
    (the vlm at tp 16: 8 KV heads, 1600 image tokens), the ranks hold
    slices of the cross K/V's sequence, as `decode_cache_specs` cuts it;
    the decode state's shapes are the spec's slices."""
    cfg = get_config("llama-3.2-vision-11b")
    p_abs = steps.abstract_params(cfg)
    specs = shd.param_specs(cfg, p_abs, tp=16)
    local = shd.shard_by_spec(p_abs, specs, {"model": 16}, {"model": 3})
    with tp.model_axis(RecordingGroup(16, 3, "model")):
        cache = steps.abstract_decode_state(cfg, local, 8, 256)
    whole = steps.abstract_decode_state(cfg, p_abs, 8, 256)
    cs = shd.decode_cache_specs(cfg, whole, tp=16, multi_pod=False,
                                global_batch=8, dp_degree=1)
    for k in ("k", "cross_k", "cross_v"):
        want = list(whole[k].shape)
        d = shd.spec_dim(cs[k], "model")
        want[d] //= 16
        assert list(cache[k].shape) == want, k
    assert cache["cross_k"].shape[2] == cfg.num_image_tokens // 16


@pytest.mark.parametrize("name", ["mamba2-370m", "zamba2-7b"])
def test_decode_state_is_the_spec_slice(name):
    """The carries (and zamba2's ring) a rank allocates at tp 2 are the
    slices `decode_cache_specs` cuts from the whole state."""
    cfg = ranks.cfg_of(name)
    whole = init_decode_state(cfg, 4, 32, device="meta")
    with tp.model_axis(RecordingGroup(2, 1, "model")):
        local = init_decode_state(cfg, 4, 32, device="meta")
    cs = shd.decode_cache_specs(cfg, whole, tp=2, multi_pod=False,
                                global_batch=4, dp_degree=1)
    assert set(local) == set(whole)
    for k, v in whole.items():
        want = tuple(shd.shard_leaf(torch.empty(v.shape, device="meta"),
                                    cs[k], {"model": 2, "data": 1},
                                    {"model": 1}).shape)
        assert tuple(local[k].shape) == want, k


# ------------------------------------------------ restore across meshes
@pytest.mark.parametrize("mesh", [(1, 1), (2, 2)])
@pytest.mark.parametrize("name", ranks.SAVE_CFGS)
def test_restore_across_meshes(grids, name, mesh):
    """The checkpoint the (1, 2) grid saved restores onto every rank of
    another mesh with the bits of the slices cut from the original
    params."""
    out, _ = grids[1]
    cfg = ranks.cfg_of(name)
    params, _ = ranks.setup(cfg, seed=9)
    mgr = CheckpointManager(os.path.join(out, f"ckpt_{name}"))
    assert mgr.metadata(1)["mesh"] == [1, 2]
    d_n, t_n = mesh
    specs = steps.tp_param_specs(cfg, t_n)
    sizes = {"data": d_n, "model": t_n}
    for d in range(d_n):
        for m in range(t_n):
            coords = {"data": d, "model": m}
            got = restore_sharded(mgr, 1, params, specs, sizes, coords,
                                  device="cpu")
            want = shd.shard_by_spec(params, specs, sizes, coords)
            for a, b in zip(_leaves(got), _leaves(want)):
                assert a.shape == b.shape
                assert a.numpy().tobytes() == b.numpy().tobytes()


# ----------------------------------------- the plan against the ranks
@pytest.mark.parametrize("dp", [1, 2])
def test_plan_schedule_equals_ranks(grids, dp):
    """The recording groups' schedule of the mamba2 tp 2 step (the plan
    on meta) equals what the gloo ranks moved, op kind by op kind."""
    _, res = grids[dp]
    cfg = ranks.cfg_of("mamba2-370m")
    cell = dryrun.build_cell(
        cfg, "train", MeshDesc(("data", "model"), (dp, 2)),
        global_batch=ranks.B, seq_len=ranks.S, head_mode="full",
        moe_sharded=False, use_zero1=False)
    rec = dryrun.plan(cell, head_mode="full")
    for r in res:
        kinds = {k[len("events_"):] for k in r if k.startswith("events_")}
        assert kinds == {k for k in rec["collectives"]
                         if isinstance(rec["collectives"][k], dict)}
        for k in kinds:
            c = rec["collectives"][k]
            assert [c["count"], c["bytes"]] == r[f"events_{k}"].tolist()
