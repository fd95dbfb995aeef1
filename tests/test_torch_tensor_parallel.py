"""The model axis of the port (`dist.tensor_parallel`, `dist.sharding`'s
spec trees, the sharded MoE dispatch, ZeRO-1, the restore across meshes,
`attention.set_impl`) against the reference and the port's one-device
path, on the CPU.

The ranks are gloo CPU processes spawned once per grid for the file
(`tests/torch_tp_ranks.py`, which imports no JAX): dp 1 x tp 2 and dp 2 x
tp 2. The reference runs meanwhile in a subprocess on four forced host
devices, its sharded MoE dispatch on a hand-built `jax.sharding.Mesh`
(ROADMAP Queue 3 fact a: `jax.make_mesh`'s explicit axes fail here).
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

import torch_tp_ranks as ranks
from repro_torch.bridge import params_to_numpy
from repro_torch.checkpoint import CheckpointManager, restore_sharded
from repro_torch.configs import ARCHS
from repro_torch.configs import get_config as tget_config
from repro_torch.dist import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch import steps
from repro_torch.launch.mesh import MeshDesc, spawn_ranks
from repro_torch.models import attention as attn_mod
from repro_torch.models.decode import init_decode_state
from repro_torch.optim import adamw
from repro_torch.optim.optimizers import OptState, opt_state_specs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
# the step configs held to the reference's step; 'gather' (6 heads over 3
# KV heads) is held to the port's one-device step, itself held to the
# reference by the model's own tests
REF_CFGS = ("smollm-135m", "granite-moe-1b-a400m")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tier-1 run puts test files in parallel
    workers, and torch's thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------- the reference, 4 devices
def _reference_program(inp: str, outp: str) -> None:
    """In a subprocess with four forced host devices: the reference's
    single-device full-head step of each `REF_CFGS` config and its
    `apply_moe_sharded` on a hand-built (data 2, model 2) mesh."""
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs import get_config
    from repro.launch.steps import make_train_step
    from repro.models import init_params
    from repro.models import moe as jmoe
    from repro.optim import sgd

    d = dict(np.load(inp))
    out = {}
    for name in REF_CFGS:
        cfg = dataclasses.replace(get_config(name).reduced(),
                                  dtype="float32").with_head(mode="full")
        like, tdef = jax.tree_util.tree_flatten(jax.eval_shape(
            lambda: init_params(cfg, jax.random.PRNGKey(0))))
        params = tdef.unflatten([jnp.asarray(d[f"{name}_p{i}"])
                                 for i in range(len(like))])
        opt = sgd(1.0, momentum=0.0)
        batch = {"tokens": jnp.asarray(d[f"{name}_tokens"], jnp.int32),
                 "labels": jnp.asarray(d[f"{name}_labels"], jnp.int32)}
        new, _, m = jax.jit(make_train_step(cfg, opt, head_mode="full"))(
            params, opt.init(params), jnp.zeros(()), batch,
            jax.random.PRNGKey(0))
        out[f"{name}_loss"] = np.asarray(m["loss"])
        for i, x in enumerate(jax.tree_util.tree_leaves(new)):
            out[f"{name}_param_{i}"] = np.asarray(x)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))
    p = {k: jnp.asarray(d[f"moe_{k}"])
         for k in ("router", "w_gate", "w_up", "w_down")}
    p["shared"] = {k: jnp.asarray(d[f"moe_shared_{k}"])
                   for k in ("gate", "up", "down", "shared_gate")}
    x = jnp.asarray(d["moe_x"])
    jmoe.set_moe_mesh(mesh, ("data",), "model")
    for cf in (8.0, 1.25):
        y, aux = jax.jit(lambda x, cf=cf: jmoe.apply_moe_sharded(
            p, x, top_k=ranks.MOE["k"], capacity_factor=cf))(x)
        out[f"moe_{cf}_y"] = np.asarray(y)
        out[f"moe_{cf}_aux"] = np.asarray(aux)
    jmoe.set_moe_mesh(None)
    np.savez(outp, **out)


class _Reference:
    def __init__(self, tmp: str):
        inp = {}
        for name in REF_CFGS:
            cfg = ranks.cfg_of(name)
            params, toks, labels = ranks.setup(cfg)
            leaves = jax.tree_util.tree_leaves(params_to_numpy(cfg, params))
            inp.update({f"{name}_p{i}": x for i, x in enumerate(leaves)})
            inp[f"{name}_tokens"], inp[f"{name}_labels"] = toks, labels
        p, x = ranks.moe_inputs()
        for k, v in p.items():
            if k == "shared":
                inp.update({f"moe_shared_{j}": w.numpy()
                            for j, w in v.items()})
            else:
                inp[f"moe_{k}"] = v.numpy()
        inp["moe_x"] = x.numpy()
        self.inp = os.path.join(tmp, "in.npz")
        self.out = os.path.join(tmp, "out.npz")
        np.savez(self.inp, **inp)
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = os.pathsep.join(
            [os.path.join(REPO, "src"), os.path.join(REPO, "tests")])
        code = ("import sys, test_torch_tensor_parallel as t; "
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
    outs = {dp: str(tmp_path_factory.mktemp(f"tp2dp{dp}")) for dp in (1, 2)}

    def spawn(dp):
        spawn_ranks(ranks.scenarios, 1, (outs[dp],), dp=dp, tp=2,
                    device="cpu", backend="gloo", threads=1)

    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        for f in [ex.submit(spawn, dp) for dp in outs]:
            f.result()
    return {dp: (out, [dict(np.load(os.path.join(out, f"rank{r}.npz")))
                       for r in range(2 * dp)])
            for dp, out in outs.items()}


# ------------------------------------------------------ (a) the spec trees
def _ref_specs(tree, specs) -> dict:
    """path -> (spec tuple padded to the leaf's rank, ndim)."""
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    sflat = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    for (path, leaf), spec in zip(flat, sflat):
        names = tuple(getattr(k, "key", getattr(k, "name", None))
                      for k in path)
        names = tuple(n for n in names if isinstance(n, str))
        t = tuple(spec) + (None,) * (leaf.ndim - len(tuple(spec)))
        out[names] = (t, leaf.ndim)
    return out


def _port_specs(tree, specs) -> dict:
    """path -> (spec, ndim), layers collapsed (every layer the same)."""
    out = {}

    def one(names, leaf):
        return (names, leaf.dim())

    pairs = shd.tree_map_with_path(one, tree)
    for (names, nd), spec in zip(_leaves(pairs), _leaves(specs)):
        assert out.get(names, (spec, nd)) == (spec, nd), names
        out[names] = (spec, nd)
    return out


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _same(ref: dict, port: dict, dp: int = 0) -> None:
    """The same split dimension for every leaf (the reference stacks a
    layer's leaves [L, ...]: its spec then has one more entry in front).
    ZeRO-1 (`dp`): where the reference splits the stacked layer dimension
    over the data axes, the port's per-layer leaf takes its first unsplit
    dimension that dp divides (`dist.sharding.zero1_specs`)."""
    assert set(ref) == set(port), set(ref) ^ set(port)
    for names, (rs, rnd) in ref.items():
        ps, pnd = port[names]
        if rnd == pnd + 1:
            if dp and rs[0] is not None:
                shape = port_shapes[names]
                rs = list(rs[1:])
                d = next((i for i in range(pnd) if rs[i] is None
                          and shape[i] % dp == 0), None)
                if d is not None:
                    rs[d] = ref_entry(dp)
            else:
                assert rs[0] is None, names
                rs = rs[1:]
        assert tuple(rs) == tuple(ps), (names, rs, ps)


port_shapes: dict = {}


def ref_entry(dp: int):
    return ("pod", "data") if dp == 32 else "data"


def _ref_trees(arch: str):
    from repro.configs import get_config
    from repro.launch import steps as jsteps
    cfg = get_config(arch)
    p_abs = jsteps.abstract_params(cfg)
    cache = jsteps.abstract_decode_state(cfg, p_abs, 128, 32768)
    return cfg, p_abs, cache


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_spec_trees_match_reference(reference, arch):
    """param_specs at tp 1 / 2 / 16, zero1_specs and opt_state_specs at dp
    16 / 32, decode_cache_specs, batch_spec and index_specs: the split
    dimension of every leaf is the reference's. (Asking for `reference`
    starts its subprocess while these run.)"""
    del reference
    from repro import dist as jdist
    from repro.optim import opt_state_specs as jopt_specs
    jcfg, jp, jcache = _ref_trees(arch)
    cfg = tget_config(arch)
    pp = steps.abstract_params(cfg)
    meta = torch.device("meta")
    kw = {}
    if cfg.family == "vlm":
        kw["image_emb"] = torch.empty((128, cfg.num_image_tokens,
                                       cfg.d_model), device=meta)
    if cfg.family == "audio":
        kw["frames"] = torch.empty((128, cfg.encoder_seq, cfg.d_model),
                                   device=meta)
    cache = init_decode_state(cfg, 128, 32768, device=meta, params=pp, **kw)
    port_shapes.clear()
    port_shapes.update({k: v[0][0] for k, v in _port_specs(
        pp, shd.tree_map_with_path(lambda _, x: (tuple(x.shape),),
                                   pp)).items()})
    for tpn in (1, 2, 16):
        js = jdist.param_specs(jcfg, jp, tp=tpn)
        ps = shd.param_specs(cfg, pp, tp=tpn)
        _same(_ref_specs(jp, js), _port_specs(pp, ps))
        for dp in (16, 32):
            axes = ("pod", "data") if dp == 32 else ("data",)
            _same(_ref_specs(jp, jdist.zero1_specs(js, jp, dp=dp,
                                                   data_axes=axes)),
                  _port_specs(pp, shd.zero1_specs(ps, pp, dp=dp,
                                                  data_axes=axes)), dp)
            jo = jopt_specs(js, jp, adamw_state_like(jp), dp=dp,
                            data_axes=axes)
            po = opt_state_specs(ps, pp, OptState(0, pp, pp), dp=dp,
                                 data_axes=axes)
            _same(_ref_specs(jp, jo.nu), _port_specs(pp, po.nu), dp)
            for mp in (False, True):
                jc = jdist.decode_cache_specs(
                    jcfg, jcache, tp=tpn, multi_pod=mp, global_batch=128,
                    dp_degree=dp)
                pc = shd.decode_cache_specs(
                    cfg, cache, tp=tpn, multi_pod=mp, global_batch=128,
                    dp_degree=dp)
                _same(_ref_specs(jcache, jc), _port_specs(cache, pc))
                for gb in (256, 1):
                    assert tuple(jdist.batch_spec(mp, global_batch=gb,
                                                  dp=dp)) == \
                        shd.batch_spec(mp, global_batch=gb, dp=dp)
    idx = shd.index_specs(steps.abstract_index(cfg))
    assert all(s is None or all(e is None for e in s)
               for s in idx.values())


def adamw_state_like(p):
    """An OptState of the reference's with nu present (its specs only
    look at `nu is None`)."""
    from repro.optim import OptState as JOpt
    return JOpt(None, p, p)


def test_shard_then_gather_bitwise(grids):
    """shard_by_spec -> the ranks' gather_by_spec gives the replicated tree
    bit for bit (held through the checkpoint the ranks gathered)."""
    out, _ = grids[2]
    cfg = ranks.cfg_of("smollm-135m")
    params, _, _ = ranks.setup(cfg, seed=9)
    got = CheckpointManager(os.path.join(out, "ckpt")).restore(
        1, params, device="cpu")
    for a, b in zip(_leaves(params), _leaves(got)):
        assert a.numpy().tobytes() == b.numpy().tobytes()


# --------------------------------------- (b) the tp 2 step vs the reference
def _one_device_step(name: str) -> dict:
    """The port's one-device full-head SGD step of a `ranks` config, in
    the reference's leaf order."""
    from repro_torch.optim import sgd
    cfg = ranks.cfg_of(name)
    params, toks, labels = ranks.setup(cfg)
    opt = sgd(1.0, momentum=0.0)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    p, _, m = steps.make_train_step(cfg, opt)(params, opt.init(params),
                                             None, batch, None)
    out = {f"{name}_loss": np.asarray(float(m["loss"]))}
    for i, x in enumerate(ranks.flat_np(params_to_numpy(cfg, p))):
        out[f"{name}_param_{i}"] = x
    return out


@pytest.mark.parametrize("dp", [1, 2])
@pytest.mark.parametrize("name", ranks.STEP_CFGS)
def test_tp_step_matches_reference(grids, reference, name, dp):
    """dp 1 x tp 2 and dp 2 x tp 2: the loss and every updated param (SGD
    at lr 1: the clipped gradient) within 1e-5 of the reference's
    single-device step on the bridged params; the replicated leaves the
    same bits on every model rank (their gradients are not all-reduced
    again). 'gather' is held to the port's one-device step."""
    _, res = grids[dp]
    ref = (reference.result() if name in REF_CFGS
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


# ------------------------------------------ (c) the sharded MoE dispatch
@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_moe_sharded_dispatch_matches_reference(grids, reference, cf):
    """The ranks' y rows (data rank d's, model rank 0's and 1's equal) and
    aux against the reference's `apply_moe_sharded` on a (2, 2) mesh; at
    1.25 tokens are dropped (the inputs share a direction, so the router
    favours two experts)."""
    _, res = grids[2]
    ref = reference.result()
    y = np.concatenate([res[2 * d][f"moe_{cf}_y"] for d in range(2)])
    assert np.allclose(y, ref[f"moe_{cf}_y"], atol=2e-6, rtol=1e-5)
    for d in range(2):
        assert res[2 * d][f"moe_{cf}_y"].tobytes() == \
            res[2 * d + 1][f"moe_{cf}_y"].tobytes()
    for r in res:
        assert abs(float(r[f"moe_{cf}_aux"])
                   - float(ref[f"moe_{cf}_aux"])) < TOL
    from repro_torch.models.moe import route
    p, x = ranks.moe_inputs()
    m = ranks.MOE
    r = route(p, x[:m["b"] // 2].reshape(1, -1, m["d"]), top_k=m["k"],
              capacity_factor=cf)
    assert bool((r.counts > r.cap).any()) == (cf == 1.25)


@pytest.mark.parametrize("name", ranks.BF16_CFGS)
def test_tp_prefill_bf16_within_one_device_bar(grids, name):
    """dp 1 x tp 2 in bf16: the prefill's logits are no further from the
    one-device fp32 logits than twice the one-device bf16 prefill's."""
    _, res = grids[1]
    cfg = ranks.cfg_of(name)
    params, toks, _ = ranks.setup(cfg)
    batch = {"tokens": torch.from_numpy(toks)}
    with torch.no_grad():
        f32 = steps.make_prefill_step(cfg)(params, batch).numpy()
        bf16 = steps.make_prefill_step(dataclasses.replace(
            cfg, dtype="bfloat16"))(params, batch).float().numpy()
    own = np.abs(bf16 - f32).max()
    assert own > 0
    for r in res:
        assert np.abs(r[f"{name}_bf16_logits"] - f32).max() <= 2.0 * own


# ------------------------------------------------------------- (d) ZeRO-1
def test_zero1_params_bitwise_dp2(grids):
    """Three AdamW steps with ZeRO-1 moments at dp 2: the params and the
    gathered moments the same bits as the step without, each rank's moment
    bytes smaller."""
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


# ------------------------------------------------ (e) restore across meshes
@pytest.mark.parametrize("mesh", [(1, 2), (4, 1), (1, 1), (2, 2)])
def test_restore_across_meshes(grids, mesh):
    """The checkpoint four ranks at (dp, tp) = (2, 2) saved restores onto
    every rank of another mesh with the values of the slices cut from the
    original params."""
    out, _ = grids[2]
    cfg = ranks.cfg_of("smollm-135m")
    params, _, _ = ranks.setup(cfg, seed=9)
    mgr = CheckpointManager(os.path.join(out, "ckpt"))
    assert mgr.metadata(1)["mesh"] == [2, 2]
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


# --------------------------------------------------------- decode under TP
def test_tp_decode_tokens_equal_tp1(grids):
    """tp 2: the engine's MIDX-head tokens (paged pool, KV heads split) and
    `decode_step`'s greedy tokens over the sequence-sharded cache (6 heads
    over 3 KV heads) equal tp 1's."""
    _, res = grids[1]
    from repro_torch.serve.engine import Engine
    cfg, params, index = ranks.engine_setup()
    want = ranks.engine_tokens(Engine(cfg, params, index=index,
                                      device="cpu", seed=0))
    gcfg = ranks.cfg_of("gather")
    gparams, toks, _ = ranks.setup(gcfg)
    gwant = ranks.greedy(gcfg, gparams, toks)
    for r in res:
        assert np.array_equal(r["engine_tokens"], want)
        assert np.array_equal(r["decode_tokens"], gwant)


# ----------------------------- (g) the plan's schedule against the ranks
@pytest.mark.parametrize("dp", [1, 2])
def test_plan_schedule_equals_ranks(grids, dp):
    """The recording groups' schedule of the smollm tp 2 step (the plan on
    meta) equals what the gloo ranks moved, op kind by op kind."""
    _, res = grids[dp]
    cfg = ranks.cfg_of("smollm-135m")
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


# ---------------------------------------------------- (f) set_impl switch
@pytest.mark.parametrize("causal", [True, False])
def test_set_impl_autodiff_matches_flash(causal):
    """The chunked path with "autodiff" (autograd through the plain
    blockwise forward) against "flash" (the recompute backward): the same
    forward, the gradients within the fp32 bar."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 64, 4, 16), generator=g, requires_grad=True)
    k = torch.randn((2, 64, 2, 16), generator=g, requires_grad=True)
    v = torch.randn((2, 64, 2, 16), generator=g, requires_grad=True)
    w = torch.randn((2, 64, 4, 16), generator=g)
    outs = {}
    for impl in ("flash", "autodiff"):
        attn_mod.set_impl(impl)
        try:
            o = attn_mod.attention(q, k, v, causal=causal,
                                   direct_threshold=16, q_chunk=16,
                                   kv_chunk=32)
            outs[impl] = (o.detach(), torch.autograd.grad(
                (o * w).sum(), (q, k, v)))
        finally:
            attn_mod.set_impl("flash")
    assert torch.equal(outs["flash"][0], outs["autodiff"][0])
    for a, b in zip(outs["flash"][1], outs["autodiff"][1]):
        assert torch.allclose(a, b, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):
        attn_mod.set_impl("xla")


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-1b-a400m",
                                  "mamba2-370m", "zamba2-7b",
                                  "llama-3.2-vision-11b", "whisper-tiny"])
def test_tp_step_at_one_rank_is_the_one_device_step(arch):
    """A grid of one rank: `make_sharded_train_step` is `make_train_step` bit
    for bit (MIDX head, two AdamW steps; the vlm's and whisper's batches
    carry their media), its norm summed as the one-device clip sums it."""
    from repro_torch.core import noise
    from repro_torch.dist.collectives import RecordingGroup
    from repro_torch.launch.mesh import RankGrid
    from repro_torch.models import heads, init_params
    cfg = dataclasses.replace(tget_config(arch).reduced(), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    index = heads.init_head_state(cfg, params,
                                  torch.Generator().manual_seed(1))
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16)))
             for k in ("tokens", "labels")}
    media = {"vlm": ("image_emb", cfg.num_image_tokens),
             "audio": ("frames", cfg.encoder_seq)}.get(cfg.family)
    if media is not None:
        batch[media[0]] = torch.from_numpy(rng.standard_normal(
            (4, media[1], cfg.d_model)).astype(np.float32))
    grid = RankGrid(0, 1, torch.device("cpu"), "gloo", None, 1, 0,
                    RecordingGroup(1, 0, "data"), 1, 0,
                    RecordingGroup(1, 0, "model"))
    out = []
    for tp_step in (False, True):
        p = shd.shard_by_spec(params, steps.tp_param_specs(cfg, 1),
                              {}, {})
        opt = adamw(1e-2)
        o = opt.init(p)
        step = (steps.make_sharded_train_step(cfg, opt, grid) if tp_step
                else steps.make_train_step(cfg, opt))
        for i in range(2):
            keys = noise.train_keys(7, i, 64)
            res = step(p, o, index, batch, keys)
            p, o, met = res[0], res[1], res[2]
        out.append((float(met["grad_norm"]), p))
    assert out[0][0] == out[1][0]
    for a, b in zip(_leaves(out[0][1]), _leaves(out[1][1])):
        assert torch.equal(a, b)
