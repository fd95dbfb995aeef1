"""The port's dry run (`repro_torch.launch.dryrun`): one rank's program of
a cell planned on the meta device, on the CPU, without JAX.

What the plan reads is held here against what it stands for: a cell's
argument bytes against the bytes of the spec trees' slices, the roofline
against the named H100 constants, the calibration variants against the
linear law, and every family's cells under the model axis. The schedule of the recording groups is held against what gloo
ranks moved in `tests/test_torch_tensor_parallel.py`.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.dist import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh, mesh_dp_tp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _slice_bytes(tree, specs, sizes) -> int:
    """Bytes of a rank's slices: each leaf's bytes over the degrees of the
    axes its spec splits."""
    total = 0
    for x, s in zip(_leaves(tree), _leaves(specs)):
        n = 1
        for e in s:
            for a in (e if isinstance(e, tuple) else (e,)):
                n *= sizes.get(a, 1) if a is not None else 1
        total += x.numel() * x.element_size() // n
    return total


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_train_cell_argument_bytes_are_the_spec_slices(multi_pod):
    """paper-lm train_4k: the plan's argument bytes are the params' slices
    under param_specs, the AdamW moments' under zero1_specs (two of them),
    the local index view over the rank's rows, and the rank's batch rows
    and keys; the roofline is the named H100 constants'."""
    cfg = get_config("paper-lm")
    mesh = make_production_mesh(multi_pod=multi_pod)
    dp, tpn = mesh_dp_tp(mesh)
    sizes = mesh.sizes
    cell = dryrun.build_cell(cfg, "train", mesh, global_batch=256,
                             seq_len=4096)
    p = steps.abstract_params(cfg)
    ps = shd.param_specs(cfg, p, tp=tpn)
    axes = ("pod", "data") if multi_pod else ("data",)
    zs = shd.zero1_specs(ps, p, dp=dp, data_axes=axes)
    rows = cfg.padded_vocab // tpn
    k = cfg.head.midx_k
    dq = cfg.d_model // 2 if cfg.head.quantizer == "pq" else cfg.d_model
    index = 8 * (3 * rows + 2 * k * k + 1) + 4 * (2 * k * dq + k * k)
    b = 256 // dp
    want = (_slice_bytes(p, ps, sizes) + 2 * _slice_bytes(p, zs, sizes)
            + index + 3 * 8 * b * 4096)
    assert cell.arg_bytes == want
    rec = dryrun.plan(cell, shape_name="train_4k")
    assert rec["memory"]["argument_bytes"] == want
    assert rec["memory"]["peak_bytes"] > want
    r, hw = rec["roofline"], rec["hw"]
    assert hw["peak_flops"] == 989e12 and hw["hbm_bw"] == 3.35e12
    assert r["compute_s"] == rec["flops_per_device"] / 989e12
    assert r["memory_s"] == rec["bytes_per_device"] / 3.35e12
    assert rec["chips"] == (512 if multi_pod else 256)
    assert rec["flops_per_device"] > 0
    # a 16-way model axis spans two 8-GPU nodes: InfiniBand
    assert dryrun.link_bw("model", mesh.sizes) == 50e9
    assert dryrun.link_bw("model", {"data": 2, "model": 2}) == 450e9


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_serving_cells_plan(shape, tmp_path):
    """A dense and a moe serving cell (2 layers) plan and write the
    reference's keys; decode's cache is the spec's slice (KV heads over
    the model ranks where they divide, else the sequence)."""
    for arch in ("llama3.2-1b", "granite-moe-1b-a400m"):
        rec = dryrun.run_cell(arch, shape, multi_pod=False,
                              layers_override=2, out_dir=str(tmp_path),
                              save_trace=True)
        for key in ("arch", "shape", "kind", "head", "mesh", "chips",
                    "flops_per_device", "bytes_per_device", "memory",
                    "collectives", "roofline", "plan_s"):
            assert key in rec
        tag = f"{arch}__{shape}__single__midx"
        with open(tmp_path / f"{tag}.json") as f:
            assert json.load(f)["kind"] == rec["kind"]
        assert (tmp_path / f"{tag}.trace.json").exists()
    cfg = get_config("llama3.2-1b")
    cell = dryrun.build_cell(cfg, "decode", make_production_mesh(),
                             global_batch=128, seq_len=32768)
    k = cell.args[1]["k"]
    # llama's 8 KV heads do not divide 16: the sequence is split
    assert tuple(k.shape) == (cfg.num_layers, 8, 32768 // 16, 8, 64)


def test_calibrate_variants_follow_the_linear_law(tmp_path):
    """Eager counting sees every layer: flops, bytes and collective bytes
    of the L = 0, 1, 2 variants are linear in L, exactly."""
    out = dryrun.calibrate_cell("paper-lm", "decode_32k", multi_pod=False,
                                out_dir=str(tmp_path))
    assert out["linear"]
    v = out["variants"]
    assert v["2"]["flops"] > v["1"]["flops"] > v["0"]["flops"]


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b",
                                  "llama-3.2-vision-11b", "whisper-tiny"])
def test_other_families_plan(arch, tmp_path):
    """ssm / hybrid / vlm / audio decode cells plan at tp 16 through the
    CLI: `main` returns (exit 0), the JSON is written, and the model
    axis's collectives are in it (the vlm's cross K/V split over its 1600
    image tokens merges over the model ranks)."""
    dryrun.main(["--arch", arch, "--shape", "decode_32k", "--mesh",
                 "single", "--out", str(tmp_path)])
    with open(tmp_path / f"{arch}__decode_32k__single__midx.json") as f:
        rec = json.load(f)
    assert rec["mesh"] == [16, 16]
    c = rec["collectives"]
    assert c["all-reduce"]["count"] > 0 and c["total_bytes"] > 0
    assert rec["flops_per_device"] > 0


@pytest.mark.parametrize("arch", ["zamba2-7b", "llama-3.2-vision-11b"])
def test_calibrate_family_twins_plan_under_tp(arch, tmp_path):
    """The hybrid's and the vlm's train_4k calibration at tp 16: the L =
    0, 1, 2 variants (the shared block or a cross block unread at L = 0,
    its gradient zero) and the L = 0, 1 family twins plan, linearly."""
    out = dryrun.calibrate_cell(arch, "train_4k", multi_pod=False,
                                out_dir=str(tmp_path))
    assert out["linear"]
    assert set(out["variants"]) == {"0", "1", "2", "twin0", "twin1"}
    assert all(v["collective_bytes"] > 0 for v in out["variants"].values())


def test_port_and_plan_import_without_jax(tmp_path):
    """`repro_torch` and the plan run with JAX unimportable."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.launch.dryrun as d; "
            "r = d.run_cell('smollm-135m', 'decode_32k', multi_pod=False, "
            "layers_override=1, write=False); "
            "assert r['flops_per_device'] > 0")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]


def test_vocab_parallel_cell_plans_over_the_vocab_axis():
    """`--vocab-parallel 2` (paper-lm train_4k): the backbone replicated,
    the class table and index split over the vocab axis (16 x 8 x 2), the
    vocab group's collectives in the schedule."""
    rec = dryrun.run_cell("paper-lm", "train_4k", multi_pod=False,
                          vocab_parallel=2, write=False)
    assert rec["vocab_parallel"] == 2 and rec["mesh"] == [16, 8, 2]
    assert rec["collectives"]["all-reduce"]["count"] > 0
    with pytest.raises(ValueError, match="train cells"):
        dryrun.run_cell("paper-lm", "decode_32k", multi_pod=False,
                        vocab_parallel=2, write=False)
