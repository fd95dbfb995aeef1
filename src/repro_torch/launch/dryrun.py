"""The dry run: plan every (arch x shape x mesh) cell on the meta device.

Mirrors `src/repro/launch/dryrun.py`: `cells_for` (:44), `parse_collectives`'
ring model (:93-127), `lower_cell` (:153-294), `analyze` (:297),
`lower_refresh_cell` (:334), `run_cell` (:358), `calibrate_cell` (:405)
and `main` (:466), with the reference's CLI. Where the reference lowers
and compiles one SPMD program over 256 or 512 placeholder devices, the
plan builds ONE rank's program, the rank at coordinate 0 of every axis of
the mesh description (`launch.mesh.make_production_mesh`), from the code
the ranks run: its params cut by `param_specs` (`shard_by_spec`), ZeRO-1
moments (`zero1_specs`), the replicated index (`index_specs`) or its
vocab shard, the decode cache (`decode_cache_specs`), its rows of the
batch (`batch_spec`), the sharded MoE dispatch (`models.moe`) and
`attention.set_impl`. The program runs on `torch.device("meta")`: shapes
and dtypes only, nothing computed, nothing drawn, so any cell plans on a
CPU. Every collective goes to a `dist.collectives.RecordingGroup`, which
moves nothing and notes the op, its group size and its bytes: the
schedule is the port's own. On meta the kernels' plain versions run
(`kernels.dispatch`), so their work is counted. `--fused-head` maps as
on / interpret -> the fused route (the wrappers' plain versions here;
there is no interpret mode), off -> the unfused route, auto -> the
config's `use_fused_head`.

What is measured, per rank:
  flops_per_device  `torch.utils.flop_counter.FlopCounterMode` (matmuls,
                    einsums, attention products) over the whole step;
  bytes_per_device  the bytes every op other than a view reads and
                    writes; a kernel's call counts its tensor arguments and
                    results only (`kernels.dispatch`'s kernel scope: its
                    temporaries stay on chip);
  memory            a dispatch-mode tracker of live tensors (not
                    `MemTracker`): arguments (params, moments, index,
                    batch, cache), outputs (new tensors the step returns),
                    peak (arguments + the most bytes the step's own
                    allocations held at once) and temp (peak - arguments);
  collectives       {kind: {count, bytes, ring_bytes}} from the recording
                    groups; the ring model sends 2 (n - 1) / n of an
                    all-reduce's buffer and (n - 1) / n of an all-gather's
                    result. It prices the port's own schedule: a gradient
                    is all-reduced whole, ZeRO-1 included (no reduce-
                    scatter, which gloo lacks for CUDA tensors), where
                    NCCL's ZeRO-1 would reduce-scatter it for half the
                    bytes;
  roofline          compute_s = flops / peak, memory_s = bytes / HBM,
                    collective_s = each event's ring bytes over its axis's
                    link, and the dominant term.
Eager counting sees every layer as it runs, so there is no while-loop
undercount to calibrate away: `--calibrate` writes the reference's L = 0,
1, 2 variants and checks that they follow the linear law exactly.

H100 constants (data-sheet figures for "NVIDIA H100 80GB HBM3, 700.00 W",
none measured): 989 TFLOP/s dense bf16 and 3.35 TB/s HBM per device; a
mesh axis whose group fits in one 8-GPU node rides NVLink 4 at 450 GB/s a
direction, a wider one (a 16-way axis spans two nodes) 400 Gb/s
InfiniBand, 50 GB/s a GPU. The reference's TPU dict (:37-41) is not used.

The model axis covers every family (dense, moe, ssm, hybrid, vlm,
audio): a vlm or audio cell's batch carries the rank's rows of the
stubbed media (`steps.media_batch`), and its decode cache the cross K/V
over them, as the reference's `batch_struct` and
`abstract_decode_state`. A failing cell makes `--all` exit 1, as the
reference's does on any failure.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
Outputs go to experiments/dryrun_torch/ (git-ignored).
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import LM_SHAPES, ShapeConfig, shape_by_name
from repro_torch.dist import collectives as coll
from repro_torch.dist import sharding as shd
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist.vocab_parallel import local_index
from repro_torch.kernels.dispatch import kernel_scope
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import (MeshDesc, RankGrid,
                                     make_production_mesh, mesh_dp_tp)
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.optim import adamw
from repro_torch.optim.optimizers import OptState, zero1

# pure full-attention archs skip long_500k (quadratic at 500k, DESIGN §5)
LONG_OK_FAMILIES = ("ssm", "hybrid")

HW = {  # NVIDIA H100 80GB HBM3 (SXM, 700 W) data-sheet figures
    "device": "NVIDIA H100 80GB HBM3, 700.00 W (data sheet, not measured)",
    "peak_flops": 989e12,       # dense bf16 tensor-core FLOP/s
    "hbm_bw": 3.35e12,          # HBM3 bytes/s
    "nvlink_bw": 450e9,         # NVLink 4, bytes/s a direction, in a node
    "ib_bw": 50e9,              # 400 Gb/s InfiniBand, bytes/s a GPU
    "gpus_per_node": 8,
    "collective_schedule": "the port's: gradients all-reduced whole "
                           "(ZeRO-1 too, no reduce-scatter), all-gathers "
                           "real; ring model 2(n-1)/n of an all-reduce, "
                           "(n-1)/n of an all-gather",
}

def cells_for(arch: str) -> list[ShapeConfig]:
    cfg = get_config(arch)
    return [s for s in LM_SHAPES
            if s.name != "long_500k" or cfg.family in LONG_OK_FAMILIES]


_SCOPE = kernel_scope()


# ---------------------------------------------------------------- tracking
class _Tracker(TorchDispatchMode):
    """Live bytes of the tensors the ops allocate (a fresh, non-aliasing
    output counts until it is freed), the bytes every op other than a
    view reads and writes, and the ops run."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.accessed = 0
        self.ops: collections.Counter = collections.Counter()

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops[str(func.overloadpacket)] += 1
        if _SCOPE["depth"]:
            return out                # a kernel's plain version: on chip
        schema = func._schema
        fresh = [r.alias_info is None for r in schema.returns]
        if schema.returns and not any(fresh) and not schema.is_mutable:
            return out                                    # a view
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        written = [t for a, x in zip(schema.arguments, args)
                   if a.alias_info is not None and a.alias_info.is_write
                   for t in tree_flatten(x)[0]
                   if isinstance(t, torch.Tensor)]
        self._account(ins, outs, written)
        return out

    def _account(self, ins, outs, written=()) -> None:
        in_ids = {id(t) for t in ins}
        new = [t for t in outs if id(t) not in in_ids and not t._is_view()]
        self.accessed += sum(t.numel() * t.element_size()
                             for t in ins + new + list(written))
        for t in new:
            n = t.untyped_storage().nbytes()
            self.live += n
            weakref.finalize(t, self._free, n)
        self.peak = max(self.peak, self.live)

    def kernel_call(self, ins, outs) -> None:
        """A kernel's meta call: what it reads and writes, and its
        results as the step's own allocations (its temporaries stay on
        chip)."""
        self._account(ins, outs)


def _tensors(*trees) -> list:
    out = []
    for tree in trees:
        if dataclasses.is_dataclass(tree):
            tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
        elif isinstance(tree, OptState):
            tree = [tree.mu, tree.nu]
        if isinstance(tree, dict):
            out += _tensors(*tree.values())
        elif isinstance(tree, (list, tuple)):
            out += _tensors(*tree)
        elif isinstance(tree, torch.Tensor):
            out.append(tree)
    return out


def arg_bytes(*trees) -> int:
    """Bytes of the distinct tensors of the trees (params, OptState,
    MultiIndex and dict / list trees)."""
    seen, total = set(), 0
    for t in _tensors(*trees):
        if id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


def link_bw(axis: Optional[str], sizes: dict) -> float:
    """Bytes/s of the link an axis's collectives ride: NVLink where its
    group fits in one node (the axes inner to it times its own size <= 8),
    InfiniBand otherwise."""
    order = [a for a in ("pod", "data", "model", "vocab") if a in sizes]
    if axis not in order:
        return HW["nvlink_bw"]
    span = 1
    for a in order[order.index(axis):]:
        span *= sizes[a]
    return HW["nvlink_bw"] if span <= HW["gpus_per_node"] else HW["ib_bw"]


def collective_record(events: list, sizes: dict) -> dict:
    out = {k: {"count": v["count"], "bytes": v["bytes"],
               "ring_bytes": v["ring_bytes"]}
           for k, v in coll.summarize(events).items()}
    out["total_bytes"] = sum(e.ring_bytes for e in events)
    out["seconds"] = sum(e.ring_bytes / link_bw(e.axis, sizes)
                         for e in events)
    return out


def measure(fn) -> tuple:
    """Run fn() under the trackers -> (result, record)."""
    tr = _Tracker()
    _SCOPE.update(meta=True, hook=tr.kernel_call)
    try:
        with coll.counting() as events, \
                FlopCounterMode(display=False) as fc, tr:
            res = fn()
    finally:
        _SCOPE.update(meta=False, hook=None)
    return res, {"flops": float(fc.get_total_flops()),
                 "bytes": float(tr.accessed), "peak_temp": tr.peak,
                 "events": events, "ops": dict(tr.ops)}


# ------------------------------------------------------------ cell runner
_FUSED_HEAD_MODES = {"auto": None, "on": True, "interpret": True,
                     "off": False}


@dataclasses.dataclass
class Cell:
    """One rank's program of a cell, ready to run on meta."""
    cfg: object
    kind: str
    mesh: MeshDesc
    fn: object
    args: tuple
    arg_bytes: int


def _grid(mesh: MeshDesc, *, vocab_parallel: int = 1) -> RankGrid:
    dp, tpn = mesh_dp_tp(mesh)
    meta = torch.device("meta")
    data = coll.RecordingGroup(dp, 0, "data")
    if vocab_parallel > 1:
        return RankGrid(0, vocab_parallel, meta, "recording",
                        coll.RecordingGroup(vocab_parallel, 0, "vocab"), dp,
                        0, data)
    return RankGrid(0, 1, meta, "recording", None, dp, 0, data, tpn, 0,
                    coll.RecordingGroup(tpn, 0, "model"))


def configure(arch: str, *, layers_override: Optional[int] = None,
              family_twin: bool = False, pad_heads: bool = False,
              proposal: Optional[str] = None,
              refresh_every: Optional[int] = None,
              refresh_policy: Optional[str] = None,
              vocab_parallel: int = 1, vocab_size: Optional[int] = None,
              table_dtype: Optional[str] = None):
    """The cell's config, rewritten as `lower_cell` rewrites it."""
    cfg = get_config(arch)
    if vocab_size is not None:
        cfg = dataclasses.replace(
            cfg, vocab_size=vocab_size,
            vocab_pad_multiple=max(cfg.vocab_pad_multiple,
                                   8 * vocab_parallel))
    if proposal is not None:
        cfg = cfg.with_head(proposal=proposal)
    if table_dtype is not None:
        cfg = cfg.with_head(table_dtype=table_dtype)
    if refresh_every is not None:
        cfg = cfg.with_head(refresh_every=refresh_every)
    if refresh_policy is not None:
        cfg = cfg.with_head(refresh_policy=refresh_policy)
    if pad_heads and cfg.num_heads and (cfg.num_heads % 16 or
                                        cfg.num_kv_heads % 16):
        hd = cfg.resolved_head_dim
        cfg = dataclasses.replace(
            cfg, num_heads=((cfg.num_heads + 15) // 16) * 16,
            num_kv_heads=((cfg.num_kv_heads + 15) // 16) * 16, head_dim=hd)
    if layers_override is not None:
        cfg = dataclasses.replace(
            cfg, num_layers=layers_override,
            encoder_layers=min(cfg.encoder_layers, layers_override))
    if family_twin:
        if cfg.family == "vlm":
            cfg = dataclasses.replace(cfg, family="dense",
                                      cross_attn_every=0,
                                      num_image_tokens=0)
        elif cfg.family == "hybrid":
            cfg = dataclasses.replace(cfg, family="ssm",
                                      hybrid_attn_every=0)
    return cfg


def build_cell(cfg, kind: str, mesh: MeshDesc, *, global_batch: int,
               seq_len: int, head_mode: str = "midx",
               window: Optional[int] = None, fused_head: str = "auto",
               moe_sharded: bool = True, use_zero1: bool = True,
               vocab_parallel: int = 1, optimizer=None) -> Cell:
    """One rank's train / prefill / decode program of a cell on meta;
    `optimizer` (default AdamW, as the reference plans) under ZeRO-1 where
    `use_zero1` and the data degree is above 1."""
    if vocab_parallel > 1 and (kind != "train" or head_mode != "midx"):
        raise ValueError("--vocab-parallel applies to train cells with the "
                         "midx head only")
    meta = torch.device("meta")
    grid = _grid(mesh, vocab_parallel=vocab_parallel)
    dp, tpn = grid.dp, grid.tp
    bspec = shd.batch_spec("pod" in mesh.axis_names,
                           global_batch=global_batch, dp=dp)
    b = global_batch // dp if bspec else global_batch
    p_abs = steps_mod.abstract_params(cfg)
    sizes = {"data": dp, "model": tpn}
    coords = {"data": 0, "model": 0}
    if vocab_parallel > 1:
        params = shd.shard_params(p_abs, vocab_parallel, 0)
    else:
        params = shd.shard_by_spec(
            p_abs, shd.param_specs(cfg, p_abs, tp=tpn), sizes, coords)

    def ids(*shape):
        return torch.empty(shape, dtype=torch.int64, device=meta)

    if kind == "train":
        opt = optimizer or adamw(1e-4)
        if use_zero1 and vocab_parallel == 1 and dp > 1:
            opt = zero1(opt, steps_mod.zero1_dims(cfg, grid), grid.data_pg)
        opt_state = opt.init(params)
        batch = {"tokens": ids(b, seq_len), "labels": ids(b, seq_len),
                 **steps_mod.media_batch(cfg, b, meta)}
        keys = ids(b * seq_len)
        fh = _FUSED_HEAD_MODES[fused_head]
        if vocab_parallel > 1:
            index = local_index(steps_mod.abstract_vocab_index(
                cfg, p_abs, vocab_parallel), 0)
            step = steps_mod.make_vocab_parallel_train_step(
                cfg, opt, grid, window=window, fused_head=fh)
            args = (params, opt_state, index, batch, keys)
        else:
            split = tpn > 1 and cfg.padded_vocab % tpn == 0
            index = (steps_mod.abstract_index(
                cfg, rows=cfg.padded_vocab // tpn if split else None)
                if head_mode == "midx" else None)
            step = steps_mod.make_sharded_train_step(
                cfg, opt, grid, head_mode=head_mode, window=window,
                fused_head=fh, moe_sharded=moe_sharded and bool(bspec))
            args = (params, opt_state, index, batch, keys)
        return Cell(cfg, kind, mesh, step, args,
                    arg_bytes(params, opt_state, index, batch, keys))
    moe_on = moe_sharded and bool(bspec) and cfg.family == "moe"
    prefill = steps_mod.make_prefill_step(cfg, window=window)
    decode = steps_mod.make_decode_step(cfg, window=window)

    def run_in_axis(fn):
        def run(*a):
            with tp.model_axis(grid.model_pg if tpn > 1 else None), \
                    moe_mod.sharded_dispatch(moe_on, grid.data_pg), \
                    torch.no_grad():
                return fn(*a)
        return run

    if kind == "prefill":
        batch = {"tokens": ids(b, seq_len),
                 **steps_mod.media_batch(cfg, b, meta)}
        return Cell(cfg, kind, mesh, run_in_axis(prefill),
                    (params, batch), arg_bytes(params, batch))
    with tp.model_axis(grid.model_pg if tpn > 1 else None):
        cache = steps_mod.abstract_decode_state(cfg, params, b, seq_len,
                                                window=window)
    args = (params, cache, ids(b), ids(b))
    return Cell(cfg, kind, mesh, run_in_axis(decode), args,
                arg_bytes(params, cache) + 2 * b * 8)


def plan(cell: Cell, *, head_mode: str = "midx", shape_name: str = "",
         save_trace: Optional[str] = None) -> dict:
    """Run a cell's program on meta and report it (reference `analyze`)."""
    t0 = time.time()
    out, m = measure(lambda: cell.fn(*cell.args))
    plan_s = time.time() - t0
    out_bytes = 0
    in_ids = {id(t) for t in _tensors(*cell.args)}
    for t in _tensors(out):
        if id(t) not in in_ids:
            out_bytes += t.numel() * t.element_size()
    sizes = cell.mesh.sizes
    colls = collective_record(m["events"], sizes)
    t_compute = m["flops"] / HW["peak_flops"]
    t_memory = m["bytes"] / HW["hbm_bw"]
    t_coll = colls["seconds"]
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    if save_trace:
        with open(save_trace, "w") as f:
            json.dump({"ops": m["ops"], "collectives": [
                dataclasses.asdict(e) for e in m["events"]]}, f, indent=1)
    return {
        "arch": cell.cfg.name, "shape": shape_name, "kind": cell.kind,
        "head": head_mode, "mesh": list(cell.mesh.shape),
        "mesh_axes": list(cell.mesh.axis_names), "chips": cell.mesh.size,
        "flops_per_device": m["flops"], "bytes_per_device": m["bytes"],
        "memory": {"argument_bytes": cell.arg_bytes,
                   "output_bytes": out_bytes,
                   "temp_bytes": m["peak_temp"],
                   "peak_bytes": cell.arg_bytes + m["peak_temp"]},
        "collectives": colls,
        "roofline": {"compute_s": t_compute, "memory_s": t_memory,
                     "collective_s": t_coll, "dominant": dominant},
        "hw": HW, "plan_s": plan_s,
    }


def plan_refresh(cfg, mesh: MeshDesc, *, refresh_policy: str) -> dict:
    """The data-sharded index refresh of a train cell (reference
    `lower_refresh_cell`): `launch.steps.make_refresh_step` over a
    recording data group, its collective schedule."""
    grid = _grid(mesh)
    p_abs = steps_mod.abstract_params(cfg)
    fn = steps_mod.make_refresh_step(
        dataclasses.replace(cfg, head=dataclasses.replace(
            cfg.head, refresh_policy=refresh_policy)), grid)
    index = steps_mod.abstract_index(cfg)
    t0 = time.time()
    _, m = measure(lambda: fn(p_abs, index, None))
    return {"policy": refresh_policy, "plan_s": time.time() - t0,
            "collectives": collective_record(m["events"], mesh.sizes)}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             head_mode: str = "midx", out_dir: str = "experiments/dryrun_torch",
             save_trace: bool = False, attn_impl: str = "flash",
             moe_impl: str = "shard_map", pad_heads: bool = False,
             fused_head: str = "auto", refresh_every: Optional[int] = None,
             refresh_policy: Optional[str] = None,
             vocab_parallel: int = 1, vocab_size: Optional[int] = None,
             table_dtype: Optional[str] = None,
             layers_override: Optional[int] = None,
             family_twin: bool = False, write: bool = True) -> dict:
    shape = shape_by_name(shape_name)
    cfg = configure(arch, layers_override=layers_override,
                    family_twin=family_twin, pad_heads=pad_heads,
                    refresh_every=refresh_every,
                    refresh_policy=refresh_policy,
                    vocab_parallel=vocab_parallel, vocab_size=vocab_size,
                    table_dtype=table_dtype)
    mesh = make_production_mesh(multi_pod=multi_pod,
                                vocab_parallel=vocab_parallel)
    window = cfg.sliding_window if shape.name == "long_500k" else None
    tag = (f"{arch}__{shape_name}__{'multi' if multi_pod else 'single'}"
           f"__{head_mode}")
    if vocab_parallel > 1:
        tag += f"__vp{vocab_parallel}"
    if table_dtype is not None:
        tag += f"__{table_dtype}"
    prev = attn_mod.get_impl()
    attn_mod.set_impl(attn_impl)
    try:
        cell = build_cell(cfg, shape.kind, mesh,
                          global_batch=shape.global_batch,
                          seq_len=shape.seq_len, head_mode=head_mode,
                          window=window, fused_head=fused_head,
                          moe_sharded=moe_impl == "shard_map",
                          vocab_parallel=vocab_parallel)
        trace = (os.path.join(out_dir, tag + ".trace.json")
                 if save_trace else None)
        if trace:
            os.makedirs(out_dir, exist_ok=True)
        rec = plan(cell, head_mode=head_mode, shape_name=shape_name,
                   save_trace=trace)
    finally:
        attn_mod.set_impl(prev)
    if vocab_parallel > 1:
        rec["vocab_parallel"] = vocab_parallel
        rec["vocab_size"] = cfg.vocab_size
    if table_dtype is not None:
        rec["table_dtype"] = table_dtype
    if refresh_policy is not None and shape.kind == "train" \
            and head_mode == "midx" and vocab_parallel == 1:
        rec["refresh"] = plan_refresh(cfg, mesh,
                                      refresh_policy=refresh_policy)
    if write:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    r = rec["roofline"]
    print(f"[dryrun] {tag}: dominant={r['dominant']} "
          f"compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
          f"collective={r['collective_s']:.4f}s peak="
          f"{rec['memory']['peak_bytes'] / 2**30:.2f} GiB "
          f"(plan {rec['plan_s']:.1f}s)", flush=True)
    return rec


def calibrate_cell(arch: str, shape_name: str, *, multi_pod: bool,
                   head_mode: str = "midx",
                   out_dir: str = "experiments/dryrun_torch",
                   attn_impl: str = "flash", moe_impl: str = "shard_map",
                   pad_heads: bool = False) -> dict:
    """The reference's L = 0, 1, 2 variants (and L = 0, 1 family twins
    for vlm / hybrid). Eager counting runs every layer, so flops(L) and
    collective bytes(L) must follow f0 + L·(f1 − f0) exactly: `linear`
    says whether they do."""
    out = {"arch": arch, "shape": shape_name,
           "mesh": "multi" if multi_pod else "single", "head": head_mode,
           "variants": {}}

    def one(lv, twin):
        rec = run_cell(arch, shape_name, multi_pod=multi_pod,
                       head_mode=head_mode, attn_impl=attn_impl,
                       moe_impl=moe_impl, pad_heads=pad_heads,
                       layers_override=lv, family_twin=twin, write=False)
        return {"flops": rec["flops_per_device"],
                "bytes": rec["bytes_per_device"],
                "collective_bytes": rec["collectives"]["total_bytes"],
                "plan_s": rec["plan_s"]}

    v = out["variants"]
    for lv in (0, 1, 2):
        v[str(lv)] = one(lv, False)
    if get_config(arch).family in ("vlm", "hybrid"):
        for lv in (0, 1):
            v[f"twin{lv}"] = one(lv, True)
    out["linear"] = all(
        v["2"][k] - v["1"][k] == v["1"][k] - v["0"][k]
        for k in ("flops", "bytes", "collective_bytes"))
    os.makedirs(out_dir, exist_ok=True)
    tag = (f"{arch}__{shape_name}__{'multi' if multi_pod else 'single'}"
           f"__{head_mode}__calib")
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(out, f, indent=1)
    print(f"[calib] {tag}: linear={out['linear']} " + " ".join(
        f"L{lv}:f={r['flops']:.6g}" for lv, r in v.items()), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--head", choices=("midx", "full", "both"),
                    default="midx")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--save-trace", action="store_true",
                    help="write each cell's op counts and collective "
                         "events beside its JSON")
    ap.add_argument("--calibrate", action="store_true",
                    help="plan L in {0,1,2} variants and check the linear "
                         "law")
    ap.add_argument("--attn", choices=("flash", "autodiff"),
                    default="flash")
    ap.add_argument("--moe", choices=("shard_map", "vmap"),
                    default="shard_map",
                    help="shard_map: the sharded MoE dispatch; vmap: per "
                         "sequence")
    ap.add_argument("--fused-head", choices=tuple(_FUSED_HEAD_MODES),
                    default="auto")
    ap.add_argument("--pad-heads", action="store_true",
                    help="pad Q/KV heads to multiples of 16 so attention "
                         "splits by heads")
    ap.add_argument("--refresh-every", type=int, default=None)
    ap.add_argument("--refresh-policy", default=None,
                    choices=(None, "fixed", "drift"),
                    help="also plan the data-sharded index refresh of "
                         "train cells under this policy")
    ap.add_argument("--vocab-parallel", type=int, default=1)
    ap.add_argument("--vocab-size", type=int, default=None)
    ap.add_argument("--table-dtype", default=None)
    args = ap.parse_args(argv)

    archs = ([args.arch] if args.arch else
             [a for a in ARCHS if a != "paper-lm"])
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    heads = {"midx": ["midx"], "full": ["full"],
             "both": ["midx", "full"]}[args.head]
    failures = []
    for arch in archs:
        shapes = ([shape_by_name(args.shape)] if args.shape
                  else cells_for(arch))
        for shape in shapes:
            for mp in meshes:
                for hm in heads:
                    if shape.kind != "train" and hm == "full" and \
                            len(heads) > 1:
                        continue
                    try:
                        if args.calibrate:
                            calibrate_cell(arch, shape.name, multi_pod=mp,
                                           head_mode=hm, out_dir=args.out,
                                           attn_impl=args.attn,
                                           moe_impl=args.moe,
                                           pad_heads=args.pad_heads)
                        else:
                            run_cell(arch, shape.name, multi_pod=mp,
                                     head_mode=hm, out_dir=args.out,
                                     save_trace=args.save_trace,
                                     attn_impl=args.attn, moe_impl=args.moe,
                                     pad_heads=args.pad_heads,
                                     fused_head=args.fused_head,
                                     refresh_every=args.refresh_every,
                                     refresh_policy=args.refresh_policy,
                                     vocab_parallel=args.vocab_parallel,
                                     vocab_size=args.vocab_size,
                                     table_dtype=args.table_dtype)
                    except Exception as e:
                        failures.append((arch, shape.name, mp, hm, str(e)))
                        print(f"[dryrun] FAIL {arch} {shape.name} "
                              f"multi={mp} head={hm}: {e}", flush=True)
                        if not isinstance(e, NotImplementedError):
                            traceback.print_exc()
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES")
        raise SystemExit(1)
    print("[dryrun] all cells passed")


if __name__ == "__main__":
    main()
