"""Rank programs of `tests/test_torch_tensor_parallel.py` and
`tests/test_torch_dryrun.py`: each runs in a process of its own (spawned,
gloo on the CPU), one rank of a dp x tp grid, and saves what it computed
as numpy to `<outdir>/rank<r>.npz` (r the world rank). It imports the
port only (no JAX), so a rank starts quickly.

Inputs are made from fixed seeds, the same in every rank and in the test
process, which holds the results to the reference (run in a subprocess)
and to the port's one-device path.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch.bridge import params_to_numpy
from repro_torch.checkpoint import CheckpointManager, save_gathered
from repro_torch.configs import get_config
from repro_torch.dist import collectives as coll
from repro_torch.dist import sharding as shd
from repro_torch.dist import tensor_parallel as tp
from repro_torch.launch import steps
from repro_torch.models import heads, init_params
from repro_torch.models import moe as moe_mod
from repro_torch.models.decode import decode_step, init_decode_state
from repro_torch.optim import adamw, sgd
from repro_torch.optim.optimizers import tree_leaves, zero1
from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import Request

B, S = 4, 16                        # the step's batch
MOE = dict(b=8, s=16, d=32, e=4, f=64, k=2, shared=48)
DECODE_TOKENS = 6


def _np(x):
    return x.detach().cpu().numpy()


def flat_np(tree) -> list:
    """Leaves of a dict / list tree of arrays in JAX's flatten order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat_np(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flat_np(v)]
    return [np.asarray(tree)]


def cfg_of(name: str):
    """The reduced configs the tests hold (fp32, full head): smollm and
    granite-moe (their heads divide tp 2) and 'gather', smollm with 6
    heads over 3 KV heads (the columns divide tp 2, the heads do not)."""
    if name == "gather":
        cfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                                  num_heads=6, num_kv_heads=3, head_dim=16)
    else:
        cfg = get_config(name).reduced()
    return dataclasses.replace(cfg, dtype="float32").with_head(mode="full")


STEP_CFGS = ("smollm-135m", "granite-moe-1b-a400m", "gather")
BF16_CFGS = ("smollm-135m", "gather")


def setup(cfg, seed: int = 3):
    params = init_params(cfg, torch.Generator().manual_seed(seed),
                         device="cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    labels = rng.integers(0, cfg.vocab_size, (B, S))
    return params, toks, labels


def _rows(grid, x):
    r = shd.data_rows(x.shape[0], grid.dp, grid.data_rank)
    return torch.from_numpy(np.ascontiguousarray(x[r]))


def _groups(grid) -> dict:
    return {"model": grid.model_pg, "data": grid.data_pg}


def step_scenario(grid, out: dict) -> None:
    """One full-head SGD step (lr 1, momentum 0) of each config: the loss,
    the updated params gathered whole, the replicated leaves' bits on this
    rank, and (smollm) the collectives the step made."""
    for name in STEP_CFGS:
        cfg = cfg_of(name)
        params, toks, labels = setup(cfg)
        opt = sgd(1.0, momentum=0.0)
        p = steps.shard_for_rank(cfg, params, grid)
        step = steps.make_sharded_train_step(cfg, opt, grid)
        batch = {"tokens": _rows(grid, toks), "labels": _rows(grid, labels)}
        with coll.counting() as events:
            p, _, met, _ = step(p, opt.init(p), None, batch, None)
        out[f"{name}_loss"] = _np(met["loss"])
        specs = steps.tp_param_specs(cfg, grid.tp)
        full = shd.gather_by_spec(p, specs, _groups(grid))
        for i, x in enumerate(flat_np(params_to_numpy(cfg, full))):
            out[f"{name}_param_{i}"] = x
        rep = [x for x, s in zip(tree_leaves(p), tree_leaves(
            shd.tree_map_with_path(lambda _, s: (s,), specs)))
            if all(e is None for e in s[0])]
        out[f"{name}_replicated"] = np.concatenate(
            [_np(x).reshape(-1) for x in rep])
        if name == "smollm-135m":
            for kind, v in coll.summarize(events).items():
                out[f"events_{kind}"] = np.array([v["count"], v["bytes"]])


def moe_inputs():
    g = torch.Generator().manual_seed(11)
    m = MOE
    p = moe_mod.moe_init(g, m["d"], m["f"], m["e"], m["shared"],
                         device="cpu")
    x = 0.3 * torch.randn((m["b"], m["s"], m["d"]), generator=g)
    # a direction every token shares tilts the router towards two experts,
    # so that capacity factor 1.25 drops tokens
    return p, x + 20.0 * p["router"][:, :2].sum(1)


def moe_scenario(grid, out: dict) -> None:
    """The sharded MoE dispatch on this rank's rows and F slice, at
    capacity factors 8.0 and 1.25: y rows and the aux loss."""
    p, x = moe_inputs()
    m = MOE
    specs = shd.param_specs(None, {"ffn": p}, tp=grid.tp)["ffn"]
    p_loc = shd.shard_by_spec(p, specs, {"model": grid.tp},
                              {"model": grid.model_rank})
    xl = _rows(grid, x.numpy())
    for cf in (8.0, 1.25):
        moe_mod.set_moe_group(grid.model_pg, grid.data_pg)
        try:
            y, aux = moe_mod.apply_moe_sharded(
                p_loc, xl, top_k=m["k"], capacity_factor=cf, d_ff=m["f"],
                shared_d_ff=m["shared"])
        finally:
            moe_mod.set_moe_group(on=False)
            tp.set_model_group(None)
        out[f"moe_{cf}_y"] = _np(y)
        out[f"moe_{cf}_aux"] = _np(aux)


def zero1_scenario(grid, out: dict) -> None:
    """Three AdamW steps of granite-moe with ZeRO-1 moments and without:
    the params (whole) of both, this rank's moment bytes of both."""
    cfg = cfg_of("granite-moe-1b-a400m")
    params, toks, labels = setup(cfg)
    batch = {"tokens": _rows(grid, toks), "labels": _rows(grid, labels)}
    specs = steps.tp_param_specs(cfg, grid.tp)
    for mode in ("plain", "zero1"):
        opt = adamw(1e-2)
        if mode == "zero1":
            opt = zero1(opt, steps.zero1_dims(cfg, grid, min_size=1 << 10),
                        grid.data_pg)
        p = steps.shard_for_rank(cfg, params, grid)
        o = opt.init(p)
        step = steps.make_sharded_train_step(cfg, opt, grid)
        for _ in range(3):
            p, o, _, _ = step(p, o, None, batch, None)
        full = shd.gather_by_spec(p, specs, _groups(grid))
        for i, x in enumerate(flat_np(params_to_numpy(cfg, full))):
            out[f"z_{mode}_param_{i}"] = x
        out[f"z_{mode}_moment_bytes"] = np.array(sum(
            t.numel() * t.element_size() for t in tree_leaves(o.mu)))
        mspecs = specs if mode == "plain" else shd.zero1_specs(
            specs, steps.abstract_params(cfg), dp=grid.dp, min_size=1 << 10)
        nu = shd.gather_by_spec(o.nu, mspecs, _groups(grid))
        for i, x in enumerate(flat_np(params_to_numpy(cfg, nu))):
            out[f"z_{mode}_nu_{i}"] = x


def save_scenario(grid, out: dict, outdir: str) -> None:
    """The checkpoint a (dp, tp) grid writes: its slices gathered, saved by
    world rank 0 (the restore across meshes reads it)."""
    cfg = cfg_of("smollm-135m")
    params, _, _ = setup(cfg, seed=9)
    p = steps.shard_for_rank(cfg, params, grid)
    mgr = CheckpointManager(os.path.join(outdir, "ckpt"))
    save_gathered(mgr, 1, p, steps.tp_param_specs(cfg, grid.tp),
                  _groups(grid), write=grid.world_rank == 0,
                  metadata={"mesh": [grid.dp, grid.tp]})


def decode_scenario(grid, out: dict) -> None:
    """Greedy decode of the reduced llama through the engine (paged pool,
    the MIDX head) and of the 'gather' config through `decode_step` over
    the sequence-sharded cache, under the model axis."""
    cfg, params, index = engine_setup()
    tp.set_model_group(grid.model_pg)
    try:
        eng = Engine(cfg, steps.shard_for_rank(cfg, params, grid),
                     index=index, device="cpu", seed=0)
        out["engine_tokens"] = engine_tokens(eng)
        gcfg = cfg_of("gather")
        gparams, toks, _ = setup(gcfg)
        out["decode_tokens"] = greedy(
            gcfg, steps.shard_for_rank(gcfg, gparams, grid), toks)
    finally:
        tp.set_model_group(None)


def bf16_scenario(grid, out: dict) -> None:
    """The prefill's last-position logits of `BF16_CFGS` in bf16 (the
    row-parallel products in bf16, their sums over the ranks in fp32)."""
    for name in BF16_CFGS:
        cfg = dataclasses.replace(cfg_of(name), dtype="bfloat16")
        params, toks, _ = setup(cfg)
        p = steps.shard_for_rank(cfg, params, grid)
        with tp.model_axis(grid.model_pg), torch.no_grad():
            logits = steps.make_prefill_step(cfg)(
                p, {"tokens": torch.from_numpy(toks)})
        out[f"{name}_bf16_logits"] = _np(logits.float())


def engine_setup():
    """The reduced llama (fp32), its params and the MIDX index built over
    the whole table, the same in every process."""
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(4),
                         device="cpu")
    index = heads.init_head_state(cfg, params,
                                  torch.Generator().manual_seed(5))
    return cfg, params, index


def engine_tokens(eng) -> np.ndarray:
    reqs = [Request(rid=i, tokens=np.array(t, np.int32),
                    max_new=DECODE_TOKENS, seed=i)
            for i, t in enumerate(([5, 9, 2, 7], [3, 3, 8, 1, 4]))]
    res = eng.run(reqs)
    return np.stack([np.asarray(res[i].tokens, np.int64)
                     for i in range(len(reqs))])


def greedy(cfg, params, toks) -> np.ndarray:
    """DECODE_TOKENS greedy steps of `decode_step` after writing the
    prompt token by token."""
    b = toks.shape[0]
    state = init_decode_state(cfg, b, 32, device="cpu")
    tok = torch.from_numpy(toks[:, 0])
    got = []
    with torch.no_grad():
        for t in range(4 + DECODE_TOKENS):
            pos = torch.full((b,), t, dtype=torch.long)
            h, state = decode_step(cfg, params, tok, pos, state)
            nxt = torch.argmax(h.float() @ tp.table_rows(
                params["embed"], torch.arange(cfg.padded_vocab),
                cfg.padded_vocab).float().T, -1)
            tok = torch.from_numpy(toks[:, t + 1]) if t + 1 < 4 else nxt
            if t >= 3:
                got.append(_np(nxt))
    return np.stack(got, 1)


def scenarios(grid, outdir: str) -> None:
    torch.manual_seed(0)
    out: dict = {}
    step_scenario(grid, out)
    if grid.dp > 1:
        moe_scenario(grid, out)
        zero1_scenario(grid, out)
        save_scenario(grid, out, outdir)
    else:
        decode_scenario(grid, out)
        bf16_scenario(grid, out)
    np.savez(os.path.join(outdir, f"rank{grid.world_rank}.npz"), **out)
