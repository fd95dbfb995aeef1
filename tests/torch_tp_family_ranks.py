"""Rank programs of `tests/test_torch_tp_families.py`: each runs in a
process of its own (spawned, gloo on the CPU), one rank of a dp x tp grid
over the ssm, hybrid, vlm and audio families, and saves what it computed
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
from repro_torch.models.decode import init_decode_state
from repro_torch.optim import adamw, sgd
from repro_torch.optim.optimizers import tree_leaves, zero1
from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import Request

B, S = 4, 16                        # the step's batch (mamba2's chunk is 8)
DECODE_TOKENS = 6
PROMPT = 4
FAMILY_CFGS = ("mamba2-370m", "zamba2-7b", "llama-3.2-vision-11b",
               "whisper-tiny")
# 'vlm-gather': the reduced vlm with 6 heads over 3 KV heads (the columns
# divide tp 2, the KV heads do not), held to the port's one-device step
STEP_CFGS = FAMILY_CFGS + ("vlm-gather",)
ENGINE_CFGS = ("mamba2-370m", "zamba2-7b")
MEDIA_CFGS = ("llama-3.2-vision-11b", "whisper-tiny", "vlm-gather")
SAVE_CFGS = ("mamba2-370m", "zamba2-7b")


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
    """The reduced config in fp32 with the full head."""
    if name == "vlm-gather":
        cfg = dataclasses.replace(
            get_config("llama-3.2-vision-11b").reduced(), num_heads=6,
            num_kv_heads=3, head_dim=16)
    else:
        cfg = get_config(name).reduced()
    return dataclasses.replace(cfg, dtype="float32").with_head(mode="full")


def media(cfg, rng, b: int) -> dict:
    """The stubbed media of a vlm / audio batch, [b, N, D] fp32."""
    if cfg.family == "vlm":
        shape = (b, cfg.num_image_tokens, cfg.d_model)
        return {"image_emb": (0.5 * rng.standard_normal(shape)
                              ).astype(np.float32)}
    if cfg.family == "audio":
        shape = (b, cfg.encoder_seq, cfg.d_model)
        return {"frames": (0.5 * rng.standard_normal(shape)
                           ).astype(np.float32)}
    return {}


def setup(cfg, seed: int = 3):
    """Params (the vlm's gates set to seeded nonzero values: at 0 they
    hide the cross blocks), a batch of tokens, labels and media as numpy."""
    params = init_params(cfg, torch.Generator().manual_seed(seed),
                         device="cpu")
    rng = np.random.default_rng(seed)
    for cb in params.get("cross_blocks", []):
        cb["gate_attn"] = torch.tensor(float(rng.uniform(0.3, 0.8)))
        cb["gate_mlp"] = torch.tensor(float(rng.uniform(-0.8, -0.3)))
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)),
             **media(cfg, rng, B)}
    return params, batch


def torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _groups(grid) -> dict:
    return {"model": grid.model_pg, "data": grid.data_pg}


def replicated_bits(p, specs) -> np.ndarray:
    """The leaves the specs leave whole, concatenated (their bits)."""
    rep = [x for x, s in zip(tree_leaves(p), tree_leaves(
        shd.tree_map_with_path(lambda _, s: (s,), specs)))
        if all(e is None for e in s[0])]
    return np.concatenate([_np(x).reshape(-1) for x in rep])


def step_scenario(grid, out: dict) -> None:
    """One full-head SGD step (lr 1, momentum 0) of each config on this
    rank's rows: the loss, the updated params gathered whole, the
    replicated leaves' bits on this rank, and (mamba2) the collectives
    the step made."""
    for name in STEP_CFGS:
        cfg = cfg_of(name)
        params, batch = setup(cfg)
        opt = sgd(1.0, momentum=0.0)
        p = steps.shard_for_rank(cfg, params, grid)
        step = steps.make_sharded_train_step(cfg, opt, grid)
        with coll.counting() as events:
            p, _, met, _ = step(p, opt.init(p), None,
                                steps.rank_batch(torch_batch(batch), grid),
                                None)
        out[f"{name}_loss"] = _np(met["loss"])
        specs = steps.tp_param_specs(cfg, grid.tp)
        full = shd.gather_by_spec(p, specs, _groups(grid))
        for i, x in enumerate(flat_np(params_to_numpy(cfg, full))):
            out[f"{name}_param_{i}"] = x
        out[f"{name}_replicated"] = replicated_bits(p, specs)
        if name == "mamba2-370m":
            for kind, v in coll.summarize(events).items():
                out[f"events_{kind}"] = np.array([v["count"], v["bytes"]])


def zero1_scenario(grid, out: dict) -> None:
    """Three AdamW steps of mamba2 with ZeRO-1 moments and without: the
    params (whole) and the gathered second moments of both."""
    cfg = cfg_of("mamba2-370m")
    params, batch = setup(cfg)
    batch = steps.rank_batch(torch_batch(batch), grid)
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


def save_scenario(grid, outdir: str) -> None:
    """The checkpoints a (1, 2) grid writes of mamba2 and zamba2: its
    slices gathered, saved by world rank 0."""
    for name in SAVE_CFGS:
        cfg = cfg_of(name)
        params, _ = setup(cfg, seed=9)
        p = steps.shard_for_rank(cfg, params, grid)
        mgr = CheckpointManager(os.path.join(outdir, f"ckpt_{name}"))
        save_gathered(mgr, 1, p, steps.tp_param_specs(cfg, grid.tp),
                      _groups(grid), write=grid.world_rank == 0,
                      metadata={"mesh": [grid.dp, grid.tp]})


def engine_setup(name: str):
    """A reduced config (fp32, the MIDX head), its params and the index
    built over the whole table, the same in every process."""
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
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


def greedy(cfg, params, batch: dict) -> np.ndarray:
    """`launch.steps.make_decode_step`'s greedy tokens over a slot-major
    state with the batch's media: the prompt's PROMPT tokens teacher-
    forced, then DECODE_TOKENS steps."""
    toks = batch["tokens"]
    b = toks.shape[0]
    kw = {k: torch.from_numpy(v) for k, v in batch.items()
          if k in ("image_emb", "frames")}
    step = steps.make_decode_step(cfg)
    got = []
    with torch.no_grad():
        state = init_decode_state(cfg, b, 32, device="cpu", params=params,
                                  **kw)
        tok = torch.from_numpy(toks[:, 0])
        for t in range(PROMPT - 1 + DECODE_TOKENS):
            pos = torch.full((b,), t, dtype=torch.long)
            nxt, state = step(params, state, tok, pos)
            tok = torch.from_numpy(toks[:, t + 1]) if t + 1 < PROMPT else nxt
            if t >= PROMPT - 1:
                got.append(_np(nxt))
    return np.stack(got, 1)


def decode_scenario(grid, out: dict) -> None:
    """Under the model axis: the engine's tokens (the MIDX head) for
    mamba2 and zamba2, and `make_decode_step`'s greedy tokens with media
    for the vlms and whisper."""
    tp.set_model_group(grid.model_pg)
    try:
        for name in ENGINE_CFGS:
            cfg, params, index = engine_setup(name)
            eng = Engine(cfg, steps.shard_for_rank(cfg, params, grid),
                         index=index, device="cpu", seed=0)
            out[f"{name}_engine_tokens"] = engine_tokens(eng)
        for name in MEDIA_CFGS:
            cfg = cfg_of(name)
            params, batch = setup(cfg)
            out[f"{name}_greedy"] = greedy(
                cfg, steps.shard_for_rank(cfg, params, grid), batch)
    finally:
        tp.set_model_group(None)


def scenarios(grid, outdir: str) -> None:
    torch.manual_seed(0)
    out: dict = {}
    step_scenario(grid, out)
    if grid.dp > 1:
        zero1_scenario(grid, out)
    else:
        decode_scenario(grid, out)
        save_scenario(grid, outdir)
    np.savez(os.path.join(outdir, f"rank{grid.world_rank}.npz"), **out)
