"""Rank programs of `tests/test_torch_dp.py`: each runs in a process of
its own (spawned, gloo on the CPU), one rank of a data-parallel (or
dp x vp) grid, and saves what it computed as numpy to
`<outdir>/rank<r>.npz` (r the world rank). It imports the port only (no
JAX), so a rank starts quickly.

Inputs are made from fixed seeds, the same in every rank and in the test
process, which holds the results to the reference (run in a subprocess)
and to the port's single-device path.
"""
from __future__ import annotations

import dataclasses
import os
import shutil

import numpy as np
import torch

from repro_torch.bridge import params_to_numpy
from repro_torch.configs import get_config
from repro_torch.configs.base import HeadConfig, ModelConfig
from repro_torch.core import noise
from repro_torch.dist import collectives as coll
from repro_torch.dist import sharding as shd
from repro_torch.dist import vocab_parallel as vp
from repro_torch.index.build import build
from repro_torch.launch import steps
from repro_torch.launch.train import train_loop
from repro_torch.models import heads, init_params
from repro_torch.optim import adamw, sgd
from repro_torch.optim.optimizers import tree_leaves, tree_map
from torch_vp_ranks import _clone, _same

TRANSPORTS = ("fp32", "bf16", "int8_ef")
PROPOSALS = ("per_token", "pooled", "mixture")
MIDX_STEPS = 3
FULL_B, FULL_S = 4, 16              # the full-head step against the reference
MIDX_B, MIDX_S = 8, 8               # the MIDX step against one device
REFRESH_N, REFRESH_D, REFRESH_K = 256, 16, 8


def _np(x):
    return x.detach().cpu().numpy()


def flat_np(tree) -> list:
    """Leaves of a dict / list tree of arrays in JAX's flatten order
    (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat_np(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flat_np(v)]
    return [np.asarray(tree)]


# --------------------------------------------------------------- collectives
def coll_inputs(n: int):
    """Per-rank gradient and error-feedback trees, each leaf [n, ...]: an
    all-zero leaf (the 1e-30 floor), a leaf whose scale is exactly 1 with
    values at x.5 (round half to even), and random leaves with a nonzero
    carried ef."""
    rng = np.random.default_rng(100 + n)
    ties = (rng.integers(-100, 100, (n, 8)) + 0.5).astype(np.float32)
    ties[0, 0] = 127.0
    ties[0, 1:5] = (2.5, -3.5, 0.5, -0.5)
    g = {"a": {"zero": np.zeros((n, 6), np.float32), "ties": ties},
         "blocks": [{"w": (0.01 * rng.standard_normal((n, 4, 5)))
                     .astype(np.float32)},
                    {"w": rng.standard_normal((n, 3)).astype(np.float32)}]}
    ef = {"a": {"zero": np.zeros((n, 6), np.float32),
                "ties": np.zeros((n, 8), np.float32)},
          "blocks": [{"w": (1e-4 * rng.standard_normal((n, 4, 5)))
                      .astype(np.float32)},
                     {"w": (1e-2 * rng.standard_normal((n, 3)))
                      .astype(np.float32)}]}
    return g, ef


def _take(tree, r):
    if isinstance(tree, dict):
        return {k: _take(v, r) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_take(v, r) for v in tree]
    return torch.from_numpy(np.ascontiguousarray(tree[r]))


def collectives_scenario(grid, out: dict) -> None:
    g, ef = coll_inputs(grid.dp)
    gl, el = _take(g, grid.data_rank), _take(ef, grid.data_rank)
    pg = grid.data_pg
    for i, x in enumerate(flat_np(tree_map(_np, coll.psum_bf16(gl, pg)))):
        out[f"coll_bf16_{i}"] = x
    s, e = coll.psum_int8_ef(gl, el, pg)
    for i, x in enumerate(flat_np(tree_map(_np, s))):
        out[f"coll_int8_{i}"] = x
    for i, x in enumerate(flat_np(tree_map(_np, e))):
        out[f"coll_ef_{i}"] = x
    for i, x in enumerate(flat_np(tree_map(_np, coll.pmean(gl, pg)))):
        out[f"coll_mean_{i}"] = x


# ------------------------------------------------ the full-head step vs JAX
def full_cfg():
    cfg = get_config("paper-lm").reduced()
    return dataclasses.replace(cfg, dtype="float32").with_head(mode="full")


def full_setup(cfg):
    """params (the port's init), tokens, labels: the same everywhere."""
    params = init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (FULL_B, FULL_S))
    labels = rng.integers(0, cfg.vocab_size, (FULL_B, FULL_S))
    return params, toks, labels


def full_step_scenario(grid, out: dict) -> None:
    """One step of `make_sharded_train_step` in each transport with SGD at
    lr 1, momentum 0: the optimizer's moment is then the clipped, reduced
    gradient itself. Also each leaf's int8 scale (max |g| over the ranks /
    127; one per layer of a stacked leaf) and the ranks' Σ|g| per element,
    for the int8 and bf16 bars."""
    cfg = full_cfg()
    params, toks, labels = full_setup(cfg)
    rows = shd.data_rows(FULL_B, grid.dp, grid.data_rank)
    batch = {"tokens": torch.from_numpy(toks[rows]),
             "labels": torch.from_numpy(labels[rows])}
    opt = sgd(1.0, momentum=0.0)
    for t in TRANSPORTS:
        p = _clone(params)
        step = steps.make_sharded_train_step(cfg, opt, grid,
                                             grad_transport=t)
        ef = steps.init_grad_transport_state(p, t)
        p, o, met, ef = step(p, opt.init(p), None, batch, None, ef)
        out[f"full_{t}_loss"] = _np(met["loss"])
        out[f"full_{t}_gnorm"] = _np(met["grad_norm"])
        for i, x in enumerate(flat_np(params_to_numpy(cfg, o.mu))):
            out[f"full_{t}_grad_{i}"] = x
    leaves = tree_map(lambda x: x.detach().requires_grad_(True), params)
    loss, _ = steps.make_loss_fn(cfg)(leaves, None, batch, None)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    it = iter(grads)
    gtree = tree_map(lambda _: next(it), leaves)
    amax = tree_map(lambda g: coll.pmax(torch.amax(torch.abs(g)),
                                        grid.data_pg), gtree)
    for i, x in enumerate(flat_np(params_to_numpy(cfg, amax))):
        out[f"full_scale_{i}"] = x / 127.0
    absum = tree_map(lambda g: coll.psum_no_grad(torch.abs(g), grid.data_pg),
                     gtree)
    for i, x in enumerate(flat_np(params_to_numpy(cfg, absum))):
        out[f"full_absum_{i}"] = x


# --------------------------------------------- the MIDX step vs one device
def midx_cfg(proposal: str) -> ModelConfig:
    return ModelConfig(
        name="dp-test", family="dense", num_layers=2, d_model=32,
        num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=200, head_dim=16,
        vocab_pad_multiple=8, remat=False, dtype="float32",
        head=HeadConfig(mode="midx", midx_k=8, num_negatives=12,
                        proposal=proposal, kmeans_iters=2))


def midx_setup(cfg):
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    index = heads.init_head_state(cfg, params,
                                  torch.Generator().manual_seed(1))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (MIDX_STEPS, MIDX_B, MIDX_S))
    labels = rng.integers(0, cfg.vocab_size, (MIDX_STEPS, MIDX_B, MIDX_S))
    return params, index, toks, labels


def midx_batches(toks, labels, dp: int, rank: int):
    """(batch, keys) of each step on data rank `rank`: its rows, and the
    global per-token keys of its rows."""
    rows = shd.data_rows(MIDX_B, dp, rank)
    for s in range(MIDX_STEPS):
        keys = noise.train_keys(0, s, MIDX_B * MIDX_S)
        yield ({"tokens": torch.from_numpy(toks[s][rows]),
                "labels": torch.from_numpy(labels[s][rows])},
               keys[rows.start * MIDX_S:rows.stop * MIDX_S])


def midx_opt():
    """SGD with momentum: the parameters then move by lr x the gradient,
    so a summation-order difference in the reduced gradient stays that
    small (AdamW's first steps scale a near-zero gradient element to ±lr,
    and would scale its rounding too)."""
    return sgd(0.1, momentum=0.9)


def midx_step_scenario(grid, out: dict) -> None:
    for proposal in PROPOSALS:
        cfg = midx_cfg(proposal)
        params, index, toks, labels = midx_setup(cfg)
        opt = midx_opt()
        p = _clone(params)
        o = opt.init(p)
        step = steps.make_sharded_train_step(cfg, opt, grid)
        losses, gnorms = [], []
        for batch, keys in midx_batches(toks, labels, grid.dp,
                                        grid.data_rank):
            p, o, met, _ = step(p, o, index, batch, keys, None)
            losses.append(float(met["loss"]))
            gnorms.append(float(met["grad_norm"]))
        out[f"midx_{proposal}_loss"] = np.array(losses)
        out[f"midx_{proposal}_gnorm"] = np.array(gnorms)
        for i, leaf in enumerate(tree_leaves(p)):
            out[f"midx_{proposal}_param_{i}"] = _np(leaf)


# ------------------------------------------------------------ the refresh
def refresh_tables(n=REFRESH_N):
    """(x, moved, c1, c2): a clustered table (stage-1 centres c1, stage-2
    offsets c2) and the same rows each moved to the next stage-1 cluster:
    every class reassigned while no codeword empties, so a warm-started
    refit draws nothing random."""
    rng = np.random.default_rng(0)
    k, d = REFRESH_K, REFRESH_D
    c1 = 4.0 * rng.standard_normal((k, d))
    c2 = 1.0 * rng.standard_normal((k, d))
    a1, a2 = rng.integers(0, k, n), rng.integers(0, k, n)
    a1[:k], a2[:k] = np.arange(k), np.arange(k)
    jitter = 0.05 * rng.standard_normal((n, d))
    x = c1[a1] + c2[a2] + jitter
    moved = c1[(a1 + 1) % k] + c2[a2] + jitter
    return tuple(a.astype(np.float32) for a in (x, moved, c1, c2))


def refresh_index(n=REFRESH_N):
    """The replicated (RQ, residual-free) index fit to the unchanged table
    from the true centres."""
    x, _, c1, c2 = refresh_tables(n)
    return build(torch.Generator().manual_seed(2), torch.from_numpy(x),
                 kind="rq", k=REFRESH_K, iters=3, keep_residuals=False,
                 init=(torch.from_numpy(c1), torch.from_numpy(c2)))


INDEX_FIELDS = ("codebook1", "codebook2", "assign1", "assign2",
                "sorted_ids", "offsets", "counts", "log_counts")


def refresh_cases(n=REFRESH_N):
    """name -> (table, policy): the drift policy below its threshold (the
    cheap branch) and the fixed policy's warm-started refit."""
    x, moved, _, _ = refresh_tables(n)
    return {"drift": (x, "drift"), "fixed": (moved, "fixed")}


def refresh_scenario(grid, out: dict, n=REFRESH_N) -> None:
    """`index.sharded.refresh_sharded` on this data rank's rows (the table
    zero-padded to ceil(n / dp)·dp rows where dp does not divide n)."""
    from repro_torch.index.sharded import refresh_sharded
    dp, r = grid.dp, grid.data_rank
    rows = shd.refresh_rows_per_shard(n, dp)
    n_valid = n if rows * dp != n else None
    for name, (table, policy) in refresh_cases(n).items():
        t = np.zeros((rows * dp, table.shape[1]), np.float32)
        t[:n] = table
        idx, m = refresh_sharded(
            refresh_index(n), torch.Generator().manual_seed(3),
            torch.from_numpy(t[r * rows:(r + 1) * rows]), group=grid.data_pg,
            iters=3, policy=policy, threshold=0.5, n_valid=n_valid)
        for f in INDEX_FIELDS:
            out[f"refresh_{name}_{f}"] = _np(getattr(idx, f))
        for k, v in m.items():
            out[f"refresh_{name}_{k}"] = np.array(float(v))


def quant_cfg() -> ModelConfig:
    """The int8 head under the drift policy far below its threshold: the
    refresh takes the cheap branch, then re-derives the low-bit twins."""
    return midx_cfg("per_token").with_head(
        table_dtype="int8", refresh_policy="drift",
        refresh_drift_threshold=10.0)


def quant_setup(cfg):
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return params, heads.init_head_state(cfg, params,
                                         torch.Generator().manual_seed(1))


def quant_refresh_scenario(grid, out: dict) -> None:
    """`launch.steps.make_refresh_step` on a quantized head state at dp:
    the data-sharded rebuild, then the twins re-derived."""
    from repro_torch.index.quantized import QUANT_FIELDS
    cfg = quant_cfg()
    params, state = quant_setup(cfg)
    new, _ = steps.make_refresh_step(cfg, grid)(
        params, state, torch.Generator().manual_seed(4))
    for f in QUANT_FIELDS[1:]:
        out[f"quant_{f}"] = _np(getattr(new, f).view(torch.uint8)
                                if getattr(new, f).dtype.itemsize == 1
                                else getattr(new, f))
    for f in INDEX_FIELDS:
        out[f"quant_index_{f}"] = _np(getattr(new.index, f))


# ------------------------------------------------------- guard and faults
def guard_scenario(grid, out: dict) -> None:
    """int8_ef at dp: two steps (a nonzero carry), then a step whose
    `_fault_scale` is NaN on every rank's rows: skipped, with params, the
    optimizer state and ef unchanged bit for bit."""
    cfg = midx_cfg("per_token")
    params, index, toks, labels = midx_setup(cfg)
    opt = adamw(1e-2)
    p = _clone(params)
    o = opt.init(p)
    step = steps.make_sharded_train_step(cfg, opt, grid,
                                         grad_transport="int8_ef")
    ef = steps.init_grad_transport_state(p, "int8_ef")
    skipped = []
    for s, (batch, keys) in enumerate(midx_batches(toks, labels, grid.dp,
                                                   grid.data_rank)):
        n = batch["tokens"].shape[0]
        batch["_fault_scale"] = torch.full(
            (n,), float("nan") if s == 2 else 1.0)
        before = _clone([p, o.mu, o.nu, ef])
        p, o, met, ef = step(p, o, index, batch, keys, ef)
        skipped.append(float(met["skipped"]))
    out["guard_skipped"] = np.array(skipped)
    out["guard_unchanged"] = np.array(_same(before, (p, o.mu, o.nu, ef)))
    out["guard_ef_nonzero"] = np.array(
        max(float(torch.amax(torch.abs(e))) for e in tree_leaves(ef)) > 0)
    out["guard_opt_step"] = np.array(o.step)


# ------------------------------------------------------ checkpoint legs
def resume_scenario(grid, out: dict, outdir: str) -> None:
    """fp32 at dp: 3 steps + a resume to 6 == 6 steps uninterrupted, bit
    for bit; the step-3 checkpoint is copied for the test process to
    resume at dp = 1."""
    cfg = midx_cfg("per_token")
    small = dict(batch_size=MIDX_B, seq_len=MIDX_S, lr=1e-3, log_every=1000,
                 seed=0, refresh_every=2, group=grid)
    legs = os.path.join(outdir, "legs")
    train_loop(cfg, steps=3, total_steps=6, ckpt_dir=legs, ckpt_every=3,
               **small)
    if grid.world_rank == 0:
        shutil.copytree(legs, os.path.join(outdir, "legs3"))
    p_res, o_res, i_res, h_res = train_loop(
        cfg, steps=6, total_steps=6, ckpt_dir=legs, ckpt_every=3, **small)
    p_one, o_one, i_one, h_one = train_loop(cfg, steps=6, **small)
    out["resume_hist"], out["whole_hist"] = np.array(h_res), np.array(h_one)
    out["resume_same"] = np.array(_same((p_res, o_res.mu, o_res.nu, i_res),
                                        (p_one, o_one.mu, o_one.nu, i_one)))
    flat = torch.cat([x.reshape(-1) for x in tree_leaves(p_one)])
    allp = coll.all_gather_stack(flat, grid.data_pg)
    out["params_same_across_ranks"] = np.array(all(
        torch.equal(allp[0], allp[i]) for i in range(grid.dp)))


def scenarios(grid, outdir: str, extra: bool) -> None:
    """Every dp scenario on this rank; `extra` adds the full-head step,
    the guard and the checkpoint legs (dp = 2)."""
    out = {}
    collectives_scenario(grid, out)
    midx_step_scenario(grid, out)
    refresh_scenario(grid, out)
    if extra:
        quant_refresh_scenario(grid, out)
        full_step_scenario(grid, out)
        guard_scenario(grid, out)
        resume_scenario(grid, out, outdir)
    np.savez(os.path.join(outdir, f"rank{grid.world_rank}.npz"), **out)


def padded_refresh_scenario(grid, outdir: str, n: int) -> None:
    """The pad-and-mask refresh at a dp that does not divide `n`."""
    out = {}
    refresh_scenario(grid, out, n)
    np.savez(os.path.join(outdir, f"rank{grid.world_rank}.npz"), **out)


# ------------------------------------------------------------- dp x vp
def grid_scenario(grid, outdir: str) -> None:
    """One vocab-parallel step on a dp x vp grid: each data row its rows
    of the batch, the vocab rank its rows of the class table; the params
    gathered back to the replicated layout."""
    from torch_vp_ranks import make_cfg, setup
    cfg = make_cfg()
    params, index, _, _, _, _ = setup(cfg)
    rng = np.random.default_rng(3)
    b, s = 4, 8
    toks = rng.integers(0, cfg.vocab_size, (b, s))
    labels = rng.integers(0, cfg.vocab_size, (b, s))
    rows = shd.data_rows(b, grid.dp, grid.data_rank)
    keys = noise.train_keys(0, 0, b * s)[rows.start * s:rows.stop * s]
    n, r = grid.size, grid.rank
    local = vp.local_index(vp.shard_index(index, n), r)
    opt = adamw(1e-3)
    p = _clone(shd.shard_params(params, n, r))
    o = opt.init(p)
    step = steps.make_vocab_parallel_train_step(cfg, opt, grid)
    p, o, met = step(p, o, local, {"tokens": torch.from_numpy(toks[rows]),
                                   "labels": torch.from_numpy(labels[rows])},
                     keys)
    out = {"loss": _np(met["loss"]), "gnorm": _np(met["grad_norm"])}
    for i, leaf in enumerate(tree_leaves(shd.gather_params(p, grid.pg))):
        out[f"param_{i}"] = _np(leaf)
    np.savez(os.path.join(outdir, f"rank{grid.world_rank}.npz"), **out)


# ------------------------------------------------ the unfused head route
UNFUSED_TRAIN = dict(steps=3, batch_size=4, seq_len=8, lr=1e-3,
                     log_every=1000, seed=0, refresh_every=10)


def unfused_corpus(cfg):
    from repro_torch.data import ZipfLM
    return ZipfLM(vocab_size=cfg.vocab_size, num_clusters=8, seq_len=9,
                  seed=0).sample(16)


def unfused_train_scenario(grid, outdir: str) -> None:
    """`train_loop(fused_head=False)` on this rank's rows of every batch:
    the loss history."""
    from torch_vp_ranks import make_cfg
    cfg = make_cfg()
    _, _, _, hist = train_loop(cfg, corpus=unfused_corpus(cfg), group=grid,
                               fused_head=False, **UNFUSED_TRAIN)
    np.savez(os.path.join(outdir, f"rank{grid.world_rank}.npz"),
             hist=np.array(hist))


# ------------------------------------------------ the sequence-sharded decode
DEC_B, DEC_S, DEC_H, DEC_KV, DEC_HD = 3, 32, 4, 2, 8
DEC_CASES = {            # name: (pos, window)
    "scalar": (17, None),
    "slots": ((31, 5, 12), None),
    "scalar_window": (17, 6),
    "slots_window": ((31, 5, 12), 6),
}


def decode_inputs():
    """q [B,1,H,hd], k/v caches [B,Smax,KV,hd] (fp32, numpy)."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((DEC_B, 1, DEC_H, DEC_HD)).astype(np.float32)
    k = rng.standard_normal((DEC_B, DEC_S, DEC_KV, DEC_HD)).astype(np.float32)
    v = rng.standard_normal((DEC_B, DEC_S, DEC_KV, DEC_HD)).astype(np.float32)
    return q, k, v


def decode_engine_cfg():
    """A 2-layer dense model served greedily by the full head, 2 slots of
    8 pages of 4: every slot's cache view is 32 positions."""
    cfg = midx_cfg("per_token").with_head(decode_temperature=0.0)
    return cfg.with_serve(max_slots=2, page_size=4, max_seq=32)


def decode_requests():
    from repro_torch.serve import Request
    rng = np.random.default_rng(12)
    return [Request(rid=i, tokens=rng.integers(0, 200, n).astype(np.int32),
                    max_new=6, seed=i) for i, n in enumerate((5, 11, 3))]


def decode_scenario(grid, outdir: str, engine: bool) -> None:
    """`flash_decode_seq_sharded` over the data group on every case; with
    `engine`, a paged engine whose decode attends through it (greedy
    tokens and a solo replay)."""
    import functools
    from repro_torch.dist.decode import flash_decode_seq_sharded
    q, k, v = (torch.from_numpy(x) for x in decode_inputs())
    out = {}
    for name, (pos, window) in DEC_CASES.items():
        out[f"dec_{name}"] = _np(flash_decode_seq_sharded(
            q, k, v, torch.tensor(pos), grid.data_pg, window=window))
    if engine:
        from repro_torch.serve import Engine
        eng = Engine(decode_engine_cfg(), head="full", device="cpu",
                     attn_fn=functools.partial(flash_decode_seq_sharded,
                                               group=grid.data_pg))
        reqs = decode_requests()
        res = eng.run(reqs)
        for r in reqs:
            out[f"tokens_{r.rid}"] = np.asarray(res[r.rid].tokens)
        out["solo_0"] = np.asarray(eng.replay_single(reqs[0]))
    np.savez(os.path.join(outdir, f"rank{grid.world_rank}.npz"), **out)
