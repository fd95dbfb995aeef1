"""Rank programs of `tests/test_torch_vocab_parallel.py`: each runs in a
process of its own (spawned, gloo on the CPU), one vocab-parallel rank,
and saves what it computed as numpy to `<outdir>/rank<r>.npz`. It imports
the port only (no JAX), so a rank starts quickly.

Inputs are made from fixed seeds (`setup`), the same in every rank and in
the test process, which holds the results to the port's replicated path.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch.configs.base import HeadConfig, ModelConfig
from repro_torch.core import midx, noise
from repro_torch.dist import collectives as coll
from repro_torch.dist import sharding as shd
from repro_torch.dist import vocab_parallel as vp
from repro_torch.launch import steps
from repro_torch.launch.train import train_loop
from repro_torch.models import heads, init_params
from repro_torch.models.model import class_embeddings
from repro_torch.optim import adamw
from repro_torch.optim.optimizers import tree_leaves

B, S = 2, 8
LOSS_CASES = {          # name: (proposal, table_dtype, mask_collisions)
    "per_token": ("per_token", "bf16", True),
    "per_token_unmasked": ("per_token", "bf16", False),
    "pooled": ("pooled", "bf16", True),
    "mixture": ("mixture", "bf16", True),
    "per_token_int8": ("per_token", "int8", True),
    "per_token_fp8": ("per_token", "fp8", True),
}


UNFUSED_CASES = {      # the unfused route's: (proposal, table_dtype, mask)
    "per_token": ("per_token", "bf16", True),
    "per_token_unmasked": ("per_token", "bf16", False),
    "pooled": ("pooled", "bf16", True),
    "mixture": ("mixture", "bf16", True),
    "per_token_int8": ("per_token", "int8", True),
}


def make_cfg(proposal="per_token", table_dtype="bf16", mask=True,
             vocab=200):
    return ModelConfig(
        name="vp-test", family="dense", num_layers=1, d_model=32,
        num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=vocab, head_dim=16,
        vocab_pad_multiple=8, remat=False, dtype="float32",
        head=HeadConfig(mode="midx", midx_k=8, num_negatives=12,
                        proposal=proposal, kmeans_iters=2,
                        table_dtype=table_dtype, mask_collisions=mask))


def setup(cfg):
    """params, index (the replicated head state's MultiIndex), hidden,
    labels, tokens and keys: the same in every process."""
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, device="cpu")
    gen_i = torch.Generator().manual_seed(1)
    index = heads.init_head_state(cfg.with_head(table_dtype="bf16"), params,
                                  gen_i)
    rng = np.random.default_rng(0)
    h = torch.from_numpy(
        (rng.standard_normal((B, S, cfg.d_model)) * 0.3).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    keys = noise.train_keys(0, 0, B * S, "cpu")
    return params, index, h, labels, tokens, keys


def _np(x):
    return x.detach().cpu().numpy()


def _loss_grads(cfg, table_local, local, h, labels, keys, pg, fused=None):
    t = table_local.detach().clone().requires_grad_(True)
    hh = h.detach().clone().requires_grad_(True)
    loss = vp.loss_midx_vp(cfg, t, local, hh, labels, keys, group=pg,
                           fused=fused)
    dt, dh = torch.autograd.grad(loss, (t, hh))
    return loss, coll.all_gather_rows(dt, pg), dh


def scenarios(group, outdir: str, extra: bool) -> None:
    """Every scenario of the test file on this rank; `extra` adds the
    serving export and the 3 + 3 resume (R = 2)."""
    pg, n, r = group.pg, group.size, group.rank
    out = {}
    cfg = make_cfg()
    params, index, h, labels, tokens, keys = setup(cfg)
    table = class_embeddings(cfg, params).detach()
    local = vp.local_index(vp.shard_index(index, n), r)
    table_local = shd.shard_rows(table, n, r)
    m = cfg.head.num_negatives

    # the samplers: ids bitwise, log_q
    d = vp.sample_twostage_vp(local, h.reshape(B * S, -1), m, keys, group=pg)
    out["twostage_ids"], out["twostage_lq"] = _np(d.ids), _np(d.log_q)
    prop = vp.proposal_index(local, pg)
    member = vp.make_member_fn(local, prop.counts, pg)
    for name, sampler in (("pooled", midx.sample_pooled),
                          ("mixture", midx.sample_mixture)):
        d = sampler(prop, h, m, noise.sequence_keys(keys, S),
                    member_fn=member)
        out[f"{name}_ids"], out[f"{name}_lq"] = _np(d.ids), _np(d.log_q)

    # the embedding lookup
    out["embed"] = _np(vp.embed_lookup(table_local, tokens, pg))

    # the loss and its gradients
    for name, (proposal, fmt, mask) in LOSS_CASES.items():
        c = make_cfg(proposal, fmt, mask)
        loss, dt, dh = _loss_grads(c, table_local, local, h, labels, keys,
                                   pg)
        out[f"loss_{name}"], out[f"dtab_{name}"] = _np(loss), _np(dt)
        out[f"dh_{name}"] = _np(dh)

    # one train step
    opt = adamw(1e-3)
    p_local = _clone(shd.shard_params(params, n, r))
    o_local = opt.init(p_local)
    step = steps.make_vocab_parallel_train_step(cfg, opt, group)
    batch = {"tokens": tokens, "labels": labels}
    p_local, o_local, met = step(p_local, o_local, local, batch, keys)
    out["step_loss"], out["step_gnorm"] = _np(met["loss"]), \
        _np(met["grad_norm"])
    full = shd.gather_params(p_local, pg)
    for i, leaf in enumerate(tree_leaves(full)):
        out[f"step_param_{i}"] = _np(leaf)
    backbone = [leaf for k, v in p_local.items() if k != "embed"
                for leaf in tree_leaves(v)]
    out["backbone"] = np.concatenate([_np(x).ravel() for x in backbone])

    # the native index init and refresh
    gen = torch.Generator().manual_seed(7)
    built = steps.make_vocab_index_init(cfg, group)(p_local, gen)
    refreshed, metrics = steps.make_vocab_refresh_step(cfg, group)(
        p_local, built, torch.Generator().manual_seed(8))
    for tag, li in (("init", built), ("refresh", refreshed)):
        st = vp.stack_local_indexes(li, pg)
        for f in vp.CSR_FIELDS:
            out[f"{tag}_{f}"] = _np(getattr(st, f))
        out[f"{tag}_loss"] = _np(vp.loss_midx_vp(
            cfg, table_local, li, h, labels, keys, group=pg))
    out["refresh_metrics"] = np.array(
        [float(metrics["reassigned_frac"]), float(metrics["codeword_drift"])])

    if extra:
        small = dict(batch_size=4, seq_len=8, lr=1e-3, log_every=1000,
                     seed=0, refresh_every=2, group=group)
        exp = os.path.join(outdir, "export")
        _, _, li, hist = train_loop(cfg, steps=2, ckpt_dir=exp, **small)
        st = vp.stack_local_indexes(li, pg)
        for f in vp.CSR_FIELDS:
            out[f"export_{f}"] = _np(getattr(st, f))
        legs = os.path.join(outdir, "legs")
        train_loop(cfg, steps=3, total_steps=6, ckpt_dir=legs,
                   ckpt_every=3, **small)
        p_res, o_res, i_res, h_res = train_loop(
            cfg, steps=6, total_steps=6, ckpt_dir=legs, ckpt_every=3,
            **small)
        p_one, o_one, i_one, h_one = train_loop(cfg, steps=6, **small)
        out["resume_hist"], out["whole_hist"] = np.array(h_res), \
            np.array(h_one)
        out["resume_same"] = np.array(_same((p_res, o_res.mu, o_res.nu,
                                             i_res),
                                            (p_one, o_one.mu, o_one.nu,
                                             i_one)))
    np.savez(os.path.join(outdir, f"rank{r}.npz"), **out)


def unfused_scenario(group, outdir: str) -> None:
    """`loss_midx_vp(fused=False)` and its gradients (d(table) gathered
    to the replicated rows, dh) for each of `UNFUSED_CASES`."""
    pg, n, r = group.pg, group.size, group.rank
    out = {}
    for name, (proposal, fmt, mask) in UNFUSED_CASES.items():
        cfg = make_cfg(proposal, fmt, mask)
        params, index, h, labels, _, keys = setup(cfg)
        local = vp.local_index(vp.shard_index(index, n), r)
        table_local = shd.shard_rows(class_embeddings(cfg, params).detach(),
                                     n, r)
        loss, dt, dh = _loss_grads(cfg, table_local, local, h, labels, keys,
                                   pg, fused=False)
        out[f"loss_{name}"], out[f"dtab_{name}"] = _np(loss), _np(dt)
        out[f"dh_{name}"] = _np(dh)
    np.savez(os.path.join(outdir, f"rank{r}.npz"), **out)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.detach().clone()


def _same(a, b) -> bool:
    """Bitwise equality of two trees of tensors (params, moments, index)."""
    la, lb = _flat(a), _flat(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.reshape(-1).view(torch.uint8)
                        if x.is_floating_point() else x,
                        y.reshape(-1).view(torch.uint8)
                        if y.is_floating_point() else y)
        for x, y in zip(la, lb))


def _flat(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _flat(t[k])]
    if isinstance(t, (list, tuple)):
        return [x for v in t for x in _flat(v)]
    if dataclasses.is_dataclass(t):
        return [x for f in dataclasses.fields(t)
                if torch.is_tensor(getattr(t, f.name))
                for x in _flat(getattr(t, f.name))]
    return [t] if torch.is_tensor(t) else []


# ------------------------------------------------------ the drift refresh
DRIFT_N, DRIFT_D, DRIFT_K = 256, 16, 8


def drift_tables():
    """(x, moved, c1, c2): a clustered table (stage-1 centres c1, stage-2
    offsets c2) and the same rows each moved to another stage-1 cluster
    (a cyclic shift of the cluster labels): every class reassigned while
    no codeword empties, so the drift policy refits and a warm-started
    refit draws nothing random."""
    rng = np.random.default_rng(0)
    k, d, n = DRIFT_K, DRIFT_D, DRIFT_N
    c1 = 4.0 * rng.standard_normal((k, d))
    c2 = 1.0 * rng.standard_normal((k, d))
    a1, a2 = rng.integers(0, k, n), rng.integers(0, k, n)
    a1[:k], a2[:k] = np.arange(k), np.arange(k)
    jitter = 0.05 * rng.standard_normal((n, d))
    x = c1[a1] + c2[a2] + jitter
    moved = c1[(a1 + 1) % k] + c2[a2] + jitter
    return tuple(a.astype(np.float32) for a in (x, moved, c1, c2))


def drift_index():
    """The replicated (RQ) index the drift scenarios start from, fit to
    the unchanged table from the true centres."""
    from repro_torch.index.build import build
    x, _, c1, c2 = drift_tables()
    return build(torch.Generator().manual_seed(2), torch.from_numpy(x),
                 kind="rq", k=DRIFT_K, iters=3, keep_residuals=False,
                 init=(torch.from_numpy(c1), torch.from_numpy(c2)))


def drift_scenario(group, outdir: str) -> None:
    """`refresh_vocab_sharded(policy='drift')` on this rank's rows of the
    unchanged table (the cheap branch) and of the moved one (the refit),
    with the stacked CSR, the codebooks and the metrics saved."""
    from repro_torch.index.sharded import refresh_vocab_sharded
    n, r = group.size, group.rank
    rows = DRIFT_N // n
    x, moved, _, _ = drift_tables()
    local = vp.local_index(vp.shard_index(drift_index(), n), r)
    out = {}
    for tag, table in (("same", x), ("moved", moved)):
        li, m = refresh_vocab_sharded(
            local, torch.Generator().manual_seed(3),
            torch.from_numpy(table[r * rows:(r + 1) * rows]), iters=3,
            policy="drift", threshold=0.5)
        st = vp.stack_local_indexes(li, None)
        for f in vp.CSR_FIELDS:
            out[f"{tag}_{f}"] = getattr(st, f).numpy()
        out[f"{tag}_codebook1"] = li.codebook1.numpy()
        out[f"{tag}_codebook2"] = li.codebook2.numpy()
        for k, v in m.items():
            out[f"{tag}_{k}"] = np.array(float(v))
    np.savez(os.path.join(outdir, f"rank{r}.npz"), **out)
