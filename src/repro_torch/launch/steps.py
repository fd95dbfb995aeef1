"""Train-step functions: the loss and one optimizer step.

Mirrors `src/repro/launch/steps.py`: `resolve_proposal` (:55),
`_model_extras` (:23), `make_loss_fn` (:70; modes `midx`, `full` and
every registry contender, which route through `heads.loss_sampled`; `with_aux` adds a trainable
proposal's auxiliary loss, :112-121; the fault seam `_apply_fault` :33; an
unknown `head.table_dtype` raises when the loss is built, :96),
`make_train_step` (:129: the trainable branch :159-186, the other
:188-202, both with the non-finite skip guard) and the vocab-parallel
family (DESIGN §9): `make_vocab_parallel_train_step` (:305),
`make_vocab_index_init` (:417) and `make_vocab_refresh_step` (:451, both
refresh policies). The data-parallel step (`make_sharded_train_step`,
item 13) is not ported yet.

The vocab-parallel step runs on every rank of a `launch.mesh.VocabGroup`
with the same batch and keys (data degree 1): the class table (`embed`,
and `head` where untied) is the rank's rows, the backbone and its
optimizer state replicate, and the index is the rank's local view
(`dist.vocab_parallel`). Its gradients need no scaling (the collectives'
backwards hand each rank its own inputs' gradients, `dist.collectives`);
the global-norm clip sums the sharded leaves' squares over the ranks with
one all-reduce, so every rank scales by the same factor and the
replicated leaves stay the same on every rank.

Departures: torch runs eagerly, so there is no jit; a step is a function
of (params, opt state, head state, batch, keys) — `keys` [B·S] are the
tokens' counter-hash stream keys (`core.noise.train_keys`) where the
reference passes a JAX key. Params are a dict of leaf tensors; the step
differentiates a fresh requires-grad view of them and the optimizer then
updates them in place (`optim.optimizers`).
Trace ranges `train.forward`, `train.head`, `train.backward` and
`train.optimizer` (torch.profiler) split a step's host time.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.index.quantized import resolve_table_dtype
from repro_torch.models import heads
from repro_torch.models.model import forward
from repro_torch.optim.optimizers import (Optimizer, clip_by_global_norm,
                                          tree_leaves, tree_map)
from repro_torch.proposals import registry as proposals_registry

def _model_extras(cfg: ModelConfig, batch: dict) -> dict:
    """The batch's media for `forward` (reference :23-29): `image_emb`
    [B, Ni, D] for vlm, `frames` [B, Senc, D] for audio."""
    kw = {}
    if cfg.family == "vlm":
        kw["image_emb"] = batch["image_emb"]
    if cfg.family == "audio":
        kw["frames"] = batch["frames"]
    return kw


def _apply_fault(loss: torch.Tensor, batch: dict) -> torch.Tensor:
    """Resilience seam: when the batch carries `_fault_scale` ([B] fp32,
    normally all ones; the train loop adds it when a fault injector is
    armed), the loss is scaled by its mean. Multiplying by 1.0 is
    IEEE-exact, so a quiet injector leaves the run's bits unchanged, while
    a NaN/Inf/spike scale poisons the loss and, through the chain rule,
    every gradient, where the non-finite guard must catch them."""
    if "_fault_scale" in batch:
        return loss * torch.mean(batch["_fault_scale"].float())
    return loss


def resolve_proposal(cfg: ModelConfig, head_mode: Optional[str] = None):
    """(mode, Proposal-or-None) for a head config, validated at step-build
    time: an unknown mode raises the registry's ValueError. 'midx' and
    'full' return None: they keep their dedicated lanes."""
    mode = head_mode or cfg.head.mode
    proposals_registry.validate_mode(mode)
    if mode in ("midx", "full"):
        return mode, None
    return mode, proposals_registry.from_config(cfg.head, mode)


def make_loss_fn(cfg: ModelConfig, *, head_mode: Optional[str] = None,
                 window: Optional[int] = None,
                 with_aux: bool = False) -> Callable:
    """loss(params, state, batch, keys) -> (loss, metrics). `state` is the
    MultiIndex for 'midx', ignored for 'full', and the proposal's state for
    a registry contender; batch holds int64 `tokens` and `labels` [B, S] on
    the params' device, and for vlm / audio `image_emb` [B, Ni, D] /
    `frames` [B, Senc, D]. The resolved Proposal (or None) is
    `loss_fn.proposal`.

    `with_aux=True` adds a trainable proposal's L_recon + L_KL objective
    (paper §6.2.3) to the loss, and its `prop_recon` / `prop_kl` to the
    metrics; it moves only what the caller differentiates, the state's
    trainable leaves (make_train_step's trainable branch)."""
    from repro_torch.models.model import class_embeddings

    mode, proposal = resolve_proposal(cfg, head_mode)
    resolve_table_dtype(cfg.head.table_dtype)
    include_aux = bool(with_aux and proposal is not None
                       and proposal.trainable)

    def loss_fn(params, state, batch, keys):
        with record_function("train.forward"):
            out = forward(cfg, params, batch["tokens"], window=window,
                          **_model_extras(cfg, batch))
        with record_function("train.head"):
            if mode == "full":
                ce = heads.loss_full(cfg, params, out["hidden"],
                                     batch["labels"])
            elif mode == "midx":
                ce = heads.loss_midx(cfg, params, state, out["hidden"],
                                     batch["labels"], keys)
            else:
                ce = heads.loss_sampled(cfg, params, proposal, state,
                                        out["hidden"], batch["labels"], keys)
        loss = ce + cfg.router_aux_weight * out["aux_loss"]
        metrics = {"ce": ce, "aux": out["aux_loss"]}
        if include_aux:
            h = out["hidden"].float()
            aux_p, am = proposal.aux_loss(state, keys,
                                          h.reshape(-1, h.shape[-1]),
                                          class_embeddings(cfg, params))
            loss = loss + aux_p
            metrics.update(am)
        return _apply_fault(loss, batch), metrics

    loss_fn.proposal = proposal
    return loss_fn


def _tensor_fields(tr) -> list:
    """The tensor fields of a trainable node (a dataclass such as
    `core.learnable.LearnableCodebooks`), in field order."""
    return [f.name for f in dataclasses.fields(tr)
            if isinstance(getattr(tr, f.name), torch.Tensor)]


def _map_trainable(fn, tr):
    return dataclasses.replace(tr, **{f: fn(getattr(tr, f))
                                      for f in _tensor_fields(tr)})


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, *,
                    head_mode: Optional[str] = None,
                    window: Optional[int] = None,
                    clip_norm: float = 1.0) -> Callable:
    """step(params, opt_state, state, batch, keys) -> (params, opt_state,
    metrics), with `step.returns_state` False; params and the optimizer
    state are updated in place and come back as the same objects. A
    trainable proposal (midx-learnable-*) returns its updated state too,
    step(...) -> (params, opt_state, state, metrics) with
    `step.returns_state` True: its trainable leaves (the codebooks) take one
    SGD step at cfg.head.learnable_lr on their own gradient, the aux loss's,
    which the global-norm clip leaves out (the reference clips the params'
    gradient only).

    When the loss or the gradient's global norm is NaN/Inf, nothing is
    written to the params, the optimizer state or the trainable leaves and
    metrics['skipped'] is 1: a poisoned step never reaches the optimizer.
    The guard reads one flag on the host (a sync the train loop makes
    anyway to log the loss); the reference selects leafwise inside its
    jitted step instead."""
    loss_fn = make_loss_fn(cfg, head_mode=head_mode, window=window,
                           with_aux=True)
    proposal = loss_fn.proposal

    if proposal is not None and proposal.trainable:
        lr = cfg.head.learnable_lr

        def trainable_step(params, opt_state, state, batch, keys):
            trainable, rest = proposal.split_trainable(state)
            leaves = tree_map(lambda p: p.detach().requires_grad_(True),
                              params)
            tr = _map_trainable(lambda t: t.detach().requires_grad_(True),
                                trainable)
            loss, metrics = loss_fn(leaves, proposal.merge_trainable(tr, rest),
                                    batch, keys)
            flat = tree_leaves(leaves)
            tr_flat = [getattr(tr, f) for f in _tensor_fields(tr)]
            with record_function("train.backward"):
                got = torch.autograd.grad(loss, flat + tr_flat)
            it = iter(got[:len(flat)])
            grads = tree_map(lambda _: next(it), leaves)
            gt = dict(zip(_tensor_fields(tr), got[len(flat):]))
            with record_function("train.optimizer"):
                grads, gnorm = clip_by_global_norm(grads, clip_norm)
                loss = loss.detach()
                ok = bool(torch.isfinite(loss) & torch.isfinite(gnorm))
                if ok:
                    params, opt_state = optimizer.update(grads, opt_state,
                                                         params)
                    trainable = dataclasses.replace(trainable, **{
                        f: getattr(trainable, f) - lr * g
                        for f, g in gt.items()})
            metrics = {**{k: v.detach() for k, v in metrics.items()},
                       "loss": loss, "grad_norm": gnorm,
                       "skipped": 0.0 if ok else 1.0}
            return (params, opt_state,
                    proposal.merge_trainable(trainable, rest), metrics)

        trainable_step.returns_state = True
        trainable_step.proposal = proposal
        return trainable_step

    def train_step(params, opt_state, state, batch, keys):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        (loss, metrics) = loss_fn(leaves, state, batch, keys)
        flat = tree_leaves(leaves)
        with record_function("train.backward"):
            it = iter(torch.autograd.grad(loss, flat))
        grads = tree_map(lambda _: next(it), leaves)
        with record_function("train.optimizer"):
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            loss = loss.detach()
            ok = bool(torch.isfinite(loss) & torch.isfinite(gnorm))
            if ok:
                params, opt_state = optimizer.update(grads, opt_state,
                                                     params)
        metrics = {**{k: v.detach() for k, v in metrics.items()},
                   "loss": loss, "grad_norm": gnorm,
                   "skipped": 0.0 if ok else 1.0}
        return params, opt_state, metrics

    train_step.returns_state = False
    train_step.proposal = proposal
    return train_step


# ------------------------------------------------------------ vocab parallel
def _vp_loss_fn(cfg: ModelConfig, pg, window: Optional[int]):
    from repro_torch.dist import vocab_parallel as vp_mod
    from repro_torch.models.model import class_embeddings

    def loss_fn(params, local_idx, batch, keys):
        with record_function("train.forward"):
            emb = vp_mod.embed_lookup(params["embed"], batch["tokens"], pg)
            out = forward(cfg, params, batch["tokens"], window=window,
                          inputs_embeds=emb, **_model_extras(cfg, batch))
        with record_function("train.head"):
            ce = vp_mod.loss_midx_vp(cfg, class_embeddings(cfg, params),
                                     local_idx, out["hidden"],
                                     batch["labels"], keys, group=pg)
        loss = ce + cfg.router_aux_weight * out["aux_loss"]
        return _apply_fault(loss, batch), {"ce": ce, "aux": out["aux_loss"]}

    return loss_fn


def make_vocab_parallel_train_step(cfg: ModelConfig, optimizer: Optimizer,
                                   group, *, window: Optional[int] = None,
                                   clip_norm: float = 1.0) -> Callable:
    """step(params, opt_state, local_index, batch, keys) -> (params,
    opt_state, metrics) on one rank of `group` (a `launch.mesh.
    VocabGroup`): params and opt state hold the rank's rows of the class
    tables and the whole backbone, updated in place; the loss, the grad
    norm and the skip decision are the same on every rank. Parity
    contract (tests/test_torch_vocab_parallel.py): loss, grad norm and
    every updated param within 1e-5 of `make_train_step` on the
    replicated layout with the same keys."""
    from repro_torch.dist.collectives import psum_no_grad
    from repro_torch.dist.sharding import vocab_param_names

    if (cfg.head.mode or "midx") != "midx":
        raise ValueError("vocab-parallel training requires the MIDX head")
    pg = group.pg
    loss_fn = _vp_loss_fn(cfg, pg, window)

    def train_step(params, opt_state, local_idx, batch, keys):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, metrics = loss_fn(leaves, local_idx, batch, keys)
        flat = tree_leaves(leaves)
        with record_function("train.backward"):
            it = iter(torch.autograd.grad(loss, flat))
        grads = tree_map(lambda _: next(it), leaves)
        with record_function("train.optimizer"):
            sharded = vocab_param_names(grads)
            rep = [g for k, v in grads.items() if k not in sharded
                   for g in tree_leaves(v)]
            sq_local = sum(torch.sum(torch.square(grads[k].float()))
                           for k in sharded)
            sq_rep = sum(torch.sum(torch.square(g.float())) for g in rep)
            gnorm = torch.sqrt(sq_rep + psum_no_grad(sq_local, pg))
            grads, gnorm = clip_by_global_norm(grads, clip_norm, norm=gnorm)
            loss = loss.detach()
            ok = bool(torch.isfinite(loss) & torch.isfinite(gnorm))
            if ok:
                params, opt_state = optimizer.update(grads, opt_state,
                                                     params)
        metrics = {**{k: v.detach() for k, v in metrics.items()},
                   "loss": loss, "grad_norm": gnorm,
                   "skipped": 0.0 if ok else 1.0}
        return params, opt_state, metrics

    train_step.returns_state = False
    return train_step


def make_vocab_index_init(cfg: ModelConfig, group) -> Callable:
    """init(params, gen) -> this rank's local index view, built natively
    (`index.sharded.build_vocab_sharded`): codebook statistics all-reduced,
    the CSR never leaving its rank. `params` hold the rank's table rows;
    `gen` is seeded alike on every rank."""
    from repro_torch.index.sharded import build_vocab_sharded
    from repro_torch.models.model import class_embeddings

    def init(params, gen):
        return build_vocab_sharded(
            gen, class_embeddings(cfg, params).detach().float(),
            kind=cfg.head.quantizer, k=cfg.head.midx_k,
            iters=cfg.head.kmeans_iters, group=group.pg)

    return init


def make_vocab_refresh_step(cfg: ModelConfig, group, *,
                            policy: Optional[str] = None) -> Callable:
    """refresh(params, local_index, gen) -> (local_index, metrics): the
    all-reduced drift probe and, under `policy` (default
    cfg.head.refresh_policy), the warm-started sharded refit or the
    drift policy's reassign-only branch, each rank rebuilding only its own
    CSR (`index.sharded.refresh_vocab_sharded`)."""
    from repro_torch.index.sharded import refresh_vocab_sharded
    from repro_torch.models.model import class_embeddings

    pol = policy or cfg.head.refresh_policy

    def refresh(params, local_idx, gen):
        return refresh_vocab_sharded(
            local_idx, gen, class_embeddings(cfg, params).detach().float(),
            group=group.pg, iters=cfg.head.kmeans_iters, policy=pol,
            threshold=cfg.head.refresh_drift_threshold)

    return refresh
