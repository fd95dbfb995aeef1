"""Train-step functions: the loss and one optimizer step.

Mirrors `src/repro/launch/steps.py`: `resolve_proposal` (:55),
`_model_extras` (:23), `make_loss_fn` (:70; modes `midx`, `full` and
every registry contender, which route through `heads.loss_sampled`; `with_aux` adds a trainable
proposal's auxiliary loss, :112-121; the fault seam `_apply_fault` :33; an
unknown `head.table_dtype` raises when the loss is built, :96),
`make_train_step` (:129: the trainable branch :159-186, the other
:188-202, both with the non-finite skip guard), the head's route switch
`fused_head` (:72-112, :133-155) on every step builder, the
data-parallel family (DESIGN §4): `init_grad_transport_state` (:205),
`make_sharded_train_step` (:218) and the data-sharded `make_refresh_step`
(:518), and the
vocab-parallel family (DESIGN §9): `make_vocab_parallel_train_step`
(:305, with its data group, :369-408), `make_vocab_index_init` (:417) and
`make_vocab_refresh_step` (:451, both refresh policies).

The data-parallel step runs on every rank of a `launch.mesh.RankGrid`'s
data group, each rank on its rows of the batch (`dist.sharding.
data_rows`) with the replicated params, optimizer state and head state.
Departure: the reference folds the step key with the data shard index,
so each shard draws negatives of its own; here a token's draws are a
function of (seed, step, its GLOBAL flat index) (`core.noise.train_keys`),
and a rank takes the keys of its rows, so a dp run draws exactly the
negatives of the single-device run, and its fp32 loss (the mean of the
ranks' means, as the reference takes it) is the single-device loss up to
summation order where the ranks hold equal token counts.

The vocab-parallel step runs on every rank of a `launch.mesh.RankGrid`'s
vocab group with the same batch rows and keys: the class table (`embed`,
and `head` where untied) is the rank's rows, the backbone and its
optimizer state replicate, and the index is the rank's local view
(`dist.vocab_parallel`). Its gradients need no scaling (the collectives'
backwards hand each rank its own inputs' gradients, `dist.collectives`);
the global-norm clip sums the sharded leaves' squares over the ranks with
one all-reduce, so every rank scales by the same factor and the
replicated leaves stay the same on every rank. On a dp x vp grid the
gradients and the metrics are then averaged over the data group before the
clip, as the reference pmeans them over its data axes.

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
from repro_torch.dist import collectives as coll
from repro_torch.index.quantized import resolve_table_dtype, unwrap_index
from repro_torch.launch.mesh import mesh_dp
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
                 fused_head: Optional[bool] = None,
                 with_aux: bool = False, model_group=None) -> Callable:
    """loss(params, state, batch, keys) -> (loss, metrics). `state` is the
    MultiIndex for 'midx', ignored for 'full', and the proposal's state for
    a registry contender; batch holds int64 `tokens` and `labels` [B, S] on
    the params' device, and for vlm / audio `image_emb` [B, Ni, D] /
    `frames` [B, Senc, D]. The resolved Proposal (or None) is
    `loss_fn.proposal`. `fused_head` picks the MIDX head's route
    (`heads.loss_midx`'s `fused`: None defers to cfg.head.use_fused_head).

    `with_aux=True` adds a trainable proposal's L_recon + L_KL objective
    (paper §6.2.3) to the loss, and its `prop_recon` / `prop_kl` to the
    metrics; it moves only what the caller differentiates, the state's
    trainable leaves (make_train_step's trainable branch).

    `model_group`: the model axis's group, under which the caller runs
    the loss (`make_sharded_train_step`). Where its ranks split the class
    table's rows, the MIDX loss is `dist.vocab_parallel.loss_midx_vp`
    over that group, on the replicated index's local view
    (`tp_head_state`); it takes the 'midx' and 'full' heads only."""
    from repro_torch.dist import vocab_parallel as vp_mod
    from repro_torch.models.model import class_embeddings

    mode, proposal = resolve_proposal(cfg, head_mode)
    resolve_table_dtype(cfg.head.table_dtype)
    include_aux = bool(with_aux and proposal is not None
                       and proposal.trainable)
    tpn = 1 if model_group is None else coll.group_size(model_group)
    if tpn > 1 and proposal is not None:
        raise ValueError("the model axis takes the 'midx' and 'full' heads")
    table_split = tpn > 1 and cfg.padded_vocab % tpn == 0

    def loss_fn(params, state, batch, keys):
        with record_function("train.forward"):
            out = forward(cfg, params, batch["tokens"], window=window,
                          **_model_extras(cfg, batch))
        with record_function("train.head"):
            if mode == "full":
                ce = heads.loss_full(cfg, params, out["hidden"],
                                     batch["labels"])
            elif table_split:
                ce = vp_mod.loss_midx_vp(
                    cfg, class_embeddings(cfg, params), unwrap_index(state),
                    out["hidden"], batch["labels"], keys, group=model_group,
                    fused=fused_head)
            elif mode == "midx":
                ce = heads.loss_midx(cfg, params, state, out["hidden"],
                                     batch["labels"], keys, fused=fused_head)
            else:
                ce = heads.loss_sampled(cfg, params, proposal, state,
                                        out["hidden"], batch["labels"], keys,
                                        fused=fused_head)
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
                    clip_norm: float = 1.0,
                    fused_head: Optional[bool] = None) -> Callable:
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
    jitted step instead. `fused_head` as in `make_loss_fn`."""
    loss_fn = make_loss_fn(cfg, head_mode=head_mode, window=window,
                           fused_head=fused_head, with_aux=True)
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


# ------------------------------------------------------------ data parallel
GRAD_TRANSPORTS = ("fp32", "bf16", "int8_ef")


def check_grad_transport(grad_transport: str) -> None:
    if grad_transport not in GRAD_TRANSPORTS:
        raise ValueError(f"--grad-transport must be one of "
                         f"{GRAD_TRANSPORTS}, got {grad_transport!r}")


def init_grad_transport_state(params, grad_transport: str):
    """The int8 error-feedback carry (fp32 zeros shaped like the params)
    for 'int8_ef', None otherwise (reference :205). Each rank carries its
    own residual, where the reference stacks the shards' on a leading
    [dp] dim; it is in no checkpoint (the reference saves (params,
    opt_state, index) and rebuilds it as zeros at start)."""
    check_grad_transport(grad_transport)
    if grad_transport != "int8_ef":
        return None
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _scalars(metrics: dict) -> dict:
    return {k: torch.as_tensor(v).detach().float() for k, v in
            metrics.items()}


def reduce_grads(grads, group, grad_transport: str, ef=None):
    """The data group's mean gradient in `grad_transport` (reference
    :266-279) -> (grads, new ef): 'fp32' the all-reduce mean; 'bf16' the
    bf16 sum over the dp ranks, divided by dp; 'int8_ef' the error-
    feedback int8 sum, divided by dp."""
    dp = coll.group_size(group)
    if grad_transport == "fp32":
        return coll.pmean(grads, group), ef
    if grad_transport == "bf16":
        return tree_map(lambda g: g / dp, coll.psum_bf16(grads, group)), ef
    summed, ef = coll.psum_int8_ef(grads, ef, group)
    return tree_map(lambda g: g / dp, summed), ef


def make_sharded_train_step(cfg: ModelConfig, optimizer: Optimizer, group,
                            *, grad_transport: str = "fp32",
                            head_mode: Optional[str] = None,
                            window: Optional[int] = None,
                            clip_norm: float = 1.0,
                            fused_head: Optional[bool] = None,
                            moe_sharded: bool = False) -> Callable:
    """step(params, opt_state, state, batch, keys, ef=None) -> (params,
    opt_state, metrics, ef) on one rank of a dp x tp `group` (a
    `launch.mesh.RankGrid`): `batch` and `keys` are the rank's data rows
    (`rank_batch`: the vlm's `image_emb` and whisper's `frames` cut with
    the tokens; the global `train_keys` cut to them);
    params are the rank's model slices (`shard_for_rank`; whole at tp 1)
    and `state` its head state (`tp_head_state`), params and the optimizer
    state updated in place. The forward runs under the model axis over
    `group.model_pg` (`dist.tensor_parallel`); the MIDX loss over a
    row-split table is `dist.vocab_parallel.loss_midx_vp` with the model
    group as its group, the full head the vocab-split softmax
    (`make_loss_fn`'s `model_group`). The gradient is reduced over the
    data group in `grad_transport` (`reduce_grads`; at dp 1 an fp32
    transport is the identity and is skipped), the metrics are averaged
    over it, and the global-norm clip and the non-finite guard then see
    the same values on every rank, so every rank takes the same branch: a
    skipped step leaves params, the optimizer state and `ef` as they were
    (reference :284-296). Replicated leaves' gradients are the same on
    every model rank (the region ops see to it), so they are not
    all-reduced again; the global norm sums the split leaves' squares
    over the model group once. `moe_sharded` turns on the sharded MoE
    dispatch (`models.moe.set_moe_group`'s semantics: capacity per rank's
    b_loc·S tokens). `optimizer` may be `optim.zero1(...)` over
    `group.data_pg` (`zero1_dims`).

    As in the reference (:249), the loss carries no trainable proposal's
    auxiliary loss and the head state is not returned: a midx-learnable
    head trains the params against its codebooks, which stay as they are
    (the reference's data-parallel step threads no proposal state); the
    model axis takes the 'midx' and 'full' heads only. `fused_head` as in
    `make_loss_fn`."""
    from repro_torch.dist import tensor_parallel as tp
    from repro_torch.dist.sharding import tree_map_with_path
    from repro_torch.models import moe as moe_mod

    check_grad_transport(grad_transport)
    mpg, dpg, tpn = group.model_pg, group.data_pg, group.tp
    loss_fn = make_loss_fn(cfg, head_mode=head_mode, window=window,
                           fused_head=fused_head,
                           model_group=mpg if tpn > 1 else None)
    reduce = group.dp > 1 or grad_transport != "fp32"
    split = tree_leaves(tree_map_with_path(
        lambda _, s: any(e is not None for e in s),
        tp_param_specs(cfg, tpn))) if tpn > 1 else None

    def global_norm(grads):
        if split is None:
            return None
        g = tree_leaves(grads)
        zero = g[0].new_zeros((), dtype=torch.float32)
        sq_split = sum((torch.sum(torch.square(x.float()))
                        for x, s in zip(g, split) if s), zero)
        sq_rep = sum((torch.sum(torch.square(x.float()))
                      for x, s in zip(g, split) if not s), zero)
        return torch.sqrt(sq_rep + coll.psum_no_grad(sq_split, mpg))

    def train_step(params, opt_state, state, batch, keys, ef=None):
        with tp.model_axis(mpg if tpn > 1 else None), \
                moe_mod.sharded_dispatch(moe_sharded, dpg):
            leaves = tree_map(lambda p: p.detach().requires_grad_(True),
                              params)
            loss, metrics = loss_fn(leaves, state, batch, keys)
            flat = tree_leaves(leaves)
            with record_function("train.backward"):
                # a leaf the loss does not read (the calibration's L = 0
                # variant of the hybrid's shared block or the vlm's cross
                # block) takes a zero gradient, as the reference's grad
                it = iter(torch.autograd.grad(loss, flat, allow_unused=True,
                                              materialize_grads=True))
            grads = tree_map(lambda _: next(it), leaves)
        metrics = _scalars({**metrics, "loss": loss})
        new_ef = ef
        if reduce:
            with record_function("train.grad_transport"):
                grads, new_ef = reduce_grads(grads, dpg, grad_transport, ef)
                metrics = coll.pmean(metrics, dpg)
        with record_function("train.optimizer"):
            grads, gnorm = clip_by_global_norm(grads, clip_norm,
                                               norm=global_norm(grads))
            ok = (gnorm.is_meta or bool(torch.isfinite(metrics["loss"])
                                        & torch.isfinite(gnorm)))
            if ok:
                params, opt_state = optimizer.update(grads, opt_state,
                                                     params)
                ef = new_ef
        metrics = {**metrics, "grad_norm": gnorm,
                   "skipped": 0.0 if ok else 1.0}
        return params, opt_state, metrics, ef

    train_step.returns_state = False
    train_step.proposal = loss_fn.proposal
    return train_step


def make_refresh_step(cfg: ModelConfig, group=None) -> Callable:
    """refresh(params, state, gen) -> (state, metrics) for the MIDX head
    state (reference :518) under cfg.head.refresh_policy: on one device
    (or a data degree of 1) the single-device refresh; with `group`'s
    data degree dp > 1 the
    data-sharded one (`index.sharded.refresh_sharded`): data rank d
    quantizes the rows [d·rows, (d+1)·rows) of the class table, rows =
    ceil(Vpad / dp), the table zero-padded where dp does not divide Vpad
    and the pad rows masked. A quantized head state re-derives its
    low-bit twins from the rebuilt index (reference :598-610), the same
    on every rank. `gen` is seeded alike on every rank."""
    from repro_torch.dist.sharding import refresh_rows_per_shard
    from repro_torch.index.quantized import QuantHeadState
    from repro_torch.index.sharded import refresh_sharded
    from repro_torch.models.model import class_embeddings

    dp = mesh_dp(group)
    if dp <= 1:
        def refresh_replicated(params, state, gen):
            return heads.refresh_head_state_with_policy(cfg, params, state,
                                                        gen)
        return refresh_replicated
    vpad = cfg.padded_vocab
    rows = refresh_rows_per_shard(vpad, dp)
    n_valid = vpad if rows * dp != vpad else None
    lo = group.data_rank * rows

    def refresh(params, state, gen):
        table = class_embeddings(cfg, params).detach().float()
        local = table[lo:lo + rows]
        if local.shape[0] < rows:
            local = torch.nn.functional.pad(
                local, (0, 0, 0, rows - local.shape[0]))
        new_index, metrics = refresh_sharded(
            unwrap_index(state), gen, local, group=group.data_pg,
            iters=cfg.head.kmeans_iters, policy=cfg.head.refresh_policy,
            threshold=cfg.head.refresh_drift_threshold, n_valid=n_valid)
        if isinstance(state, QuantHeadState):
            return heads._requantized(cfg, state, new_index, table,
                                      gen), metrics
        return new_index, metrics

    return refresh


# ------------------------------------------------------------ vocab parallel
def _vp_loss_fn(cfg: ModelConfig, pg, window: Optional[int],
                fused_head: Optional[bool]):
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
                                     batch["labels"], keys, group=pg,
                                     fused=fused_head)
        loss = ce + cfg.router_aux_weight * out["aux_loss"]
        return _apply_fault(loss, batch), {"ce": ce, "aux": out["aux_loss"]}

    return loss_fn


def make_vocab_parallel_train_step(cfg: ModelConfig, optimizer: Optimizer,
                                   group, *, window: Optional[int] = None,
                                   clip_norm: float = 1.0,
                                   fused_head: Optional[bool] = None
                                   ) -> Callable:
    """step(params, opt_state, local_index, batch, keys) -> (params,
    opt_state, metrics) on one rank of `group` (a `launch.mesh.
    RankGrid`): params and opt state hold the rank's rows of the class
    tables and the whole backbone, updated in place; the loss, the grad
    norm and the skip decision are the same on every rank. With a data
    degree dp > 1, `batch` and `keys` are the rank's data rows, and the
    gradients and metrics are averaged over the data group before the
    clip (reference :369-408). Parity contract
    (tests/test_torch_vocab_parallel.py, tests/test_torch_dp.py): loss,
    grad norm and every updated param within 1e-5 of `make_train_step` on
    the replicated layout with the same keys, on either route
    (`fused_head`, as in `make_loss_fn`)."""
    from repro_torch.dist.collectives import psum_no_grad
    from repro_torch.dist.sharding import vocab_param_names

    if (cfg.head.mode or "midx") != "midx":
        raise ValueError("vocab-parallel training requires the MIDX head")
    pg, data_pg = group.pg, group.data_pg
    loss_fn = _vp_loss_fn(cfg, pg, window, fused_head)

    def train_step(params, opt_state, local_idx, batch, keys):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, metrics = loss_fn(leaves, local_idx, batch, keys)
        flat = tree_leaves(leaves)
        with record_function("train.backward"):
            it = iter(torch.autograd.grad(loss, flat))
        grads = tree_map(lambda _: next(it), leaves)
        metrics = _scalars({**metrics, "loss": loss})
        if group.dp > 1:
            with record_function("train.grad_transport"):
                grads = coll.pmean(grads, data_pg)
                metrics = coll.pmean(metrics, data_pg)
        with record_function("train.optimizer"):
            sharded = vocab_param_names(grads)
            rep = [g for k, v in grads.items() if k not in sharded
                   for g in tree_leaves(v)]
            sq_local = sum(torch.sum(torch.square(grads[k].float()))
                           for k in sharded)
            sq_rep = sum(torch.sum(torch.square(g.float())) for g in rep)
            gnorm = torch.sqrt(sq_rep + psum_no_grad(sq_local, pg))
            grads, gnorm = clip_by_global_norm(grads, clip_norm, norm=gnorm)
            ok = gnorm.is_meta or bool(torch.isfinite(metrics["loss"])
                                       & torch.isfinite(gnorm))
            if ok:
                params, opt_state = optimizer.update(grads, opt_state,
                                                     params)
        metrics = {**metrics, "grad_norm": gnorm,
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


# ---------------------------------------------------------------- model axis
def abstract_params(cfg: ModelConfig, cast_dtype: Optional[str] = None):
    """The params tree on the meta device (reference :642): the shapes and
    dtypes of `init_params`, nothing drawn (a CPU generator cannot feed a
    meta tensor). `cast_dtype` casts every leaf's dtype."""
    from repro_torch.models.model import _draw_params
    meta = torch.device("meta")
    params = _draw_params(cfg, None, meta, lambda bp: bp)
    if cast_dtype is not None:
        dt = getattr(torch, cast_dtype)
        params = tree_map(lambda x: torch.empty(x.shape, dtype=dt,
                                                device=meta), params)
    return params


def abstract_index(cfg: ModelConfig, params_abs=None, rows=None):
    """The MultiIndex `heads.init_head_state` builds, on the meta device
    (reference :666; the bare index, residuals dropped); `rows` sizes a
    vocab shard's local view (`dist.vocab_parallel.local_index`)."""
    from repro_torch.index.build import MultiIndex
    del params_abs
    meta = torch.device("meta")
    k, d = cfg.head.midx_k, cfg.d_model
    dq = d // 2 if cfg.head.quantizer == "pq" else d
    n = cfg.padded_vocab if rows is None else rows

    def e(*shape, dt=torch.int64):
        return torch.empty(shape, dtype=dt, device=meta)

    return MultiIndex(cfg.head.quantizer, e(k, dq, dt=torch.float32),
                      e(k, dq, dt=torch.float32), e(n), e(n),
                      e(0, dq, dt=torch.float32), e(n), e(k * k + 1),
                      e(k, k), e(k, k, dt=torch.float32))


def abstract_vocab_index(cfg: ModelConfig, params_abs, vp: int):
    """The VocabShardedIndex at `vp` shards on the meta device (reference
    :672)."""
    from repro_torch.dist.vocab_parallel import VocabShardedIndex
    rows = cfg.padded_vocab // vp
    loc = abstract_index(cfg, params_abs, rows)

    def st(x):
        return torch.empty((vp, *x.shape), dtype=x.dtype, device=x.device)

    return VocabShardedIndex(loc.kind, vp, loc.codebook1, loc.codebook2,
                             st(loc.assign1), st(loc.assign2),
                             st(loc.sorted_ids), st(loc.offsets),
                             st(loc.counts), st(loc.log_counts))


def abstract_decode_state(cfg: ModelConfig, params_abs, bsz: int,
                          max_seq: int, window: Optional[int] = None):
    """The slot-major decode state on the meta device (reference :651),
    in this rank's layout under the model axis (`decode_cache_specs`;
    `params_abs` then the rank's slices); the vlm's and whisper's cross
    K/V over `media_batch`'s media (the reference's over zeros)."""
    from repro_torch.models.decode import init_decode_state
    return init_decode_state(cfg, bsz, max_seq, device="meta",
                             params=params_abs, window=window,
                             **media_batch(cfg, bsz, "meta"))


def media_batch(cfg: ModelConfig, bsz: int, device) -> dict:
    """The batch's media on `device` as the dry run plans them (reference
    `batch_struct` :622-632): `image_emb` [B, Ni, D] (vlm), `frames`
    [B, Senc, D] (audio), uninitialised, in the compute dtype."""
    from repro_torch.models.model import torch_dtype
    dt = torch_dtype(cfg)
    if cfg.family == "vlm":
        return {"image_emb": torch.empty(
            (bsz, cfg.num_image_tokens, cfg.d_model), dtype=dt,
            device=device)}
    if cfg.family == "audio":
        return {"frames": torch.empty((bsz, cfg.encoder_seq, cfg.d_model),
                                      dtype=dt, device=device)}
    return {}


def rank_batch(batch: dict, grid) -> dict:
    """Data rank `grid.data_rank`'s rows of every leaf of a [B, ...]
    batch (tokens, labels, and the vlm's `image_emb` / whisper's `frames`
    with them; `dist.sharding.data_rows`)."""
    from repro_torch.dist.sharding import data_rows
    b = batch["tokens"].shape[0]
    rows = data_rows(b, grid.dp, grid.data_rank)
    return {k: v[rows] for k, v in batch.items()}


def make_prefill_step(cfg: ModelConfig, *, window: Optional[int] = None):
    """prefill(params, batch) -> the last position's full logits [B, Vpad]
    (reference :489)."""
    from repro_torch.models.model import logits_full

    def prefill_step(params, batch):
        out = forward(cfg, params, batch["tokens"], window=window,
                      **_model_extras(cfg, batch))
        return logits_full(cfg, params, out["hidden"][:, -1, :])

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, window: Optional[int] = None):
    """serve(params, cache, token, pos) -> (next token [B], cache): one
    token against the cache, the full head, greedy (reference :501 with
    `sample=False`; its categorical draw needs a JAX key)."""
    from repro_torch.models.decode import decode_step
    from repro_torch.models.model import logits_full

    def serve_step(params, cache, token, pos):
        hidden, cache = decode_step(cfg, params, token, pos, cache,
                                    window=window)
        return torch.argmax(logits_full(cfg, params, hidden), -1), cache

    return serve_step


def tp_param_specs(cfg: ModelConfig, tp: int):
    """`param_specs` of cfg's whole params at degree tp."""
    from repro_torch.dist.sharding import param_specs
    return param_specs(cfg, abstract_params(cfg), tp=tp)


def shard_for_rank(cfg: ModelConfig, params: dict, grid) -> dict:
    """The params a rank of `grid` trains: its model slice of every leaf
    (`shard_by_spec` under `param_specs` at the grid's tp)."""
    from repro_torch.dist.sharding import shard_by_spec
    return shard_by_spec(params, tp_param_specs(cfg, grid.tp),
                         {"data": grid.dp, "model": grid.tp},
                         {"data": grid.data_rank, "model": grid.model_rank})


def tp_head_state(cfg: ModelConfig, index, grid):
    """The head state a rank's TP loss reads, built once a refresh: where
    the model ranks split the class table, the local view of the
    replicated index over the rank's rows (`local_index(shard_index(idx,
    tp), m)`, so every model rank draws the replicated index's ids from
    the same keys); else the index itself."""
    from repro_torch.dist.vocab_parallel import local_index, shard_index
    if grid.tp == 1 or cfg.padded_vocab % grid.tp:
        return index
    return local_index(shard_index(unwrap_index(index), grid.tp),
                       grid.model_rank)


def zero1_dims(cfg: ModelConfig, grid, min_size: int = 1 << 16):
    """The dimension of each param leaf ZeRO-1 splits over the data group
    (`zero1_specs` over `param_specs` at the grid's tp), or None."""
    from repro_torch.dist.sharding import spec_dim, zero1_specs
    specs = zero1_specs(tp_param_specs(cfg, grid.tp), abstract_params(cfg),
                        dp=grid.dp, min_size=min_size)
    return tree_map(lambda s: spec_dim(s, "data"), specs)
