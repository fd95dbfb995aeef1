"""Training loop and CLI: the MIDX head first-class, on one card,
checkpointed and fault-tolerant.

Mirrors `src/repro/launch/train.py`: `StragglerWatchdog` (:40),
`train_loop` (:68) on a single device with the `midx` and `full` heads and
every registry proposal (their state initialised as at :172-178, the
unigram family and TAPAS from the corpus's class frequencies,
`np.bincount(corpus, minlength=padded_vocab)` as float64; refreshed by
the lifecycle when adaptive, :200-201; a trainable proposal's step returns
its state, which the loop threads on, :168, :238-240, and its refresh
re-derives the index from the learned codebooks), the head-state
refresh lifecycle, checkpoints and resume (:203-215: the restore-fallback
walk, `next_step` from the metadata; a save every `ckpt_every` steps after
the lifecycle's flush, :299-310; the final save and the serving export to
`<ckpt>/serve`, :325-344; the final save is skipped where the loop's
last save or the resume already wrote that step, where the reference
writes it again), the fault injector's seams and the guardrails'
rollback and replay (:217-280), the loss history and the step log, and
the CLI (`main` :348, `_parse_chaos` :438) with the flags --arch --steps
--batch --seq --lr --head --reduced --refresh-every --refresh-policy
--refresh-lag --ckpt --chaos --chaos-seed --seed --table-dtype (bf16, or
the quantized head's int8 / fp8: the low-bit class table, codebooks and
residual codes, DESIGN §12), --head taking every `proposal_modes()` entry,
and --fused-head (the reference's `:374`, `:417-418`): `auto` defers to
cfg.head.use_fused_head, `on` takes the fused route (the hand-written
kernels on the card, their plain versions on the CPU) and `off` the
unfused route (plain torch ops, no kernel; `train_loop(fused_head=...)`
passes the switch to every step builder and rank); `interpret` (the
reference's Pallas-interpreter route) exits with a message. Beside them,
--device (default: the card; 'cpu' must be asked for), --vocab-parallel N
and --dp N with --grad-transport (below).

The index lifecycle (DESIGN §8; reference :80, :289-316, :390-395):
`--refresh-policy drift` refreshes reassign-only until the drift probe
passes cfg.head.refresh_drift_threshold, then refits; `--refresh-lag N`
builds each refresh from step s's params at step s and swaps it in after
step s + N (`index.lifecycle`: the rebuild runs on the loop's thread,
only the swap is deferred). Every completed refresh reaches
`train_loop(on_refresh=...)`, and the run ends with the reference's
refresh summary (`utils.metrics.refresh_summary`). A checkpoint first
flushes the rebuild in flight, and a rollback aborts it.

Vocab-parallel training (DESIGN §9; reference :137-160, :169, :187,
:236, :333-340): `--vocab-parallel N` spawns N rank processes
(`launch.mesh.spawn_ranks`), one shard of the class table and the index
each, every rank reading the same batch (data degree 1). Ranks share the
card when there is one (gloo, CUDA tensors staged through the host) or
take one card each (NCCL), `--vp-backend` overriding the choice; with
`--device cpu` they run on the CPU over gloo. `train_loop(group=...)` is
one rank: the index is built natively per rank and refreshed by the
sharded refit, checkpoints are the reference's vocab-parallel format
(rank 0 writes the gathered params and optimizer state and the stacked
index; a run resumes on the same N), and the serving export unshards the
index, so `Engine.from_checkpoint` serves the model.

Data-parallel training (DESIGN §4; reference :133-160, :181, :187-192,
:239-241, :364-373, :412-416): `--dp N` spawns N rank processes, each
training on its rows of every batch with the replicated params, optimizer
state and index (`launch.steps.make_sharded_train_step`); the gradient
meets over the data group in `--grad-transport` fp32, bf16 or int8_ef, and
the MIDX index refreshes data-sharded (`launch.steps.make_refresh_step`).
`--dp N --vocab-parallel M` runs the N x M grid, data outer
(`launch.mesh.RankGrid`): the vocab-parallel step on each data row, its
gradients averaged over the data group, and the vocab-sharded refresh;
there only the fp32 transport runs, as in the reference (:142-144). As in
the reference (:132-133), a non-fp32 transport without --dp runs a data
group over every local card (one process on one card, where int8_ef still
quantizes). Each rank takes the global per-token keys of its rows, so a
dp run draws the single-device run's negatives (`launch.steps`).
Checkpoints hold the replicated (params, opt_state, index), written by
world rank 0; at vp = 1 nothing is sharded, so a run resumes at another
dp. The int8 error-feedback carry is in no checkpoint and a guardrail
rollback leaves it as it is, both as in the reference (:181, :260-279):
an int8_ef run that resumes is not bit for bit the uninterrupted one.
Fault injection runs on every rank alike (the same plan and seed), its
`_fault_scale` cut to the rank's rows like the batch; world rank 0 alone
saves, and a kill in its save reaches every rank.

Checkpoints are the reference's format (`checkpoint.manager`): a run of
either package resumes from the other's. `total_steps` is the job's
schedule horizon and must stay fixed across resume legs, so that a
resumed run is bit for bit the uninterrupted one. A `full`-head run
builds and checkpoints a MultiIndex it never reads, as the reference's
does, so that its checkpoints cross too.

Every random choice is a pure function of (seed, step): the batches
(`TokenStream.batch_at`), the negatives (counter-hash keys per token, see
`core.noise.train_keys`) and the refresh's K-means generator. Two runs
with one seed on one device therefore agree bit for bit, and so do a run
and its resume from a checkpoint, and a rollback's replay.

The head trains with the config's proposal: per-token for `paper-lm`,
the shared-negative `pooled` default (`HeadConfig.proposal`) for the other
configs, e.g. `llama3.2-1b` at full width (M = 1024, K = 64) and
`mamba2-370m` (the ssm family, its chunked scan through the ssd_scan
kernel on the card). Sequences longer than 1024 tokens (the repo's
`train_4k` length, 4096) run their attention through the chunked flash
path. The moe family (its router aux loss in the loss, the config's
`router_aux_weight`) and the hybrid family train as the reference's
CLI trains them. The vlm and audio families need media in every batch
(`image_emb`, `frames`), which this loop's token stream does not carry,
nor does the reference's: `train_loop` refuses them, and they train
through `launch.steps.make_train_step` with batches that carry the
media.

`train_loop`'s default corpus is the reference's, max(512, 4 x batch)
`ZipfLM` sequences at every length, so CLI runs train on the reference
CLI's data.

  python -m repro_torch.launch.train --arch paper-lm --steps 120 --lr 3e-3
  rm -rf build/ck-paper-lm build/ck-chaos    # a --ckpt dir that exists is resumed
  python -m repro_torch.launch.train --arch paper-lm --steps 120 --ckpt build/ck-paper-lm   # rerun: resumes
  python -m repro_torch.launch.train --arch paper-lm --steps 60 --ckpt build/ck-chaos --chaos nan_loss@30,kill_mid_save@40:committed
  python -m repro_torch.launch.train --arch llama3.2-1b --steps 40 --batch 4 --seq 256
  python -m repro_torch.launch.train --arch llama3.2-1b --seq 4096 --batch 2 --steps 20 --lr 1e-3
  python -m repro_torch.launch.train --arch paper-lm --head rff-fused --steps 120 --lr 3e-3
  python -m repro_torch.launch.train --arch paper-lm --head midx-learnable --steps 120 --lr 3e-3
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced --head unigram --steps 30
  python -m repro_torch.launch.train --arch paper-lm --steps 120 --lr 3e-3 --table-dtype int8
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced --steps 2 --table-dtype fp8
  python -m repro_torch.launch.train --arch mamba2-370m --steps 30 --batch 4 --seq 1024 --lr 1e-3
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced --steps 4 --ckpt build/ck-cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m --device cpu --reduced
  python -m repro_torch.launch.train --arch paper-lm --steps 120 --lr 3e-3 --vocab-parallel 2
  python -m repro_torch.launch.train --arch llama3.2-1b --steps 40 --batch 4 --seq 256 --refresh-every 10 --refresh-lag 2
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced --steps 30 --refresh-every 5 --refresh-policy drift --refresh-lag 2
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced --vocab-parallel 2 --steps 4 --ckpt build/ck-vp
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import (CheckpointError, CheckpointManager,
                                    save_serving_state)
from repro_torch.configs import get_config
from repro_torch.core import noise
from repro_torch.data import ZipfLM, make_lm_stream
from repro_torch.dist import collectives as coll
from repro_torch.dist import sharding as shard_mod
from repro_torch.dist import vocab_parallel as vp_mod
from repro_torch.index.lifecycle import IndexLifecycle
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import RankGrid, mesh_dp, mesh_vp, spawn_ranks
from repro_torch.models import heads, init_params
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.proposals import registry as proposals_registry
from repro_torch.resilience import (FaultInjector, FaultSpec, InjectedFault,
                                    TrainGuardrails)
from repro_torch.resilience.validate import validate_state
from repro_torch.utils import metrics as metrics_mod

# Generator streams derived from the run's seed.
_STREAM_INIT, _STREAM_INDEX, _STREAM_REFRESH = range(3)


#: families whose batches carry media the token stream cannot make
MEDIA_FAMILIES = ("vlm", "audio")


def media_refusal(cfg) -> str:
    media = "image_emb" if cfg.family == "vlm" else "frames"
    return (f"{cfg.name} ({cfg.family}) needs {media} in every batch, "
            "which the token stream does not carry: train it through "
            "repro_torch.launch.steps.make_train_step with batches that "
            "carry the media")


def _generator(device: torch.device, seed: int, stream: int):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(noise.hash_bits(seed, stream, 0, 0)))
    return gen


class GridState:
    """A multi-process run's view of its rank grid for the loop: the
    replicated state for the checkpoints and the serving export (`full`,
    a collective over the vocab group; `local` cuts it back to this rank's
    rows), the world barrier and the world's verdicts."""

    def __init__(self, grid: RankGrid):
        self.grid = grid
        self.vp = mesh_vp(grid) > 1

    @property
    def writer(self) -> bool:
        return self.grid.world_rank == 0

    def full(self, params, opt_state, index):
        if not self.vp:
            return params, opt_state, index
        pg = self.grid.pg
        return (shard_mod.gather_params(params, pg),
                shard_mod.map_opt_state(
                    opt_state, lambda t: shard_mod.gather_params(t, pg)),
                vp_mod.stack_local_indexes(index, pg))

    def local(self, state):
        if not self.vp:
            return state
        params, opt_state, sharded = state
        n, r = self.grid.size, self.grid.rank
        return (shard_mod.shard_params(params, n, r),
                shard_mod.map_opt_state(
                    opt_state, lambda t: shard_mod.shard_params(t, n, r)),
                vp_mod.local_index(sharded, r))

    def barrier(self):
        if coll.group_size() > 1:
            torch.distributed.barrier()

    def any(self, flag: bool) -> bool:
        """Whether `flag` holds on any rank of the world (a collective)."""
        return bool(coll.psum_no_grad(torch.tensor(
            [int(flag)], device=self.grid.device)).item())

    def validate(self, new, like):
        """`validate_state` on this rank, with the verdict all-reduced: a
        refresh any rank rejects is rejected on every rank."""
        reasons = list(validate_state(new, like=like))
        if self.any(bool(reasons)) and not reasons:
            reasons = ["another rank rejected its refresh"]
        return reasons


@dataclasses.dataclass
class StragglerWatchdog:
    """EWMA step-time monitor. At scale each host reports its step time; a
    host whose EWMA exceeds `threshold` x the fleet median gets its
    grad-accum microbatches re-balanced. Here: detection and the
    re-balance decision, which the single-process loop logs."""
    alpha: float = 0.2
    threshold: float = 1.8
    ewma: Optional[float] = None
    trips: int = 0

    def observe(self, dt: float, fleet_median: Optional[float] = None) -> bool:
        self.ewma = dt if self.ewma is None else \
            (1 - self.alpha) * self.ewma + self.alpha * dt
        ref = fleet_median if fleet_median is not None else self.ewma
        slow = dt > self.threshold * max(ref, 1e-9)
        if slow:
            self.trips += 1
        return slow

    def rebalance_plan(self, num_microbatches: int) -> dict:
        """Shed one microbatch to the fastest peer (returned as a plan; a
        multi-host launcher applies it via the deterministic pipeline)."""
        return {"shed_microbatches": 1 if self.trips > 0 else 0,
                "of": num_microbatches}


def train_loop(cfg, *, steps: int, batch_size: int, seq_len: int,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 100,
               corpus: Optional[np.ndarray] = None, lr: float = 3e-4,
               head_mode: Optional[str] = None, log_every: int = 20,
               seed: int = 0, total_steps: Optional[int] = None,
               refresh_every: Optional[int] = None,
               refresh_policy: Optional[str] = None,
               refresh_lag: Optional[int] = None,
               on_metrics: Optional[Callable[[int, dict], None]] = None,
               on_refresh: Optional[Callable] = None, device=None,
               injector: Optional[FaultInjector] = None,
               guardrails=None, group: Optional[RankGrid] = None,
               grad_transport: str = "fp32",
               fused_head: Optional[bool] = None):
    """Single-device training loop. Returns (params, opt_state, index,
    history): params detached, ready for `serve.Engine(cfg, params,
    index=index, head=mode)`; index the head state (the MultiIndex, or the
    proposal's state for a registry mode); history the per-step losses of
    this leg (a resumed run's start at its checkpoint).

    total_steps: the job's schedule horizon (default `steps`), fixed across
    resume legs. ckpt_dir: resume from the newest checkpoint there that
    verifies, save every `ckpt_every` steps and at the end, and export
    `{"params", "index"}` to `<ckpt_dir>/serve` for `Engine.
    from_checkpoint`. injector: a `resilience.FaultInjector`, clocked by
    the step, whose faults reach the loss (`_fault_scale`), the refresh
    and the checkpoint's save phases. guardrails: a `resilience.
    GuardrailConfig`; a 'rollback' restores the newest checkpoint that
    verifies and replays from its step. on_metrics(step, metrics) also
    receives `step_s`, the host time of the step (which ends in a device
    sync), `guard_action` and `straggler`. on_refresh(event) receives
    every completed (or rejected) `index.lifecycle.RefreshEvent`. device:
    default the card.

    group: a `launch.mesh.RankGrid`; this process is then one rank of a
    multi-process run on the grid's device. Every rank must call with the
    same arguments. With a vocab degree > 1 params, opt_state and index
    come back as its shard (the rows of the class table, the local index
    view); with a vocab degree of 1 it runs the data-parallel step
    (`launch.steps.make_sharded_train_step`, a data degree of 1 included)
    on its rows of every batch, the gradient reduced in `grad_transport`
    ('fp32', 'bf16' or 'int8_ef'; a non-fp32 transport with a vocab degree
    > 1 is refused, as in the reference). Without a grid, a non-fp32
    transport runs the data-parallel step on a data group of this process
    alone, as the reference's one-device mesh does. fused_head: the MIDX
    head's route on every step (`launch.steps.make_loss_fn`; None defers
    to cfg.head.use_fused_head)."""
    if cfg.family in MEDIA_FAMILIES:
        raise ValueError(media_refusal(cfg))
    steps_mod.check_grad_transport(grad_transport)
    if group is None and grad_transport != "fp32":
        group = RankGrid(0, 1, resolve_device(device), "none")
    refresh_kw = {k: v for k, v in (("refresh_every", refresh_every),
                                    ("refresh_policy", refresh_policy),
                                    ("refresh_lag", refresh_lag))
                  if v is not None}
    if refresh_kw:
        cfg = cfg.with_head(**refresh_kw)
    mode, proposal = steps_mod.resolve_proposal(cfg, head_mode)
    gstate = GridState(group) if group is not None else None
    vstate = gstate if gstate is not None and gstate.vp else None
    rows = shard_mod.data_rows(batch_size, mesh_dp(group),
                               0 if group is None else group.data_rank)
    if vstate is not None:
        if mode != "midx":
            raise ValueError("vocab-parallel training requires the midx head")
        if grad_transport != "fp32":
            raise ValueError("compressed grad transports are not wired into "
                             "the vocab-parallel step; use fp32")
    if group is not None:
        device = group.device
    device = resolve_device(device)
    horizon = total_steps or steps

    params = init_params(cfg, _generator(device, seed, _STREAM_INIT),
                         device=device)
    if vstate is not None:
        params = shard_mod.shard_params(params, group.size, group.rank)
    optimizer = adamw(cosine_schedule(lr,
                                      warmup_steps=min(100, horizon // 10 + 1),
                                      total_steps=horizon))
    opt_state = optimizer.init(params)

    if corpus is None:
        gen = ZipfLM(vocab_size=cfg.vocab_size, num_clusters=64,
                     seq_len=seq_len + 1, seed=seed)
        corpus = gen.sample(max(512, batch_size * 4))
    stream = make_lm_stream(corpus, batch_size, seed=seed)

    gen_index = _generator(device, seed, _STREAM_INDEX)
    if vstate is not None:
        train_step = steps_mod.make_vocab_parallel_train_step(
            cfg, optimizer, group, fused_head=fused_head)
        index = steps_mod.make_vocab_index_init(cfg, group)(params,
                                                            gen_index)
        vp_refresh = steps_mod.make_vocab_refresh_step(cfg, group)
    elif gstate is not None:
        train_step = steps_mod.make_sharded_train_step(
            cfg, optimizer, group, grad_transport=grad_transport,
            head_mode=mode, fused_head=fused_head)
    else:
        train_step = steps_mod.make_train_step(cfg, optimizer,
                                               head_mode=mode,
                                               fused_head=fused_head)
    if vstate is None and proposal is not None:
        # the unigram family and TAPAS take the corpus's class frequencies;
        # every other contender ignores them
        freq = np.bincount(np.asarray(corpus).reshape(-1),
                           minlength=cfg.padded_vocab).astype(np.float64)
        index = heads.init_proposal_state(cfg, params, gen_index, proposal,
                                          freq)
    elif vstate is None:
        # the full head trains without it, but its checkpoints carry a
        # MultiIndex, as the reference's do (reference :180)
        index = heads.init_head_state(cfg, params, gen_index)
    ef = steps_mod.init_grad_transport_state(params, grad_transport)
    # the MIDX index refreshes data-sharded over the data group (one device:
    # the single-device refresh); a proposal refreshes replicated
    midx_refresh = steps_mod.make_refresh_step(
        cfg, None if vstate is not None else group)

    def refresh(p, state, step_seed):
        gen = torch.Generator(device=device)
        gen.manual_seed(step_seed)
        if vstate is not None:
            return vp_refresh(p, state, gen)
        if proposal is None:
            return midx_refresh(p, state, gen)
        # drift probes are a MultiIndex notion: a proposal reports none
        return heads.refresh_proposal_state(cfg, p, proposal, state, gen), {}

    if injector is not None:
        refresh = injector.wrap_refresh(refresh)
    lifecycle = IndexLifecycle(
        refresh, every=cfg.head.refresh_every, lag=cfg.head.refresh_lag,
        base_seed=int(noise.hash_bits(seed, _STREAM_REFRESH, 0, 0)),
        enabled=mode == "midx" or (proposal is not None
                                   and proposal.adaptive),
        validate=None if gstate is None else gstate.validate)

    def refreshed(ev) -> None:
        if ev is None:
            return
        drift = "".join(f" {name}={ev.metrics[key]:.3f}" for name, key
                        in (("reassigned", "reassigned_frac"),
                            ("drift", "codeword_drift"))
                        if key in ev.metrics)
        print(f"[train] refresh @{ev.step} (swap @{ev.swap_step}) "
              f"mode={ev.mode} {ev.seconds:.3f}s{drift}")
        if ev.rejected:
            print(f"[train] refresh @{ev.step} REJECTED: "
                  f"{'; '.join(ev.reasons)} — keeping live state")
        if on_refresh:
            on_refresh(ev)

    ckpt = None
    if ckpt_dir and gstate is not None:
        # rank 0 heals a half-done swap before the others look
        if gstate.writer:
            ckpt = CheckpointManager(ckpt_dir)
        gstate.barrier()
        if not gstate.writer:
            ckpt = CheckpointManager(ckpt_dir)
    elif ckpt_dir:
        ckpt = CheckpointManager(ckpt_dir)
    if ckpt is not None and injector is not None:
        injector.attach_checkpoint(ckpt)

    def ckpt_tree(p, o, i):
        """What a checkpoint holds: the replicated state (gathered over
        the vocab group in a vocab-parallel run, a collective)."""
        return (p, o, i) if vstate is None else vstate.full(p, o, i)

    def restore(fn, *a):
        """`ckpt.restore` / `restore_latest_verified`, on this rank's
        shard in a vocab-parallel run."""
        like = ckpt_tree(params, opt_state, index)
        out = fn(*a, like, device=device)
        if vstate is None:
            return out
        if isinstance(out[0], int):          # (step, state)
            return out[0], vstate.local(out[1])
        return vstate.local(out)

    def save(step_n: int, p, o, i) -> None:
        """World rank 0 writes; a kill in its save is raised on every
        rank, so the ranks agree on what was saved."""
        tree = ckpt_tree(p, o, i)
        if gstate is None:
            ckpt.save(step_n, tree, metadata={"next_step": step_n})
            return
        killed = None
        if gstate.writer:
            try:
                ckpt.save(step_n, tree, metadata={"next_step": step_n})
            except InjectedFault as e:
                killed = e
        if gstate.any(killed is not None):
            raise killed or InjectedFault(
                f"save(step={step_n}) killed on world rank 0")

    start_step, saved = 0, None
    if ckpt is not None:
        # restore-fallback walk: resume from the newest checkpoint that
        # passes verification, skipping corrupt or mismatched step dirs
        s = ckpt.latest_verified_step(ckpt_tree(params, opt_state, index))
        if s is not None:
            params, opt_state, index = restore(ckpt.restore, s)
            start_step = saved = ckpt.metadata(s).get("next_step", s)
            print(f"[train] resumed from step {start_step}")

    guard = TrainGuardrails(guardrails)
    watchdog = StragglerWatchdog()
    history = []
    leg_start = step = start_step
    while step < steps:
        if injector is not None:
            injector.note_step(step)
        batch = {k: torch.from_numpy(v[rows]).long().to(device)
                 for k, v in stream.batch_at(step).items()}
        if injector is not None:
            batch["_fault_scale"] = torch.full(
                (batch_size,), injector.loss_scale(step),
                dtype=torch.float32, device=device)[rows]
        # the global per-token keys of this rank's rows
        keys = noise.train_keys(seed, step, batch_size * seq_len,
                                device)[rows.start * seq_len:
                                        rows.stop * seq_len]
        t0 = time.perf_counter()
        if injector is not None:
            injector.maybe_sleep(step)
        if train_step.returns_state:
            params, opt_state, index, metrics = train_step(
                params, opt_state, index, batch, keys)
        elif gstate is not None and vstate is None:
            params, opt_state, metrics, ef = train_step(
                params, opt_state, index, batch, keys, ef)
        else:
            params, opt_state, metrics = train_step(params, opt_state, index,
                                                    batch, keys)
        loss = float(metrics["loss"])                  # sync point
        dt = time.perf_counter() - t0
        skipped = metrics["skipped"] > 0.5
        slow = watchdog.observe(dt)
        if slow:
            print(f"[train] straggler warning at step {step}: {dt:.3f}s "
                  f"(ewma {watchdog.ewma:.3f}s) -> "
                  f"{watchdog.rebalance_plan(batch_size)}")
        action = guard.observe(step, loss, skipped=skipped)
        if skipped:
            print(f"[train] step {step}: non-finite update skipped "
                  f"(loss {loss}, params/opt state unchanged)")
        if action == "rollback":
            if ckpt is None:
                print(f"[train] guardrails requested rollback at step {step} "
                      "but no ckpt_dir is set — continuing degraded")
            else:
                try:
                    lifecycle.abort()
                    s, (params, opt_state, index) = restore(
                        ckpt.restore_latest_verified)
                    resume = ckpt.metadata(s).get("next_step", s)
                    print(f"[train] rollback at step {step}: restored "
                          f"checkpoint {s}, replaying from step {resume}")
                    del history[max(0, resume - leg_start):]
                    step = resume
                    continue
                except CheckpointError as e:
                    print(f"[train] rollback impossible ({e}) — continuing")
        index, ev = lifecycle.step(step, params, index)
        refreshed(ev)
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"ce {float(metrics['ce']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} ({dt:.3f}s)")
        history.append(loss)
        if on_metrics:
            on_metrics(step, {**metrics, "step_s": dt, "guard_action": action,
                              "straggler": 1.0 if slow else 0.0})
        if ckpt is not None and (step + 1) % ckpt_every == 0:
            # the saved head state is never mid-flight
            index, ev = lifecycle.flush(step, index)
            refreshed(ev)
            try:
                save(step + 1, params, opt_state, index)
                saved = step + 1
            except InjectedFault as e:
                print(f"[train] checkpoint save at step {step + 1} "
                      f"killed: {e} — previous checkpoint still intact")
        step += 1
    index, ev = lifecycle.flush(steps - 1, index)
    refreshed(ev)
    if lifecycle.events:
        rs = lifecycle.summary()
        print(f"[train] refresh summary: {rs['refreshes']} events "
              f"({rs['full_refits']} full / {rs['reassign_only']} reassign / "
              f"{rs['rejected']} rejected) {rs['refresh_s']:.2f}s total")
    if guard.events:
        gs = metrics_mod.guardrail_summary(guard.events)
        print(f"[train] guardrail summary: {gs['skips']} skips, "
              f"{gs['spikes']} spikes, {gs['rollbacks']} rollbacks")
    if ckpt is not None:
        try:
            if saved != steps:      # the loop's last save may have been it
                save(steps, params, opt_state, index)
        except InjectedFault as e:
            print(f"[train] final checkpoint save killed: {e}")
        # serving export: {"params", "index"}, no optimizer state — what
        # `serve.Engine.from_checkpoint` restores; a vocab-parallel run
        # gathers its params and unshards its index (replicated layout)
        export_params, export_index = params, index
        if vstate is not None:
            export_params = shard_mod.gather_params(params, group.pg)
            export_index = vp_mod.unshard_index(
                vp_mod.stack_local_indexes(index, group.pg))
        if gstate is None or gstate.writer:
            save_serving_state(os.path.join(ckpt_dir, "serve"), steps,
                               export_params, export_index,
                               metadata={"arch": cfg.name})
        if gstate is not None:
            gstate.barrier()
    return params, opt_state, index, history


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="paper-lm")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced (CPU smoke) config")
    ap.add_argument("--head", default=None,
                    choices=(None, *proposals_registry.proposal_modes()),
                    help="head mode (default: cfg.head.mode)")
    ap.add_argument("--fused-head", default="auto",
                    choices=("auto", "on", "off", "interpret"),
                    help="the MIDX head's route: auto = "
                         "cfg.head.use_fused_head; on = the fused route "
                         "(the hand-written kernels on the card, their "
                         "plain versions on the CPU); off = the unfused "
                         "route (plain torch ops, no kernel); the "
                         "reference's interpret route is not offered")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--refresh-every", type=int, default=None,
                    help="steps between index refresh events "
                         "(default: cfg.head.refresh_every)")
    ap.add_argument("--refresh-policy", default=None,
                    choices=(None, "fixed", "drift"),
                    help="index refresh policy (DESIGN §8): fixed = full "
                         "warm-started refit every event; drift = reassign-"
                         "only, escalating to the refit when drift exceeds "
                         "cfg.head.refresh_drift_threshold")
    ap.add_argument("--refresh-lag", type=int, default=None,
                    help="staleness window: swap the rebuilt index in this "
                         "many steps after dispatch (0 = synchronous)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' must be asked)")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint dir: resume from it, save to it every "
                         "100 steps and at the end, export <ckpt>/serve")
    ap.add_argument("--chaos", default=None,
                    help="fault plan, comma-separated 'kind@step[:mode_or_"
                         "arg]' specs, e.g. 'nan_loss@10,"
                         "slow_step@5:0.2,kill_mid_save@100:committed'")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed of the injector's (seed, step) fault streams")
    ap.add_argument("--table-dtype", default=None,
                    help="class-table storage on the head's hot path "
                         "(DESIGN §12): bf16 = master precision (default), "
                         "int8/fp8 = per-row-scaled low-bit table + "
                         "quantized proposal codebooks + PQ-code residual")
    ap.add_argument("--vocab-parallel", type=int, default=1,
                    help="vocab-parallel degree: >1 spawns that many ranks, "
                         "each training a row shard of the class table and "
                         "the MIDX index (DESIGN §9)")
    ap.add_argument("--vp-backend", default=None, choices=(None, "gloo",
                                                           "nccl"),
                    help="the ranks' collective backend (default: gloo "
                         "where ranks share a card or run on the CPU, NCCL "
                         "where each has its own card)")
    ap.add_argument("--dp", type=int, default=0,
                    help="data-parallel degree: >0 spawns that many ranks "
                         "(times --vocab-parallel), each training on its "
                         "rows of every batch (DESIGN §4)")
    ap.add_argument("--grad-transport", default="fp32",
                    choices=steps_mod.GRAD_TRANSPORTS,
                    help="gradient all-reduce transport (DESIGN §4); without "
                         "--dp a non-fp32 transport runs a data group over "
                         "every local card")
    return ap


def local_cards(device) -> int:
    """The data degree a non-fp32 transport takes without --dp: every
    local card (reference :132-133), one process on the CPU."""
    if device is not None and torch.device(device).type == "cpu":
        return 1
    return max(1, torch.cuda.device_count())


def main(argv=None):
    args = parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family in MEDIA_FAMILIES:
        raise SystemExit(media_refusal(cfg))
    if args.fused_head == "interpret":
        raise SystemExit("--fused-head interpret: the port has no Pallas "
                         "interpreter; its fused route runs the hand-written "
                         "kernels on the card and their plain versions on "
                         "the CPU (--fused-head on), its unfused route plain "
                         "torch ops (--fused-head off)")
    if args.vocab_parallel > 1 and args.grad_transport != "fp32":
        raise ValueError("compressed grad transports are not wired into "
                         "the vocab-parallel step; use fp32")
    dp = args.dp
    if dp == 0 and args.grad_transport != "fp32":
        dp = local_cards(args.device)
    shard_mod.data_rows(args.batch, max(dp, 1), 0)   # batch % dp refused
    if args.table_dtype is not None:
        cfg = cfg.with_head(table_dtype=args.table_dtype)
    kw = dict(steps=args.steps, batch_size=args.batch, seq_len=args.seq,
              ckpt_dir=args.ckpt, head_mode=args.head, lr=args.lr,
              refresh_every=args.refresh_every,
              refresh_policy=args.refresh_policy,
              refresh_lag=args.refresh_lag, seed=args.seed,
              grad_transport=args.grad_transport,
              fused_head={"auto": None, "on": True,
                          "off": False}[args.fused_head])
    chaos = (args.chaos, args.chaos_seed) if args.chaos else None
    world = max(dp, 1) * args.vocab_parallel
    if world > 1:
        # each rank a share of this process's intra-op threads on the CPU
        threads = max(1, torch.get_num_threads() // world) \
            if args.device == "cpu" else 0
        spawn_ranks(_grid_rank, args.vocab_parallel, (cfg, kw, chaos),
                    dp=max(dp, 1), device=args.device,
                    backend=args.vp_backend, threads=threads)
        return None
    if dp == 1:
        # --dp 1: the data-parallel step on a data group of one
        kw["group"] = RankGrid(0, 1, resolve_device(args.device), "none")
    injector = _parse_chaos(*chaos) if chaos else None
    out = train_loop(cfg, device=args.device, injector=injector, **kw)
    if injector is not None:
        print(f"[train] chaos report: {injector.summary()}")
    return out


def _grid_rank(grid, cfg, kw, chaos) -> None:
    """One rank of `--dp` / `--vocab-parallel`: world rank 0 prints the
    run's log and the chaos report."""
    injector = _parse_chaos(*chaos) if chaos else None

    def run():
        train_loop(cfg, group=grid, injector=injector, **kw)
        if injector is not None:
            print(f"[train] chaos report: {injector.summary()}")

    if grid.world_rank != 0:
        import contextlib
        with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
            run()
        return
    run()


def _parse_chaos(plan: str, seed: int) -> FaultInjector:
    """'kind@step[:mode_or_arg]' specs -> a FaultInjector. A numeric suffix
    becomes FaultSpec.arg (spike factor, sleep seconds); anything else
    becomes FaultSpec.mode (refresh degeneracy, save phase)."""
    specs = []
    for item in plan.split(","):
        item = item.strip()
        if not item:
            continue
        kind, _, rest = item.partition("@")
        step_s, _, extra = rest.partition(":")
        spec = FaultSpec(kind=kind, step=int(step_s) if step_s else -1)
        if extra:
            try:
                spec = dataclasses.replace(spec, arg=float(extra))
            except ValueError:
                spec = dataclasses.replace(spec, mode=extra)
        specs.append(spec)
    return FaultInjector(seed, specs)


if __name__ == "__main__":
    main()
