"""Training loop and CLI: the MIDX head first-class, on one card.

Mirrors `src/repro/launch/train.py`: `train_loop` (:68) on a single device
with the `midx` and `full` heads and the ported registry proposals (`rff`,
`rff-fused`; their state initialised as at :172-177 and refreshed by the
lifecycle when adaptive, :200-201 — the RFF refresh re-maps φ(C) from the
current table), the head-state refresh lifecycle, the loss history and
the step log, and the CLI (`main` :348) with the flags --arch
--steps --batch --seq --lr --head --reduced --refresh-every, plus --device
(default: the card; 'cpu' must be asked for). The reference's other flags
are accepted and raise NotImplementedError with a pointer to ROADMAP.md
Queue 1: --dp, --vocab-parallel and --grad-transport (item 13), --chaos
(item 11), --ckpt (item 5), --refresh-policy drift and --refresh-lag > 0
(item 9), --table-dtype int8/fp8 (item 8).

Every random choice is a pure function of (seed, step): the batches
(`TokenStream.batch_at`), the negatives (counter-hash keys per token, see
`core.noise.train_keys`) and the refresh's K-means generator. Two runs
with one seed on one device therefore agree bit for bit.

The head trains with the config's proposal: per-token for `paper-lm`,
the shared-negative `pooled` default (`HeadConfig.proposal`) for the other
configs, e.g. `llama3.2-1b` at full width (M = 1024, K = 64) and
`mamba2-370m` (the ssm family, its chunked scan through the ssd_scan
kernel on the card). Sequences longer than 1024 tokens (the repo's
`train_4k` length, 4096) run their attention through the chunked flash
path. The moe, hybrid, vlm and audio families raise (ROADMAP.md Queue 1
item 12b).

`train_loop`'s default corpus is the reference's, max(512, 4 x batch)
`ZipfLM` sequences at every length, so CLI runs train on the reference
CLI's data.

  python -m repro_torch.launch.train --arch paper-lm --steps 120 --lr 3e-3
  python -m repro_torch.launch.train --arch llama3.2-1b --steps 40 --batch 4 --seq 256
  python -m repro_torch.launch.train --arch llama3.2-1b --seq 4096 --batch 2 --steps 20 --lr 1e-3
  python -m repro_torch.launch.train --arch paper-lm --head rff-fused --steps 120 --lr 3e-3
  python -m repro_torch.launch.train --arch mamba2-370m --steps 30 --batch 4 --seq 1024 --lr 1e-3
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m --device cpu --reduced
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import noise
from repro_torch.data import ZipfLM, make_lm_stream
from repro_torch.index.lifecycle import IndexLifecycle
from repro_torch.launch import steps as steps_mod
from repro_torch.models import heads, init_params
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.proposals import registry as proposals_registry

# Generator streams derived from the run's seed.
_STREAM_INIT, _STREAM_INDEX, _STREAM_REFRESH = range(3)


def _unported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md "
                               f"Queue 1 item {item})")


def _generator(device: torch.device, seed: int, stream: int):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(noise.hash_bits(seed, stream, 0, 0)))
    return gen


def train_loop(cfg, *, steps: int, batch_size: int, seq_len: int,
               corpus: Optional[np.ndarray] = None, lr: float = 3e-4,
               head_mode: Optional[str] = None, log_every: int = 20,
               seed: int = 0, total_steps: Optional[int] = None,
               refresh_every: Optional[int] = None,
               refresh_policy: Optional[str] = None,
               refresh_lag: Optional[int] = None,
               on_metrics: Optional[Callable[[int, dict], None]] = None,
               device=None):
    """Single-device training loop. Returns (params, opt_state, index,
    history): params detached, ready for `serve.Engine(cfg, params,
    index=index, head=mode)`; index the head state (the MultiIndex, or the
    proposal's state for a registry mode); history the per-step losses.

    total_steps: the schedule horizon (default `steps`). on_metrics(step,
    metrics) also receives `step_s`, the host time of the step (which ends
    in a device sync). device: default the card."""
    refresh_kw = {k: v for k, v in (("refresh_every", refresh_every),
                                    ("refresh_policy", refresh_policy),
                                    ("refresh_lag", refresh_lag))
                  if v is not None}
    if refresh_kw:
        cfg = cfg.with_head(**refresh_kw)
    mode, proposal = steps_mod.resolve_proposal(cfg, head_mode)
    device = resolve_device(device)
    horizon = total_steps or steps

    params = init_params(cfg, _generator(device, seed, _STREAM_INIT),
                         device=device)
    optimizer = adamw(cosine_schedule(lr,
                                      warmup_steps=min(100, horizon // 10 + 1),
                                      total_steps=horizon))
    opt_state = optimizer.init(params)

    if corpus is None:
        gen = ZipfLM(vocab_size=cfg.vocab_size, num_clusters=64,
                     seq_len=seq_len + 1, seed=seed)
        corpus = gen.sample(max(512, batch_size * 4))
    stream = make_lm_stream(corpus, batch_size, seed=seed)

    train_step = steps_mod.make_train_step(cfg, optimizer, head_mode=mode)
    index = None
    gen_index = _generator(device, seed, _STREAM_INDEX)
    if mode == "midx":
        index = heads.init_head_state(cfg, params, gen_index)
    elif proposal is not None:
        index = heads.init_proposal_state(cfg, params, gen_index, proposal)

    def refresh(p, state, step_seed):
        gen = torch.Generator(device=device)
        gen.manual_seed(step_seed)
        if proposal is None:
            return heads.refresh_head_state_with_policy(cfg, p, state, gen)
        # drift probes are a MultiIndex notion: a proposal reports none
        return heads.refresh_proposal_state(cfg, p, proposal, state, gen), {}

    lifecycle = IndexLifecycle(
        refresh, every=cfg.head.refresh_every, lag=cfg.head.refresh_lag,
        base_seed=int(noise.hash_bits(seed, _STREAM_REFRESH, 0, 0)),
        enabled=mode == "midx" or (proposal is not None
                                   and proposal.adaptive))

    history = []
    for step in range(steps):
        batch = {k: torch.from_numpy(v).long().to(device)
                 for k, v in stream.batch_at(step).items()}
        keys = noise.train_keys(seed, step, batch_size * seq_len, device)
        t0 = time.perf_counter()
        params, opt_state, metrics = train_step(params, opt_state, index,
                                                batch, keys)
        loss = float(metrics["loss"])                  # sync point
        dt = time.perf_counter() - t0
        if metrics["skipped"]:
            print(f"[train] step {step}: non-finite update skipped "
                  f"(loss {loss}, params/opt state unchanged)")
        index, ev = lifecycle.step(step, params, index)
        if ev is not None:
            drift = "".join(f" {name}={ev.metrics[key]:.3f}" for name, key
                            in (("reassigned", "reassigned_frac"),
                                ("drift", "codeword_drift"))
                            if key in ev.metrics)
            print(f"[train] refresh @{ev.step} mode={ev.mode} "
                  f"{ev.seconds:.3f}s{drift}")
            if ev.rejected:
                print(f"[train] refresh @{ev.step} REJECTED: "
                      f"{'; '.join(ev.reasons)} — keeping live state")
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"ce {float(metrics['ce']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} ({dt:.3f}s)")
        history.append(loss)
        if on_metrics:
            on_metrics(step, {**metrics, "step_s": dt})
    if lifecycle.events:
        ev = lifecycle.events
        print(f"[train] refresh summary: {len(ev)} events "
              f"({sum(e.rejected for e in ev)} rejected) "
              f"{sum(e.seconds for e in ev):.2f}s total")
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
                    choices=(None, *proposals_registry.PORTED_MODES),
                    help="head mode (default: cfg.head.mode)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--refresh-every", type=int, default=None,
                    help="steps between index refresh events "
                         "(default: cfg.head.refresh_every)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' must be asked)")
    unported = ap.add_argument_group("not ported yet (raise)")
    unported.add_argument("--ckpt", default=None)
    unported.add_argument("--dp", type=int, default=0)
    unported.add_argument("--vocab-parallel", type=int, default=1)
    unported.add_argument("--grad-transport", default="fp32")
    unported.add_argument("--chaos", default=None)
    unported.add_argument("--refresh-policy", default=None)
    unported.add_argument("--refresh-lag", type=int, default=None)
    unported.add_argument("--table-dtype", default=None)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.ckpt is not None:
        raise _unported("checkpointing (--ckpt)", 5)
    if (args.dp > 0 or args.vocab_parallel > 1
            or args.grad_transport != "fp32"):
        raise _unported("data- and vocab-parallel training and gradient "
                        "transports", 13)
    if args.chaos:
        raise _unported("fault injection (--chaos)", 11)
    if args.table_dtype is not None:
        cfg = cfg.with_head(table_dtype=args.table_dtype)
    return train_loop(cfg, steps=args.steps, batch_size=args.batch,
                      seq_len=args.seq, head_mode=args.head, lr=args.lr,
                      refresh_every=args.refresh_every,
                      refresh_policy=args.refresh_policy,
                      refresh_lag=args.refresh_lag, seed=args.seed,
                      device=args.device)


if __name__ == "__main__":
    main()
