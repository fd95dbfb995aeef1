"""Where the fused MIDX proposal-tables route's time goes, on one CUDA
card: at `chip_smoke.py` phase 22d's three shapes (llama3.2-1b and
mamba2-370m decode, paper-lm training), on the smoke's own inputs, each
piece of the route read three ways (`head_kernel_times.py`'s readings):
`smoke_ms` (the smoke's timer: cold L2, CUDA events around one call),
`device_ms` (the same with the card held in a spin until the host has
issued the call: the card's time alone) and `host_us` (the host's time
to issue one call, over `--calls` calls back to back). The pieces:

- `fwd_kernel`, `bwd_kernel`: the two wrappers called directly
  (`midx_probs_cuda`, `midx_probs_bwd_cuda`);
- `fused_fwd`: `proposal_tables` (the autograd op's forward);
- `fused_fwd_bwd`: that and `torch.autograd.grad` through it, 22d's
  `fused_fwd_bwd_ms`;
- `unfused_fwd_bwd`: the same through `core.midx.twostage_tables`, 22d's
  `fwd_bwd_ms`;
- `grad_identity`: `torch.autograd.grad` through a one-op graph (z * 1)
  of the same z: the autograd engine's own cost a call.

`--train` reads instead the median step of paper-lm's per-token training
(`launch.train.train_loop`, 16 x 64 tokens, `--steps` steps, the first
five left out), through entry points every version of the port has, so
that two trees can be compared in turns in one call:
`PYTHONPATH=<checkout>/src python3 scripts/midx_route_times.py --train`.
One JSON object on stdout, with the card's name and power limit.

    PYTHONPATH=src python3 scripts/midx_route_times.py
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch


def train_step_ms(steps: int) -> dict:
    """paper-lm's per-token training on the card: the median step."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train_loop
    seen = []
    train_loop(get_config("paper-lm"), steps=steps, batch_size=16,
               seq_len=64, lr=3e-3, log_every=10 ** 6, device="cuda",
               on_metrics=lambda step, m: seen.append(m["step_s"]))
    return {"median_step_ms": statistics.median(seen[5:]) * 1e3,
            "steps": len(seen)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=500)
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("midx_route_times: no CUDA device")
    if args.train:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        import repro_torch
        print(json.dumps({"card": card, "src": repro_torch.__file__,
                          "train": train_step_ms(args.steps)}), flush=True)
        return
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    sys.path.insert(0, os.path.dirname(here))
    import chip_smoke as smoke
    from head_kernel_times import device_ms, issue_us
    from repro_torch.core import midx as midx_mod
    from repro_torch.kernels.midx_probs import cuda
    from repro_torch.kernels.midx_probs.ops import proposal_tables
    torch.backends.cuda.matmul.allow_tf32 = False
    buf = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")
    out = {"card": smoke.card_line(), "shapes": {}}
    for name, (t, d, k, split) in smoke.MIDX_BWD_TIMED[:3]:
        z, cb1, cb2, counts = smoke.midx_inputs(t, d, k, split, seed=1)
        idx = smoke.tables_index(cb1, cb2, counts, split)
        zl = z.clone().requires_grad_(True)
        tabs = cuda.midx_probs_cuda(z, cb1, cb2, counts, split=split)
        cot = [torch.randn_like(x) for x in tabs]
        pieces = {
            "fwd_kernel": lambda: cuda.midx_probs_cuda(z, cb1, cb2, counts,
                                                       split=split),
            "bwd_kernel": lambda: cuda.midx_probs_bwd_cuda(
                *tabs, *cot, cb1, cb2, counts, split=split),
            "fused_fwd": lambda: proposal_tables(idx, zl),
            "fused_fwd_bwd": smoke.grad_of(
                lambda zz: proposal_tables(idx, zz), [zl], cot),
            "unfused_fwd_bwd": smoke.grad_of(
                lambda zz: midx_mod.twostage_tables(idx, zz), [zl], cot),
            "grad_identity": smoke.grad_of(lambda zz: zz * 1.0, [zl],
                                           [torch.ones_like(z)])}
        got = {}
        for piece, fn in pieces.items():
            host, card = issue_us(fn, args.calls)
            got[piece] = {"smoke_ms": smoke.time_ms(fn, buf),
                          "device_ms": device_ms(fn, buf, smoke.flush_l2),
                          "host_us": host, "card_us": card}
        out["shapes"][f"{name} T={t} D={d} K={k}"] = got
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
