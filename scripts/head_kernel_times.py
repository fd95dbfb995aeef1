"""Host and card time of the port's `midx_probs` and shared-negative
sampled-CE forward calls, and of their plain versions, on one CUDA card.

At the shapes at which `chip_smoke.py` times these two functions (the
seven `midx_probs` shapes, the four `SHARED_TRAIN` shapes), on the smoke's
own inputs, it reads each call and its plain version three ways:

- `smoke_ms`: `chip_smoke.time_ms`, the smoke's timer: the median of 50
  calls, each after a 128 MB write that flushes the L2, CUDA events
  recorded around the call. Where the host takes longer to issue the call
  than the card takes to flush, the host's issue is in the figure;
- `device_ms`: the same, with the card held in a ~0.5 ms spin
  (`torch.cuda._sleep`) before the start event, so the host has issued the
  whole call before the card reaches it: the card's time alone;
- `host_us` and `card_us`: the host's time to issue one call, and the
  card's time per call, over `--calls` calls issued back to back.

A `torch.add` of a [4, 2048] fp32 tensor is the gauge of the host's speed
in the process. One JSON object per run on stdout.

    PYTHONPATH=src python3 scripts/head_kernel_times.py

It calls only entry points that every version of the port since these
kernels were ported has, so the same file measures an older checkout:
`PYTHONPATH=<checkout>/src python3 scripts/head_kernel_times.py`.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

SPIN_CYCLES = 1_000_000        # ~0.5 ms of the card's clock


def device_ms(fn, buf, flush, reps: int = 50, warm: int = 5) -> float:
    """`chip_smoke.time_ms` with a spin on the card before the start
    event."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        flush(buf)
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def issue_us(fn, calls: int) -> tuple[float, float]:
    """(host µs to issue one call, card µs per call) over `calls` calls
    back to back."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
    t0 = time.perf_counter()
    start.record()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return 1e6 * host / calls, 1e3 * start.elapsed_time(end) / calls


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("head_kernel_times: torch sees no CUDA device")
    # the port under test comes from PYTHONPATH; import it before
    # chip_smoke, which puts this checkout's src first on the path
    from repro_torch.kernels.midx_probs import cuda as midx_cuda
    from repro_torch.kernels.midx_probs.ref import midx_probs_ref
    from repro_torch.kernels.sampled_ce import cuda as sce_cuda
    from repro_torch.kernels.sampled_ce.ref import sampled_ce_fwd_ref
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as smoke

    torch.backends.cuda.matmul.allow_tf32 = False    # as the smoke's phase 3
    torch.backends.cudnn.allow_tf32 = False
    buf = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")
    out = {"label": args.label, "card": smoke.card_line(),
           "port": os.path.dirname(midx_cuda.__file__)}

    def read(kern, plain) -> dict:
        got = {}
        for name, fn in (("kernel", kern), ("plain", plain)):
            host, card = issue_us(fn, args.calls)
            got[name] = {"smoke_ms": smoke.time_ms(fn, buf),
                         "device_ms": device_ms(fn, buf, smoke.flush_l2),
                         "host_us": host, "card_us": card}
        return got

    out["midx_probs"] = {}
    for name, (t, d, k, split) in (
            ("paper-lm decode", (4, 200, 32, False)),
            ("llama3.2-1b decode", (4, 2048, 64, False)),
            ("llama3.2-1b T=8", (8, 2048, 64, False)),
            ("llama3.2-1b T=512", (512, 2048, 64, False)),
            ("llama3.2-1b decode pq", (4, 2048, 64, True)),
            ("mamba2-370m decode", (4, 1024, 64, False)),
            ("paper-lm train", (1024, 200, 32, False))):
        z, cb1, cb2, counts = smoke.midx_inputs(t, d, k, split, seed=1)
        out["midx_probs"][name] = read(
            lambda: midx_cuda.midx_probs_cuda(z, cb1, cb2, counts,
                                              split=split),
            lambda: midx_probs_ref(z, cb1, cb2, counts, split=split))
    out["sampled_ce"] = {}
    for name, ((b, s, m, d), v) in smoke.SHARED_TRAIN.items():
        h, pe, ne, lq, neg, pos, _ = smoke.shared_inputs(
            b, s, m, d, v, torch.float32, seed=1)
        out["sampled_ce"][name] = read(
            lambda: sce_cuda.sampled_ce_cuda(h, pe, ne, lq, neg, pos),
            lambda: sampled_ce_fwd_ref(h, pe, ne, lq, neg, pos))
        del h, pe, ne, lq, neg, pos
    x = torch.randn((4, 2048), device="cuda")
    sink = torch.empty_like(x)
    out["torch.add host_us"] = issue_us(
        lambda: torch.add(x, 1.0, out=sink), args.calls)[0]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
