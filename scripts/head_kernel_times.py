"""Host and card time of the port's `midx_probs`, shared-negative
sampled-CE forward, RFF sampler and per-token sampled-CE backward calls,
and of their plain versions, on one CUDA card.

At the shapes at which `chip_smoke.py` times these functions (the seven
`midx_probs` shapes, the four `SHARED_TRAIN` shapes, the three
`RFF_SHAPES`, the per-token backward's `SCE_PT_TIMED` shapes), on the
smoke's own inputs, and for the per-token backward also at the ids of one
step of the smoke's paper-lm training run (`chip_smoke.TRAIN_IDS`, which
the smoke writes; "not measured" without it), it reads each call and its
plain version three ways:

- `smoke_ms`: `chip_smoke.time_ms`, the smoke's timer: the median of 50
  calls, each after a 128 MB write that flushes the L2, CUDA events
  recorded around the call. Where the host takes longer to issue the call
  than the card takes to flush, the host's issue is in the figure;
- `device_ms`: the same, with the card held in a ~0.5 ms spin
  (`torch.cuda._sleep`) before the start event, so the host has issued the
  whole call before the card reaches it: the card's time alone;
- `host_us` and `card_us`: the host's time to issue one call, and the
  card's time per call, over `--calls` calls issued back to back;
- for the per-token backward also `kernels_us`: each CUDA kernel's (and
  memset's) device µs a call under `torch.profiler`, over 20 calls.

A `torch.add` of a [4, 2048] fp32 tensor is the gauge of the host's speed
in the process. One JSON object per run on stdout. `--save PATH` keeps
the outputs of the `rff_sample` and per-token backward calls (on the
CPU); `--against PATH` compares this run's outputs with a saved run's:
bit for bit, or the count of differing elements and the largest
difference.

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


def kernels_us(fn, calls: int = 20) -> dict:
    """Device µs a call of each kernel that `fn` launches, by name."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    res = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = e.key.replace("void ", "").replace(
                "(anonymous namespace)::", "").split("(")[0].strip()
            res[name] = res.get(name, 0.0) + e.device_time_total / calls
    return res


def compare(got: dict, want: dict) -> dict:
    """Per call and output: "bitwise equal", or the count of elements that
    differ and the largest absolute difference."""
    res = {}
    for key in sorted(set(got) & set(want)):
        res[key] = []
        for a, b in zip(got[key], want[key]):
            if torch.equal(a, b):
                res[key].append("bitwise equal")
            else:
                diff = (a.double() - b.double()).abs()
                res[key].append({"differ": int((a != b).sum()),
                                 "of": a.numel(),
                                 "max_abs_diff": float(diff.max())})
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--label", default="")
    ap.add_argument("--ids", default=None,
                    help="the training step's ids (default: the file "
                         "chip_smoke.py saves)")
    ap.add_argument("--save", default=None)
    ap.add_argument("--against", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("head_kernel_times: torch sees no CUDA device")
    # the port under test comes from PYTHONPATH; import it before
    # chip_smoke, which puts this checkout's src first on the path
    from repro_torch.kernels.midx_probs import cuda as midx_cuda
    from repro_torch.kernels.midx_probs.ref import midx_probs_ref
    from repro_torch.kernels.rff_sample import cuda as rff_cuda
    from repro_torch.kernels.rff_sample.ref import rff_gumbel_ref
    from repro_torch.kernels.sampled_ce import cuda as sce_cuda
    from repro_torch.kernels.sampled_ce.ref import (sampled_ce_fwd_ref,
                                                    sampled_ce_pt_bwd_ref)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as smoke

    torch.backends.cuda.matmul.allow_tf32 = False    # as the smoke's phase 3
    torch.backends.cudnn.allow_tf32 = False
    buf = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")
    out = {"label": args.label, "card": smoke.card_line(),
           "port": os.path.dirname(midx_cuda.__file__)}

    def read(kern, plain, plain_reps: int = 50) -> dict:
        """plain_reps: timed calls of the plain version (fewer where it
        takes tens of ms)."""
        got = {}
        for name, fn, reps in (("kernel", kern, 50),
                               ("plain", plain, plain_reps)):
            host, card = issue_us(fn, min(args.calls, 4 * reps))
            got[name] = {"smoke_ms": smoke.time_ms(fn, buf, reps=reps),
                         "device_ms": device_ms(fn, buf, smoke.flush_l2,
                                                reps=reps),
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
    outputs = {}
    out["rff_sample"] = {}
    for name, (t, n, r2, m) in smoke.RFF_SHAPES.items():
        pz, pc, seeds, t_ids = smoke.rff_inputs(t, n, r2, "rows", seed=1)
        out["rff_sample"][name] = read(
            lambda: rff_cuda.rff_sample_cuda(pz, pc, seeds, t_ids, m),
            lambda: rff_gumbel_ref(pz, pc, seeds, t_ids, m), plain_reps=5)
        outputs[f"rff_sample {name}"] = rff_cuda.rff_sample_cuda(
            pz, pc, seeds, t_ids, m)
    out["sampled_ce_pt_bwd"] = {}
    shapes = [(name, shape, hot, None)
              for name, shape, hot in smoke.SCE_PT_TIMED]
    ids_path = args.ids or smoke.TRAIN_IDS
    if os.path.exists(ids_path):
        ids = torch.load(ids_path)
        shapes.append(("paper-lm train step ids", (
            ids["pos_ids"].numel(), ids["d"], ids["neg_ids"].shape[1],
            ids["v"], torch.float32), False, ids))
    else:
        out["sampled_ce_pt_bwd"]["paper-lm train step ids"] = (
            f"not measured: {ids_path} is missing (chip_smoke.py writes "
            "it)")
    for name, (t, d, m, v, dtype), hot, ids in shapes:
        h, tab, lq, neg, pos, g = smoke.sce_inputs(t, d, m, v, dtype,
                                                   seed=1, hot_row=hot)
        if ids is not None:
            neg, pos = ids["neg_ids"].cuda(), ids["pos_ids"].cuda()
        _, lse = sce_cuda.sampled_ce_pt_cuda(h, tab, lq, neg, pos)

        def bwd():
            return sce_cuda.sampled_ce_pt_bwd_cuda(g, h, tab, lq, neg, pos,
                                                   lse)
        out["sampled_ce_pt_bwd"][name] = {
            "longest_segment": smoke.longest_segment(neg, pos, v),
            **read(bwd, lambda: sampled_ce_pt_bwd_ref(g, h, tab, lq, neg,
                                                      pos, lse),
                   plain_reps=20),
            "kernels_us": kernels_us(bwd)}
        outputs[f"sampled_ce_pt_bwd {name}"] = bwd()
        del h, tab, lq, neg, pos, g, lse
    outputs = {k: [x.cpu() for x in v] for k, v in outputs.items()}
    if args.save:
        torch.save(outputs, args.save)
    if args.against:
        out["against"] = {"file": args.against, **compare(
            outputs, torch.load(args.against))}
    x = torch.randn((4, 2048), device="cuda")
    sink = torch.empty_like(x)
    out["torch.add host_us"] = issue_us(
        lambda: torch.add(x, 1.0, out=sink), args.calls)[0]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
