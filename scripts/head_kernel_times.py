"""Host and card time of the port's `midx_probs`, shared-negative
sampled-CE forward, RFF sampler and per-token sampled-CE forward and
backward calls, and of their plain versions, on one CUDA card.

At the shapes at which `chip_smoke.py` times these functions (the seven
`midx_probs` shapes, the four `SHARED_TRAIN` shapes, the three
`RFF_SHAPES`, the per-token CE's `SCE_PT_TIMED` shapes), on the smoke's
own inputs, and for the per-token forward and backward also at the ids of
one step of the smoke's paper-lm training run (`chip_smoke.TRAIN_IDS`,
which the smoke writes; "not measured" without it), it reads each call
and its plain version three ways:

- `smoke_ms`: `chip_smoke.time_ms`, the smoke's timer: the median of 50
  calls, each after a 128 MB write that flushes the L2, CUDA events
  recorded around the call. Where the host takes longer to issue the call
  than the card takes to flush, the host's issue is in the figure;
- `device_ms`: the same, with the card held in a ~0.5 ms spin
  (`torch.cuda._sleep`) before the start event, so the host has issued the
  whole call before the card reaches it: the card's time alone;
- `host_us` and `card_us`: the host's time to issue one call, and the
  card's time per call, over `--calls` calls issued back to back;
- for the per-token forward and backward also `kernels_us`: each CUDA
  kernel's (and memset's) device µs a call under `torch.profiler`, over
  20 calls.

A `torch.add` of a [4, 2048] fp32 tensor is the gauge of the host's speed
in the process. One JSON object per run on stdout. `--save PATH` keeps
the outputs of the `rff_sample` and per-token forward (loss, lse) and
backward calls (on the CPU); `--against PATH` compares this run's outputs
with a saved run's: bit for bit, or the count of differing elements and
the largest difference. `--only` reads some of the five functions, or
`quantized`: the quantized modes (int8 and fp8) of `midx_probs`, the
per-token CE forward and backward and the shared CE forward and backward,
at `chip_smoke.py`'s phase 3d shapes (`QMIDX_SHAPES`, `QSCE_PT_SHAPES`,
llama 4 x 256), on a port that has them.
`--host-against <checkout>/src` loads that checkout's per-token forward
wrapper beside this one and times the host's issue of the two in turns
in this one process (`host_ab`: rounds of back-to-back calls, this tree
then the other), so that the process's own speed, which moves between
processes, is the same for both.

    PYTHONPATH=src python3 scripts/head_kernel_times.py
    PYTHONPATH=src python3 scripts/head_kernel_times.py --only sampled_ce_pt
    PYTHONPATH=src python3 scripts/head_kernel_times.py --only sampled_ce_pt \
        --host-against <older checkout>/src

It calls only entry points that every version of the port since these
kernels were ported has (the quantized modes: since they were; an older
port reads them as "not measured"), so the same file measures an older
checkout:
`PYTHONPATH=<checkout>/src python3 scripts/head_kernel_times.py`.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
import time

import torch

SPIN_CYCLES = 1_000_000        # ~0.5 ms of the card's clock
FUNCTIONS = ("midx_probs", "sampled_ce", "rff_sample", "sampled_ce_pt",
             "sampled_ce_pt_bwd", "quantized")


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


def load_other_wrapper(src: str):
    """Another checkout's `kernels/sampled_ce/cuda.py`, as a module of its
    own; its kernels build from that checkout's source."""
    path = os.path.join(src, "repro_torch", "kernels", "sampled_ce",
                        "cuda.py")
    spec = importlib.util.spec_from_file_location("other_sce_cuda", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_ab(this, other, args, rounds: int = 9, calls: int = 500) -> dict:
    """Host µs to issue one per-token forward call through this tree's
    wrapper and the other's, in turns, `rounds` times each: the medians
    and every round."""
    got = {"this": [], "other": []}
    for _ in range(rounds):
        for name, mod in (("this", this), ("other", other)):
            got[name].append(issue_us(
                lambda: mod.sampled_ce_pt_cuda(*args), calls)[0])
    return {**{f"{k}_median_us": statistics.median(v)
               for k, v in got.items()}, "rounds_us": got}


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
    ap.add_argument("--only", nargs="+", choices=FUNCTIONS, default=FUNCTIONS,
                    help="the functions to read (default: all)")
    ap.add_argument("--host-against", default=None,
                    help="another checkout's src: time the host's issue of "
                         "its per-token forward and this one's in turns")
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
                                                    sampled_ce_pt_bwd_ref,
                                                    sampled_ce_pt_fwd_ref)
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

    outputs = {}
    if "midx_probs" in args.only:
        read_midx_probs(out, read, smoke, midx_cuda, midx_probs_ref)
    if "sampled_ce" in args.only:
        out["sampled_ce"] = {}
        for name, ((b, s, m, d), v) in smoke.SHARED_TRAIN.items():
            h, pe, ne, lq, neg, pos, _ = smoke.shared_inputs(
                b, s, m, d, v, torch.float32, seed=1)
            out["sampled_ce"][name] = read(
                lambda: sce_cuda.sampled_ce_cuda(h, pe, ne, lq, neg, pos),
                lambda: sampled_ce_fwd_ref(h, pe, ne, lq, neg, pos))
            del h, pe, ne, lq, neg, pos
    if "rff_sample" in args.only:
        out["rff_sample"] = {}
        for name, (t, n, r2, m) in smoke.RFF_SHAPES.items():
            pz, pc, seeds, t_ids = smoke.rff_inputs(t, n, r2, "rows", seed=1)
            out["rff_sample"][name] = read(
                lambda: rff_cuda.rff_sample_cuda(pz, pc, seeds, t_ids, m),
                lambda: rff_gumbel_ref(pz, pc, seeds, t_ids, m),
                plain_reps=5)
            outputs[f"rff_sample {name}"] = rff_cuda.rff_sample_cuda(
                pz, pc, seeds, t_ids, m)
    shapes = [(name, shape, hot, None)
              for name, shape, hot in smoke.SCE_PT_TIMED]
    ids_path = args.ids or smoke.TRAIN_IDS
    step = "paper-lm train step ids"
    if os.path.exists(ids_path):
        ids = torch.load(ids_path)
        shapes.append((step, (
            ids["pos_ids"].numel(), ids["d"], ids["neg_ids"].shape[1],
            ids["v"], torch.float32), False, ids))
    for fn in ("sampled_ce_pt", "sampled_ce_pt_bwd"):
        if fn not in args.only:
            continue
        out[fn] = {}
        if not os.path.exists(ids_path):
            out[fn][step] = (f"not measured: {ids_path} is missing "
                             "(chip_smoke.py writes it)")
        for name, (t, d, m, v, dtype), hot, ids in shapes:
            h, tab, lq, neg, pos, g = smoke.sce_inputs(t, d, m, v, dtype,
                                                       seed=1, hot_row=hot)
            if ids is not None:
                neg, pos = ids["neg_ids"].cuda(), ids["pos_ids"].cuda()
            _, lse = sce_cuda.sampled_ce_pt_cuda(h, tab, lq, neg, pos)
            if fn == "sampled_ce_pt":
                def kern():
                    return sce_cuda.sampled_ce_pt_cuda(h, tab, lq, neg, pos)

                def plain():
                    return sampled_ce_pt_fwd_ref(h, tab, lq, neg, pos)
            else:
                def kern():
                    return sce_cuda.sampled_ce_pt_bwd_cuda(g, h, tab, lq,
                                                           neg, pos, lse)

                def plain():
                    return sampled_ce_pt_bwd_ref(g, h, tab, lq, neg, pos,
                                                 lse)
            out[fn][name] = {
                "longest_segment": smoke.longest_segment(neg, pos, v),
                **read(kern, plain, plain_reps=20),
                "kernels_us": kernels_us(kern)}
            outputs[f"{fn} {name}"] = kern()
            del h, tab, lq, neg, pos, g, lse
    if "quantized" in args.only:
        read_quantized(out, read, smoke, midx_cuda, midx_probs_ref, sce_cuda)
    if args.host_against:
        other = load_other_wrapper(args.host_against)
        out["sampled_ce_pt host_ab"] = {"other": args.host_against}
        for name, (t, d, m, v, dtype), hot in smoke.SCE_PT_TIMED:
            h, tab, lq, neg, pos, _ = smoke.sce_inputs(t, d, m, v, dtype,
                                                       seed=1, hot_row=hot)
            out["sampled_ce_pt host_ab"][name] = host_ab(
                sce_cuda, other, (h, tab, lq, neg, pos))
            del h, tab, lq, neg, pos
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


def read_midx_probs(out: dict, read, smoke, midx_cuda, midx_probs_ref):
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


def read_quantized(out: dict, read, smoke, midx_cuda, midx_probs_ref,
                   sce_cuda):
    """The quantized modes at the smoke's phase 3d shapes, int8 and fp8."""
    try:
        from repro_torch.index.quantized import quantize_rows
    except ImportError:
        out["quantized"] = "not measured: this port has no quantized modes"
        return
    from repro_torch.kernels.sampled_ce.ref import (sampled_ce_bwd_ref,
                                                    sampled_ce_fwd_ref,
                                                    sampled_ce_pt_bwd_ref,
                                                    sampled_ce_pt_fwd_ref)
    got = out["quantized"] = {}
    for fmt in smoke.QFMTS:
        for name, (t, d, k, split) in smoke.QMIDX_SHAPES:
            z, cb1, cb2, counts = smoke.midx_inputs(t, d, k, split, seed=1)
            (q1, s1), (q2, s2) = quantize_rows(cb1, fmt), quantize_rows(
                cb2, fmt)
            kw = dict(split=split, scale1=s1.reshape(-1),
                      scale2=s2.reshape(-1))
            got[f"midx_probs[{fmt}] {name}"] = read(
                lambda: midx_cuda.midx_probs_cuda(z, q1, q2, counts, **kw),
                lambda: midx_probs_ref(z, q1, q2, counts, **kw))
        for name, (t, d, m, v), hot in smoke.QSCE_PT_SHAPES:
            h, tab, lq, neg, pos, g = smoke.sce_inputs(
                t, d, m, v, torch.float32, seed=1, hot_row=hot)
            q, sc = quantize_rows(tab, fmt)
            del tab
            args = (h, q, lq, neg, pos)
            _, lse = sce_cuda.sampled_ce_pt_cuda(*args, scale=sc)
            got[f"sampled_ce_pt[{fmt}] {name}"] = read(
                lambda: sce_cuda.sampled_ce_pt_cuda(*args, scale=sc),
                lambda: sampled_ce_pt_fwd_ref(*args, scale=sc),
                plain_reps=20)
            got[f"sampled_ce_pt_bwd[{fmt}] {name}"] = read(
                lambda: sce_cuda.sampled_ce_pt_bwd_cuda(g, *args, lse,
                                                        scale=sc),
                lambda: sampled_ce_pt_bwd_ref(g, *args, lse, scale=sc),
                plain_reps=20)
            del h, q, sc, lq, neg, pos, g, lse, args
        b, s_, m, d = smoke.SHAPE
        h, pe, ne, lq, neg, pos, g = smoke.shared_inputs(
            b, s_, m, d, 128256, torch.float32, seed=1)
        (pq, ps), (nq, ns) = (quantize_rows(x.reshape(-1, d), fmt)
                              for x in (pe, ne))
        args = (h, pq.reshape(pe.shape), nq.reshape(ne.shape), lq, neg, pos)
        kw = dict(pos_scale=ps.reshape(b, s_, 1),
                  neg_scale=ns.reshape(b, m, 1))
        _, lse = sce_cuda.sampled_ce_cuda(*args, **kw)
        got[f"sampled_ce[{fmt}] llama3.2-1b train"] = read(
            lambda: sce_cuda.sampled_ce_cuda(*args, **kw),
            lambda: sampled_ce_fwd_ref(*args, **kw))
        got[f"sampled_ce_bwd[{fmt}] llama3.2-1b train"] = read(
            lambda: sce_cuda.sampled_ce_bwd_cuda(g, *args, lse, **kw),
            lambda: sampled_ce_bwd_ref(g, *args, lse, **kw))
        del h, pe, ne, pq, nq, lq, neg, pos, g, lse, args


if __name__ == "__main__":
    main()
