"""The per-token sampled-CE forward's two ways of copying a row into shared
memory, timed against each other on one CUDA card, in one process.

`csrc/sampled_ce_pt.cu` copies a token's rows by TMA bulk copies where a
row is `BULK_ROW_BYTES` long or more, and by 16-byte `cp.async.ca` copies
(through L1) below. This script builds the source as it is and with the
choice forced each way (`cp.async` for every row; TMA for every row; and
`cp.async.cg`, which skips L1, for every row), plus, with `--against
<checkout>/src`, that checkout's source, each into a library of its own
under `build/routes/`. Then, in turns, it loads each library behind the
port's forward wrapper and reads the forward at five shapes (paper-lm,
paper-lm with one hot row, llama width in bf16, llama width with one hot
row, llama width with an fp32 table; `chip_smoke.sce_inputs`, seed 1):

- `device_ms`: `head_kernel_times.device_ms` (the card's time alone, cold
  L2), once a round;
- `kernel_us`: the CUDA kernels' device µs a call (torch.profiler, warm
  L2), once a round;
- `held`: loss and lse within 1e-4·max(1, |plain|) of the plain version;
- `bits_as_first`: loss and lse bit for bit those of the first library
  (`--against`'s, where given).

One JSON object on stdout.

    PYTHONPATH=src python3 scripts/sampled_ce_pt_routes.py \\
        --against <older checkout>/src
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join("repro_torch", "kernels", "sampled_ce", "csrc",
                      "sampled_ce_pt.cu")
CHOICE = "BULK_ROW_BYTES = 2048"
SHAPES = (                     # (name, (T, D, M, V, table dtype), hot row)
    ("paper-lm", (1024, 200, 20, 10000, torch.float32), False),
    ("paper-lm, one hot row", (1024, 200, 20, 10000, torch.float32), True),
    ("llama width", (1024, 2048, 64, 128256, torch.bfloat16), False),
    ("llama width, one hot row", (1024, 2048, 64, 128256, torch.bfloat16),
     True),
    ("llama width, fp32 table", (1024, 2048, 64, 128256, torch.float32),
     False))


def variants(src_dir: str, against: str | None) -> dict:
    """name -> CUDA source text."""
    text = open(os.path.join(src_dir, SOURCE)).read()
    if CHOICE not in text:
        sys.exit(f"sampled_ce_pt_routes: `{CHOICE}` not in the source")
    out = {}
    if against:
        out["against"] = open(os.path.join(against, SOURCE)).read()
    out["as built"] = text
    out["cp.async.ca every row"] = text.replace(CHOICE,
                                                "BULK_ROW_BYTES = 1 << 30")
    out["TMA every row"] = text.replace(CHOICE, "BULK_ROW_BYTES = 0")
    out["cp.async.cg every row"] = out["cp.async.ca every row"].replace(
        "cp.async.ca.shared.global [%0], [%1], 16;",
        "cp.async.cg.shared.global [%0], [%1], 16;")
    return out


def build_all(sources: dict, build, declare) -> dict:
    """Builds every variant at once (one nvcc each); name -> loaded lib."""
    out_dir = os.path.join(HERE, "build", "routes")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu = os.path.join(out_dir, f"v{i}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o",
             os.path.join(out_dir, f"v{i}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), i)
    libs = {}
    for name, (proc, i) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"sampled_ce_pt_routes: nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"v{i}.so"))
        declare(lib)
        libs[name] = lib
    return libs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", default=None,
                    help="another checkout's src, built and read first")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("sampled_ce_pt_routes: torch sees no CUDA device")
    from repro_torch.kernels import build
    from repro_torch.kernels.sampled_ce import cuda as sce
    from repro_torch.kernels.sampled_ce.ref import sampled_ce_pt_fwd_ref
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import chip_smoke as smoke
    import head_kernel_times as hkt

    src_dir = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(sce.__file__)))))
    libs = build_all(variants(src_dir, args.against), build, sce._declare)
    buf = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")
    inputs = {name: smoke.sce_inputs(t, d, m, v, dtype, seed=1, hot_row=hot)
              for name, (t, d, m, v, dtype), hot in SHAPES}
    first = next(iter(libs))
    got, res = {}, {}
    for rnd in range(args.rounds):
        for lib_name, lib in libs.items():
            sce.LIBRARY._lib = lib         # the wrapper launches this build
            for name, _, _ in SHAPES:
                h, tab, lq, neg, pos, _ = inputs[name]

                def fwd():
                    return sce.sampled_ce_pt_cuda(h, tab, lq, neg, pos)
                r = res.setdefault(lib_name, {}).setdefault(name, {})
                r.setdefault("device_ms", []).append(
                    hkt.device_ms(fwd, buf, smoke.flush_l2))
                r.setdefault("kernel_us", []).append(
                    sum(hkt.kernels_us(fwd).values()))
                if rnd == 0:
                    out = [x.clone() for x in fwd()]
                    got[lib_name, name] = out
                    want = sampled_ce_pt_fwd_ref(h, tab, lq, neg, pos)
                    r["held"] = all(bool(torch.all(
                        (a - b).abs() <= 1e-4 * b.abs().clamp(min=1)))
                        for a, b in zip(out, want))
                    r["bits_as_first"] = all(
                        torch.equal(a, b)
                        for a, b in zip(out, got[first, name]))
    print(json.dumps({"card": smoke.card_line(), "first": first,
                      "routes": res}))


if __name__ == "__main__":
    main()
