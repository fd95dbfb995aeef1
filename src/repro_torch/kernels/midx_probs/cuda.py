"""Load and launch the hand-written CUDA `midx_probs` kernel.

The kernel (`csrc/midx_probs.cu`) replaces the JAX package's TPU kernel
`kernels/midx_probs/midx_probs.py::_kernel`; its header says what bounds it
on the card and how the design answers that: two launches, partial scores
per fixed slice of the codewords' columns, then a finish that sums them in
ascending slice order. Its quantized mode (the TPU kernel's `quantized`
branch) takes int8 or fp8-e4m3 codebooks, converted to fp32 in registers,
and [K] fp32 scales applied after the slices' sum. It has a plain C
interface and is built by
`kernels/build.py` (nvcc for sm_90a at first use, into `build/kernels/`)
and loaded with `ctypes`.

Nothing here runs at import time: the CPU test suite imports this module
on a machine without nvcc or a card.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import KernelLibrary


def _declare(lib: ctypes.CDLL) -> None:
    lib.midx_probs_launch.argtypes = [ctypes.c_void_p] * 11 + \
        [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.midx_probs_launch.restype = ctypes.c_int
    lib.midx_probs_max_k.argtypes = []
    lib.midx_probs_max_k.restype = ctypes.c_int
    lib.midx_probs_slices.argtypes = [ctypes.c_int] * 2
    lib.midx_probs_slices.restype = ctypes.c_int


LIBRARY = KernelLibrary(
    "midx_probs", Path(__file__).resolve().parent / "csrc" / "midx_probs.cu",
    _declare)
load = LIBRARY.load


# codebook dtypes the kernel takes -> its `cb_kind`
_CB_KIND = {torch.float32: 0, torch.int8: 1, torch.float8_e4m3fn: 2}


def midx_probs_cuda(z: torch.Tensor, cb1: torch.Tensor, cb2: torch.Tensor,
                    counts: torch.Tensor, *, split: bool,
                    scale1: torch.Tensor | None = None,
                    scale2: torch.Tensor | None = None):
    """Launch the kernel: z [T, D] and counts [K, K] fp32, cb1/cb2 [K, Dc]
    fp32 — or, in the quantized mode, both int8 or both fp8-e4m3 with
    scale1/scale2 [K] fp32 — contiguous, on one CUDA device -> (s1, s2,
    log_psi [T, K], lse [T]). Raises on anything the kernel does not take,
    and when the launch reports an error. Adds one to
    `midx_probs_cuda.launches` per call (its two kernels, the partials and
    the finish, launch together), and, in the quantized mode, to
    `quant_launches[fmt]`."""
    quant = scale1 is not None
    if quant != (scale2 is not None):
        raise ValueError("midx_probs_cuda: give both scales or neither")
    scales = (scale1, scale2) if quant else ()
    tensors = (z, cb1, cb2, counts, *scales)
    if not all(t.is_cuda and t.device == z.device for t in tensors):
        raise ValueError("midx_probs_cuda: every operand must be on z's "
                         "CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("midx_probs_cuda: operands must be contiguous")
    if not all(t.dtype == torch.float32 for t in (z, counts, *scales)):
        raise ValueError("midx_probs_cuda: z, counts and the scales must be "
                         "fp32")
    kind = _CB_KIND.get(cb1.dtype)
    if kind is None or cb2.dtype != cb1.dtype or (kind > 0) != quant:
        raise ValueError(f"midx_probs_cuda: codebooks must be both fp32, or "
                         f"both int8 / fp8-e4m3 with scales; got "
                         f"{cb1.dtype}, {cb2.dtype}, scales={quant}")
    t, d = z.shape
    k, dc = cb1.shape
    if split and d % 2:
        raise ValueError(f"PQ split needs an even D, got {d}")
    want_dc = d // 2 if split else d
    if (tuple(cb2.shape) != (k, dc) or dc != want_dc
            or tuple(counts.shape) != (k, k)
            or any(tuple(x.shape) != (k,) for x in scales)):
        raise ValueError(f"midx_probs_cuda: bad shapes z{tuple(z.shape)} "
                         f"cb1{tuple(cb1.shape)} cb2{tuple(cb2.shape)} "
                         f"counts{tuple(counts.shape)} split={split}")
    lib = load()
    if k > lib.midx_probs_max_k():
        raise ValueError(f"midx_probs_cuda supports K <= "
                         f"{lib.midx_probs_max_k()}, got {k}")
    s1 = torch.empty((t, k), dtype=torch.float32, device=z.device)
    s2 = torch.empty_like(s1)
    lpsi = torch.empty_like(s1)
    lse = torch.empty((t,), dtype=torch.float32, device=z.device)
    if t == 0:
        return s1, s2, lpsi, lse
    # the partial scores [slices, T, 2K]; the kernel decides the slices
    part = torch.empty((lib.midx_probs_slices(d, int(split)), t, 2 * k),
                       dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.midx_probs_launch(
            z.data_ptr(), cb1.data_ptr(), cb2.data_ptr(), counts.data_ptr(),
            scale1.data_ptr() if quant else None,
            scale2.data_ptr() if quant else None,
            s1.data_ptr(), s2.data_ptr(), lpsi.data_ptr(), lse.data_ptr(),
            part.data_ptr(), t, d, k, int(split), kind, stream)
    if err != 0:
        raise RuntimeError(f"midx_probs kernel launch failed: cudaError {err}")
    midx_probs_cuda.launches += 1
    if quant:
        midx_probs_cuda.quant_launches[
            "int8" if cb1.dtype == torch.int8 else "fp8"] += 1
    return s1, s2, lpsi, lse


midx_probs_cuda.launches = 0
midx_probs_cuda.quant_launches = {"int8": 0, "fp8": 0}
