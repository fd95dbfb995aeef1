"""Load and launch the hand-written CUDA chunked SSD scan.

The kernels (`csrc/ssd_scan.cu`) replace the JAX package's TPU kernel
`kernels/ssd_scan/ssd_scan.py::_kernel` (:24, its `pallas_call` at :74);
the source's header says what bounds the function on the card, how its
four kernels (C·B and cum per (b, chunk); the chunk states; the carry;
y per query tile) split it, and how they mask. It includes
`kernels/common/tf32x3.cuh` (3xTF32 tensor-core products), has a plain C
interface and is built by `kernels/build.py` (nvcc for sm_90a at first
use, into `build/kernels/`) and loaded with `ctypes`.

Nothing here runs at import time: the CPU test suite imports this module
on a machine without nvcc or a card.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import KernelLibrary

_P, _I = ctypes.c_void_p, ctypes.c_int


def _declare(lib: ctypes.CDLL) -> None:
    lib.ssd_scan_fwd.argtypes = [_P] * 10 + [_I] * 7 + [_P]
    for fn in (lib.ssd_scan_fwd, lib.ssd_scan_max_n, lib.ssd_scan_max_p):
        fn.restype = ctypes.c_int
    lib.ssd_scan_max_n.argtypes = []
    lib.ssd_scan_max_p.argtypes = []


LIBRARY = KernelLibrary(
    "ssd_scan", Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu",
    _declare)
_TILE = 64              # the kernels' query / key tile; C·B is padded to it
_STATE_WIDTH = 64       # the chunk-state workspace's row width (P <= 64)
load = LIBRARY.load


@functools.cache
def _limits() -> tuple:
    """(largest N, largest P) the kernels take, read once from the library."""
    lib = load()
    return lib.ssd_scan_max_n(), lib.ssd_scan_max_p()


def ssd_scan_cuda(x: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                  adt: torch.Tensor, dt: torch.Tensor, *, chunk: int):
    """Launch the scan: x [Bt,S,H,P], bmat / cmat [Bt,S,N], adt / dt
    [Bt,S,H], all fp32, contiguous, on one CUDA device, P <= 64, N <= 128,
    S a multiple of `chunk` >= 1 -> (y [Bt,S,H,P], h_last [Bt,H,N,P]),
    fp32. Raises on anything the kernel does not take, and when a launch
    reports an error. Adds one to `ssd_scan_cuda.launches` per call that
    launches (each call launches four kernels)."""
    tensors = (x, bmat, cmat, adt, dt)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("ssd_scan_cuda: x, bmat, cmat, adt and dt must be "
                         "on one CUDA device")
    if not all(t.dtype == torch.float32 for t in tensors):
        raise ValueError(f"ssd_scan_cuda takes fp32 only, got "
                         f"{[str(t.dtype) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_scan_cuda: inputs must be contiguous")
    if x.dim() != 4 or bmat.dim() != 3 or cmat.shape != bmat.shape \
            or bmat.shape[:2] != x.shape[:2] or adt.shape != x.shape[:3] \
            or dt.shape != adt.shape:
        raise ValueError(f"ssd_scan_cuda: bad shapes x{tuple(x.shape)} "
                         f"bmat{tuple(bmat.shape)} cmat{tuple(cmat.shape)} "
                         f"adt{tuple(adt.shape)} dt{tuple(dt.shape)}")
    bt, s, nh, p = x.shape
    n = bmat.shape[2]
    if chunk < 1 or s % chunk:
        raise ValueError(f"ssd_scan_cuda needs S % chunk == 0, got S={s} "
                         f"chunk={chunk}")
    lib = load()
    max_n, max_p = _limits()
    if not (1 <= n <= max_n and 1 <= p <= max_p):
        raise ValueError(f"ssd_scan_cuda supports N <= {max_n} and P <= "
                         f"{max_p}, got N={n} P={p}")
    nc, nt = s // chunk, -(-chunk // _TILE)
    if bt * nc > 65535 or nh > 65535 or bt * nh * nc * n * _STATE_WIDTH \
            >= 2**31 or nt * (nt + 1) // 2 >= 2**31 - 1:
        raise ValueError(f"ssd_scan_cuda: unsupported sizes Bt={bt} S={s} "
                         f"H={nh} chunk={chunk}")
    y = torch.empty_like(x)
    if bt * nh == 0 or s == 0:
        return y, torch.zeros((bt, nh, n, p), dtype=torch.float32,
                              device=x.device)
    h_last = torch.empty((bt, nh, n, p), dtype=torch.float32,
                         device=x.device)
    # workspaces in one allocation: cum [Bt,H,S] (padded to 64 floats, so
    # the rest stays 256-byte aligned), C·B [Bt,nc,Qp,Qp], chunk states
    # [Bt,H,nc,N,64]
    n_cum = -(-bt * nh * s // 64) * 64
    n_cb = bt * nc * (nt * _TILE) ** 2
    work = torch.empty(n_cum + n_cb + bt * nh * nc * n * _STATE_WIDTH,
                       dtype=torch.float32, device=x.device)
    cum = work.data_ptr()
    cbw, states = cum + 4 * n_cum, cum + 4 * (n_cum + n_cb)
    vec = int(p % 4 == 0 and n % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x, bmat, cmat)))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_scan_fwd(
            x.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), adt.data_ptr(),
            dt.data_ptr(), y.data_ptr(), h_last.data_ptr(), cum, cbw, states,
            bt, s, nh, p, n, chunk, vec, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err}")
    ssd_scan_cuda.launches += 1
    return y, h_last


ssd_scan_cuda.launches = 0
