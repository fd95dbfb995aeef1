"""Load and launch the hand-written CUDA RFF Gumbel-top-m sampler.

The kernel (`csrc/rff_sample.cu`) replaces the JAX package's TPU kernel
`kernels/rff_sample/rff_sample.py::_kernel`; its header says what bounds it
on the card and why it runs as two kernels (per-chunk partials, then an
ordered merge) over one workspace. It has a plain C interface and is built by
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

_P, _I = ctypes.c_void_p, ctypes.c_int


def _declare(lib: ctypes.CDLL) -> None:
    lib.rff_sample_launch.argtypes = [_P] * 7 + [_I] * 4 + [_P]
    lib.rff_sample_launch.restype = ctypes.c_int
    lib.rff_sample_max_r2.argtypes = []
    lib.rff_sample_max_r2.restype = ctypes.c_int
    lib.rff_sample_workspace_bytes.argtypes = [_I] * 3
    lib.rff_sample_workspace_bytes.restype = ctypes.c_longlong
    lib.max_r2 = lib.rff_sample_max_r2()      # read once, not per call


LIBRARY = KernelLibrary(
    "rff_sample", Path(__file__).resolve().parent / "csrc" / "rff_sample.cu",
    _declare)
load = LIBRARY.load


def rff_sample_cuda(phi_z: torch.Tensor, phi_c: torch.Tensor,
                    seeds: torch.Tensor, t_ids: torch.Tensor, m: int):
    """Launch the sampler: phi_z [T, R2] and phi_c [N, R2] fp32, seeds and
    t_ids [T] int64, all contiguous on one CUDA device -> (ids [T, m]
    int32, log_q [T, m] fp32). Raises on anything the kernel does not take,
    and when a launch reports an error. Adds one to
    `rff_sample_cuda.launches` per call that launches."""
    tensors = (phi_z, phi_c, seeds, t_ids)
    if not all(x.is_cuda and x.device == phi_z.device for x in tensors):
        raise ValueError("rff_sample_cuda: every operand must be on phi_z's "
                         "CUDA device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("rff_sample_cuda: operands must be contiguous")
    if phi_z.dtype != torch.float32 or phi_c.dtype != torch.float32:
        raise ValueError("rff_sample_cuda: phi_z and phi_c must be fp32")
    if seeds.dtype != torch.int64 or t_ids.dtype != torch.int64:
        raise ValueError("rff_sample_cuda: seeds and t_ids must be int64")
    if phi_z.dim() != 2 or phi_c.dim() != 2 \
            or phi_z.shape[1] != phi_c.shape[1] \
            or tuple(seeds.shape) != (phi_z.shape[0],) \
            or tuple(t_ids.shape) != (phi_z.shape[0],):
        raise ValueError(f"rff_sample_cuda: bad shapes phi_z"
                         f"{tuple(phi_z.shape)} phi_c{tuple(phi_c.shape)} "
                         f"seeds{tuple(seeds.shape)} "
                         f"t_ids{tuple(t_ids.shape)}")
    t, r2 = phi_z.shape
    n = phi_c.shape[0]
    lib = load()
    if not 1 <= r2 <= lib.max_r2:
        raise ValueError(f"rff_sample_cuda supports 1 <= R2 <= "
                         f"{lib.max_r2}, got {r2}")
    # the partials and the row sums, carved by the C call from one block
    # whose size it states (-1: sizes past its grids)
    nbytes = lib.rff_sample_workspace_bytes(t, n, m)
    if nbytes < 0:
        raise ValueError(f"rff_sample_cuda: unsupported sizes T={t} N={n} "
                         f"m={m}")
    dev = phi_z.device
    ids = torch.empty((t, m), dtype=torch.int32, device=dev)
    log_q = torch.empty((t, m), dtype=torch.float32, device=dev)
    if t == 0 or m == 0:
        return ids, log_q
    work = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rff_sample_launch(
            phi_z.data_ptr(), phi_c.data_ptr(), seeds.data_ptr(),
            t_ids.data_ptr(), ids.data_ptr(), log_q.data_ptr(),
            work.data_ptr(), t, n, r2, m, stream)
    if err != 0:
        raise RuntimeError(f"rff_sample kernel launch failed: cudaError {err}")
    rff_sample_cuda.launches += 1
    return ids, log_q


rff_sample_cuda.launches = 0
