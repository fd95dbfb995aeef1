"""Build, load and launch the hand-written CUDA `midx_probs` kernel.

The kernel (`csrc/midx_probs.cu`) replaces the JAX package's TPU kernel
`kernels/midx_probs/midx_probs.py::_kernel`; its header says what bounds it
on the card and how the design answers that. It has a plain C interface:
`nvcc` compiles it for sm_90a into a shared library at first use, from the
source in the checkout, into `build/kernels/` at the repository root (listed
in .gitignore), and `ctypes` loads it. The library's file name carries a
hash of the source and flags, so an edited source is rebuilt.

Nothing here runs at import time: the CPU test suite imports this module
on a machine without nvcc or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_SRC = Path(__file__).resolve().parent / "csrc" / "midx_probs.cu"
#: <repo>/build/kernels — four levels above this file's package directory.
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lib = None
#: What the last build printed (ptxas: registers, shared memory, spills).
build_log = ""
#: Seconds the last build took (0.0 when the library was already built).
build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the midx_probs "
                           "CUDA kernel cannot be built")
    return path


def library_path() -> Path:
    tag = hashlib.sha256(_SRC.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libmidx_probs_{tag}.so"


def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib, build_log, build_seconds
    if _lib is not None:
        return _lib
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(_SRC)], capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {_SRC.name}:\n"
                               f"{build_log}")
        os.replace(tmp, out)          # atomic: concurrent builds agree
    lib = ctypes.CDLL(str(out))
    lib.midx_probs_launch.argtypes = [ctypes.c_void_p] * 8 + \
        [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.midx_probs_launch.restype = ctypes.c_int
    lib.midx_probs_max_k.argtypes = []
    lib.midx_probs_max_k.restype = ctypes.c_int
    _lib = lib
    return lib


def midx_probs_cuda(z: torch.Tensor, cb1: torch.Tensor, cb2: torch.Tensor,
                    counts: torch.Tensor, *, split: bool):
    """Launch the kernel: z [T, D], cb1/cb2 [K, Dc], counts [K, K], all
    fp32, contiguous, on one CUDA device -> (s1, s2, log_psi [T, K],
    lse [T]). Raises on anything the kernel does not take, and when the
    launch reports an error. Adds one to `midx_probs_cuda.launches` per
    launch."""
    tensors = (z, cb1, cb2, counts)
    if not all(t.is_cuda and t.device == z.device for t in tensors):
        raise ValueError("midx_probs_cuda: every operand must be on z's "
                         "CUDA device")
    if not all(t.dtype == torch.float32 and t.is_contiguous()
               for t in tensors):
        raise ValueError("midx_probs_cuda: operands must be contiguous fp32")
    t, d = z.shape
    k, dc = cb1.shape
    if split and d % 2:
        raise ValueError(f"PQ split needs an even D, got {d}")
    want_dc = d // 2 if split else d
    if (tuple(cb2.shape) != (k, dc) or dc != want_dc
            or tuple(counts.shape) != (k, k)):
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
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.midx_probs_launch(
            z.data_ptr(), cb1.data_ptr(), cb2.data_ptr(), counts.data_ptr(),
            s1.data_ptr(), s2.data_ptr(), lpsi.data_ptr(), lse.data_ptr(),
            t, d, k, int(split), stream)
    if err != 0:
        raise RuntimeError(f"midx_probs kernel launch failed: cudaError {err}")
    midx_probs_cuda.launches += 1
    return s1, s2, lpsi, lse


midx_probs_cuda.launches = 0
