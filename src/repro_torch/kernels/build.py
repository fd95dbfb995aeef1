"""Build and load the port's hand-written CUDA kernels.

Every kernel library has a plain C interface: `nvcc` compiles its one
source for sm_90a into a shared library at first use, from the checkout,
into `build/kernels/` at the repository root (listed in .gitignore), and
`ctypes` loads it. The library's file name carries a hash of the source,
the headers it includes by quoted relative paths (`#include "..."`) and
the flags, so an edited source or shared header is rebuilt; the build
writes a temporary file and renames it, so concurrent builds agree.

Nothing here runs at import time: the CPU test suite imports the kernel
modules on a machine without nvcc or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

#: <repo>/build/kernels — three levels above this file's package directory.
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
_QUOTED_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def local_files(source: Path) -> list:
    """`source` and the files it includes by quoted paths relative to
    itself (`#include "../../common/tf32x3.cuh"`)."""
    return [source, *(source.parent / inc for inc in
                      _QUOTED_INCLUDE.findall(source.read_text()))]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA "
                           "kernels cannot be built")
    return path


class KernelLibrary:
    """One `csrc/*.cu` source, built once per hash of the source, the
    headers it includes from the repository (`local_files`) and the flags,
    and loaded.

    `declare(lib)` sets the `argtypes`/`restype` of the library's C
    functions. After `load()`, `build_log` holds what nvcc printed (ptxas:
    registers, shared memory, spills) and `build_seconds` how long it took
    (0.0 when the library was already built)."""

    def __init__(self, name: str, source: Path, declare):
        self.name = name
        self.source = Path(source)
        self._declare = declare
        self._lib = None
        self._proc = None
        self._t0 = 0.0
        self.build_log = ""
        self.build_seconds = 0.0

    def library_path(self) -> Path:
        digest = hashlib.sha256()
        for path in local_files(self.source):
            digest.update(path.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        tag = digest.hexdigest()[:12]
        return BUILD_DIR / f"lib{self.name}_{tag}.so"

    def _tmp(self) -> Path:
        out = self.library_path()
        return out.with_name(f"{out.name}.{os.getpid()}.tmp")

    def start(self) -> None:
        """Start nvcc in the background unless the library exists; `load`
        waits for it. Lets a caller build several libraries at once."""
        if self._lib is not None or self._proc is not None \
                or self.library_path().exists():
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self._t0 = time.perf_counter()
        self._proc = subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(self._tmp()), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def load(self) -> ctypes.CDLL:
        """Build (once per source hash) and load the library."""
        if self._lib is not None:
            return self._lib
        out = self.library_path()
        if not out.exists():
            self.start()
        if self._proc is not None:
            log, _ = self._proc.communicate()
            self.build_seconds = time.perf_counter() - self._t0
            self.build_log = log
            rc, self._proc = self._proc.returncode, None
            if rc != 0:
                raise RuntimeError(f"nvcc failed to build {self.source.name}:"
                                   f"\n{log}")
            os.replace(self._tmp(), out)
        lib = ctypes.CDLL(str(out))
        self._declare(lib)
        self._lib = lib
        return lib
