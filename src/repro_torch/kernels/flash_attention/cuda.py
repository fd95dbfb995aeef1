"""Load and launch the hand-written CUDA flash-attention forward.

The kernel (`csrc/flash_attention.cu`) replaces the JAX package's TPU
kernel `kernels/flash_attention/flash_attention.py::_kernel` (:25, its
`pallas_call` at :85); its header says what bounds it on the card and why
skipping masked kv blocks changes no bit. It has a plain C interface and
is built by `kernels/build.py` (nvcc for sm_90a at first use, into
`build/kernels/`) and loaded with `ctypes`.

Nothing here runs at import time: the CPU test suite imports this module
on a machine without nvcc or a card.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import KernelLibrary

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LIMIT = 2**30                 # |offsets, window| the kernel's int math takes


def _declare(lib: ctypes.CDLL) -> None:
    lib.flash_attention_fwd.argtypes = ([_P] * 5 + [_I] * 6 + [_F]
                                        + [_I] * 5 + [_P])
    for fn in (lib.flash_attention_fwd, lib.flash_attention_block,
               lib.flash_attention_max_hd):
        fn.restype = ctypes.c_int
    lib.flash_attention_block.argtypes = []
    lib.flash_attention_max_hd.argtypes = []


LIBRARY = KernelLibrary(
    "flash_attention",
    Path(__file__).resolve().parent / "csrc" / "flash_attention.cu", _declare)
load = LIBRARY.load


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: int | None,
                         q_offset: int):
    """Launch the forward: q [B, Sq, H, hd], k / v [B, Sk, KV, hd], fp32 or
    bf16 alike, contiguous on one CUDA device, H a multiple of KV, hd <=
    128, Sq and Sk multiples of 128 -> (out like q, lse [B, KV, H / KV, Sq]
    fp32). The kernel walks its own kv blocks: the reference's chunk
    sizes do not enter. Raises on anything the kernel does not take, and
    when a launch reports an error. Adds one to
    `flash_attention_cuda.launches` per call that launches."""
    tensors = (q, k, v)
    if not all(x.is_cuda and x.device == q.device for x in tensors):
        raise ValueError("flash_attention_cuda: q, k and v must be on one "
                         "CUDA device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("flash_attention_cuda: q, k and v must be "
                         "contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_cuda: q, k and v must be all fp32 "
                         f"or all bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention_cuda: bad shapes q"
                         f"{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    lib = load()
    block, max_hd = lib.flash_attention_block(), lib.flash_attention_max_hd()
    if not 1 <= hd <= max_hd:
        raise ValueError(f"flash_attention_cuda supports 1 <= hd <= {max_hd}, "
                         f"got {hd}")
    if sq % block or sk % block or sk == 0:
        raise ValueError(f"flash_attention_cuda needs Sq and Sk multiples of "
                         f"{block} and Sk > 0, got Sq={sq} Sk={sk}")
    win = 0 if window is None else int(window)
    if b * h > 65535 or max(q.numel(), k.numel()) >= 2**31 \
            or max(sq, sk, abs(win), abs(int(q_offset))) >= _LIMIT:
        raise ValueError(f"flash_attention_cuda: unsupported sizes B={b} "
                         f"Sq={sq} Sk={sk} H={h} window={window} "
                         f"q_offset={q_offset}")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if b == 0 or sq == 0:
        return out, lse.view(b, kvh, h // kvh, sq)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, sq, sk, h, kvh, hd, hd ** -0.5, int(causal),
            int(window is not None), win, int(q_offset),
            int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    flash_attention_cuda.launches += 1
    return out, lse.view(b, kvh, h // kvh, sq)


flash_attention_cuda.launches = 0
