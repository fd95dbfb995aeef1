"""Load and launch the hand-written CUDA sampled-CE kernels.

`csrc/sampled_ce_pt.cu` replaces the JAX package's TPU kernels
`kernels/sampled_ce/per_token.py::_fwd_kernel` (`sampled_ce_pt`) and
`::_bwd_kernel` (`sampled_ce_pt_bwd`); `csrc/sampled_ce.cu` replaces
`kernels/sampled_ce/sampled_ce.py::_kernel` (`sampled_ce`) and
`::_bwd_dh_kernel` / `::_bwd_dne_kernel` (`sampled_ce_bwd`), the
shared-negative pair: a forward of two kernels (per-tile logsumexp
partials on 3xTF32 tensor-core tiles, then their merge) and a backward of
three 3xTF32 tensor-core passes (`kernels/common/tf32x3.cuh`). Each header
says what bounds its kernels on the card and how the design answers that.
Both are built by `kernels/build.py` (nvcc for sm_90a at first use, into
`build/kernels/`), one library per source, and loaded with `ctypes`.

The per-token backward is one C call over one workspace: a per-token
kernel (dh, dlq, the per-occurrence coefficients and the rows' occurrence
counts), the segment offsets and the placement of each occurrence in its
row's segment, built on the card, then a deterministic segmented reduction
for d(table), each row in ascending occurrence index.

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
    lib.sampled_ce_pt_fwd_launch.argtypes = [_P] * 7 + [_I] * 5 + [_P]
    lib.sampled_ce_pt_bwd_launch.argtypes = [_P] * 11 + [_I] * 7 + [_P]
    for fn in (lib.sampled_ce_pt_fwd_launch, lib.sampled_ce_pt_bwd_launch,
               lib.sampled_ce_pt_max_m):
        fn.restype = ctypes.c_int
    lib.sampled_ce_pt_max_m.argtypes = []
    lib.max_m = lib.sampled_ce_pt_max_m()     # read once, not per call


LIBRARY = KernelLibrary(
    "sampled_ce_pt",
    Path(__file__).resolve().parent / "csrc" / "sampled_ce_pt.cu", _declare)
load = LIBRARY.load

_VEC_ELEMS = {torch.float32: 4, torch.bfloat16: 8}   # 16 bytes


def _check(hidden, table, log_q, neg_ids, pos_ids, *extra):
    tensors = (hidden, table, log_q, neg_ids, pos_ids, *extra)
    if not all(x.is_cuda and x.device == hidden.device for x in tensors):
        raise ValueError("sampled_ce_pt_cuda: every operand must be on "
                         "hidden's CUDA device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("sampled_ce_pt_cuda: operands must be contiguous")
    if table.dtype not in _VEC_ELEMS:
        raise ValueError(f"sampled_ce_pt_cuda: table must be fp32 or bf16, "
                         f"got {table.dtype}")
    if not all(x.dtype == torch.float32 for x in (hidden, log_q, *extra)):
        raise ValueError("sampled_ce_pt_cuda: hidden, log_q, g and lse must "
                         "be fp32")
    if neg_ids.dtype != torch.int64 or pos_ids.dtype != torch.int64:
        raise ValueError("sampled_ce_pt_cuda: ids must be int64")
    t, d = hidden.shape
    if (table.dim() != 2 or table.shape[1] != d or log_q.dim() != 2
            or log_q.shape[0] != t or tuple(neg_ids.shape) != tuple(log_q.shape)
            or tuple(pos_ids.shape) != (t,)
            or any(tuple(x.shape) != (t,) for x in extra)):
        raise ValueError(f"sampled_ce_pt_cuda: bad shapes hidden"
                         f"{tuple(hidden.shape)} table{tuple(table.shape)} "
                         f"log_q{tuple(log_q.shape)} "
                         f"neg_ids{tuple(neg_ids.shape)} "
                         f"pos_ids{tuple(pos_ids.shape)}")
    m = log_q.shape[1]
    lib = load()
    if m > lib.max_m:
        raise ValueError(f"sampled_ce_pt_cuda supports M <= {lib.max_m}, "
                         f"got {m}")
    return lib, t, d, m


def _vec(d: int, elems: int, *tensors) -> int:
    """1 when 16-byte vector loads are legal: D a multiple of the vector
    and every base pointer 16-byte aligned."""
    return int(d % elems == 0 and all(x.data_ptr() % 16 == 0
                                      for x in tensors))


def _raise(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def sampled_ce_pt_cuda(hidden: torch.Tensor, table: torch.Tensor,
                       log_q: torch.Tensor, neg_ids: torch.Tensor,
                       pos_ids: torch.Tensor):
    """Forward: hidden [T, D] fp32, table [V, D] fp32/bf16, log_q [T, M]
    fp32, neg_ids [T, M] / pos_ids [T] int64 (ids in [0, V)), contiguous,
    on one CUDA device -> (loss [T], lse [T]) fp32. Adds one to
    `sampled_ce_pt_cuda.launches` per launch."""
    lib, t, d, m = _check(hidden, table, log_q, neg_ids, pos_ids)
    loss = torch.empty((t,), dtype=torch.float32, device=hidden.device)
    lse = torch.empty_like(loss)
    if t == 0:
        return loss, lse
    vec = _vec(d, _VEC_ELEMS[table.dtype], hidden, table)
    with torch.cuda.device(hidden.device):
        err = lib.sampled_ce_pt_fwd_launch(
            hidden.data_ptr(), table.data_ptr(), log_q.data_ptr(),
            neg_ids.data_ptr(), pos_ids.data_ptr(), loss.data_ptr(),
            lse.data_ptr(), t, d, m, int(table.dtype == torch.bfloat16), vec,
            torch.cuda.current_stream().cuda_stream)
    _raise(err, "sampled_ce_pt")
    sampled_ce_pt_cuda.launches += 1
    return loss, lse


sampled_ce_pt_cuda.launches = 0


def sampled_ce_pt_bwd_cuda(g: torch.Tensor, hidden: torch.Tensor,
                           table: torch.Tensor, log_q: torch.Tensor,
                           neg_ids: torch.Tensor, pos_ids: torch.Tensor,
                           lse: torch.Tensor):
    """Backward from the forward's lse: g/lse [T] fp32, the rest as the
    forward -> (dh [T, D], dtab [V, D], dlq [T, M]), all fp32.
    Adds one to `sampled_ce_pt_bwd_cuda.launches` per backward (its memset
    and four kernels launch together, in one C call)."""
    lib, t, d, m = _check(hidden, table, log_q, neg_ids, pos_ids, g, lse)
    dev = hidden.device
    v, nocc = table.shape[0], t * (m + 1)
    if nocc >= 2**31:
        raise ValueError(f"sampled_ce_pt_bwd_cuda: T·(M+1) must stay below "
                         f"2^31, got T={t} M={m}")
    dh = torch.empty((t, d), dtype=torch.float32, device=dev)
    dlq = torch.empty((t, m), dtype=torch.float32, device=dev)
    dtab = torch.empty((v, d), dtype=torch.float32, device=dev)
    if t == 0:
        return dh, dtab.zero_(), dlq
    # the C call's scratch, carved from one block (`sampled_ce_pt.cu`,
    # `sampled_ce_pt_bwd_launch`): coef [T(M+1)] fp32, the row counts [V],
    # the segment offsets [V+1], the placed and the sorted occurrences
    # [T(M+1)] each, int32
    work = torch.empty(4 * (3 * nocc + 2 * v + 1), dtype=torch.uint8,
                       device=dev)
    with torch.cuda.device(dev):
        err = lib.sampled_ce_pt_bwd_launch(
            g.data_ptr(), hidden.data_ptr(), table.data_ptr(),
            log_q.data_ptr(), neg_ids.data_ptr(), pos_ids.data_ptr(),
            lse.data_ptr(), dh.data_ptr(), dlq.data_ptr(), dtab.data_ptr(),
            work.data_ptr(), t, d, m, v, int(table.dtype == torch.bfloat16),
            _vec(d, _VEC_ELEMS[table.dtype], hidden, table, dh),
            _vec(d, 4, hidden, dtab),
            torch.cuda.current_stream().cuda_stream)
    _raise(err, "sampled_ce_pt_bwd")
    sampled_ce_pt_bwd_cuda.launches += 1
    return dh, dtab, dlq


sampled_ce_pt_bwd_cuda.launches = 0


# ------------------------------------------------------ shared negatives
def _declare_shared(lib: ctypes.CDLL) -> None:
    lib.sampled_ce_fwd_launch.argtypes = [_P] * 10 + [_I] * 6 + [_P]
    lib.sampled_ce_bwd_launch.argtypes = [_P] * 14 + [_I] * 6 + [_P]
    lib.sampled_ce_fwd_launch.restype = ctypes.c_int
    lib.sampled_ce_bwd_launch.restype = ctypes.c_int


SHARED_LIBRARY = KernelLibrary(
    "sampled_ce", Path(__file__).resolve().parent / "csrc" / "sampled_ce.cu",
    _declare_shared)


_SHARED_TILE = 64       # the kernels' tile; the workspaces are cut by it


def _check_shared(hidden, pos_emb, neg_emb, log_q, neg_ids, pos_ids, *extra):
    """Raises on what the shared-negative kernels do not take; returns
    (B, S, M, D). extra: the backward's g and lse [B, S] fp32."""
    tensors = (hidden, pos_emb, neg_emb, log_q, neg_ids, pos_ids, *extra)
    if not all(x.is_cuda and x.device == hidden.device for x in tensors):
        raise ValueError("sampled_ce_cuda: every operand must be on "
                         "hidden's CUDA device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("sampled_ce_cuda: operands must be contiguous")
    if pos_emb.dtype not in _VEC_ELEMS or neg_emb.dtype != pos_emb.dtype:
        raise ValueError(f"sampled_ce_cuda: pos_emb and neg_emb must be both "
                         f"fp32 or both bf16, got {pos_emb.dtype} and "
                         f"{neg_emb.dtype}")
    if not all(x.dtype == torch.float32 for x in (hidden, log_q, *extra)):
        raise ValueError("sampled_ce_cuda: hidden, log_q, g and lse must be "
                         "fp32")
    if neg_ids.dtype != torch.int64 or pos_ids.dtype != torch.int64:
        raise ValueError("sampled_ce_cuda: ids must be int64")
    if hidden.dim() != 3 or neg_emb.dim() != 3:
        raise ValueError(f"sampled_ce_cuda: bad shapes hidden"
                         f"{tuple(hidden.shape)} neg_emb"
                         f"{tuple(neg_emb.shape)}")
    b, s, d = hidden.shape
    m = neg_emb.shape[1]
    if (tuple(pos_emb.shape) != (b, s, d) or tuple(neg_emb.shape) != (b, m, d)
            or tuple(log_q.shape) != (b, m) or tuple(neg_ids.shape) != (b, m)
            or tuple(pos_ids.shape) != (b, s)
            or any(tuple(x.shape) != (b, s) for x in extra)):
        raise ValueError(f"sampled_ce_cuda: bad shapes hidden"
                         f"{tuple(hidden.shape)} pos_emb"
                         f"{tuple(pos_emb.shape)} neg_emb"
                         f"{tuple(neg_emb.shape)} log_q{tuple(log_q.shape)} "
                         f"neg_ids{tuple(neg_ids.shape)} "
                         f"pos_ids{tuple(pos_ids.shape)}")
    if d < 1 or m < 1 or b > 65535:
        raise ValueError(f"sampled_ce_cuda takes D >= 1, M >= 1 and "
                         f"B <= 65535, got D={d} M={m} B={b}")
    return b, s, m, d


def sampled_ce_cuda(hidden: torch.Tensor, pos_emb: torch.Tensor,
                    neg_emb: torch.Tensor, log_q: torch.Tensor,
                    neg_ids: torch.Tensor, pos_ids: torch.Tensor):
    """Forward: hidden [B, S, D] fp32, pos_emb [B, S, D] and neg_emb
    [B, M, D] both fp32 or both bf16, log_q [B, M] fp32, neg_ids [B, M] /
    pos_ids [B, S] int64, contiguous, on one CUDA device -> (loss [B, S],
    lse [B, S]) fp32. Adds one to `sampled_ce_cuda.launches` per forward
    (its two kernels, the partials and their merge, launch together)."""
    b, s, m, d = _check_shared(hidden, pos_emb, neg_emb, log_q, neg_ids,
                               pos_ids)
    lib = SHARED_LIBRARY.load()
    dev = hidden.device
    loss = torch.empty((b, s), dtype=torch.float32, device=dev)
    lse = torch.empty_like(loss)
    if loss.numel() == 0:
        return loss, lse
    nt = -(-m // _SHARED_TILE)
    # workspaces in one allocation: the (m, l) partials [B, S, M/64] of
    # float pairs, the positive logits [B, S]
    work = torch.empty(2 * b * s * nt + b * s, dtype=torch.float32,
                       device=dev)
    part = work.data_ptr()
    pos = part + 8 * b * s * nt
    vec = _vec(d, _VEC_ELEMS[pos_emb.dtype], hidden, pos_emb, neg_emb)
    with torch.cuda.device(dev):
        err = lib.sampled_ce_fwd_launch(
            hidden.data_ptr(), pos_emb.data_ptr(), neg_emb.data_ptr(),
            log_q.data_ptr(), neg_ids.data_ptr(), pos_ids.data_ptr(),
            loss.data_ptr(), lse.data_ptr(), part, pos, b, s, m, d,
            int(pos_emb.dtype == torch.bfloat16), vec,
            torch.cuda.current_stream().cuda_stream)
    _raise(err, "sampled_ce")
    sampled_ce_cuda.launches += 1
    return loss, lse


sampled_ce_cuda.launches = 0


def sampled_ce_bwd_cuda(g: torch.Tensor, hidden: torch.Tensor,
                        pos_emb: torch.Tensor, neg_emb: torch.Tensor,
                        log_q: torch.Tensor, neg_ids: torch.Tensor,
                        pos_ids: torch.Tensor, lse: torch.Tensor):
    """Backward from the forward's lse: g/lse [B, S] fp32, the rest as the
    forward -> (dh, dpe [B, S, D], dne [B, M, D], dlq [B, M]), all fp32.
    Adds one to `sampled_ce_bwd_cuda.launches` per backward (its three
    kernels, W, dh/dpe and dne/dlq, launch together)."""
    b, s, m, d = _check_shared(hidden, pos_emb, neg_emb, log_q, neg_ids,
                               pos_ids, g, lse)
    lib = SHARED_LIBRARY.load()
    dev = hidden.device
    dh = torch.empty((b, s, d), dtype=torch.float32, device=dev)
    dpe = torch.empty_like(dh)
    dne = torch.empty((b, m, d), dtype=torch.float32, device=dev)
    dlq = torch.empty((b, m), dtype=torch.float32, device=dev)
    if b == 0:
        return dh, dpe, dne, dlq
    pad = _SHARED_TILE
    sp, mp = -(-s // pad) * pad, -(-m // pad) * pad
    # workspaces in one allocation: W [B, Sp, Mp], the positive
    # coefficients [B, S]
    work = torch.empty(b * sp * mp + b * s, dtype=torch.float32, device=dev)
    w = work.data_ptr()
    coef = w + 4 * b * sp * mp
    vec = _vec(d, _VEC_ELEMS[pos_emb.dtype], hidden, pos_emb, neg_emb)
    with torch.cuda.device(dev):
        err = lib.sampled_ce_bwd_launch(
            g.data_ptr(), hidden.data_ptr(), pos_emb.data_ptr(),
            neg_emb.data_ptr(), log_q.data_ptr(), neg_ids.data_ptr(),
            pos_ids.data_ptr(), lse.data_ptr(), dh.data_ptr(),
            dpe.data_ptr(), dne.data_ptr(), dlq.data_ptr(), w, coef, b, s, m,
            d,
            int(pos_emb.dtype == torch.bfloat16), vec,
            torch.cuda.current_stream().cuda_stream)
    _raise(err, "sampled_ce_bwd")
    sampled_ce_bwd_cuda.launches += 1
    return dh, dpe, dne, dlq


sampled_ce_bwd_cuda.launches = 0
