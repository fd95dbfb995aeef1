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

The per-token forward is one C call and one CUDA kernel: a CTA a token
whose rows are copied into shared memory (TMA bulk copies for rows of
2 KB or more, 16-byte `cp.async` through L1 for shorter), all in one flight
where they fit (paper-lm) and through a ring of 8-row groups where they
do not (llama width); where D or the pointers allow no 16-byte copies, or
a stage does not fit in shared memory, the first design's warp-per-token
kernel with plain loads runs. Both fold in one order, so a token's loss
and lse are the first design's bit for bit. The wrapper's host issue is
kept short: the checks compare device indices, loss and lse come from one
allocation, the stream is read as a raw handle, and the device is
switched only when the operands are not on the current one.

Both pairs also have a quantized mode, the TPU kernels' `quantized`
branch: int8 or fp8-e4m3 rows with fp32 per-row scales, dequantized in
registers as they are read (before the 3xTF32 split in the shared
kernels), and d(table) / dpe / dne scale-unaware, the master rows'
straight-through gradients. `quant_launches[fmt]` counts each wrapper's
launches in that mode.

All four kernels also have the partial mode of the vocab-parallel head,
the TPU kernels' `include_pos=False` (`include_pos=False, num_neg=M` on
the wrappers): the table (or the gathered rows) is one shard's, the
positive id is local on its owner and -1 elsewhere and only masks
collisions, the forward returns the negatives-only lse (loss = lse), the
backward takes it and has no positive term (no positive scatter into
d(table), dh from zero, no dpe), and ln(M·q) uses the global M,
`num_neg`. `partial_launches[fmt]` counts each wrapper's launches in that
mode, by row format ("float": fp32 or bf16 rows, "int8", "fp8").

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
    lib.sampled_ce_pt_fwd_launch.argtypes = [_P] * 8 + [_I] * 7 + [_P]
    lib.sampled_ce_pt_bwd_launch.argtypes = [_P] * 12 + [_I] * 9 + [_P]
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
# the quantized mode's 1-byte rows: 8-byte vectors of 8 elements
_Q_VEC_ELEMS = {torch.int8: 8, torch.float8_e4m3fn: 8}
_PT_VEC_ELEMS = {**_VEC_ELEMS, **_Q_VEC_ELEMS}
# table dtypes -> the C calls' `table_kind`
_TABLE_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.float8_e4m3fn: 3}
_Q_NAMES = {torch.int8: "int8", torch.float8_e4m3fn: "fp8"}


def _count(fn, table: torch.Tensor, include_pos: bool = True) -> None:
    """One launch of `fn`, of its quantized mode by format, and of its
    partial mode by row format."""
    fn.launches += 1
    fmt = _Q_NAMES.get(table.dtype)
    if fmt is not None:
        fn.quant_launches[fmt] += 1
    if not include_pos:
        fn.partial_launches[fmt or "float"] += 1


def _num_neg(num_neg, m: int) -> int:
    """The C calls' num_neg: the global M of the partial mode, 0 (this
    call's M) where not given."""
    if num_neg is None:
        return 0
    if num_neg < 1:
        raise ValueError(f"num_neg must be >= 1, got {num_neg}")
    return int(num_neg)


def _check(hidden, table, scale, log_q, neg_ids, pos_ids, *extra):
    """Raises on what the per-token kernels do not take; returns (lib, T, D,
    M). The cheapest tests first: the device index (-1 off the card),
    contiguity and dtypes, then the shapes. `scale` is None, or the
    quantized mode's [V, 1] (or [V]) fp32 row scales of an int8 / fp8
    table."""
    quant = scale is not None
    tensors = (hidden, table, log_q, neg_ids, pos_ids, *extra,
               *((scale,) if quant else ()))
    dev = hidden.get_device()
    for x in tensors:
        if x.get_device() != dev or dev < 0 or not x.is_cuda:
            raise ValueError("sampled_ce_pt_cuda: every operand must be on "
                             "hidden's CUDA device")
    for x in tensors:
        if not x.is_contiguous():
            raise ValueError("sampled_ce_pt_cuda: operands must be "
                             "contiguous")
    if table.dtype not in (_Q_VEC_ELEMS if quant else _VEC_ELEMS):
        raise ValueError(f"sampled_ce_pt_cuda: table must be fp32 or bf16, "
                         f"or int8 / fp8-e4m3 with scales; got {table.dtype}"
                         f" with scales={quant}")
    f32 = torch.float32
    if hidden.dtype != f32 or log_q.dtype != f32 \
            or any(x.dtype != f32 for x in extra) \
            or (quant and scale.dtype != f32):
        raise ValueError("sampled_ce_pt_cuda: hidden, log_q, g, lse and the "
                         "scales must be fp32")
    if neg_ids.dtype != torch.int64 or pos_ids.dtype != torch.int64:
        raise ValueError("sampled_ce_pt_cuda: ids must be int64")
    t, d = hidden.shape
    tshape = (t,)
    if (table.dim() != 2 or table.shape[1] != d or log_q.dim() != 2
            or log_q.shape[0] != t or neg_ids.shape != log_q.shape
            or pos_ids.shape != tshape
            or any(x.shape != tshape for x in extra)
            or (quant and scale.numel() != table.shape[0])):
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
                       pos_ids: torch.Tensor, scale=None, *,
                       include_pos: bool = True, num_neg=None):
    """Forward: hidden [T, D] fp32, table [V, D] fp32/bf16 (or, with
    `scale` [V, 1] fp32, the quantized mode's int8 / fp8-e4m3), log_q
    [T, M] fp32, neg_ids [T, M] / pos_ids [T] int64 (ids in [0, V);
    pos_ids -1 allowed in the partial mode), contiguous, on one CUDA
    device -> (loss [T], lse [T]) fp32, two rows of one allocation;
    include_pos=False: the partial mode, loss = lse = the negatives-only
    lse, ln M from `num_neg`. Adds one to `sampled_ce_pt_cuda.launches`
    per launch (one C call, one CUDA kernel), and, in the quantized and
    partial modes, to `quant_launches[fmt]` and `partial_launches[fmt]`."""
    lib, t, d, m = _check(hidden, table, scale, log_q, neg_ids, pos_ids)
    out = torch.empty((2, t), dtype=torch.float32, device=hidden.device)
    loss, lse = out.unbind(0)
    if t == 0:
        return loss, lse
    dev = hidden.get_device()
    op = out.data_ptr()
    elems = _PT_VEC_ELEMS[table.dtype]
    args = (hidden.data_ptr(), table.data_ptr(),
            None if scale is None else scale.data_ptr(), log_q.data_ptr(),
            neg_ids.data_ptr(), pos_ids.data_ptr(), op, op + 4 * t, t, d, m,
            _TABLE_KIND[table.dtype], _vec(d, elems, hidden, table),
            int(include_pos), _num_neg(num_neg, m),
            # the current stream's handle, without building a Stream object
            torch._C._cuda_getCurrentRawStream(dev))
    if dev == torch.cuda.current_device():
        err = lib.sampled_ce_pt_fwd_launch(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.sampled_ce_pt_fwd_launch(*args)
    _raise(err, "sampled_ce_pt")
    _count(sampled_ce_pt_cuda, table, include_pos)
    return loss, lse


sampled_ce_pt_cuda.launches = 0
sampled_ce_pt_cuda.quant_launches = {"int8": 0, "fp8": 0}
sampled_ce_pt_cuda.partial_launches = {"float": 0, "int8": 0, "fp8": 0}


def sampled_ce_pt_bwd_cuda(g: torch.Tensor, hidden: torch.Tensor,
                           table: torch.Tensor, log_q: torch.Tensor,
                           neg_ids: torch.Tensor, pos_ids: torch.Tensor,
                           lse: torch.Tensor, scale=None, *,
                           include_pos: bool = True, num_neg=None):
    """Backward from the forward's lse: g/lse [T] fp32, the rest as the
    forward -> (dh [T, D], dtab [V, D], dlq [T, M]), all fp32; in the
    quantized mode dtab is scale-unaware (the master's gradient); in the
    partial mode (include_pos=False, lse the partial lse) no positive term.
    Adds one to `sampled_ce_pt_bwd_cuda.launches` per backward (its memset
    and four kernels launch together, in one C call), and, in the
    quantized and partial modes, to `quant_launches[fmt]` and
    `partial_launches[fmt]`."""
    lib, t, d, m = _check(hidden, table, scale, log_q, neg_ids, pos_ids, g,
                          lse)
    dev = hidden.device
    v, nocc = table.shape[0], t * (m + int(include_pos))
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
    elems = _PT_VEC_ELEMS[table.dtype]
    with torch.cuda.device(dev):
        err = lib.sampled_ce_pt_bwd_launch(
            g.data_ptr(), hidden.data_ptr(), table.data_ptr(),
            None if scale is None else scale.data_ptr(),
            log_q.data_ptr(), neg_ids.data_ptr(), pos_ids.data_ptr(),
            lse.data_ptr(), dh.data_ptr(), dlq.data_ptr(), dtab.data_ptr(),
            work.data_ptr(), t, d, m, v, _TABLE_KIND[table.dtype],
            _vec(d, elems, hidden, table, dh),
            _vec(d, 4, hidden, dtab), int(include_pos), _num_neg(num_neg, m),
            torch.cuda.current_stream().cuda_stream)
    _raise(err, "sampled_ce_pt_bwd")
    _count(sampled_ce_pt_bwd_cuda, table, include_pos)
    return dh, dtab, dlq


sampled_ce_pt_bwd_cuda.launches = 0
sampled_ce_pt_bwd_cuda.quant_launches = {"int8": 0, "fp8": 0}
sampled_ce_pt_bwd_cuda.partial_launches = {"float": 0, "int8": 0, "fp8": 0}


# ------------------------------------------------------ shared negatives
def _declare_shared(lib: ctypes.CDLL) -> None:
    lib.sampled_ce_fwd_launch.argtypes = [_P] * 12 + [_I] * 8 + [_P]
    lib.sampled_ce_bwd_launch.argtypes = [_P] * 16 + [_I] * 8 + [_P]
    lib.sampled_ce_fwd_launch.restype = ctypes.c_int
    lib.sampled_ce_bwd_launch.restype = ctypes.c_int


SHARED_LIBRARY = KernelLibrary(
    "sampled_ce", Path(__file__).resolve().parent / "csrc" / "sampled_ce.cu",
    _declare_shared)


_SHARED_TILE = 64       # the kernels' tile; the workspaces are cut by it
# the shared kernels' 16-byte vectors, 1-byte rows included
_SHARED_VEC_ELEMS = {**_VEC_ELEMS, torch.int8: 16, torch.float8_e4m3fn: 16}


def _check_shared(hidden, pos_emb, neg_emb, log_q, neg_ids, pos_ids, *extra,
                  scales=()):
    """Raises on what the shared-negative kernels do not take; returns
    (B, S, M, D). extra: the backward's g and lse [B, S] fp32. scales: the
    quantized mode's (pos_scale [B, S, 1], neg_scale [B, M, 1]) fp32 of
    int8 / fp8 rows, or (). The partial mode has no positive rows: pos_emb
    None, and pos_scale None in its quantized mode."""
    quant = bool(scales)
    given = [x for x in (hidden, pos_emb, neg_emb, log_q, neg_ids, pos_ids,
                         *extra, *scales) if x is not None]
    if not all(x.is_cuda and x.device == hidden.device for x in given):
        raise ValueError("sampled_ce_cuda: every operand must be on "
                         "hidden's CUDA device")
    if not all(x.is_contiguous() for x in given):
        raise ValueError("sampled_ce_cuda: operands must be contiguous")
    rows = [x for x in (pos_emb, neg_emb) if x is not None]
    if neg_emb.dtype not in (_Q_VEC_ELEMS if quant else _VEC_ELEMS) \
            or any(x.dtype != neg_emb.dtype for x in rows):
        raise ValueError(f"sampled_ce_cuda: pos_emb and neg_emb must be both "
                         f"fp32 or both bf16, or both int8 / fp8-e4m3 with "
                         f"scales; got {[x.dtype for x in rows]} with "
                         f"scales={quant}")
    if not all(x.dtype == torch.float32 for x in (hidden, log_q, *extra,
                                                  *scales) if x is not None):
        raise ValueError("sampled_ce_cuda: hidden, log_q, g, lse and the "
                         "scales must be fp32")
    if neg_ids.dtype != torch.int64 or pos_ids.dtype != torch.int64:
        raise ValueError("sampled_ce_cuda: ids must be int64")
    if hidden.dim() != 3 or neg_emb.dim() != 3:
        raise ValueError(f"sampled_ce_cuda: bad shapes hidden"
                         f"{tuple(hidden.shape)} neg_emb"
                         f"{tuple(neg_emb.shape)}")
    b, s, d = hidden.shape
    m = neg_emb.shape[1]
    if ((pos_emb is not None and tuple(pos_emb.shape) != (b, s, d))
            or tuple(neg_emb.shape) != (b, m, d)
            or tuple(log_q.shape) != (b, m) or tuple(neg_ids.shape) != (b, m)
            or tuple(pos_ids.shape) != (b, s)
            or any(tuple(x.shape) != (b, s) for x in extra)
            or (quant and ((scales[0] is not None
                            and scales[0].numel() != b * s)
                           or scales[1].numel() != b * m))):
        raise ValueError(f"sampled_ce_cuda: bad shapes hidden"
                         f"{tuple(hidden.shape)} pos_emb"
                         f"{None if pos_emb is None else tuple(pos_emb.shape)}"
                         f" neg_emb{tuple(neg_emb.shape)} log_q"
                         f"{tuple(log_q.shape)} neg_ids"
                         f"{tuple(neg_ids.shape)} pos_ids"
                         f"{tuple(pos_ids.shape)}")
    if d < 1 or m < 1 or b > 65535:
        raise ValueError(f"sampled_ce_cuda takes D >= 1, M >= 1 and "
                         f"B <= 65535, got D={d} M={m} B={b}")
    return b, s, m, d


def _scales(pos_scale, neg_scale, include_pos: bool = True):
    if not include_pos:
        if pos_scale is not None:
            raise ValueError("sampled_ce_cuda: the partial mode takes no "
                             "positive rows or scales")
        return () if neg_scale is None else (None, neg_scale)
    if (pos_scale is None) != (neg_scale is None):
        raise ValueError("sampled_ce_cuda: give both scales or neither")
    return () if pos_scale is None else (pos_scale, neg_scale)


def _ptr(x):
    return None if x is None else x.data_ptr()


def sampled_ce_cuda(hidden: torch.Tensor, pos_emb, neg_emb: torch.Tensor,
                    log_q: torch.Tensor, neg_ids: torch.Tensor,
                    pos_ids: torch.Tensor, pos_scale=None, neg_scale=None,
                    *, include_pos: bool = True, num_neg=None):
    """Forward: hidden [B, S, D] fp32, pos_emb [B, S, D] and neg_emb
    [B, M, D] both fp32 or both bf16 (or, with pos_scale [B, S, 1] and
    neg_scale [B, M, 1] fp32, the quantized mode's gathered int8 / fp8-e4m3
    rows), log_q [B, M] fp32, neg_ids [B, M] / pos_ids [B, S] int64,
    contiguous, on one CUDA device -> (loss [B, S], lse [B, S]) fp32;
    include_pos=False: the partial mode (pos_emb and pos_scale None,
    pos_ids local or -1, loss = lse = the negatives-only lse, ln M from
    `num_neg`). Adds one to `sampled_ce_cuda.launches` per forward (its two
    kernels, the partials and their merge, launch together), and, in the
    quantized and partial modes, to `quant_launches[fmt]` and
    `partial_launches[fmt]`."""
    scales = _scales(pos_scale, neg_scale, include_pos)
    if include_pos == (pos_emb is None):
        raise ValueError("sampled_ce_cuda: pos_emb is given in the full "
                         "mode and None in the partial mode")
    b, s, m, d = _check_shared(hidden, pos_emb, neg_emb, log_q, neg_ids,
                               pos_ids, scales=scales)
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
    rows = (hidden, neg_emb) if pos_emb is None else (hidden, pos_emb,
                                                        neg_emb)
    vec = _vec(d, _SHARED_VEC_ELEMS[neg_emb.dtype], *rows)
    with torch.cuda.device(dev):
        err = lib.sampled_ce_fwd_launch(
            hidden.data_ptr(), _ptr(pos_emb), neg_emb.data_ptr(),
            _ptr(pos_scale), _ptr(neg_scale),
            log_q.data_ptr(), neg_ids.data_ptr(), pos_ids.data_ptr(),
            loss.data_ptr(), lse.data_ptr(), part, pos, b, s, m, d,
            _TABLE_KIND[neg_emb.dtype], vec, int(include_pos),
            _num_neg(num_neg, m), torch.cuda.current_stream().cuda_stream)
    _raise(err, "sampled_ce")
    _count(sampled_ce_cuda, neg_emb, include_pos)
    return loss, lse


sampled_ce_cuda.launches = 0
sampled_ce_cuda.quant_launches = {"int8": 0, "fp8": 0}
sampled_ce_cuda.partial_launches = {"float": 0, "int8": 0, "fp8": 0}


def sampled_ce_bwd_cuda(g: torch.Tensor, hidden: torch.Tensor, pos_emb,
                        neg_emb: torch.Tensor, log_q: torch.Tensor,
                        neg_ids: torch.Tensor, pos_ids: torch.Tensor,
                        lse: torch.Tensor, pos_scale=None, neg_scale=None,
                        *, include_pos: bool = True, num_neg=None):
    """Backward from the forward's lse: g/lse [B, S] fp32, the rest as the
    forward -> (dh, dpe [B, S, D], dne [B, M, D], dlq [B, M]), all fp32;
    dpe and dne scale-unaware in the quantized mode; in the partial mode
    (lse the partial lse) dpe is None. Adds one to
    `sampled_ce_bwd_cuda.launches` per backward (its three kernels, W,
    dh/dpe and dne/dlq, launch together), and, in the quantized and
    partial modes, to `quant_launches[fmt]` and `partial_launches[fmt]`."""
    scales = _scales(pos_scale, neg_scale, include_pos)
    if include_pos == (pos_emb is None):
        raise ValueError("sampled_ce_bwd_cuda: pos_emb is given in the full "
                         "mode and None in the partial mode")
    b, s, m, d = _check_shared(hidden, pos_emb, neg_emb, log_q, neg_ids,
                               pos_ids, g, lse, scales=scales)
    lib = SHARED_LIBRARY.load()
    dev = hidden.device
    dh = torch.empty((b, s, d), dtype=torch.float32, device=dev)
    dpe = torch.empty_like(dh) if include_pos else None
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
    rows = (hidden, neg_emb) if pos_emb is None else (hidden, pos_emb,
                                                        neg_emb)
    vec = _vec(d, _SHARED_VEC_ELEMS[neg_emb.dtype], *rows)
    with torch.cuda.device(dev):
        err = lib.sampled_ce_bwd_launch(
            g.data_ptr(), hidden.data_ptr(), _ptr(pos_emb),
            neg_emb.data_ptr(), _ptr(pos_scale), _ptr(neg_scale),
            log_q.data_ptr(), neg_ids.data_ptr(),
            pos_ids.data_ptr(), lse.data_ptr(), dh.data_ptr(),
            _ptr(dpe), dne.data_ptr(), dlq.data_ptr(), w, coef, b, s, m,
            d, _TABLE_KIND[neg_emb.dtype], vec, int(include_pos),
            _num_neg(num_neg, m), torch.cuda.current_stream().cuda_stream)
    _raise(err, "sampled_ce_bwd")
    _count(sampled_ce_bwd_cuda, neg_emb, include_pos)
    return dh, dpe, dne, dlq


sampled_ce_bwd_cuda.launches = 0
sampled_ce_bwd_cuda.quant_launches = {"int8": 0, "fp8": 0}
sampled_ce_bwd_cuda.partial_launches = {"float": 0, "int8": 0, "fp8": 0}
