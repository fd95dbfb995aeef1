"""Which implementation runs a kernel's function: decided by the device.

Mirrors `src/repro/kernels/dispatch.py` (`midx_tables_fn` :65,
`rff_sample_fn` :114, and the choice between the fused CE kernels and their
jnp oracles), the choice in `src/repro/models/attention.py` between the
Pallas flash kernel and the chunked XLA forward, and the one between the
Pallas SSD scan (`kernels/ssd_scan/ops.py`) and mamba2's own chunked scan,
with one rule in place of the reference's backend and environment
switches:
  - a CUDA tensor -> the hand-written kernel (it launches or raises);
  - a CPU tensor  -> the kernel's plain torch version;
  - a meta tensor -> the plain version too, but only while the dry run's
    plan (`launch.dryrun`) asks for it (`kernel_scope()["meta"]`), and
    then inside a kernel scope: the plan counts the call's FLOPs, and as
    its bytes only what the kernel reads and writes (its tensor arguments
    and results), not the plain version's temporaries, which the kernel
    keeps on chip. On meta the flash forward runs as one block (the same
    FLOPs as the chunk loops, whose count would only cost planning time);
  - anything else -> an error.
There is no fallback from a failed build or launch to the plain version,
and no interpret mode.

`fused_head_active` (reference :46-62) picks the MIDX head's route: the
fused route calls the wrappers below (the kernels on the card, their
plain versions on the CPU); the unfused route never calls them and runs
the head's plain torch formulation on whatever device its tensors live.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ref import flash_fwd_ref
from repro_torch.kernels.midx_probs.ref import (midx_probs_bwd_ref,
                                                midx_probs_ref)
from repro_torch.kernels.rff_sample.ref import rff_gumbel_ref
from repro_torch.kernels.sampled_ce.ref import (
    sampled_ce_bwd_ref, sampled_ce_fwd_ref, sampled_ce_partial_bwd_ref,
    sampled_ce_partial_fwd_ref, sampled_ce_pt_bwd_ref, sampled_ce_pt_fwd_ref,
    sampled_ce_pt_partial_bwd_ref, sampled_ce_pt_partial_ref)
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

# whether meta tensors take the plain versions (the plan asks), the meta
# calls in flight, and what is told of each finished one
_SCOPE = {"meta": False, "depth": 0, "hook": None}


def kernel_scope() -> dict:
    """{"meta": whether meta tensors take the plain versions, "depth":
    meta kernel calls in flight, "hook": None or hook(inputs, outputs),
    called with a finished meta call's tensors} (the dry run's tracker
    sets "meta" and the hook while it plans)."""
    return _SCOPE


def _plain(x: torch.Tensor) -> bool:
    """Whether x's device takes the plain version."""
    return x.device.type == "cpu" or (x.device.type == "meta"
                                      and _SCOPE["meta"])


def _tensors_of(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors_of(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors_of(x)]
    return []


def _kernel(fn):
    """A kernel's dispatcher, which on meta runs inside the kernel scope."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        ins = _tensors_of(list(args) + list(kwargs.values()))
        if not ins or not ins[0].is_meta or not _SCOPE["meta"]:
            return fn(*args, **kwargs)
        _SCOPE["depth"] += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            _SCOPE["depth"] -= 1
        if _SCOPE["hook"] is not None:
            _SCOPE["hook"](ins, _tensors_of(out))
        return out
    return run


def fused_head_active(head_cfg, *, fused: Optional[bool] = None) -> bool:
    """Does the MIDX head take the fused route? A head without collision
    masking never does (the kernels always mask collisions); else an
    explicit `fused` wins; else `head_cfg.use_fused_head`. Departures: no
    REPRO_FUSED_HEAD / REPRO_PALLAS_INTERPRET environment switches, and no
    backend gate on `use_fused_head`, since every device the port runs on
    has a fused route (the kernels on the card, their plain versions on
    the CPU)."""
    if not head_cfg.mask_collisions:
        return False
    if fused is not None:
        return fused
    return head_cfg.use_fused_head


def _unsupported(name: str, x: torch.Tensor):
    return RuntimeError(f"{name} has no implementation for {x.device}")


@_kernel
def midx_probs(z: torch.Tensor, cb1: torch.Tensor, cb2: torch.Tensor,
               counts: torch.Tensor, *, split: bool, scale1=None,
               scale2=None):
    """(s1, s2, log_psi [T, K], lse [T]) for z [T, D]. scale1/scale2 [K]
    fp32 given: the quantized mode over int8 / fp8 codebooks."""
    if z.is_cuda:
        from repro_torch.kernels.midx_probs.cuda import midx_probs_cuda
        return midx_probs_cuda(z, cb1, cb2, counts, split=split,
                               scale1=scale1, scale2=scale2)
    if _plain(z):
        return midx_probs_ref(z, cb1, cb2, counts, split=split,
                              scale1=scale1, scale2=scale2)
    raise _unsupported("midx_probs", z)


@_kernel
def midx_probs_bwd(s1, s2, lpsi, lse, g1, g2, g3, g4, cb1, cb2, counts, *,
                   split: bool, scale1=None, scale2=None,
                   with_ds: bool = False):
    """Its backward from the forward's outputs and their cotangents: (dz
    [T, D], ds1, ds2 [T, K] where `with_ds`, else None)."""
    if s1.is_cuda:
        from repro_torch.kernels.midx_probs.cuda import midx_probs_bwd_cuda
        return midx_probs_bwd_cuda(s1, s2, lpsi, lse, g1, g2, g3, g4, cb1,
                                   cb2, counts, split=split, scale1=scale1,
                                   scale2=scale2, with_ds=with_ds)
    if _plain(s1):
        return midx_probs_bwd_ref(s1, s2, lpsi, lse, g1, g2, g3, g4, cb1,
                                  cb2, counts, split=split, scale1=scale1,
                                  scale2=scale2, with_ds=with_ds)
    raise _unsupported("midx_probs_bwd", s1)


@_kernel
def sampled_ce_pt(hidden, table, log_q, neg_ids, pos_ids, scale=None):
    """Per-token sampled CE forward: (loss [T], lse [T]). scale [V, 1]
    fp32 given: the quantized mode over an int8 / fp8 table."""
    if hidden.is_cuda:
        from repro_torch.kernels.sampled_ce.cuda import sampled_ce_pt_cuda
        return sampled_ce_pt_cuda(hidden, table, log_q, neg_ids, pos_ids,
                                  scale=scale)
    if _plain(hidden):
        return sampled_ce_pt_fwd_ref(hidden, table, log_q, neg_ids, pos_ids,
                                     scale=scale)
    raise _unsupported("sampled_ce_pt", hidden)


@_kernel
def sampled_ce_pt_bwd(g, hidden, table, log_q, neg_ids, pos_ids, lse,
                      scale=None):
    """Its backward from the saved lse: (dh [T, D], dtab [V, D] fp32,
    dlq [T, M]); in the quantized mode dtab is scale-unaware."""
    if hidden.is_cuda:
        from repro_torch.kernels.sampled_ce.cuda import sampled_ce_pt_bwd_cuda
        return sampled_ce_pt_bwd_cuda(g, hidden, table, log_q, neg_ids,
                                      pos_ids, lse, scale=scale)
    if _plain(hidden):
        return sampled_ce_pt_bwd_ref(g, hidden, table, log_q, neg_ids,
                                     pos_ids, lse, scale=scale)
    raise _unsupported("sampled_ce_pt_bwd", hidden)


@_kernel
def sampled_ce(hidden, pos_emb, neg_emb, log_q, neg_ids, pos_ids,
               pos_scale=None, neg_scale=None):
    """Shared-negative sampled CE forward: (loss [B, S], lse [B, S]).
    pos_scale [B, S, 1] / neg_scale [B, M, 1] fp32 given: the quantized
    mode over gathered int8 / fp8 rows."""
    if hidden.is_cuda:
        from repro_torch.kernels.sampled_ce.cuda import sampled_ce_cuda
        return sampled_ce_cuda(hidden, pos_emb, neg_emb, log_q, neg_ids,
                               pos_ids, pos_scale=pos_scale,
                               neg_scale=neg_scale)
    if _plain(hidden):
        return sampled_ce_fwd_ref(hidden, pos_emb, neg_emb, log_q, neg_ids,
                                  pos_ids, pos_scale, neg_scale)
    raise _unsupported("sampled_ce", hidden)


@_kernel
def sampled_ce_bwd(g, hidden, pos_emb, neg_emb, log_q, neg_ids, pos_ids,
                   lse, pos_scale=None, neg_scale=None):
    """Its backward from the saved lse: (dh, dpe [B, S, D], dne [B, M, D],
    dlq [B, M]), all fp32; dpe and dne scale-unaware in the quantized
    mode."""
    if hidden.is_cuda:
        from repro_torch.kernels.sampled_ce.cuda import sampled_ce_bwd_cuda
        return sampled_ce_bwd_cuda(g, hidden, pos_emb, neg_emb, log_q,
                                   neg_ids, pos_ids, lse,
                                   pos_scale=pos_scale, neg_scale=neg_scale)
    if _plain(hidden):
        return sampled_ce_bwd_ref(g, hidden, pos_emb, neg_emb, log_q, neg_ids,
                                  pos_ids, lse, pos_scale, neg_scale)
    raise _unsupported("sampled_ce_bwd", hidden)


@_kernel
def sampled_ce_pt_partial(hidden, table, log_q, neg_ids, pos_ids,
                          num_neg: int, scale=None):
    """The per-token forward's partial mode (a vocab shard's negatives,
    pos_ids local or -1, ln M from num_neg): the partial lse [T]."""
    if hidden.is_cuda:
        from repro_torch.kernels.sampled_ce.cuda import sampled_ce_pt_cuda
        return sampled_ce_pt_cuda(hidden, table, log_q, neg_ids, pos_ids,
                                  scale=scale, include_pos=False,
                                  num_neg=num_neg)[1]
    if _plain(hidden):
        return sampled_ce_pt_partial_ref(hidden, table, log_q, neg_ids,
                                         pos_ids, num_neg, scale=scale)
    raise _unsupported("sampled_ce_pt", hidden)


@_kernel
def sampled_ce_pt_partial_bwd(g, hidden, table, log_q, neg_ids, pos_ids,
                              lse, num_neg: int, scale=None):
    """Its backward from the saved partial lse: (dh [T, D], dtab [V, D],
    dlq [T, M]) fp32, with no positive term."""
    if hidden.is_cuda:
        from repro_torch.kernels.sampled_ce.cuda import sampled_ce_pt_bwd_cuda
        return sampled_ce_pt_bwd_cuda(g, hidden, table, log_q, neg_ids,
                                      pos_ids, lse, scale=scale,
                                      include_pos=False, num_neg=num_neg)
    if _plain(hidden):
        return sampled_ce_pt_partial_bwd_ref(g, hidden, table, log_q,
                                             neg_ids, pos_ids, lse, num_neg,
                                             scale=scale)
    raise _unsupported("sampled_ce_pt_bwd", hidden)


@_kernel
def sampled_ce_partial(hidden, neg_emb, log_q, neg_ids, pos_ids,
                       num_neg: int, neg_scale=None):
    """The shared-negative forward's partial mode: the partial lse
    [B, S]. neg_scale [B, M, 1] given: gathered int8 / fp8 rows."""
    if hidden.is_cuda:
        from repro_torch.kernels.sampled_ce.cuda import sampled_ce_cuda
        return sampled_ce_cuda(hidden, None, neg_emb, log_q, neg_ids,
                               pos_ids, neg_scale=neg_scale,
                               include_pos=False, num_neg=num_neg)[1]
    if _plain(hidden):
        return sampled_ce_partial_fwd_ref(hidden, neg_emb, log_q, neg_ids,
                                          pos_ids, num_neg, neg_scale)
    raise _unsupported("sampled_ce", hidden)


@_kernel
def sampled_ce_partial_bwd(g, hidden, neg_emb, log_q, neg_ids, pos_ids, lse,
                           num_neg: int, neg_scale=None):
    """Its backward from the saved partial lse: (dh [B, S, D], dne
    [B, M, D], dlq [B, M]) fp32; there are no positive rows, so no dpe."""
    if hidden.is_cuda:
        from repro_torch.kernels.sampled_ce.cuda import sampled_ce_bwd_cuda
        dh, _, dne, dlq = sampled_ce_bwd_cuda(
            g, hidden, None, neg_emb, log_q, neg_ids, pos_ids, lse,
            neg_scale=neg_scale, include_pos=False, num_neg=num_neg)
        return dh, dne, dlq
    if _plain(hidden):
        return sampled_ce_partial_bwd_ref(g, hidden, neg_emb, log_q, neg_ids,
                                          pos_ids, lse, num_neg, neg_scale)
    raise _unsupported("sampled_ce_bwd", hidden)


@_kernel
def rff_sample(phi_z, phi_c, seeds, t_ids, m: int):
    """Fused RFF Gumbel-top-m: (ids [T, m] int32, log_q [T, m])."""
    if phi_z.is_cuda:
        from repro_torch.kernels.rff_sample.cuda import rff_sample_cuda
        return rff_sample_cuda(phi_z, phi_c, seeds, t_ids, m)
    if _plain(phi_z):
        ids, score, lse = rff_gumbel_ref(phi_z, phi_c, seeds, t_ids, m)
        return ids, score - lse[:, None]
    raise _unsupported("rff_sample", phi_z)


@_kernel
def flash_attention(q, k, v, *, causal: bool, window, q_offset: int,
                    q_chunk: int, kv_chunk: int):
    """Online-softmax attention forward: (out like q, lse [B, KV, G, Sq]
    fp32). The chunk sizes shape the plain version's loops; the kernel
    walks its own 64-key blocks."""
    if q.is_cuda:
        from repro_torch.kernels.flash_attention.cuda import \
            flash_attention_cuda
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset)
    if q.is_meta:
        q_chunk, kv_chunk = q.shape[1], k.shape[1]
    if _plain(q):
        return flash_fwd_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, q_chunk=q_chunk,
                             kv_chunk=kv_chunk)
    raise _unsupported("flash_attention", q)


@_kernel
def ssd_scan(x, bmat, cmat, adt, dt, *, chunk: int):
    """Chunked SSD scan: (y [Bt,S,H,P], h_last [Bt,H,N,P]), fp32."""
    if x.is_cuda:
        from repro_torch.kernels.ssd_scan.cuda import ssd_scan_cuda
        return ssd_scan_cuda(x, bmat, cmat, adt, dt, chunk=chunk)
    if _plain(x):
        return ssd_scan_ref(x, bmat, cmat, adt, dt, chunk=chunk)
    raise _unsupported("ssd_scan", x)
