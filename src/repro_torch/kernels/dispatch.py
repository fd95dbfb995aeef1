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
  - anything else -> an error.
There is no fallback from a failed build or launch to the plain version,
and no interpret mode.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import flash_fwd_ref
from repro_torch.kernels.midx_probs.ref import midx_probs_ref
from repro_torch.kernels.rff_sample.ref import rff_gumbel_ref
from repro_torch.kernels.sampled_ce.ref import (
    sampled_ce_bwd_ref, sampled_ce_fwd_ref, sampled_ce_partial_bwd_ref,
    sampled_ce_partial_fwd_ref, sampled_ce_pt_bwd_ref, sampled_ce_pt_fwd_ref,
    sampled_ce_pt_partial_bwd_ref, sampled_ce_pt_partial_ref)
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref


def _unsupported(name: str, x: torch.Tensor):
    return RuntimeError(f"{name} has no implementation for {x.device}")


def midx_probs(z: torch.Tensor, cb1: torch.Tensor, cb2: torch.Tensor,
               counts: torch.Tensor, *, split: bool, scale1=None,
               scale2=None):
    """(s1, s2, log_psi [T, K], lse [T]) for z [T, D]. scale1/scale2 [K]
    fp32 given: the quantized mode over int8 / fp8 codebooks."""
    if z.is_cuda:
        from repro_torch.kernels.midx_probs.cuda import midx_probs_cuda
        return midx_probs_cuda(z, cb1, cb2, counts, split=split,
                               scale1=scale1, scale2=scale2)
    if z.device.type == "cpu":
        return midx_probs_ref(z, cb1, cb2, counts, split=split,
                              scale1=scale1, scale2=scale2)
    raise _unsupported("midx_probs", z)


def sampled_ce_pt(hidden, table, log_q, neg_ids, pos_ids, scale=None):
    """Per-token sampled CE forward: (loss [T], lse [T]). scale [V, 1]
    fp32 given: the quantized mode over an int8 / fp8 table."""
    if hidden.is_cuda:
        from repro_torch.kernels.sampled_ce.cuda import sampled_ce_pt_cuda
        return sampled_ce_pt_cuda(hidden, table, log_q, neg_ids, pos_ids,
                                  scale=scale)
    if hidden.device.type == "cpu":
        return sampled_ce_pt_fwd_ref(hidden, table, log_q, neg_ids, pos_ids,
                                     scale=scale)
    raise _unsupported("sampled_ce_pt", hidden)


def sampled_ce_pt_bwd(g, hidden, table, log_q, neg_ids, pos_ids, lse,
                      scale=None):
    """Its backward from the saved lse: (dh [T, D], dtab [V, D] fp32,
    dlq [T, M]); in the quantized mode dtab is scale-unaware."""
    if hidden.is_cuda:
        from repro_torch.kernels.sampled_ce.cuda import sampled_ce_pt_bwd_cuda
        return sampled_ce_pt_bwd_cuda(g, hidden, table, log_q, neg_ids,
                                      pos_ids, lse, scale=scale)
    if hidden.device.type == "cpu":
        return sampled_ce_pt_bwd_ref(g, hidden, table, log_q, neg_ids,
                                     pos_ids, lse, scale=scale)
    raise _unsupported("sampled_ce_pt_bwd", hidden)


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
    if hidden.device.type == "cpu":
        return sampled_ce_fwd_ref(hidden, pos_emb, neg_emb, log_q, neg_ids,
                                  pos_ids, pos_scale, neg_scale)
    raise _unsupported("sampled_ce", hidden)


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
    if hidden.device.type == "cpu":
        return sampled_ce_bwd_ref(g, hidden, pos_emb, neg_emb, log_q, neg_ids,
                                  pos_ids, lse, pos_scale, neg_scale)
    raise _unsupported("sampled_ce_bwd", hidden)


def sampled_ce_pt_partial(hidden, table, log_q, neg_ids, pos_ids,
                          num_neg: int, scale=None):
    """The per-token forward's partial mode (a vocab shard's negatives,
    pos_ids local or -1, ln M from num_neg): the partial lse [T]."""
    if hidden.is_cuda:
        from repro_torch.kernels.sampled_ce.cuda import sampled_ce_pt_cuda
        return sampled_ce_pt_cuda(hidden, table, log_q, neg_ids, pos_ids,
                                  scale=scale, include_pos=False,
                                  num_neg=num_neg)[1]
    if hidden.device.type == "cpu":
        return sampled_ce_pt_partial_ref(hidden, table, log_q, neg_ids,
                                         pos_ids, num_neg, scale=scale)
    raise _unsupported("sampled_ce_pt", hidden)


def sampled_ce_pt_partial_bwd(g, hidden, table, log_q, neg_ids, pos_ids,
                              lse, num_neg: int, scale=None):
    """Its backward from the saved partial lse: (dh [T, D], dtab [V, D],
    dlq [T, M]) fp32, with no positive term."""
    if hidden.is_cuda:
        from repro_torch.kernels.sampled_ce.cuda import sampled_ce_pt_bwd_cuda
        return sampled_ce_pt_bwd_cuda(g, hidden, table, log_q, neg_ids,
                                      pos_ids, lse, scale=scale,
                                      include_pos=False, num_neg=num_neg)
    if hidden.device.type == "cpu":
        return sampled_ce_pt_partial_bwd_ref(g, hidden, table, log_q,
                                             neg_ids, pos_ids, lse, num_neg,
                                             scale=scale)
    raise _unsupported("sampled_ce_pt_bwd", hidden)


def sampled_ce_partial(hidden, neg_emb, log_q, neg_ids, pos_ids,
                       num_neg: int, neg_scale=None):
    """The shared-negative forward's partial mode: the partial lse
    [B, S]. neg_scale [B, M, 1] given: gathered int8 / fp8 rows."""
    if hidden.is_cuda:
        from repro_torch.kernels.sampled_ce.cuda import sampled_ce_cuda
        return sampled_ce_cuda(hidden, None, neg_emb, log_q, neg_ids,
                               pos_ids, neg_scale=neg_scale,
                               include_pos=False, num_neg=num_neg)[1]
    if hidden.device.type == "cpu":
        return sampled_ce_partial_fwd_ref(hidden, neg_emb, log_q, neg_ids,
                                          pos_ids, num_neg, neg_scale)
    raise _unsupported("sampled_ce", hidden)


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
    if hidden.device.type == "cpu":
        return sampled_ce_partial_bwd_ref(g, hidden, neg_emb, log_q, neg_ids,
                                          pos_ids, lse, num_neg, neg_scale)
    raise _unsupported("sampled_ce_bwd", hidden)


def rff_sample(phi_z, phi_c, seeds, t_ids, m: int):
    """Fused RFF Gumbel-top-m: (ids [T, m] int32, log_q [T, m])."""
    if phi_z.is_cuda:
        from repro_torch.kernels.rff_sample.cuda import rff_sample_cuda
        return rff_sample_cuda(phi_z, phi_c, seeds, t_ids, m)
    if phi_z.device.type == "cpu":
        ids, score, lse = rff_gumbel_ref(phi_z, phi_c, seeds, t_ids, m)
        return ids, score - lse[:, None]
    raise _unsupported("rff_sample", phi_z)


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
    if q.device.type == "cpu":
        return flash_fwd_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, q_chunk=q_chunk,
                             kv_chunk=kv_chunk)
    raise _unsupported("flash_attention", q)


def ssd_scan(x, bmat, cmat, adt, dt, *, chunk: int):
    """Chunked SSD scan: (y [Bt,S,H,P], h_last [Bt,H,N,P]), fp32."""
    if x.is_cuda:
        from repro_torch.kernels.ssd_scan.cuda import ssd_scan_cuda
        return ssd_scan_cuda(x, bmat, cmat, adt, dt, chunk=chunk)
    if x.device.type == "cpu":
        return ssd_scan_ref(x, bmat, cmat, adt, dt, chunk=chunk)
    raise _unsupported("ssd_scan", x)
