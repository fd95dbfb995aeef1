"""Which implementation runs a kernel's function: decided by the device.

Mirrors `src/repro/kernels/dispatch.py` (`midx_tables_fn` :65), with one
rule in place of the reference's backend and environment switches (the
decode head passes `kernels.midx_probs.ops.proposal_tables`, which lands
here, as its `tables_fn`):
  - a CUDA tensor -> the hand-written kernel (it launches or raises);
  - a CPU tensor  -> the kernel's plain torch version;
  - anything else -> an error.
There is no fallback from a failed build or launch to the plain version,
and no interpret mode.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.midx_probs.ref import midx_probs_ref


def midx_probs(z: torch.Tensor, cb1: torch.Tensor, cb2: torch.Tensor,
               counts: torch.Tensor, *, split: bool):
    """(s1, s2, log_psi [T, K], lse [T]) for z [T, D]."""
    if z.is_cuda:
        from repro_torch.kernels.midx_probs.cuda import midx_probs_cuda
        return midx_probs_cuda(z, cb1, cb2, counts, split=split)
    if z.device.type == "cpu":
        return midx_probs_ref(z, cb1, cb2, counts, split=split)
    raise RuntimeError(f"midx_probs has no implementation for {z.device}")
