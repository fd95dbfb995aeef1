"""Public wrapper: fused RFF Gumbel-top-m sampling.

Mirrors `src/repro/kernels/rff_sample/ops.py::rff_gumbel_sample` (:36).
Drawing ids is not differentiable, and log q is a constant of the loss (the
importance correction enters through the corrected logits), so, as the
reference stop-gradients its inputs (:43-45), this wrapper detaches them
and needs no autograd.Function. The device decides the implementation
(`kernels.dispatch.rff_sample`): the CUDA kernel for a CUDA tensor, the
plain version for a CPU tensor. There is no `use_kernel` or `interpret`
switch and no padding: the kernel masks the ragged edges itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch


def rff_gumbel_sample(phi_z: torch.Tensor, phi_c: torch.Tensor,
                      seeds: torch.Tensor, t_ids: torch.Tensor, m: int):
    """phi_z [T, 2R], phi_c [N, 2R]; seeds, t_ids [T] int64 (row t's hash
    seed and row counter). Returns (ids [T, m] int32, log_q [T, m] fp32):
    m iid draws per row from softmax(log max(φ(z)·φ(c), 1e-8)) with their
    exact log-probs."""
    def prep(x, dtype):
        return x.detach().to(dtype).contiguous()

    return dispatch.rff_sample(prep(phi_z, torch.float32),
                               prep(phi_c, torch.float32),
                               prep(seeds, torch.int64),
                               prep(t_ids, torch.int64), m)
