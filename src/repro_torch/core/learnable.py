"""Learnable codebooks (paper §6.2.3): codewords as trainable parameters.

Mirrors `src/repro/core/learnable.py:21-101`. Instead of K-means alone,
the codewords C1, C2 are optimised jointly with the model by
  L_recon = mean_i ‖q̂_i − q_i‖²  with soft assignments w_k = softmax(q_iᵀ c_k)
  L_KL    = KL(P(·|z) ‖ P̂(·|z)) where P̂ scores the reconstructions q̂
The KL term directly shrinks the sampler's proposal divergence (Theorems
5/13). Hard assignments for the sampling index are refreshed from the
learned codewords, assign-only (`index_from_learnable`: the port's
`index.kmeans._assign` and `index.build.from_quantization`, no k-means).

Departures: `LearnableCodebooks` is a frozen dataclass of tensors whose
`kind` is metadata (the reference registers it as a pytree node with
`kind` a meta field, which the checkpoint format prints,
`checkpoint.manager._treedef_str`); `init_learnable` draws from a
`torch.Generator` where the reference splits a JAX key.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.index.build import MultiIndex, from_quantization
from repro_torch.index.kmeans import _assign
from repro_torch.index.quantization import Quantization


@dataclasses.dataclass(frozen=True)
class LearnableCodebooks:
    kind: str                    # 'pq' | 'rq' (metadata)
    codebook1: torch.Tensor      # [K, D or D/2]
    codebook2: torch.Tensor      # [K, D or D/2]


#: The data fields, in the reference's flatten order.
CODEBOOK_FIELDS = ("codebook1", "codebook2")


def init_learnable(gen: torch.Generator, d: int, k: int, kind: str = "rq",
                   scale: float = 0.02, device=None) -> LearnableCodebooks:
    dim = d // 2 if kind == "pq" else d
    return LearnableCodebooks(
        kind,
        scale * torch.randn((k, dim), generator=gen, device=device),
        scale * torch.randn((k, dim), generator=gen, device=device))


def from_index(index: MultiIndex) -> LearnableCodebooks:
    """Warm-start learnable codebooks from a fitted (k-means) index: the
    paper's setting, K-means init then KL + recon fine-tuning (§6.2.3)."""
    return LearnableCodebooks(index.kind, index.codebook1, index.codebook2)


def soft_reconstruct(cb: LearnableCodebooks, q: torch.Tensor) -> torch.Tensor:
    """q̂_i = [Σ w1 c1 ⊕ Σ w2 c2] (pq) or Σ w1 c1 + Σ w2 c2 (rq)."""
    q = q.float()
    if cb.kind == "pq":
        d = q.shape[-1]
        q1, q2 = q[..., : d // 2], q[..., d // 2:]
        w1 = torch.softmax(q1 @ cb.codebook1.T, dim=-1)
        w2 = torch.softmax(q2 @ cb.codebook2.T, dim=-1)
        return torch.cat([w1 @ cb.codebook1, w2 @ cb.codebook2], dim=-1)
    w1 = torch.softmax(q @ cb.codebook1.T, dim=-1)
    r1 = w1 @ cb.codebook1
    w2 = torch.softmax((q - r1) @ cb.codebook2.T, dim=-1)
    return r1 + w2 @ cb.codebook2


def reconstruction_loss(cb: LearnableCodebooks,
                        q: torch.Tensor) -> torch.Tensor:
    diff = soft_reconstruct(cb, q) - q.float()
    return torch.mean(torch.sum(diff * diff, dim=-1))


def kl_loss(cb: LearnableCodebooks, z: torch.Tensor,
            q: torch.Tensor) -> torch.Tensor:
    """KL(P ‖ P̂) between the true softmax and the reconstructed-embedding
    softmax over the given class set. z [..., D], q [N, D]."""
    z = z.float()
    q_hat = soft_reconstruct(cb, q)
    log_p = torch.log_softmax(z @ q.float().T, dim=-1)
    log_p_hat = torch.log_softmax(z @ q_hat.T, dim=-1)
    return torch.mean(torch.sum(torch.exp(log_p) * (log_p - log_p_hat),
                                dim=-1))


def codebook_losses(cb: LearnableCodebooks, z: torch.Tensor, q: torch.Tensor,
                    recon_weight: float = 1.0, kl_weight: float = 1.0):
    lr = reconstruction_loss(cb, q)
    lk = kl_loss(cb, z, q)
    return recon_weight * lr + kl_weight * lk, {"recon": lr, "kl": lk}


def index_from_learnable(cb: LearnableCodebooks,
                         q: torch.Tensor) -> MultiIndex:
    """Hard-assign classes to the learned codewords and build the CSR
    index."""
    q = q.float()
    if cb.kind == "pq":
        d = q.shape[-1]
        a1 = _assign(q[:, : d // 2], cb.codebook1)
        a2 = _assign(q[:, d // 2:], cb.codebook2)
        recon = torch.cat([cb.codebook1[a1], cb.codebook2[a2]], dim=-1)
    else:
        a1 = _assign(q, cb.codebook1)
        a2 = _assign(q - cb.codebook1[a1], cb.codebook2)
        recon = cb.codebook1[a1] + cb.codebook2[a2]
    return from_quantization(Quantization(cb.kind, cb.codebook1, cb.codebook2,
                                          a1, a2, q - recon))
