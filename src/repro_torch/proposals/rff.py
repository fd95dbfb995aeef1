"""Random Fourier Features proposals (Rawat et al. 2019).

Mirrors `src/repro/proposals/rff.py:25-81`. q(i|z) ∝ max(φ(z)·φ(c_i), 1e-8)
with φ(x) = [cos(Wx̂); sin(Wx̂)]/√R over the normalised query / table — a
positive-definite softmax-kernel surrogate whose class features φ(C) are
precomputed and re-mapped on refresh.

Two contenders share the state {emb, w, tau, phi_c}:

  rff        plain torch: the [.., N] log p row, then a categorical draw
             (`base.categorical_draw`); log q stays differentiable in z.
  rff-fused  the scores, the Gumbel-top-m and the logsumexp in one kernel
             (`kernels.rff_sample`, through `kernels.dispatch`: the CUDA
             kernel on the card, its plain version on the CPU); the [T, N]
             score matrix never reaches device memory on the card, and log
             q is a constant, as the reference's stop-gradient makes it.

The state's `emb` is a copy of the table at init / refresh: the class
table can be the params' own tensor, which the optimizer updates in place,
and the state holds the table its φ(C) was mapped from, as the
reference's immutable arrays do.

Departures: `rff_init` draws W from an explicit `torch.Generator`; the
fused sampler seeds each row by its own stream key with row counter 0
(`kernels/rff_sample/ref.py`), where the reference folds one key into one
seed for the batch and counts rows 0..T-1.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.rff_sample.ops import rff_gumbel_sample
from repro_torch.proposals.base import Draw, categorical_draw


def rff_map(x: torch.Tensor, w: torch.Tensor,
            tau: torch.Tensor) -> torch.Tensor:
    """φ(x) = [cos(Wx̂); sin(Wx̂)] / √R over the normalised input."""
    xn = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                         min=1e-6)
    proj = torch.sqrt(tau) * (xn @ w.T)
    return torch.cat([torch.cos(proj), torch.sin(proj)],
                     dim=-1) / math.sqrt(w.shape[0])


def rff_init(gen: torch.Generator, class_emb: torch.Tensor, class_freq=None,
             r: int = 32, tau: float = 4.0) -> dict:
    del class_freq                            # the RFF proposal ignores it
    d = class_emb.shape[-1]
    w = torch.randn((r, d), generator=gen, dtype=torch.float32,
                    device=class_emb.device)
    tau_t = torch.tensor(tau, dtype=torch.float32, device=class_emb.device)
    phi_c = rff_map(class_emb.float(), w, tau_t)                 # [N, 2R]
    return {"emb": class_emb.detach().clone(), "w": w, "tau": tau_t,
            "phi_c": phi_c}


def rff_log_p(state: dict, z: torch.Tensor) -> torch.Tensor:
    phi_z = rff_map(z.float(), state["w"], state["tau"])
    scores = torch.clamp(phi_z @ state["phi_c"].T, min=1e-8)      # [..., N]
    return torch.log(scores) - torch.log(torch.sum(scores, dim=-1,
                                                   keepdim=True))


def rff_sample(state: dict, keys: torch.Tensor, z: torch.Tensor,
               m: int) -> Draw:
    return categorical_draw(keys, rff_log_p(state, z), m)


def rff_log_prob(state: dict, z: torch.Tensor,
                 ids: torch.Tensor) -> torch.Tensor:
    return torch.gather(rff_log_p(state, z), -1, ids)


def rff_refresh(state: dict, gen: torch.Generator,
                class_emb: torch.Tensor) -> dict:
    phi_c = rff_map(class_emb.float(), state["w"], state["tau"])
    return {**state, "emb": class_emb.detach().clone(), "phi_c": phi_c}


def rff_fused_sample(state: dict, keys: torch.Tensor, z: torch.Tensor,
                     m: int) -> Draw:
    """The fused draw (the `sample` that the reference's
    `rff_fused_sample_factory` :61 builds; here the device, not a
    `use_kernel` switch, picks the implementation): φ(z) here, then
    `kernels.rff_sample` for z [..., D] and keys [...] -> Draw [..., m].
    Row r's hash seed is keys[r] and its row counter 0."""
    lead = z.shape[:-1]
    phi_z = rff_map(z.float(), state["w"], state["tau"])
    seeds = keys.reshape(-1)
    ids, log_q = rff_gumbel_sample(phi_z.reshape(-1, phi_z.shape[-1]),
                                   state["phi_c"], seeds,
                                   torch.zeros_like(seeds), m)
    return Draw(ids.long().reshape(*lead, m), log_q.reshape(*lead, m))

