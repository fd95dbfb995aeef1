"""Plain torch version of the fused RFF Gumbel-top-m sampling kernel.

Mirrors `src/repro/kernels/rff_sample/ref.py` (`rff_scores` :58,
`rff_gumbel_ref` :64). The CPU tests run it, `chip_smoke.py` holds the CUDA
kernel against it on the card, and `kernels.dispatch.rff_sample` takes it
for a CPU tensor. The main path never calls it on a CUDA tensor.

The noise is the reference's counter hash, from the port's one copy of it
(`core.noise.gumbel_noise`), so a draw here is the reference's draw up to
the float32 `log` of two libraries and the order of the dot. Departure:
the reference keys the whole call by one int32 seed and the row index
(t = 0..T-1); here each row has its own seed and row counter, `seeds [T]`
and `t_ids [T]`. The reference's call is the case seeds = full(seed),
t_ids = arange(T); the port's proposals key each row by its own stream key
with t_ids = 0, so a row's draws never depend on the other rows.

Tie rule (what the kernel's blocked running argmax implements): the
winning column of a draw is the minimum column among the global maxima of
the perturbed logits.
"""
from __future__ import annotations

import torch

from repro_torch.core import noise


def rff_scores(phi_z: torch.Tensor, phi_c: torch.Tensor) -> torch.Tensor:
    """Unnormalised log proposal scores log max(φ(z)·φ(c), 1e-8), fp32.
    phi_z [T, 2R], phi_c [N, 2R] -> [T, N]."""
    s = phi_z.float() @ phi_c.float().T
    return torch.log(torch.clamp(s, min=1e-8))


def rff_gumbel_ref(phi_z: torch.Tensor, phi_c: torch.Tensor, seeds, t_ids,
                   m: int):
    """Gumbel-top-m: (ids [T, m] int32, score [T, m], lse [T]). `score` is
    the unperturbed logit of each drawn id, `lse` the log normaliser over
    the N columns in the kernel's form m_run + log max(l_run, 1e-30)
    (`src/repro/kernels/rff_sample/ops.py:58`); log q = score − lse. The
    draws loop in chunks (`noise.gumbel_max_draws`): never [T, m, N]."""
    logits = rff_scores(phi_z, phi_c)                            # [T, N]
    ids = noise.gumbel_max_draws(logits, seeds, t_ids, m)
    score = torch.gather(logits, 1, ids)
    top = torch.amax(logits, dim=-1, keepdim=True)
    total = torch.sum(torch.exp(logits - top), dim=-1)
    lse = top[:, 0] + torch.log(torch.clamp(total, min=1e-30))
    return ids.to(torch.int32), score, lse


def perturbed_values(logits: torch.Tensor, seeds, t_ids,
                     ids: torch.Tensor) -> torch.Tensor:
    """logits[t, id] + g(seeds[t], t_ids[t], d, id) for each draw d of ids
    [T, m]: the value the Gumbel-max compared. Two implementations' ids
    may differ only where these values of both ids are a near-tie."""
    d = torch.arange(ids.shape[1], device=ids.device)[None, :]
    ids = ids.long()
    seed = torch.as_tensor(seeds, device=ids.device).reshape(-1, 1)
    row = torch.as_tensor(t_ids, device=ids.device).reshape(-1, 1)
    return (torch.gather(logits, 1, ids)
            + noise.gumbel_noise(seed, row, d, ids))
