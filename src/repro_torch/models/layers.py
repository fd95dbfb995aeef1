"""Layer primitives: norms, MLPs, embeddings, RoPE. Plain dicts of tensors.

Mirrors `src/repro/models/layers.py`. Conventions kept from the reference:
linear weights are [in, out] and apply as `x @ W` (so weights carried across
by `repro_torch.bridge` need no transpose); params are initialized fp32 and
cast to the compute dtype inside apply. Departures: inits draw from an
explicit `torch.Generator` on the target device instead of a JAX key (the
two give different numbers from one seed; tests carry weights across
instead), and GELU is written as the tanh form that `jax.nn.gelu` defaults
to.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def normal(shape, gen: torch.Generator, device) -> torch.Tensor:
    """Standard normal fp32 draws from `gen`; on the meta device (the
    dry run's abstract params) an uninitialised tensor, drawing nothing."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: float | None = None, *, device) -> torch.Tensor:
    scale = scale if scale is not None else d_in ** -0.5
    return scale * normal((d_in, d_out), gen, device)


def embed_init(gen: torch.Generator, n: int, d: int, scale: float = 0.02, *,
               device) -> torch.Tensor:
    return scale * normal((n, d), gen, device)


# ------------------------------------------------------------------- norms
def norm_init(d: int, kind: str = "rmsnorm", *, device) -> dict:
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if kind != "rmsnorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def apply_norm(p: dict, x: torch.Tensor, *, eps: float = 1e-5,
               kind: str = "rmsnorm") -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"]
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return out.to(x.dtype)


# ------------------------------------------------------------------- MLP
def mlp_init(gen: torch.Generator, d: int, d_ff: int, act: str = "silu", *,
             device) -> dict:
    p = {"up": dense_init(gen, d, d_ff, device=device),
         "down": dense_init(gen, d_ff, d, device=device)}
    if act == "silu":                     # SwiGLU
        p["gate"] = dense_init(gen, d, d_ff, device=device)
    return p


def apply_mlp(p: dict, x: torch.Tensor, act: str = "silu",
              d_ff: int | None = None) -> torch.Tensor:
    """The MLP; `d_ff`, its whole width, turns on the model axis: where
    the model ranks split it, gate / up are the rank's columns and down
    its rows, summed over the ranks (`dist.tensor_parallel`)."""
    from repro_torch.dist import tensor_parallel as tp
    dt = x.dtype
    split = d_ff is not None and tp.splits(d_ff)
    if split:
        x = tp.region_in(x)
    if act == "silu":
        h = F.silu(x @ p["gate"].to(dt)) * (x @ p["up"].to(dt))
    else:
        h = F.gelu(x @ p["up"].to(dt), approximate="tanh")
    if split:
        return tp.row_out(h, p["down"], dt)
    return h @ p["down"].to(dt)


# ------------------------------------------------------------------- RoPE
def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [...,] -> cos/sin [..., head_dim/2]."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, hd]; cos/sin [..., S, hd/2] (broadcast over heads)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
