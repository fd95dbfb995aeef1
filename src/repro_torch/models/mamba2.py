"""Mamba2 / SSD block (arXiv:2405.21060), chunked matmul formulation.

Mirrors `src/repro/models/mamba2.py`: `mamba2_init` (:23), `_causal_conv`
(:50), `_gated_norm` (:58), `apply_mamba2` (:65, with the `return_state`
carry :125-137), `mamba2_decode_state` (:140), `_conv_step` (:153) and
`decode_mamba2` (:160). Projections are split per segment (z | x | B | C
| dt), B and C are shared by all heads (ngroups = 1), and linear weights
are [in, out] as in the reference, so `repro_torch.bridge` carries them
unchanged. `a_log = log(1..H)`, `dt_bias = 0`, `d_skip = 1` and
`norm_scale = 1` are deterministic, as there.

The chunked scan (reference :94-119, its own `lax.scan`) goes through
`kernels.ssd_scan.ops.SsdScanFn`: on the card the hand-written CUDA kernel,
on the CPU its plain version. That plain version departs from the
reference in one place, and the gradients with it: the intra-chunk decay
is masked before its exponential, where the reference's
`where(mask, exp(decay), 0)` (:108) gives NaN gradients in `a_log`,
`dt_bias` and `dt_proj` once a chunk is long enough for exp(decay) to
overflow above the diagonal (at the configured chunk of 256 it is). The
forward values are the same (`kernels/ssd_scan/ref.py`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ops import ssd_scan_op
from repro_torch.models.layers import dense_init


def mamba2_init(gen: torch.Generator, d_model: int, *, d_state: int,
                head_dim: int, expand: int, conv_width: int,
                device) -> dict:
    d_inner = expand * d_model
    nheads = d_inner // head_dim

    def normal(*shape):
        return 0.1 * torch.randn(shape, generator=gen, device=device,
                                 dtype=torch.float32)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=device)

    return {
        "z_proj": dense_init(gen, d_model, d_inner, device=device),
        "x_proj": dense_init(gen, d_model, d_inner, device=device),
        "b_proj": dense_init(gen, d_model, d_state, device=device),
        "c_proj": dense_init(gen, d_model, d_state, device=device),
        "dt_proj": dense_init(gen, d_model, nheads, device=device),
        "conv_x": normal(conv_width, d_inner),
        "conv_x_b": zeros(d_inner),
        "conv_b": normal(conv_width, d_state),
        "conv_b_b": zeros(d_state),
        "conv_c": normal(conv_width, d_state),
        "conv_c_b": zeros(d_state),
        "a_log": torch.log(torch.arange(1, nheads + 1, dtype=torch.float32,
                                        device=device)),
        "dt_bias": zeros(nheads),
        "d_skip": torch.ones((nheads,), dtype=torch.float32, device=device),
        "norm_scale": torch.ones((d_inner,), dtype=torch.float32,
                                 device=device),
        "out_proj": dense_init(gen, d_inner, d_model, device=device),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus's form: log1p(exp(-|x|)) + max(x, 0)."""
    return torch.log1p(torch.exp(-x.abs())) + x.clamp(min=0)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along seq. x [B,S,C]; w [W,C]; silu."""
    width, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = pad[:, 0:s, :] * w[0]
    for i in range(1, width):
        out = out + pad[:, i:i + s, :] * w[i]
    return F.silu(out + b)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """y ⊙ silu(z), then RMSNorm over d_inner (mamba2's gated norm)."""
    g = (y * F.silu(z)).float()
    var = torch.mean(g * g, dim=-1, keepdim=True)
    return (g * torch.rsqrt(var + eps) * scale).to(y.dtype)


def apply_mamba2(p: dict, x: torch.Tensor, *, d_state: int, head_dim: int,
                 expand: int, chunk: int = 256, return_state: bool = False):
    """x [B,S,D] -> [B,S,D].

    return_state=True also returns the single-step decode carry after the
    whole sequence, the dict `mamba2_decode_state` allocates: the last W−1
    pre-conv inputs of each conv (left-padded with zeros when S < W−1) and
    the scan's h_last."""
    bsz, s, d_model = x.shape
    d_inner = expand * d_model
    nheads = d_inner // head_dim
    dt_ = x.dtype
    if chunk < 1 or s % chunk:
        raise ValueError(f"apply_mamba2 needs S % chunk == 0, got S={s} "
                         f"chunk={chunk}")

    z = x @ p["z_proj"].to(dt_)
    u_x = x @ p["x_proj"].to(dt_)
    u_b = x @ p["b_proj"].to(dt_)
    u_c = x @ p["c_proj"].to(dt_)
    xs = _causal_conv(u_x, p["conv_x"].to(dt_), p["conv_x_b"].to(dt_))
    bmat = _causal_conv(u_b, p["conv_b"].to(dt_),
                        p["conv_b_b"].to(dt_)).float()             # [B,S,N]
    cmat = _causal_conv(u_c, p["conv_c"].to(dt_),
                        p["conv_c_b"].to(dt_)).float()             # [B,S,N]
    dt = _softplus((x @ p["dt_proj"].to(dt_)).float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])                                     # [H]
    xh = xs.reshape(bsz, s, nheads, head_dim).float()              # [B,S,H,P]
    y, h_last = ssd_scan_op(xh, bmat, cmat, a * dt, dt, chunk)
    y = y + p["d_skip"][None, None, :, None] * xh
    y = y.reshape(bsz, s, d_inner).to(dt_)
    y = _gated_norm(y, z, p["norm_scale"])
    out = y @ p["out_proj"].to(dt_)
    if not return_state:
        return out

    w1 = p["conv_x"].shape[0] - 1

    def hist(u):
        u = F.pad(u, (0, 0, max(0, w1 - s), 0))
        return u[:, u.shape[1] - w1:]

    state = {"conv_x": hist(u_x), "conv_b": hist(u_b), "conv_c": hist(u_c),
             "ssm": h_last}
    return out, state


def mamba2_decode_state(bsz: int, d_model: int, *, d_state: int,
                        head_dim: int, expand: int, conv_width: int,
                        dtype=torch.float32, device=None) -> dict:
    d_inner = expand * d_model
    nheads = d_inner // head_dim
    w = conv_width - 1
    return {
        "conv_x": torch.zeros((bsz, w, d_inner), dtype=dtype, device=device),
        "conv_b": torch.zeros((bsz, w, d_state), dtype=dtype, device=device),
        "conv_c": torch.zeros((bsz, w, d_state), dtype=dtype, device=device),
        "ssm": torch.zeros((bsz, nheads, d_state, head_dim),
                           dtype=torch.float32, device=device),
    }


def _conv_step(hist: torch.Tensor, cur: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor):
    """hist [B,W-1,C], cur [B,C] -> (out [B,C], new hist)."""
    full = torch.cat([hist, cur[:, None, :].to(hist.dtype)], dim=1)
    out = torch.sum(full * w[None], dim=1) + b
    return F.silu(out), full[:, 1:]


def decode_mamba2(p: dict, x: torch.Tensor, state: dict, *, d_state: int,
                  head_dim: int, expand: int):
    """Single-token step. x [B,1,D] -> (y [B,1,D], new state)."""
    bsz, _, d_model = x.shape
    d_inner = expand * d_model
    nheads = d_inner // head_dim
    dt_ = x.dtype
    x0 = x[:, 0]

    def conv(name, u):
        cdt = state[name].dtype
        return _conv_step(state[name], u, p[name].to(cdt),
                          p[name + "_b"].to(cdt))

    z = x0 @ p["z_proj"].to(dt_)
    xs, conv_x = conv("conv_x", x0 @ p["x_proj"].to(dt_))
    bvec, conv_b = conv("conv_b", x0 @ p["b_proj"].to(dt_))
    cvec, conv_c = conv("conv_c", x0 @ p["c_proj"].to(dt_))
    bvec, cvec = bvec.float(), cvec.float()
    dt = _softplus((x0 @ p["dt_proj"].to(dt_)).float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    xh = xs.reshape(bsz, nheads, head_dim).float()

    decay = torch.exp(a[None] * dt)                                # [B,H]
    h_new = (decay[:, :, None, None] * state["ssm"]
             + bvec[:, None, :, None] * (dt[:, :, None] * xh)[:, :, None, :])
    y = torch.einsum("bn,bhnp->bhp", cvec, h_new)
    y = y + p["d_skip"][None, :, None] * xh
    y = y.reshape(bsz, d_inner).to(dt_)
    y = _gated_norm(y, z, p["norm_scale"])
    out = (y @ p["out_proj"].to(dt_))[:, None, :]
    return out, {"conv_x": conv_x, "conv_b": conv_b, "conv_c": conv_c,
                 "ssm": h_new}
