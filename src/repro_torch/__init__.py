"""repro_torch — the PyTorch / CUDA port of `repro` for NVIDIA Hopper.

A package of its own beside the JAX reference (`src/repro/`), mirrored
module for module: each file's docstring names the reference file it
mirrors and where it departs. It imports torch and never jax, nor anything
of `repro`. The kernels — the head's `midx_probs`
(`kernels/midx_probs/`), the per-token and shared-negative sampled CEs
with their backwards (`kernels/sampled_ce/`) and the RFF sampler
(`kernels/rff_sample/`), the long-context attention forward
(`kernels/flash_attention/`) and mamba2's chunked SSD scan
(`kernels/ssd_scan/`) — are CUDA C++ built at first use;
everything else is plain torch ops.

Entry points (`init_params`, `serve.Engine`, `launch.serve`) run on the
card unless the caller asks for the CPU: `device=None` means "cuda", and
with no CUDA device they raise instead of carrying on on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> the card. Raises when the card is asked for (explicitly or
    by default) and torch sees no CUDA device; "cpu" must be asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' (CLI: --device cpu) to run on the "
            "CPU")
    return dev
