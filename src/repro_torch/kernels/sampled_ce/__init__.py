"""The per-token sampled-softmax CE kernels: `csrc/sampled_ce_pt.cu` (CUDA,
forward and backward, built by `cuda.py`), their plain versions `ref.py`,
and the differentiable wrapper `ops.py` (mirrors
`src/repro/kernels/sampled_ce/` for the per-token op)."""
