"""The sampled-softmax CE kernels, per-token (`csrc/sampled_ce_pt.cu`) and
shared-negative (`csrc/sampled_ce.cu`): CUDA forward and backward, built by
`cuda.py`, their plain versions `ref.py`, and the differentiable wrappers
`ops.py` (mirrors `src/repro/kernels/sampled_ce/`)."""
