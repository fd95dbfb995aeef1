"""The fused MIDX proposal-table kernel: `csrc/midx_probs.cu` (CUDA, built
by `cuda.py`), its plain version `ref.py`, and the differentiable wrapper
`ops.py` (mirrors `src/repro/kernels/midx_probs/`)."""
