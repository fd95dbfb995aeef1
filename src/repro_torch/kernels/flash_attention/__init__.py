"""Flash attention: the CUDA forward `csrc/flash_attention.cu` (built by
`cuda.py`), its plain versions `ref.py`, and the differentiable wrapper
`ops.py` with the blockwise-recompute backward (mirrors
`src/repro/kernels/flash_attention/` and the chunked path of
`src/repro/models/attention.py`)."""
