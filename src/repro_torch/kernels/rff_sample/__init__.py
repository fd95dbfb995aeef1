"""The fused RFF Gumbel-top-m sampler: `csrc/rff_sample.cu` (CUDA, built
by `cuda.py`), its plain version `ref.py`, and the wrapper `ops.py`
(mirrors `src/repro/kernels/rff_sample/`)."""
