"""The chunked SSD scan (mamba2's core): the CUDA kernel `csrc/ssd_scan.cu`
(built by `cuda.py`), its plain version `ref.py`, and the differentiable
wrapper `ops.py` (mirrors `src/repro/kernels/ssd_scan/`)."""
