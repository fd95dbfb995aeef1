"""Hand-written Hopper kernels and their plain torch versions (mirrors
`src/repro/kernels/`); `dispatch.py` picks one by the tensor's device."""
