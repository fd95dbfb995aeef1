"""The inverted multi-index: K-means, quantizers, CSR build (mirrors
`src/repro/index/`)."""
from repro_torch.index.build import MultiIndex, build, reassign, refresh
