"""Re-export shim: K-means lives in `repro_torch.index.kmeans`.

Mirrors `src/repro/core/kmeans.py` (the old import path,
`from repro.core import kmeans`, kept after the move to `repro.index`,
DESIGN §8). New code imports from `repro_torch.index`.
"""
from repro_torch.index.kmeans import KMeansResult, _assign, _update, kmeans

__all__ = ["KMeansResult", "kmeans", "_assign", "_update"]
