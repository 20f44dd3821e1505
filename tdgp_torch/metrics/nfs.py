"""Non-flatness score (a copy of `tdgp/metrics/nfs.py`).

NFS = the mean over images of exp(entropy of the image's depth histogram),
the histogram taken over the fixed [min_depth, max_depth] range of the
rendering frustum: a flat scene puts all its mass in one bin (entropy 0,
NFS 1); depth spread over the frustum raises it.
"""
from __future__ import annotations

import numpy as np


def compute_nfs_from_depth_maps(depth_maps: np.ndarray, min_depth: float,
                                max_depth: float, num_bins: int = 64,
                                eps: float = 1e-12) -> float:
    """depth_maps: [N, H, W] (or [N, P]) rendered frontal depths, in float64."""
    n = depth_maps.shape[0]
    d = np.clip(np.asarray(depth_maps).reshape(n, -1).astype(np.float64), min_depth, max_depth)
    scores = np.empty(n)
    for i in range(n):
        hist, _ = np.histogram(d[i], bins=num_bins, range=(min_depth, max_depth))
        p = hist / hist.sum()
        entropy = -(p * np.log(p + eps)).sum()
        scores[i] = np.exp(entropy)
    return float(scores.mean())
