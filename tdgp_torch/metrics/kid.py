"""Kernel Inception Distance (a copy of `tdgp/metrics/kid.py`)."""
from __future__ import annotations

import numpy as np


def compute_kid(real_features: np.ndarray, gen_features: np.ndarray,
                num_subsets: int = 100, max_subset_size: int = 1000,
                seed: int = 0) -> float:
    """The polynomial-kernel MMD, averaged over `num_subsets` random subsets
    of up to `max_subset_size` features of each set, drawn by
    `np.random.RandomState(seed)` as the JAX package draws them."""
    n = real_features.shape[1]
    m = min(min(real_features.shape[0], gen_features.shape[0]), max_subset_size)
    rs = np.random.RandomState(seed)
    t = 0.0
    for _ in range(num_subsets):
        x = gen_features[rs.choice(gen_features.shape[0], m, replace=False)]
        y = real_features[rs.choice(real_features.shape[0], m, replace=False)]
        a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
        b = (x @ y.T / n + 1) ** 3
        t += (a.sum() - np.trace(a)) / (m - 1) - b.sum() * 2 / m
    return float(t / num_subsets / m)
