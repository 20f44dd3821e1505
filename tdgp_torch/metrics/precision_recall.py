"""Improved precision and recall (port of `tdgp/metrics/precision_recall.py`).

A sample is covered by a set if it lies within the k-th nearest neighbour
distance (its radius) of some member of that set. The JAX function builds
a [1024, N, D] difference tensor per block of rows, about 420 GB at
N = 50,000 and D = 2048; here the same float32 distances are taken block
by block on the features' device by `torch.cdist` without the
matrix-product expansion (that expansion moves distances near a radius
across the `<=` test), each block [rows, N].
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

BLOCK_ELEMENTS = 2 ** 26  # distances held at once: [rows, N]


def _rows(n: int) -> int:
    return max(1, min(n, BLOCK_ELEMENTS // max(n, 1)))


def _distances(queries: torch.Tensor, refs: torch.Tensor) -> torch.Tensor:
    return torch.cdist(queries[None], refs[None], compute_mode='donot_use_mm_for_euclid_dist')[0]


def kth_nn_radius(features: torch.Tensor, k: int) -> torch.Tensor:
    """The distance of each feature to its k-th nearest other feature (the
    (k + 1)-th smallest, the first being itself at 0), float64 [N]."""
    n = features.shape[0]
    rows = _rows(n)
    return torch.cat([torch.kthvalue(_distances(features[i:i + rows], features), k + 1,
                                     dim=1).values.double() for i in range(0, n, rows)])


def fraction_covered(queries: torch.Tensor, refs: torch.Tensor, radii: torch.Tensor) -> float:
    """The share of queries within the radius of at least one reference."""
    rows = _rows(refs.shape[0])
    hits = sum(int((_distances(queries[i:i + rows], refs) <= radii[None, :]).any(dim=1).sum())
               for i in range(0, queries.shape[0], rows))
    return hits / queries.shape[0]


def compute_pr(real_features: np.ndarray, gen_features: np.ndarray, nhood_size: int = 3,
               device: Union[str, torch.device] = 'cpu') -> Tuple[float, float]:
    """(precision, recall) of float32 features [N, D], computed on `device`."""
    real = torch.as_tensor(np.asarray(real_features, np.float32), device=device)
    gen = torch.as_tensor(np.asarray(gen_features, np.float32), device=device)
    with torch.no_grad():
        real_radii = kth_nn_radius(real, nhood_size)
        gen_radii = kth_nn_radius(gen, nhood_size)
        precision = fraction_covered(gen, real, real_radii)
        recall = fraction_covered(real, gen, gen_radii)
    return float(precision), float(recall)
