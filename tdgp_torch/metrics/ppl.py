"""Perceptual path length (a copy of `tdgp/metrics/ppl.py`): w-space
endpoints, epsilon 1e-4, the perceptual detector injected."""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def compute_ppl(sample_pair_fn: Callable, detector: Callable, *,
                num_samples: int = 2048, batch_size: int = 16, epsilon: float = 1e-4,
                seed: int = 0) -> float:
    """sample_pair_fn(batch, seed) -> (img_t, img_t_eps), uint8 [N, H, W, 3]
    images rendered at interpolation t and t + epsilon with the same noise;
    detector(images) -> perceptual features [N, D]. The mean of the squared
    feature distances over epsilon^2, without those below their 1st and
    above their 99th percentile."""
    dists = []
    n_done = 0
    s = seed
    while n_done < num_samples:
        img0, img1 = sample_pair_fn(batch_size, s)
        f0 = _numpy(detector(img0))
        f1 = _numpy(detector(img1))
        d = np.sum(np.square(f0 - f1), axis=1) / (epsilon ** 2)
        dists.append(d)
        n_done += batch_size
        s += 1
    dist = np.concatenate(dists)[:num_samples]
    lo = np.percentile(dist, 1, method='lower')
    hi = np.percentile(dist, 99, method='higher')
    return float(np.extract(np.logical_and(dist >= lo, dist <= hi), dist).mean())
