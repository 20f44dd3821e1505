"""Feature detectors for the FID family (port of `tdgp/metrics/detectors.py`).

    detector(images uint8 [N, H, W, 3]) -> features [N, D]

`RandomProjectionDetector` is the JAX runs' FID proxy (the repo has no
InceptionV3 weights): images average-pooled to 32x32, flattened and
multiplied by a fixed Gaussian projection. Its projection is the JAX
package's own, `jax.random.normal(PRNGKey(seed), (3072, D)) / sqrt(3072)`,
drawn here without JAX by `jax_normal` (threefry-2x32 in numpy), so that
the port's numbers stand beside the JAX runs' curves.
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import scipy.special
import torch

from tdgp_torch.utils.misc import exact_fp32

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011), as jax.random's
    `threefry_2x32` computes it, on uint32 arrays."""
    ks = [np.uint32(k0), np.uint32(k1), np.uint32(k0 ^ k1 ^ 0x1BD11BDA)]
    x0, x1 = x0 + ks[0], x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def jax_normal(seed: int, shape: Sequence[int]) -> np.ndarray:
    """`jax.random.normal(jax.random.PRNGKey(seed), shape)` (float32) under
    the partitionable threefry (`jax_threefry_partitionable`, on by
    default since JAX 0.5): each element's 32 random bits are the two threefry words
    of its flat index, xor'ed; a float in [1, 2) from their top 23 bits,
    mapped to [nextafter(-1, 0), 1), then sqrt(2) erfinv. erfinv is taken in
    float64 here; XLA's float32 approximation differs by ~1e-5."""
    size = int(np.prod(shape))
    if size >= 2 ** 32:
        raise ValueError(f'{size} elements: the counter needs its high word')
    with np.errstate(over='ignore'):
        b0, b1 = threefry2x32(0, seed, np.zeros(size, np.uint32),
                              np.arange(size, dtype=np.uint32))
    bits = b0 ^ b1
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = np.maximum(lo, floats * (np.float32(1) - lo) + lo)
    z = np.sqrt(2.0) * scipy.special.erfinv(u.astype(np.float64))
    return z.astype(np.float32).reshape(tuple(shape))


class RandomProjectionDetector:
    """Average pool to `image_size`^2, then a fixed random projection to
    `feature_dim` features, on `device`."""

    def __init__(self, feature_dim: int = 64, seed: int = 0, image_size: int = 32,
                 device: Union[str, torch.device] = 'cpu'):
        self.feature_dim = feature_dim
        self.image_size = image_size
        d_in = image_size * image_size * 3
        proj = jax_normal(seed, (d_in, feature_dim)) / np.float32(np.sqrt(d_in))
        self.proj = torch.from_numpy(proj).to(device)

    @torch.no_grad()
    def __call__(self, images) -> torch.Tensor:
        x = torch.as_tensor(images).to(self.proj.device, torch.float32) / 255.0
        n, h, w, c = x.shape
        s = self.image_size
        fh, fw = h // s, w // s
        if fh > 1 or fw > 1:
            x = x[:, :fh * s, :fw * s].reshape(n, s, fh, s, fw, c).mean(dim=(2, 4))
        with exact_fp32():
            return x.reshape(n, -1) @ self.proj
