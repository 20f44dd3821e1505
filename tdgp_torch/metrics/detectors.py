"""Feature detectors of the metrics (port of `tdgp/metrics/detectors.py`).

    detector(images uint8 [N, H, W, 3]) -> features [N, D]

`load_inception_detector` builds the FID InceptionV3
(`tdgp_torch.metrics.inception`) from converted weights, the `.npz` that
`scripts/convert_inception.py` writes and `TDGP_INCEPTION_WEIGHTS` names;
the repo holds none, and without them it raises FileNotFoundError, as the
JAX package's does. `RandomProjectionDetector` is then the JAX runs' FID
proxy: images average-pooled to 32x32, flattened and multiplied by a fixed
Gaussian projection. Its projection is the JAX package's own,
`jax.random.normal(PRNGKey(seed), (3072, D)) / sqrt(3072)`, drawn here
without JAX by `jax_normal` (threefry-2x32 in numpy), so that the port's
numbers stand beside the JAX runs' curves. `split` and `jax_uniform` draw
as `jax.random.split` and `jax.random.uniform` do (PPL's pairs).
"""
from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple, Union

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


JaxKey = Tuple[int, int]


def prng_key(seed: int) -> JaxKey:
    """`jax.random.PRNGKey(seed)` for 0 <= seed < 2^32: the two words (0, seed)."""
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f'seed {seed} outside [0, 2^32)')
    return 0, seed


def _threefry_counts(key: JaxKey, size: int):
    """The two threefry words of the flat indices 0 .. size - 1 under `key`
    (the partitionable threefry's counter: high word 0, low word the index)."""
    if size >= 2 ** 32:
        raise ValueError(f'{size} elements: the counter needs its high word')
    with np.errstate(over='ignore'):
        return threefry2x32(key[0], key[1], np.zeros(size, np.uint32),
                            np.arange(size, dtype=np.uint32))


def split(key: JaxKey, num: int = 2) -> List[JaxKey]:
    """`jax.random.split(key, num)`: key i is the two threefry words of index i."""
    b0, b1 = _threefry_counts(key, num)
    return [(int(x), int(y)) for x, y in zip(b0, b1)]


def _unit_floats(key: JaxKey, shape: Sequence[int]) -> np.ndarray:
    """Floats in [0, 1) from the top 23 of each element's 32 random bits (the
    two threefry words of its flat index, xor'ed), float32."""
    b0, b1 = _threefry_counts(key, int(np.prod(shape)))
    bits = b0 ^ b1
    return ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)


def jax_uniform(key: JaxKey, shape: Sequence[int]) -> np.ndarray:
    """`jax.random.uniform(key, shape)` (float32 in [0, 1))."""
    return np.maximum(np.float32(0), _unit_floats(key, shape)).reshape(tuple(shape))


def jax_normal(seed: Union[int, JaxKey], shape: Sequence[int]) -> np.ndarray:
    """`jax.random.normal(jax.random.PRNGKey(seed), shape)` (float32), or of
    a key from `split`, under the partitionable threefry
    (`jax_threefry_partitionable`, on by default since JAX 0.5): a uniform
    float in [nextafter(-1, 0), 1), then sqrt(2) erfinv. erfinv is taken in
    float64 here; XLA's float32 approximation differs by ~1e-5."""
    key = prng_key(int(seed)) if isinstance(seed, (int, np.integer)) else seed
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = np.maximum(lo, _unit_floats(key, shape) * (np.float32(1) - lo) + lo)
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


def load_inception_detector(weights_path: Optional[str] = None,
                            fid_pool: Optional[bool] = None,
                            device: Union[str, torch.device] = 'cpu') -> Callable:
    """The FID InceptionV3 from converted weights, on `device`: its pool
    features [N, 2048]. `weights_path` defaults to $TDGP_INCEPTION_WEIGHTS;
    FileNotFoundError without a file. `fid_pool` (pytorch-fid's
    count_include_pad=False branch pools, for the pt_inception-2015-12-05
    weights) resolves in the JAX package's order: the argument, then
    $TDGP_INCEPTION_FID_POOL, then the `__meta__/fid_pool` marker of the
    `.npz`, then False (torchvision's weights)."""
    from tdgp_torch.metrics import inception
    weights_path = weights_path or os.environ.get('TDGP_INCEPTION_WEIGHTS', '')
    if not weights_path or not os.path.exists(weights_path):
        raise FileNotFoundError(
            'InceptionV3 weights not found. Convert them once with '
            'scripts/convert_inception.py and set TDGP_INCEPTION_WEIGHTS.')
    if fid_pool is None:
        env = os.environ.get('TDGP_INCEPTION_FID_POOL')
        if env is not None:
            fid_pool = env not in ('', '0', 'false', 'False')
        else:
            fid_pool = bool(inception.npz_meta(weights_path).get('fid_pool', False))
    return inception.make_detector(inception.load_weights(weights_path), fid_pool=fid_pool,
                                   device=device)


NO_WEIGHTS_WARNING = 'WARNING: using RandomProjectionDetector (no InceptionV3 weights)'


def make_fid_detector(device: Union[str, torch.device] = 'cpu',
                      warning: str = NO_WEIGHTS_WARNING) -> Callable:
    """The detector of the metric scripts and the training loop, chosen as the
    JAX scripts choose it: InceptionV3 where $TDGP_INCEPTION_WEIGHTS names
    converted weights, else `RandomProjectionDetector(2048)`, `warning`
    printed."""
    try:
        return load_inception_detector(device=device)
    except FileNotFoundError:
        print(warning)
        return RandomProjectionDetector(2048, device=device)
