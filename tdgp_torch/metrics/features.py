"""Feature statistics of a dataset and of a generator (port of
`tdgp/metrics/features.py`, for one process).

Detectors are callables `detector(images uint8 [N, H, W, 3]) -> features
[N, D]`. The dataset's statistics are cached under an md5 of their options,
so that each evaluation of a run computes them once.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from tdgp_torch.config import Config
from tdgp_torch.rendering.camera import sample_camera_params
from tdgp_torch.utils.draws import Draws


class FeatureStats:
    """Accumulates up to `max_items` features: their (mean, cov) moments
    (`capture_mean_cov`, FID) and/or the features themselves (`capture_all`,
    KID, precision/recall and IS)."""

    def __init__(self, max_items: Optional[int] = None, capture_all: bool = False,
                 capture_mean_cov: bool = True):
        self.capture_all = capture_all
        self.capture_mean_cov = capture_mean_cov
        self.max_items = max_items
        self.num_items = 0
        self.num_features: Optional[int] = None
        self.all_features: Optional[list] = None
        self.raw_mean = None
        self.raw_cov = None

    def set_num_features(self, num_features: int) -> None:
        if self.num_features is not None:
            if num_features != self.num_features:
                raise ValueError(f'{num_features} features after {self.num_features}')
            return
        self.num_features = num_features
        self.all_features = []
        if self.capture_mean_cov:
            self.raw_mean = np.zeros(num_features, dtype=np.float64)
            self.raw_cov = np.zeros((num_features, num_features), dtype=np.float64)

    def is_full(self) -> bool:
        return self.max_items is not None and self.num_items >= self.max_items

    def append(self, x) -> None:
        x = np.asarray(x, dtype=np.float32)
        if x.ndim != 2:
            raise ValueError(f'features [N, D] expected, got {x.shape}')
        if self.max_items is not None and self.num_items + x.shape[0] > self.max_items:
            if self.num_items >= self.max_items:
                return
            x = x[:self.max_items - self.num_items]
        self.set_num_features(x.shape[1])
        self.num_items += x.shape[0]
        if self.capture_all:
            self.all_features.append(x)
        if self.capture_mean_cov:
            x64 = x.astype(np.float64)
            self.raw_mean += x64.sum(axis=0)
            self.raw_cov += x64.T @ x64

    def get_all(self) -> np.ndarray:
        """The features, float32 [num_items, D]."""
        if not self.capture_all:
            raise ValueError('the features were not captured (capture_all=False)')
        return np.concatenate(self.all_features, axis=0)

    def get_mean_cov(self):
        if not self.capture_mean_cov:
            raise ValueError('the moments were not captured (capture_mean_cov=False)')
        mean = self.raw_mean / self.num_items
        cov = self.raw_cov / self.num_items - np.outer(mean, mean)
        return mean, cov

    def save(self, path: str) -> None:
        with open(path, 'wb') as f:
            pickle.dump(self.__dict__, f)

    @staticmethod
    def load(path: str) -> 'FeatureStats':
        """A cache file that `save` wrote."""
        with open(path, 'rb') as f:
            d = pickle.load(f)
        obj = FeatureStats.__new__(FeatureStats)
        obj.__dict__.update(d)
        return obj


def to_uint8_images(img: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float NHWC -> uint8, truncated as the JAX package converts."""
    return torch.clamp(img * 127.5 + 128, 0, 255).to(torch.uint8)


def cache_key(tag: str, opts: Dict[str, Any]) -> str:
    md5 = hashlib.md5(json.dumps(opts, sort_keys=True, default=str).encode()).hexdigest()
    return f'{tag}-{md5}'


def _features(detector: Callable, images) -> np.ndarray:
    feats = detector(images)
    return feats.cpu().numpy() if isinstance(feats, torch.Tensor) else np.asarray(feats)


def compute_feature_stats_for_dataset(
    dataset, detector: Callable, *, detector_name: str = 'detector',
    batch_size: int = 64, max_items: Optional[int] = None,
    cache_dir: Optional[str] = None, capture_all: bool = False, capture_mean_cov: bool = True,
) -> FeatureStats:
    """The features of the dataset's first `max_items` items (all of them by
    default), in batches of `batch_size`, as `FeatureStats` with what it
    captures; from the cache when it has them."""
    stats_kwargs = dict(capture_all=capture_all, capture_mean_cov=capture_mean_cov)
    cache_file = None
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        key = cache_key('features', dict(dataset=getattr(dataset, 'name', ''),
                                         n=len(dataset), detector=detector_name,
                                         max_items=max_items, **stats_kwargs))
        cache_file = os.path.join(cache_dir, key + '.pkl')
        if os.path.exists(cache_file):
            return FeatureStats.load(cache_file)
    num_items = len(dataset) if max_items is None else min(len(dataset), max_items)
    stats = FeatureStats(max_items=num_items, **stats_kwargs)
    idx = 0
    while not stats.is_full():
        images = [dataset[(idx + i) % len(dataset)]['image'] for i in range(batch_size)]
        idx += batch_size
        stats.append(_features(detector, np.stack(images)))
    if cache_file:
        stats.save(cache_file)
    return stats


def iterate_random_conditioning(cfg: Config, dataset, batch_size: int, seed: int = 0,
                                device='cpu') -> Iterator[Dict[str, Any]]:
    """Random (label, camera) conditioning for sampling G: labels from the
    dataset's distribution (numpy's RandomState(seed)), cameras from the
    prior (a torch.Generator seeded with `seed`, on `device`); for the
    'custom' angle distribution, origin angles from the dataset."""
    rs = np.random.RandomState(seed)
    draws = Draws(torch.Generator(device=device).manual_seed(seed))
    custom_angles = cfg.camera.origin.angles.dist == 'custom'
    if custom_angles and dataset is None:
        raise ValueError("angles dist 'custom' needs a dataset to sample origin angles from")
    while True:
        if dataset is not None and cfg.dataset.c_dim > 0:
            idx = rs.randint(len(dataset), size=batch_size)
            c = torch.as_tensor(np.stack([dataset.get_label(i) for i in idx]), device=device)
        else:
            c = torch.zeros((batch_size, cfg.dataset.c_dim), device=device)
        origin_angles = None
        if custom_angles:
            aidx = rs.randint(len(dataset), size=batch_size)
            origin_angles = torch.as_tensor(np.stack(
                [dataset.get_camera_angles(i) for i in aidx]).astype(np.float32), device=device)
        cam = sample_camera_params(draws.scope('camera'), cfg.camera, batch_size,
                                   origin_angles=origin_angles)
        yield {'c': c, 'camera_params': cam}


def compute_feature_stats_for_generator(
    sample_fn: Callable,  # (batch_size, seed) -> uint8 images [N, H, W, 3]
    detector: Callable, *, batch_size: int = 16, max_items: int = 2048,
    capture_all: bool = False, capture_mean_cov: bool = True,
) -> FeatureStats:
    """The features of `max_items` images of G, sampled with seeds 0, 1, ..."""
    stats = FeatureStats(max_items=max_items, capture_all=capture_all,
                         capture_mean_cov=capture_mean_cov)
    seed = 0
    while not stats.is_full():
        stats.append(_features(detector, sample_fn(batch_size, seed)))
        seed += 1
    return stats
