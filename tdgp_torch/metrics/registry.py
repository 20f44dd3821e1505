"""Metric registry and the generator's samplers (port of
`tdgp/metrics/registry.py`).

Every entry of the JAX registry: the FID family (fid2k_full, the in-loop
metric of the synth presets, fid5k_5k, fid50k_full), KID (kid50k,
kid50k_full), precision/recall (pr50k3, pr50k3_full), the Inception Score
(is50k), the perceptual path length (ppl2_wend) and the non-flatness score
(nfs256, the default in-loop metric beside fid2k_full). Images, pairs and
depth maps are rendered without autograd on G's device, so on the card
they run the served path's kernels (NFS's with K3's cut entry); the
statistics are computed as the JAX package computes them. Where the JAX
package has no sampler (a 2D StyleGAN2 generator), the samplers raise
NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from tdgp_torch.config import Config, is_2d
from tdgp_torch.metrics import fid as fid_mod
from tdgp_torch.metrics import inception_score as is_mod
from tdgp_torch.metrics import kid as kid_mod
from tdgp_torch.metrics import nfs as nfs_mod
from tdgp_torch.metrics import ppl as ppl_mod
from tdgp_torch.metrics import precision_recall as pr_mod
from tdgp_torch.metrics.detectors import jax_normal, jax_uniform, prng_key, split
from tdgp_torch.metrics.features import (compute_feature_stats_for_dataset,
                                         compute_feature_stats_for_generator,
                                         iterate_random_conditioning, to_uint8_images)
from tdgp_torch.models.epigraf import Generator
from tdgp_torch.rendering.camera import get_mean_camera_params
from tdgp_torch.utils.misc import exact_fp32

PPL_EPSILON = 1e-4

_metric_dict: Dict[str, Callable] = {}


def register_metric(fn: Callable) -> Callable:
    _metric_dict[fn.__name__] = fn
    return fn


def list_metrics():
    return list(_metric_dict.keys())


def is_valid_metric(name: str) -> bool:
    return name in _metric_dict


@dataclasses.dataclass
class EvalContext:
    cfg: Config
    G: Generator                             # the EMA generator, on its device
    dataset: Any = None
    detector: Optional[Callable] = None      # images uint8 [N,H,W,3] -> features [N,D]
    ppl_detector: Optional[Callable] = None  # VGG16 for PPL (None: `detector`)
    cache_dir: Optional[str] = None
    batch_size: int = 16
    batch_gpu: Optional[int] = None          # images rendered at once (None: automatic)

    def _resolve_batch_gpu(self) -> int:
        """Images rendered at once: the largest divisor of the batch up to
        `batch_gpu`, by default up to the whole batch below 256^2 and 4 from
        there (the render's peak memory), as in the JAX package."""
        cap = self.batch_gpu
        if cap is None:
            cap = self.batch_size if self.cfg.generator.img_resolution < 256 else 4
        cap = max(1, min(cap, self.batch_size))
        while self.batch_size % cap:
            cap -= 1
        return cap

    @property
    def device(self) -> torch.device:
        return next(self.G.parameters()).device

    def _refuse_2d(self, what: str) -> None:
        if is_2d(self.cfg):
            raise NotImplementedError(
                f'no {what} for the 2D StyleGAN2 model: the JAX package has none either '
                '(tdgp/metrics/registry.py:94-99 renders g.synthesis(ws, camera, ...), which '
                'a 2D generator does not take)')

    def make_image_sampler(self) -> Callable:
        """(batch_size, seed) -> uint8 images [N, H, W, 3] of G on its device.
        z is `jax.random.normal(PRNGKey(seed))`'s draw, as the JAX sampler's;
        labels and cameras come from `iterate_random_conditioning`. The
        render runs without autograd, rays `max_batch_res**2` at a time
        above that, so on the card it runs the served path's kernels."""
        cfg, G = self.cfg, self.G
        self._refuse_2d('image sampler')
        gc = cfg.generator
        device = next(G.parameters()).device
        chunk = gc.max_batch_res ** 2 if gc.img_resolution > gc.max_batch_res else None
        cond_iter = iterate_random_conditioning(cfg, self.dataset, self.batch_size,
                                                device=device)
        bg = self._resolve_batch_gpu()

        @torch.no_grad()
        def render(z, c, cam):
            with exact_fp32():
                ws = G.map_ws(z, c, camera_angles=cam.angles)
                if gc.camera_adaptor.enabled:
                    cam = G.synthesis.apply_camera_adaptor(cam, z, c)
                return to_uint8_images(G.synthesis(ws, cam, ray_chunk=chunk))

        def sample(batch_size: int, seed: int) -> torch.Tensor:
            if batch_size != self.batch_size:
                raise ValueError(f'the sampler draws batches of {self.batch_size}')
            cond = next(cond_iter)
            z = torch.from_numpy(jax_normal(seed, (batch_size, gc.z_dim))).to(device)
            cam = cond['camera_params']
            return torch.cat([render(z[i:i + bg], cond['c'][i:i + bg],
                                     cam.select(slice(i, i + bg)))
                              for i in range(0, batch_size, bg)])

        return sample

    def make_depth_sampler(self, cut_quantile: float = 0.5) -> Callable:
        """(batch_size, seed) -> depth maps [N, H, W, 1] of G from the mean
        camera (no camera adaptor), with the const noise and the densities
        below their `cut_quantile`-quantile zeroed. z is JAX's draw for the
        seed, labels come from `iterate_random_conditioning`. As in the
        JAX package the quantile pools over one render call: the images
        rendered at once (`_resolve_batch_gpu`) and, above `max_batch_res`,
        one chunk of `max_batch_res**2` rays of each."""
        cfg, G = self.cfg, self.G
        self._refuse_2d('depth sampler')
        gc = cfg.generator
        device = self.device
        mean_cam = get_mean_camera_params(cfg.camera, device)
        chunk = gc.max_batch_res ** 2 if gc.img_resolution > gc.max_batch_res else None
        cond_iter = iterate_random_conditioning(cfg, self.dataset, self.batch_size,
                                                device=device)
        bg = self._resolve_batch_gpu()

        @torch.no_grad()
        def render_depth(z, c):
            cam = mean_cam.repeat_interleave(z.shape[0])
            with exact_fp32():
                ws = G.map_ws(z, c, camera_angles=cam.angles)
                return G.synthesis(ws, cam, return_depth=True, cut_quantile=cut_quantile,
                                   ray_chunk=chunk).depth

        def sample(batch_size: int, seed: int) -> torch.Tensor:
            cond = next(cond_iter)
            z = torch.from_numpy(jax_normal(seed, (batch_size, gc.z_dim))).to(device)
            return torch.cat([render_depth(z[i:i + bg], cond['c'][i:i + bg])
                              for i in range(0, batch_size, bg)])

        return sample

    def make_pair_sampler(self, epsilon: float = PPL_EPSILON) -> Callable:
        """(batch_size, seed) -> (images at t, images at t + epsilon), uint8
        [N, H, W, 3] each: w of two z interpolated linearly (the w-space
        endpoints of ppl2_wend) with the same const noise and camera. z0, z1
        and t are drawn as the JAX package draws them (`jax.random.split` of
        PRNGKey(seed) into 3, two normals and a uniform); labels and cameras
        come from `iterate_random_conditioning`."""
        cfg, G = self.cfg, self.G
        self._refuse_2d('pair sampler')
        gc = cfg.generator
        device = self.device
        cond_iter = iterate_random_conditioning(cfg, self.dataset, self.batch_size,
                                                device=device)
        bg = self._resolve_batch_gpu()

        @torch.no_grad()
        def render_pair(z0, z1, c, cam, t):
            with exact_fp32():
                ws0 = G.map_ws(z0, c, camera_angles=cam.angles)
                ws1 = G.map_ws(z1, c, camera_angles=cam.angles)
                wt0 = ws0 + (ws1 - ws0) * t[:, None, None]
                wt1 = ws0 + (ws1 - ws0) * (t + epsilon)[:, None, None]
                return (to_uint8_images(G.synthesis(wt0, cam)),
                        to_uint8_images(G.synthesis(wt1, cam)))

        def sample_pair(batch_size: int, seed: int):
            cond = next(cond_iter)
            k0, k1, kt = split(prng_key(seed), 3)
            z0, z1 = (torch.from_numpy(jax_normal(k, (batch_size, gc.z_dim))).to(device)
                      for k in (k0, k1))
            t = torch.from_numpy(jax_uniform(kt, (batch_size,))).to(device)
            cam = cond['camera_params']
            pairs = [render_pair(z0[i:i + bg], z1[i:i + bg], cond['c'][i:i + bg],
                                 cam.select(slice(i, i + bg)), t[i:i + bg])
                     for i in range(0, batch_size, bg)]
            return torch.cat([a for a, _ in pairs]), torch.cat([b for _, b in pairs])

        return sample_pair


# ------------------------------------------------------------------ metrics

def _fid(ctx: EvalContext, max_real: Optional[int], num_gen: int) -> float:
    real = compute_feature_stats_for_dataset(
        ctx.dataset, ctx.detector, max_items=max_real, cache_dir=ctx.cache_dir,
        batch_size=ctx.batch_size)
    gen = compute_feature_stats_for_generator(
        ctx.make_image_sampler(), ctx.detector, batch_size=ctx.batch_size, max_items=num_gen)
    return fid_mod.compute_fid(real, gen)


def _all_features(ctx: EvalContext, max_real: Optional[int], num_gen: int):
    """The raw features of the dataset's first `max_real` items (all with
    None) and of `num_gen` images of G."""
    real = compute_feature_stats_for_dataset(
        ctx.dataset, ctx.detector, max_items=max_real, cache_dir=ctx.cache_dir,
        capture_all=True, capture_mean_cov=False, batch_size=ctx.batch_size)
    gen = compute_feature_stats_for_generator(
        ctx.make_image_sampler(), ctx.detector, batch_size=ctx.batch_size, max_items=num_gen,
        capture_all=True, capture_mean_cov=False)
    return real.get_all(), gen.get_all()


def _kid(ctx: EvalContext, max_real: Optional[int], num_gen: int) -> float:
    return kid_mod.compute_kid(*_all_features(ctx, max_real, num_gen))


def _pr(ctx: EvalContext, max_real: Optional[int], num_gen: int):
    return pr_mod.compute_pr(*_all_features(ctx, max_real, num_gen), device=ctx.device)


@register_metric
def fid2k_full(ctx: EvalContext) -> Dict[str, float]:
    return {'fid2k_full': _fid(ctx, max_real=None, num_gen=2048)}


@register_metric
def fid5k_5k(ctx: EvalContext) -> Dict[str, float]:
    return {'fid5k_5k': _fid(ctx, max_real=5000, num_gen=5000)}


@register_metric
def fid50k_full(ctx: EvalContext) -> Dict[str, float]:
    return {'fid50k_full': _fid(ctx, max_real=None, num_gen=50000)}


@register_metric
def kid50k(ctx: EvalContext) -> Dict[str, float]:
    return {'kid50k': _kid(ctx, max_real=50000, num_gen=50000)}


@register_metric
def kid50k_full(ctx: EvalContext) -> Dict[str, float]:
    return {'kid50k_full': _kid(ctx, max_real=None, num_gen=50000)}


@register_metric
def pr50k3(ctx: EvalContext) -> Dict[str, float]:
    p, r = _pr(ctx, max_real=50000, num_gen=50000)
    return {'pr50k3_precision': p, 'pr50k3_recall': r}


@register_metric
def pr50k3_full(ctx: EvalContext) -> Dict[str, float]:
    p, r = _pr(ctx, max_real=None, num_gen=50000)
    return {'pr50k3_full_precision': p, 'pr50k3_full_recall': r}


@register_metric
def is50k(ctx: EvalContext) -> Dict[str, float]:
    """Scores `ctx.detector`'s output as class probabilities, as the JAX
    package does: the scripts' detectors give pool features (or random
    projections, with negative entries: NaN), not InceptionV3's softmax."""
    gen = compute_feature_stats_for_generator(
        ctx.make_image_sampler(), ctx.detector, batch_size=ctx.batch_size, max_items=50000,
        capture_all=True, capture_mean_cov=False)
    mean, std = is_mod.compute_is(gen.get_all())
    return {'is50k_mean': mean, 'is50k_std': std}


@register_metric
def ppl2_wend(ctx: EvalContext) -> Dict[str, float]:
    """2048 pairs in w between endpoints; the detector is `ctx.ppl_detector`,
    else `ctx.detector` (as in the JAX package, whose scripts set no
    ppl_detector)."""
    value = ppl_mod.compute_ppl(ctx.make_pair_sampler(PPL_EPSILON),
                                ctx.ppl_detector or ctx.detector, num_samples=2048,
                                batch_size=ctx.batch_size, epsilon=PPL_EPSILON)
    return {'ppl2_wend': value}


@register_metric
def nfs256(ctx: EvalContext) -> Dict[str, float]:
    """NFS of 256 frontal depth maps (cut at the 0.5-quantile), seeds 0, 1, ..."""
    sampler = ctx.make_depth_sampler(cut_quantile=0.5)
    maps = []
    n_done, seed = 0, 0
    while n_done < 256:
        d = sampler(ctx.batch_size, seed)[..., 0].cpu().numpy()
        maps.append(d)
        n_done += d.shape[0]
        seed += 1
    depth_maps = np.concatenate(maps)[:256]
    ray = ctx.cfg.camera.ray
    return {'nfs256': nfs_mod.compute_nfs_from_depth_maps(
        depth_maps, min_depth=ray.start, max_depth=ray.end, num_bins=64)}


# ------------------------------------------------------------------ evaluation

def calc_metric(metric: str, ctx: EvalContext) -> Dict[str, Any]:
    if not is_valid_metric(metric):
        raise ValueError(f'unknown metric {metric}; have {list_metrics()}')
    t0 = time.time()
    results = _metric_dict[metric](ctx)
    return dict(results=results, metric=metric, total_time=time.time() - t0, num_devices=1)


def report_metric(result_dict: Dict[str, Any], run_dir: Optional[str] = None,
                  snapshot: Optional[str] = None) -> None:
    """Print the result and append it to <run_dir>/metric-<name>.jsonl."""
    metric = result_dict['metric']
    line = json.dumps({**result_dict, 'snapshot': snapshot, 'timestamp': time.time()})
    print(line)
    if run_dir is not None and os.path.isdir(run_dir):
        with open(os.path.join(run_dir, f'metric-{metric}.jsonl'), 'at') as f:
            f.write(line + '\n')
