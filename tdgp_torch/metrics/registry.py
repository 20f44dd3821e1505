"""Metric registry and the generator's image sampler (port of
`tdgp/metrics/registry.py`, the FID family).

The FID entries of the JAX registry are here: fid2k_full (the in-loop
metric of the synth presets), fid5k_5k and fid50k_full, one function at
three sizes. The other entries (KID, precision/recall, IS, PPL, NFS) are
registered by name and raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Optional

import torch

from tdgp_torch.config import Config
from tdgp_torch.metrics import fid as fid_mod
from tdgp_torch.metrics.detectors import jax_normal
from tdgp_torch.metrics.features import (compute_feature_stats_for_dataset,
                                         compute_feature_stats_for_generator,
                                         iterate_random_conditioning, to_uint8_images)
from tdgp_torch.models.epigraf import Generator
from tdgp_torch.utils.misc import exact_fp32

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
    cache_dir: Optional[str] = None
    batch_size: int = 16

    def _resolve_batch_gpu(self) -> int:
        """Images rendered at once: the whole batch below 256^2, else the
        largest divisor of the batch up to 4 (the render's peak memory), as
        in the JAX package."""
        cap = self.batch_size if self.cfg.generator.img_resolution < 256 else 4
        cap = max(1, min(cap, self.batch_size))
        while self.batch_size % cap:
            cap -= 1
        return cap

    def make_image_sampler(self) -> Callable:
        """(batch_size, seed) -> uint8 images [N, H, W, 3] of G on its device.
        z is `jax.random.normal(PRNGKey(seed))`'s draw, as the JAX sampler's;
        labels and cameras come from `iterate_random_conditioning`. The
        render runs without autograd, rays `max_batch_res**2` at a time
        above that, so on the card it runs the served path's kernels."""
        cfg, G = self.cfg, self.G
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


# ------------------------------------------------------------------ metrics

def _fid(ctx: EvalContext, max_real: Optional[int], num_gen: int) -> float:
    real = compute_feature_stats_for_dataset(
        ctx.dataset, ctx.detector, max_items=max_real, cache_dir=ctx.cache_dir,
        batch_size=ctx.batch_size)
    gen = compute_feature_stats_for_generator(
        ctx.make_image_sampler(), ctx.detector, batch_size=ctx.batch_size, max_items=num_gen)
    return fid_mod.compute_fid(real, gen)


@register_metric
def fid2k_full(ctx: EvalContext) -> Dict[str, float]:
    return {'fid2k_full': _fid(ctx, max_real=None, num_gen=2048)}


@register_metric
def fid5k_5k(ctx: EvalContext) -> Dict[str, float]:
    return {'fid5k_5k': _fid(ctx, max_real=5000, num_gen=5000)}


@register_metric
def fid50k_full(ctx: EvalContext) -> Dict[str, float]:
    return {'fid50k_full': _fid(ctx, max_real=None, num_gen=50000)}


def _not_ported(name: str) -> Callable:
    def metric(ctx: EvalContext) -> Dict[str, float]:
        raise NotImplementedError(f'metric {name} is not ported to tdgp_torch')
    metric.__name__ = name
    return metric


for _name in ('kid50k', 'kid50k_full', 'pr50k3', 'pr50k3_full', 'is50k', 'ppl2_wend',
              'nfs256'):
    register_metric(_not_ported(_name))


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
