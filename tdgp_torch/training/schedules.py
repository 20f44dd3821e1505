"""Progressive schedules of a training step (port of `tdgp/training/schedules.py`).

The JAX package packs them into one traced pytree so that one compiled step
serves the whole run; here they are host floats, computed from the number
of images shown so far.
"""
from __future__ import annotations

import dataclasses

from tdgp_torch.config import Config
from tdgp_torch.utils.misc import linear_schedule


@dataclasses.dataclass(frozen=True)
class Schedules:
    blur_sigma: float       # D input blur fade
    patch_min_scale: float  # patch-scale anneal
    patch_beta: float       # beta-distribution anneal of the patch scale
    gpc_spoof_p: float      # camera-conditioning spoof probability
    kd_weight: float        # D knowledge-distillation weight
    emd_multiplier: float   # camera-adaptor EMD ramp
    nerf_noise_std: float   # density noise anneal
    depth_progress: float   # depth-adaptor selection anneal
    ema_beta: float         # G EMA decay
    ada_p: float            # ADA augment probability


def compute_schedules(cfg: Config, cur_nimg: int, ada_p: float = 0.0) -> Schedules:
    kimg = cur_nimg / 1e3
    t, l, g = cfg.training, cfg.loss, cfg.generator

    blur_sigma = (max(1 - cur_nimg / (l.blur_fade_kimg * 1e3), 0) * l.blur_init_sigma
                  if l.blur_fade_kimg > 0 else 0.0)
    p = g.patch
    if p.distribution == 'beta':
        patch_beta = linear_schedule(kimg, p.beta_val_start, p.beta_val_end, p.anneal_kimg)
        patch_min_scale = p.min_scale_trg
    else:
        patch_beta = 1.0
        patch_min_scale = linear_schedule(kimg, p.max_scale, p.min_scale_trg, p.anneal_kimg)

    ema_nimg = t.ema_kimg * 1000
    if t.ema_rampup is not None:
        ema_nimg = min(ema_nimg, cur_nimg * t.ema_rampup)
    ema_beta = 0.5 ** (t.batch_size / max(ema_nimg, 1e-8))
    if t.ema_start_kimg > kimg:
        ema_beta = 0.0

    return Schedules(
        blur_sigma=float(blur_sigma), patch_min_scale=float(patch_min_scale),
        patch_beta=float(patch_beta),
        gpc_spoof_p=float(linear_schedule(kimg, 1.0, g.camera_cond_spoof_p, 1000)),
        kd_weight=float(linear_schedule(kimg, l.kd.weight, 0.0, period=l.kd.anneal_kimg)),
        emd_multiplier=float(linear_schedule(kimg, 0.0, 1.0,
                                             period=g.camera_adaptor.emd.anneal_kimg)
                             if t.learn_camera_dist else 0.0),
        nerf_noise_std=float(linear_schedule(kimg, g.nerf_noise_std_init, 0.0,
                                             g.nerf_noise_kimg_growth)),
        depth_progress=float(linear_schedule(kimg, 0.0, 1.0, g.depth_adaptor.anneal_kimg)),
        ema_beta=float(ema_beta), ada_p=float(ada_p))
