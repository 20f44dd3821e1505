"""What the loop reports besides the losses (port of `tdgp/training/telemetry.py`):
the 3DGP progress panel (the schedules' values and ADA's p), the camera
posterior panel (means and stds of the prior's and the camera adaptor's
camera parameters over 1024 samples, with histograms of the posterior),
and a TensorBoard sink.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from tdgp_torch.config import Config
from tdgp_torch.models.epigraf import Generator
from tdgp_torch.rendering.camera import sample_camera_params
from tdgp_torch.training.patch import sample_random_c
from tdgp_torch.training.schedules import Schedules
from tdgp_torch.utils.draws import Draws
from tdgp_torch.utils.misc import exact_fp32
from tdgp_torch.utils.tensor_group import TensorGroup


class TBWriter:
    """TensorBoard scalars and histograms under `log_dir`; does nothing when
    not enabled, and raises when enabled without the `tensorboard` package."""

    def __init__(self, log_dir: str, enabled: bool = True):
        self._w = None
        if not enabled:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            raise ImportError('training.tensorboard is set, but TensorBoard is not installed; '
                              'set training.tensorboard=false to log to stats.jsonl only') from e
        self._w = SummaryWriter(log_dir=log_dir)

    def scalars(self, values: Dict[str, float], step: int):
        if self._w is None:
            return
        for k, v in values.items():
            self._w.add_scalar(k, float(v), global_step=step)

    def histogram(self, name: str, values: np.ndarray, step: int):
        if self._w is not None:
            self._w.add_histogram(name, values, global_step=step)

    def flush(self):
        if self._w is not None:
            self._w.flush()

    def close(self):
        if self._w is not None:
            self._w.close()


def progress_scalars(sched: Schedules, ada_p: float) -> Dict[str, float]:
    """The 3DGP progress panel."""
    return {
        'Progress/nerf_noise_std': sched.nerf_noise_std,
        'Progress/blur_sigma': sched.blur_sigma,
        'Progress/patch/min_scale': sched.patch_min_scale,
        'Progress/patch/beta': sched.patch_beta,
        'Progress/kd_weight': sched.kd_weight,
        'Progress/gpc_spoof_p': sched.gpc_spoof_p,
        'Progress/emd_multiplier': sched.emd_multiplier,
        'Progress/depth/progress': sched.depth_progress,
        'Progress/augment_p': float(ada_p),
    }


@torch.no_grad()
def camera_posterior(G: Generator, cfg: Config, draws: Draws, num_samples: int = 1024,
                     origin_angles: Optional[np.ndarray] = None):
    """(prior, posterior) camera parameters of `num_samples` draws ('z',
    'c/...', 'camera/...') through G's camera adaptor; None without an
    adaptor, or for the 'custom' angle distribution without `origin_angles`
    (dataset angles, tiled up to `num_samples`)."""
    gc = cfg.generator
    if not gc.camera_adaptor.enabled:
        return None
    device = next(G.parameters()).device
    angles = None
    if cfg.camera.origin.angles.dist == 'custom':
        if origin_angles is None:
            return None
        angles = torch.as_tensor(np.resize(np.asarray(origin_angles, np.float32),
                                           (num_samples, 3)), device=device)
    z = draws.normal('z', (num_samples, gc.z_dim))
    c = sample_random_c(draws.scope('c'), num_samples, gc.c_dim)
    prior = sample_camera_params(draws.scope('camera'), cfg.camera, num_samples,
                                 origin_angles=angles)
    with exact_fp32():
        post = G.synthesis.apply_camera_adaptor(prior, z, c)
    return prior, post


def camera_posterior_report(prior_post, tb: Optional[TBWriter] = None,
                            step: int = 0) -> Dict[str, float]:
    """Means and stds of the prior's and the posterior's camera parameters,
    and TensorBoard histograms of the posterior's."""
    if prior_post is None:
        return {}
    out: Dict[str, float] = {}

    def series(group: TensorGroup) -> Dict[str, np.ndarray]:
        angles = group.angles.cpu().numpy()
        look_at = group.look_at.cpu().numpy()
        return {'yaw': angles[:, 0], 'pitch': angles[:, 1], 'fov': group.fov.cpu().numpy(),
                'radius': group.radius.cpu().numpy(), 'look_at_x': look_at[:, 0],
                'look_at_y': look_at[:, 1], 'look_at_z': look_at[:, 2]}

    prior, post = prior_post
    for tag, group in (('posterior', post), ('prior', prior)):
        for name, vals in series(group).items():
            out[f'Camera/{tag}/{name}/mean'] = float(vals.mean())
            out[f'Camera/{tag}/{name}/std'] = float(vals.std())
            if tb is not None and tag == 'posterior':
                tb.histogram(f'Camera/{tag}/{name}', vals, step)
    return out
