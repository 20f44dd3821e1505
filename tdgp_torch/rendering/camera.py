"""Camera sampling, camera-to-world math and the mean camera
(port of `tdgp/rendering/camera.py`).

Conventions as in the JAX package: angles = (yaw, pitch, roll), the camera
sits on a sphere of `radius` looking at `look_at` (spherical coordinates),
up = +y. Sampling takes its uniform draws from a `Draws`; the truncated
normal is the inverse-CDF transform of a uniform draw, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch

from tdgp_torch.config import AnglesDist, CameraConfig, Dist
from tdgp_torch.utils.draws import Draws
from tdgp_torch.utils.tensor_group import TensorGroup


def normalize_vec(x: torch.Tensor, dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + eps)


# --------------------------------------------------------------- sampling

def _norm_cdf(z: float) -> float:
    return 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))


def sample_truncnorm(draws: Draws, name: str, mean: float, std: float, lo: float,
                     hi: float, n: int) -> torch.Tensor:
    """Truncated normal by the inverse CDF of a uniform draw."""
    a, b = _norm_cdf((lo - mean) / std), _norm_cdf((hi - mean) / std)
    u = (draws.uniform(name, (n,)) * (b - a) + a).clamp(1e-7, 1 - 1e-7)
    return mean + std * math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)


def _uniform(draws: Draws, name: str, lo: float, hi: float, n: int) -> torch.Tensor:
    return draws.uniform(name, (n,)) * (hi - lo) + lo


def sample_camera_angles(draws: Draws, cfg: AnglesDist, n: int) -> torch.Tensor:
    """(yaw, pitch, roll) [n, 3] from the configured distribution. 'hybrid'
    draws the whole batch from a uniform of half-width 2 std about the mean
    or from the normal, one choice per batch (the draw 'select', as
    `tdgp/rendering/camera.py:72-80` takes it); 'custom' takes the dataset's
    angles, which the caller passes to `sample_camera_params`."""
    y, p = cfg.yaw, cfg.pitch
    if cfg.dist == 'custom':
        raise ValueError("angles dist 'custom' requires dataset-provided origin_angles")
    if cfg.dist == 'uniform':
        yaw = _uniform(draws, 'yaw', y.min, y.max, n)
        pitch = _uniform(draws, 'pitch', p.min, p.max, n)
    elif cfg.dist == 'normal':
        yaw = draws.normal('yaw', (n,)) * y.std + y.mean
        pitch = draws.normal('pitch', (n,)) * p.std + p.mean
    elif cfg.dist == 'truncnorm':
        yaw = sample_truncnorm(draws, 'yaw', (y.max + y.min) * 0.5, y.std, y.min, y.max, n)
        pitch = sample_truncnorm(draws, 'pitch', (p.max + p.min) * 0.5, p.std, p.min, p.max, n)
    elif cfg.dist == 'hybrid':
        u_yaw = (draws.uniform('yaw', (n,)) - 0.5) * 2 * y.std * 2 + y.mean
        u_pitch = (draws.uniform('pitch', (n,)) - 0.5) * 2 * p.std * 2 + p.mean
        n_yaw = draws.normal('normal/yaw', (n,)) * y.std + y.mean
        n_pitch = draws.normal('normal/pitch', (n,)) * p.std + p.mean
        take_uniform = draws.uniform('select', ()) < 0.5
        yaw = torch.where(take_uniform, u_yaw, n_yaw)
        pitch = torch.where(take_uniform, u_pitch, n_pitch)
    elif cfg.dist == 'spherical_uniform':
        yaw = (draws.uniform('yaw', (n,)) - 0.5) * (y.max - y.min) + 0.5 * (y.max + y.min)
        v = (draws.uniform('pitch', (n,)) - 0.5) * (p.max - p.min) + 0.5 * (p.max + p.min)
        pitch = torch.arccos(1 - 2 * (v / math.pi).clamp(1e-5, 1 - 1e-5))
    else:
        raise NotImplementedError(f'Unknown angle distribution: {cfg.dist}')
    pitch = pitch.clamp(1e-5, math.pi - 1e-5)
    return torch.stack([yaw, pitch, torch.zeros_like(yaw)], dim=1)


def sample_bounded_scalar(draws: Draws, name: str, cfg: Dist, n: int) -> torch.Tensor:
    if cfg.dist == 'normal':
        if float(cfg.std) != 0.0:
            raise ValueError('a camera scalar must be bounded: normal with std 0 only')
        return torch.full((n,), float(cfg.mean), device=draws.device)
    if cfg.dist == 'truncnorm':
        return sample_truncnorm(draws, name, cfg.mean, cfg.std, cfg.min, cfg.max, n)
    if cfg.dist == 'uniform':
        return _uniform(draws, name, cfg.min, cfg.max, n)
    raise NotImplementedError(f'scalar distribution {cfg.dist!r} is not ported')


def sample_camera_params(draws: Draws, cfg: CameraConfig, n: int,
                         origin_angles: Optional[torch.Tensor] = None) -> TensorGroup:
    """angles [n,3], fov [n], radius [n], look_at [n,3] (yaw, pitch, radius)."""
    angles = (sample_camera_angles(draws.scope('angles'), cfg.origin.angles, n)
              if origin_angles is None else origin_angles)
    la = cfg.look_at
    la_angles = sample_camera_angles(draws.scope('look_at/angles'), la.angles, n)
    la_radius = sample_bounded_scalar(draws, 'look_at/radius', la.radius, n)
    return TensorGroup(
        angles=angles, fov=sample_bounded_scalar(draws, 'fov', cfg.fov, n),
        radius=sample_bounded_scalar(draws, 'radius', cfg.origin.radius, n),
        look_at=torch.cat([la_angles[:, :2], la_radius[:, None]], dim=1))


# --------------------------------------------------------- analytic means

def get_mean_sampling_value(d: Dist) -> float:
    if d.dist in ('normal', 'truncnorm'):
        return d.mean
    if d.dist == 'uniform':
        return (d.max + d.min) / 2
    raise NotImplementedError(d.dist)


def get_mean_angles_values(angles: AnglesDist):
    if angles.dist in ('spherical_uniform', 'truncnorm', 'uniform'):
        return [(angles.yaw.max + angles.yaw.min) * 0.5,
                (angles.pitch.max + angles.pitch.min) * 0.5, 0.0]
    if angles.dist == 'normal':
        return [angles.yaw.mean, angles.pitch.mean, 0.0]
    raise NotImplementedError(angles.dist)


def get_mean_camera_params(camera_cfg: CameraConfig,
                           device: Union[str, torch.device] = 'cuda') -> TensorGroup:
    """The mean camera, batch 1: angles [1,3], fov [1], radius [1], look_at [1,3]."""
    la = camera_cfg.look_at
    look_at = [(la.angles.yaw.max + la.angles.yaw.min) * 0.5,
               (la.angles.pitch.max + la.angles.pitch.min) * 0.5,
               get_mean_sampling_value(la.radius)]

    def tensor(values):
        return torch.tensor(values, dtype=torch.float32, device=device)

    return TensorGroup(angles=tensor([get_mean_angles_values(camera_cfg.origin.angles)]),
                       fov=tensor([get_mean_sampling_value(camera_cfg.fov)]),
                       radius=tensor([get_mean_sampling_value(camera_cfg.origin.radius)]),
                       look_at=tensor([look_at]))


def spherical2cartesian(rotation: torch.Tensor, pitch: torch.Tensor, radius=1.0) -> torch.Tensor:
    x = radius * torch.sin(pitch) * torch.sin(-rotation)
    y = radius * torch.cos(pitch)
    z = radius * torch.sin(pitch) * torch.cos(rotation)
    return torch.stack([x, y, z], dim=-1)


def compute_cam2world_matrix(camera_params: TensorGroup) -> torch.Tensor:
    """Look-at cam2world with up = +y. Returns [N, 4, 4]."""
    origins = spherical2cartesian(camera_params.angles[:, 0], camera_params.angles[:, 1],
                                  camera_params.radius)
    look_at = spherical2cartesian(camera_params.look_at[:, 0], camera_params.look_at[:, 1],
                                  camera_params.look_at[:, 2])
    forward = normalize_vec(look_at - origins)
    up = torch.tensor([0.0, 1.0, 0.0], dtype=forward.dtype, device=forward.device).expand_as(forward)
    left = normalize_vec(torch.linalg.cross(up, forward, dim=-1))
    up = normalize_vec(torch.linalg.cross(forward, left, dim=-1))
    c2w = torch.zeros((origins.shape[0], 4, 4), dtype=forward.dtype, device=forward.device)
    c2w[:, :3, :3] = torch.stack([-left, up, -forward], dim=-1)
    c2w[:, :3, 3] = origins
    c2w[:, 3, 3] = 1.0
    return c2w


def get_max_sampling_value(d: Dist) -> float:
    """The largest value a distribution draws (inf for a normal with spread)."""
    if d.dist == 'normal':
        return d.mean if d.std <= 1e-8 else float('inf')
    if d.dist in ('truncnorm', 'uniform'):
        return d.max
    raise NotImplementedError(d.dist)


def validate_frustum(fov: float, near: float, far: float, radius: float,
                     scale: float = 1.0, step: float = 1e-2) -> bool:
    """Whether the viewing frustum between `near` and `far` stays inside the
    [-scale, scale]^3 cube for every camera on the sphere of `radius` looking
    at the origin (fov in degrees); on the CPU."""
    num_angles = int((math.pi / 2) / step)
    yaw = torch.linspace(0, 2 * math.pi, num_angles, dtype=torch.float64).float()
    pitch = torch.linspace(0, math.pi, num_angles, dtype=torch.float64).clamp(
        1e-7, math.pi - 1e-7).float()
    yaw, pitch = torch.meshgrid(yaw, pitch, indexing='ij')
    angles = torch.stack([yaw.reshape(-1), pitch.reshape(-1), torch.zeros(yaw.numel())], dim=1)
    n = angles.shape[0]
    c2w = compute_cam2world_matrix(TensorGroup(
        angles=angles, radius=torch.full((n,), float(radius)), fov=torch.full((n,), float(fov)),
        look_at=torch.zeros((n, 3))))
    x = torch.tensor([-1.0, 1.0, -1.0, 1.0])
    y = torch.tensor([1.0, 1.0, -1.0, -1.0])
    z = -torch.ones(4) / math.tan(math.radians(fov) * 0.5)
    rays_d_cam = normalize_vec(torch.stack([x, y, z], dim=1))               # [4, 3]
    z_vals = torch.tensor([near, far], dtype=torch.float32)
    dirs_world = torch.einsum('bij,pj->bpi', c2w[:, :3, :3], rays_d_cam)     # [n, 4, 3]
    origins = c2w[:, :3, 3][:, None, None, :]
    pts = origins + z_vals[None, None, :, None] * dirs_world[:, :, None, :]
    return float(pts.min()) >= -scale and float(pts.max()) <= scale
