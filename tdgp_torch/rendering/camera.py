"""Camera-to-world math and the mean camera (port of `tdgp/rendering/camera.py`).

Conventions as in the JAX package: angles = (yaw, pitch, roll), the camera
sits on a sphere of `radius` looking at `look_at` (spherical coordinates),
up = +y.
"""
from __future__ import annotations

from typing import Union

import torch

from tdgp_torch.config import AnglesDist, CameraConfig, Dist
from tdgp_torch.utils.tensor_group import TensorGroup


def normalize_vec(x: torch.Tensor, dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + eps)


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
