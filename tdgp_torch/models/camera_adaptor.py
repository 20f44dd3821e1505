"""Learnable camera distribution (port of `tdgp/models/camera_adaptor.py`).

Warps prior camera samples (yaw, pitch, roll, fov, radius, look_at[3]) =
8 scalars through two small MLPs conditioned on (z, c), squashing them back
into the prior's bounds with sigmoids. Differentiable in its parameters and
in the prior, which the Lipschitz regularizer uses.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tdgp_torch.config import CameraAdaptorCfg, CameraConfig
from tdgp_torch.models.layers import FullyConnected, normalize_2nd_moment
from tdgp_torch.utils.tensor_group import TensorGroup


def unroll_camera_params(cp: TensorGroup) -> torch.Tensor:
    """TensorGroup -> [N, 8]."""
    return torch.cat([cp.angles, cp.fov[:, None], cp.radius[:, None], cp.look_at], dim=1)


def roll_camera_params(cp: torch.Tensor) -> TensorGroup:
    """[N, 8] -> TensorGroup."""
    return TensorGroup(angles=cp[:, 0:3], fov=cp[:, 3], radius=cp[:, 4], look_at=cp[:, 5:8])


def normalize_camera_params(camera: CameraConfig, cp: TensorGroup,
                            eps: float = 1e-8) -> TensorGroup:
    """Camera scalars into [0, 1] by their prior bounds."""
    yaw, pitch, roll, fov, radius, la_yaw, la_pitch, la_radius = unroll_camera_params(cp).unbind(1)
    oa, la = camera.origin.angles, camera.look_at
    yaw = (yaw - oa.yaw.min) / (oa.yaw.max - oa.yaw.min + eps)
    pitch = (pitch - oa.pitch.min) / (oa.pitch.max - oa.pitch.min + eps)
    fov = (fov - camera.fov.min) / (camera.fov.max - camera.fov.min + eps)
    la_yaw = (la_yaw - la.angles.yaw.min) / (la.angles.yaw.max - la.angles.yaw.min + eps)
    la_pitch = (la_pitch - la.angles.pitch.min) / (la.angles.pitch.max - la.angles.pitch.min + eps)
    la_radius = (la_radius - la.radius.min) / (la.radius.max - la.radius.min + eps)
    return roll_camera_params(torch.stack(
        [yaw, pitch, roll, fov, radius, la_yaw, la_pitch, la_radius], dim=1))


def denormalize_camera_params(camera: CameraConfig, cp: TensorGroup) -> TensorGroup:
    """Sigmoid-squash back into the prior's bounds (the look-at radius against
    its own bound, as the JAX package does)."""
    yaw, pitch, roll, fov, radius, la_yaw, la_pitch, la_radius = unroll_camera_params(cp).unbind(1)
    oa, la = camera.origin.angles, camera.look_at
    sig = torch.sigmoid
    yaw = sig(yaw) * (oa.yaw.max - oa.yaw.min) + oa.yaw.min
    pitch = sig(pitch) * (oa.pitch.max - oa.pitch.min - 2e-5) + oa.pitch.min + 1e-5
    roll = roll * 0.0
    fov = sig(fov) * (camera.fov.max - camera.fov.min) + camera.fov.min
    la_yaw = sig(la_yaw) * (la.angles.yaw.max - la.angles.yaw.min) + la.angles.yaw.min
    la_pitch = sig(la_pitch) * (la.angles.pitch.max - la.angles.pitch.min) + la.angles.pitch.min
    la_radius = sig(la_radius) * (la.radius.max - la.radius.min) + la.radius.min
    return roll_camera_params(torch.stack(
        [yaw, pitch, roll, fov, radius, la_yaw, la_pitch, la_radius], dim=1))


class ParamsAdaptor(nn.Module):
    """A small softplus MLP over (params, z?, c?)."""

    def __init__(self, cfg: CameraAdaptorCfg, in_channels: int, out_channels: int,
                 use_z: bool = True):
        super().__init__()
        lr, hid, emb = cfg.lr_multiplier, cfg.hid_dim, cfg.embed_dim
        self.project_params = FullyConnected(in_channels, hid, 'softplus', lr)
        self.project_z = FullyConnected(cfg.z_dim, emb, 'softplus', lr) if use_z else None
        self.project_c = FullyConnected(cfg.c_dim, emb, 'softplus', lr) if cfg.c_dim > 0 else None
        main_in = hid + (emb if use_z else 0) + (emb if cfg.c_dim > 0 else 0)
        self.main0 = FullyConnected(main_in, hid, 'softplus', lr)
        self.main1 = FullyConnected(hid, out_channels, 'linear', lr)

    def forward(self, x: torch.Tensor, z: Optional[torch.Tensor] = None,
                c: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.project_params(x)
        if self.project_z is not None:
            x = torch.cat([x, normalize_2nd_moment(self.project_z(z))], dim=1)
        if self.project_c is not None:
            x = torch.cat([x, normalize_2nd_moment(self.project_c(c))], dim=1)
        return self.main1(self.main0(x))


class CameraAdaptor(nn.Module):
    """Prior camera parameters -> the learned posterior."""

    def __init__(self, cfg: CameraAdaptorCfg, camera: CameraConfig):
        super().__init__()
        self.cfg, self.camera = cfg, camera
        self.origin_adaptor = ParamsAdaptor(cfg, 4, 4, use_z=False)
        self.look_at_adaptor = ParamsAdaptor(cfg, 8, 4, use_z=True)

    def forward(self, prior: TensorGroup, z: torch.Tensor,
                c: Optional[torch.Tensor] = None) -> TensorGroup:
        old = normalize_camera_params(self.camera, prior)
        origin_new = self.origin_adaptor(torch.cat([old.angles, old.radius[:, None]], dim=1),
                                         c=c)
        look_at_in = torch.cat([origin_new[:, :3], old.fov[:, None], origin_new[:, 3:4],
                                old.look_at], dim=1)
        look_at_new = self.look_at_adaptor(look_at_in, z=z, c=c)
        new = roll_camera_params(torch.cat([origin_new[:, :3], look_at_new[:, 0:1],
                                            origin_new[:, 3:4], look_at_new[:, 1:4]], dim=1))
        if self.cfg.residual:
            new = roll_camera_params(unroll_camera_params(old) + unroll_camera_params(new))
        new = denormalize_camera_params(self.camera, new)
        adj = self.cfg.adjust

        def pick(name, adjust):
            return new[name] if adjust else prior[name] + 0.0 * new[name]

        return TensorGroup(angles=pick('angles', adj.angles), radius=pick('radius', adj.radius),
                           fov=pick('fov', adj.fov), look_at=pick('look_at', adj.look_at))
