"""Mapping-network building blocks (port of `tdgp/models/layers.py`).

Equalized learning rate as in StyleGAN: parameters are stored at unit scale
and multiplied by `lr_multiplier / sqrt(fan_in)` when used. Linear weights
are stored in PyTorch's [out, in] layout. Parameters start at zero and are
filled from a trained generator by `tdgp_torch.weights.load_flat`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from tdgp_torch.ops.bias_act import bias_act


def normalize_2nd_moment(x: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=dim, keepdim=True) + eps)


class FullyConnected(nn.Module):
    """Equalized-lr dense layer with bias and activation."""

    def __init__(self, in_features: int, out_features: int, activation: str = 'linear',
                 lr_multiplier: float = 1.0):
        super().__init__()
        self.activation = activation
        self.lr_multiplier = lr_multiplier
        self.weight_gain = lr_multiplier / math.sqrt(in_features)
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight * self.weight_gain)
        return bias_act(y, self.bias * self.lr_multiplier, act=self.activation)


def scalar_encoder_raw(x: torch.Tensor) -> torch.Tensor:
    """`ScalarEncoder1d(coord_dim, 0.0, 0, use_raw=True)`: the raw scalars,
    flattened to [N, coord_dim]."""
    return x.reshape(x.shape[0], -1)


class MappingNetwork(nn.Module):
    """z, c and camera angles -> ws [N, num_ws, w_dim], at eval.

    Camera conditioning takes yaw and pitch wrapped into [-1, 1] as raw
    scalars (`camera_cond_raw`). Truncation pulls w toward the `w_avg`
    buffer, the EMA the JAX package keeps in its 'ema' collection.
    """

    lr_multiplier = 0.01

    def __init__(self, z_dim: int, c_dim: int, w_dim: int, num_ws: int,
                 num_layers: int = 2, camera_cond: bool = False,
                 camera_raw_scalars: bool = True):
        super().__init__()
        if z_dim <= 0:
            raise NotImplementedError('the served generator maps a latent z')
        if camera_cond and not camera_raw_scalars:
            raise NotImplementedError('Fourier camera encoding is not ported')
        self.z_dim, self.w_dim, self.num_ws = z_dim, w_dim, num_ws
        self.camera_cond = camera_cond
        embed_in = c_dim + (2 if camera_cond else 0)
        self.embed = FullyConnected(embed_in, w_dim) if embed_in > 0 else None
        in_dim = z_dim + (w_dim if embed_in > 0 else 0)
        for idx in range(num_layers):
            setattr(self, f'fc{idx}', FullyConnected(in_dim, w_dim, activation='lrelu',
                                                     lr_multiplier=self.lr_multiplier))
            in_dim = w_dim
        self.num_layers = num_layers
        self.register_buffer('w_avg', torch.zeros(w_dim))

    def forward(self, z: torch.Tensor, c: Optional[torch.Tensor],
                camera_angles: Optional[torch.Tensor] = None,
                truncation_psi: float = 1.0) -> torch.Tensor:
        if self.camera_cond:
            if camera_angles is None:
                raise ValueError('camera-conditioned mapping needs camera angles')
            ang = camera_angles[:, :2]
            ang = torch.sign(ang) * (torch.remainder(ang.abs(), 2.0 * math.pi) / (2.0 * math.pi))
            embs = scalar_encoder_raw(ang)
            c = embs if c is None or c.shape[1] == 0 else torch.cat([c, embs], dim=1)
        x = normalize_2nd_moment(z.float())
        if self.embed is not None:
            y = normalize_2nd_moment(self.embed(c.float()))
            x = torch.cat([x, y], dim=1)
        for idx in range(self.num_layers):
            x = getattr(self, f'fc{idx}')(x)
        if truncation_psi != 1.0:
            x = self.w_avg + (x - self.w_avg) * truncation_psi
        return x[:, None, :].repeat(1, self.num_ws, 1)
