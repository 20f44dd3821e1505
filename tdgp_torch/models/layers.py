"""Shared building blocks (port of `tdgp/models/layers.py`).

Equalized learning rate as in StyleGAN: parameters are stored at unit scale
and multiplied by `lr_multiplier / sqrt(fan_in)` when used. Linear weights
are stored in PyTorch's layout [out, in], conv weights as [Co, Ci, kh, kw];
activations are NHWC. `reset_parameters(generator)` draws a module's
initial values as the JAX package's initializers do; `init_weights` applies
it to a whole model. A trained or a JAX-initialised model is loaded instead
by `tdgp_torch.weights.load_flat`.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from tdgp_torch.ops.bias_act import activation_funcs, bias_act, round_to
from tdgp_torch.ops.conv2d_resample import conv2d_resample
from tdgp_torch.ops.upfirdn2d import setup_filter
from tdgp_torch.utils.draws import Draws


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter and persistent buffer of `model` from `generator`,
    in module order, with the rules of the modules' `reset_parameters`."""
    with torch.no_grad():
        for module in model.modules():
            if hasattr(module, 'reset_parameters'):
                module.reset_parameters(generator)
    return model


def _normal_(t: torch.Tensor, generator: torch.Generator, std: float = 1.0) -> None:
    t.copy_(torch.randn(t.shape, generator=generator) * std)


def normalize_2nd_moment(x: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=dim, keepdim=True) + eps)


class FullyConnected(nn.Module):
    """Equalized-lr dense layer with bias and activation."""

    def __init__(self, in_features: int, out_features: int, activation: str = 'linear',
                 lr_multiplier: float = 1.0, bias: bool = True, weight_init: float = 1.0,
                 bias_init: float = 0.0):
        super().__init__()
        self.activation = activation
        self.lr_multiplier = lr_multiplier
        self.weight_init, self.bias_init = weight_init, bias_init
        self.weight_gain = lr_multiplier / math.sqrt(in_features)
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        _normal_(self.weight, generator, self.weight_init / self.lr_multiplier)
        if self.bias is not None:
            self.bias.fill_(self.bias_init / self.lr_multiplier)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # as the JAX package: the weight cast to x's dtype, then scaled there
        y = F.linear(x, self.weight.to(x.dtype) * round_to(self.weight_gain, x.dtype))
        b = None if self.bias is None else self.bias * self.lr_multiplier
        return bias_act(y, b, act=self.activation)


class FourierEncoder1d(nn.Module):
    """Log-spaced Fourier features of scalars: [N, D] -> [N, D, 2*num_freqs]."""

    def __init__(self, coord_dim: int, max_x_value: float = 100.0):
        super().__init__()
        self.coord_dim = coord_dim
        num_freqs = int(np.ceil(np.log2(max_x_value)))
        coefs = (2.0 ** np.arange(num_freqs)) / 2 ** num_freqs * np.pi
        self.register_buffer('fourier_coefs', torch.tensor(coefs, dtype=torch.float32),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        raw = self.fourier_coefs[None, None, :] * x.float()[:, :, None]
        return torch.cat([torch.sin(raw), torch.cos(raw)], dim=2)


def fourier_dim_for(x_multiplier: float) -> int:
    return 0 if x_multiplier <= 0 else int(np.ceil(np.log2(x_multiplier))) * 2


def scalar_encoder_dim(coord_dim: int, x_multiplier: float, const_emb_dim: int,
                       use_raw: bool = False) -> int:
    return coord_dim * (const_emb_dim + fourier_dim_for(x_multiplier) + (1 if use_raw else 0))


class ConstEmbed(nn.Module):
    """A learned table looked up by integer index (flax `nn.Embed`)."""

    def __init__(self, num: int, dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(num, dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _normal_(self.embedding, generator, 1.0 / math.sqrt(self.embedding.shape[1]))

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return F.embedding(idx, self.embedding)


class ScalarEncoder1d(nn.Module):
    """Scalars in [0, 1] -> raw | Fourier features | learned table, flattened."""

    def __init__(self, coord_dim: int, x_multiplier: float, const_emb_dim: int,
                 use_raw: bool = False):
        super().__init__()
        self.coord_dim, self.x_multiplier, self.use_raw = coord_dim, x_multiplier, use_raw
        self.fourier = FourierEncoder1d(coord_dim, x_multiplier) if x_multiplier > 0 else None
        self.const_embed = (ConstEmbed(int(np.ceil(x_multiplier)) + 1, const_emb_dim)
                            if x_multiplier > 0 and const_emb_dim > 0 else None)
        self.out_dim = scalar_encoder_dim(coord_dim, x_multiplier, const_emb_dim, use_raw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        parts = [x[:, :, None]] if self.use_raw else []
        if self.fourier is not None:
            scaled = x.float() * self.x_multiplier
            parts.append(self.fourier(scaled))
            if self.const_embed is not None:
                parts.append(self.const_embed(torch.round(scaled).long()))
        return torch.cat(parts, dim=2).reshape(x.shape[0], -1)


class MappingNetwork(nn.Module):
    """z, c and camera angles -> w, or ws [N, num_ws, w_dim] when num_ws is set.

    Camera conditioning takes yaw and pitch wrapped into [-1, 1], as raw
    scalars (`camera_raw_scalars`) or encoded by `ScalarEncoder1d(2, 64, 0)`
    (6 Fourier frequencies, sin then cos, 24 features), dropped out with
    probability `camera_cond_drop_p` where `draws` are given (training).
    `w_avg` is the EMA of w that the JAX package keeps in its 'ema'
    collection: `update_emas` moves it toward the batch mean, and truncation
    pulls w toward it.
    """

    def __init__(self, z_dim: int, c_dim: int, w_dim: int, num_ws: Optional[int],
                 num_layers: int = 2, activation: str = 'lrelu', lr_multiplier: float = 0.01,
                 w_avg_beta: Optional[float] = 0.998, camera_cond: bool = False,
                 camera_cond_drop_p: float = 0.0, camera_raw_scalars: bool = True):
        super().__init__()
        self.z_dim, self.w_dim, self.num_ws = z_dim, w_dim, num_ws
        self.camera_cond, self.camera_cond_drop_p = camera_cond, camera_cond_drop_p
        self.w_avg_beta = w_avg_beta
        self.camera_scalar_enc = None
        if camera_cond:
            self.camera_scalar_enc = (ScalarEncoder1d(2, 0.0, 0, use_raw=True)
                                      if camera_raw_scalars else ScalarEncoder1d(2, 64.0, 0))
        embed_in = c_dim + (self.camera_scalar_enc.out_dim if camera_cond else 0)
        self.embed = FullyConnected(embed_in, w_dim) if embed_in > 0 else None
        in_dim = z_dim + (w_dim if embed_in > 0 else 0)
        for idx in range(num_layers):
            setattr(self, f'fc{idx}', FullyConnected(in_dim, w_dim, activation=activation,
                                                     lr_multiplier=lr_multiplier))
            in_dim = w_dim
        self.num_layers = num_layers
        if num_ws is not None and w_avg_beta is not None:
            self.register_buffer('w_avg', torch.zeros(w_dim))
        else:
            self.w_avg = None

    def forward(self, z: Optional[torch.Tensor], c: Optional[torch.Tensor],
                camera_angles: Optional[torch.Tensor] = None, truncation_psi: float = 1.0,
                update_emas: bool = False, draws: Optional[Draws] = None) -> torch.Tensor:
        if self.camera_cond:
            if camera_angles is None:
                raise ValueError('camera-conditioned mapping needs camera angles')
            ang = camera_angles[:, :2]
            ang = torch.sign(ang) * (torch.remainder(ang.abs(), 2.0 * math.pi) / (2.0 * math.pi))
            embs = self.camera_scalar_enc(ang)
            if draws is not None and self.camera_cond_drop_p > 0:
                keep = 1.0 - self.camera_cond_drop_p
                mask = draws.uniform('cond_drop', embs.shape) < keep
                embs = torch.where(mask, embs / keep, torch.zeros_like(embs))
            c = embs if c is None or c.shape[1] == 0 else torch.cat([c, embs], dim=1)
        x = normalize_2nd_moment(z.float()) if self.z_dim > 0 else None
        if self.embed is not None:
            y = normalize_2nd_moment(self.embed(c.float()))
            x = y if x is None else torch.cat([x, y], dim=1)
        for idx in range(self.num_layers):
            x = getattr(self, f'fc{idx}')(x)
        if self.w_avg is not None:
            if update_emas:
                with torch.no_grad():
                    new_avg = x.detach().mean(0)
                    self.w_avg.copy_(new_avg + (self.w_avg - new_avg) * self.w_avg_beta)
            if truncation_psi != 1.0:
                x = self.w_avg + (x - self.w_avg) * truncation_psi
        if self.num_ws is None:
            return x
        return x[:, None, :].repeat(1, self.num_ws, 1)


class Conv2dLayer(nn.Module):
    """Equalized-lr convolution with optional down/upsampling, bias,
    activation, clamp and hypernetwork modulation of its input
    (x * (1 + tanh(affine(c))))."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 bias: bool = True, activation: str = 'linear', up: int = 1, down: int = 1,
                 resample_filter=(1, 3, 3, 1), conv_clamp: Optional[float] = None,
                 hyper_mod_dim: int = 0):
        super().__init__()
        self.activation, self.up, self.down = activation, up, down
        self.conv_clamp, self.padding = conv_clamp, kernel_size // 2
        self.weight_gain = 1.0 / math.sqrt(in_channels * kernel_size ** 2)
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels, kernel_size,
                                               kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.affine = FullyConnected(hyper_mod_dim, in_channels) if hyper_mod_dim else None
        self.register_buffer('resample_filter', setup_filter(list(resample_filter))
                             if up > 1 or down > 1 else None, persistent=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _normal_(self.weight, generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor, c: Optional[torch.Tensor] = None,
                gain: float = 1.0) -> torch.Tensor:
        if self.affine is not None:
            x = x * (1.0 + torch.tanh(self.affine(c))).to(x.dtype)[:, None, None, :]
        # as the JAX package: the weight scaled in float32, then cast to x's dtype
        x = conv2d_resample(x, (self.weight * self.weight_gain).to(x.dtype),
                            f=self.resample_filter,
                            up=self.up, down=self.down, padding=self.padding,
                            flip_weight=(self.up == 1))
        act_gain = activation_funcs[self.activation].def_gain * gain
        clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, self.bias, act=self.activation, gain=act_gain, clamp=clamp)
