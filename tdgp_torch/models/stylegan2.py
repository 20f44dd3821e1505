"""StyleGAN2 synthesis stack, NHWC, float32 (port of `tdgp/models/stylegan2.py`).

Only the skip architecture that the tri-plane decoder uses is ported. The
noise is `noise_const * noise_strength` when no noise is given (serving),
or the given N(0, 1) buffers [N, res, res, 1] times `noise_strength`
(training; `SynthesisBlocksSequence.draw_noise` draws them beforehand, so
that a recomputed forward sees the same noise). Conv weights are stored as
[Co, Ci, kh, kw]; the learned const input stays [H, W, C] because
activations are NHWC.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tdgp_torch.models.layers import FullyConnected, _normal_
from tdgp_torch.ops.bias_act import bias_act
from tdgp_torch.ops.modulated_conv2d import modulated_conv2d
from tdgp_torch.ops.upfirdn2d import setup_filter, upsample2d
from tdgp_torch.utils.draws import Draws

RESAMPLE_FILTER = (1, 3, 3, 1)
CONV_CLAMP = 256.0


def sg2_block_resolutions(in_resolution: int, out_resolution: int) -> List[int]:
    in_log2 = 2 if in_resolution == 0 else int(np.log2(in_resolution)) + 1
    out_log2 = int(np.log2(out_resolution))
    return [2 ** i for i in range(in_log2, out_log2 + 1)]


def sg2_channel_dict(cbase: int, cmax: int, fmaps: float, resolutions: List[int]) -> Dict[int, int]:
    return {res: min(int(cbase * fmaps) // res, cmax) for res in resolutions}


def sg2_num_ws(in_resolution: int, out_resolution: int, has_input: bool = False) -> int:
    """w vectors consumed: 1 conv in a const-input first block, 2 in every
    other block, plus the last block's ToRGB."""
    n = 0
    for i, _ in enumerate(sg2_block_resolutions(in_resolution, out_resolution)):
        n += 2 if (i > 0 or has_input) else 1
    return n + 1


class SynthesisLayer(nn.Module):
    """Modulated conv + const noise + bias/lrelu/clamp."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, resolution: int,
                 up: int = 1, use_noise: bool = True):
        super().__init__()
        self.up = up
        self.use_noise = use_noise
        self.resolution = resolution
        self.affine = FullyConnected(w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        if use_noise:
            self.noise_strength = nn.Parameter(torch.zeros(()))
            self.register_buffer('noise_const', torch.zeros(resolution, resolution))
        self.register_buffer('resample_filter',
                             setup_filter(list(RESAMPLE_FILTER)) if up > 1 else None,
                             persistent=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _normal_(self.weight, generator)
        self.bias.zero_()
        if self.use_noise:
            self.noise_strength.zero_()
            _normal_(self.noise_const, generator)

    def forward(self, x: torch.Tensor, w: torch.Tensor,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """noise: N(0, 1) [N, res, res, 1], or None for the const noise."""
        styles = self.affine(w)
        if self.use_noise:
            noise = (self.noise_const[None, :, :, None] if noise is None else noise) \
                * self.noise_strength
        x = modulated_conv2d(x, self.weight, styles, noise=noise, up=self.up, padding=1,
                             resample_filter=self.resample_filter,
                             flip_weight=(self.up == 1))
        return bias_act(x, self.bias, act='lrelu', clamp=CONV_CLAMP)


class ToRGBLayer(nn.Module):
    """1x1 modulated conv without demodulation."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int):
        super().__init__()
        self.weight_gain = 1.0 / math.sqrt(in_channels)
        self.affine = FullyConnected(w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _normal_(self.weight, generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        styles = self.affine(w) * self.weight_gain
        x = modulated_conv2d(x, self.weight, styles, demodulate=False)
        return bias_act(x, self.bias, clamp=CONV_CLAMP)


class SynthesisBlock(nn.Module):
    """One resolution level of the skip architecture: (up-)conv, conv, ToRGB."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, resolution: int,
                 img_channels: int, use_noise: bool = True):
        super().__init__()
        self.in_channels = in_channels
        kw = dict(w_dim=w_dim, resolution=resolution, use_noise=use_noise)
        if in_channels == 0:
            self.const = nn.Parameter(torch.zeros(resolution, resolution, out_channels))
        else:
            self.conv0 = SynthesisLayer(in_channels, out_channels, up=2, **kw)
        self.conv1 = SynthesisLayer(out_channels, out_channels, **kw)
        self.torgb = ToRGBLayer(out_channels, img_channels, w_dim=w_dim)
        self.register_buffer('resample_filter', setup_filter(list(RESAMPLE_FILTER)),
                             persistent=False)

    @property
    def num_conv(self) -> int:
        return 1 if self.in_channels == 0 else 2

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.in_channels == 0:
            _normal_(self.const, generator)

    def forward(self, x: Optional[torch.Tensor], img: Optional[torch.Tensor],
                ws: torch.Tensor, noise: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """ws: [N, num_conv + 1, w_dim]; noise: 'conv0'/'conv1' -> buffer, or None."""
        noise = noise or {}
        if self.in_channels == 0:
            x = self.const[None].expand(ws.shape[0], -1, -1, -1)
        else:
            x = self.conv0(x, ws[:, 0], noise.get('conv0'))
        x = self.conv1(x, ws[:, self.num_conv - 1], noise.get('conv1'))
        if img is not None:
            img = upsample2d(img, self.resample_filter)
        y = self.torgb(x, ws[:, self.num_conv])
        return x, (img + y if img is not None else y)


class SynthesisBlocksSequence(nn.Module):
    """SynthesisBlocks from 4x4 (a learned const) to `out_resolution`."""

    def __init__(self, w_dim: int, out_resolution: int, out_channels: int,
                 cbase: int = 32768, cmax: int = 512, fmaps: float = 1.0,
                 use_noise: bool = True):
        super().__init__()
        self.resolutions = sg2_block_resolutions(0, out_resolution)
        channels = sg2_channel_dict(cbase, cmax, fmaps, self.resolutions)
        for idx, res in enumerate(self.resolutions):
            cin = channels[res // 2] if idx > 0 else 0
            setattr(self, f'b{res}', SynthesisBlock(
                cin, channels[res], w_dim=w_dim, resolution=res, img_channels=out_channels,
                use_noise=use_noise))
        self.num_ws = sg2_num_ws(0, out_resolution)

    def draw_noise(self, draws: Draws, n: int) -> Dict[str, Dict[str, torch.Tensor]]:
        """N(0, 1) buffers [n, res, res, 1] for every noisy layer, named
        'b<res>/conv0' and 'b<res>/conv1' in `draws`."""
        noise = {}
        for res in self.resolutions:
            block = getattr(self, f'b{res}')
            names = ['conv1'] if block.in_channels == 0 else ['conv0', 'conv1']
            noise[f'b{res}'] = {name: draws.normal(f'b{res}/{name}', (n, res, res, 1))
                                for name in names if getattr(block, name).use_noise}
        return noise

    def forward(self, ws: torch.Tensor,
                noise: Optional[Dict[str, Dict[str, torch.Tensor]]] = None) -> torch.Tensor:
        """ws [N, num_ws, w_dim] -> img [N, R, R, out_channels]; `noise` from
        `draw_noise`, or None for the const noise."""
        x = img = None
        w_idx = 0
        for res in self.resolutions:
            block = getattr(self, f'b{res}')
            x, img = block(x, img, ws[:, w_idx:w_idx + block.num_conv + 1],
                           None if noise is None else noise[f'b{res}'])
            w_idx += block.num_conv
        return img
