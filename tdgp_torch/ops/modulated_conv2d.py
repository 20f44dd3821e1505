"""StyleGAN2 modulated convolution, NHWC, float32.

Port of `tdgp/ops/modulated_conv2d.py`: modulation and demodulation are
diagonal scalings, so they scale the activations around one convolution
with the shared weight, y = demod * conv(x * style, W) (docs/DESIGN.md:19-31).
The JAX package's bf16 pre-normalization has no counterpart: the port runs
the generator at float32.
"""
from __future__ import annotations

from typing import Optional

import torch

from tdgp_torch.ops.conv2d_resample import conv2d_resample


def modulated_conv2d(
    x: torch.Tensor,                       # [N, H, W, Ci]
    weight: torch.Tensor,                  # [Co, Ci, kh, kw]
    styles: torch.Tensor,                  # [N, Ci]
    noise: Optional[torch.Tensor] = None,  # broadcastable to [N, Ho, Wo, Co]
    up: int = 1,
    padding: int = 0,
    resample_filter: Optional[torch.Tensor] = None,
    demodulate: bool = True,
    flip_weight: bool = True,
) -> torch.Tensor:
    n, ci = x.shape[0], x.shape[3]
    if styles.shape != (n, ci) or weight.shape[1] != ci:
        raise ValueError(f'styles {tuple(styles.shape)} / weight {tuple(weight.shape)} '
                         f'do not match x {tuple(x.shape)}')
    x = x * styles[:, None, None, :]
    x = conv2d_resample(x, weight, f=resample_filter, up=up, padding=padding,
                        flip_weight=flip_weight)
    if demodulate:
        w2 = weight.square().sum(dim=(2, 3))                 # [Co, Ci]
        dcoefs = torch.rsqrt(styles.square() @ w2.t() + 1e-8)  # [N, Co]
        x = x * dcoefs[:, None, None, :]
    if noise is not None:
        x = x + noise
    return x
