"""StyleGAN2 modulated convolution, NHWC, in float32 or bfloat16.

Port of `tdgp/ops/modulated_conv2d.py`: modulation and demodulation are
diagonal scalings, so they scale the activations around one convolution
with the shared weight, y = demod * conv(x * style, W) (docs/DESIGN.md:19-31).

In bfloat16 (a bf16 block: `x` in bf16, `weight` and `styles` in float32)
the cast points are the JAX package's: with demodulation, the weight is
first scaled per output channel to a largest magnitude of 1/sqrt(fan-in)
and the styles per sample to a largest magnitude of 1 (the overflow guard
of the StyleGAN2 reference); the demodulation coefficients are computed in
float32 from the scaled weight and styles; then the styles, the weight, the
coefficients and the noise are cast to `x.dtype`, and every product is
rounded to it.
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
    if x.dtype == torch.bfloat16 and demodulate:
        kh, kw = weight.shape[2:]
        w_norm = weight.abs().amax(dim=(1, 2, 3), keepdim=True)  # [Co, 1, 1, 1]
        fan_in = torch.tensor(ci * kh * kw, dtype=weight.dtype)
        weight = weight * ((1.0 / torch.sqrt(fan_in)) / (w_norm + 1e-12))
        styles = styles / (styles.abs().amax(dim=1, keepdim=True) + 1e-12)
    x = x * styles.to(x.dtype)[:, None, None, :]
    x = conv2d_resample(x, weight, f=resample_filter, up=up, padding=padding,
                        flip_weight=flip_weight)
    if demodulate:
        w2 = weight.square().sum(dim=(2, 3))                 # [Co, Ci]
        dcoefs = torch.rsqrt(styles.square() @ w2.t() + 1e-8)  # [N, Co]
        x = x * dcoefs.to(x.dtype)[:, None, None, :]
    if noise is not None:
        x = x + noise.to(x.dtype)
    return x
