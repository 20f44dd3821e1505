"""Gaussian blur of D's input (port of `tdgp/training/blur.py`).

The kernel has the static support of the largest sigma, 2*floor(3*max)+1
taps, with the taps beyond floor(3*sigma) masked to 0, as in the JAX
package. At sigma 0 only the centre tap is left and the filter is the
identity, exactly, so it is skipped.
"""
from __future__ import annotations

from typing import Optional

import torch

from tdgp_torch.ops.upfirdn2d import filter2d


def gaussian_kernel_1d(sigma: float, max_sigma: float, denom: Optional[float] = None,
                       device=None) -> torch.Tensor:
    """Masked 2^{-(k/denom)^2} taps for |k| <= floor(3*sigma), normalized;
    denom defaults to sigma (the depth channel's blur uses 30)."""
    max_taps = int(max_sigma * 3)
    k = torch.arange(-max_taps, max_taps + 1, dtype=torch.float32, device=device)
    d = sigma if denom is None else denom
    f = torch.exp2(-torch.square(k / max(d, 1e-8)))
    f = torch.where(k.abs() <= float(torch.floor(torch.tensor(sigma * 3.0))), f,
                    torch.zeros_like(f))
    return f / f.sum()


def _filter(img: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    return filter2d(img, torch.outer(f, f))


def maybe_blur(img: torch.Tensor, sigma: float, max_sigma: float) -> torch.Tensor:
    """Blur [N, H, W, C] with sigma > 0; the identity otherwise."""
    if max_sigma <= 0 or sigma <= 0:
        return img
    return _filter(img, gaussian_kernel_1d(sigma, max_sigma, device=img.device))


def blur_depth_channel(img: torch.Tensor, sigma: float, max_sigma: float) -> torch.Tensor:
    """The extra blur of channel 3 (depth) with the denom=30 kernel; img [N,H,W,>=4]."""
    if max_sigma <= 0 or sigma <= 0:
        return img
    f = gaussian_kernel_1d(sigma, max_sigma, denom=30.0, device=img.device)
    return torch.cat([img[..., :3], _filter(img[..., 3:4], f), img[..., 4:]], dim=-1)
