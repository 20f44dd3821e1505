"""Bilinear grid sampling with zero padding, NHWC.

Port of `tdgp/ops/grid_sample.py`. `grid_sample_2d` (align_corners=True, the
patch extraction) goes through `F.grid_sample`; `grid_sample_nhwc` (the
augment pipe's geometric transform, align_corners=False) gathers the four
corners as the JAX function does, so that it is differentiable to any order
in `x` by construction: R1 takes a gradient of a gradient through it. The
JAX package computes both in XLA, outside any Pallas kernel.
coords[..., 0] = x indexes width and coords[..., 1] = y indexes height, as
in both frameworks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_2d(x: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """x: [N, H, W, C]; coords: [N, P, 2] in [-1, 1] -> [N, P, C]."""
    out = F.grid_sample(x.permute(0, 3, 1, 2), coords[:, None].to(x.dtype),
                        mode='bilinear', padding_mode='zeros', align_corners=True)
    return out[:, :, 0].transpose(1, 2)  # [N, C, 1, P] -> [N, P, C]


def _unnormalize(coord: torch.Tensor, size: int, align_corners: bool) -> torch.Tensor:
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def grid_sample_nhwc(x: torch.Tensor, grid: torch.Tensor,
                     align_corners: bool = True) -> torch.Tensor:
    """x: [N, H, W, C]; grid: [N, Ho, Wo, 2] in [-1, 1] -> [N, Ho, Wo, C]."""
    n, h, w, c = x.shape
    _, ho, wo, _ = grid.shape
    coords = grid.reshape(n, ho * wo, 2).to(x.dtype)
    gx = _unnormalize(coords[..., 0], w, align_corners)
    gy = _unnormalize(coords[..., 1], h, align_corners)
    x0, y0 = torch.floor(gx), torch.floor(gy)
    tx, ty = (gx - x0)[..., None], (gy - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    base = (torch.arange(n, device=x.device) * (h * w))[:, None]
    flat = x.reshape(n * h * w, c)

    def corner(yi, xi):
        valid = ((xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)).to(x.dtype)[..., None]
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1) + base
        return flat.index_select(0, idx.reshape(-1)).reshape(n, ho * wo, c), valid

    v00, m00 = corner(y0, x0)
    v01, m01 = corner(y0, x0 + 1)
    v10, m10 = corner(y0 + 1, x0)
    v11, m11 = corner(y0 + 1, x0 + 1)
    out = (v00 * ((1 - tx) * (1 - ty) * m00) + v01 * (tx * (1 - ty) * m01)
           + v10 * ((1 - tx) * ty * m10) + v11 * (tx * ty * m11))
    return out.reshape(n, ho, wo, c)
