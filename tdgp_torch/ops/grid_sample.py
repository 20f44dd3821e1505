"""Bilinear grid sampling (align_corners=True, zero padding), NHWC.

Port of `tdgp/ops/grid_sample.py:grid_sample_2d` through `F.grid_sample`:
the JAX package computes this gather in XLA, outside any Pallas kernel.
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
