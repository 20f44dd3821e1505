"""Patch-wise training utilities (port of `tdgp/training/patch.py`).

Patch parameters are drawn per mbstd group and repeated over the group, so
that minibatch-std statistics see one scale per group. The beta-distributed
scale is X / (X + Y) of two gamma draws. A `discrete_uniform` scale is one
of the `discrete_support` values within [min_scale, max_scale], each as
likely (the JAX package's masked categorical draw); with an empty support
it is the uniform draw.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from tdgp_torch.config import PatchCfg
from tdgp_torch.ops.grid_sample import grid_sample_nhwc
from tdgp_torch.utils.draws import Draws
from tdgp_torch.utils.xla_float import linspace_row, to_patch


def sample_patch_params(draws: Draws, n: int, cfg: PatchCfg, min_scale: float,
                        beta: float = 1.0) -> Dict[str, torch.Tensor]:
    """{scales [n,2], offsets [n,2]} in [0, 1] units."""
    group = cfg.mbstd_group_size
    if n % group:
        raise ValueError(f'batch {n} is not a multiple of the mbstd group {group}')
    groups = n // group
    if cfg.distribution == 'discrete_uniform' and cfg.discrete_support:
        scales_x = _discrete_scales(draws, groups, cfg, min_scale)
    elif cfg.distribution in ('uniform', 'discrete_uniform'):
        u = draws.uniform('scale', (groups,))
        scales_x = u * (cfg.max_scale - min_scale) + min_scale
    elif cfg.distribution == 'beta':
        x = draws.gamma('scale_a', torch.full((groups,), float(cfg.alpha)))
        y = draws.gamma('scale_b', torch.full((groups,), float(beta)))
        u = x / (x + y).clamp_min(1e-30)
        scales_x = u * (cfg.max_scale - min_scale) + min_scale
    else:
        raise NotImplementedError(cfg.distribution)
    scales = torch.stack([scales_x, scales_x], dim=1)
    offsets = draws.uniform('offset', (groups, 2)) * (1.0 - scales)
    return {'scales': scales.repeat_interleave(group, 0),
            'offsets': offsets.repeat_interleave(group, 0)}


def _discrete_scales(draws: Draws, groups: int, cfg: PatchCfg,
                     min_scale: float) -> torch.Tensor:
    """One value of the support per group, uniform over those in [min_scale,
    max_scale] (compared in float32, as the JAX package compares its float32
    support): the draw 'scale_index' picks the position among them. With
    none in range every group takes the first value, where the JAX
    package's categorical over all -inf logits lands."""
    support = np.asarray(cfg.discrete_support, np.float32)
    valid = np.flatnonzero((support >= np.float32(min_scale))
                           & (support <= np.float32(cfg.max_scale)))
    if valid.size == 0:
        valid = np.zeros(1, np.int64)
    values = torch.tensor(support[valid], device=draws.device)
    return values[draws.randint('scale_index', 0, valid.size, (groups,))]


def compute_patch_coords(patch_params: Dict[str, torch.Tensor], resolution: int) -> torch.Tensor:
    """Patch params -> grid_sample coords [N, res, res, 2] (align_corners=True).

    The positions are those of the JAX package's jitted step bit for bit
    (`utils.xla_float`)."""
    scales, offsets = patch_params['scales'], patch_params['offsets']
    row = linspace_row(resolution, scales.device)
    x = row[None, :].expand(resolution, resolution)
    coords = torch.stack([x, -x.t()], dim=2)[None]
    coords = to_patch(coords, scales[:, None, None, :], offsets[:, None, None, :])
    return torch.stack([coords[..., 0], -coords[..., 1]], dim=-1)  # grid_sample flips y


def extract_patches(x: torch.Tensor, patch_params: Dict[str, torch.Tensor],
                    resolution: int) -> torch.Tensor:
    """Crop and resize patches by bilinear sampling: [N,H,W,C] -> [N,res,res,C].

    The four-corner gather of `grid_sample_nhwc`, the JAX package's own
    sampler here, which is differentiable to any order: the 2D model's
    path-length penalty differentiates the crop's backward again, which
    neither cuDNN's nor PyTorch's CUDA grid sampler can."""
    if x.shape[1] != x.shape[2]:
        raise ValueError(f'square images only, got {tuple(x.shape)}')
    return grid_sample_nhwc(x, compute_patch_coords(patch_params, resolution),
                            align_corners=True)


def sample_random_c(draws: Draws, n: int, c_dim: int) -> torch.Tensor:
    """Random one-hot labels [n, c_dim]."""
    if c_dim == 0:
        return torch.zeros((n, 0), device=draws.device)
    idx = (draws.uniform('label', (n,)) * c_dim).long().clamp(max=c_dim - 1)
    return torch.nn.functional.one_hot(idx, c_dim).float()
