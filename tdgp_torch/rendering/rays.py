"""Ray generation for a whole image (port of `tdgp/rendering/rays.py:sample_rays`,
without patch cropping)."""
from __future__ import annotations

import math
from typing import Tuple

import torch

from tdgp_torch.rendering.camera import normalize_vec


def sample_rays(c2w: torch.Tensor, fov: torch.Tensor,
                resolution: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """c2w [N, 4, 4], fov [N] in degrees, resolution (w, h)
    -> (ray origins [N, h*w, 3], ray directions [N, h*w, 3]), world space.

    NDC grid with y flipped to image memory order, pinhole directions.
    """
    n = c2w.shape[0]
    w, h = resolution
    kw = dict(dtype=torch.float32, device=c2w.device)
    x = torch.linspace(-1.0, 1.0, w, **kw)[None, :].expand(h, w).reshape(1, -1).expand(n, -1)
    y = torch.linspace(1.0, -1.0, h, **kw)[:, None].expand(h, w).reshape(1, -1).expand(n, -1)
    fov = fov.to(torch.float32).reshape(-1).expand(n)
    fov_rad = fov[:, None] / 360.0 * 2.0 * math.pi
    z = -torch.ones_like(x) / torch.tan(fov_rad * 0.5)
    ray_d_cam = normalize_vec(torch.stack([x, y, z], dim=2))
    ray_d_world = torch.einsum('bij,bpj->bpi', c2w[:, :3, :3], ray_d_cam)
    ray_o_world = c2w[:, None, :3, 3].expand_as(ray_d_world)
    return ray_o_world, ray_d_world
