"""Ray generation for a whole image or a patch of it
(port of `tdgp/rendering/rays.py:sample_rays`)."""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from tdgp_torch.rendering.camera import normalize_vec


def sample_rays(c2w: torch.Tensor, fov: torch.Tensor, resolution: Tuple[int, int],
                patch_params: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """c2w [N, 4, 4], fov [N] in degrees, resolution (w, h), patch params
    {'scales' [N,2], 'offsets' [N,2]} in [0, 1] units or None
    -> (ray origins [N, h*w, 3], ray directions [N, h*w, 3]), world space.

    NDC grid with y flipped to image memory order, rescaled to the patch,
    pinhole directions.
    """
    n = c2w.shape[0]
    w, h = resolution
    kw = dict(dtype=torch.float32, device=c2w.device)
    x = torch.linspace(-1.0, 1.0, w, **kw)[None, :].expand(h, w).reshape(1, -1).expand(n, -1)
    y = torch.linspace(1.0, -1.0, h, **kw)[:, None].expand(h, w).reshape(1, -1).expand(n, -1)
    if patch_params is not None:
        scales, offsets = patch_params['scales'], patch_params['offsets']
        x = (x + 1.0) * scales[:, 0:1] - 1.0 + offsets[:, 0:1] * 2.0
        y = (y + 1.0) * scales[:, 1:2] - 1.0 + offsets[:, 1:2] * 2.0
    fov = fov.to(torch.float32).reshape(-1).expand(n)
    fov_rad = fov[:, None] / 360.0 * 2.0 * math.pi
    z = -torch.ones_like(x) / torch.tan(fov_rad * 0.5)
    ray_d_cam = normalize_vec(torch.stack([x, y, z], dim=2))
    ray_d_world = torch.einsum('bij,bpj->bpi', c2w[:, :3, :3], ray_d_cam)
    ray_o_world = c2w[:, None, :3, 3].expand_as(ray_d_world)
    return ray_o_world, ray_d_world
