"""The tri-plane 3DGP generator at eval (port of `tdgp/models/epigraf.py`).

A StyleGAN2 stack decodes w into three feature planes; rays sample the
planes (bilinear, align_corners=True) and average them, a small MLP maps the
features to (rgb, sigma), and the two-pass renderer integrates along the
rays. Noise is the stored const noise and sampling draws nothing, so a
forward pass is a pure function of its inputs.

The depth adaptor's output is dropped on the serving path and the camera
adaptor is not called there, so neither is built here; their weights are
named in `tdgp_torch.weights.SKIPPED_PREFIXES`. The generator runs at
float32 only (`fp32_only=True`).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tdgp_torch.config import GeneratorConfig
from tdgp_torch.models.layers import FullyConnected, MappingNetwork
from tdgp_torch.models.stylegan2 import SynthesisBlocksSequence, sg2_num_ws
from tdgp_torch.ops.grid_sample import grid_sample_2d
from tdgp_torch.rendering.camera import compute_cam2world_matrix
from tdgp_torch.rendering.rays import sample_rays
from tdgp_torch.rendering.renderer import RenderOptions, importance_render
from tdgp_torch.utils.tensor_group import TensorGroup


def flatten_planes(planes: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 3, F] -> [N*3, H, W, F] (a copy)."""
    n, h, w, _, f = planes.shape
    return planes.permute(0, 3, 1, 2, 4).reshape(n * 3, h, w, f)


def tri_plane_sample(planes: torch.Tensor, coords: torch.Tensor, scale: float) -> torch.Tensor:
    """Sample the x/y, x/z and y/z planes at 3-D points and average them.

    planes: [N*3, H, W, F]; coords: [N, P, 3] world coordinates; scale: the
    cube's half side. Returns [N, P, F].
    """
    n3, _, _, f = planes.shape
    n, p = coords.shape[0], coords.shape[1]
    coords = coords / scale
    grids = torch.stack([coords[..., [0, 1]], coords[..., [0, 2]], coords[..., [1, 2]]], dim=1)
    feats = grid_sample_2d(planes, grids.reshape(n3, p, 2))
    return feats.reshape(n, 3, p, f).mean(dim=1)


def resolve_march_impl(impl: str) -> str:
    """'auto' -> 'fused': the final march runs in kernel K3 on the card (on
    CPU tensors its wrapper computes the plain version)."""
    return 'fused' if impl == 'auto' else impl


class TriPlaneMLP(nn.Module):
    """Plane features [N, P, F] -> (rgb [N, P, out_dim], sigma [N, P])."""

    def __init__(self, cfg: GeneratorConfig, out_dim: int):
        super().__init__()
        mlp = cfg.tri_plane.mlp
        if mlp.n_layers < 2:
            raise ValueError('the tri-plane MLP needs >= 2 layers')
        if cfg.ray_marcher_type != 'classical':
            raise NotImplementedError(f'ray marcher {cfg.ray_marcher_type!r} is not ported')
        dims = [cfg.tri_plane.feat_dim] + [mlp.hid_dim] * (mlp.n_layers - 1) + [out_dim + 1]
        self.n_layers = mlp.n_layers
        for i in range(mlp.n_layers):
            act = 'lrelu' if i < mlp.n_layers - 1 else 'linear'
            setattr(self, f'fc{i}', FullyConnected(dims[i], dims[i + 1], activation=act))

    def forward(self, x: torch.Tensor):
        for i in range(self.n_layers):
            x = getattr(self, f'fc{i}')(x)
        return x[..., :-1], x[..., -1]


class SynthesisNetwork(nn.Module):
    """Tri-plane decoder + renderer, eval forward."""

    def __init__(self, cfg: GeneratorConfig):
        super().__init__()
        if not cfg.fp32_only:
            raise NotImplementedError('the port runs the generator at float32: '
                                      'set generator.fp32_only=true')
        if cfg.architecture != 'skip':
            raise NotImplementedError(f'architecture {cfg.architecture!r} is not ported')
        self.cfg = cfg
        self.num_ws = sg2_num_ws(0, cfg.tri_plane.res)
        self.tri_plane_decoder = SynthesisBlocksSequence(
            w_dim=cfg.w_dim, out_resolution=cfg.tri_plane.res,
            out_channels=cfg.tri_plane.feat_dim * 3, cbase=cfg.cbase, cmax=cfg.cmax,
            fmaps=cfg.fmaps, use_noise=cfg.use_noise)
        self.tri_plane_mlp = TriPlaneMLP(cfg, out_dim=cfg.img_channels)

    def render_opts(self) -> RenderOptions:
        c = self.cfg
        return RenderOptions(
            num_proposal_steps=c.num_ray_steps, num_fine_steps=c.num_ray_steps,
            ray_start=c.camera.ray.start, ray_end=c.camera.ray.end,
            clamp_mode=c.clamp_mode, use_inf_depth=c.use_inf_depth,
            last_back=c.last_back, march_impl=resolve_march_impl(c.ray_march_impl))

    def decode_planes(self, ws: torch.Tensor) -> torch.Tensor:
        """ws -> tri-planes [N, H, W, 3, F]."""
        out = self.tri_plane_decoder(ws[:, :self.num_ws])
        n, h, w, _ = out.shape
        return out.reshape(n, h, w, 3, self.cfg.tri_plane.feat_dim)

    def forward(self, ws: torch.Tensor, camera_params: TensorGroup,
                resolution: Optional[int] = None,
                ray_chunk: Optional[int] = None) -> torch.Tensor:
        """-> images [N, H, W, img_channels]; rays are rendered `ray_chunk`
        at a time (per image) when given."""
        c = self.cfg
        n = ws.shape[0]
        h = w = c.img_resolution if resolution is None else resolution
        planes = flatten_planes(self.decode_planes(ws))
        c2w = compute_cam2world_matrix(camera_params)
        ray_o, ray_d = sample_rays(c2w, camera_params.fov, resolution=(w, h))
        opts = self.render_opts()

        def run_model(coords):
            return self.tri_plane_mlp(tri_plane_sample(planes, coords, c.camera.cube_scale))

        chunk = h * w if ray_chunk is None else min(ray_chunk, h * w)
        if (h * w) % chunk:
            raise ValueError(f'ray_chunk {ray_chunk} does not divide {h * w} rays')
        rgb = torch.cat([importance_render(run_model, ray_o[:, i:i + chunk],
                                           ray_d[:, i:i + chunk], opts)[0]
                         for i in range(0, h * w, chunk)], dim=1)
        return rgb.reshape(n, h, w, c.img_channels)


class Generator(nn.Module):
    """Mapping + tri-plane synthesis; serving calls `map_ws`, then `synthesis`."""

    def __init__(self, cfg: GeneratorConfig):
        super().__init__()
        self.cfg = cfg
        self.synthesis = SynthesisNetwork(cfg)
        self.mapping = MappingNetwork(
            z_dim=cfg.z_dim, c_dim=cfg.c_dim, w_dim=cfg.w_dim,
            num_ws=self.synthesis.num_ws, num_layers=cfg.map_depth,
            camera_cond=cfg.camera_cond, camera_raw_scalars=cfg.camera_cond_raw)

    def map_ws(self, z: torch.Tensor, c: Optional[torch.Tensor],
               camera_angles: Optional[torch.Tensor] = None,
               truncation_psi: float = 1.0) -> torch.Tensor:
        return self.mapping(z, c, camera_angles=camera_angles, truncation_psi=truncation_psi)
