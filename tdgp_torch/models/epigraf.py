"""The tri-plane 3DGP generator (port of `tdgp/models/epigraf.py`).

A StyleGAN2 stack decodes w into three feature planes; rays sample the
planes (bilinear, align_corners=True) and average them, a small MLP maps the
features to (rgb, sigma), and the two-pass renderer integrates along the
rays. The depth adaptor turns the rendered depth into the fourth channel the
discriminator sees, and the camera adaptor warps prior cameras into the
learned camera distribution. Unless `fp32_only`, the decoder's
`num_fp16_res` highest-resolution blocks compute in bfloat16
(`models/stylegan2.py`); the planes leave the decoder in float32, and the
mapping, the sampling, the MLP and the renderer are float32 throughout,
unless `render_bf16`: then the planes are cast to bf16, sampled into bf16
features (`ops/splat.py`) and mapped by the MLP in bf16, as the JAX
package's bf16 render streams do (`tdgp/models/epigraf.py:241-244,
287-289`); rays, depths and the marches stay float32, and so do the density
queries of geometry extraction (`compute_densities`), as in JAX.
`Generator.view` builds such a view of a generator over its own parameters,
as the JAX train step's bf16 views (`training.dmain_fake_bf16`,
`training.gmain_render_bf16`) are.

At eval (serving) noise is the stored const noise and sampling draws
nothing, so a forward pass is a pure function of its inputs. In training
(`draws` given) the patch is rendered at the patch resolution with random
StyleGAN2 noise, jittered and importance-sampled rays, density noise and a
random depth-adaptor pick, all from `draws`. Where gradients flow, plane
sampling goes through `triplane_sample`, whose backward is kernel K1, and
the final march through kernel K3 forward and backward. Where they do not
(serving, inference, geometry), the MLP runs in kernel K4, every
bias + activation of the decoder and the mapping in kernel K5, and the
merge of the coarse and fine samples with the final march in K3's merged
entry. Under `render_bf16` the same routes take their bf16 entries: K4's
and K3's merged entry's where autograd does not record; where it records,
the bf16 `FullyConnected` layers and K1's bf16 entry, a render's two passes
rounding their plane gradient once together (`triplane_sample_pair`).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from tdgp_torch.config import GeneratorConfig
from tdgp_torch.models.camera_adaptor import CameraAdaptor
from tdgp_torch.models.depth_adaptor import DepthAdaptor
from tdgp_torch.models.layers import FullyConnected, MappingNetwork
from tdgp_torch.models.stylegan2 import SynthesisBlocksSequence, sg2_num_ws
from tdgp_torch.ops.bias_act import round_to
from tdgp_torch.ops.splat import tri_plane_sample, triplane_sample, triplane_sample_pair
from tdgp_torch.ops.triplane_mlp import fold_fully_connected, triplane_mlp
from tdgp_torch.rendering.camera import compute_cam2world_matrix
from tdgp_torch.rendering.rays import sample_rays
from tdgp_torch.rendering.renderer import RenderOptions, importance_render
from tdgp_torch.utils.draws import Draws
from tdgp_torch.utils.tensor_group import TensorGroup

__all__ = ['Generator', 'SynthesisNetwork', 'TriPlaneMLP', 'flatten_planes', 'tri_plane_sample']


def flatten_planes(planes: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 3, F] -> [N*3, H, W, F] (a copy)."""
    n, h, w, _, f = planes.shape
    return planes.permute(0, 3, 1, 2, 4).reshape(n * 3, h, w, f)


def resolve_march_impl(impl: str) -> str:
    """'auto' -> 'fused': the final march runs in kernel K3 on the card (on
    CPU tensors its wrapper computes the plain version)."""
    return 'fused' if impl == 'auto' else impl


def resolve_sample_impl(impl: str) -> str:
    """'auto' -> 'fused': the plane-sampling backward runs in kernel K1 on the
    card (on CPU tensors its wrapper computes the plain version). 'jnp', the
    JAX package's name for its plain path, is the same on CPU tensors and is
    refused on the card."""
    impl = 'fused' if impl == 'auto' else impl
    if impl not in ('fused', 'jnp'):
        raise NotImplementedError(f'plane_sample_impl {impl!r} is not ported')
    return impl


class TriPlaneMLP(nn.Module):
    """Plane features [N, P, F] -> (rgb [N, P, out_dim], sigma [N, P]).

    Where autograd records the call (training), and for any `n_layers` but
    2, it runs as its `FullyConnected` layers, as the JAX package does at
    every depth: on the card their products in cuBLAS and, where autograd
    does not record, each bias + activation in K5. Otherwise (serving,
    inference, geometry) the 2-layer MLP runs in kernel K4
    (`ops/triplane_mlp.py`) on the card, and in K4's plain version on the
    CPU. Under the mip marcher the colour is the MipNeRF clamp of the last
    layer's, sigmoid(x) x (1 + 2e-3) - 1e-3 (`tdgp/models/epigraf.py:125`).
    """

    def __init__(self, cfg: GeneratorConfig, out_dim: int):
        super().__init__()
        mlp = cfg.tri_plane.mlp
        if mlp.n_layers < 2:
            raise ValueError('the tri-plane MLP needs >= 2 layers')
        if cfg.ray_marcher_type not in ('classical', 'mip'):
            raise NotImplementedError(cfg.ray_marcher_type)
        self.mip = cfg.ray_marcher_type == 'mip'
        dims = [cfg.tri_plane.feat_dim] + [mlp.hid_dim] * (mlp.n_layers - 1) + [out_dim + 1]
        self.n_layers = mlp.n_layers
        for i in range(mlp.n_layers):
            act = 'lrelu' if i < mlp.n_layers - 1 else 'linear'
            setattr(self, f'fc{i}', FullyConnected(dims[i], dims[i + 1], activation=act))

    def forward(self, x: torch.Tensor):
        """x float32, or bf16 (the bf16 render views: the layers and K4's
        bf16 entry compute in bf16, as the JAX layers do on bf16 input)."""
        records = torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in self.parameters()))
        if records or self.n_layers != 2:
            for i in range(self.n_layers):
                x = getattr(self, f'fc{i}')(x)
            rgb, sigma = x[..., :-1], x[..., -1]
        else:
            dtype = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
            rgb, sigma = triplane_mlp(x, *fold_fully_connected(self.fc0, dtype),
                                      *fold_fully_connected(self.fc1, dtype))
        if self.mip:  # the constants weakly typed, in rgb's dtype
            rgb = torch.sigmoid(rgb) * round_to(1 + 2 * 0.001, rgb.dtype) \
                - round_to(0.001, rgb.dtype)
        return rgb, sigma


class SynthesisNetwork(nn.Module):
    """Tri-plane decoder + renderer + depth adaptor; hosts the camera adaptor."""

    def __init__(self, cfg: GeneratorConfig):
        super().__init__()
        self.cfg = cfg
        self.sample_impl = resolve_sample_impl(cfg.plane_sample_impl)
        self.num_ws = sg2_num_ws(0, cfg.tri_plane.res)
        self.tri_plane_decoder = SynthesisBlocksSequence(
            w_dim=cfg.w_dim, out_resolution=cfg.tri_plane.res,
            out_channels=cfg.tri_plane.feat_dim * 3, cbase=cfg.cbase, cmax=cfg.cmax,
            fmaps=cfg.fmaps, use_noise=cfg.use_noise, num_fp16_res=cfg.num_fp16_res,
            fp32_only=cfg.fp32_only)
        self.tri_plane_mlp = TriPlaneMLP(cfg, out_dim=cfg.img_channels)
        self.depth_adaptor = (DepthAdaptor(cfg.depth_adaptor, cfg.camera.ray.start,
                                           cfg.camera.ray.end)
                              if cfg.depth_adaptor.enabled else None)
        self.camera_adaptor = (CameraAdaptor(cfg.camera_adaptor, cfg.camera)
                               if cfg.camera_adaptor.enabled else None)

    def render_opts(self, cut_quantile: float = 0.0) -> RenderOptions:
        c = self.cfg
        return RenderOptions(
            num_proposal_steps=c.num_ray_steps, num_fine_steps=c.num_ray_steps,
            ray_start=c.camera.ray.start, ray_end=c.camera.ray.end,
            clamp_mode=c.clamp_mode, use_inf_depth=c.use_inf_depth,
            last_back=c.last_back, cut_quantile=cut_quantile,
            ray_marcher_type=c.ray_marcher_type, white_back=c.white_back,
            density_bias=c.density_bias, march_impl=resolve_march_impl(c.ray_march_impl))

    def decode_planes(self, ws: torch.Tensor,
                      noise: Optional[Dict[str, Dict[str, torch.Tensor]]] = None) -> torch.Tensor:
        """ws -> tri-planes [N, H, W, 3, F]. With gradients on and
        `decoder_remat`, the decoder's activations are recomputed in the
        backward instead of kept (the JAX package's `nn.remat`); the noise is
        drawn before, so the recomputation sees the same."""
        ws = ws[:, :self.num_ws]
        if self.cfg.decoder_remat and torch.is_grad_enabled():
            out = checkpoint(self.tri_plane_decoder, ws, noise, use_reentrant=False,
                             preserve_rng_state=False)
        else:
            out = self.tri_plane_decoder(ws, noise)
        n, h, w, _ = out.shape
        return out.reshape(n, h, w, 3, self.cfg.tri_plane.feat_dim)

    def apply_camera_adaptor(self, camera_params: TensorGroup, z: torch.Tensor,
                             c: Optional[torch.Tensor] = None) -> TensorGroup:
        if self.camera_adaptor is None:
            raise ValueError('the camera adaptor is disabled')
        return self.camera_adaptor(camera_params, z, c)

    def compute_densities(self, ws: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        """Density at arbitrary points, for geometry extraction (the
        counterpart of `tdgp/models/epigraf.py:207`), with the const noise:
        ws [N, num_ws, w_dim], coords [N, P, 3] -> sigma [N, P]."""
        return self.sample_densities(flatten_planes(self.decode_planes(ws)), coords)

    def sample_densities(self, planes: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        """sigma [N, P] at coords [N, P, 3] from decoded planes [N*3, H, W, F]."""
        _, sigma = self.tri_plane_mlp(self._sample_fn(planes.device)(planes, coords))
        return sigma

    def _sample_fn(self, device: torch.device, dtype: torch.dtype = torch.float32):
        """The plane sampler for planes on `device` of `dtype`: without
        gradients the gather, with them `triplane_sample` (K1 as its
        backward), for bf16 planes a `triplane_sample_pair` for the two
        passes of one render."""
        scale = self.cfg.camera.cube_scale
        if self.sample_impl == 'jnp' and device.type != 'cpu':
            raise NotImplementedError("plane_sample_impl 'jnp' (the plain splat) runs on CPU "
                                      "tensors only; on the card it runs in kernel K1 ('fused')")
        if not torch.is_grad_enabled():
            return lambda planes, coords: tri_plane_sample(planes, coords, scale)
        if dtype == torch.bfloat16:
            return triplane_sample_pair(scale)
        return lambda planes, coords: triplane_sample(planes, coords, scale)

    def forward(self, ws: torch.Tensor, camera_params: TensorGroup,
                patch_params: Optional[Dict[str, torch.Tensor]] = None, *,
                draws: Optional[Draws] = None, concat_depth: bool = False,
                return_depth: bool = False, nerf_noise_std: float = 0.0,
                depth_progress: float = 1.0, cut_quantile: float = 0.0,
                resolution: Optional[int] = None, ray_chunk: Optional[int] = None):
        """-> images [N, H, W, img_channels (+1 with concat_depth)], or
        TensorGroup(img, depth) with `return_depth`.

        `draws` given is training: the output is the patch resolution when
        patches are on, and every random choice comes from `draws`
        ('noise/...', 'render/...', 'depth/...'). Rays are rendered
        `ray_chunk` at a time (per image) when given. `cut_quantile` > 0
        zeroes the densities below that quantile of each render call (all
        images, the chunk's rays) in both marches, as the JAX package's
        eval renders for NFS do.
        """
        c = self.cfg
        n = ws.shape[0]
        train = draws is not None
        if resolution is None:
            resolution = c.patch.resolution if (train and c.patch.enabled) else c.img_resolution
        h = w = resolution
        noise = self.tri_plane_decoder.draw_noise(draws.scope('noise'), n) if train else None
        planes = flatten_planes(self.decode_planes(ws, noise))
        if c.render_bf16:
            planes = planes.to(torch.bfloat16)
        c2w = compute_cam2world_matrix(camera_params)
        ray_o, ray_d = sample_rays(c2w, camera_params.fov, resolution=(w, h),
                                   patch_params=patch_params)
        opts = self.render_opts(cut_quantile)
        sample = self._sample_fn(planes.device, planes.dtype)
        if c.render_bf16 and not torch.is_grad_enabled():
            # the gather sums in float32: widen the bf16 planes once, not per pass and chunk
            planes = planes.float()
            sample = functools.partial(tri_plane_sample, scale=c.camera.cube_scale,
                                       out_dtype=torch.bfloat16)

        def run_model(coords):
            return self.tri_plane_mlp(sample(planes, coords))

        chunk = h * w if ray_chunk is None else min(ray_chunk, h * w)
        if (h * w) % chunk:
            raise ValueError(f'ray_chunk {ray_chunk} does not divide {h * w} rays')
        if train and chunk != h * w:
            raise NotImplementedError('ray chunks in training')
        render_draws = draws.scope('render') if train else None
        outs = [importance_render(run_model, ray_o[:, i:i + chunk], ray_d[:, i:i + chunk], opts,
                                  draws=render_draws, density_noise=nerf_noise_std)
                for i in range(0, h * w, chunk)]
        img = torch.cat([o[0] for o in outs], dim=1).reshape(n, h, w, c.img_channels)
        depth = torch.cat([o[1] for o in outs], dim=1).reshape(n, h, w, 1)
        if concat_depth:
            if self.depth_adaptor is None:
                raise ValueError('concat_depth needs the depth adaptor')
            depth_adapted = self.depth_adaptor(
                depth, progress=depth_progress,
                draws=draws.scope('depth') if train else None)
            img = torch.cat([img, depth_adapted], dim=-1)
        if return_depth:
            return TensorGroup(img=img, depth=depth)
        return img


class Generator(nn.Module):
    """Mapping + tri-plane synthesis; serving calls `map_ws`, then `synthesis`."""

    def __init__(self, cfg: GeneratorConfig):
        super().__init__()
        self.cfg = cfg
        self.synthesis = SynthesisNetwork(cfg)
        self.mapping = MappingNetwork(
            z_dim=cfg.z_dim, c_dim=cfg.c_dim, w_dim=cfg.w_dim,
            num_ws=self.synthesis.num_ws, num_layers=cfg.map_depth,
            camera_cond=cfg.camera_cond, camera_cond_drop_p=cfg.camera_cond_drop_p,
            camera_raw_scalars=cfg.camera_cond_raw)

    def view(self, cfg: GeneratorConfig) -> 'Generator':
        """A Generator of config `cfg` (one that differs from this one's only
        in precision, as `config.render_bf16_view` makes it) over this
        generator's own parameter and buffer tensors: a change to either
        shows in both. Not a submodule: it saves nothing of its own."""
        view = Generator(cfg)
        pairs = list(zip(view.named_modules(), self.named_modules()))
        if len(pairs) != len(list(self.modules())) or any(
                name != their_name or type(mine) is not type(theirs)
                for (name, mine), (their_name, theirs) in pairs):
            raise ValueError('a view must differ from its generator only in precision')
        for (_, mine), (_, theirs) in pairs:
            mine._parameters, mine._buffers = theirs._parameters, theirs._buffers
            mine.training = theirs.training
        return view

    def map_ws(self, z: torch.Tensor, c: Optional[torch.Tensor],
               camera_angles: Optional[torch.Tensor] = None,
               truncation_psi: float = 1.0) -> torch.Tensor:
        return self.mapping(z, c, camera_angles=camera_angles, truncation_psi=truncation_psi)
