"""Kernel K3: reduced classical volume integration and its gradient, in
CUDA C++ for Hopper.

Port of `tdgp/ops/pallas_kernels.py:ray_march_fused`: the forward replaces
`ray_march_pallas` (kernel `:86`), the backward the analytic jnp VJP
`_ray_march_bwd` (`:251`). Both packages reach it through the renderer's
`_march_reduced` when `generator.ray_march_impl` is 'fused'. The kernels are
in `csrc/ray_march.cu`; its source notes give the bounds and the design.

`ray_march_reduced` is differentiable (`RayMarchReduced`, which saves only
the three inputs, as the JAX VJP does). For CUDA tensors its forward
launches the forward kernel and counts the launch in
`ray_march_reduced.launches`, and its backward launches the backward kernel
and counts it in `ray_march_reduced_bwd.launches`. For CPU tensors, and
only for them, it computes `ray_march_reduced_plain` and
`ray_march_reduced_bwd_plain`, the same functions in plain PyTorch, which
the tests and the on-card comparison use as the reference.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from tdgp_torch.ops import cuda_build

_CLAMP_MODES = {'softplus': 0, 'relu': 1}
MAX_CHANNELS = 4


def _last_delta(use_inf_depth: bool) -> float:
    return 1e10 if use_inf_depth else 1e-3


def classical_ray_march_plain(colors: torch.Tensor, densities: torch.Tensor,
                              depths: torch.Tensor, clamp_mode: str = 'softplus',
                              sp_beta: float = 1.0, use_inf_depth: bool = True,
                              last_back: bool = False):
    """The classical marcher of `tdgp/rendering/renderer.py:62-105`.

    colors [B,R,S,C], densities [B,R,S], depths [B,R,S]
    -> (rgb [B,R,C], depth [B,R], weights [B,R,S], final_transmittance [B,R]).
    """
    deltas = depths[..., 1:] - depths[..., :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[..., :1], _last_delta(use_inf_depth))], -1)
    if clamp_mode == 'softplus':
        densities = F.softplus(sp_beta * densities) / sp_beta
    elif clamp_mode == 'relu':
        densities = F.relu(densities)
    else:
        raise NotImplementedError(f'Unknown clamp mode: {clamp_mode}')
    alphas = 1.0 - torch.exp(-deltas * densities)
    trans = torch.cumprod(1.0 - alphas + 1e-10, dim=-1)
    final_transmittance = trans[..., -1]
    weights = alphas * torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    if last_back:
        weights_agg = weights.sum(-1)
        weights = torch.cat([weights[..., :-1], weights[..., -1:] + (1.0 - weights_agg)[..., None]], -1)
    rgb = (weights[..., None] * colors).sum(-2)
    depth = (weights * depths).sum(-1)
    return rgb, depth, weights, final_transmittance


def ray_march_reduced_plain(colors, densities, depths, clamp_mode: str = 'softplus',
                            sp_beta: float = 1.0, use_inf_depth: bool = True,
                            last_back: bool = False):
    """-> (rgb [B,R,C], depth [B,R], weights_sum [B,R], final_transmittance [B,R])."""
    rgb, depth, weights, ftrans = classical_ray_march_plain(
        colors, densities, depths, clamp_mode, sp_beta, use_inf_depth, last_back)
    return rgb, depth, weights.sum(-1), ftrans


def ray_march_reduced_bwd_plain(colors, densities, depths, g_rgb, g_depth, g_wsum,
                                g_ftrans, clamp_mode: str = 'softplus', sp_beta: float = 1.0,
                                use_inf_depth: bool = True, last_back: bool = False):
    """The gradient of `ray_march_reduced_plain` from its three inputs and
    four cotangents, by the closed form of the JAX package's `_ray_march_bwd`
    -> (g_colors [B,R,S,C], g_densities [B,R,S], g_depths [B,R,S])."""
    deltas = depths[..., 1:] - depths[..., :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[..., :1], _last_delta(use_inf_depth))], -1)
    if clamp_mode == 'softplus':
        sigma = F.softplus(sp_beta * densities) / sp_beta
        dsigma = torch.sigmoid(sp_beta * densities)
    elif clamp_mode == 'relu':
        sigma = F.relu(densities)
        dsigma = (densities > 0).to(densities.dtype)
    else:
        raise NotImplementedError(f'Unknown clamp mode: {clamp_mode}')
    e = torch.exp(-deltas * sigma)
    alpha = 1.0 - e
    factor = 1.0 - alpha + 1e-10
    trans_incl = torch.cumprod(factor, dim=-1)
    t_excl = torch.cat([torch.ones_like(trans_incl[..., :1]), trans_incl[..., :-1]], -1)
    w = alpha * t_excl
    w_corr = w
    if last_back:
        w_corr = torch.cat([w[..., :-1], w[..., -1:] + (1.0 - w.sum(-1, keepdim=True))], -1)
    a = (colors * g_rgb[..., None, :]).sum(-1) + depths * g_depth[..., None] + g_wsum[..., None]
    g = a
    if last_back:
        g = torch.cat([(a - a[..., -1:])[..., :-1], torch.zeros_like(a[..., :1])], -1)
    gw = g * w
    suffix = gw.flip(-1).cumsum(-1).flip(-1) - gw
    gf = -g * t_excl + (suffix + g_ftrans[..., None] * trans_incl[..., -1:]) / factor
    g_densities = gf * (-deltas * e) * dsigma
    g_colors = w_corr[..., None] * g_rgb[..., None, :]
    gd = (gf * (-sigma * e))[..., :-1]
    g_depths = w_corr * g_depth[..., None]
    g_depths = g_depths - F.pad(gd, (0, 1)) + F.pad(gd, (1, 0))
    return g_colors, g_densities, g_depths


@functools.cache
def _kernels():
    lib = cuda_build.library('ray_march')
    scalars = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fwd = lib.tdgp_ray_march_reduced
    fwd.argtypes = [ctypes.c_void_p] * 7 + scalars
    fwd.restype = ctypes.c_int
    bwd = lib.tdgp_ray_march_reduced_bwd
    bwd.argtypes = [ctypes.c_void_p] * 10 + scalars
    bwd.restype = ctypes.c_int
    lib.tdgp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tdgp_cuda_error_string.restype = ctypes.c_char_p
    return fwd, bwd, lib.tdgp_cuda_error_string


def _launch(fn, error_string, what, device, tensors, n_rays, s, c, clamp_mode, sp_beta,
            use_inf_depth, last_back):
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f'{what} takes contiguous tensors')
    with torch.cuda.device(device):
        err = fn(*[t.data_ptr() for t in tensors], n_rays, s, c, _CLAMP_MODES[clamp_mode],
                 float(sp_beta), _last_delta(use_inf_depth), int(last_back),
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'{what} launch failed: {error_string(err).decode()}')


def _check(colors: torch.Tensor, densities: torch.Tensor, depths: torch.Tensor,
           clamp_mode: str) -> None:
    if clamp_mode not in _CLAMP_MODES:
        raise NotImplementedError(f'Unknown clamp mode: {clamp_mode}')
    if colors.ndim != 4 or densities.shape != colors.shape[:3] or depths.shape != densities.shape:
        raise ValueError(f'expected colors [B,R,S,C] and densities/depths [B,R,S], got '
                         f'{tuple(colors.shape)}, {tuple(densities.shape)}, {tuple(depths.shape)}')
    if not 1 <= colors.shape[3] <= MAX_CHANNELS or colors.shape[2] < 1:
        raise ValueError(f'need 1 <= C <= {MAX_CHANNELS} and S >= 1, got {tuple(colors.shape)}')
    for t in (colors, densities, depths):
        if t.dtype != torch.float32:
            raise TypeError(f'ray_march_reduced takes float32, got {t.dtype}')
        if t.device != colors.device:
            raise ValueError(f'inputs on {colors.device} and {t.device}')


def _forward(colors, densities, depths, clamp_mode, sp_beta, use_inf_depth, last_back):
    device = colors.device
    if device.type == 'cpu':
        return ray_march_reduced_plain(colors, densities, depths, clamp_mode, sp_beta,
                                       use_inf_depth, last_back)
    if device.type != 'cuda':
        raise ValueError(f'ray_march_reduced runs on CUDA or CPU tensors, not {device}')
    b, r, s, c = colors.shape
    rgb = torch.empty((b, r, c), dtype=torch.float32, device=device)
    depth, wsum, ftrans = (torch.empty((b, r), dtype=torch.float32, device=device)
                           for _ in range(3))
    fwd, _, error_string = _kernels()
    _launch(fwd, error_string, 'ray_march_reduced', device,
            (colors, densities, depths, rgb, depth, wsum, ftrans), b * r, s, c,
            clamp_mode, sp_beta, use_inf_depth, last_back)
    ray_march_reduced.launches += 1
    return rgb, depth, wsum, ftrans


def ray_march_reduced_bwd(colors, densities, depths, g_rgb, g_depth, g_wsum, g_ftrans,
                          clamp_mode: str = 'softplus', sp_beta: float = 1.0,
                          use_inf_depth: bool = True, last_back: bool = False):
    """The backward kernel for CUDA tensors, `ray_march_reduced_bwd_plain`
    for CPU tensors -> (g_colors, g_densities, g_depths)."""
    _check(colors, densities, depths, clamp_mode)
    device = colors.device
    if device.type == 'cpu':
        return ray_march_reduced_bwd_plain(colors, densities, depths, g_rgb, g_depth, g_wsum,
                                           g_ftrans, clamp_mode, sp_beta, use_inf_depth,
                                           last_back)
    if device.type != 'cuda':
        raise ValueError(f'ray_march_reduced_bwd runs on CUDA or CPU tensors, not {device}')
    b, r, s, c = colors.shape
    grads = [g.to(torch.float32).contiguous() for g in (g_rgb, g_depth, g_wsum, g_ftrans)]
    g_colors = torch.empty_like(colors)
    g_densities, g_depths = torch.empty_like(densities), torch.empty_like(depths)
    _, bwd, error_string = _kernels()
    _launch(bwd, error_string, 'ray_march_reduced_bwd', device,
            (colors, densities, depths, *grads, g_colors, g_densities, g_depths), b * r, s, c,
            clamp_mode, sp_beta, use_inf_depth, last_back)
    ray_march_reduced_bwd.launches += 1
    return g_colors, g_densities, g_depths


class RayMarchReduced(torch.autograd.Function):
    """K3 forward and backward, or with `plain` their plain versions on any
    device; the context keeps only the three inputs."""

    @staticmethod
    def forward(ctx, colors, densities, depths, clamp_mode, sp_beta, use_inf_depth, last_back,
                plain):
        ctx.save_for_backward(colors, densities, depths)
        ctx.opts = (clamp_mode, sp_beta, use_inf_depth, last_back)
        ctx.plain = plain
        fwd = ray_march_reduced_plain if plain else _forward
        return fwd(colors, densities, depths, clamp_mode, sp_beta, use_inf_depth, last_back)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_rgb, g_depth, g_wsum, g_ftrans):
        colors, densities, depths = ctx.saved_tensors
        grads = [torch.zeros_like(ref) if g is None else g
                 for g, ref in ((g_rgb, colors[..., 0, :]), (g_depth, depths[..., 0]),
                                (g_wsum, depths[..., 0]), (g_ftrans, depths[..., 0]))]
        bwd = ray_march_reduced_bwd_plain if ctx.plain else ray_march_reduced_bwd
        return (*bwd(colors, densities, depths, *grads, *ctx.opts),
                None, None, None, None, None)


def ray_march_reduced(colors: torch.Tensor, densities: torch.Tensor, depths: torch.Tensor,
                      clamp_mode: str = 'softplus', sp_beta: float = 1.0,
                      use_inf_depth: bool = True, last_back: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """colors [B,R,S,C], densities [B,R,S], depths [B,R,S], float32
    -> (rgb [B,R,C], depth [B,R], weights_sum [B,R], final_transmittance [B,R]).
    Differentiable in all three inputs (first order)."""
    _check(colors, densities, depths, clamp_mode)
    return RayMarchReduced.apply(colors, densities, depths, clamp_mode, sp_beta,
                                 use_inf_depth, last_back, False)


def ray_march_reduced_reference(colors, densities, depths, clamp_mode: str = 'softplus',
                                sp_beta: float = 1.0, use_inf_depth: bool = True,
                                last_back: bool = False):
    """`ray_march_reduced` through the plain forward and backward on any
    device: the reference the kernels are held against on the card."""
    _check(colors, densities, depths, clamp_mode)
    return RayMarchReduced.apply(colors, densities, depths, clamp_mode, sp_beta,
                                 use_inf_depth, last_back, True)


ray_march_reduced.launches = 0
ray_march_reduced_bwd.launches = 0
