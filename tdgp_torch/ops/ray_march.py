"""Kernel K3: reduced classical volume integration, in CUDA C++ for Hopper.

Port of `tdgp/ops/pallas_kernels.py:ray_march_pallas` (kernel `:86`),
reached in both packages through the renderer's `_march_reduced` when
`generator.ray_march_impl` is 'fused'. The kernel is `csrc/ray_march.cu`;
its source note gives the bound and the design.

`ray_march_reduced` launches the kernel for CUDA tensors and counts the
launch in `ray_march_reduced.launches`. For CPU tensors, and only for them,
it computes `ray_march_reduced_plain`, the same function in plain PyTorch,
which the tests and the on-card comparison use as the reference.
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


@functools.cache
def _kernel():
    lib = cuda_build.library('ray_march')
    fn = lib.tdgp_ray_march_reduced
    fn.argtypes = ([ctypes.c_void_p] * 7
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.tdgp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tdgp_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.tdgp_cuda_error_string


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


def ray_march_reduced(colors: torch.Tensor, densities: torch.Tensor, depths: torch.Tensor,
                      clamp_mode: str = 'softplus', sp_beta: float = 1.0,
                      use_inf_depth: bool = True, last_back: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """colors [B,R,S,C], densities [B,R,S], depths [B,R,S], float32
    -> (rgb [B,R,C], depth [B,R], weights_sum [B,R], final_transmittance [B,R])."""
    _check(colors, densities, depths, clamp_mode)
    device = colors.device
    if device.type == 'cpu':
        return ray_march_reduced_plain(colors, densities, depths, clamp_mode, sp_beta,
                                       use_inf_depth, last_back)
    if device.type != 'cuda':
        raise ValueError(f'ray_march_reduced runs on CUDA or CPU tensors, not {device}')
    for t in (colors, densities, depths):
        if not t.is_contiguous():
            raise ValueError('ray_march_reduced takes contiguous tensors')
    b, r, s, c = colors.shape
    rgb = torch.empty((b, r, c), dtype=torch.float32, device=device)
    depth, wsum, ftrans = (torch.empty((b, r), dtype=torch.float32, device=device)
                           for _ in range(3))
    fn, error_string = _kernel()
    with torch.cuda.device(device):
        err = fn(colors.data_ptr(), densities.data_ptr(), depths.data_ptr(),
                 rgb.data_ptr(), depth.data_ptr(), wsum.data_ptr(), ftrans.data_ptr(),
                 b * r, s, c, _CLAMP_MODES[clamp_mode], float(sp_beta),
                 _last_delta(use_inf_depth), int(last_back),
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'ray_march_reduced launch failed: {error_string(err).decode()}')
    ray_march_reduced.launches += 1
    return rgb, depth, wsum, ftrans


ray_march_reduced.launches = 0
