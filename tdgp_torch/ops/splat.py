"""Tri-plane sampling with kernel K1, the splat, as its backward.

Port of `tdgp/ops/splat.py`: `triplane_sample` is the counterpart of
`triplane_sample_fused` (:943). Its forward samples the x/y, x/z and y/z
planes bilinearly (align_corners=True, zero outside) and averages them, as
`tri_plane_sample` does on the serving path; the JAX package computes it in
XLA, and here it is `F.grid_sample` inside the autograd function, which
keeps no graph of its own. Its backward is the CUDA kernel of
`csrc/splat.cu` (K1, replacing `_splat_kernel` and the wide-window
`_splat_kernel_wide`, K2): the plane gradient as float32 atomics into a
zeroed buffer, and the coordinate gradient of `_coords_grad` (:973) from the
corner values read again. The context keeps the planes and the coordinates.

For CUDA tensors the backward launches the kernel and counts it in
`triplane_splat.launches`; for CPU tensors, and only for them, it computes
`triplane_sample_bwd_plain`: the scatter-add `triplane_splat_plain`
(`index_add_`, the counterpart of `triplane_splat_ref` :775) and the
coordinate gradient in plain PyTorch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from tdgp_torch.ops import cuda_build
from tdgp_torch.ops.grid_sample import grid_sample_2d

_PROJ = ((0, 1), (0, 2), (1, 2))  # plane projections: x/y, x/z, y/z


def tri_plane_sample(planes: torch.Tensor, coords: torch.Tensor, scale: float) -> torch.Tensor:
    """Sample the x/y, x/z and y/z planes at 3-D points and average them.

    planes: [N*3, H, W, F]; coords: [N, P, 3] world coordinates; scale: the
    cube's half side. Returns [N, P, F].
    """
    n3, _, _, f = planes.shape
    n, p = coords.shape[0], coords.shape[1]
    coords = coords / scale
    grids = torch.stack([coords[..., list(pr)] for pr in _PROJ], dim=1)
    feats = grid_sample_2d(planes, grids.reshape(n3, p, 2))
    return feats.reshape(n, 3, p, f).mean(dim=1)


def _corners(coords: torch.Tensor, scale: float, h: int, w: int):
    """Per (plane, point): corner rows (y0, x0), fractions (tx, ty) and the
    validity masks of the 4 corners 00, 01, 10, 11 -> each [N*3, P]."""
    n, p, _ = coords.shape
    c = coords / scale
    g2 = torch.stack([c[..., list(pr)] for pr in _PROJ], dim=1).reshape(n * 3, p, 2)
    gx = (g2[..., 0] + 1.0) * 0.5 * (w - 1)
    gy = (g2[..., 1] + 1.0) * 0.5 * (h - 1)
    x0, y0 = torch.floor(gx), torch.floor(gy)
    tx, ty = gx - x0, gy - y0
    x0, y0 = x0.long(), y0.long()

    def valid(yi, xi):
        return ((xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)).to(coords.dtype)

    masks = (valid(y0, x0), valid(y0, x0 + 1), valid(y0 + 1, x0), valid(y0 + 1, x0 + 1))
    return y0, x0, tx, ty, masks


def _corner_index(y0, x0, h: int, w: int):
    """Flat texel index of each corner in [N*3*H*W], clipped into the plane."""
    base = torch.arange(y0.shape[0], device=y0.device)[:, None] * (h * w)
    return [base + (y0 + dy).clamp(0, h - 1) * w + (x0 + dx).clamp(0, w - 1)
            for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1))]


def _point_cotangent(g: torch.Tensor) -> torch.Tensor:
    """Output cotangent [N, P, F] -> per (plane, point) rows [N*3, P, F]:
    the mean over the 3 planes gives each g / 3."""
    n, p, f = g.shape
    return (g / 3.0)[:, None].expand(n, 3, p, f).reshape(n * 3, p, f)


def triplane_splat_plain(g_pts: torch.Tensor, coords: torch.Tensor, scale: float,
                         n3: int, h: int, w: int) -> torch.Tensor:
    """The adjoint of the bilinear gather: each (plane, point) row of
    g_pts [N*3, P, F], times its corner weights, added into
    g_planes [N*3, H, W, F] with `index_add_`."""
    f = g_pts.shape[-1]
    y0, x0, tx, ty, masks = _corners(coords, scale, h, w)
    weights = ((1 - tx) * (1 - ty), tx * (1 - ty), (1 - tx) * ty, tx * ty)
    flat = torch.zeros((n3 * h * w, f), dtype=g_pts.dtype, device=g_pts.device)
    for idx, wt, m in zip(_corner_index(y0, x0, h, w), weights, masks):
        flat.index_add_(0, idx.reshape(-1), ((wt * m)[..., None] * g_pts).reshape(-1, f))
    return flat.reshape(n3, h, w, f)


def triplane_coords_grad_plain(planes: torch.Tensor, coords: torch.Tensor,
                               g_pts: torch.Tensor, scale: float) -> torch.Tensor:
    """d/d coords [N, P, 3] from the corner values of `planes` read again
    (`_coords_grad` of the JAX package)."""
    n3, h, w, f = planes.shape
    n, p = coords.shape[0], coords.shape[1]
    y0, x0, tx, ty, (m00, m01, m10, m11) = _corners(coords, scale, h, w)
    flat = planes.reshape(n3 * h * w, f)
    v00, v01, v10, v11 = (flat[idx] for idx in _corner_index(y0, x0, h, w))
    tx, ty = tx[..., None], ty[..., None]
    dtx = (g_pts * ((1 - ty) * (m01[..., None] * v01 - m00[..., None] * v00)
                    + ty * (m11[..., None] * v11 - m10[..., None] * v10))).sum(-1)
    dty = (g_pts * ((1 - tx) * (m10[..., None] * v10 - m00[..., None] * v00)
                    + tx * (m11[..., None] * v11 - m01[..., None] * v01))).sum(-1)
    dgx = (dtx * (0.5 * (w - 1) / scale)).reshape(n, 3, p)
    dgy = (dty * (0.5 * (h - 1) / scale)).reshape(n, 3, p)
    return torch.stack([dgx[:, 0] + dgx[:, 1], dgy[:, 0] + dgx[:, 2], dgy[:, 1] + dgy[:, 2]],
                       dim=-1)


def triplane_sample_bwd_plain(planes: torch.Tensor, coords: torch.Tensor, g: torch.Tensor,
                              scale: float, coords_grad: bool = True
                              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The backward of `tri_plane_sample` in plain PyTorch
    -> (g_planes [N*3, H, W, F], g_coords [N, P, 3] or None)."""
    n3, h, w, _ = planes.shape
    g_pts = _point_cotangent(g)
    g_planes = triplane_splat_plain(g_pts, coords, scale, n3, h, w)
    g_coords = triplane_coords_grad_plain(planes, coords, g_pts, scale) if coords_grad else None
    return g_planes, g_coords


@functools.cache
def _kernel():
    lib = cuda_build.library('splat')
    fn = lib.tdgp_triplane_splat
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.tdgp_splat_error_string.argtypes = [ctypes.c_int]
    lib.tdgp_splat_error_string.restype = ctypes.c_char_p
    return fn, lib.tdgp_splat_error_string


def _check(planes: torch.Tensor, coords: torch.Tensor) -> None:
    if planes.ndim != 4 or coords.ndim != 3 or coords.shape[2] != 3 \
            or planes.shape[0] != 3 * coords.shape[0]:
        raise ValueError(f'expected planes [3N,H,W,F] and coords [N,P,3], got '
                         f'{tuple(planes.shape)}, {tuple(coords.shape)}')
    for t in (planes, coords):
        if t.dtype != torch.float32:
            raise TypeError(f'triplane_sample takes float32, got {t.dtype}')
    if planes.device != coords.device:
        raise ValueError(f'inputs on {planes.device} and {coords.device}')


def triplane_splat(planes: torch.Tensor, coords: torch.Tensor, g: torch.Tensor, scale: float,
                   coords_grad: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The backward of `tri_plane_sample`: kernel K1 for CUDA tensors,
    `triplane_sample_bwd_plain` for CPU tensors.

    planes [N*3, H, W, F], coords [N, P, 3], g [N, P, F] (the cotangent of
    the plane mean) -> (g_planes [N*3, H, W, F], g_coords [N, P, 3] or None).
    """
    _check(planes, coords)
    device = planes.device
    if device.type == 'cpu':
        return triplane_sample_bwd_plain(planes, coords, g, scale, coords_grad)
    if device.type != 'cuda':
        raise ValueError(f'triplane_splat runs on CUDA or CPU tensors, not {device}')
    n3, h, w, f = planes.shape
    n, p = coords.shape[0], coords.shape[1]
    planes, coords = planes.contiguous(), coords.contiguous()
    g = g.to(torch.float32).contiguous()
    if tuple(g.shape) != (n, p, f):
        raise ValueError(f'cotangent {tuple(g.shape)} for output {(n, p, f)}')
    g_planes = torch.zeros((n3, h, w, f), dtype=torch.float32, device=device)
    g_coords = torch.empty((n, p, 3), dtype=torch.float32, device=device) if coords_grad else None
    fn, error_string = _kernel()
    with torch.cuda.device(device):
        err = fn(planes.data_ptr() if coords_grad else None, coords.data_ptr(), g.data_ptr(),
                 g_planes.data_ptr(), g_coords.data_ptr() if coords_grad else None,
                 n, p, h, w, f, float(scale), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'triplane_splat launch failed: {error_string(err).decode()}')
    triplane_splat.launches += 1
    return g_planes, g_coords


triplane_splat.launches = 0


class TriplaneSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, planes, coords, scale, plain):
        ctx.save_for_backward(planes, coords)
        ctx.scale, ctx.plain = scale, plain
        return tri_plane_sample(planes, coords, scale)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        planes, coords = ctx.saved_tensors
        bwd = triplane_sample_bwd_plain if ctx.plain else triplane_splat
        g_planes, g_coords = bwd(planes, coords, g, ctx.scale,
                                 coords_grad=ctx.needs_input_grad[1])
        return (g_planes if ctx.needs_input_grad[0] else None), g_coords, None, None


def triplane_sample(planes: torch.Tensor, coords: torch.Tensor, scale: float) -> torch.Tensor:
    """`tri_plane_sample` with kernel K1 as its backward: planes [N*3, H, W, F],
    coords [N, P, 3] -> plane-mean features [N, P, F]."""
    _check(planes, coords)
    return TriplaneSample.apply(planes, coords, scale, False)


def triplane_sample_reference(planes: torch.Tensor, coords: torch.Tensor,
                              scale: float) -> torch.Tensor:
    """`triplane_sample` with K1's plain version as its backward on any
    device: the reference the kernel is held against on the card."""
    _check(planes, coords)
    return TriplaneSample.apply(planes, coords, scale, True)
