"""Tri-plane sampling with kernel K1, the splat, as its backward.

Port of `tdgp/ops/splat.py`: `triplane_sample` is the counterpart of
`triplane_sample_fused` (:943). Its forward samples the x/y, x/z and y/z
planes bilinearly (align_corners=True, zero outside) and averages them, as
`tri_plane_sample` does on the serving path; the JAX package computes it in
XLA, and here it is `F.grid_sample` inside the autograd function, which
keeps no graph of its own. Its backward is the CUDA kernel of
`csrc/splat.cu` (K1, replacing `_splat_kernel` and the wide-window
`_splat_kernel_wide`, K2). As the TPU kernel does, it works on entries
grouped by the window they fall in: here a window is a STRIP_H x STRIP_W
strip of one plane. Every (plane, point) entry is keyed by the strip of its
base corner and copied to the strip on the right, below and diagonally
below wherever its 2x2 footprint reaches into them; `_bins` is that
arithmetic in torch, and `triplane_splat_bins` the same bins on the card (a
histogram and a scatter kernel, with the offsets summed in torch). The
kernel then gives each strip one warp, which sums its entries in shared
memory and writes the strip of the plane gradient once; the entry's home
strip also computes its coordinate gradient (`_coords_grad` :973). The
context keeps the planes and the coordinates.

For CUDA tensors the backward launches the kernel and counts it in
`triplane_splat.launches`; for CPU tensors, and only for them, it computes
`triplane_sample_bwd_plain`: the scatter-add `triplane_splat_plain`
(`index_add_`, the counterpart of `triplane_splat_ref` :775) and the
coordinate gradient in plain PyTorch. `triplane_splat_binned_plain` walks
the kernel's bins in plain PyTorch, for the tests.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
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


def _plane_coords(coords: torch.Tensor, scale: float, h: int, w: int) -> torch.Tensor:
    """Plane-pixel coordinates (gx, gy) of every (plane, point) -> [N*3, P, 2]:
    the one place the sampler's corners are computed, for the plain versions
    and for the kernel's bins alike."""
    n, p, _ = coords.shape
    c = coords / scale
    g2 = torch.stack([c[..., list(pr)] for pr in _PROJ], dim=1).reshape(n * 3, p, 2)
    size = torch.tensor([w - 1, h - 1], dtype=coords.dtype, device=coords.device)
    return (g2 + 1.0) * 0.5 * size


def _corners(coords: torch.Tensor, scale: float, h: int, w: int):
    """Per (plane, point): corner rows (y0, x0), fractions (tx, ty) and the
    validity masks of the 4 corners 00, 01, 10, 11 -> each [N*3, P]."""
    gxy = _plane_coords(coords, scale, h, w)
    gx, gy = gxy[..., 0], gxy[..., 1]
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
    return _combine_coords_grad(dtx, dty, n, p, h, w, scale)


def _combine_coords_grad(dtx, dty, n: int, p: int, h: int, w: int, scale: float):
    """Per (plane, point) derivatives in plane pixels [N*3, P] -> d/d coords
    [N, P, 3]: the x/y, x/z and y/z planes read (x, y), (x, z), (y, z)."""
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


KERNEL_FEATS = (8, 16, 32)  # feature widths K1 is instantiated for (csrc/splat.cu)
STRIP_H, STRIP_W = 4, 8  # texels of the strip that one warp of K1 sums (csrc/splat.cu)


def _strips(h: int, w: int) -> Tuple[int, int]:
    """Strips down and across one H x W plane."""
    return -(-h // STRIP_H), -(-w // STRIP_W)


def _strip_origin(b: int, h: int, w: int) -> Tuple[int, int, int]:
    """Bin b -> (plane, first row, first column) of its strip, as the kernel
    reads it from its warp's index."""
    strips_y, strips_x = _strips(h, w)
    plane, t = divmod(b, strips_y * strips_x)
    return plane, (t // strips_x) * STRIP_H, (t % strips_x) * STRIP_W


def _bins(gxy: torch.Tensor, h: int, w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorts the (plane, point) entries into the strips their 2x2 footprints
    meet: kernel K1's bins.

    gxy [N*3, P, 2] (`_plane_coords`) -> (entries [R] int32: plane * P +
    point, grouped by strip; offsets [n_bins + 1] int32: strip b's entries
    are entries[offsets[b]:offsets[b + 1]]). A strip is STRIP_H x STRIP_W
    texels of one plane; bin b is strip b in (plane, row, column) order. An
    entry goes to the strip of its base corner clamped into the plane (its
    home, which also computes its coordinate gradient) and, where its base
    corner is the last texel of a strip's column or row, also to the strips
    on the right, below and diagonally below. Entries with no corner in the
    plane are dropped. Within a strip the entries keep their order (a stable
    sort), home entries first; the card's `triplane_splat_bins` gives the
    same bins, each in the order of its atomics."""
    n3, p, _ = gxy.shape
    strips_y, strips_x = _strips(h, w)
    gx, gy = gxy[..., 0], gxy[..., 1]
    inside = (gx >= -1) & (gx < w) & (gy >= -1) & (gy < h)  # some corner in the plane
    x0 = torch.floor(gx).clamp(-1, w - 1).to(torch.int32)
    y0 = torch.floor(gy).clamp(-1, h - 1).to(torch.int32)
    cross_x = (x0 >= 0) & (x0 % STRIP_W == STRIP_W - 1) & (x0 + 1 < w)
    cross_y = (y0 >= 0) & (y0 % STRIP_H == STRIP_H - 1) & (y0 + 1 < h)
    plane = torch.arange(n3, dtype=torch.int32, device=gxy.device)[:, None]
    home = (plane * strips_y + y0.clamp_min(0) // STRIP_H) * strips_x + x0.clamp_min(0) // STRIP_W
    keys = torch.stack([home, home + 1, home + strips_x, home + strips_x + 1])
    valid = torch.stack([inside, inside & cross_x, inside & cross_y, inside & cross_x & cross_y])
    entry = torch.arange(n3 * p, dtype=torch.int32, device=gxy.device).reshape(n3, p)
    keys, entries = keys[valid], entry.expand(4, n3, p)[valid]
    keys, order = torch.sort(keys, stable=True)
    offsets = torch.searchsorted(
        keys, torch.arange(n3 * strips_y * strips_x + 1, dtype=torch.int32, device=gxy.device),
        out_int32=True)
    return entries[order], offsets


def triplane_splat_binned_plain(planes: torch.Tensor, coords: torch.Tensor, g: torch.Tensor,
                                scale: float, coords_grad: bool = True
                                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Kernel K1's algorithm in plain PyTorch, for the tests: walks the bins
    of `_bins` strip by strip (the kernel's warps), sums each strip's share
    of its entries into a STRIP_H x STRIP_W accumulator that then becomes
    that strip of g_planes, and takes each entry's coordinate gradient in
    its home strip. Same outputs as `triplane_sample_bwd_plain`."""
    n3, h, w, f = planes.shape
    n, p = coords.shape[0], coords.shape[1]
    gxy = _plane_coords(coords, scale, h, w).reshape(n3 * p, 2)
    entries, offsets = _bins(gxy.reshape(n3, p, 2), h, w)
    g_pts = _point_cotangent(g).reshape(n3 * p, f)
    g_planes = torch.empty_like(planes)
    d = torch.zeros((n3 * p, 2), dtype=planes.dtype, device=planes.device)
    for b in range(len(offsets) - 1):
        plane, y_base, x_base = _strip_origin(b, h, w)
        acc = torch.zeros((STRIP_H, STRIP_W, f), dtype=planes.dtype, device=planes.device)
        e = entries[offsets[b]:offsets[b + 1]].long()
        gx, gy = gxy[e, 0], gxy[e, 1]
        fx0, fy0 = torch.floor(gx), torch.floor(gy)
        tx, ty = (gx - fx0)[:, None], (gy - fy0)[:, None]
        x0, y0 = fx0.long(), fy0.long()
        gv = g_pts[e]
        corners = {}
        for dy, dx, wt in ((0, 0, (1 - tx) * (1 - ty)), (0, 1, tx * (1 - ty)),
                           (1, 0, (1 - tx) * ty), (1, 1, tx * ty)):
            yy, xx = y0 + dy, x0 + dx
            valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            ly, lx = yy - y_base, xx - x_base
            mine = valid & (ly >= 0) & (ly < STRIP_H) & (lx >= 0) & (lx < STRIP_W)
            acc.index_put_((ly[mine], lx[mine]), (wt * gv)[mine], accumulate=True)
            corners[dy, dx] = valid, yy.clamp(0, h - 1), xx.clamp(0, w - 1)
        rows, cols = min(STRIP_H, h - y_base), min(STRIP_W, w - x_base)
        g_planes[plane, y_base:y_base + rows, x_base:x_base + cols] = acc[:rows, :cols]
        home = ((y0.clamp_min(0) - y_base).div(STRIP_H, rounding_mode='floor') == 0) \
            & ((x0.clamp_min(0) - x_base).div(STRIP_W, rounding_mode='floor') == 0)
        if coords_grad and bool(home.any()):
            v = {c: torch.where(valid[home, None], planes[plane, yy[home], xx[home]], 0.0)
                 for c, (valid, yy, xx) in corners.items()}
            tx, ty, gv = tx[home], ty[home], gv[home]
            d[e[home], 0] = (gv * ((1 - ty) * (v[0, 1] - v[0, 0])
                                   + ty * (v[1, 1] - v[1, 0]))).sum(-1)
            d[e[home], 1] = (gv * ((1 - tx) * (v[1, 0] - v[0, 0])
                                   + tx * (v[1, 1] - v[0, 1]))).sum(-1)
    g_coords = (_combine_coords_grad(d[:, 0].reshape(n3, p), d[:, 1].reshape(n3, p),
                                     n, p, h, w, scale) if coords_grad else None)
    return g_planes, g_coords


@functools.cache
def _library():
    lib = cuda_build.library('splat')
    geometry = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float]
    lib.tdgp_splat_bin_counts.argtypes = [ctypes.c_void_p] * 2 + geometry + [ctypes.c_void_p]
    lib.tdgp_splat_bin_entries.argtypes = [ctypes.c_void_p] * 3 + geometry + [ctypes.c_void_p]
    lib.tdgp_triplane_splat.argtypes = [ctypes.c_void_p] * 8 + geometry[:4] + [
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    for fn in (lib.tdgp_splat_bin_counts, lib.tdgp_splat_bin_entries, lib.tdgp_triplane_splat):
        fn.restype = ctypes.c_int
    lib.tdgp_splat_error_string.argtypes = [ctypes.c_int]
    lib.tdgp_splat_error_string.restype = ctypes.c_char_p
    return lib


def _launched(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f'{what} launch failed: '
                           f'{_library().tdgp_splat_error_string(err).decode()}')


def _inv_scale(scale: float) -> float:
    """float32(1 / scale), the factor PyTorch multiplies by on the card where
    `_plane_coords` divides by the scale."""
    return float(np.float32(1.0) / np.float32(scale))


def triplane_splat_bins(coords: torch.Tensor, h: int, w: int, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_bins` on the card, for K1: the same bins from two small kernels of
    csrc/splat.cu (a histogram, then a scatter through cursors that start at
    the offsets, which torch sums here, each aggregating a block's entries
    by strip in shared memory first), with the entries of a bin in the order
    of the scatter's atomics. coords [N, P, 3] on a CUDA device ->
    (entries [4 N*3 P] int32, of which the first offsets[-1] are used;
    offsets [n_bins + 1] int32)."""
    n, p = coords.shape[0], coords.shape[1]
    strips_y, strips_x = _strips(h, w)
    n_bins = 3 * n * strips_y * strips_x
    device = coords.device
    lib = _library()
    geometry = (n, p, h, w, _inv_scale(scale))
    stream = torch.cuda.current_stream(device).cuda_stream
    counts = torch.empty(n_bins, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        _launched(lib.tdgp_splat_bin_counts(coords.data_ptr(), counts.data_ptr(), *geometry,
                                            stream), 'triplane_splat_bins')
        offsets = torch.cat([torch.zeros(1, dtype=torch.int32, device=device),
                             counts.cumsum(0, dtype=torch.int32)])
        cursor = offsets[:-1].clone()
        entries = torch.empty(4 * 3 * n * p, dtype=torch.int32, device=device)  # <= 4 bins each
        _launched(lib.tdgp_splat_bin_entries(coords.data_ptr(), cursor.data_ptr(),
                                             entries.data_ptr(), *geometry, stream),
                  'triplane_splat_bins')
    return entries, offsets


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
    if f not in KERNEL_FEATS:
        raise NotImplementedError(f'kernel K1 is built for F in {KERNEL_FEATS}, not {f}')
    if n3 * p >= 2 ** 31:
        raise ValueError(f'kernel K1 takes fewer than 2^31 (plane, point) entries, not {n3 * p}')
    g = g.to(torch.float32).contiguous()
    if tuple(g.shape) != (n, p, f):
        raise ValueError(f'cotangent {tuple(g.shape)} for output {(n, p, f)}')
    planes, coords = planes.contiguous(), coords.contiguous()
    entries, offsets = triplane_splat_bins(coords, h, w, scale)
    g_planes = torch.empty((n3, h, w, f), dtype=torch.float32, device=device)  # written once
    d_scratch = torch.empty((n3, p, 2), dtype=torch.float32, device=device) if coords_grad else None
    g_coords = torch.empty((n, p, 3), dtype=torch.float32, device=device) if coords_grad else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(device):
        _launched(_library().tdgp_triplane_splat(
            ptr(planes) if coords_grad else None, g.data_ptr(), coords.data_ptr(),
            entries.data_ptr(), offsets.data_ptr(), g_planes.data_ptr(), ptr(d_scratch),
            ptr(g_coords), n, p, h, w, f, _inv_scale(scale), 0.5 * (w - 1) / scale,
            0.5 * (h - 1) / scale, torch.cuda.current_stream(device).cuda_stream), 'triplane_splat')
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
