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
histogram that ranks each entry in its strip and a placing kernel, with the
offsets summed in torch). The
kernel then gives each strip one warp, which sums its entries in shared
memory, 8 entries a step (`triplane_splat_grouped_plain` is that walk's
arithmetic in torch), and writes the strip of the plane gradient once; the
entry's home strip also computes its coordinate gradient (`_coords_grad`
:973). The context keeps the planes and the coordinates.

For CUDA tensors the backward launches the kernel and counts it in
`triplane_splat.launches`; for CPU tensors, and only for them, it computes
`triplane_sample_bwd_plain`: the scatter-add `triplane_splat_plain`
(`index_add_`, the counterpart of `triplane_splat_ref` :775) and the
coordinate gradient in plain PyTorch. `triplane_splat_binned_plain` walks
the kernel's bins in plain PyTorch, for the tests.

The float32 backward is itself a recorded function
(`TriplaneSampleBackward`), so that a gradient of the gradient (the 3DGP
model's path-length regularization, `create_graph=True`) passes through it.
Its own backward, given the cotangents of (g_planes, g_coords), is
`triplane_sample_bwd_bwd`: for CUDA tensors K1's two second-order entries,
`triplane_splat_gather` (the cotangents of g and of the coordinates, F / 4
lanes a point gathering the planes' cotangent and, with a coordinate
cotangent, the planes) and `triplane_splat_dcoords` (the planes' cotangent,
a scatter of g with the bilinear weights' derivatives over K1's strip bins,
launched only with a coordinate cotangent: the path-length phase has none,
since its coordinates do not depend on ws), each counted in its own
`launches`; for CPU tensors `triplane_sample_bwd_bwd_plain`, autograd
through `triplane_sample_bwd_plain`.

bf16 planes (the bf16 render views, `generator.render_bf16`): the forward
sums each plane's four corners in float32 from the bf16 texels and rounds
once to bf16, then takes the mean of the three planes in float32 and rounds
once, where the JAX package's `grid_sample_2d` and `jnp.mean` round. The
backward is K1's bf16 entry, `triplane_splat_bf16` (its own launch count):
the bf16 cotangent divided by 3 and rounded as JAX's bf16 division rounds
it, the splat summed in float32, the plane gradient rounded once to bf16 as
the JAX package's TPU route rounds it at its boundary
(`tdgp/ops/splat.py:1030-1033`), the coordinate gradient in float32 from
the corner texels; `triplane_sample_bwd_plain_bf16` on CPU tensors. A
render's two passes share that one rounding (`triplane_sample_pair`, the
counterpart of `merged_splat`'s `triplane_sample_pair_first/second`): the
fine pass's backward keeps its float32 sum, and the coarse pass's backward
adds its own to it and rounds the total once.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from tdgp_torch.ops import cuda_build
from tdgp_torch.ops.grid_sample import grid_sample_2d
from tdgp_torch.ops.ray_march import widen

_PROJ = ((0, 1), (0, 2), (1, 2))  # plane projections: x/y, x/z, y/z


def tri_plane_sample(planes: torch.Tensor, coords: torch.Tensor, scale: float,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Sample the x/y, x/z and y/z planes at 3-D points and average them.

    planes: [N*3, H, W, F]; coords: [N, P, 3] world coordinates; scale: the
    cube's half side. Returns [N, P, F] in `out_dtype`, by default the
    planes'. bf16 planes, or float32 ones (bf16 values widened) with
    `out_dtype` bf16: each plane's bilinear sum in float32 rounded once to
    bf16, then ((a + b) + c) / 3 of the three in float32 rounded once.
    """
    n3, _, _, f = planes.shape
    n, p = coords.shape[0], coords.shape[1]
    out_dtype = out_dtype or planes.dtype
    coords = coords / scale
    grids = torch.stack([coords[..., list(pr)] for pr in _PROJ], dim=1)
    feats = grid_sample_2d(widen(planes), grids.reshape(n3, p, 2))
    if out_dtype != torch.bfloat16:
        return feats.reshape(n, 3, p, f).mean(dim=1)
    feats = feats.to(out_dtype).reshape(n, 3, p, f)  # in grid_sample's layout, as yet
    mean = (feats[:, 0].float() + feats[:, 1] + feats[:, 2]) / 3
    return mean.to(out_dtype, memory_format=torch.contiguous_format)


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


def triplane_sample_bwd_plain_bf16(planes: torch.Tensor, coords: torch.Tensor, g: torch.Tensor,
                                   scale: float, coords_grad: bool = True,
                                   addend: Optional[torch.Tensor] = None, round_out: bool = True
                                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K1's bf16 entry in plain PyTorch: bf16 planes [N*3, H, W, F] and
    cotangent g [N, P, F] -> (g_planes [N*3, H, W, F], g_coords [N, P, 3]
    float32 or None). Each (plane, point) row is g / 3 rounded to bf16,
    widened; the splat sums in float32, adds `addend` (float32, another
    pass's sum) and rounds the total once to bf16, or with `round_out` False
    returns it in float32; the coordinate gradient is float32."""
    n3, h, w, _ = planes.shape
    g_pts = _point_cotangent(g.to(torch.bfloat16)).float()
    g_planes = triplane_splat_plain(g_pts, coords, scale, n3, h, w)
    if addend is not None:
        g_planes = g_planes + addend
    if round_out:
        g_planes = g_planes.to(torch.bfloat16)
    g_coords = (triplane_coords_grad_plain(planes.float(), coords, g_pts, scale)
                if coords_grad else None)
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


def group_size(f: int) -> int:
    """Entries a warp of K1's group walk takes a step: F / 8 lanes an entry."""
    return 32 // (f // 8)


def run_ranks(key: torch.Tensor) -> torch.Tensor:
    """For each entry of a group, how many entries before it have the same
    key (the same corners): its round in K1's group walk, as the kernel
    counts it from `__match_any_sync`."""
    return torch.stack([(key[:i] == key[i]).sum() for i in range(len(key))])


def triplane_splat_grouped_plain(planes: torch.Tensor, coords: torch.Tensor, g: torch.Tensor,
                                 scale: float, coords_grad: bool = True,
                                 addend: Optional[torch.Tensor] = None, round_out: bool = True
                                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The arithmetic of K1's group walk (`splat_group_kernel`, every
    entry's) in plain PyTorch, for the tests: the bins of `_bins` strip by
    strip, each strip's entries `group_size(F)` at a time; within a group
    the entries with the same corners (a run) go in rounds, the r-th entry
    of every run in round r, and each round adds w_c x g / 3 into the
    strip's float32 accumulator one corner index c at a time. A home entry's
    (dtx, dty) is summed over 8-feature slices, the slices then added as the
    lanes' butterfly adds them. bf16 planes: each row g / 3 rounded to bf16,
    `addend` added to the float32 sums, the total rounded once to bf16 (or
    kept in float32 with `round_out` False), as `triplane_sample_bwd_plain_bf16`;
    float32 planes: as `triplane_sample_bwd_plain`."""
    n3, h, w, f = planes.shape
    n, p = coords.shape[0], coords.shape[1]
    bf16 = planes.dtype == torch.bfloat16
    gxy = _plane_coords(coords, scale, h, w).reshape(n3 * p, 2)
    entries, offsets = _bins(gxy.reshape(n3, p, 2), h, w)
    g_pts = _point_cotangent(g.to(torch.bfloat16) if bf16 else g).float().reshape(n3 * p, f)
    values = planes.float()
    sums = torch.empty((n3, h, w, f), dtype=torch.float32, device=planes.device)
    d = torch.zeros((n3 * p, 2), dtype=torch.float32, device=planes.device)
    lanes, size = f // 8, group_size(f)
    for b in range(len(offsets) - 1):
        plane, y_base, x_base = _strip_origin(b, h, w)
        acc = torch.zeros((STRIP_H, STRIP_W, f), dtype=torch.float32, device=planes.device)
        for start in range(int(offsets[b]), int(offsets[b + 1]), size):
            e = entries[start:min(start + size, int(offsets[b + 1]))].long()
            gx, gy = gxy[e, 0], gxy[e, 1]
            fx0, fy0 = torch.floor(gx), torch.floor(gy)
            tx, ty = (gx - fx0)[:, None], (gy - fy0)[:, None]
            ly, lx = fy0.long() - y_base, fx0.long() - x_base
            gv = g_pts[e]
            rank = run_ranks(ly * 64 + lx)  # by the corners (in one strip, the masks follow)
            weights = ((1 - tx) * (1 - ty), tx * (1 - ty), (1 - tx) * ty, tx * ty)
            for r in range(int(rank.max()) + 1):
                for c, wt in enumerate(weights):
                    yy, xx = fy0.long() + c // 2, fx0.long() + c % 2
                    cy, cx = ly + c // 2, lx + c % 2
                    mine = ((rank == r) & (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                            & (cy >= 0) & (cy < STRIP_H) & (cx >= 0) & (cx < STRIP_W))
                    acc[cy[mine], cx[mine]] += (wt * gv)[mine]  # distinct texels: one add each
            home = ((fy0.long().clamp_min(0) - y_base).div(STRIP_H, rounding_mode='floor') == 0) \
                & ((fx0.long().clamp_min(0) - x_base).div(STRIP_W, rounding_mode='floor') == 0)
            if coords_grad and bool(home.any()):
                v = []
                for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
                    yy, xx = fy0.long()[home] + dy, fx0.long()[home] + dx
                    valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                    v.append(torch.where(valid[:, None],
                                         values[plane, yy.clamp(0, h - 1), xx.clamp(0, w - 1)], 0.0))
                tx_h, ty_h, gv_h = tx[home], ty[home], gv[home]
                parts = torch.stack([
                    gv_h * ((1 - ty_h) * (v[1] - v[0]) + ty_h * (v[3] - v[2])),
                    gv_h * ((1 - tx_h) * (v[2] - v[0]) + tx_h * (v[3] - v[1]))], 1)
                slices = parts.reshape(-1, 2, lanes, 8).sum(-1)  # a lane's 8 features
                step = lanes // 2
                while step:  # the butterfly over the entry's lanes: lane 0 keeps the sum
                    slices = slices[..., :step] + slices[..., step:2 * step]
                    step //= 2
                d[e[home]] = slices[..., 0]
        rows, cols = min(STRIP_H, h - y_base), min(STRIP_W, w - x_base)
        sums[plane, y_base:y_base + rows, x_base:x_base + cols] = acc[:rows, :cols]
    if addend is not None:
        sums = sums + addend
    g_planes = sums.to(torch.bfloat16) if bf16 and round_out else sums
    g_coords = (_combine_coords_grad(d[:, 0].reshape(n3, p), d[:, 1].reshape(n3, p),
                                     n, p, h, w, scale) if coords_grad else None)
    return g_planes, g_coords


def _signatures():
    """The C interface of `csrc/splat.cu`: function -> argument types (each
    returns an int, the first CUDA error)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    geometry = [ctypes.c_longlong, ctypes.c_longlong, i, i, f]
    entry = geometry[:4] + [i, f, f, f]
    return {'tdgp_splat_bin_ranks': [p] * 3 + geometry + [p],
            'tdgp_splat_bin_place': [p] * 4 + geometry + [p],
            'tdgp_triplane_splat': [p] * 8 + entry + [p],
            'tdgp_triplane_splat_bf16': [p] * 9 + entry + [i, p],
            'tdgp_triplane_splat_gather': [p] * 7 + entry + [p],
            'tdgp_triplane_splat_dcoords': [p] * 6 + entry + [p]}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of a built `csrc/splat.cu` on `lib` (of an
    earlier one, the functions of it that it has)."""
    for name, argtypes in _signatures().items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.tdgp_splat_error_string.argtypes = [ctypes.c_int]
    lib.tdgp_splat_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library():
    return bind(cuda_build.library('splat'))


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
    """`_bins` on the card, for K1: the same bins from two kernels of
    csrc/splat.cu: a histogram that also gives each (entry, bin) its index
    in the bin (a block's entries aggregated by strip in shared memory
    first, one global atomic per strip and block), then, with the offsets
    torch sums from the counts, a pass that places each entry; the entries
    of a bin in the order of the histogram's atomics. coords [N, P, 3] on a
    CUDA device -> (entries [4 N*3 P] int32, of which the first
    offsets[-1] are used; offsets [n_bins + 1] int32)."""
    n, p = coords.shape[0], coords.shape[1]
    strips_y, strips_x = _strips(h, w)
    n_bins = 3 * n * strips_y * strips_x
    device = coords.device
    lib = _library()
    geometry = (n, p, h, w, _inv_scale(scale))
    stream = torch.cuda.current_stream(device).cuda_stream
    counts = torch.empty(n_bins, dtype=torch.int32, device=device)
    ranks = torch.empty((3 * n * p, 4), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        _launched(lib.tdgp_splat_bin_ranks(coords.data_ptr(), counts.data_ptr(), ranks.data_ptr(),
                                           *geometry, stream), 'triplane_splat_bins')
        offsets = torch.cat([torch.zeros(1, dtype=torch.int32, device=device),
                             counts.cumsum(0, dtype=torch.int32)])
        entries = torch.empty(4 * 3 * n * p, dtype=torch.int32, device=device)  # <= 4 bins each
        _launched(lib.tdgp_splat_bin_place(coords.data_ptr(), ranks.data_ptr(), offsets.data_ptr(),
                                           entries.data_ptr(), *geometry, stream),
                  'triplane_splat_bins')
    return entries, offsets


def _aligned(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """`t` contiguous at a 16-byte aligned address (a copy if it is not), as
    the kernels' 16-byte loads of its rows need."""
    if t is None:
        return None
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(planes: torch.Tensor, coords: torch.Tensor) -> None:
    if planes.ndim != 4 or coords.ndim != 3 or coords.shape[2] != 3 \
            or planes.shape[0] != 3 * coords.shape[0]:
        raise ValueError(f'expected planes [3N,H,W,F] and coords [N,P,3], got '
                         f'{tuple(planes.shape)}, {tuple(coords.shape)}')
    if coords.dtype != torch.float32 or planes.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'triplane_sample takes float32 coordinates and float32 or bf16 '
                        f'planes, got {coords.dtype} and {planes.dtype}')
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
    if planes.dtype == torch.bfloat16:
        return triplane_splat_bf16(planes, coords, g, scale, coords_grad)
    if planes.device.type == 'cpu':
        return triplane_sample_bwd_plain(planes, coords, g, scale, coords_grad)
    out = _splat(planes, coords, g, scale, coords_grad, 'triplane_splat')
    triplane_splat.launches += 1
    return out


def triplane_splat_bf16(planes: torch.Tensor, coords: torch.Tensor, g: torch.Tensor,
                        scale: float, coords_grad: bool = True,
                        addend: Optional[torch.Tensor] = None, round_out: bool = True
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K1's bf16 entry: bf16 planes [N*3, H, W, F] and cotangent g [N, P, F],
    float32 coords [N, P, 3] -> (g_planes, g_coords float32 or None), what
    `triplane_sample_bwd_plain_bf16` computes: the float32 strip sums plus
    `addend` (float32 [N*3, H, W, F], read once), stored in bf16, or in
    float32 with `round_out` False. Counted in `triplane_splat_bf16.launches`;
    the plain version for CPU tensors."""
    _check(planes, coords)
    if planes.dtype != torch.bfloat16:
        raise TypeError(f'triplane_splat_bf16 takes bf16 planes, got {planes.dtype}')
    if planes.device.type == 'cpu':
        return triplane_sample_bwd_plain_bf16(planes, coords, g, scale, coords_grad, addend,
                                              round_out)
    out = _splat(planes, coords, g, scale, coords_grad, 'triplane_splat_bf16', addend,
                 round_out)
    triplane_splat_bf16.launches += 1
    return out


def _splat(planes, coords, g, scale, coords_grad, what, addend=None, round_out=False):
    """One launch of K1's float32 entry, or of its bf16 entry for bf16 planes."""
    device = planes.device
    if device.type != 'cuda':
        raise ValueError(f'{what} runs on CUDA or CPU tensors, not {device}')
    n3, h, w, f = planes.shape
    n, p = coords.shape[0], coords.shape[1]
    if f not in KERNEL_FEATS:
        raise NotImplementedError(f'kernel K1 is built for F in {KERNEL_FEATS}, not {f}')
    if n3 * p >= 2 ** 31:
        raise ValueError(f'kernel K1 takes fewer than 2^31 (plane, point) entries, not {n3 * p}')
    bf16 = planes.dtype == torch.bfloat16
    g = _aligned(g.to(planes.dtype))
    if tuple(g.shape) != (n, p, f):
        raise ValueError(f'cotangent {tuple(g.shape)} for output {(n, p, f)}')
    if addend is not None:
        if addend.dtype != torch.float32 or tuple(addend.shape) != tuple(planes.shape) \
                or addend.device != device:
            raise ValueError(f'addend must be float32 {tuple(planes.shape)} on {device}')
        addend = _aligned(addend)
    planes, coords = _aligned(planes), coords.contiguous()
    entries, offsets = triplane_splat_bins(coords, h, w, scale)
    out_dtype = torch.bfloat16 if bf16 and round_out else torch.float32
    g_planes = torch.empty((n3, h, w, f), dtype=out_dtype, device=device)  # written once
    d_scratch = torch.empty((n3, p, 2), dtype=torch.float32, device=device) if coords_grad else None
    g_coords = torch.empty((n, p, 3), dtype=torch.float32, device=device) if coords_grad else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _library()
    pointers = [ptr(planes) if coords_grad else None, g.data_ptr(), coords.data_ptr(),
                entries.data_ptr(), offsets.data_ptr()]
    pointers += [ptr(addend)] if bf16 else []
    pointers += [g_planes.data_ptr(), ptr(d_scratch), ptr(g_coords)]
    scalars = [n, p, h, w, f, _inv_scale(scale), 0.5 * (w - 1) / scale, 0.5 * (h - 1) / scale]
    scalars += [int(out_dtype == torch.bfloat16)] if bf16 else []
    fn = lib.tdgp_triplane_splat_bf16 if bf16 else lib.tdgp_triplane_splat
    with torch.cuda.device(device):
        _launched(fn(*pointers, *scalars, torch.cuda.current_stream(device).cuda_stream), what)
    return g_planes, g_coords


def triplane_sample_bwd_bwd_plain(planes: torch.Tensor, coords: torch.Tensor, g: torch.Tensor,
                                  u_planes: Optional[torch.Tensor],
                                  u_coords: Optional[torch.Tensor], scale: float
                                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The derivative of `triplane_sample_bwd_plain`: autograd through it,
    from the cotangents u_planes [N*3, H, W, F] and u_coords [N, P, 3] (None
    for zero) of its outputs -> those of (planes, coords, g)."""
    inputs = [t.detach().requires_grad_(True) for t in (planes, coords, g)]
    with torch.enable_grad():
        outs = triplane_sample_bwd_plain(*inputs, scale, coords_grad=u_coords is not None)
    pairs = [(o, u) for o, u in zip(outs, (u_planes, u_coords)) if u is not None]
    if not pairs:
        return tuple(torch.zeros_like(t) for t in inputs)
    grads = torch.autograd.grad([o for o, _ in pairs], inputs, [u for _, u in pairs],
                                allow_unused=True)
    return tuple(torch.zeros_like(t) if d is None else d for d, t in zip(grads, inputs))


def _check_second(planes, coords, g, u_planes, u_coords):
    want = {'g': (g, (coords.shape[0], coords.shape[1], planes.shape[3])),
            'u_planes': (u_planes, tuple(planes.shape)), 'u_coords': (u_coords, tuple(coords.shape))}
    for name, (t, shape) in want.items():
        if t is not None and (tuple(t.shape) != shape or t.dtype != torch.float32
                              or t.device != planes.device):
            raise ValueError(f'{name} must be float32 {shape} on {planes.device}, got '
                             f'{t.dtype} {tuple(t.shape)} on {t.device}')
    if planes.dtype != torch.float32:
        raise TypeError(f'the second order of triplane_sample takes float32 planes, '
                        f'got {planes.dtype}')


def triplane_splat_gather(planes: torch.Tensor, coords: torch.Tensor, g: torch.Tensor,
                          u_planes: Optional[torch.Tensor], u_coords: Optional[torch.Tensor],
                          scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's second-order gather entry on CUDA tensors: the cotangents
    (b_g [N, P, F], b_coords [N, P, 3]) of `triplane_splat`'s g and coords
    from those of its outputs (u_planes, u_coords; None for zero), in one
    launch (csrc/splat.cu), counted in `triplane_splat_gather.launches`."""
    _check(planes, coords)
    _check_second(planes, coords, g, u_planes, u_coords)
    if planes.device.type != 'cuda':
        raise ValueError(f'triplane_splat_gather runs on CUDA tensors, not {planes.device}')
    _, h, w, f = planes.shape
    if f not in KERNEL_FEATS:
        raise NotImplementedError(f'kernel K1 is built for F in {KERNEL_FEATS}, not {f}')
    n, p = coords.shape[0], coords.shape[1]
    planes, coords, g = _aligned(planes), coords.contiguous(), _aligned(g)
    u_planes, u_coords = _aligned(u_planes), None if u_coords is None else u_coords.contiguous()
    b_g = torch.empty_like(g)
    b_coords = torch.empty_like(coords)
    device = planes.device
    with torch.cuda.device(device):
        _launched(_library().tdgp_triplane_splat_gather(
            planes.data_ptr(), coords.data_ptr(), g.data_ptr(),
            None if u_planes is None else u_planes.data_ptr(),
            None if u_coords is None else u_coords.data_ptr(), b_g.data_ptr(),
            b_coords.data_ptr(), n, p, h, w, f, _inv_scale(scale), 0.5 * (w - 1) / scale,
            0.5 * (h - 1) / scale, torch.cuda.current_stream(device).cuda_stream),
            'triplane_splat_gather')
    triplane_splat_gather.launches += 1
    return b_g, b_coords


def triplane_splat_dcoords(coords: torch.Tensor, g: torch.Tensor, u_coords: torch.Tensor,
                           scale: float, h: int, w: int) -> torch.Tensor:
    """K1's second-order scatter entry on CUDA tensors: the cotangent of the
    planes [N*3, H, W, F] float32, the scatter of g / 3 with the bilinear
    weights' derivatives along u_coords [N, P, 3], over K1's strip bins
    (csrc/splat.cu), counted in `triplane_splat_dcoords.launches`."""
    device = coords.device
    if device.type != 'cuda':
        raise ValueError(f'triplane_splat_dcoords runs on CUDA tensors, not {device}')
    n, p, f = g.shape
    if f not in KERNEL_FEATS:
        raise NotImplementedError(f'kernel K1 is built for F in {KERNEL_FEATS}, not {f}')
    coords, g, u_coords = coords.contiguous(), _aligned(g), u_coords.contiguous()
    entries, offsets = triplane_splat_bins(coords, h, w, scale)
    g_planes = torch.empty((3 * n, h, w, f), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        _launched(_library().tdgp_triplane_splat_dcoords(
            g.data_ptr(), coords.data_ptr(), u_coords.data_ptr(), entries.data_ptr(),
            offsets.data_ptr(), g_planes.data_ptr(), n, p, h, w, f, _inv_scale(scale),
            0.5 * (w - 1) / scale, 0.5 * (h - 1) / scale,
            torch.cuda.current_stream(device).cuda_stream), 'triplane_splat_dcoords')
    triplane_splat_dcoords.launches += 1
    return g_planes


def triplane_sample_bwd_bwd(planes: torch.Tensor, coords: torch.Tensor, g: torch.Tensor,
                            u_planes: Optional[torch.Tensor], u_coords: Optional[torch.Tensor],
                            scale: float
                            ) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """The derivative of `triplane_splat` (float32): the cotangents of
    (planes, coords, g) from those of (g_planes, g_coords), None for zero.
    For CUDA tensors K1's gather entry and, with u_coords, its scatter entry
    (the planes' cotangent is None without it); for CPU tensors
    `triplane_sample_bwd_bwd_plain`."""
    _check(planes, coords)
    _check_second(planes, coords, g, u_planes, u_coords)
    if planes.device.type == 'cpu':
        return triplane_sample_bwd_bwd_plain(planes, coords, g, u_planes, u_coords, scale)
    b_g, b_coords = triplane_splat_gather(planes, coords, g, u_planes, u_coords, scale)
    b_planes = None
    if u_coords is not None:
        b_planes = triplane_splat_dcoords(coords, g, u_coords, scale, planes.shape[1],
                                          planes.shape[2])
    return b_planes, b_coords, b_g


triplane_splat.launches = 0
triplane_splat_gather.launches = 0
triplane_splat_dcoords.launches = 0
triplane_splat_bf16.launches = 0


def _bwd(plain, bf16):
    if bf16:
        return triplane_sample_bwd_plain_bf16 if plain else triplane_splat_bf16
    return triplane_sample_bwd_plain if plain else triplane_splat


class TriplaneSampleBackward(torch.autograd.Function):
    """K1 (or with `plain` its plain version on any device) as a recorded
    function of (planes, coords, g) -> (g_planes, g_coords or None); its
    backward is `triplane_sample_bwd_bwd` (or its plain version)."""

    @staticmethod
    def forward(ctx, planes, coords, g, scale, plain, coords_grad):
        ctx.save_for_backward(planes, coords, g)
        ctx.scale, ctx.plain = scale, plain
        ctx.set_materialize_grads(False)  # an unused output's cotangent stays None: no work
        return _bwd(plain, False)(planes, coords, g, scale, coords_grad=coords_grad)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, u_planes, u_coords):
        bwd_bwd = triplane_sample_bwd_bwd_plain if ctx.plain else triplane_sample_bwd_bwd
        b_planes, b_coords, b_g = bwd_bwd(*ctx.saved_tensors, u_planes, u_coords, ctx.scale)
        return b_planes, b_coords, b_g, None, None, None


class TriplaneSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, planes, coords, scale, plain):
        ctx.save_for_backward(planes, coords)
        ctx.scale, ctx.plain = scale, plain
        return tri_plane_sample(planes, coords, scale)

    @staticmethod
    def backward(ctx, g):
        planes, coords = ctx.saved_tensors
        coords_grad = ctx.needs_input_grad[1]
        if planes.dtype == torch.bfloat16:
            if torch.is_grad_enabled():
                raise NotImplementedError('the second order of sampling bf16 planes is not '
                                          'ported (K1 has no bf16 second-order entry)')
            g_planes, g_coords = _bwd(ctx.plain, True)(planes, coords, g, ctx.scale,
                                                       coords_grad=coords_grad)
        else:
            g_planes, g_coords = TriplaneSampleBackward.apply(planes, coords, g, ctx.scale,
                                                              ctx.plain, coords_grad)
        return (g_planes if ctx.needs_input_grad[0] else None), g_coords, None, None


class _Carry:
    """The float32 plane gradient of a render's second (fine) pass, handed
    to its first (coarse) pass's backward."""
    g_planes: Optional[torch.Tensor] = None


class _TriplaneSampleFirst(torch.autograd.Function):
    """The first pass of a pair: its backward runs after the second's (the
    token orders them), adds the second's float32 plane gradient to its own
    and rounds the sum once."""

    @staticmethod
    def forward(ctx, planes, coords, scale, plain, carry):
        ctx.save_for_backward(planes, coords)
        ctx.scale, ctx.plain, ctx.carry = scale, plain, carry
        ctx.set_materialize_grads(False)
        token = torch.zeros((), dtype=torch.float32, device=planes.device)
        return tri_plane_sample(planes, coords, scale), token

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g, _g_token):
        planes, coords = ctx.saved_tensors
        addend, ctx.carry.g_planes = ctx.carry.g_planes, None
        if g is None:
            g = planes.new_zeros((coords.shape[0], coords.shape[1], planes.shape[3]))
        g_planes, g_coords = _bwd(ctx.plain, True)(
            planes, coords, g, ctx.scale, coords_grad=ctx.needs_input_grad[1], addend=addend)
        return (g_planes if ctx.needs_input_grad[0] else None), g_coords, None, None, None


class _TriplaneSampleSecond(torch.autograd.Function):
    @staticmethod
    def forward(ctx, planes, coords, token, scale, plain, carry):
        ctx.save_for_backward(planes, coords)
        ctx.scale, ctx.plain, ctx.carry = scale, plain, carry
        return tri_plane_sample(planes, coords, scale)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        planes, coords = ctx.saved_tensors
        g_planes, g_coords = _bwd(ctx.plain, True)(
            planes, coords, g, ctx.scale, coords_grad=ctx.needs_input_grad[1], round_out=False)
        ctx.carry.g_planes = g_planes if ctx.needs_input_grad[0] else None
        return None, g_coords, torch.zeros((), device=planes.device), None, None, None


class TriplaneSamplePair:
    """`triplane_sample` for a render's two passes over the same bf16
    planes, called first with the coarse pass's coordinates, then with the
    fine pass's: the plane gradient of both is summed in float32 and rounded
    to bf16 once, in the coarse pass's backward (K1's bf16 entry twice, or
    with `plain` its plain version)."""

    def __init__(self, scale: float, plain: bool = False):
        self.scale, self.plain, self._pending = scale, plain, None

    def __call__(self, planes: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        _check(planes, coords)
        if planes.dtype != torch.bfloat16:
            raise TypeError(f'triplane_sample_pair takes bf16 planes, got {planes.dtype}')
        if self._pending is None:
            carry = _Carry()
            feats, token = _TriplaneSampleFirst.apply(planes, coords, self.scale, self.plain,
                                                      carry)
            self._pending = token, carry
            return feats
        (token, carry), self._pending = self._pending, None
        return _TriplaneSampleSecond.apply(planes, coords, token, self.scale, self.plain, carry)


def triplane_sample_pair(scale: float) -> TriplaneSamplePair:
    """A sampler for the two passes of one render over bf16 planes, K1's
    bf16 entry as its backward (`TriplaneSamplePair`)."""
    return TriplaneSamplePair(scale)


def triplane_sample_pair_reference(scale: float) -> TriplaneSamplePair:
    """`triplane_sample_pair` with K1's plain version as its backward on any
    device: the reference the kernel is held against on the card."""
    return TriplaneSamplePair(scale, plain=True)


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
