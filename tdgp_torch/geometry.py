"""Geometry extraction: density grid -> triangle mesh (port of `tdgp/geometry.py`).

The generator's density is sampled on a voxel grid over the scene cube and
isosurfaced by marching tetrahedra, in the port's C++ copy
(`tdgp_torch/native/`) or, when asked for (`use_native=False`), in numpy.
Exports: .obj (text) and .mrc (a minimal MRC2014 float32 volume).

`extract_density_grid` decodes the planes once per sample and then samples
them chunk by chunk, where the JAX package decodes them again inside each
jitted chunk; the numbers are the same. On the card the chunks' MLP runs in
kernel K4 and the decoder's bias + activations in kernel K5.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tdgp_torch import native
from tdgp_torch.models.epigraf import Generator, flatten_planes
from tdgp_torch.utils.misc import exact_fp32


# ------------------------------------------------------------- density grid

def create_voxel_coords(resolution: int, cube_scale: float = 0.5, batch_size: int = 1,
                        device: torch.device | str = 'cpu') -> torch.Tensor:
    """The points of a resolution^3 grid spanning the cube, x slowest
    -> [batch_size, resolution^3, 3]."""
    side = np.linspace(-cube_scale, cube_scale, resolution, dtype=np.float32)
    x, y, z = np.meshgrid(side, side, side, indexing='ij')
    coords = torch.from_numpy(np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)).to(device)
    return coords[None].expand(batch_size, -1, -1)


@torch.no_grad()
def extract_density_grid(G: Generator, ws: torch.Tensor, resolution: int = 128,
                         cube_scale: float = 0.5, chunk: int = 32 ** 3) -> np.ndarray:
    """Density of the first sample of `ws` on the voxel grid, `chunk` points
    at a time, with the const noise -> [res, res, res] numpy float32."""
    device = next(G.parameters()).device
    coords = create_voxel_coords(resolution, cube_scale, 1, device)
    with exact_fp32():
        planes = flatten_planes(G.synthesis.decode_planes(ws[:1].to(device)))
        sigma = torch.cat([G.synthesis.sample_densities(planes, coords[:, i:i + chunk])
                           for i in range(0, coords.shape[1], chunk)], dim=1)
    return sigma[0].cpu().numpy().reshape(resolution, resolution, resolution)


# ------------------------------------------------------- marching tetrahedra

# cube corner offsets (x, y, z)
_CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
], dtype=np.int64)

# six tetrahedra per cube sharing the 0-6 diagonal
_TETS = np.array([
    [0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
    [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6],
], dtype=np.int64)


def _marching_tetrahedra_numpy(values: np.ndarray, level: float) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized marching tetrahedra. values: [X, Y, Z] -> (verts [V, 3] in
    voxel coordinates, faces [F, 3])."""
    nx, ny, nz = values.shape
    base = np.stack(np.meshgrid(np.arange(nx - 1), np.arange(ny - 1),
                                np.arange(nz - 1), indexing='ij'), axis=-1).reshape(-1, 3)
    corner_idx = base[:, None, :] + _CORNERS[None, :, :]  # [ncubes, 8, 3]
    cv = values[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]  # [ncubes, 8]
    corner_pos = corner_idx.astype(np.float64)

    tri_list = []
    for tet in _TETS:
        v = cv[:, tet]                    # [ncubes, 4]
        p = corner_pos[:, tet]            # [ncubes, 4, 3]
        inside = v > level
        code = (inside * np.array([1, 2, 4, 8])).sum(axis=1)

        def interp(mask, a, b):
            """The level crossing on edge a-b of the selected cubes' tetrahedra."""
            va, vb = v[mask, a], v[mask, b]
            t = (level - va) / np.where(np.abs(vb - va) < 1e-12, 1e-12, vb - va)
            t = np.clip(t, 0.0, 1.0)[:, None]
            return p[mask, a] + t * (p[mask, b] - p[mask, a])

        # one corner apart from the other three: 1 triangle
        single = [(1, 0, (1, 2, 3)), (2, 1, (0, 3, 2)), (4, 2, (0, 1, 3)), (8, 3, (0, 2, 1))]
        for code_in, ci, others in single:
            for c_val, flip in ((code_in, False), (15 - code_in, True)):
                m = code == c_val
                if not m.any():
                    continue
                pts = [interp(m, ci, o) for o in others]
                if flip:
                    pts = pts[::-1]
                tri_list.append(np.stack(pts, axis=1))  # [n, 3, 3]

        # two corners apart from the other two: a quad, 2 triangles
        double = [(3, (0, 1), (2, 3)), (5, (0, 2), (1, 3)), (9, (0, 3), (1, 2)),
                  (6, (1, 2), (0, 3)), (10, (1, 3), (0, 2)), (12, (2, 3), (0, 1))]
        for c_val, (a, b), (c_, d) in double:
            m = code == c_val
            if not m.any():
                continue
            q0, q1 = interp(m, a, c_), interp(m, a, d)
            q2, q3 = interp(m, b, d), interp(m, b, c_)
            tri_list.append(np.stack([q0, q1, q2], axis=1))
            tri_list.append(np.stack([q0, q2, q3], axis=1))

    if not tri_list:
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int64)
    tris = np.concatenate(tri_list, axis=0)  # [F, 3, 3]
    verts, inverse = np.unique(tris.reshape(-1, 3).round(6), axis=0, return_inverse=True)
    return verts, inverse.reshape(-1, 3)


def marching_cubes(values: np.ndarray, level: float,
                   use_native: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Isosurface of `values` at `level` -> (verts in voxel coordinates,
    faces): the C++ version, built at first use (a failed build raises), or
    with `use_native=False` the numpy version."""
    if use_native:
        return native.marching_tetrahedra(values, float(level))
    return _marching_tetrahedra_numpy(values, level)


def extract_geometry(G: Generator, ws: torch.Tensor, resolution: int = 128,
                     cube_scale: float = 0.5, level: Optional[float] = None, crop: int = 1,
                     use_native: bool = True) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Density grid of the first sample, its border zeroed `crop` voxels deep
    to close the surface, isosurfaced at `level` (default: the 90th
    percentile of the grid) -> (verts in world units, faces, sigma grid)."""
    sigma = extract_density_grid(G, ws, resolution, cube_scale)
    if crop > 0:
        sigma = sigma.copy()
        sigma[:crop] = sigma[-crop:] = 0
        sigma[:, :crop] = sigma[:, -crop:] = 0
        sigma[:, :, :crop] = sigma[:, :, -crop:] = 0
    if level is None:
        level = float(np.percentile(sigma, 90))
    verts, faces = marching_cubes(sigma, level, use_native)
    verts = verts / (resolution - 1) * (2 * cube_scale) - cube_scale
    return verts, faces, sigma


# --------------------------------------------------------------------- io

def save_obj(verts: np.ndarray, faces: np.ndarray, path: str) -> None:
    with open(path, 'w') as f:
        for v in verts:
            f.write(f'v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n')
        for face in faces + 1:  # obj is 1-indexed
            f.write(f'f {face[0]} {face[1]} {face[2]}\n')


def save_mrc(volume: np.ndarray, path: str, voxel_size: float = 1.0) -> None:
    """A minimal MRC2014 file (mode 2, float32) of `volume`."""
    vol = np.ascontiguousarray(volume, dtype=np.float32)
    nz, ny, nx = vol.shape
    header = np.zeros(256, dtype=np.int32)
    header[0:3] = [nx, ny, nz]
    header[3] = 2                          # mode: float32
    header[7:10] = [nx, ny, nz]            # mx, my, mz
    fheader = header.view(np.float32)
    fheader[10:13] = [nx * voxel_size, ny * voxel_size, nz * voxel_size]  # cell size
    fheader[13:16] = [90.0, 90.0, 90.0]    # cell angles
    header[16:19] = [1, 2, 3]              # axis order
    fheader[19] = float(vol.min())
    fheader[20] = float(vol.max())
    fheader[21] = float(vol.mean())
    header[52] = int.from_bytes(b'MAP ', 'little')
    header[53] = 0x00004144                # little-endian machine stamp
    with open(path, 'wb') as f:
        f.write(header.tobytes())
        f.write(vol.tobytes())
