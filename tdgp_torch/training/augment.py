"""ADA augmentation pipeline (port of `tdgp/training/augment.py`).

The groups of the JAX pipe, in its order: the geometric ones (xflip,
rotate90, integer translation, isotropic scale, rotation, anisotropic scale,
rotation, fractional translation) composed into one inverse affine matrix per
sample and executed with a wavelet 2x upsample, a bilinear resampling and a
2x downsample; the colour ones (brightness, contrast, luma flip, hue,
saturation) composed into one 4x4 matrix per sample and applied to the
colour channels only, so that the depth channel rides along unchanged; the
image filter (a 4-band wavelet filter bank); additive noise and cutout.

Each group is applied to a sample with probability (its weight) x p, the
rotations with 1 - sqrt(1 - weight x p) each, so that one of the two
happens with probability weight x p. Every random number comes from the
`Draws` given to the call, under the group's name: the value as `<group>`,
the coin as `<group>/gate` (`rotate/0`, `rotate/1` for the two rotations,
`imgfilter/<band>` for the bands, `noise/pixels` and `cutout/center` for the
noise and the cutout's centre). The pipe is linear in the images, and
differentiable to any order in them: R1 takes a gradient of a gradient
through it. Images are NHWC.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch
import torch.nn.functional as F

from tdgp_torch.config import AugmentCfg
from tdgp_torch.ops.grid_sample import grid_sample_nhwc
from tdgp_torch.ops.upfirdn2d import downsample2d, setup_filter, upsample2d
from tdgp_torch.utils.draws import Draws

# sym6 wavelet lowpass (pywt), the geometric transform's resampling filter
SYM6 = np.asarray([
    0.015404109327027373, 0.0034907120842174702, -0.11799011114819057,
    -0.048311742585633, 0.4910559419267466, 0.787641141030194,
    0.3379294217276218, -0.07263752278646252, -0.021060292512300564,
    0.04472490177066578, 0.0017677118642428036, -0.007800708325034148,
], dtype=np.float32)

# sym2 lowpass, the basis of the 4-band image-filter bank
SYM2 = np.asarray([-0.12940952255092145, 0.22414386804185735,
                   0.836516303737469, 0.48296291314469025], dtype=np.float32)


def _build_fbank() -> np.ndarray:
    """The 4-band wavelet filter bank [4, taps]."""
    import scipy.signal
    hz_lo = SYM2.astype(np.float64)
    hz_hi = hz_lo * ((-1) ** np.arange(hz_lo.size))
    hz_lo2 = np.convolve(hz_lo, hz_lo[::-1]) / 2
    hz_hi2 = np.convolve(hz_hi, hz_hi[::-1]) / 2
    fbank = np.eye(4, 1)
    for i in range(1, fbank.shape[0]):
        fbank = np.dstack([fbank, np.zeros_like(fbank)]).reshape(fbank.shape[0], -1)[:, :-1]
        fbank = scipy.signal.convolve(fbank, [hz_lo2])
        fbank[i, (fbank.shape[1] - hz_hi2.size) // 2:
              (fbank.shape[1] + hz_hi2.size) // 2] += hz_hi2
    return fbank.astype(np.float32)


def _eye(n: int, k: int, device) -> torch.Tensor:
    return torch.eye(k, device=device).repeat(n, 1, 1)


def _translate2d(tx: torch.Tensor, ty: torch.Tensor) -> torch.Tensor:
    m = _eye(tx.shape[0], 3, tx.device)
    m[:, 0, 2], m[:, 1, 2] = tx, ty
    return m


def _scale2d(sx: torch.Tensor, sy: torch.Tensor) -> torch.Tensor:
    m = _eye(sx.shape[0], 3, sx.device)
    m[:, 0, 0], m[:, 1, 1] = sx, sy
    return m


def _rotate2d(theta: torch.Tensor) -> torch.Tensor:
    m = _eye(theta.shape[0], 3, theta.device)
    c, s = torch.cos(theta), torch.sin(theta)
    m[:, 0, 0], m[:, 0, 1], m[:, 1, 0], m[:, 1, 1] = c, -s, s, c
    return m


def _translate3d(t: torch.Tensor) -> torch.Tensor:
    m = _eye(t.shape[0], 4, t.device)
    m[:, 0, 3] = m[:, 1, 3] = m[:, 2, 3] = t
    return m


def _scale3d(s: torch.Tensor) -> torch.Tensor:
    m = _eye(s.shape[0], 4, s.device)
    m[:, 0, 0] = m[:, 1, 1] = m[:, 2, 2] = s
    return m


def _rotate3d_about(v: np.ndarray, theta: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation about the unit axis v (4x4 homogeneous), per sample."""
    vx, vy, vz = float(v[0]), float(v[1]), float(v[2])
    s, c = torch.sin(theta), torch.cos(theta)
    cc = 1 - c
    rows = [[vx * vx * cc + c, vx * vy * cc - vz * s, vx * vz * cc + vy * s],
            [vy * vx * cc + vz * s, vy * vy * cc + c, vy * vz * cc - vx * s],
            [vz * vx * cc - vy * s, vz * vy * cc + vx * s, vz * vz * cc + c]]
    m = _eye(theta.shape[0], 4, theta.device)
    for i in range(3):
        for j in range(3):
            m[:, i, j] = rows[i][j]
    return m


def _reflect_pad(x: torch.Tensor, px: int, py: int) -> torch.Tensor:
    """Reflect-pad the H and W axes of NHWC `x` (the edge not repeated)."""
    return F.pad(x.permute(0, 3, 1, 2), (px, px, py, py), mode='reflect').permute(0, 2, 3, 1)


class AugmentPipe:
    """(images [N, H, W, C], p, draws) -> images; `p` is ADA's probability."""

    def __init__(self, cfg: AugmentCfg, num_color_channels: int = 3,
                 device: Union[str, torch.device] = 'cpu',
                 xint_max: float = 0.125, scale_std: float = 0.2,
                 rotate_max: float = 1.0, aniso_std: float = 0.2,
                 xfrac_std: float = 0.125, brightness_std: float = 0.2,
                 contrast_std: float = 0.5, hue_max: float = 1.0,
                 saturation_std: float = 1.0, noise_std: float = 0.1,
                 cutout_size: float = 0.5,
                 imgfilter_bands=(1.0, 1.0, 1.0, 1.0),
                 imgfilter_std: float = 1.0):
        if num_color_channels not in (1, 3):
            raise ValueError('color channels must be 1 or 3')
        self.cfg = cfg
        self.num_color_channels = num_color_channels
        self.xint_max = xint_max
        self.scale_std = scale_std
        self.rotate_max = rotate_max
        self.aniso_std = aniso_std
        self.xfrac_std = xfrac_std
        self.brightness_std = brightness_std
        self.contrast_std = contrast_std
        self.hue_max = hue_max
        self.saturation_std = saturation_std
        self.noise_std = noise_std
        self.cutout_size = cutout_size
        self.imgfilter_bands = tuple(imgfilter_bands)
        self.imgfilter_std = imgfilter_std
        self.hz_geom = setup_filter(SYM6, device)
        self.hz_fbank = (torch.as_tensor(_build_fbank(), device=device)
                         if cfg.imgfilter > 0 else None)
        if self.hz_fbank is not None and len(self.imgfilter_bands) != self.hz_fbank.shape[0]:
            raise ValueError(f'{len(self.imgfilter_bands)} imgfilter bands for a bank of '
                             f'{self.hz_fbank.shape[0]}')

    def __call__(self, images: torch.Tensor, p: float, draws: Draws) -> torch.Tensor:
        cfg = self.cfg
        n, h, w, c = images.shape
        dev = images.device

        def gate(name, weight, value, identity):
            """`value` where the sample's coin falls under weight x p, else `identity`."""
            mask = draws.uniform(f'{name}/gate', (n,)) < weight * p
            return torch.where(mask.reshape((n,) + (1,) * (value.ndim - 1)), value, identity)

        def rotation(name, p_rot):
            theta = (draws.uniform(name, (n,)) * 2 - 1) * np.pi * self.rotate_max
            mask = draws.uniform(f'{name}/gate', (n,)) < p_rot
            return torch.where(mask, theta, torch.zeros_like(theta))

        # geometric: the inverse 2-D affine matrix per sample
        g_inv = _eye(n, 3, dev)
        if cfg.xflip > 0:
            i = torch.floor(draws.uniform('xflip', (n,)) * 2)
            i = gate('xflip', cfg.xflip, i, torch.zeros_like(i))
            g_inv = g_inv @ _scale2d(1.0 / (1 - 2 * i), torch.ones(n, device=dev))
        if cfg.rotate90 > 0:
            i = torch.floor(draws.uniform('rotate90', (n,)) * 4)
            i = gate('rotate90', cfg.rotate90, i, torch.zeros_like(i))
            g_inv = g_inv @ _rotate2d(np.pi / 2 * i)
        if cfg.xint > 0:
            t = (draws.uniform('xint', (n, 2)) * 2 - 1) * self.xint_max
            t = gate('xint', cfg.xint, t, torch.zeros_like(t))
            g_inv = g_inv @ _translate2d(-torch.round(t[:, 0] * w), -torch.round(t[:, 1] * h))
        if cfg.scale > 0:
            s = torch.exp2(draws.normal('scale', (n,)) * self.scale_std)
            s = gate('scale', cfg.scale, s, torch.ones_like(s))
            g_inv = g_inv @ _scale2d(1.0 / s, 1.0 / s)
        p_rot = 1 - float(np.sqrt(np.clip(1 - cfg.rotate * p, 0, 1)))
        if cfg.rotate > 0:
            g_inv = g_inv @ _rotate2d(rotation('rotate/0', p_rot))
        if cfg.aniso > 0:
            s = torch.exp2(draws.normal('aniso', (n,)) * self.aniso_std)
            s = gate('aniso', cfg.aniso, s, torch.ones_like(s))
            g_inv = g_inv @ _scale2d(1.0 / s, s)
        if cfg.rotate > 0:
            g_inv = g_inv @ _rotate2d(rotation('rotate/1', p_rot))
        if cfg.xfrac > 0:
            t = draws.normal('xfrac', (n, 2)) * self.xfrac_std
            t = gate('xfrac', cfg.xfrac, t, torch.zeros_like(t))
            g_inv = g_inv @ _translate2d(-t[:, 0] * w, -t[:, 1] * h)

        images = self._execute_geometric(images, g_inv)

        # colour: a 4x4 matrix per sample
        c_mat = _eye(n, 4, dev)
        if cfg.brightness > 0:
            b = draws.normal('brightness', (n,)) * self.brightness_std
            b = gate('brightness', cfg.brightness, b, torch.zeros_like(b))
            c_mat = _translate3d(b) @ c_mat
        if cfg.contrast > 0:
            cc = torch.exp2(draws.normal('contrast', (n,)) * self.contrast_std)
            cc = gate('contrast', cfg.contrast, cc, torch.ones_like(cc))
            c_mat = _scale3d(cc) @ c_mat
        v = np.asarray([1, 1, 1, 0]) / np.sqrt(3)
        vvt = torch.as_tensor(np.outer(v, v), dtype=torch.float32, device=dev)
        eye4 = torch.eye(4, device=dev)
        if cfg.lumaflip > 0:
            i = torch.floor(draws.uniform('lumaflip', (n,)) * 2)
            i = gate('lumaflip', cfg.lumaflip, i, torch.zeros_like(i))
            c_mat = (eye4 - 2 * vvt * i[:, None, None]) @ c_mat
        if cfg.hue > 0 and self.num_color_channels > 1:
            theta = (draws.uniform('hue', (n,)) * 2 - 1) * np.pi * self.hue_max
            theta = gate('hue', cfg.hue, theta, torch.zeros_like(theta))
            c_mat = _rotate3d_about(v[:3] / np.linalg.norm(v[:3]), theta) @ c_mat
        if cfg.saturation > 0 and self.num_color_channels > 1:
            s = torch.exp2(draws.normal('saturation', (n,)) * self.saturation_std)
            s = gate('saturation', cfg.saturation, s, torch.ones_like(s))
            c_mat = (vvt + (eye4 - vvt) * s[:, None, None]) @ c_mat

        images = self._execute_color(images, c_mat)

        # image-space filtering: per-sample amplification of 4 frequency bands
        if cfg.imgfilter > 0:
            num_bands = self.hz_fbank.shape[0]
            expected_power = torch.as_tensor(np.array([10, 1, 1, 1]) / 13,
                                             dtype=torch.float32, device=dev)
            gvec = torch.ones((n, num_bands), device=dev)
            for i, band_strength in enumerate(self.imgfilter_bands):
                t_i = torch.exp2(draws.normal(f'imgfilter/{i}', (n,)) * self.imgfilter_std)
                mask = draws.uniform(f'imgfilter/{i}/gate', (n,)) < (
                    cfg.imgfilter * p * band_strength)
                t_i = torch.where(mask, t_i, torch.ones_like(t_i))
                t = torch.ones((n, num_bands), device=dev)
                t[:, i] = t_i
                t = t / torch.sqrt((expected_power * t ** 2).sum(-1, keepdim=True))
                gvec = gvec * t
            images = self._execute_imgfilter(images, gvec @ self.hz_fbank)

        # image-space corruptions
        if cfg.noise > 0:
            sigma = draws.normal('noise', (n,)).abs() * self.noise_std
            sigma = gate('noise', cfg.noise, sigma, torch.zeros_like(sigma))
            images = images + draws.normal('noise/pixels', images.shape) * sigma[:, None, None,
                                                                                  None]
        if cfg.cutout > 0:
            size = torch.full((n,), self.cutout_size, device=dev)
            size = gate('cutout', cfg.cutout, size, torch.zeros_like(size))
            center = draws.uniform('cutout/center', (n, 2))
            cx = (torch.arange(w, device=dev) + 0.5) / w
            cy = (torch.arange(h, device=dev) + 0.5) / h
            mask_x = (cx[None, :] - center[:, 0:1]).abs() >= size[:, None] / 2
            mask_y = (cy[None, :] - center[:, 1:2]).abs() >= size[:, None] / 2
            mask = mask_x[:, None, :] | mask_y[:, :, None]
            images = images * mask[..., None].to(images.dtype)
        return images

    def _execute_imgfilter(self, images: torch.Tensor, hz_prime: torch.Tensor) -> torch.Tensor:
        """Separable per-sample filtering: the batch rides the channel axis,
        so one depthwise convolution applies each sample's filter."""
        n, h, w, c = images.shape
        taps = hz_prime.shape[1]
        pad = taps // 2
        x = F.pad(images.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode='reflect')
        x = x.reshape(1, n * c, h + 2 * pad, w + 2 * pad)
        rhs = hz_prime.repeat_interleave(c, dim=0)                          # [n*c, taps]
        x = F.conv2d(x, rhs[:, None, None, :], groups=n * c)
        x = F.conv2d(x, rhs[:, None, :, None], groups=n * c)
        return x.reshape(n, c, h, w).permute(0, 2, 3, 1)

    def _execute_geometric(self, images: torch.Tensor, g_inv: torch.Tensor) -> torch.Tensor:
        """Reflect-pad, 2x wavelet upsample, resample through the affine
        grid, 2x downsample. A fixed margin that covers every transform the
        pipe draws keeps the shapes static, as in the JAX package."""
        n, h, w, c = images.shape
        dev = images.device
        hz_pad = self.hz_geom.shape[0] // 4
        mx = min(w - 1, w // 2 + hz_pad * 2)
        my = min(h - 1, h // 2 + hz_pad * 2)
        images = upsample2d(_reflect_pad(images, mx, my), self.hz_geom, up=2)

        def full(v):
            return torch.full((n,), v, device=dev)

        g = _scale2d(full(2.0), full(2.0)) @ g_inv @ _scale2d(full(0.5), full(0.5))
        g = _translate2d(full(-0.5), full(-0.5)) @ g @ _translate2d(full(0.5), full(0.5))
        hp, wp = images.shape[1], images.shape[2]
        h_out, w_out = (h + hz_pad * 2) * 2, (w + hz_pad * 2) * 2
        g = _scale2d(full(2.0 / wp), full(2.0 / hp)) @ g @ _scale2d(full(w_out / 2.0),
                                                                    full(h_out / 2.0))
        ys = (torch.arange(h_out, device=dev) + 0.5) * 2.0 / h_out - 1.0
        xs = (torch.arange(w_out, device=dev) + 0.5) * 2.0 / w_out - 1.0
        gy, gx = torch.meshgrid(ys, xs, indexing='ij')
        pts = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).reshape(-1, 3)
        grid = torch.einsum('nij,pj->npi', g[:, :2, :], pts).reshape(n, h_out, w_out, 2)
        images = grid_sample_nhwc(images, grid, align_corners=False)
        # the negative padding crops the filter's halo back to (h, w)
        images = downsample2d(images, self.hz_geom, down=2, padding=-hz_pad * 2,
                              flip_filter=True)
        if images.shape[1:3] != (h, w):
            raise AssertionError(f'geometric transform gave {tuple(images.shape)}')
        return images

    def _execute_color(self, images: torch.Tensor, c_mat: torch.Tensor) -> torch.Tensor:
        """The 4x4 colour matrix on the colour channels only."""
        ncc = self.num_color_channels
        color, rest = images[..., :ncc], images[..., ncc:]
        if ncc == 3:
            out = torch.einsum('nij,nhwj->nhwi', c_mat[:, :3, :3], color) + \
                c_mat[:, :3, 3][:, None, None, :]
        else:
            m = c_mat[:, :3, :].mean(dim=1, keepdim=True)                   # [n, 1, 4]
            out = color * m[:, :, :3].sum(2)[:, None, None, :] + m[:, :, 3][:, None, None, :]
        return torch.cat([out, rest], dim=-1)
