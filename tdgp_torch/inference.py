"""Seed grids, camera trajectories and videos from a trained generator
(port of `tdgp/inference.py`).

Every function takes the port's `Generator` (in place of the JAX package's
module and variables) and runs where its parameters are. Rendering runs
under `torch.no_grad()` and `exact_fp32`, rays `max_batch_res**2` at a
time when the image has more, as `tdgp.inference.make_synthesis_fn` does:
so on the card the tri-plane MLP runs in kernel K4, every bias +
activation in kernel K5, and the merge of the coarse and fine samples
with the final march in kernel K3's merged entry. Frames come
back as numpy floats in [0, 1].

Random draws: the per-seed z's are numpy's, as in the JAX package, so they
are the same bit for bit. The per-class truncation averages of
`sample_ws_from_seeds` draw their z's from a `torch.Generator` seeded with
the class index, where the JAX package draws `jax.random.normal(PRNGKey(k))`,
which torch cannot replay; the caller may pass the z's instead.
"""
from __future__ import annotations

import math
import os
import shutil
import subprocess
import tempfile
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import PIL.Image
import torch

from tdgp_torch.config import Config
from tdgp_torch.models.epigraf import Generator
from tdgp_torch.rendering.camera import get_mean_camera_params
from tdgp_torch.utils.misc import exact_fp32
from tdgp_torch.utils.tensor_group import EasyDict, TensorGroup


def _device(G: Generator) -> torch.device:
    return next(G.parameters()).device


# ------------------------------------------------------------------ latents

def sample_z_from_seeds(seeds: Sequence[int], z_dim: int,
                        device: torch.device | str = 'cpu') -> torch.Tensor:
    """One z per seed from numpy's RandomState(seed): [len(seeds), z_dim]."""
    zs = [np.random.RandomState(s).randn(z_dim).astype(np.float32) for s in seeds]
    return torch.from_numpy(np.stack(zs)).to(device)


@torch.no_grad()
def sample_ws_from_seeds(G: Generator, seeds: Sequence[int], c: Optional[torch.Tensor],
                         camera_angles: torch.Tensor, truncation_psi: float = 1.0,
                         num_avg_samples: int = 256,
                         class_zs: Optional[Mapping[int, Any]] = None) -> torch.Tensor:
    """Seeds -> ws [len(seeds), num_ws, w_dim], truncated toward the mapping's
    w_avg, or with a class condition toward the average w of its class over
    `num_avg_samples` z's: `class_zs[k]` [num_avg_samples, z_dim] when given,
    else N(0, 1) draws of a torch.Generator seeded with k."""
    device = _device(G)
    z = sample_z_from_seeds(seeds, G.cfg.z_dim, device)
    with exact_fp32():
        ws = G.mapping(z, c, camera_angles=camera_angles)
        if truncation_psi == 1.0:
            return ws
        if c is None or c.shape[1] == 0:
            w_avg = G.mapping.w_avg
            return w_avg + (ws - w_avg) * truncation_psi
        labels = c.argmax(dim=1).tolist()
        w_avg_per_class = {}
        for k in sorted(set(labels)):
            if class_zs is not None:
                zs = torch.as_tensor(np.asarray(class_zs[k]), dtype=torch.float32, device=device)
            else:
                zs = torch.randn(num_avg_samples, G.cfg.z_dim,
                                 generator=torch.Generator().manual_seed(k)).to(device)
            cs = torch.zeros(zs.shape[0], c.shape[1], device=device)
            cs[:, k] = 1.0
            angs = camera_angles[:1].repeat(zs.shape[0], 1)
            w_avg_per_class[k] = G.mapping(zs, cs, camera_angles=angs).mean(dim=0)
        avg = torch.stack([w_avg_per_class[k] for k in labels])
        return avg + (ws - avg) * truncation_psi


# -------------------------------------------------------------- trajectories

def generate_camera_trajectory(traj: Dict[str, Any], canonical: TensorGroup) -> TensorGroup:
    """Camera paths around each canonical camera, every camera's frames in a
    row: point | points | front_circle | line | wiggle."""
    traj = EasyDict.init_recursively(traj)
    num_samples = len(canonical)
    name = traj['name']
    num_frames = len(traj['yaw_offsets']) if name == 'points' else traj.get('num_frames', 1)
    cam = canonical.repeat_interleave(num_frames)
    angles = cam.angles.cpu().numpy()
    fov = cam.fov.cpu().numpy()

    if name == 'point':
        if num_frames != 1:
            raise ValueError(f"trajectory 'point' has one frame, not {num_frames}")
        angles = angles + np.asarray([traj['yaw_offset'], traj['pitch_offset'], 0.0])
        fov = fov + traj.get('fov_offset', 0.0)
    elif name == 'front_circle':
        steps = np.tile(np.linspace(0, 1, num_frames), num_samples)
        yaw = angles[:, 0] + traj['yaw_diff'] * np.sin(steps * 2 * np.pi)
        pitch = angles[:, 1] + traj['pitch_diff'] * np.cos(steps * 2 * np.pi)
        angles = np.stack([yaw, pitch, angles[:, 2]], axis=1)
        fov = fov + traj['fov_diff'] * np.sin(steps * 2 * np.pi)
    elif name == 'points':
        yaw = angles[:, 0] + np.tile(np.asarray(traj['yaw_offsets']), num_samples)
        pitch = angles[:, 1] + traj.get('pitch_offset', 0.0)
        angles = np.stack([yaw, pitch, angles[:, 2]], axis=1)
    elif name == 'wiggle':
        yaws = np.tile(np.linspace(traj['yaw_left'], traj['yaw_right'], num_frames), num_samples)
        pitches = np.tile(traj['pitch_diff'] * np.cos(np.linspace(0, 1, num_frames) * 2 * np.pi)
                          + np.pi / 2, num_samples)
        angles = np.stack([yaws, pitches, np.zeros_like(yaws)], axis=1)
    elif name == 'line':
        yaws = np.tile(np.linspace(traj['yaw_start'], traj['yaw_end'], num_frames), num_samples)
        pitches = np.tile(np.linspace(traj['pitch_start'], traj['pitch_end'], num_frames),
                          num_samples)
        angles = np.stack([yaws, pitches, np.zeros_like(yaws)], axis=1)
        if traj.get('fov') is not None:
            fov = np.full_like(fov, traj['fov'])
    else:
        raise NotImplementedError(f'Unknown trajectory: {name}')

    device = cam.angles.device
    return TensorGroup(
        angles=torch.as_tensor(np.asarray(angles, dtype=np.float32), device=device),
        fov=torch.as_tensor(np.asarray(fov + traj.get('fov_offset', 0.0), dtype=np.float32),
                            device=device),
        radius=cam.radius, look_at=cam.look_at)


@torch.no_grad()
def canonical_cameras(cfg: Config, num: int, G: Optional[Generator] = None,
                      z: Optional[torch.Tensor] = None, c: Optional[torch.Tensor] = None,
                      use_posterior: bool = False,
                      device: torch.device | str | None = None) -> TensorGroup:
    """The prior's mean camera `num` times, warped through the camera
    adaptor with `use_posterior` (and an enabled adaptor). On `device`, else
    where G is, else the CPU."""
    if device is None:
        device = _device(G) if G is not None else 'cpu'
    mean = get_mean_camera_params(cfg.camera, device=device)
    cam = TensorGroup(angles=mean.angles.repeat(num, 1), fov=mean.fov.repeat(num),
                      radius=mean.radius.repeat(num), look_at=mean.look_at.repeat(num, 1))
    if use_posterior and G is not None and cfg.generator.camera_adaptor.enabled:
        with exact_fp32():
            cam = G.synthesis.apply_camera_adaptor(cam, z, c)
    return cam


# ----------------------------------------------------------------- rendering

def make_synthesis_fn(G: Generator, **synthesis_kwargs) -> Callable[..., torch.Tensor]:
    """(ws, camera) -> images [N, H, W, C] in [-1, 1] and beyond, with the
    const noise, rays `max_batch_res**2` at a time above that."""
    mbr = G.cfg.max_batch_res
    if 'ray_chunk' not in synthesis_kwargs and G.cfg.img_resolution > mbr:
        synthesis_kwargs['ray_chunk'] = mbr * mbr

    @torch.no_grad()
    def fn(ws: torch.Tensor, cam: TensorGroup) -> torch.Tensor:
        with exact_fp32():
            return G.synthesis(ws, cam, **synthesis_kwargs)

    return fn


def generate(G: Generator, ws: torch.Tensor, camera_params: TensorGroup, batch_size: int = 4,
             **synthesis_kwargs) -> np.ndarray:
    """Images of every (w, camera) pair in batches of `batch_size`, the tail
    batch padded with copies of its first row as in the JAX package, so that
    every batch has one shape -> [N, H, W, C] floats in [0, 1]."""
    fn = make_synthesis_fn(G, **synthesis_kwargs)
    outs = []
    n = ws.shape[0]
    for i in range(0, n, batch_size):
        real = min(batch_size, n - i)
        pad = batch_size - real
        w_b = ws[i:i + real]
        cam_b = camera_params.select(slice(i, i + real))
        if pad:
            w_b = torch.cat([w_b, w_b[:1].repeat(pad, *[1] * (w_b.ndim - 1))])
            cam_b = TensorGroup.cat([cam_b, cam_b.select(slice(0, 1)).repeat_interleave(pad)])
        img = fn(w_b, cam_b).clamp(-1.0, 1.0) * 0.5 + 0.5
        outs.append(img[:real].cpu().numpy())
    return np.concatenate(outs)


def generate_trajectory(G: Generator, ws: torch.Tensor, camera_params: TensorGroup,
                        batch_size: int = 4, **synthesis_kwargs) -> np.ndarray:
    """Every w along its trajectory (`camera_params` holds each sample's
    frames in a row) -> [num_frames, num_samples, H, W, C] floats in [0, 1]."""
    num_samples = ws.shape[0]
    num_frames = len(camera_params) // num_samples
    imgs = generate(G, ws.repeat_interleave(num_frames, dim=0), camera_params,
                    batch_size=batch_size, **synthesis_kwargs)
    imgs = imgs.reshape(num_samples, num_frames, *imgs.shape[1:])
    return imgs.transpose(1, 0, 2, 3, 4)


# --------------------------------------------------------------------- io

def make_grid(images: np.ndarray, nrow: Optional[int] = None, pad: int = 2) -> np.ndarray:
    """[N, H, W, C] floats in [0, 1] -> one grid image [GH, GW, C] on white."""
    n, h, w, c = images.shape
    nrow = nrow or int(math.ceil(math.sqrt(n)))
    ncol = int(math.ceil(n / nrow))
    grid = np.ones((ncol * (h + pad) - pad, nrow * (w + pad) - pad, c), dtype=images.dtype)
    for i in range(n):
        r, col = divmod(i, nrow)
        grid[r * (h + pad): r * (h + pad) + h, col * (w + pad): col * (w + pad) + w] = images[i]
    return grid


def save_image(img: np.ndarray, path: str) -> None:
    """float [0, 1] HWC -> png / jpg."""
    arr = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    PIL.Image.fromarray(arr).save(path)


def save_video_frames(frames: np.ndarray, path: str, fps: int = 25) -> None:
    """[T, H, W, C] floats in [0, 1] -> an animated gif, or an mp4 through
    ffmpeg; without ffmpeg, a gif beside the requested path."""
    arrs = [np.clip(f * 255.0 + 0.5, 0, 255).astype(np.uint8) for f in frames]
    if path.endswith('.gif'):
        ims = [PIL.Image.fromarray(a) for a in arrs]
        ims[0].save(path, save_all=True, append_images=ims[1:], duration=int(1000 / fps),
                    loop=0)
        return
    if shutil.which('ffmpeg') is None:
        save_video_frames(frames, os.path.splitext(path)[0] + '.gif', fps)
        return
    with tempfile.TemporaryDirectory() as td:
        for i, a in enumerate(arrs):
            PIL.Image.fromarray(a).save(os.path.join(td, f'{i:05d}.png'))
        subprocess.run(['ffmpeg', '-y', '-framerate', str(fps), '-i',
                        os.path.join(td, '%05d.png'), '-c:v', 'libx264', '-crf', '20',
                        '-pix_fmt', 'yuv420p', path], check=True)


@torch.no_grad()
def generate_videos(G: Generator, cfg: Config, z: torch.Tensor, c: Optional[torch.Tensor],
                    num_frames: int = 32, batch_size: int = 4) -> np.ndarray:
    """front_circle preview videos of the first (up to 16, or 9 at 1024^2)
    latents -> [num_videos, num_frames, H, W, C]."""
    num_videos = min(z.shape[0], 9 if cfg.generator.img_resolution >= 1024 else 16)
    z, c = z[:num_videos], (c[:num_videos] if c is not None else None)
    canon = canonical_cameras(cfg, num_videos, G=G, z=z, c=c)
    traj = dict(name='front_circle', num_frames=num_frames, fov_diff=1.0,
                yaw_diff=0.5, pitch_diff=0.3, use_mean_camera=True)
    cams = generate_camera_trajectory(traj, canon)
    with exact_fp32():
        ws = G.mapping(z, c, camera_angles=canon.angles)
    frames = generate_trajectory(G, ws, cams, batch_size=batch_size)
    return frames.transpose(1, 0, 2, 3, 4)
