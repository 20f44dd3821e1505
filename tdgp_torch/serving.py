"""Serving: z -> image from a trained generator (port of `tdgp/serving.py`).

`load_generator` reads a JAX training run's directory (its
`experiment_config.yaml` and the exported `g_ema_leg1.npz`) into the port's
`Generator` on a device; `make_serving_fn` closes over it and serves with
the signature of the JAX package's `make_serving_fn`:

    (z [B, z_dim], c [B, c_dim], angles [B, 3], fov [B], radius [B],
     look_at [B, 3]) -> images [B, H, W, 3] in [0, 1]

Truncation pulls toward the mapping's `w_avg`; noise is the stored const
noise. The JAX package's `jax.export` artifact has no counterpart here.
"""
from __future__ import annotations

import os
from typing import Callable, Sequence, Union

import numpy as np
import torch

from tdgp_torch.config import load_config
from tdgp_torch.models.epigraf import Generator
from tdgp_torch.utils.misc import exact_fp32, resolve_device
from tdgp_torch.utils.tensor_group import TensorGroup
from tdgp_torch.weights import load_flat

WEIGHTS_FILE = 'g_ema_leg1.npz'


def load_generator(run_dir: str, device: Union[str, torch.device] = 'cuda',
                   overrides: Sequence[str] = ()) -> Generator:
    """The run's EMA generator on `device`, in eval mode. `overrides` are
    dotted config overrides such as 'generator.ray_march_impl=fused'."""
    device = resolve_device(device)
    cfg = load_config(os.path.join(run_dir, 'experiment_config.yaml'), overrides)
    G = Generator(cfg.generator)
    with np.load(os.path.join(run_dir, WEIGHTS_FILE)) as flat:
        load_flat(G, flat)
    return G.to(device).eval()


def make_serving_fn(G: Generator, truncation_psi: float = 1.0,
                    **synthesis_kwargs) -> Callable[..., torch.Tensor]:
    """z -> image closure over `G`. Rays are rendered `max_batch_res**2` at
    a time when the image has more, as in the JAX package. Inputs may be
    arrays or tensors; they are moved to `G`'s device."""
    mbr = G.cfg.max_batch_res
    if 'ray_chunk' not in synthesis_kwargs and G.cfg.img_resolution > mbr:
        synthesis_kwargs['ray_chunk'] = mbr * mbr
    device = next(G.parameters()).device

    def as_input(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    @torch.no_grad()
    def fn(z, c, angles, fov, radius, look_at) -> torch.Tensor:
        z, c, angles, fov, radius, look_at = map(as_input, (z, c, angles, fov, radius, look_at))
        cam = TensorGroup(angles=angles, fov=fov, radius=radius, look_at=look_at)
        with exact_fp32():
            ws = G.map_ws(z, c, camera_angles=angles, truncation_psi=truncation_psi)
            img = G.synthesis(ws, cam, **synthesis_kwargs)
        return img.clamp(-1.0, 1.0) * 0.5 + 0.5

    return fn
