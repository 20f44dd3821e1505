"""Density-grid geometry to .obj / .mrc from a trained run
(port of `scripts/extract_geometry.py`).

    python3 -m tdgp_torch.scripts.extract_geometry --run-dir RUN --seeds 0,1,2 \
        --resolution 128 --out-dir meshes/

The flags are the JAX script's, plus `--device` and `--override` as in
`tdgp_torch.scripts.inference`. Marching runs in the port's C++ copy,
built with g++ at first use.
"""
from __future__ import annotations

import argparse
import os
from typing import Sequence

import torch

from tdgp_torch.scripts.inference import (DEFAULT_OVERRIDES, add_run_arguments, class_labels,
                                          load_run, parse_seeds)


def main(argv: Sequence[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    add_run_arguments(ap)
    ap.add_argument('--seeds', default='0')
    ap.add_argument('--resolution', type=int, default=128)
    ap.add_argument('--level', type=float, default=None, help='iso level (default: p90)')
    ap.add_argument('--save-mrc', action='store_true')
    ap.add_argument('--out-dir', default=None)
    args = ap.parse_args(argv)

    from tdgp_torch import geometry, inference

    cfg, G = load_run(args.run_dir, args.snapshot, args.device,
                      args.override or DEFAULT_OVERRIDES)
    device = next(G.parameters()).device
    out_dir = args.out_dir or os.path.join(args.run_dir, 'geometry')
    os.makedirs(out_dir, exist_ok=True)
    for seed in parse_seeds(args.seeds):
        z = inference.sample_z_from_seeds([seed], cfg.generator.z_dim, device)
        c = class_labels(cfg, [seed], None, device)
        cams = inference.canonical_cameras(cfg, 1, G=G, z=z, c=c)
        with torch.no_grad():
            ws = G.mapping(z, c, camera_angles=cams.angles)
        verts, faces, sigma = geometry.extract_geometry(
            G, ws, resolution=args.resolution, cube_scale=cfg.camera.cube_scale,
            level=args.level)
        obj_path = os.path.join(out_dir, f'seed{seed:04d}.obj')
        geometry.save_obj(verts, faces, obj_path)
        print(f'seed {seed}: {len(verts)} verts, {len(faces)} faces -> {obj_path}')
        if args.save_mrc:
            geometry.save_mrc(sigma, os.path.join(out_dir, f'seed{seed:04d}.mrc'))


if __name__ == '__main__':
    main()
