"""Image grids and multi-view videos from a trained run (port of `scripts/inference.py`).

    python3 -m tdgp_torch.scripts.inference --run-dir RUN --vis image_grid \
        --seeds 0-15 --truncation 0.7 --output grid.png
    python3 -m tdgp_torch.scripts.inference --run-dir RUN --vis video_grid \
        --trajectory front_circle --num-frames 32 --output video.gif

The flags are the JAX script's, plus `--device` (default cuda; cpu runs on
the CPU) and `--override` (dotted config overrides, repeatable). The run is
served at the precision it was trained at: the bf16 blocks of its
`num_fp16_res` unless its config says `fp32_only`; `--override
generator.fp32_only=true` runs every block in float32.
`--snapshot` names the run's EMA export (`g_ema_leg1.npz` by default, as
`scripts/infra/export_ema.py` writes it); orbax snapshots are not ported.
"""
from __future__ import annotations

import argparse
import os
from typing import List, Sequence, Tuple

import numpy as np
import torch

from tdgp_torch.config import Config, load_config
from tdgp_torch.models.epigraf import Generator
from tdgp_torch.serving import WEIGHTS_FILE
from tdgp_torch.utils.misc import resolve_device
from tdgp_torch.weights import load_flat

def parse_seeds(spec: str) -> List[int]:
    """'0-3,7' -> [0, 1, 2, 3, 7]."""
    out = []
    for part in spec.split(','):
        if '-' in part:
            a, b = part.split('-')
            out.extend(range(int(a), int(b) + 1))
        else:
            out.append(int(part))
    return out


def load_run(run_dir: str, snapshot: str = WEIGHTS_FILE, device: str = 'cuda',
             overrides: Sequence[str] = ()) -> Tuple[Config, Generator]:
    """The run's config and its EMA generator from an `.npz` export (a path,
    or a file in `run_dir`), on `device`, in eval mode."""
    if not snapshot.endswith('.npz'):
        raise NotImplementedError(
            f'snapshot {snapshot!r}: the port reads EMA .npz exports only; orbax snapshots '
            f"('latest', 'best', checkpoint paths) wait for ROADMAP §1 item 2 (loop, data, "
            f'snapshots)')
    candidates = [snapshot, os.path.join(run_dir, snapshot)]
    path = next((p for p in candidates if os.path.exists(p)), None)
    if path is None:
        raise FileNotFoundError(f'no EMA export found; tried {candidates}')
    device = resolve_device(device)
    cfg = load_config(os.path.join(run_dir, 'experiment_config.yaml'), overrides,
                      finalize=False)
    G = Generator(cfg.generator)
    with np.load(path) as flat:
        load_flat(G, flat)
    return cfg, G.to(device).eval()


def class_labels(cfg: Config, seeds: Sequence[int], classes: str | None,
                 device: torch.device) -> torch.Tensor | None:
    """One-hot c [len(seeds), c_dim]: `classes` in turn, else seed % c_dim;
    None for an unconditional run."""
    c_dim = cfg.dataset.c_dim
    if c_dim == 0:
        return None
    if classes:
        cls = [int(x) for x in classes.split(',')]
        idx = [cls[i % len(cls)] for i in range(len(seeds))]
    else:
        idx = [s % c_dim for s in seeds]
    return torch.eye(c_dim, device=device)[idx]


def add_run_arguments(ap: argparse.ArgumentParser) -> None:
    ap.add_argument('--run-dir', required=True)
    ap.add_argument('--snapshot', default=WEIGHTS_FILE,
                    help=f'an EMA .npz export, a path or a file of the run (default {WEIGHTS_FILE})')
    ap.add_argument('--device', default='cuda', help='cuda (default) or cpu')
    ap.add_argument('--override', action='append', default=None,
                    help='dotted config override, repeatable (generator.fp32_only=true: '
                         'every block in float32)')


def main(argv: Sequence[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    add_run_arguments(ap)
    ap.add_argument('--vis', default='image_grid', choices=['image_grid', 'video_grid'])
    ap.add_argument('--seeds', default='0-15')
    ap.add_argument('--truncation', type=float, default=1.0)
    ap.add_argument('--trajectory', default='front_circle',
                    choices=['front_circle', 'line', 'wiggle', 'points', 'point'])
    ap.add_argument('--num-frames', type=int, default=32)
    ap.add_argument('--batch-size', type=int, default=4)
    ap.add_argument('--classes', default=None, help='comma list of class ids')
    ap.add_argument('--output', default=None)
    args = ap.parse_args(argv)

    from tdgp_torch import inference

    cfg, G = load_run(args.run_dir, args.snapshot, args.device,
                      args.override or ())
    device = next(G.parameters()).device
    seeds = parse_seeds(args.seeds)
    c = class_labels(cfg, seeds, args.classes, device)
    z = inference.sample_z_from_seeds(seeds, cfg.generator.z_dim, device)
    cams = inference.canonical_cameras(cfg, len(seeds), G=G, z=z, c=c)
    ws = inference.sample_ws_from_seeds(G, seeds, c, cams.angles, truncation_psi=args.truncation)

    if args.vis == 'image_grid':
        imgs = inference.generate(G, ws, cams, batch_size=args.batch_size)
        out = args.output or os.path.join(args.run_dir, 'grid.png')
        inference.save_image(inference.make_grid(imgs), out)
    else:
        traj = dict(name=args.trajectory, num_frames=args.num_frames,
                    fov_diff=1.0, yaw_diff=0.5, pitch_diff=0.3,
                    yaw_left=-0.5, yaw_right=0.5,
                    yaw_start=-0.5, yaw_end=0.5,
                    pitch_start=np.pi / 2, pitch_end=np.pi / 2,
                    yaw_offset=0.0, pitch_offset=0.0, fov=None,
                    yaw_offsets=[-0.4, 0.0, 0.4], use_mean_camera=True)
        cams_traj = inference.generate_camera_trajectory(traj, cams)
        frames = inference.generate_trajectory(G, ws, cams_traj, batch_size=args.batch_size)
        out = args.output or os.path.join(args.run_dir, 'video.gif')
        inference.save_video_frames(np.stack([inference.make_grid(f) for f in frames]), out)
    print(f'wrote {out}')


if __name__ == '__main__':
    main()
