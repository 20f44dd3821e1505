"""Training entry point of the port (counterpart of `scripts/train.py`).

    python3 -m tdgp_torch.scripts.train --preset synth256 dataset.path=DIR [--max-kimg 20]
    python3 -m tdgp_torch.scripts.train --preset stylegan2 dataset.path=DIR training.metrics=[]

`--preset` picks the base config, `--config` a YAML overlay (a JAX run's
`experiment_config.yaml` loads unchanged), then dotted key=value overrides
(anywhere among the flags).
A new run directory is made under `--run-root`, named after the config and
the git hash, with the frozen config in it; `--run-dir` resumes an existing
one from its frozen config and its newest snapshot. The in-loop metrics
(`training.metrics`, computed when `dataset.path` is set; fid2k_full and
nfs256 by default) use InceptionV3 where $TDGP_INCEPTION_WEIGHTS names
converted weights, else the random projection detector
(`tdgp_torch.metrics.detectors`), the FID proxy of the JAX runs: the repo
holds no InceptionV3 weights. Every `training.image_snap`
ticks a 4x4 grid of the EMA generator's images is written to the run
directory (for the 2D StyleGAN2 baseline, `--preset stylegan2`, its images
with the const noise: the JAX script's grid renders through a camera, which
a 2D generator does not take). The 2D baseline has no in-loop metric: the
JAX package has no 2D image sampler, so `fid2k_full` raises on it and the
loop contains that failure as it contains any metric's. Runs on the card
unless given `--device cpu`. A preset trains at
its own precision (the bf16 blocks of G and D, unless `fp32_only`);
`generator.fp32_only=true discriminator.fp32_only=true` is the float32 cut.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import torch

from tdgp_torch.config import PRESETS, is_2d, load_config
from tdgp_torch.infra.experiment import config_to_dict, create_experiment_dir
from tdgp_torch.rendering.camera import get_max_sampling_value, validate_frustum
from tdgp_torch.utils.misc import exact_fp32, resolve_device


def make_metric_fn(cfg, run_dir: str, device: torch.device):
    """(trainer, cur_nimg) -> {name: value} for each of `training.metrics`,
    on G_ema, each result appended to <run_dir>/metric-<name>.jsonl."""
    from tdgp_torch.data.dataset import ImageFolderDataset
    from tdgp_torch.metrics.detectors import make_fid_detector
    from tdgp_torch.metrics.registry import EvalContext, calc_metric, report_metric

    detector = make_fid_detector(
        device, 'WARNING: no InceptionV3 weights; using RandomProjectionDetector (metric '
        'values will not be comparable to the reference)')
    eval_dataset = ImageFolderDataset(cfg.dataset.path, resolution=cfg.dataset.resolution,
                                      use_labels=cfg.dataset.c_dim > 0)

    def metric_fn(trainer, cur_nimg):
        ctx = EvalContext(cfg=cfg, G=trainer.G_ema, dataset=eval_dataset, detector=detector,
                          cache_dir=os.path.join(run_dir, 'metric-cache'))
        results = {}
        for m in cfg.training.metrics:
            rd = calc_metric(m, ctx)
            report_metric(rd, run_dir=run_dir, snapshot=f'{cur_nimg // 1000:06d}')
            results.update(rd['results'])
        return results

    return metric_fn


def make_vis_fn(cfg, run_dir: str):
    """(trainer, cur_nimg) -> None: seeds 0-15 of G_ema from the mean camera,
    labels cycling through the classes, as a grid fakes<kimg>.png."""
    from tdgp_torch import inference

    def vis_fn(trainer, cur_nimg):
        G = trainer.G_ema
        device = next(G.parameters()).device
        z = inference.sample_z_from_seeds(range(16), cfg.generator.z_dim, device)
        c = None
        if cfg.dataset.c_dim > 0:
            c = torch.nn.functional.one_hot(torch.arange(16, device=device) % cfg.dataset.c_dim,
                                            cfg.dataset.c_dim).float()
        if is_2d(cfg):
            with torch.no_grad(), exact_fp32():
                imgs = torch.cat([G(z[i:i + 4], None if c is None else c[i:i + 4])
                                  for i in range(0, 16, 4)])
            imgs = (imgs.clamp(-1.0, 1.0) * 0.5 + 0.5).cpu().numpy()
        else:
            cams = inference.canonical_cameras(cfg, 16, G=G, z=z, c=c)
            with torch.no_grad(), exact_fp32():
                ws = G.map_ws(z, c, camera_angles=cams.angles)
            imgs = inference.generate(G, ws, cams, batch_size=4)
        inference.save_image(inference.make_grid(imgs),
                             os.path.join(run_dir, f'fakes{cur_nimg // 1000:06d}.png'))

    return vis_fn


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--config', default=None, help='YAML config overlay')
    ap.add_argument('--preset', default='default',
                    choices=sorted(PRESETS))
    ap.add_argument('--run-root', default='experiments')
    ap.add_argument('--run-dir', default=None,
                    help='existing run directory to resume (its frozen experiment_config.yaml '
                         'is the config unless --config is given)')
    ap.add_argument('--desc', default=None)
    ap.add_argument('--dry-run', action='store_true', help='print the config and stop')
    ap.add_argument('--max-kimg', type=float, default=None)
    ap.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    ap.add_argument('overrides', nargs='*', help='dotted key=value overrides')
    args = ap.parse_intermixed_args(argv)

    if args.run_dir and args.config is None:
        frozen = os.path.join(args.run_dir, 'experiment_config.yaml')
        if os.path.exists(frozen):
            args.config = frozen
    cfg = load_config(args.config, overrides=args.overrides, preset=args.preset)

    cam = cfg.camera
    if cam.validate_viewing_frustum and not validate_frustum(
            fov=get_max_sampling_value(cam.fov), near=cam.ray.start, far=cam.ray.end,
            radius=get_max_sampling_value(cam.origin.radius), scale=cam.cube_scale):
        raise ValueError('the viewing frustum leaves the scene cube: adjust fov, radius or '
                         'cube_scale')
    if cfg.training.batch_size % cfg.discriminator.mbstd_group_size:
        raise ValueError(f'training.batch_size {cfg.training.batch_size} is not a multiple of '
                         f'the mbstd group {cfg.discriminator.mbstd_group_size}')
    if args.dry_run:
        print(json.dumps(config_to_dict(cfg), indent=2, default=str))
        return None

    device = resolve_device(args.device)
    if args.run_dir:
        if not os.path.isdir(args.run_dir):
            raise FileNotFoundError(args.run_dir)
        run_dir = args.run_dir
    else:
        run_dir = create_experiment_dir(cfg, args.run_root, desc=args.desc)
    print(f'Run dir: {run_dir}')

    metric_fn = None
    if cfg.training.metrics and cfg.dataset.path:
        metric_fn = make_metric_fn(cfg, run_dir, device)

    from tdgp_torch.training.loop import training_loop
    return training_loop(cfg, run_dir, device=device, metric_fn=metric_fn,
                         vis_fn=make_vis_fn(cfg, run_dir), max_kimg=args.max_kimg)


if __name__ == '__main__':
    main()
