"""Where the time of a training step goes, on the card.

    python3 -m tdgp_torch.profile_training [--steps 2] [--preset stylegan2]

Builds the trainer that `chip_smoke.py` drives, as `bench.py` builds the JAX
one: `satellite_config(c_dim=0, resolution=256)` (tri-planes 3x512^2x32,
64^2 patches, 32 + 32 ray steps, both adaptors, KD with 2048-d embeddings,
R1 every 16 steps), or with `--preset stylegan2` the 2D StyleGAN2 baseline
(`stylegan2_config(c_dim=0, resolution=256)`, finalized as the training
entry point loads it, batch 16: R1 and path-length regularization every 16
steps, style mixing), at its own precision (G's and D's bf16 blocks;
`--override generator.fp32_only=true --override discriminator.fp32_only=true`
is the float32 cut), random weights from a seed, batch 16
of a synthetic real batch made on the card, schedules at 500 kimg. After a
warm-up step it traces `--steps` plain steps and one R1 step with
torch.profiler and prints the device time by phase (Gmain, camera
regularizers, PL, Dmain, R1, EMA, per run of each), by operation and by
kernel (per step, averaged over the traced steps), the port's own kernels
(K1, K3, K3's backward, K5) by name, the device's busy share of the wall time and the
peak memory. The last line is a JSON object
of these numbers, with the card's name and power limit. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Dict, List, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from tdgp_torch.config import Config, apply_overrides, load_config, satellite_config
from tdgp_torch.training.schedules import compute_schedules
from tdgp_torch.training.train_step import PHASES, Trainer
from tdgp_torch.utils.draws import Draws

FP32 = ['generator.fp32_only=true', 'discriminator.fp32_only=true']  # the float32 cut
# the port's own kernels on the training path, by the names of their CUDA
# functions (K1: its two binning kernels, the strip kernel and the
# coordinate-gradient combination; its wrapper's memsets and offset sum are
# left out)
OWN_KERNELS = {'K1 triplane_splat': ('bin_count_kernel', 'bin_scatter_kernel',
                                     'splat_strip_kernel', 'coords_grad_kernel'),
               'K3 ray_march_reduced': ('ray_march_reduced_kernel',),
               'K3 ray_march_reduced_bwd': ('ray_march_reduced_bwd_kernel',),
               'K5 bias_act': ('bias_act_',)}
BATCH = 16
CUR_NIMG = 500_000  # mid-training schedule values, as bench.py takes them


def train_config(overrides=(), preset: str = 'satellite') -> Config:
    """The satellite 256^2 configuration (no finalize, as bench.py), or the
    'stylegan2' preset at 256^2 and batch BATCH (finalized, as
    `scripts.train` loads it), with dotted `overrides` (`FP32`: every
    block in float32)."""
    if preset == 'stylegan2':
        return load_config(preset='stylegan2',
                           overrides=[f'training.batch_size={BATCH}'] + list(overrides))
    return apply_overrides(satellite_config(c_dim=0, resolution=256), list(overrides))


def make_batch(cfg: Config, n: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """A synthetic real batch, the recipe of `bench.py:make_batch`: images and
    depth uniform in [-1, 1], one-hot labels, angles, normal embeddings."""
    g = torch.Generator(device=device).manual_seed(seed)
    res, c_dim = cfg.dataset.resolution, cfg.dataset.c_dim
    labels = torch.eye(max(c_dim, 1), device=device)[torch.arange(n) % max(c_dim, 1)][:, :c_dim]
    kw = dict(generator=g, device=device)
    angles = torch.cat([torch.rand(n, 2, **kw) + 0.5, torch.zeros(n, 1, device=device)], 1)
    return {'img': torch.rand(n, res, res, 3, **kw) * 2 - 1,
            'depth': torch.rand(n, res, res, 1, **kw) * 2 - 1,
            'c': labels,
            'camera_angles': angles,
            'embs': torch.randn(n, cfg.dataset.embedding_dim, **kw)}


def capture_splat_calls(trainer: Trainer, batch, sched, draws) -> List[Tuple[str, tuple]]:
    """Runs one plain step of `trainer` and keeps the arguments of its calls
    of kernel K1 (`ops.splat.triplane_splat`, the backward of the Gmain
    render's plane sampling): [('coarse' | 'fine', (planes, coords, g,
    scale, coords_grad))], in the order of the render passes' forwards."""
    from tdgp_torch.models import epigraf
    from tdgp_torch.ops import splat
    sample, splat_fn = epigraf.triplane_sample, splat.triplane_splat
    forwards, calls = [], []

    def recorded_sample(planes, coords, scale):
        if torch.is_grad_enabled() and planes.requires_grad:
            forwards.append(coords.data_ptr())
        return sample(planes, coords, scale)

    def recorded_splat(planes, coords, g, scale, coords_grad=True):
        calls.append((planes, coords, g, scale, coords_grad))
        return splat_fn(planes, coords, g, scale, coords_grad)

    recorded_splat.launches = splat_fn.launches  # the wrapper counts under its module name
    epigraf.triplane_sample, splat.triplane_splat = recorded_sample, recorded_splat
    try:
        trainer.step(batch, sched, False, draws)
    finally:
        epigraf.triplane_sample, splat.triplane_splat = sample, splat_fn
        splat_fn.launches = recorded_splat.launches
    order = [len(forwards) - 1 - forwards[::-1].index(c[1].data_ptr()) for c in calls]
    if len(calls) != 2 or len(set(order)) != 2:
        raise RuntimeError(f'expected the coarse and the fine pass, got {len(calls)} calls '
                           f'at forwards {order}')
    return list(zip(('coarse', 'fine'), [c for _, c in sorted(zip(order, calls))]))


def _self_device_us(event) -> float:
    return float(getattr(event, 'self_device_time_total',
                         getattr(event, 'self_cuda_time_total', 0.0)))


def _device_us(event) -> float:
    return float(getattr(event, 'device_time_total', getattr(event, 'cuda_time_total', 0.0)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--steps', type=int, default=2)
    ap.add_argument('--override', action='append', default=[],
                    help='dotted config override, repeatable (FP32 gives the float32 cut)')
    ap.add_argument('--preset', default='satellite', choices=['satellite', 'stylegan2'])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('profile_training: no CUDA device')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f'card: {card}')

    cfg = train_config(args.override, args.preset)
    trainer = Trainer(cfg, 'cuda', seed=0)
    batch = make_batch(cfg, BATCH, 0, 'cuda')
    sched = compute_schedules(cfg, CUR_NIMG)
    draws = Draws(torch.Generator(device='cuda').manual_seed(1))
    trainer.step(batch, sched, False, draws)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    n_steps = args.steps + 1
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_steps):
            trainer.step(batch, sched, i == n_steps - 1, draws)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n_steps
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    averages = prof.key_averages()
    # the phases' ranges show on the device too; they are not kernels
    kernels = sorted((e for e in averages
                      if e.device_type == DeviceType.CUDA and e.key not in PHASES),
                     key=_self_device_us, reverse=True)
    ops = sorted((e for e in averages
                  if e.device_type == DeviceType.CPU and _self_device_us(e) > 0),
                 key=_self_device_us, reverse=True)
    device_ms = sum(_self_device_us(e) for e in kernels) / 1e3 / n_steps
    print(f'per step ({args.steps} plain + 1 R1): wall {wall_ms:.2f} ms under the profiler, '
          f'device busy {device_ms:.2f} ms ({100 * device_ms / wall_ms:.1f} %), '
          f'peak memory {peak_gib:.2f} GiB')

    # device ms per run of each phase (R1 runs in one of the steps): the
    # device-side range may come in several pieces, so the number of runs is
    # the host-side range's count
    runs = {e.key: e.count for e in averages if e.key in PHASES and e.device_type == DeviceType.CPU}
    phases = {e.key: _device_us(e) / 1e3 / runs[e.key] for e in averages
              if e.key in runs and e.device_type == DeviceType.CUDA}
    print('device ms per run of each phase: '
          + ', '.join(f'{k} {phases.get(k, 0.0):.2f}' for k in PHASES))

    def table(title, entries, n):
        rows = []
        print(title)
        for e in entries[:n]:
            ms = _self_device_us(e) / 1e3 / n_steps
            rows.append({'name': e.key[:100], 'ms_per_step': ms,
                         'calls_per_step': e.count / n_steps, 'share': ms / device_ms})
            print(f'{ms:9.3f} ms {100 * ms / device_ms:5.1f} %  '
                  f'x{e.count / n_steps:<6g} {e.key[:100]}')
        return rows

    top_ops = table('device time by operation:', ops, 25)
    top_kernels = table('device time by kernel:', kernels, 15)
    print("the port's own kernels:")
    own = {}
    for name, parts in OWN_KERNELS.items():
        found = [e for e in kernels if any(part in e.key for part in parts)]
        ms = sum(_self_device_us(e) for e in found) / 1e3 / n_steps
        calls = sum(e.count for e in found) / n_steps
        own[name] = {'ms_per_step': ms, 'calls_per_step': calls, 'share': ms / device_ms}
        print(f'{ms:9.3f} ms {100 * ms / device_ms:5.1f} %  x{calls:<6g} {name}')
    print(json.dumps({'card': card, 'preset': args.preset, 'overrides': args.override,
                      'batch': BATCH,
                      'steps': n_steps, 'r1_steps': 1,
                      'wall_ms_profiled': wall_ms, 'device_busy_ms': device_ms,
                      'device_busy_share': device_ms / wall_ms, 'phases_device_ms': phases,
                      'peak_memory_gib': peak_gib, 'top_ops': top_ops,
                      'top_kernels': top_kernels, 'own_kernels': own}))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
