"""PL's float32 G-gradient check repeated, and K3's second order on that check's own inputs.

    python3 -m tdgp_torch.pl_check_spread [--reps N] [--earlier LABEL=DIR ...] [--out FILE]

Runs on one card. DIR is a checkout of another commit whose
`tdgp_torch/csrc/ray_march.cu` is built (`compare_kernels.build_earlier`) and
bound in place of this tree's through `compare_kernels.ray_march_library`.

1. The second order's accuracy: one `Trainer._pl` of `chip_smoke.pl_check_phase`
   (its configuration, batch, warm-up step and draws), at the float32 cut and
   with bf16 blocks, records the arguments of each `ray_march_reduced_bwd_bwd`
   call; on those, this tree's kernel, each earlier one and the plain version
   in float32 are held against the plain version in float64: per output the
   relative L2 difference, the largest difference over the largest magnitude,
   and the relative L2 difference of the per-ray sums.
2. The check itself, at the float32 cut, REPS times, in turns over this tree's
   kernels and each earlier `ray_march.cu`: per parameter the kernels' path
   against the plain path (`rel`), the plain path against itself (`spread`), the
   floor (the larger of `spread` and `chip_smoke.FLOOR_SEEDS`' one-ulp
   perturbations), the limit max(GRAD_LIMIT, 2 x floor) and the kernels' path
   against itself (`kspread`); the reps whose worst parameter misses its limit,
   and the medians over the camera adaptor's parameters, whose PL gradient
   cancels. With --out, every rep's dictionaries as JSON lines.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTPUTS = ('colors', 'densities', 'depths', 'g_rgb', 'g_depth', 'g_wsum', 'g_ftrans')


class PLCheck:
    """The state `chip_smoke.pl_check_phase` starts from: a trainer after its
    warm-up R1 + PL step, its generator inputs, and PL's G gradient from there."""

    def __init__(self, chip_smoke, overrides):
        from tdgp_torch import profile_training
        from tdgp_torch.training.schedules import compute_schedules
        from tdgp_torch.training.train_step import Trainer, sample_gen_inputs
        from tdgp_torch.utils.draws import Draws
        self.cs, self.Draws = chip_smoke, Draws
        self.sched = compute_schedules(profile_training.train_config(),
                                       profile_training.CUR_NIMG)
        cfg = profile_training.train_config(
            list(overrides) + chip_smoke.PL + ['generator.use_noise=false'])
        self.trainer = Trainer(cfg, 'cuda', seed=0)
        batch = profile_training.make_batch(cfg, chip_smoke.PL_CHECK_BATCH, 2, 'cuda')
        self.trainer.step(batch, self.sched, True,
                          Draws(torch.Generator(device='cuda').manual_seed(1)))
        self.start = chip_smoke.sg2_trainer_state(self.trainer)
        self.gen = sample_gen_inputs(
            Draws(torch.Generator(device='cuda').manual_seed(5)).scope('gen_g'),
            chip_smoke.PL_CHECK_BATCH, cfg, self.sched)

    def grads(self, plain, seed=None):
        cs, trainer = self.cs, self.trainer
        cs.sg2_restore(trainer, self.start)
        trainer.G.zero_grad(set_to_none=True)
        with (cs.plain_versions() if plain else contextlib.nullcontext()), \
                (cs.first_order_ulp(seed) if seed is not None else contextlib.nullcontext()):
            trainer._pl(self.gen, self.sched,
                        self.Draws(torch.Generator(device='cuda').manual_seed(6)), {})
        return {n: (torch.zeros_like(p) if p.grad is None else p.grad.detach().clone())
                for n, p in trainer.G.named_parameters()}


def rel_l2(a, b):
    return {n: float((a[n] - r).norm() / r.norm().clamp_min(1e-30)) for n, r in b.items()}


def accuracy_phase(chip_smoke, earlier):
    from tdgp_torch import profile_training
    from tdgp_torch.compare_kernels import ray_march_library
    from tdgp_torch.ops import ray_march
    for label, overrides in (('float32', profile_training.FP32), ('bf16', ())):
        check = PLCheck(chip_smoke, overrides)
        captured = []
        saved = ray_march.ray_march_reduced_bwd_bwd

        def capture(*args):
            captured.append([a.detach().clone() if torch.is_tensor(a) else a for a in args])
            return saved(*args)
        capture.launches = 0  # the wrapper counts on the module's name
        ray_march.ray_march_reduced_bwd_bwd = capture
        try:
            check.grads(False)
        finally:
            ray_march.ray_march_reduced_bwd_bwd = saved
        for i, args in enumerate(captured):
            ref = ray_march.ray_march_reduced_bwd_bwd_plain(
                *[a.double() if torch.is_tensor(a) else a for a in args])
            outs = {'this': ray_march.ray_march_reduced_bwd_bwd(*args)}
            for name, ns in earlier:
                with ray_march_library(ns):
                    outs[name] = ray_march.ray_march_reduced_bwd_bwd(*args)
            outs['plain32'] = ray_march.ray_march_reduced_bwd_bwd_plain(*args)

            def errors(x, r):
                x = x.double()
                xs, rs = (x.flatten(2).sum(-1), r.flatten(2).sum(-1)) if r.dim() > 2 else (x, r)
                return [f'{float((x - r).norm() / r.norm().clamp_min(1e-300)):.3g}',
                        f'{float((x - r).abs().max() / r.abs().max().clamp_min(1e-300)):.3g}',
                        f'{float((xs - rs).norm() / rs.norm().clamp_min(1e-300)):.3g}']
            table = {n: {k: errors(o[j], ref[j]) for k, o in outs.items()}
                     for j, n in enumerate(OUTPUTS)}
            d = args[1]
            print(f'second order on PL ({label}), call {i}: {list(args[0].shape)}, options '
                  f'{args[10:]}, densities {float(d.min()):.3g}..{float(d.max()):.3g}; per '
                  f'output [relative L2, max over max, relative L2 of the per-ray sums] against '
                  f'the plain version in float64: {json.dumps(table)}', flush=True)
        del check
        torch.cuda.empty_cache()


def check_phase(chip_smoke, earlier, reps, out):
    from tdgp_torch import profile_training
    from tdgp_torch.compare_kernels import ray_march_library
    check = PLCheck(chip_smoke, profile_training.FP32)
    variants = [('this', None)] + list(earlier)
    worst = {label: [] for label, _ in variants}
    camera = {label: {k: [] for k in ('rel', 'spread', 'floor', 'kspread')}
              for label, _ in variants}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for rep in range(reps):
            for label, ns in variants:
                t = time.perf_counter()
                with ray_march_library(ns) if ns is not None else contextlib.nullcontext():
                    ref = check.grads(True)
                    got = check.grads(False)
                    spread = rel_l2(check.grads(True), ref)
                    floor = dict(spread)
                    for seed in chip_smoke.FLOOR_SEEDS:
                        floor = {n: max(floor[n], v)
                                 for n, v in rel_l2(check.grads(True, seed), ref).items()}
                    rel = rel_l2(got, ref)
                    kspread = rel_l2(check.grads(False), got)
                limit = {n: max(chip_smoke.GRAD_LIMIT, 2 * floor[n]) for n in rel}
                order = sorted(rel, key=lambda n: -rel[n] / limit[n])
                worst[label].append(rel[order[0]] / limit[order[0]])
                for key, d in (('rel', rel), ('spread', spread), ('floor', floor),
                               ('kspread', kspread)):
                    camera[label][key] += [v for n, v in d.items() if 'camera_adaptor' in n]
                print(f'[{label}] rep {rep} ({time.perf_counter() - t:.1f} s): ' + json.dumps(
                    [dict(p=n, of_limit=round(rel[n] / limit[n], 4), rel=f'{rel[n]:.4g}',
                          limit=f'{limit[n]:.4g}', spread=f'{spread[n]:.4g}',
                          floor=f'{floor[n]:.4g}', kspread=f'{kspread[n]:.4g}')
                     for n in order[:5]]), flush=True)
                if out:
                    with open(out, 'a') as f:
                        f.write(json.dumps(dict(label=label, rep=rep, rel=rel, limit=limit,
                                                spread=spread, floor=floor,
                                                kspread=kspread)) + '\n')
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for label, w in worst.items():
        med = {k: float(np.median(v)) for k, v in camera[label].items()}
        print(f'[{label}] {reps} reps: {sum(x > 1 for x in w)} missed; worst of limit per rep '
              f'{[round(x, 3) for x in w]}; the camera adaptor\'s medians '
              f'{json.dumps({k: round(v, 5) for k, v in med.items()})}', flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--earlier', action='append', default=[], metavar='LABEL=DIR',
                    help='a checkout whose ray_march.cu runs in turns with this tree\'s')
    ap.add_argument('--out', help='a file for every rep\'s dictionaries, as JSON lines')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('pl_check_spread: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from tdgp_torch.ops import cuda_build
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f'card: {card}')
    cuda_build.build(list(cuda_build.sources()))
    from tdgp_torch.compare_kernels import build_earlier
    from tdgp_torch.ops import ray_march
    earlier = [(label, ray_march.bind(build_earlier(os.path.abspath(d), 'ray_march')))
               for label, d in (e.split('=', 1) for e in args.earlier)]
    accuracy_phase(chip_smoke, earlier)
    check_phase(chip_smoke, earlier, args.reps, args.out)
    return 0


if __name__ == '__main__':
    sys.exit(main())
