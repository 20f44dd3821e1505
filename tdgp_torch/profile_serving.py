"""Where the time of a served request goes, on the card.

    python3 -m tdgp_torch.profile_serving [--requests 3]

Loads the trained flagship generator as `chip_smoke.py` does (float32, final
march in kernel K3), serves a warm-up request of batch 4 at 256x256, then
  - times the stages of a request with CUDA events: mapping, tri-plane
    decoding, and rendering (everything after the planes: rays, both passes
    of plane sampling + MLP, importance sampling, the merge and the marches),
  - traces the requests with torch.profiler and prints the device time by
    operation, the device's busy share of the wall time and the peak memory,
    and the port's own kernels by name (K3 the final march, K4 the tri-plane
    MLP, K5 bias + activation): their device time, share and launches per
    request. They are launched through ctypes, so they show up only among
    the kernels, not among the operations.
The last line is a JSON object of these numbers, with the card's name and
power limit. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from tdgp_torch.rendering.camera import get_mean_camera_params
from tdgp_torch.serving import load_generator, make_serving_fn
from tdgp_torch.utils.misc import exact_fp32
from tdgp_torch.utils.tensor_group import TensorGroup

RUN_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       'experiments', 'synth256-3dgp-p64-b16-8839f23-r5-flagship')
OVERRIDES = ['generator.ray_march_impl=fused', 'generator.fp32_only=true']
BATCH = 4
PSI = 0.7
# the port's kernels on the served path: name -> a part of the CUDA kernels' names
OWN_KERNELS = {'K3 ray_march_reduced': 'ray_march_reduced_kernel',
               'K4 triplane_mlp': 'triplane_mlp_kernel',
               'K5 bias_act': 'bias_act_'}


def request(seed: int, cfg, device, batch: int = BATCH):
    """A request of `batch`: z from numpy with `seed`, one-hot c, and the mean
    camera at yaws spread over +-0.4 rad."""
    rng = np.random.RandomState(seed)
    z = torch.from_numpy(rng.randn(batch, cfg.z_dim).astype(np.float32)).to(device)
    c = torch.eye(cfg.c_dim, device=device)[(torch.arange(batch) + seed) % cfg.c_dim]
    cam = get_mean_camera_params(cfg.camera, device=device)
    angles = cam.angles.repeat(batch, 1)
    angles[:, 0] += torch.linspace(-0.4, 0.4, batch, device=device)
    return (z, c, angles, cam.fov.repeat(batch), cam.radius.repeat(batch),
            cam.look_at.repeat(batch, 1))


def _self_device_us(event) -> float:
    return float(getattr(event, 'self_device_time_total',
                         getattr(event, 'self_cuda_time_total', 0.0)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--requests', type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('profile_serving: no CUDA device')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f'card: {card}')

    G = load_generator(RUN_DIR, 'cuda', OVERRIDES)
    serve = make_serving_fn(G, truncation_psi=PSI)
    req = request(0, G.cfg, 'cuda')
    z, c, angles, fov, radius, look_at = req
    serve(*req)
    torch.cuda.synchronize()

    # stages, with CUDA events around each
    cam = TensorGroup(angles=angles, fov=fov, radius=radius, look_at=look_at)
    stage_ms = {'mapping': [], 'decode_planes': [], 'render': []}
    with torch.no_grad(), exact_fp32():
        for _ in range(args.requests):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            ws = G.map_ws(z, c, camera_angles=angles, truncation_psi=PSI)
            ev[1].record()
            G.synthesis.decode_planes(ws)
            ev[2].record()
            G.synthesis(ws, cam, ray_chunk=G.cfg.max_batch_res ** 2)  # decodes again, renders
            ev[3].record()
            torch.cuda.synchronize()
            stage_ms['mapping'].append(ev[0].elapsed_time(ev[1]))
            stage_ms['decode_planes'].append(ev[1].elapsed_time(ev[2]))
            stage_ms['render'].append(ev[2].elapsed_time(ev[3]) - ev[1].elapsed_time(ev[2]))
    stages = {k: float(np.median(v)) for k, v in stage_ms.items()}
    print('stage medians (ms): ' + ', '.join(f'{k} {v:.2f}' for k, v in stages.items()))

    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.requests):
            serve(*req)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / args.requests
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    averages = prof.key_averages()
    # device-side entries (kernels, copies) hold the device time once; host
    # operations hold the same time again as the kernels they launched
    kernels = sorted((e for e in averages if e.device_type == DeviceType.CUDA),
                     key=_self_device_us, reverse=True)
    ops = sorted((e for e in averages
                  if e.device_type == DeviceType.CPU and _self_device_us(e) > 0),
                 key=_self_device_us, reverse=True)
    device_ms = sum(_self_device_us(e) for e in kernels) / 1e3 / args.requests
    print(f'per request: wall {wall_ms:.2f} ms under the profiler, device busy {device_ms:.2f} ms '
          f'({100 * device_ms / wall_ms:.1f} %), peak memory {peak_gib:.2f} GiB')

    def table(title, entries, n):
        rows = []
        print(title)
        for e in entries[:n]:
            ms = _self_device_us(e) / 1e3 / args.requests
            rows.append({'name': e.key[:100], 'ms_per_request': ms,
                         'calls_per_request': e.count / args.requests, 'share': ms / device_ms})
            print(f'{ms:9.3f} ms {100 * ms / device_ms:5.1f} %  '
                  f'x{e.count / args.requests:<6g} {e.key[:100]}')
        return rows

    top_ops = table('device time by operation:', ops, 20)
    top_kernels = table('device time by kernel:', kernels, 12)
    own = {}
    print("the port's kernels:")
    for name, part in OWN_KERNELS.items():
        found = [e for e in kernels if part in e.key]
        ms = sum(_self_device_us(e) for e in found) / 1e3 / args.requests
        calls = sum(e.count for e in found) / args.requests
        own[name] = {'ms_per_request': ms, 'calls_per_request': calls, 'share': ms / device_ms}
        print(f'{ms:9.3f} ms {100 * ms / device_ms:5.1f} %  x{calls:<6g} {name}')
    print(json.dumps({'card': card, 'batch': BATCH, 'resolution': G.cfg.img_resolution,
                      'stages_ms': stages, 'wall_ms_profiled': wall_ms,
                      'device_busy_ms': device_ms, 'device_busy_share': device_ms / wall_ms,
                      'peak_memory_gib': peak_gib, 'top_ops': top_ops,
                      'top_kernels': top_kernels, 'own_kernels': own}))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
