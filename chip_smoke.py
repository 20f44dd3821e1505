#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tdgp_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from `tdgp_torch/csrc/`, then:
  1. kernel:      K3 (ray_march_reduced) against its plain PyTorch version at
                  the serving shape (65,536 rays x 64 samples x 3 channels),
                  max abs diff <= 1e-5 on every output; kernel, plain and
                  bound times.
  2. serve:       the trained 256^2 flagship generator (tri-planes 3x512^2x32)
                  serves 3 requests of batch 4 after one warm-up; images
                  [4,256,256,3], finite, in [0,1]; K3 launched once per ray
                  chunk (4 per request) during the 3 requests.
  3. cross-check: one request through the plain marcher on the card (<= 1e-4),
                  and the port on the CPU at a 64x64 output against the card
                  (<= 1e-3: the convolutions sum in another order).
Prints the card's name and power limit, each phase's seconds, a JSON line
of per-kernel numbers, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, with no result, when a phase fails or there is no card.
"""
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores


@contextlib.contextmanager
def phase(name, seconds):
    print(f'== {name}', flush=True)
    t0 = time.perf_counter()
    try:
        yield
    except BaseException:
        print(f'== {name} FAILED after {time.perf_counter() - t0:.1f} s', flush=True)
        raise
    seconds[name] = time.perf_counter() - t0
    print(f'== {name}: {seconds[name]:.1f} s', flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, iters, repeats=5, warmup_s=0.5):
    """Median over `repeats` of the mean time of `iters` back-to-back calls,
    after `warmup_s` seconds of calls to bring the card to its clocks."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < warmup_s:
        fn()
        torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def kernel_phase(ray_march):
    """K3 against its plain version at the serving shape: one ray chunk of
    every image of a batch-4 request."""
    g = torch.Generator(device='cuda').manual_seed(0)
    b, r, s, c = 4, 16384, 64, 3
    colors = torch.randn(b, r, s, c, device='cuda', generator=g)
    densities = torch.randn(b, r, s, device='cuda', generator=g) * 2
    depths = torch.rand(b, r, s, device='cuda', generator=g).sort(-1).values * 0.5 + 0.75
    worst = 0.0
    for clamp_mode, inf_depth, last_back in [('softplus', True, False),
                                             ('softplus', False, False),
                                             ('softplus', False, True),
                                             ('relu', True, False)]:
        args = (colors, densities, depths, clamp_mode, 1.0, inf_depth, last_back)
        out = ray_march.ray_march_reduced(*args)
        ref = ray_march.ray_march_reduced_plain(*args)
        torch.cuda.synchronize()
        errs = [float((a - b_).abs().max()) for a, b_ in zip(out, ref)]
        print(f'K3 {clamp_mode} inf_depth={inf_depth} last_back={last_back}: '
              f'max abs diff rgb/depth/wsum/ftrans = {errs}')
        check(all(e <= 1e-5 for e in errs), 'K3 disagrees with its plain version')
        worst = max(worst, *errs)
    args = (colors, densities, depths, 'softplus', 1.0, True, False)
    ms = cuda_ms(lambda: ray_march.ray_march_reduced(*args), 500)
    plain_ms = cuda_ms(lambda: ray_march.ray_march_reduced_plain(*args), 50)
    n = b * r
    bytes_moved = 4 * (n * s * (c + 2) + n * (c + 3))  # inputs read once, outputs written once
    flops = n * s * (2 * c + 14)  # clamp, delta, alpha, transmittance, weighted sums
    bound_ms = 1e3 * max(bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS)
    bound_by = 'bytes' if bytes_moved / HBM_BYTES_PER_S >= flops / FP32_FLOPS else 'operations'
    print(f'K3 at [{b},{r},{s},{c}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, '
          f'bound {1e3 * bound_ms:.1f} us ({bytes_moved / 1e6:.1f} MB by {bound_by}), '
          f'{bytes_moved / (ms * 1e-3) / 1e12:.2f} TB/s')
    clocks = subprocess.run(['nvidia-smi', '--query-gpu=clocks.sm,clocks.mem,power.draw,'
                             'temperature.gpu', '--format=csv,noheader'],
                            capture_output=True, text=True, check=True)
    print(f'clocks after timing (sm, mem, power, temperature): {clocks.stdout.strip()}')
    return dict(name='ray_march_reduced', route='cuda', source='tdgp_torch/csrc/ray_march.cu',
                replaces='tdgp/ops/pallas_kernels.py:86', max_abs_err=worst, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from tdgp_torch.ops import cuda_build, ray_march
    from tdgp_torch.profile_serving import BATCH, OVERRIDES, PSI, RUN_DIR, request
    from tdgp_torch.serving import load_generator, make_serving_fn

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True, check=True)
    print(f'card: {smi.stdout.strip()}')
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}')

    seconds = {}
    with phase('build', seconds):
        for name, path in cuda_build.build(list(cuda_build.sources())).items():
            print(f'built {name}: {os.path.relpath(path, ROOT)}')

    with phase('kernel', seconds):
        k3 = kernel_phase(ray_march)

    with phase('serve', seconds):
        G = load_generator(RUN_DIR, 'cuda', OVERRIDES)
        gc = G.cfg
        serve = make_serving_fn(G, truncation_psi=PSI)
        requests = [request(seed, gc, 'cuda') for seed in range(3)]
        serve(*requests[0])  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ray_march.ray_march_reduced.launches = 0
        images, times = [], []
        for req in requests:
            t0 = time.perf_counter()
            images.append(serve(*req))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = ray_march.ray_march_reduced.launches
        peak = torch.cuda.max_memory_allocated()
        res = gc.img_resolution
        chunks = (res * res) // (gc.max_batch_res ** 2)
        for img in images:
            check(tuple(img.shape) == (BATCH, res, res, 3), f'image shape {tuple(img.shape)}')
            check(bool(torch.isfinite(img).all()), 'non-finite pixels')
            check(float(img.min()) >= 0.0 and float(img.max()) <= 1.0, 'pixels outside [0, 1]')
        print(f'images {tuple(images[0].shape)}, mean {float(images[0].mean()):.4f}, '
              f'std {float(images[0].std()):.4f}')
        print(f'K3 launches over {len(requests)} requests: {launches} '
              f'(expected {chunks} chunks x {len(requests)})')
        check(launches == chunks * len(requests), 'K3 launch count')
        ms = [1e3 * t for t in times]
        print(f'serving batch {BATCH} at {res}x{res}: ms per request {["%.1f" % t for t in ms]}, '
              f'median {np.median(ms):.1f} ms, {BATCH / np.median(times):.2f} images/s, '
              f'peak memory {peak / 2**30:.2f} GiB')
        k3['launches'] = launches

    with phase('cross-check', seconds):
        G_plain = load_generator(RUN_DIR, 'cuda', OVERRIDES[1:] + ['generator.ray_march_impl=jnp'])
        plain_img = make_serving_fn(G_plain, truncation_psi=PSI)(*requests[0])
        diff = float((plain_img - images[0]).abs().max())
        print(f'card, K3 vs plain marcher: max abs image diff {diff:.3g}')
        check(diff <= 1e-4, 'K3 image disagrees with the plain marcher')
        del G_plain, plain_img
        card64 = make_serving_fn(G, truncation_psi=PSI, resolution=64)(*requests[0])
        G_cpu = load_generator(RUN_DIR, 'cpu', OVERRIDES)
        cpu64 = make_serving_fn(G_cpu, truncation_psi=PSI, resolution=64)(
            *[t.cpu() for t in requests[0]])
        diff = float((card64.cpu() - cpu64).abs().max())
        print(f'card vs CPU at 64x64: max abs image diff {diff:.3g}')
        check(diff <= 1e-3, 'card disagrees with the CPU')

    print(f'phases (s): {json.dumps({k: round(v, 1) for k, v in seconds.items()})}, '
          f'total {time.perf_counter() - t_start:.1f} s')
    print(json.dumps({'kernels': [k3]}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
