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
  3. cross-check: one request through the plain marcher on the card (<= 1e-4;
                  `plain_versions` swaps the kernels' wrappers for their
                  plain versions, which no config can select on the card),
                  and the port on the CPU at a 64x64 output against the card
                  (<= 1e-3: the convolutions sum in another order).
  4. train kernels: K3's backward at 16 x 4096 rays x 64 samples x 3 channels
                  and K1 (triplane_splat) at the training shape (batch 16,
                  64^2 x 32 points per pass, planes 48 x 512^2 x 32) against
                  their plain versions, max abs diff <= 1e-5 x max |plain| on
                  every output (float32 sums in another order, and K1's
                  bins in an order that changes from run to run; K1 also at
                  small shapes: F = 8, 16, partial strips, a ray's samples
                  on one texel); kernel,
                  plain, library and bound times. K1's bins on the card are
                  held to the torch arithmetic `_bins` (the same entries in
                  every strip). K1's bound counts the plane texels that the
                  points' corners touch, not the whole planes.
  5. train check: one step's Gmain gradient at full width, batch 4, through
                  the kernels and through their plain versions on the card;
                  relative L2 difference <= 1e-3 for every parameter, also
                  with K1 alone through its kernel (K3 alone is printed). The
                  depth adaptor's parameters alone (DEPTH_ADAPTOR), whose
                  gradients the step itself does not fix to 1e-3, may instead
                  reach 2x their float32 floor, capped at RAISED_LIMIT_CAP:
                  the floor is the difference the plain path shows when the
                  rendered patch is changed by one float32 ulp
                  (x (1 + 2^-24 n), n ~ N(0, 1)), measured in the same run.
                  cuDNN runs its deterministic algorithms here, and the
                  StyleGAN2 noise is off: the gradient of a noise strength is
                  a sum of ~1e8 terms of random sign, which any other float32
                  order moves by ~1e-3.
  6. inference kernels: K4 (triplane_mlp) at the served shape, [4, 524288, 32]
                  -> 64 -> 4 (bound: the card's, with the products as
                  3xTF32 on the tensor cores; the float32 CUDA cores' bound
                  beside it), and K5 (bias_act) at [4, 512, 512, 64] (lrelu,
                  clamp 256; also as the NHWC view of an NCHW tensor) and at a
                  small shape for each of the nine activations, against their
                  plain versions: K4 <= 1e-5 x max |plain| (sums over 32 and 64
                  terms in another order), K5 <= 1e-6 x max |plain|
                  (elementwise; expf/tanhf ulps). Kernel, plain and bound
                  times; K4 also beside the two FullyConnected layers it
                  replaces (plain bias_act), a yardstick that the port no
                  longer calls. No single PyTorch call computes either.
  7. inference:   the trained flagship through `tdgp_torch.inference` and
                  `tdgp_torch.geometry` (loaded by the entry points'
                  `load_run`): a grid of seeds 0-15 at batch 4 with truncation
                  0.7 (per-class averages), a front_circle trajectory of 2 seeds
                  x 16 frames, and the 128^3 density grid of seed 0 (64 chunks
                  of 32^3) marched into a mesh by the C++ marching; images in
                  [0, 1], a non-empty mesh; ms per batch, images/s, peak memory;
                  K4 launched 2 passes x 4 chunks per batch and once per density
                  chunk, K3 4 times per batch, K5 once per bias_act call on a
                  CUDA tensor. Then one grid batch and the density grid again
                  with the plain versions of K4 and K5: image <= 1e-4 max abs,
                  sigma <= 1e-5 x max |sigma|. Then the two entry points
                  (`python3 -m tdgp_torch.scripts.inference`, image_grid and
                  video_grid, and `... .extract_geometry`), each run once on a
                  small workload into a temporary directory.
  8. train:       the satellite 256^2 G+D step (`tdgp_torch.profile_training`:
                  float32, random weights from a seed, batch 16 of a
                  synthetic batch): one warm-up step, whose two K1 calls (the
                  Gmain render's coarse and fine pass) are kept and K1 held
                  on them as in 4, timed beside its bound, with the most
                  (plane, point) corners on one texel; then plain steps and one
                  R1 step; losses finite, every parameter of G and D moved,
                  the EMA moved, K1 / K3 / K3-backward launched as often as
                  the step implies; ms per step, images/s at the 15:1
                  plain:R1 cadence, peak memory; K4 and K5 launches printed as
                  they fall (the forwards the step runs without gradients).
Serving (2) also counts K4 (8 per request) and K5 launches per request.
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
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
TF32_FLOPS = 495e12         # H100 SXM dense TF32 on the tensor cores, NVIDIA data sheet
TRAIN_PLAIN_STEPS = 5       # timed plain steps of the training phase
GRAD_LIMIT = 1e-3           # Gmain gradient, kernels vs plain: relative L2 per parameter
DEPTH_ADAPTOR = 'synthesis.depth_adaptor.'  # the only parameters that may exceed it ...
RAISED_LIMIT_CAP = 4e-3     # ... up to 2x their one-ulp floor, and never above this


@contextlib.contextmanager
def plain_versions(k1=True, k3=True, k4=False, k5=False):
    """The generator with the plain PyTorch versions of K1 (backward), K3
    (forward and backward), K4 and K5 in place of the kernels' wrappers, on
    the card: the reference the kernels' path is held against."""
    from tdgp_torch.models import epigraf, layers, stylegan2
    from tdgp_torch.ops import bias_act, ray_march, splat, triplane_mlp
    from tdgp_torch.rendering import renderer
    saved = (epigraf.triplane_sample, renderer.ray_march_reduced, epigraf.triplane_mlp,
             layers.bias_act, stylegan2.bias_act)
    if k1:
        epigraf.triplane_sample = splat.triplane_sample_reference
    if k3:
        renderer.ray_march_reduced = ray_march.ray_march_reduced_reference
    if k4:
        epigraf.triplane_mlp = triplane_mlp.triplane_mlp_plain
    if k5:
        layers.bias_act = stylegan2.bias_act = bias_act.bias_act_plain
    try:
        yield
    finally:
        (epigraf.triplane_sample, renderer.ray_march_reduced, epigraf.triplane_mlp,
         layers.bias_act, stylegan2.bias_act) = saved


class BiasActCalls:
    """Counts the calls of `bias_act` on CUDA tensors made by the models
    (`models/layers.py`, `models/stylegan2.py`) while it is entered: the
    number of K5 launches a path without gradients should show; and, of
    those, the calls on tensors that are not contiguous (K5 takes them as
    strided views)."""

    def __enter__(self):
        from tdgp_torch.models import layers, stylegan2
        self.count = self.strided = 0
        self._saved = layers.bias_act, stylegan2.bias_act
        inner = layers.bias_act

        def counted(x, *args, **kwargs):
            self.count += x.is_cuda
            self.strided += x.is_cuda and not x.is_contiguous()
            return inner(x, *args, **kwargs)

        layers.bias_act = stylegan2.bias_act = counted
        return self

    def __exit__(self, *exc):
        from tdgp_torch.models import layers, stylegan2
        layers.bias_act, stylegan2.bias_act = self._saved


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
    bytes_moved, flops = k3_work(b, r, s, c)
    bound_ms, bound_by = bound(bytes_moved, flops)
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


def k3_work(b, r, s, c):
    """(bytes, flops) of K3's forward over [b, r, s, c]: inputs read once,
    outputs written once; clamp, delta, alpha, transmittance, weighted sums."""
    n = b * r
    return 4 * (n * s * (c + 2) + n * (c + 3)), n * s * (2 * c + 14)


def bound(bytes_moved, flops, flops_per_s=FP32_FLOPS):
    """(least ms, 'bytes' or 'operations') on the card for the given work,
    its operations at `flops_per_s`."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / flops_per_s
    return 1e3 * max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else 'operations')


def corner_counts(splat, coords, scale, n3, h, w):
    """How many (plane, point) corners land on each texel [N*3*H*W]: its
    nonzeros are the texels the splat must read of the planes for the
    coordinate gradient, its maximum the contention on one texel."""
    y0, x0, _, _, masks = splat._corners(coords, scale, h, w)
    idx = torch.cat([i[m > 0] for i, m in zip(splat._corner_index(y0, x0, h, w), masks)])
    return torch.bincount(idx, minlength=n3 * h * w)


def k1_work(splat, planes, coords, scale, coords_grad=True):
    """(bytes, flops, touched texels, most corners on one texel) of K1 on
    these inputs: the touched texels of the planes (for the coordinate
    gradient), all of g_planes; the cotangent, coords and g_coords."""
    n3, h, w, f = planes.shape
    n, p = coords.shape[0], coords.shape[1]
    counts = corner_counts(splat, coords, scale, n3, h, w)
    texels = int((counts > 0).sum())
    bytes_moved = 4 * ((texels * f if coords_grad else 0) + n3 * h * w * f
                       + n * p * (f + (6 if coords_grad else 3)))
    flops = n * p * 3 * f * (20 if coords_grad else 8)  # 4 weighted adds, the coordinate gradient
    return bytes_moved, flops, texels, int(counts.max())


def bin_summary(splat, coords, h, w, scale):
    """K1's bins for these points, in words: (plane, point) entries inside a
    plane, entries after the copies at strip edges, the fullest strip."""
    n3, p = 3 * coords.shape[0], coords.shape[1]
    gxy = splat._plane_coords(coords, scale, h, w)
    inside = int(((gxy[..., 0] >= -1) & (gxy[..., 0] < w) & (gxy[..., 1] >= -1)
                  & (gxy[..., 1] < h)).sum())
    _, offsets = splat.triplane_splat_bins(coords, h, w, scale)
    sizes = offsets[1:] - offsets[:-1]
    return (f'{inside} of {n3 * p} entries in their plane, {int(offsets[-1])} after the copies, '
            f'at most {int(sizes.max())} in a strip, {int((sizes > 0).sum())} of {len(sizes)} '
            f'strips not empty')


def same_bins(splat, coords, scale, h, w):
    """Whether the card's bins (`triplane_splat_bins`) hold the entries that
    the torch arithmetic (`_bins`) puts in each strip."""
    entries, offsets = splat.triplane_splat_bins(coords, h, w, scale)
    ref_entries, ref_offsets = splat._bins(splat._plane_coords(coords, scale, h, w), h, w)
    if not torch.equal(offsets, ref_offsets):
        return False
    n_entries = 3 * coords.shape[0] * coords.shape[1]

    def keyed(ent, off):  # (bin, entry) pairs, sorted
        rec = torch.arange(int(off[-1]), device=off.device, dtype=torch.int32)
        b = torch.searchsorted(off, rec, right=True).long() - 1
        return torch.sort(b * n_entries + ent[:len(rec)].long()).values

    return torch.equal(keyed(entries, offsets), keyed(ref_entries, ref_offsets))


def train_kernel_phase(ray_march, splat):
    """K3's backward and K1 against their plain versions at the training shapes."""
    g = torch.Generator(device='cuda').manual_seed(0)
    b, r, s, c = 16, 4096, 64, 3  # one Gmain render: batch 16, 64^2 rays, 32 + 32 samples
    colors = torch.randn(b, r, s, c, device='cuda', generator=g)
    densities = torch.randn(b, r, s, device='cuda', generator=g) * 2
    depths = torch.rand(b, r, s, device='cuda', generator=g).sort(-1).values * 0.5 + 0.75
    cots = [torch.randn(b, r, c, device='cuda', generator=g)] + [
        torch.randn(b, r, device='cuda', generator=g) for _ in range(3)]
    worst = 0.0
    for clamp_mode, inf_depth, last_back in [('softplus', True, False),
                                             ('softplus', False, True),
                                             ('relu', True, False),
                                             ('relu', False, True)]:
        args = (colors, densities, depths, *cots, clamp_mode, 1.0, inf_depth, last_back)
        out = ray_march.ray_march_reduced_bwd(*args)
        ref = ray_march.ray_march_reduced_bwd_plain(*args)
        torch.cuda.synchronize()
        rel = [float((a - b_).abs().max()) / float(b_.abs().max()) for a, b_ in zip(out, ref)]
        print(f'K3 backward {clamp_mode} inf_depth={inf_depth} last_back={last_back}: '
              f'max abs diff / max |plain| of g_colors/g_densities/g_depths = {rel}')
        check(all(e <= 1e-5 for e in rel), 'K3 backward disagrees with its plain version')
        worst = max(worst, *[float((a - b_).abs().max()) for a, b_ in zip(out, ref)])
    args = (colors, densities, depths, *cots)
    ms = cuda_ms(lambda: ray_march.ray_march_reduced_bwd(*args), 200)
    plain_ms = cuda_ms(lambda: ray_march.ray_march_reduced_bwd_plain(*args), 20)
    n = b * r
    bytes_moved = 4 * (2 * n * s * (c + 2) + n * (c + 3))  # inputs + cotangents, gradients
    flops = n * s * (4 * c + 40)  # recompute (twice), scans, the three gradients
    bound_ms, bound_by = bound(bytes_moved, flops)
    print(f'K3 backward at [{b},{r},{s},{c}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, '
          f'bound {1e3 * bound_ms:.1f} us ({bytes_moved / 1e6:.1f} MB by {bound_by})')
    fwd_bytes, fwd_flops = k3_work(b, r, s, c)
    fwd_bound_ms, fwd_bound_by = bound(fwd_bytes, fwd_flops)
    print(f'K3 forward at the training shape [{b},{r},{s},{c}]: bound {1e3 * fwd_bound_ms:.1f} us '
          f'({fwd_bytes / 1e6:.1f} MB by {fwd_bound_by})')
    k3_bwd = dict(name='ray_march_reduced_bwd', route='cuda', source='tdgp_torch/csrc/ray_march.cu',
                  replaces='tdgp/ops/pallas_kernels.py:251', max_abs_err=worst, ms=ms,
                  plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)

    # K1 at small shapes: the other instantiated widths, planes whose sides are
    # not multiples of the strip's, the 32 samples of a ray on one texel (their
    # own generator: the training shape's inputs below stay as they were)
    g_small = torch.Generator(device='cuda').manual_seed(1)
    for n, h, w, f, p, clustered in [(2, 40, 50, 8, 300, False), (3, 33, 17, 16, 777, False),
                                     (2, 64, 64, 16, 4096, True), (2, 37, 21, 32, 1000, False)]:
        planes = torch.randn(3 * n, h, w, f, device='cuda', generator=g_small)
        coords = torch.rand(n, p, 3, device='cuda', generator=g_small) * 1.1 - 0.55
        if clustered:
            coords = (coords.view(n, p // 32, 32, 3)[:, :, :1] * 0.8 + 2e-3 * torch.rand(
                n, p // 32, 32, 3, device='cuda', generator=g_small)).reshape(n, p, 3)
        cot = torch.randn(n, p, f, device='cuda', generator=g_small)
        check(same_bins(splat, coords, 0.5, h, w), f"K1's bins at F={f}, {h}x{w} differ")
        for coords_grad in (True, False):
            out = splat.triplane_splat(planes, coords, cot, 0.5, coords_grad)
            ref = splat.triplane_sample_bwd_plain(planes, coords, cot, 0.5, coords_grad)
            rel = [float((a - b_).abs().max() / b_.abs().max())
                   for a, b_ in zip(out, ref) if b_ is not None]
            check(all(e <= 1e-5 for e in rel),
                  f'K1 at F={f}, planes {h}x{w} disagrees with its plain version: {rel}')
    print('K1 at F = 8, 16, 32, planes 40x50, 33x17, 64x64 (rays on one texel), 37x21, with '
          'and without the coordinate gradient: as its plain version (<= 1e-5 x max |plain|)')

    n, h, w, f, scale = 16, 512, 512, 32, 0.5
    p = 64 * 64 * 32  # points of one render pass per image
    planes = torch.randn(3 * n, h, w, f, device='cuda', generator=g)
    coords = torch.rand(n, p, 3, device='cuda', generator=g) * 1.1 - 0.55  # some outside
    coords[:, :64, 0] = scale        # on the last texel column of the x/y and x/z planes
    coords[:, 64:128, 1] = -scale    # on the first row
    cot = torch.randn(n, p, f, device='cuda', generator=g)
    check(same_bins(splat, coords, scale, h, w), "K1's bins on the card differ from _bins")
    out = splat.triplane_splat(planes, coords, cot, scale)
    ref = splat.triplane_sample_bwd_plain(planes, coords, cot, scale)
    torch.cuda.synchronize()
    errs = [float((a - b_).abs().max()) for a, b_ in zip(out, ref)]
    rel = [e / float(b_.abs().max()) for e, b_ in zip(errs, ref)]
    print(f'K1 at planes [{3 * n},{h},{w},{f}], {n} x {p} points: bins as _bins; max abs diff / '
          f'max |plain| of g_planes/g_coords = {rel}')
    check(all(e <= 1e-5 for e in rel), 'K1 disagrees with its plain version')
    del out, ref
    ms = cuda_ms(lambda: splat.triplane_splat(planes, coords, cot, scale), 20)
    bins_ms = cuda_ms(lambda: splat.triplane_splat_bins(coords, h, w, scale), 20)
    plain_ms = cuda_ms(lambda: splat.triplane_sample_bwd_plain(planes, coords, cot, scale), 3)
    # the one PyTorch call that computes the same adjoint: grid_sample's backward
    grid = torch.stack([coords[..., list(pr)] / scale for pr in ((0, 1), (0, 2), (1, 2))],
                       dim=1).reshape(3 * n, 1, p, 2)
    g_out = (cot / 3.0)[:, None].expand(n, 3, p, f).reshape(3 * n, p, f)
    g_out = g_out.permute(0, 2, 1)[:, :, None]  # [3N, F, 1, P]
    library_ms = cuda_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
        g_out, planes.permute(0, 3, 1, 2), grid, 0, 0, True, [True, True]), 10)
    bytes_moved, flops, texels, most = k1_work(splat, planes, coords, scale)
    bound_ms, bound_by = bound(bytes_moved, flops)
    print(f'K1: kernel {ms:.4f} ms (its bins {bins_ms:.4f} ms; '
          f'{bin_summary(splat, coords, h, w, scale)}), plain {plain_ms:.4f} ms, '
          f'grid_sampler_2d_backward {library_ms:.4f} ms, bound {bound_ms:.4f} ms '
          f'({bytes_moved / 1e9:.2f} GB by {bound_by}; {texels} of {3 * n * h * w} texels '
          f'touched, at most {most} corners on one), {bytes_moved / (ms * 1e-3) / 1e12:.2f} TB/s')
    k1 = dict(name='triplane_splat', route='cuda', source='tdgp_torch/csrc/splat.cu',
              replaces='tdgp/ops/splat.py:258', max_abs_err=max(errs), ms=ms,
              plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
              bins_ms=bins_ms)
    return k3_bwd, k1


def train_check_phase(Trainer, Draws, sched, train_config, make_batch, device='cuda'):
    """One step's Gmain gradient through the kernels and through the plain
    versions, at full width and batch 4, held to GRAD_LIMIT (the depth
    adaptor: see the module's docstring)."""
    from tdgp_torch.training import losses
    g_forward = losses.g_forward

    def one_ulp(*args, **kwargs):  # the rendered patch, changed by about one ulp
        out, pp = g_forward(*args, **kwargs)
        g = torch.Generator(device=device).manual_seed(9)
        img = out.img * (1 + 2.0 ** -24 * torch.randn(out.img.shape, device=device, generator=g))
        return type(out)(img=img, depth=out.depth), pp

    def gmain_grads(k1_plain, k3_plain, perturb=False):
        cfg = train_config(['generator.use_noise=false'])
        trainer = Trainer(cfg, device, seed=0)
        losses.g_forward = one_ulp if perturb else g_forward
        try:
            with plain_versions(k1_plain, k3_plain):
                stats = trainer.step(make_batch(cfg, 4, 2, device), sched, False,
                                     Draws(torch.Generator(device=device).manual_seed(3)),
                                     return_grads=True)
        finally:
            losses.g_forward = g_forward
        return stats['_grads']['g']

    def rel_l2(a, b):
        return {n: float((a[n] - r).norm() / r.norm().clamp_min(1e-30)) for n, r in b.items()}

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref = gmain_grads(True, True)
        rel = rel_l2(gmain_grads(False, False), ref)
        floor = rel_l2(gmain_grads(True, True, perturb=True), ref)
        k1_alone = rel_l2(gmain_grads(False, True), ref)
        k3_alone = rel_l2(gmain_grads(True, False), ref)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for what, r in (('K1 alone', k1_alone), ('K3 alone', k3_alone)):
        worst = max(r, key=r.get)
        print(f'Gmain gradient, {what} vs plain: median relative L2 difference '
              f'{float(np.median(list(r.values()))):.3g}, max {r[worst]:.3g} ({worst})')
    check(max(k1_alone.values()) <= GRAD_LIMIT,
          'the Gmain gradient through K1 alone disagrees with the plain path')
    limit = {n: min(RAISED_LIMIT_CAP, max(GRAD_LIMIT, 2 * floor[n]))
             if n.startswith(DEPTH_ADAPTOR) else GRAD_LIMIT for n in rel}
    name = max(rel, key=lambda n: rel[n] / limit[n])
    over = {n: f'{rel[n]:.3g} (limit {limit[n]:.3g}, floor {floor[n]:.3g})'
            for n in sorted(rel) if rel[n] > GRAD_LIMIT}
    print(f'Gmain gradient, kernels vs plain versions: {len(rel)} parameters, median relative '
          f'L2 difference {float(np.median(list(rel.values()))):.3g}, worst against its limit '
          f'{rel[name]:.3g} ({name}; limit {limit[name]:.3g}); one-ulp floor of the step: median '
          f'{float(np.median(list(floor.values()))):.3g}, max {max(floor.values()):.3g} '
          f'({max(floor, key=floor.get)}); above {GRAD_LIMIT:g}: {over}')
    check(all(rel[n] <= limit[n] for n in rel),
          'the Gmain gradient through the kernels disagrees with the plain path')


def inference_kernel_phase(bias_act, triplane_mlp, FullyConnected, init_weights):
    """K4 and K5 against their plain versions at the shapes of the served path."""
    g = torch.Generator(device='cuda').manual_seed(0)
    n, p, f, hid, out = 4, 16384 * 32, 32, 64, 4  # one render pass of one ray chunk
    cpu_gen = torch.Generator().manual_seed(0)
    fc0, fc1 = FullyConnected(f, hid, activation='lrelu'), FullyConnected(hid, out)
    for fc in (fc0, fc1):
        init_weights(fc, cpu_gen)
        with torch.no_grad():
            fc.bias.copy_(torch.randn(fc.bias.shape, generator=cpu_gen) * 0.1)
    fc0, fc1 = fc0.cuda(), fc1.cuda()
    feats = torch.randn(n, p, f, device='cuda', generator=g)
    with torch.no_grad():
        weights = (*triplane_mlp.fold_fully_connected(fc0),
                   *triplane_mlp.fold_fully_connected(fc1))
        got = triplane_mlp.triplane_mlp(feats, *weights)
        ref = triplane_mlp.triplane_mlp_plain(feats, *weights)
        torch.cuda.synchronize()
        errs = [float((a - b).abs().max()) for a, b in zip(got, ref)]
        rel = [e / float(b.abs().max()) for e, b in zip(errs, ref)]
        print(f'K4 at [{n},{p},{f}] -> {hid} -> {out}: max abs diff / max |plain| of rgb/sigma '
              f'= {rel}')
        check(all(e <= 1e-5 for e in rel), 'K4 disagrees with its plain version')
        ms = cuda_ms(lambda: triplane_mlp.triplane_mlp(feats, *weights), 50)
        plain_ms = cuda_ms(lambda: triplane_mlp.triplane_mlp_plain(feats, *weights), 10)
        k5_before = bias_act.bias_act.launches
        with plain_versions(k1=False, k3=False, k5=True):  # the path before K4 and K5
            layers_ms = cuda_ms(lambda: fc1(fc0(feats)), 10)
        check(bias_act.bias_act.launches == k5_before, 'the yardstick launched K5')
    t = n * p
    bytes_moved = 4 * (t * (f + out) + f * hid + hid + hid * out + out)
    flops = t * (2 * f * hid + 2 * hid * out)
    # the card's least time: the products as 3xTF32 on the tensor cores (three
    # TF32 products each); the bound of the float32 CUDA cores beside it
    bound_ms, bound_by = bound(bytes_moved, 3 * flops, TF32_FLOPS)
    cuda_core_bound_ms, _ = bound(bytes_moved, flops)
    print(f'K4: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, two FullyConnected layers '
          f'{layers_ms:.4f} ms, bound {bound_ms:.4f} ms (by {bound_by}: {bytes_moved / 1e6:.1f} '
          f'MB; '
          f'3 x {flops / 1e9:.2f} GFLOP at TF32), CUDA-core bound {cuda_core_bound_ms:.4f} ms, '
          f'{bytes_moved / (ms * 1e-3) / 1e12:.2f} TB/s, {flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s')
    k4 = dict(name='triplane_mlp', route='cuda', source='tdgp_torch/csrc/triplane_mlp.cu',
              replaces='tdgp/ops/pallas_kernels.py:305', max_abs_err=max(errs), ms=ms,
              plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
              cuda_core_bound_ms=cuda_core_bound_ms, two_layer_ms=layers_ms)
    del feats, got, ref

    x = torch.randn(4, 512, 512, 64, device='cuda', generator=g) * 100  # some beyond the clamp
    b = torch.randn(64, device='cuda', generator=g)
    worst = 0.0
    with torch.no_grad():
        cases = [('lrelu', x, b, dict(clamp=256.0)),
                 ('lrelu', x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), b,
                  dict(clamp=256.0))]  # the NHWC view of an NCHW tensor
        for act in bias_act.activation_funcs:
            xs = torch.randn(1023, 12, device='cuda', generator=g) * 3
            bs = torch.randn(12, device='cuda', generator=g)
            cases += [(act, xs, bs, dict(alpha=0.3, gain=0.7, clamp=2.5)),
                      (act, torch.randn(4, 31, 33, 8, device='cuda', generator=g) * 3, None, {})]
        for act, xi, bi, opts in cases:
            got = bias_act.bias_act(xi, bi, act=act, **opts)
            ref = bias_act.bias_act_plain(xi, bi, act=act, **opts)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            check(got.stride() == xi.stride(), 'K5 changed the layout')
            check(err <= 1e-6 * float(ref.abs().max()),
                  f'K5 {act} at {tuple(xi.shape)} disagrees with its plain version: {err:.3g}')
            worst = max(worst, err)
        print(f'K5 at {len(cases)} shapes and activations: max abs diff {worst:.3g} '
              f'(<= 1e-6 x max |plain| each)')
        ms = cuda_ms(lambda: bias_act.bias_act(x, b, act='lrelu', clamp=256.0), 100)
        view_ms = cuda_ms(lambda: bias_act.bias_act(cases[1][1], b, act='lrelu', clamp=256.0), 100)
        plain_ms = cuda_ms(lambda: bias_act.bias_act_plain(x, b, act='lrelu', clamp=256.0), 20)
    bound_ms, bound_by = bound(8 * x.numel() + 4 * b.numel(), 4 * x.numel())
    print(f'K5 at [4,512,512,64] lrelu clamp 256: kernel {ms:.4f} ms (NHWC view of NCHW '
          f'{view_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms (by {bound_by}), '
          f'{8 * x.numel() / (ms * 1e-3) / 1e12:.2f} TB/s')
    k5 = dict(name='bias_act', route='cuda', source='tdgp_torch/csrc/bias_act.cu',
              replaces='tdgp/ops/pallas_kernels.py:41', max_abs_err=worst, ms=ms,
              plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    return k4, k5


def reset_counts(counters):
    for c in counters:
        c.launches = 0


def inference_phase(counters, tmp_dir, run_dir, overrides, device='cuda'):
    """Seed grid, trajectory and mesh of the run's generator, through the
    entry points' functions; then the plain K4 and K5; then the entry points."""
    from tdgp_torch import geometry, inference
    from tdgp_torch.ops import bias_act, triplane_mlp
    from tdgp_torch.scripts import extract_geometry as geometry_script
    from tdgp_torch.scripts import inference as inference_script

    cfg, G = inference_script.load_run(run_dir, device=device, overrides=overrides)
    gc = G.cfg
    res, batch = gc.img_resolution, 4
    chunks = (res * res) // (gc.max_batch_res ** 2)
    seeds = list(range(16))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    launches = {}

    def read(what, k3_expected, k4_expected, calls):
        got = {c.__name__: c.launches for c in counters}
        expected = {'ray_march_reduced': k3_expected, 'triplane_mlp': k4_expected,
                    'bias_act': calls.count}
        print(f'{what}: launches {got} (expected {expected})')
        check(got == expected, f'kernel launch counts of the {what}')
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        reset_counts(counters)

    with BiasActCalls() as calls:
        t0 = time.perf_counter()
        c = inference_script.class_labels(cfg, seeds, None, torch.device(device))
        z = inference.sample_z_from_seeds(seeds, gc.z_dim, device)
        cams = inference.canonical_cameras(cfg, len(seeds), G=G, z=z, c=c)
        ws = inference.sample_ws_from_seeds(G, seeds, c, cams.angles, truncation_psi=0.7)
        imgs = inference.generate(G, ws, cams, batch_size=batch)
        grid_s = time.perf_counter() - t0
        read('seed grid', 4 * chunks, 4 * 2 * chunks, calls)
    check(imgs.shape == (16, res, res, 3), f'grid images {imgs.shape}')
    check(bool(np.isfinite(imgs).all()) and imgs.min() >= 0.0 and imgs.max() <= 1.0,
          'grid pixels not finite or outside [0, 1]')
    inference.save_image(inference.make_grid(imgs), os.path.join(tmp_dir, 'grid.png'))

    with BiasActCalls() as calls:
        t0 = time.perf_counter()
        traj = dict(name='front_circle', num_frames=16, fov_diff=1.0, yaw_diff=0.5,
                    pitch_diff=0.3)
        cams_traj = inference.generate_camera_trajectory(traj, cams.select(slice(0, 2)))
        frames = inference.generate_trajectory(G, ws[:2], cams_traj, batch_size=batch)
        traj_s = time.perf_counter() - t0
        n_batches = 2 * 16 // batch
        read('trajectory', n_batches * chunks, n_batches * 2 * chunks, calls)
    check(frames.shape == (16, 2, res, res, 3), f'trajectory frames {frames.shape}')
    check(bool(np.isfinite(frames).all()) and frames.min() >= 0.0 and frames.max() <= 1.0,
          'trajectory pixels not finite or outside [0, 1]')
    inference.save_video_frames(np.stack([inference.make_grid(f) for f in frames]),
                                os.path.join(tmp_dir, 'video.gif'))

    with BiasActCalls() as calls:
        t0 = time.perf_counter()
        verts, faces, sigma = geometry.extract_geometry(G, ws[:1], resolution=128,
                                                        cube_scale=cfg.camera.cube_scale)
        geo_s = time.perf_counter() - t0
        read('density grid and mesh', 0, 128 ** 3 // 32 ** 3, calls)
    check(sigma.shape == (128, 128, 128) and bool(np.isfinite(sigma).all()), 'density grid')
    check(len(verts) > 0 and len(faces) > 0 and int(faces.max()) < len(verts), 'empty mesh')
    check(bool(np.all(np.abs(verts) <= cfg.camera.cube_scale + 1e-6)), 'mesh outside the cube')
    geometry.save_obj(verts, faces, os.path.join(tmp_dir, 'seed0000.obj'))
    peak = torch.cuda.max_memory_allocated()
    print(f'inference at {res}x{res}: seed grid of 16 at batch {batch} {grid_s:.2f} s '
          f'({1e3 * grid_s / 4:.1f} ms per batch, {16 / grid_s:.2f} images/s, mapping and '
          f'per-class averages included); front_circle 2 x 16 frames {traj_s:.2f} s '
          f'({1e3 * traj_s / n_batches:.1f} ms per batch, {32 / traj_s:.2f} images/s); density '
          f'grid 128^3 + mesh {geo_s:.2f} s ({len(verts)} vertices, {len(faces)} faces); '
          f'peak memory {peak / 2**30:.2f} GiB')

    with plain_versions(k1=False, k3=False, k4=True, k5=True):
        plain_imgs = inference.generate(G, ws[:batch], cams.select(slice(0, batch)),
                                        batch_size=batch)
        plain_sigma = geometry.extract_density_grid(G, ws[:1], 128, cfg.camera.cube_scale)
    check(triplane_mlp.triplane_mlp.launches == 0 and bias_act.bias_act.launches == 0,
          'the plain run launched K4 or K5')
    diff = float(np.abs(plain_imgs - imgs[:batch]).max())
    inner = (slice(1, -1),) * 3  # extract_geometry zeroed the border
    sigma_rel = float(np.abs(plain_sigma[inner] - sigma[inner]).max()
                      / np.abs(plain_sigma[inner]).max())
    print(f'card, K4 + K5 vs their plain versions: max abs image diff {diff:.3g}; density '
          f'grid max abs diff / max |sigma| {sigma_rel:.3g}')
    check(diff <= 1e-4, 'the image through K4 and K5 disagrees with the plain versions')
    check(sigma_rel <= 1e-5, 'the density grid through K4 and K5 disagrees with the plain versions')
    reset_counts(counters)

    run = ['--run-dir', run_dir, '--device', device]
    for o in overrides:
        run += ['--override', o]
    t0 = time.perf_counter()
    inference_script.main(run + ['--seeds', '0-3', '--truncation', '0.7',
                                 '--output', os.path.join(tmp_dir, 'cli_grid.png')])
    inference_script.main(run + ['--vis', 'video_grid', '--seeds', '0-1', '--num-frames', '4',
                                 '--output', os.path.join(tmp_dir, 'cli_video.gif')])
    geometry_script.main(run + ['--seeds', '1', '--out-dir', tmp_dir, '--save-mrc'])
    written = sorted(os.listdir(tmp_dir))
    print(f'entry points {time.perf_counter() - t0:.1f} s; wrote {written}')
    check({'cli_grid.png', 'cli_video.gif', 'seed0001.obj', 'seed0001.mrc'} <= set(written),
          'an entry point wrote no output')
    check(triplane_mlp.triplane_mlp.launches == 2 * chunks * (1 + 2) + 64,
          'the entry points did not run K4 as implied')
    reset_counts(counters)
    return launches


def step_points_phase(calls):
    """K1 on the arguments of its two calls in a training step (the coarse
    and the fine render pass): against its plain version (<= 1e-5 x max
    |plain|), its bins against `_bins`, its time beside its bound, and the
    most (plane, point) corners on one texel."""
    from tdgp_torch.ops import splat
    readings = {}
    for label, (planes, coords, g, scale, coords_grad) in calls:
        n3, h, w, _ = planes.shape
        planes, coords, g = planes.detach(), coords.detach(), g.detach()
        check(same_bins(splat, coords, scale, h, w), f"K1's bins of the {label} pass differ")
        out = splat.triplane_splat(planes, coords, g, scale, coords_grad)
        ref = splat.triplane_sample_bwd_plain(planes, coords, g, scale, coords_grad)
        torch.cuda.synchronize()
        rel = [float((a - b).abs().max() / b.abs().max())
               for a, b in zip(out, ref) if b is not None]
        del out, ref
        check(all(e <= 1e-5 for e in rel),
              f'K1 disagrees with its plain version on the {label} pass')
        ms = cuda_ms(lambda: splat.triplane_splat(planes, coords, g, scale, coords_grad), 20)
        bins_ms = cuda_ms(lambda: splat.triplane_splat_bins(coords, h, w, scale), 20)
        bytes_moved, flops, texels, most = k1_work(splat, planes, coords, scale, coords_grad)
        bound_ms, bound_by = bound(bytes_moved, flops)
        print(f'K1 on the training step\'s {label} points (planes {list(planes.shape)}, coords '
              f'{list(coords.shape)}, coordinate gradient {coords_grad}): max abs diff / max '
              f'|plain| {rel}; kernel {ms:.4f} ms (its bins {bins_ms:.4f} ms; '
              f'{bin_summary(splat, coords, h, w, scale)}), bound {bound_ms:.4f} ms '
              f'({bytes_moved / 1e9:.2f} GB by {bound_by}; {texels} texels touched, at most '
              f'{most} corners on one)')
        readings.update({f'ms_step_{label}': ms, f'bound_ms_step_{label}': bound_ms,
                         f'bins_ms_step_{label}': bins_ms,
                         f'max_corners_per_texel_step_{label}': most,
                         f'max_abs_err_step_{label}': max(rel)})
    return readings


def train_phase(Trainer, Draws, sched, cfg, make_batch, capture_splat_calls, batch_size,
                counters, printed, device='cuda'):
    """The satellite step at full width: a warm-up step, whose K1 calls are
    held and timed by `step_points_phase`, then plain steps and one R1 step.
    `counters` are checked against what the step implies, `printed` only
    printed. Returns the launches and the step-point readings of K1."""
    trainer = Trainer(cfg, device, seed=0)
    batch = make_batch(cfg, batch_size, 0, device)
    draws = Draws(torch.Generator(device=device).manual_seed(1))
    modules = {'G': trainer.G, 'D': trainer.D, 'G_ema': trainer.G_ema}
    before = {k: {n: p.detach().clone() for n, p in m.named_parameters()}
              for k, m in modules.items()}
    calls = capture_splat_calls(trainer, batch, sched, draws)  # the warm-up step
    torch.cuda.synchronize()
    k1_step = step_points_phase(calls)
    del calls
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters + printed)
    plain_ms, history = [], []
    for _ in range(TRAIN_PLAIN_STEPS):
        t0 = time.perf_counter()
        history.append(trainer.step(batch, sched, False, draws))
        torch.cuda.synchronize()
        plain_ms.append(1e3 * (time.perf_counter() - t0))
    t0 = time.perf_counter()
    history.append(trainer.step(batch, sched, True, draws))
    torch.cuda.synchronize()
    r1_ms = 1e3 * (time.perf_counter() - t0)
    launches = {c.__name__: c.launches for c in counters}
    off_gradient = {c.__name__: c.launches for c in printed}
    peak = torch.cuda.max_memory_allocated()

    losses = {k: float(v) for k, v in history[-1].items()}
    print('losses of the R1 step: ' + ', '.join(f'{k} {v:.4g}' for k, v in sorted(losses.items())))
    check('Loss/D/r1_penalty' in losses, 'the R1 step ran no R1')
    check(all(np.isfinite(float(v)) for st in history for v in st.values()), 'non-finite losses')
    for k, m in modules.items():
        still = [n for n, p in m.named_parameters() if torch.equal(p, before[k][n])]
        print(f'{k}: {len(before[k]) - len(still)} of {len(before[k])} parameter tensors moved'
              + (f'; not: {still[:5]}' if still else ''))
        check(not still, f'parameters of {k} did not move')
    n_micro = batch_size // (cfg.training.batch_gpu or batch_size)
    steps = TRAIN_PLAIN_STEPS + 1
    expected = {'triplane_splat': 2 * n_micro * steps,  # coarse and fine pass of each Gmain render
                'ray_march_reduced': n_micro * steps, 'ray_march_reduced_bwd': n_micro * steps}
    print(f'launches over {steps} steps: {launches} (expected {expected}); per step: '
          + ', '.join(f'{k} {v / steps:g}' for k, v in launches.items()))
    check(launches == expected, 'kernel launch counts of the training path')
    print(f'launches over {steps} steps of the kernels off the gradient path: {off_gradient}')
    t_plain = float(np.median(plain_ms))
    imgs_per_s = 16 * batch_size / (15 * t_plain / 1e3 + r1_ms / 1e3)
    print(f'training step, satellite 256^2, batch {batch_size} (batch_gpu '
          f'{cfg.training.batch_gpu}): plain ms {["%.1f" % t for t in plain_ms]}, median '
          f'{t_plain:.1f} ms; R1 step {r1_ms:.1f} ms; {imgs_per_s:.2f} images/s at 15:1; '
          f'peak memory {peak / 2**30:.2f} GiB')
    return {**launches, **off_gradient}, k1_step


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from tdgp_torch import profile_training
    from tdgp_torch.models.layers import FullyConnected, init_weights
    from tdgp_torch.ops import bias_act, cuda_build, ray_march, splat, triplane_mlp
    from tdgp_torch.profile_serving import BATCH, OVERRIDES, PSI, RUN_DIR, request
    from tdgp_torch.serving import load_generator, make_serving_fn
    from tdgp_torch.training.schedules import compute_schedules
    from tdgp_torch.training.train_step import Trainer
    from tdgp_torch.utils.draws import Draws

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True, check=True)
    print(f'card: {smi.stdout.strip()}')
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}')

    seconds = {}
    with phase('build', seconds):
        for name, path in cuda_build.build(list(cuda_build.sources()), ptxas_info=True).items():
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
        served = [ray_march.ray_march_reduced, triplane_mlp.triplane_mlp, bias_act.bias_act]
        reset_counts(served)
        images, times = [], []
        with BiasActCalls() as calls:
            for req in requests:
                t0 = time.perf_counter()
                images.append(serve(*req))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        launches = ray_march.ray_march_reduced.launches
        serve_launches = {c.__name__: c.launches for c in served}
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
        print(f'K4 launches over {len(requests)} requests: {serve_launches["triplane_mlp"]} '
              f'(expected 2 passes x {chunks} chunks x {len(requests)}); K5: '
              f'{serve_launches["bias_act"]} (expected {calls.count} bias_act calls on CUDA '
              f'tensors, {calls.strided} of them on tensors that are not contiguous), '
              f'{serve_launches["bias_act"] / len(requests):g} per request')
        check(serve_launches['triplane_mlp'] == 2 * chunks * len(requests), 'K4 launch count')
        check(serve_launches['bias_act'] == calls.count, 'K5 launch count')
        ms = [1e3 * t for t in times]
        print(f'serving batch {BATCH} at {res}x{res}: ms per request {["%.1f" % t for t in ms]}, '
              f'median {np.median(ms):.1f} ms, {BATCH / np.median(times):.2f} images/s, '
              f'peak memory {peak / 2**30:.2f} GiB')

    with phase('cross-check', seconds):
        with plain_versions():
            plain_img = serve(*requests[0])
        diff = float((plain_img - images[0]).abs().max())
        print(f'card, K3 vs plain marcher: max abs image diff {diff:.3g}')
        check(diff <= 1e-4, 'K3 image disagrees with the plain marcher')
        del plain_img
        card64 = make_serving_fn(G, truncation_psi=PSI, resolution=64)(*requests[0])
        G_cpu = load_generator(RUN_DIR, 'cpu', OVERRIDES)
        cpu64 = make_serving_fn(G_cpu, truncation_psi=PSI, resolution=64)(
            *[t.cpu() for t in requests[0]])
        diff = float((card64.cpu() - cpu64).abs().max())
        print(f'card vs CPU at 64x64: max abs image diff {diff:.3g}')
        check(diff <= 1e-3, 'card disagrees with the CPU')

    with phase('train kernels', seconds):
        k3_bwd, k1 = train_kernel_phase(ray_march, splat)

    cfg = profile_training.train_config()
    sched = compute_schedules(cfg, profile_training.CUR_NIMG)
    with phase('train check', seconds):
        train_check_phase(Trainer, Draws, sched, profile_training.train_config,
                          profile_training.make_batch)

    with phase('inference kernels', seconds):
        k4, k5 = inference_kernel_phase(bias_act, triplane_mlp, FullyConnected, init_weights)

    with phase('inference', seconds), tempfile.TemporaryDirectory() as tmp_dir:
        infer_launches = inference_phase(served, tmp_dir, RUN_DIR, OVERRIDES)

    with phase('train', seconds):
        train_launches, k1_step = train_phase(Trainer, Draws, sched, cfg,
                                              profile_training.make_batch,
                                              profile_training.capture_splat_calls,
                                              profile_training.BATCH,
                                              [splat.triplane_splat, ray_march.ray_march_reduced,
                                               ray_march.ray_march_reduced_bwd],
                                              [triplane_mlp.triplane_mlp, bias_act.bias_act])
    k1.update(k1_step)
    by_path = {'serve': serve_launches, 'inference': infer_launches, 'train': train_launches}
    for k in (k3, k3_bwd, k1, k4, k5):
        k['launches_by_path'] = {path: got.get(k['name'], 0) for path, got in by_path.items()}
        k['launches'] = sum(k['launches_by_path'].values())

    print(f'phases (s): {json.dumps({k: round(v, 1) for k, v in seconds.items()})}, '
          f'total {time.perf_counter() - t_start:.1f} s')
    print(json.dumps({'kernels': [k3, k3_bwd, k1, k4, k5]}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
