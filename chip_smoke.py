#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tdgp_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from `tdgp_torch/csrc/`, then:
  1. kernel:      K3 (ray_march_reduced) against its plain PyTorch version at
                  the serving shape (65,536 rays x 64 samples x 3 channels)
                  and at every width it is built for (S = 5 to 200, C = 1 to
                  4), max abs diff <= 1e-5 on every output; timed warm (500
                  back-to-back calls on the same inputs), warm with the calls
                  enqueued ahead, cold (each call alone after a 256 MiB write
                  that evicts the L2) and cold with a clean L2, with the SM
                  and memory clocks beside each, and the host's time per call
                  (`timed`), also at the training shape (16 x 4096 rays);
                  plain and bound times. Then K3's merged entry
                  (ray_march_merged: the coarse and fine sets merged and
                  marched in one launch) against its plain version
                  (unify_samples_sorted + the plain march) at the served chunk
                  (32 + 32 samples, a quarter of the fine depths tied to
                  coarse ones) and at small shapes with S1 != S2 for every
                  width it is built for, in the four marcher settings, max
                  abs diff <= 1e-5 on every output;
                  timed in the same ways beside the two-step path it replaces
                  (unify_samples_sorted + K3), its plain version and bound; and at
                  the training shape of Dmain's fresh fakes, [16, 4096, 32 + 32,
                  C], the samples jittered as a training render draws them
                  (`train_merged_sets`), for C = 1-4 in the four settings (<=
                  1e-5), timed at C = 3.
  2. serve:       the trained 256^2 flagship generator (tri-planes 3x512^2x32)
                  at the precision it was trained at (its decoder's blocks
                  64-512 in bf16), then at the float32 cut
                  (generator.fp32_only=true): each serves 3 requests of batch
                  4 after one warm-up; images [4,256,256,3], finite, in
                  [0,1]; K3's merged entry launched once per ray chunk (4 per
                  request) during the 3 requests, the unmerged K3 never; ms
                  per request, images/s, peak memory of each, and the
                  relative L2 between their images.
  3. cross-check: one request (bf16 blocks) through the plain merge and
                  marcher on the card (<= 1e-4; no K3 launch;
                  `plain_versions` swaps the kernels' wrappers for their plain
                  versions, which no config can select on the card), and the
                  port on the CPU at a 64x64 output against the card: at the
                  float32 cut <= 1e-3 max abs (the convolutions sum in another
                  order), with bf16 blocks a relative L2 <=
                  CROSS_BF16_OF_FLOOR x the bf16 floor (the card's bf16 image
                  against its float32 one).
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
                  the kernels and through their plain versions on the card,
                  at the float32 cut as below, then with the bf16 blocks
                  (every parameter within max(1e-3, BF16_FLOOR_FACTOR x its
                  one-ulp floor), K1 and K3 not held alone);
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
                  order moves by ~1e-3. Then D's Dmain gradient with fresh
                  fakes (`training.dmain_reuse_fakes=false`), the fakes rendered
                  without gradients through K3's merged entry, K4 and K5 and
                  through their plain versions, at the float32 cut and with
                  bf16 blocks, at the Gmain check's limits; the one-ulp floor
                  there is an ulp on every float32 `bias_act` output of the
                  render (`ulp_after_bias_act`). The fresh-fake image <= 1e-4
                  at float32, <= BF16_FLOOR_FACTOR x its floor with bf16 blocks.
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
                  longer calls. No single PyTorch call computes either. Then
                  K5's bf16 instantiation at the same shapes in bf16 (and D's
                  skip: linear, gain sqrt 1/2): bit for bit for linear and
                  lrelu, at most one ulp for the others (the share printed);
                  K5 at float32 and in bf16 at [4,512,512,64] timed warm,
                  cold and cold with a clean L2 in turns, bf16 beside its
                  bound (2 + 2 bytes an element).
  7. inference:   the trained flagship through `tdgp_torch.inference` and
                  `tdgp_torch.geometry` (loaded by the entry points'
                  `load_run`): a grid of seeds 0-15 at batch 4 with truncation
                  0.7 (per-class averages), a front_circle trajectory of 2 seeds
                  x 16 frames, and the 128^3 density grid of seed 0 (64 chunks
                  of 32^3) marched into a mesh by the C++ marching; images in
                  [0, 1], a non-empty mesh; ms per batch, images/s, peak memory;
                  K4 launched 2 passes x 4 chunks per batch and once per density
                  chunk, K3 merged 4 times per batch (unmerged never), K5
                  once per bias_act call on a
                  CUDA tensor (by dtype). Then, at the float32 cut, one grid
                  batch and the density grid through the kernels and with the
                  plain versions of K4 and K5: image <= 1e-4 max abs, sigma
                  <= 1e-5 x max |sigma| (with bf16 blocks a float32 ulp of K5
                  flips bf16 roundings that the next blocks spread; K5 in
                  bf16 is held bit for bit in 6). Then the two entry points
                  (`python3 -m tdgp_torch.scripts.inference`, image_grid and
                  video_grid, and `... .extract_geometry`), each run once on a
                  small workload into a temporary directory.
  8. train:       the satellite 256^2 G+D step (`tdgp_torch.profile_training`:
                  at its own precision, G's blocks 64-512 and D's 256-32 in
                  bf16, then at the float32 cut without the K1 holding;
                  random weights from a seed, batch 16 of a
                  synthetic batch): one warm-up step, whose two K1 calls (the
                  Gmain render's coarse and fine pass) are kept and K1 held
                  on them as in 4, timed beside its bound, with the most
                  (plane, point) corners on one texel; then plain steps and one
                  R1 step; losses finite, every parameter of G and D moved,
                  the EMA moved, K1 / K3 / K3-backward launched as often as
                  the step implies (K3 merged never); ms per step, images/s at the 15:1
                  plain:R1 cadence, peak memory. Then the same step with fresh
                  Dmain fakes at its own precision: K3's merged entry 1 and K4
                  2 launches per Dmain microbatch (none with reused fakes), K5
                  in every run once per bias_act call that autograd does not
                  record, by dtype; its readings printed beside the reused
                  fakes'.
  9. loop:        the ADA pipe (`tdgp_torch.training.augment`) at p = 1 with
                  every group on, [16, 64, 64, 4] (one D pass of the synth256
                  step), on the card against the CPU with the same draws:
                  output and VJP <= 1e-4 x max |CPU|, an R1-style gradient of
                  a gradient <= 1e-3 relative L2; its time at the step's
                  groups. Then the training entry point in process,
                  `tdgp_torch.scripts.train --preset synth256` (its own
                  precision: no override), on
                  a 256-image 256^2 folder that
                  `data_scripts/make_synthetic_dataset.py` writes: three
                  ticks of four steps with ADA reacting every tick
                  (ada_kimg 1), a snapshot every tick, fid2k_full (2048
                  images of G_ema, the random projection detector) and the
                  image grid at tick 3; stats.jsonl has the JAX loop's keys,
                  ADA's p follows the controller's formula on the logged
                  signs, the metric is finite, the snapshot's meta is the
                  loop's place; K1 2 and K3 / K3's backward 1 per step, the
                  merged K3 4 and K4 8 per render of 4 images, K5 once per
                  bias_act call that autograd does not record. The run's own
                  snapshot then goes through the entry points
                  (`snapshot_phase`): `load_run` with 'latest', 'best' and its
                  path gives the trainer's G_ema exactly; `scripts.inference
                  --snapshot latest` renders seeds 0-3 (launches checked);
                  `scripts.export_ema` and `load_run` of the `.npz` render the
                  snapshot's images bit for bit; `scripts.calc_metrics
                  --snapshot latest` at batch 16 gives the loop's fid2k_full
                  within SNAPSHOT_FID_LIMIT relative. Then a resume
                  from the snapshot for one more tick: cur_nimg, batch_idx
                  and ada_p restored, losses finite. sec/kimg per tick,
                  images/s, the metric's seconds, peak memory.
 10. metrics:     the rest of the metric suite (`metrics_phase`). K3's cut entry
                  (`ray_march_merged_cut`: the merged march with NFS's quantile cut,
                  the threshold a sort on the card) against its plain version at
                  the served chunk [4, 16384, 32 + 32, 3] with ties and at small
                  shapes, q = 0.25 and 0.5, the four settings (<= 1e-5), timed
                  warm and cold beside its bound, the threshold alone and the
                  merged entry without the cut. nfs256 of the committed flagship
                  at its precision, the loop's folder giving the labels: a batch
                  of 4 depth maps through the cut entry against its plain version
                  (<= NFS_KERNEL_LIMIT x max |depth|, cuDNN deterministic: another
                  algorithm moves densities by ulps, and a ray whose last sample
                  then crosses the threshold moves by up to the far end; K4 and K5
                  swapped too is printed), a batch card vs CPU at the float32 cut
                  and a 64^2 output (without the cut <= NFS_CPU_LIMIT everywhere;
                  with it at most NFS_CPU_SHARE of the pixels beyond that, and the
                  batch's NFS within NFS_CPU_REL), then the 256 maps through the
                  registry: the value, its seconds, K3's cut entry once and K4
                  twice per ray chunk, no other K3, K5 once per bias_act call.
                  InceptionV3 (299^2) and VGG16 (224^2) at seeded random weights
                  under exact_fp32: ms per batch of 16. KID, precision/recall and
                  IS of METRIC_IMAGES flagship images against as many of the
                  loop's folder (the random projection), PPL at PPL_PAIRS pairs
                  with VGG16: counts reduced from 50,000 and 2048.
 11. stylegan2:   the 2D StyleGAN2 baseline (`--preset stylegan2`, 256^2, full width: cbase
                  32768, cmax 512, G's blocks 32-256 and D's 64-16 in bf16 at its own
                  precision, D on 64^2 RGB patches; path-length regularization and style
                  mixing on), batch SG2_BATCH = 16 (the preset's 64, cut), random weights
                  from a seed, a synthetic batch made on the card. First its R1 + PL step
                  after a warm-up step, at the float32 cut and at its own precision,
                  through K5 and through its plain version on the same weights, Adam state
                  and draws: Gmain's, PL's, Dmain's and R1's gradient per parameter within
                  GRAD_LIMIT at float32, within max(GRAD_LIMIT, BF16_FLOOR_FACTOR x its
                  one-ulp floor) with bf16 blocks (the floor: an ulp on every float32
                  `bias_act` output that autograd does not record). Then the step timed at
                  both precisions (a warm-up, TRAIN_PLAIN_STEPS plain steps, one R1 + PL
                  step): losses finite, every parameter moved, `pl_mean` moved; K5
                  launched once per `bias_act` call of a no-grad 2D forward of the Dmain
                  batch, the `w_avg` pass and Gmain's frozen D's patch mappings, by
                  dtype, and never inside PL's or R1's recorded graph; no other kernel; ms per plain and per R1 + PL step,
                  images/s at 15:1, peak memory, each beside the card's name and power
                  limit. Then `scripts.train --preset stylegan2` on a LOOP_IMAGES-image
                  256^2 folder, no metric: three ticks of four steps (R1 + PL in the first),
                  a snapshot every tick, the image grid at tick 3; the snapshot carries
                  `pl_mean` and G_ema, `load_run` 'latest' gives the trainer's G_ema and
                  `export_ema`'s `.npz` loads back equal; a resume for one more tick
                  restores `pl_mean`; K5 launches as above.
Serving (2) also counts K4 (8 per request) and K5 launches per request, by dtype.
K5's launches are counted by dtype everywhere: 'bias_act' (float32) and
'bias_act_bf16' (bfloat16), each held to the `bias_act` calls of that dtype.
Prints the card's name and power limit, each phase's seconds, a JSON line
of per-kernel numbers (K5 in bf16 its own entry), and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, with no result, when a phase fails or there is no card.
"""
import collections
import contextlib
import functools
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
K5_NAMES = {torch.float32: 'bias_act', torch.bfloat16: 'bias_act_bf16'}  # K5's launches by dtype
CROSS_BF16_OF_FLOOR = 0.6   # card vs CPU at bf16: relative L2 over the bf16 floor
BF16_FLOOR_FACTOR = 3       # the train check with bf16 blocks: limit = this x the one-ulp floor


@contextlib.contextmanager
def plain_versions(k1=True, k3=True, k4=False, k5=False):
    """The generator with the plain PyTorch versions of K1 (backward), K3
    (forward and backward, and the merged forward), K4 and K5 in place of
    the kernels' wrappers, on the card: the reference the kernels' path is
    held against."""
    from tdgp_torch.models import epigraf, layers, stylegan2
    from tdgp_torch.ops import bias_act, ray_march, splat, triplane_mlp
    from tdgp_torch.rendering import renderer
    saved = (epigraf.triplane_sample, renderer.ray_march_reduced, renderer.ray_march_merged,
             renderer.ray_march_merged_cut, epigraf.triplane_mlp, layers.bias_act,
             stylegan2.bias_act)
    if k1:
        epigraf.triplane_sample = splat.triplane_sample_reference
    if k3:
        renderer.ray_march_reduced = ray_march.ray_march_reduced_reference
        renderer.ray_march_merged = ray_march.ray_march_merged_plain
        renderer.ray_march_merged_cut = ray_march.ray_march_merged_cut_plain
    if k4:
        epigraf.triplane_mlp = triplane_mlp.triplane_mlp_plain
    if k5:
        layers.bias_act = stylegan2.bias_act = bias_act.bias_act_plain
    try:
        yield
    finally:
        (epigraf.triplane_sample, renderer.ray_march_reduced, renderer.ray_march_merged,
         renderer.ray_march_merged_cut, epigraf.triplane_mlp, layers.bias_act,
         stylegan2.bias_act) = saved


class BiasActCalls:
    """Counts the calls of `bias_act` on CUDA tensors made by the models
    (`models/layers.py`, `models/stylegan2.py`) while it is entered, by the
    name K5's launches take (`launch_counts`: 'bias_act' float32,
    'bias_act_bf16' bfloat16): the K5 launches a path without gradients
    should show (`count`); those that autograd does not record
    (`unrecorded`: K5's launches on a path that records some calls, as
    training does); the calls on tensors that are not contiguous (K5 takes
    them as strided views); and the bytes and operations of all of them (x
    read, y written, the bias read, each in x's dtype; 4 operations an
    element), for K5's bound over a path."""

    def __enter__(self):
        from tdgp_torch.models import layers, stylegan2
        self.count, self.unrecorded = collections.Counter(), collections.Counter()
        self.strided = self.bytes = self.flops = 0
        self._saved = layers.bias_act, stylegan2.bias_act
        inner = layers.bias_act

        def counted(x, b=None, **kwargs):
            if x.is_cuda:
                name = K5_NAMES[x.dtype]
                self.count[name] += 1
                self.unrecorded[name] += not (torch.is_grad_enabled() and (
                    x.requires_grad or (b is not None and b.requires_grad)))
                self.strided += not x.is_contiguous()
                self.bytes += x.element_size() * (2 * x.numel() + (0 if b is None else b.numel()))
                self.flops += 4 * x.numel()
            return inner(x, b, **kwargs)

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


def hold(seconds):
    """Keeps the card busy for about `seconds` (a spin kernel of that many
    cycles at ~2 GHz), so that the host enqueues what follows before the card
    reaches it."""
    torch.cuda._sleep(int(seconds * 2e9))


def cuda_ms(fn, iters, repeats=5, warmup_s=0.5, prefill=False):
    """Median over `repeats` of the mean time of `iters` back-to-back calls,
    after `warmup_s` seconds of calls to bring the card to its clocks. With
    `prefill`, the card is held while the host enqueues the calls, so that
    the time is the card's even where the host launches them more slowly
    than the card runs them."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < warmup_s:
        fn()
        torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        if prefill:
            hold(iters * 1e-4)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def cold_ms(fn, repeats=20, flush_mib=256, clean=False):
    """Median over `repeats` single calls, each timed alone with CUDA events
    right after a write of `flush_mib` MiB, which evicts the 50 MB L2 (the
    card held meanwhile, so that the call is enqueued before the card
    reaches it). With `clean`, a read of 64 MiB of another buffer follows
    the write, so that the lines the call evicts need no write-back to
    device memory."""
    flush = torch.empty(flush_mib * 2 ** 18, device='cuda')
    other = torch.ones(2 ** 24, device='cuda') if clean else None
    fn()
    times = []
    for _ in range(repeats):
        flush.fill_(1.0)
        if clean:
            other.sum()
        hold(1e-3)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def clocks():
    """The card's SM and memory clocks (MHz), as nvidia-smi reads them now."""
    return subprocess.run(['nvidia-smi', '--query-gpu=clocks.sm,clocks.mem',
                           '--format=csv,noheader'],
                          capture_output=True, text=True, check=True).stdout.strip()


def host_us(fn, iters=200):
    """Microseconds of host time per call of `fn` while the card is held:
    the rate at which the host launches it (bounded below by the card's own
    time once the launch queue fills, for a function of many launches)."""
    torch.cuda.synchronize()
    hold(iters * 5e-4)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    return us


def timed(label, fn, iters):
    """K3's timings of `fn` (ms): warm (`iters` back-to-back calls, as the
    kernels' times were taken before), warm with the calls enqueued ahead
    (`prefill`), cold after a write and cold with a clean L2 (`cold_ms`);
    each printed with the clocks read right after it; and the host's time
    per call (`host_us`, in us)."""
    out = {}
    for key, measure in (('warm', lambda: cuda_ms(fn, iters)),
                         ('warm_prefilled', lambda: cuda_ms(fn, iters, prefill=True)),
                         ('cold', lambda: cold_ms(fn)),
                         ('cold_clean', lambda: cold_ms(fn, clean=True))):
        out[key] = measure()
        print(f'{label} {key}: {out[key]:.4f} ms (sm, mem clocks {clocks()})')
    out['host_us'] = host_us(fn)
    print(f'{label}: the host takes {out["host_us"]:.1f} us per call')
    return out


K3_CASES = [('softplus', True, False), ('softplus', False, False), ('softplus', False, True),
            ('relu', True, False)]  # (clamp_mode, use_inf_depth, last_back)


def merged_sets(g, b, r, s1, s2, c):
    """Two per-ray sorted sample sets as the renderer hands them to K3's
    merged entry (depths, colours, raw densities of each), about a quarter
    of the second set's depths equal to depths of the first (ties)."""
    t1 = torch.rand(b, r, s1, device='cuda', generator=g).sort(-1).values * 0.5 + 0.75
    t2 = torch.rand(b, r, s2, device='cuda', generator=g) * 0.5 + 0.75
    pick = torch.randint(0, s1, (b, r, s2), device='cuda', generator=g)
    tie = torch.rand(b, r, s2, device='cuda', generator=g) < 0.25
    t2 = torch.where(tie, t1.gather(-1, pick), t2).sort(-1).values
    return (t1, torch.randn(b, r, s1, c, device='cuda', generator=g),
            torch.randn(b, r, s1, device='cuda', generator=g) * 2,
            t2, torch.randn(b, r, s2, c, device='cuda', generator=g),
            torch.randn(b, r, s2, device='cuda', generator=g) * 2)


def train_merged_sets(g, b, r, s1, s2, c):
    """The two sample sets of one training render without gradients (Dmain's
    fresh fakes): coarse depths jittered in their bins (`sample_stratified`),
    fine depths from the importance sampler on random coarse weights with a
    stratified random u (`sample_importance`), colours and raw densities with
    noise."""
    from tdgp_torch.rendering import renderer
    jitter = torch.rand(b, r, s1, device='cuda', generator=g)
    t1 = renderer.sample_stratified(b, r, s1, torch.device('cuda'), 0.75, 1.25, jitter)
    weights = torch.rand(b, r, s1, device='cuda', generator=g)
    u = torch.rand(b * r, s2, device='cuda', generator=g)
    t2 = renderer.sample_importance(t1, weights, s2, u_rand=u)
    return (t1.contiguous(), torch.randn(b, r, s1, c, device='cuda', generator=g),
            torch.randn(b, r, s1, device='cuda', generator=g) * 2, t2.contiguous(),
            torch.randn(b, r, s2, c, device='cuda', generator=g),
            torch.randn(b, r, s2, device='cuda', generator=g) * 2)


def kernel_phase(ray_march):
    """K3 against its plain version at the serving shape (one ray chunk of
    every image of a batch-4 request), timed warm, cold and cold with a
    clean L2, and at the training shape; then K3's merged entry against its
    plain version (the served chunk with ties, and S1 != S2 at small
    shapes), timed beside the two-step path it replaces."""
    g = torch.Generator(device='cuda').manual_seed(0)
    b, r, s, c = 4, 16384, 64, 3
    colors = torch.randn(b, r, s, c, device='cuda', generator=g)
    densities = torch.randn(b, r, s, device='cuda', generator=g) * 2
    depths = torch.rand(b, r, s, device='cuda', generator=g).sort(-1).values * 0.5 + 0.75
    worst = 0.0
    for clamp_mode, inf_depth, last_back in K3_CASES:
        args = (colors, densities, depths, clamp_mode, 1.0, inf_depth, last_back)
        out = ray_march.ray_march_reduced(*args)
        ref = ray_march.ray_march_reduced_plain(*args)
        torch.cuda.synchronize()
        errs = [float((a - b_).abs().max()) for a, b_ in zip(out, ref)]
        print(f'K3 {clamp_mode} inf_depth={inf_depth} last_back={last_back}: '
              f'max abs diff rgb/depth/wsum/ftrans = {errs}')
        check(all(e <= 1e-5 for e in errs), 'K3 disagrees with its plain version')
        worst = max(worst, *errs)
    # every width the kernel is built for (lanes and samples per lane, C), and
    # a ray of more than 128 samples, marched in passes
    small = 0.0
    for c_small in range(1, 5):
        for s_small in (5, 16, 32, 64, 100, 200):
            ins = (torch.randn(2, 300, s_small, c_small, device='cuda', generator=g),
                   torch.randn(2, 300, s_small, device='cuda', generator=g) * 2,
                   torch.rand(2, 300, s_small, device='cuda', generator=g).sort(-1).values + 0.5)
            for opts in K3_CASES:
                errs = [float((a - b_).abs().max()) for a, b_ in zip(
                    ray_march.ray_march_reduced(*ins, opts[0], 1.0, *opts[1:]),
                    ray_march.ray_march_reduced_plain(*ins, opts[0], 1.0, *opts[1:]))]
                check(all(e <= 1e-5 for e in errs), f'K3 at S={s_small}, C={c_small}, {opts} '
                      f'disagrees with its plain version: {errs}')
                small = max(small, *errs)
    print(f'K3 at S = 5, 16, 32, 64, 100, 200 x C = 1-4, 2 x 300 rays, in the {len(K3_CASES)} '
          f'settings: max abs diff {small:.3g} (<= 1e-5)')
    worst = max(worst, small)
    args = (colors, densities, depths, 'softplus', 1.0, True, False)
    times = timed(f'K3 at [{b},{r},{s},{c}]', lambda: ray_march.ray_march_reduced(*args), 500)
    plain_ms = cuda_ms(lambda: ray_march.ray_march_reduced_plain(*args), 50)
    bytes_moved, flops = k3_work(b, r, s, c)
    bound_ms, bound_by = bound(bytes_moved, flops)
    print(f'K3 at [{b},{r},{s},{c}]: kernel {times["cold"]:.4f} ms cold, {times["warm"]:.4f} ms '
          f'warm, plain {plain_ms:.4f} ms, bound {1e3 * bound_ms:.1f} us '
          f'({bytes_moved / 1e6:.1f} MB by {bound_by}), '
          f'{bytes_moved / (times["cold"] * 1e-3) / 1e12:.2f} TB/s cold')
    del colors, densities, depths
    b_t, r_t = 16, 4096  # one Gmain render of the training step
    colors = torch.randn(b_t, r_t, s, c, device='cuda', generator=g)
    densities = torch.randn(b_t, r_t, s, device='cuda', generator=g) * 2
    depths = torch.rand(b_t, r_t, s, device='cuda', generator=g).sort(-1).values * 0.5 + 0.75
    train_times = timed(f'K3 at the training shape [{b_t},{r_t},{s},{c}]',
                        lambda: ray_march.ray_march_reduced(colors, densities, depths), 500)
    del colors, densities, depths
    k3 = dict(name='ray_march_reduced', route='cuda', source='tdgp_torch/csrc/ray_march.cu',
              replaces='tdgp/ops/pallas_kernels.py:86', max_abs_err=worst, ms=times['cold'],
              plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
              ms_warm=times['warm'], ms_warm_prefilled=times['warm_prefilled'],
              ms_cold_clean=times['cold_clean'], host_us=times['host_us'],
              ms_train_shape=train_times['cold'], ms_train_shape_warm=train_times['warm'],
              ms_train_shape_warm_prefilled=train_times['warm_prefilled'],
              ms_train_shape_cold_clean=train_times['cold_clean'])

    worst = 0.0
    shapes = [(b, r, 32, 32, c), (3, 200, 1, 127, 1)] + [  # every width the kernel is built for
        (2, 300, s1, s2, c_small) for c_small in range(1, 5)
        for s1, s2 in ((3, 5), (5, 11), (12, 20), (40, 24), (70, 58))]
    for shape in shapes:
        sets = merged_sets(g, *shape)
        for clamp_mode, inf_depth, last_back in K3_CASES:
            opts = (clamp_mode, 1.0, inf_depth, last_back)
            out = ray_march.ray_march_merged(*sets, *opts)
            ref = ray_march.ray_march_merged_plain(*sets, *opts)
            torch.cuda.synchronize()
            errs = [float((a - b_).abs().max()) for a, b_ in zip(out, ref)]
            check(all(e <= 1e-5 for e in errs),
                  f'K3 merged at [B,R,S1,S2,C] = {list(shape)} {clamp_mode} inf_depth={inf_depth} '
                  f'last_back={last_back} disagrees with its plain version: {errs}')
            worst = max(worst, *errs)
    print(f'K3 merged at [B,R,S1,S2,C] = [{b},{r},32,32,{c}] with ties, [3,200,1,127,1], and '
          f'[2,300,S1,S2,C] for (S1, S2) = (3, 5), (5, 11), (12, 20), (40, 24), (70, 58) and '
          f'C = 1-4, each in the {len(K3_CASES)} settings: max abs diff of '
          f'rgb/depth/wsum/ftrans {worst:.3g} (<= 1e-5)')
    sets = merged_sets(g, b, r, 32, 32, c)

    def two_step():  # the path before the merged entry: unify_samples_sorted, then K3
        all_depths, all_colors, all_densities = ray_march.unify_samples_sorted(*sets)
        return ray_march.ray_march_reduced(all_colors, all_densities, all_depths)

    merged_times = timed(f'K3 merged at [{b},{r},32+32,{c}]',
                         lambda: ray_march.ray_march_merged(*sets), 500)
    two_times = timed('unify_samples_sorted + K3', two_step, 50)
    merged_plain_ms = cuda_ms(lambda: ray_march.ray_march_merged_plain(*sets), 20)
    bytes_moved, flops = k3_work(b, r, s, c)
    flops += b * r * s * 7 * 2  # each sample's rank: a binary search of 7 steps
    merged_bound_ms, merged_bound_by = bound(bytes_moved, flops)
    print(f'K3 merged at [{b},{r},32+32,{c}]: kernel {merged_times["cold"]:.4f} ms cold, '
          f'{merged_times["warm"]:.4f} ms warm; unify_samples_sorted + K3 '
          f'{two_times["cold"]:.4f} ms cold, {two_times["warm"]:.4f} ms warm; plain '
          f'{merged_plain_ms:.4f} ms; bound '
          f'{1e3 * merged_bound_ms:.1f} us ({bytes_moved / 1e6:.1f} MB by {merged_bound_by}), '
          f'{bytes_moved / (merged_times["cold"] * 1e-3) / 1e12:.2f} TB/s cold')
    # the training shape of Dmain's fresh fakes: 16 x 64^2 rays, 32 + 32 samples jittered as a
    # training render draws them, at every channel width the kernel is built for
    b_t, r_t = 16, 4096
    train_worst = 0.0
    for c_t in range(1, 5):
        sets = train_merged_sets(g, b_t, r_t, 32, 32, c_t)
        for clamp_mode, inf_depth, last_back in K3_CASES:
            opts = (clamp_mode, 1.0, inf_depth, last_back)
            out = ray_march.ray_march_merged(*sets, *opts)
            ref = ray_march.ray_march_merged_plain(*sets, *opts)
            torch.cuda.synchronize()
            errs = [float((a - b_).abs().max()) for a, b_ in zip(out, ref)]
            check(all(e <= 1e-5 for e in errs),
                  f'K3 merged at the training shape [{b_t},{r_t},32+32,{c_t}] {clamp_mode} '
                  f'inf_depth={inf_depth} last_back={last_back} disagrees with its plain '
                  f'version: {errs}')
            train_worst = max(train_worst, *errs)
        del sets, out, ref
    print(f'K3 merged at the training shape [{b_t},{r_t},32+32,C] with training jitter, C = 1-4, '
          f'in the {len(K3_CASES)} settings: max abs diff {train_worst:.3g} (<= 1e-5)')
    worst = max(worst, train_worst)
    sets = train_merged_sets(g, b_t, r_t, 32, 32, c)
    merged_train_times = timed(f'K3 merged at the training shape [{b_t},{r_t},32+32,{c}]',
                               lambda: ray_march.ray_march_merged(*sets), 500)
    merged_train_plain_ms = cuda_ms(lambda: ray_march.ray_march_merged_plain(*sets), 20)
    del sets
    power = subprocess.run(['nvidia-smi', '--query-gpu=power.draw,temperature.gpu',
                            '--format=csv,noheader'], capture_output=True, text=True, check=True)
    print(f'power and temperature after timing: {power.stdout.strip()}')
    k3_merged = dict(name='ray_march_merged', route='cuda', source='tdgp_torch/csrc/ray_march.cu',
                     replaces='tdgp/ops/pallas_kernels.py:86',
                     also_replaces='tdgp/rendering/renderer.py:281', max_abs_err=worst,
                     ms=merged_times['cold'], plain_ms=merged_plain_ms, bound_ms=merged_bound_ms,
                     bound_by=merged_bound_by, library_ms=None, ms_warm=merged_times['warm'],
                     ms_warm_prefilled=merged_times['warm_prefilled'],
                     ms_cold_clean=merged_times['cold_clean'], host_us=merged_times['host_us'],
                     two_step_ms=two_times['cold'], two_step_ms_warm=two_times['warm'],
                     two_step_ms_warm_prefilled=two_times['warm_prefilled'],
                     ms_train_shape=merged_train_times['cold'],
                     ms_train_shape_warm=merged_train_times['warm'],
                     ms_train_shape_warm_prefilled=merged_train_times['warm_prefilled'],
                     ms_train_shape_cold_clean=merged_train_times['cold_clean'],
                     plain_ms_train_shape=merged_train_plain_ms,
                     max_abs_err_train_shape=train_worst)
    return k3, k3_merged


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


def train_check_phase(Trainer, Draws, sched, train_config, make_batch, overrides,
                      device='cuda'):
    """One step's Gmain gradient through the kernels and through the plain
    versions, at full width and batch 4, with the config `overrides`: at
    float32 held to GRAD_LIMIT (the depth adaptor: see the module's
    docstring); with bf16 blocks every parameter to max(GRAD_LIMIT,
    BF16_FLOOR_FACTOR x its one-ulp floor), since a float32 ulp of the
    rendered patch can flip a bf16 rounding in the decoder's backward."""
    from tdgp_torch.training import losses
    g_forward = losses.g_forward

    def one_ulp(*args, **kwargs):  # the rendered patch, changed by about one ulp
        out, pp = g_forward(*args, **kwargs)
        g = torch.Generator(device=device).manual_seed(9)
        img = out.img * (1 + 2.0 ** -24 * torch.randn(out.img.shape, device=device, generator=g))
        return type(out)(img=img, depth=out.depth), pp

    bf16 = not train_config(overrides).generator.fp32_only
    label = 'bf16 blocks' if bf16 else 'float32'

    def gmain_grads(k1_plain, k3_plain, perturb=False):
        cfg = train_config(list(overrides) + ['generator.use_noise=false'])
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
        if not bf16:
            k1_alone = rel_l2(gmain_grads(False, True), ref)
            k3_alone = rel_l2(gmain_grads(True, False), ref)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    if bf16:
        limit = {n: max(GRAD_LIMIT, BF16_FLOOR_FACTOR * floor[n]) for n in rel}
    else:
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
    print(f'Gmain gradient ({label}), kernels vs plain versions: {len(rel)} parameters, median '
          f'relative L2 difference {float(np.median(list(rel.values()))):.3g}, worst against its '
          f'limit {rel[name]:.3g} ({name}; limit {limit[name]:.3g}); one-ulp floor of the step: '
          f'median {float(np.median(list(floor.values()))):.3g}, max {max(floor.values()):.3g} '
          f'({max(floor, key=floor.get)}); above {GRAD_LIMIT:g}: {over}')
    check(all(rel[n] <= limit[n] for n in rel),
          f'the Gmain gradient ({label}) through the kernels disagrees with the plain path')


FRESH = ['training.dmain_reuse_fakes=false']  # Dmain renders fresh fakes, without gradients


@contextlib.contextmanager
def ulp_after_bias_act(device):
    """Every float32 `bias_act` output that autograd does not record (the
    fresh-fake render's) changed by about one ulp (x (1 + 2^-24 n), n ~ N(0,
    1)): the difference K5 at float32 makes to its plain version."""
    from tdgp_torch.models import layers, stylegan2
    saved = layers.bias_act, stylegan2.bias_act
    inner = layers.bias_act
    gen = torch.Generator(device=device).manual_seed(9)

    def noisy(x, b=None, **kwargs):
        y = inner(x, b, **kwargs)
        if y.dtype == torch.float32 and not torch.is_grad_enabled():
            y = y * (1 + 2.0 ** -24 * torch.randn(y.shape, device=y.device, generator=gen))
        return y

    layers.bias_act = stylegan2.bias_act = noisy
    try:
        yield
    finally:
        layers.bias_act, stylegan2.bias_act = saved


def fresh_fakes_check_phase(Trainer, Draws, sched, train_config, make_batch, overrides,
                            device='cuda'):
    """D's Dmain gradient with fresh fakes, at full width and batch 4 with
    the config `overrides`: the fakes rendered without gradients through
    K3's merged entry, K4 and K5, and through their plain versions
    (`plain_versions(k3=True, k4=True, k5=True)`). The one-ulp floor is the
    plain path's distance when every float32 `bias_act` output of the render
    moves by about an ulp (`ulp_after_bias_act`, what K5 at float32 does;
    with bf16 blocks such an ulp flips bf16 roundings in the blocks after
    it). The Gmain check's limits: each parameter at float32 within
    GRAD_LIMIT, with bf16 blocks within max(GRAD_LIMIT, BF16_FLOOR_FACTOR x
    its floor); the fresh-fake image at float32 within 1e-4 max abs, with
    bf16 blocks within BF16_FLOOR_FACTOR x the floor's image difference.
    Returns the image's max abs difference."""
    from tdgp_torch.training import losses
    from tdgp_torch.ops import bias_act, ray_march, triplane_mlp
    from tdgp_torch.utils.misc import exact_fp32
    g_forward = losses.g_forward
    images = {}

    def fake_render(key):
        def render(*args, **kwargs):
            out, pp = g_forward(*args, **kwargs)
            if not torch.is_grad_enabled():
                images[key] = out.img
            return out, pp
        return render

    cfg = train_config(list(overrides) + FRESH + ['generator.use_noise=false'])
    bf16 = not cfg.generator.fp32_only
    label = 'bf16 blocks' if bf16 else 'float32'

    def dmain_grads(plain, perturb=False):
        trainer = Trainer(cfg, device, seed=0)
        batch = make_batch(cfg, 4, 2, device)
        losses.g_forward = fake_render((plain, perturb))
        reset_counts([ray_march.ray_march_merged, triplane_mlp.triplane_mlp, bias_act.bias_act])
        try:
            with (plain_versions(k1=True, k3=True, k4=True, k5=True) if plain
                  else contextlib.nullcontext()), \
                    (ulp_after_bias_act(device) if perturb else contextlib.nullcontext()), \
                    exact_fp32():
                trainer._dmain(batch, sched, Draws(torch.Generator(device=device).manual_seed(3)),
                               1, lambda name, value: None, None, None)
        finally:
            losses.g_forward = g_forward
        launched = (ray_march.ray_march_merged.launches, triplane_mlp.triplane_mlp.launches,
                    bias_act.bias_act.launches)
        check(not any(launched) if plain else all(launched),
              f'the {"plain" if plain else "kernel"} fresh-fake render launched K3 merged, K4, '
              f'K5 {launched}')
        return {n: p.grad.detach().clone() for n, p in trainer.D.named_parameters()}

    def rel_l2(a, b):
        return {n: float((a[n] - r).norm() / r.norm().clamp_min(1e-30)) for n, r in b.items()}

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref = dmain_grads(True)
        rel = rel_l2(dmain_grads(False), ref)
        floor = rel_l2(dmain_grads(True, perturb=True), ref)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    img_diff = float((images[(False, False)] - images[(True, False)]).abs().max())
    img_floor = float((images[(True, True)] - images[(True, False)]).abs().max())
    img_limit = BF16_FLOOR_FACTOR * img_floor if bf16 else 1e-4
    limit = {n: max(GRAD_LIMIT, BF16_FLOOR_FACTOR * floor[n]) if bf16 else GRAD_LIMIT
             for n in rel}
    name = max(rel, key=lambda n: rel[n] / limit[n])
    print(f'fresh-fake image ({label}, [{", ".join(map(str, images[(False, False)].shape))}]), '
          f'K3 merged + K4 + K5 vs their plain versions: max abs diff {img_diff:.3g} (limit '
          f'{img_limit:.3g}; one-ulp floor {img_floor:.3g})')
    print(f'Dmain gradient with fresh fakes ({label}), kernels vs plain versions: {len(rel)} '
          f'parameters, median relative L2 difference {float(np.median(list(rel.values()))):.3g}, '
          f'worst against its limit {rel[name]:.3g} ({name}; limit {limit[name]:.3g}); one-ulp '
          f'floor: median {float(np.median(list(floor.values()))):.3g}, max '
          f'{max(floor.values()):.3g} ({max(floor, key=floor.get)})')
    check(img_diff <= img_limit, f'the fresh-fake image ({label}) through K3 merged, K4 and K5 '
                                 f'disagrees with the plain versions')
    check(all(rel[n] <= limit[n] for n in rel),
          f'the Dmain gradient with fresh fakes ({label}) through the kernels disagrees with '
          f'the plain path')
    return img_diff


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
    return k4, k5, bf16_kernel_phase(bias_act, x, b, k5, g)


def bf16_ulps(a, b):
    """Distance in bf16 ulps of each element of two bf16 tensors of one layout."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordered(a) - ordered(b)).abs()


def bf16_kernel_phase(bias_act, x, b, k5, g):
    """K5's bf16 instantiation against its plain version (bit for bit for
    linear and lrelu, at most one ulp for the others) at the largest served
    bf16 call, [4, 512, 512, 64] (the 512^2 block of the flagship: lrelu,
    gain sqrt 2, clamp 256), as its NHWC view of an NCHW tensor and at small
    shapes for each activation; timed warm, cold and cold with a clean L2
    beside K5 at float32 on the same values (`k5` gains those two)."""
    bf = torch.bfloat16
    xb = x.to(bf)
    worst_ulp, worst_abs, shares = 0, 0.0, {}
    with torch.no_grad():
        cases = [('lrelu', xb, b, dict(clamp=256.0)),
                 ('lrelu', xb.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), b,
                  dict(clamp=256.0)),
                 ('linear', xb, None, dict(gain=0.5 ** 0.5))]  # D's skip
        for act in bias_act.activation_funcs:
            cases += [(act, (torch.randn(1023, 16, device='cuda', generator=g) * 3).to(bf),
                       torch.randn(16, device='cuda', generator=g),
                       dict(alpha=0.3, gain=0.7, clamp=2.5)),
                      (act, (torch.randn(4, 31, 33, 12, device='cuda', generator=g) * 3).to(bf),
                       None, {}),
                      (act, (torch.randn(4, 12, 8, 8, device='cuda', generator=g) * 3).to(bf)
                       .permute(0, 2, 3, 1), torch.randn(12, device='cuda', generator=g), {})]
        for act, xi, bi, opts in cases:
            got = bias_act.bias_act(xi, bi, act=act, **opts)
            ref = bias_act.bias_act_plain(xi, bi, act=act, **opts)
            torch.cuda.synchronize()
            check(got.dtype == bf and got.stride() == xi.stride(), 'K5 bf16 changed the layout')
            ulps = bf16_ulps(got, ref)
            share = float((ulps > 0).float().mean())
            shares[act] = max(shares.get(act, 0.0), share)
            worst_ulp = max(worst_ulp, int(ulps.max()))
            worst_abs = max(worst_abs, float((got.float() - ref.float()).abs().max()))
            if act in ('linear', 'lrelu'):
                check(torch.equal(got, ref), f'K5 bf16 {act} at {tuple(xi.shape)} is not its '
                                             f'plain version bit for bit')
            check(int(ulps.max()) <= 1, f'K5 bf16 {act} at {tuple(xi.shape)}: {int(ulps.max())} '
                                        f'ulps from its plain version')
        print(f'K5 bf16 at {len(cases)} shapes and activations: at most {worst_ulp} ulp from the '
              f'plain version; share of elements that differ by activation {shares}')

        def served(t):
            return lambda: bias_act.bias_act(t, b, act='lrelu', clamp=256.0)
        times = {}
        for label, t in (('float32', x), ('bf16', xb)):
            times[label] = dict(warm=cuda_ms(served(t), 100), cold=cold_ms(served(t)),
                                cold_clean=cold_ms(served(t), clean=True))
            print(f'K5 {label} at [4,512,512,64] lrelu clamp 256: ' + ', '.join(
                f'{k} {v:.4f} ms' for k, v in times[label].items()) + f' (sm, mem clocks '
                f'{clocks()})')
        plain_ms = cuda_ms(lambda: bias_act.bias_act_plain(xb, b, act='lrelu', clamp=256.0), 20)
    bound_ms, bound_by = bound(4 * x.numel() + 2 * b.numel(), 4 * x.numel())
    print(f'K5 bf16: plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms (by {bound_by}: '
          f'{(4 * x.numel() + 2 * b.numel()) / 1e6:.1f} MB), cold {times["bf16"]["cold"] / bound_ms:.2f}x '
          f'its bound; float32 cold {times["float32"]["cold"] / k5["bound_ms"]:.2f}x its bound')
    k5.update(cold_ms=times['float32']['cold'], cold_clean_ms=times['float32']['cold_clean'])
    return dict(name='bias_act_bf16', route='cuda', source='tdgp_torch/csrc/bias_act.cu',
                replaces='tdgp/ops/pallas_kernels.py:41', max_abs_err=worst_abs,
                max_ulps=worst_ulp, ulp_share=shares, ms=times['bf16']['warm'],
                cold_ms=times['bf16']['cold'], cold_clean_ms=times['bf16']['cold_clean'],
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def reset_counts(counters):
    for c in counters:
        c.launches = 0
        if hasattr(c, 'launches_by_dtype'):
            c.launches_by_dtype.clear()


def launch_counts(counters):
    """{kernel name: launches} of the wrappers in `counters`; K5's split by
    dtype into 'bias_act' (float32) and 'bias_act_bf16' (bfloat16)."""
    got = {}
    for c in counters:
        if hasattr(c, 'launches_by_dtype'):
            for dtype, name in K5_NAMES.items():
                got[name] = c.launches_by_dtype[str(dtype).removeprefix('torch.')]
        else:
            got[c.__name__] = c.launches
    return got


def inference_phase(counters, tmp_dir, run_dir, overrides, device='cuda'):
    """Seed grid, trajectory and mesh of the run's generator, through the
    entry points' functions; then K4 and K5 against their plain versions at
    the float32 cut; then the entry points."""
    from tdgp_torch import geometry, inference
    from tdgp_torch.profile_serving import FP32
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
        got = launch_counts(counters)
        expected = {'ray_march_reduced': 0, 'ray_march_merged': k3_expected,
                    'triplane_mlp': k4_expected, **{n: calls.count[n] for n in K5_NAMES.values()}}
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

    # K4 and K5 against their plain versions at the float32 cut: with bf16 blocks a float32
    # ulp of K5 in the float32 blocks can flip a bf16 rounding after them, which the
    # following blocks spread (K5 in bf16 is its plain version bit for bit)
    _, G32 = inference_script.load_run(run_dir, device=device, overrides=list(overrides) + FP32)
    cams4 = cams.select(slice(0, batch))
    kernel_imgs = inference.generate(G32, ws[:batch], cams4, batch_size=batch)
    kernel_sigma = geometry.extract_density_grid(G32, ws[:1], 128, cfg.camera.cube_scale)
    reset_counts(counters)
    with plain_versions(k1=False, k3=False, k4=True, k5=True):
        plain_imgs = inference.generate(G32, ws[:batch], cams4, batch_size=batch)
        plain_sigma = geometry.extract_density_grid(G32, ws[:1], 128, cfg.camera.cube_scale)
    check(triplane_mlp.triplane_mlp.launches == 0 and bias_act.bias_act.launches == 0,
          'the plain run launched K4 or K5')
    del G32
    diff = float(np.abs(plain_imgs - kernel_imgs).max())
    sigma_rel = float(np.abs(plain_sigma - kernel_sigma).max() / np.abs(plain_sigma).max())
    print(f'card, float32 cut, K4 + K5 vs their plain versions: max abs image diff {diff:.3g}; '
          f'density grid max abs diff / max |sigma| {sigma_rel:.3g}')
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
                counters, label, device='cuda'):
    """The satellite step at full width: a warm-up step, whose K1 calls are
    held and timed by `step_points_phase` (unless `capture_splat_calls` is
    None), then plain steps and one R1 step. Every kernel's launches are
    held to what the step implies: K1 2, K3 and its backward 1 per Gmain
    microbatch; with fresh Dmain fakes K3's merged entry 1 and K4 2 (coarse
    and fine pass) per Dmain microbatch, else none; K5 once per `bias_act`
    call that autograd does not record, by dtype. Returns the launches, the
    step-point readings of K1 and the step's readings (ms per plain and R1
    step, images/s at 15:1, peak memory)."""
    trainer = Trainer(cfg, device, seed=0)
    batch = make_batch(cfg, batch_size, 0, device)
    draws = Draws(torch.Generator(device=device).manual_seed(1))
    modules = {'G': trainer.G, 'D': trainer.D, 'G_ema': trainer.G_ema}
    before = {k: {n: p.detach().clone() for n, p in m.named_parameters()}
              for k, m in modules.items()}
    k1_step = {}
    if capture_splat_calls is None:
        trainer.step(batch, sched, False, draws)  # the warm-up step
    else:
        calls = capture_splat_calls(trainer, batch, sched, draws)  # the warm-up step
        torch.cuda.synchronize()
        k1_step = step_points_phase(calls)
        del calls
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    plain_ms, history = [], []
    with BiasActCalls() as bias_calls:
        for _ in range(TRAIN_PLAIN_STEPS):
            t0 = time.perf_counter()
            history.append(trainer.step(batch, sched, False, draws))
            torch.cuda.synchronize()
            plain_ms.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        history.append(trainer.step(batch, sched, True, draws))
        torch.cuda.synchronize()
        r1_ms = 1e3 * (time.perf_counter() - t0)
    launches = launch_counts(counters)
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
    fresh = 0 if cfg.training.dmain_reuse_fakes else 1
    expected = {'triplane_splat': 2 * n_micro * steps,  # coarse and fine pass of each Gmain render
                'ray_march_reduced': n_micro * steps, 'ray_march_reduced_bwd': n_micro * steps,
                'ray_march_merged': fresh * n_micro * steps,
                'triplane_mlp': fresh * 2 * n_micro * steps,
                **{n: bias_calls.unrecorded[n] for n in K5_NAMES.values()}}
    print(f'launches over {steps} steps: {launches} (expected {expected}; K5: the bias_act calls '
          f'that autograd does not record, of {dict(bias_calls.count)} on CUDA tensors); per '
          f'step: ' + ', '.join(f'{k} {v / steps:g}' for k, v in launches.items()))
    check(launches == expected, 'kernel launch counts of the training path')
    t_plain = float(np.median(plain_ms))
    imgs_per_s = 16 * batch_size / (15 * t_plain / 1e3 + r1_ms / 1e3)
    print(f'training step, satellite 256^2, {label}, batch {batch_size} (batch_gpu '
          f'{cfg.training.batch_gpu}): plain ms {["%.1f" % t for t in plain_ms]}, median '
          f'{t_plain:.1f} ms; R1 step {r1_ms:.1f} ms; {imgs_per_s:.2f} images/s at 15:1; '
          f'peak memory {peak / 2**30:.2f} GiB')
    readings = dict(plain_ms=t_plain, r1_ms=r1_ms, images_per_s=imgs_per_s,
                    peak_gib=peak / 2 ** 30)
    return launches, k1_step, readings


# the keys of a tick's line in the JAX loop's stats.jsonl (tdgp/training/loop.py
# with the synth256 step: KD off, R1 in the tick, ADA, one metric)
LOOP_KEYS = {
    'Loss/G/loss', 'Loss/scores/fake', 'Loss/signs/fake', 'Loss/camera_dist/emd_loss',
    'Loss/camera_dist/force_mean', 'Loss/D/loss', 'Loss/scores/real', 'Loss/signs/real',
    'Timing/sec_per_tick', 'Timing/sec_per_kimg', 'Timing/data', 'Timing/step_dispatch',
    'Timing/ada_sync', 'Timing/stats_sync', 'Progress/nerf_noise_std', 'Progress/blur_sigma',
    'Progress/patch/min_scale', 'Progress/patch/beta', 'Progress/kd_weight',
    'Progress/gpc_spoof_p', 'Progress/emd_multiplier', 'Progress/depth/progress',
    'Progress/augment_p', 'timestamp'} | {
    f'Camera/{tag}/{name}/{stat}' for tag in ('posterior', 'prior')
    for name in ('yaw', 'pitch', 'fov', 'radius', 'look_at_x', 'look_at_y', 'look_at_z')
    for stat in ('mean', 'std')}
LOOP_PRESET, LOOP_RES, LOOP_IMAGES = 'synth256', 256, 256  # the loop phase's run and folder
AUG_BATCH = (16, 64, 64, 4)  # one D pass of the synth256 step: batch 16 of 64^2 RGB-D patches
AUG_LIMIT = 1e-4             # pipe card vs CPU, output and VJP: max abs diff / max |CPU|
AUG_GG_LIMIT = 1e-3          # the gradient of a gradient: relative L2, as the card vs CPU check


class Recording:
    """A `Draws` that keeps every value it draws under its full name, so that
    `Replay` can hand the same values to a second run."""

    def __init__(self, draws, values):
        self.draws, self.values = draws, values

    def scope(self, name):
        return Recording(self.draws.scope(name), self.values)

    def _keep(self, name, value):
        self.values[self.draws.prefix + name] = value
        return value

    def uniform(self, name, shape):
        return self._keep(name, self.draws.uniform(name, shape))

    def normal(self, name, shape):
        return self._keep(name, self.draws.normal(name, shape))


def augment_phase(Draws, Replay):
    """The ADA pipe at p = 1 with every group on (the image filter, noise and
    cutout too), on the card against the same pipe on the CPU with the same
    draws: its output, its gradient in the images (a VJP) and an R1-style
    gradient of a gradient (a small D's first weight's gradient of
    ||d D(aug(x)) / dx||^2, D = two convolutions with softplus). Then the
    pipe's time at the synth256 step's groups and a D pass's shape: forward,
    and forward and backward (ADA's cost per plain step: Gmain's pass
    differentiates through it, Dmain's two passes do not)."""
    from tdgp_torch.config import AugmentCfg
    from tdgp_torch.training.augment import AugmentPipe
    from tdgp_torch.utils.misc import exact_fp32

    g = torch.Generator().manual_seed(0)
    x = torch.rand(AUG_BATCH, generator=g) * 2 - 1
    cot = torch.randn(AUG_BATCH, generator=g)
    w1 = torch.randn(16, AUG_BATCH[-1], 3, 3, generator=g) * 0.3
    w2 = torch.randn(1, 16, 3, 3, generator=g) * 0.3
    every = AugmentCfg(mode='ada', xflip=1.0, imgfilter=1.0, noise=1.0, cutout=1.0)
    values = {}

    def run(device, draws):
        pipe = AugmentPipe(every, device=device)
        with exact_fp32():
            img = x.to(device).requires_grad_(True)
            out = pipe(img, 1.0, draws)
            (vjp,) = torch.autograd.grad(out, img, cot.to(device))
            a = w1.to(device).requires_grad_(True)
            img = x.to(device).requires_grad_(True)
            h = torch.nn.functional.softplus(torch.nn.functional.conv2d(
                pipe(img, 1.0, draws).permute(0, 3, 1, 2), a, padding=1))
            logits = torch.nn.functional.conv2d(h, w2.to(device), padding=1).sum()
            (grad,) = torch.autograd.grad(logits, img, create_graph=True)
            (gg,) = torch.autograd.grad(grad.square().sum(), a)
        return [t.detach().cpu() for t in (out, vjp, gg)]

    AugmentPipe(every)(x, 1.0, Recording(Draws(torch.Generator().manual_seed(1)), values))
    cpu = run('cpu', Replay(values))
    card = run('cuda', Replay({k: v.cuda() for k, v in values.items()}, device='cuda'))
    torch.cuda.synchronize()
    rel = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(card[:2], cpu[:2])]
    gg_rel = float((card[2] - cpu[2]).norm() / cpu[2].norm())
    print(f'augment pipe at p = 1, every group on, {list(AUG_BATCH)}: card vs CPU, max abs diff '
          f'/ max |CPU| of the output {rel[0]:.3g} and the VJP {rel[1]:.3g} (<= {AUG_LIMIT}); '
          f'gradient of a gradient, relative L2 {gg_rel:.3g} (<= {AUG_GG_LIMIT}); '
          f'{len(values)} draws')
    check(all(e <= AUG_LIMIT for e in rel), 'the augment pipe on the card disagrees with the CPU')
    check(gg_rel <= AUG_GG_LIMIT, "the augment pipe's gradient of a gradient disagrees")

    pipe = AugmentPipe(AugmentCfg(mode='ada'), device='cuda')  # the synth256 groups
    draws = Draws(torch.Generator(device='cuda').manual_seed(2))
    img = x.cuda().requires_grad_(True)
    cot_cuda = cot.cuda()
    with exact_fp32():
        fwd_ms = cuda_ms(lambda: pipe(img.detach(), 1.0, draws), 20)
        both_ms = cuda_ms(lambda: torch.autograd.grad(pipe(img, 1.0, draws), img, cot_cuda), 20)
    per_step = both_ms + 2 * fwd_ms
    print(f'augment pipe, synth256 groups at p = 1, {list(AUG_BATCH)}: forward {fwd_ms:.3f} ms, '
          f'forward and backward {both_ms:.3f} ms; {per_step:.3f} ms per plain step (Gmain '
          f'forward and backward, Dmain two forwards)')
    return {'aug_fwd_ms': fwd_ms, 'aug_fwd_bwd_ms': both_ms, 'aug_ms_per_step': per_step}


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


SNAPSHOT_FID_LIMIT = 1e-4  # calc_metrics on the loop's snapshot vs the loop's value: relative


def snapshot_phase(run_dir, trainer, counters, fid, tmp_dir, device='cuda'):
    """The loop's own snapshot through the port's entry points: `load_run`
    with 'latest', 'best' and the snapshot's path gives the trainer's G_ema
    exactly; `scripts.inference --snapshot latest` renders a 4-seed grid
    (K3 merged and K4 as one render batch implies, K5 once per `bias_act`
    call); `scripts.export_ema` then `load_run` of the `.npz` renders the
    snapshot's images bit for bit; `scripts.calc_metrics --snapshot latest`
    at the loop's batch (16) gives the loop's fid2k_full within
    SNAPSHOT_FID_LIMIT (expected equal: the same weights, draws, detector
    and cached dataset statistics). Returns the readings."""
    from tdgp_torch import inference
    from tdgp_torch.scripts import calc_metrics, export_ema
    from tdgp_torch.scripts import inference as inference_script
    snap = os.path.join(run_dir, 'network-snapshot-000000')
    ema = trainer.G_ema.state_dict()
    t0 = time.perf_counter()
    for ref in ('latest', 'best', snap):
        _, G = inference_script.load_run(run_dir, ref, device)
        state = G.state_dict()
        check(state.keys() == ema.keys() and all(torch.equal(state[k], ema[k]) for k in ema),
              f"load_run({ref!r}) is not the trainer's G_ema")
        del G
    gc = trainer.G_ema.cfg
    chunks = (gc.img_resolution ** 2) // (gc.max_batch_res ** 2)
    reset_counts(counters)
    with BiasActCalls() as calls:
        inference_script.main(['--run-dir', run_dir, '--snapshot', 'latest', '--seeds', '0-3',
                               '--device', device,
                               '--output', os.path.join(tmp_dir, 'snapshot_grid.png')])
    torch.cuda.synchronize()
    got = launch_counts(counters)
    expected = {'triplane_splat': 0, 'ray_march_reduced': 0, 'ray_march_reduced_bwd': 0,
                'ray_march_merged': chunks, 'triplane_mlp': 2 * chunks,
                **{n: calls.count[n] for n in K5_NAMES.values()}}
    print(f'scripts.inference --snapshot latest, seeds 0-3: launches {got} (expected {expected})')
    check(got == expected, 'kernel launch counts of the snapshot grid')
    check(os.path.exists(os.path.join(tmp_dir, 'snapshot_grid.png')), 'no grid written')

    npz = export_ema.main(['--run-dir', run_dir, '--snapshot', 'latest'])
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        images = []
        for ref in ('latest', npz):
            cfg, G = inference_script.load_run(run_dir, ref, device)
            z = inference.sample_z_from_seeds(range(4), gc.z_dim, device)
            c = inference_script.class_labels(cfg, list(range(4)), None, torch.device(device))
            cams = inference.canonical_cameras(cfg, 4, G=G, z=z, c=c)
            ws = inference.sample_ws_from_seeds(G, list(range(4)), c, cams.angles)
            images.append(inference.generate(G, ws, cams, batch_size=4))
            del G
    finally:
        torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = deterministic
    check(np.array_equal(images[0], images[1]), 'the .npz export renders other images')
    print(f'export_ema -> {os.path.basename(npz)}: load_run of it renders the snapshot\'s images '
          f'bit for bit ({images[0].shape})')
    entry_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    result = calc_metrics.main(['--run-dir', run_dir, '--snapshot', 'latest', '--metrics',
                                'fid2k_full', '--batch-size', '16', '--device', device])
    metric_s = time.perf_counter() - t0
    offline = result[0]['results']['fid2k_full']
    rel = abs(offline - fid) / abs(fid)
    print(f'calc_metrics --snapshot latest: fid2k_full {offline!r} beside the loop\'s {fid!r} '
          f'(relative difference {rel:.3g}, limit {SNAPSHOT_FID_LIMIT:g}) in {metric_s:.1f} s; '
          f'load_run, the grid and the export {entry_s:.1f} s')
    check(rel <= SNAPSHOT_FID_LIMIT, "calc_metrics disagrees with the loop's fid2k_full")
    return {'snapshot_fid2k_full': offline, 'snapshot_fid_rel_diff': rel,
            'snapshot_metric_s': metric_s, 'snapshot_entry_points_s': entry_s}


def loop_phase(tmp_dir, counters, train_images_per_s):
    """`python3 -m tdgp_torch.scripts.train --preset synth256` in process on a
    256-image synthetic folder: three ticks of four steps (R1 at step 0),
    ADA reacting every tick (ada_kimg 1), a snapshot every tick, fid2k_full
    at tick 3 on 2048 images of G_ema, the image grid at tick 3; then a
    resume for one more tick. Checks stats.jsonl's keys, ADA's p against
    the controller's formula on the logged signs, the snapshot and what the
    resume restores, the metric, and each kernel's launches against what
    the loop implies. Returns the launches of the first run."""
    import importlib.util
    from tdgp_torch.scripts import train as train_script
    from tdgp_torch.utils.draws import Draws, Replay

    readings = augment_phase(Draws, Replay)
    data_dir = os.path.join(tmp_dir, 'data')
    t0 = time.perf_counter()
    subprocess.run([sys.executable, os.path.join(ROOT, 'data_scripts', 'make_synthetic_dataset.py'),
                    '--out', data_dir, '--res', str(LOOP_RES), '--n', str(LOOP_IMAGES),
                    '--classes', '4'], check=True, timeout=300)
    print(f'synthetic {LOOP_RES}^2 folder of {LOOP_IMAGES} images in '
          f'{time.perf_counter() - t0:.1f} s')
    tensorboard = importlib.util.find_spec('tensorboard') is not None
    print(f'TensorBoard installed: {tensorboard}; training.tensorboard={str(tensorboard).lower()}')
    from tdgp_torch.config import load_config
    steps_per_tick, ticks = 4, 3
    batch = load_config(preset=LOOP_PRESET).training.batch_size
    overrides = [f'dataset.path={data_dir}', f'training.tick_kimg={batch * steps_per_tick / 1e3}',
                 'training.augment.ada_kimg=1', 'training.snap=1', f'training.val_freq={ticks}',
                 f'training.image_snap={ticks}', f'training.tensorboard={str(tensorboard).lower()}']
    max_kimg = batch * steps_per_tick * ticks / 1e3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    t0 = time.perf_counter()
    with BiasActCalls() as calls:
        result = train_script.main(['--preset', LOOP_PRESET, '--run-root', tmp_dir,
                                    '--max-kimg', str(max_kimg)] + overrides)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = launch_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    cfg = result.trainer.cfg
    gc = cfg.generator
    run_dir = result.run_dir
    lines = read_jsonl(os.path.join(run_dir, 'stats.jsonl'))
    steps = steps_per_tick * ticks
    check(result.cur_nimg == batch * steps and result.batch_idx == steps,
          f'the loop stopped at {result.cur_nimg} images, step {result.batch_idx}')
    check(len(lines) == ticks, f'{len(lines)} lines in stats.jsonl')
    for i, line in enumerate(lines):
        missing = LOOP_KEYS - set(line)
        check(not missing, f'tick {i + 1} of stats.jsonl lacks {sorted(missing)}')
        check(all(np.isfinite(v['mean']) for k, v in line.items() if k.startswith('Loss/')),
              f'non-finite losses at tick {i + 1}')
    check('Loss/D/r1_penalty' in lines[0], 'no R1 in the first tick')
    a = cfg.training.augment
    p, ps = 0.0, []
    for line in lines:
        signs = line['Loss/signs/real']['mean']
        p = min(max(p + float(np.sign(signs - a.target)) * batch * a.ada_interval
                    / (a.ada_kimg * 1000), 0.0), 1.0)
        ps.append(p)
    logged = [line['Progress/augment_p']['mean'] for line in lines]
    print(f'ADA: signs/real per tick {[round(l["Loss/signs/real"]["mean"], 4) for l in lines]}, '
          f'p logged {logged}, by the formula {ps}')
    check(np.allclose(logged, ps, rtol=0, atol=1e-9), "ADA's p does not follow the controller")
    check(abs(result.ada_p - ps[-1]) <= 1e-9, 'the loop ended with another p')
    snap = os.path.join(run_dir, 'network-snapshot-000000')
    with open(snap + '.meta.json') as f:
        meta = json.load(f)
    check(os.path.exists(os.path.join(snap, 'state.pt')), 'no snapshot written')
    check(meta['cur_nimg'] == batch * steps and meta['batch_idx'] == steps
          and abs(meta['ada_p'] - ps[-1]) <= 1e-9, f'snapshot meta {meta}')
    metric = read_jsonl(os.path.join(run_dir, 'metric-fid2k_full.jsonl'))
    check(len(metric) == 1, f'{len(metric)} metric lines')
    fid = metric[0]['results']['fid2k_full']
    check(np.isfinite(fid) and 'Metrics/fid2k_full' in lines[-1]
          and not any('Metrics/eval_failed' in line for line in lines), 'fid2k_full failed')
    check(os.path.exists(os.path.join(run_dir, f'fakes{0:06d}.png')), 'no image grid written')
    chunks = (gc.img_resolution ** 2) // (gc.max_batch_res ** 2)
    # the metric renders 4 images at a time from 256^2 (its 16 below), the grid 4
    renders = 2048 // (4 if gc.img_resolution >= 256 else 16) + 16 // 4
    expected = {'triplane_splat': 2 * steps, 'ray_march_reduced': steps,
                'ray_march_reduced_bwd': steps, 'ray_march_merged': chunks * renders,
                'triplane_mlp': 2 * chunks * renders,
                **{n: calls.unrecorded[n] for n in K5_NAMES.values()}}
    print(f'loop launches over {steps} steps, fid2k_full (2048 images) and the image grid: '
          f'{launches} (expected {expected}; K5: the bias_act calls that autograd does not '
          f'record, of {dict(calls.count)} on CUDA tensors)')
    check(launches == expected, 'kernel launch counts of the loop')
    for i, line in enumerate(lines):
        print(f'tick {i + 1} host seconds: ' + ', '.join(
            f'{k[7:]} {v["mean"]:.4f} x {v["num"]}' for k, v in line.items()
            if k.startswith('Timing/')))
    sec_per_kimg = [line['Timing/sec_per_kimg']['mean'] for line in lines]
    steady = float(np.mean(sec_per_kimg[1:]))
    metric_s = metric[0]['total_time']
    readings.update(loop_sec_per_kimg=sec_per_kimg, loop_images_per_s=1e3 / steady,
                    fid2k_full=fid, metric_s=metric_s, loop_peak_gib=peak / 2 ** 30,
                    loop_s=loop_s, ada_p=ps)
    print(f'loop, {LOOP_PRESET} with ADA, batch {batch}: sec/kimg per tick '
          f'{[round(v, 2) for v in sec_per_kimg]} (tick 1 has R1 and the warm-up), '
          f'{1e3 / steady:.2f} images/s over ticks 2-3 beside '
          f'{train_images_per_s:.2f} images/s of the train phase (satellite, no ADA, no loop, at '
          f'15:1); fid2k_full {fid:.3f} in {metric_s:.1f} s; peak memory {peak / 2**30:.2f} GiB; '
          f'{loop_s:.1f} s in all')

    readings.update(snapshot_phase(run_dir, result.trainer, counters, fid, tmp_dir))

    reset_counts(counters)
    resumed = train_script.main(['--run-dir', run_dir, '--max-kimg',
                                 str(batch * (steps + steps_per_tick) / 1e3),
                                 'training.metrics=[]'])
    torch.cuda.synchronize()
    got = launch_counts(counters)
    lines = read_jsonl(os.path.join(run_dir, 'stats.jsonl'))
    print(f'resumed from {resumed.resumed_from} with {resumed.resume_meta}; stopped at '
          f'{resumed.cur_nimg} images, step {resumed.batch_idx}, p {resumed.ada_p}; launches {got}')
    check(resumed.resumed_from == snap and resumed.resume_meta == meta,
          'resume read another snapshot')
    check(resumed.cur_nimg == batch * (steps + steps_per_tick)
          and resumed.batch_idx == steps + steps_per_tick, 'the resumed loop lost its place')
    check(len(lines) == ticks + 1 and all(np.isfinite(v['mean']) for k, v in lines[-1].items()
                                           if k.startswith('Loss/')), 'the resumed tick')
    check(got['triplane_splat'] == 2 * steps_per_tick and got['ray_march_merged'] == 0,
          'kernel launch counts of the resumed tick')
    return launches, readings


SG2_BATCH = 16  # the stylegan2 preset's batch 64, cut to 16 as the satellite step's


def sg2_trainer_state(trainer):
    """A copy of everything `Trainer.step` changes: the modules, both Adams
    and `pl_mean`."""
    import copy
    return copy.deepcopy({'G': trainer.G.state_dict(), 'D': trainer.D.state_dict(),
                          'G_ema': trainer.G_ema.state_dict(), 'pl_mean': trainer.pl_mean,
                          'g_opt': trainer.g_opt.state_dict(),
                          'd_opt': trainer.d_opt.state_dict()})


def sg2_restore(trainer, state):
    """`state` back into `trainer`; the optimizers get copies (their
    `load_state_dict` keeps the tensors it is given, and Adam updates them in
    place)."""
    import copy
    for name in ('G', 'D', 'G_ema'):
        getattr(trainer, name).load_state_dict(state[name])
    trainer.g_opt.load_state_dict(copy.deepcopy(state['g_opt']))
    trainer.d_opt.load_state_dict(copy.deepcopy(state['d_opt']))
    trainer.pl_mean = state['pl_mean'].clone()


def stylegan2_check_phase(Trainer, Draws, sched, sg2_config, make_batch, overrides, card,
                          device='cuda'):
    """The 2D baseline's R1 + PL step at full width and batch SG2_BATCH with
    the config `overrides`, through K5 and through its plain version
    (`plain_versions(k5=True)`) on the same weights, Adam state and draws:
    each phase's gradient (Gmain 'g', PL 'pl', Dmain 'd', R1 'r1') per
    parameter at float32 within GRAD_LIMIT, with bf16 blocks within
    max(GRAD_LIMIT, BF16_FLOOR_FACTOR x its one-ulp floor) (`ulp_after_bias_act`:
    an ulp on every float32 `bias_act` output that autograd does not record).
    K5 runs only where autograd does not record: Dmain's fresh fakes and the
    `w_avg` pass; Gmain and PL come before both (their differences are the
    float32 atomics of the patch crop's backward). One warm-up step first,
    so that neither Adam takes its first step (+-lr whatever the gradient's
    size) in the step compared."""
    from tdgp_torch.ops import bias_act
    cfg = sg2_config(overrides)
    bf16 = not cfg.generator.fp32_only
    label = 'bf16 blocks' if bf16 else 'float32'
    trainer = Trainer(cfg, device, seed=0)
    batch = make_batch(cfg, SG2_BATCH, 2, device)
    trainer.step(batch, sched, True, Draws(torch.Generator(device=device).manual_seed(1)))
    start = sg2_trainer_state(trainer)

    def grads(plain, perturb=False):
        sg2_restore(trainer, start)
        reset_counts([bias_act.bias_act])
        with (plain_versions(k1=False, k3=False, k5=True) if plain
              else contextlib.nullcontext()), \
                (ulp_after_bias_act(device) if perturb else contextlib.nullcontext()):
            stats = trainer.step(batch, sched, True,
                                 Draws(torch.Generator(device=device).manual_seed(3)),
                                 return_grads=True)
        launched = bias_act.bias_act.launches
        check(launched == 0 if plain else launched > 0,
              f'the {"plain" if plain else "kernel"} 2D step launched K5 {launched} times')
        check(all(np.isfinite(float(v)) for k, v in stats.items() if not k.startswith('_')),
              'non-finite losses in the 2D check')
        return stats['_grads']

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref = grads(True)
        got = grads(False)
        floor = grads(True, perturb=True) if bf16 else None
    finally:
        torch.backends.cudnn.deterministic = deterministic
    del trainer, start
    readings = {}
    for ph in ('g', 'pl', 'd', 'r1'):
        rel = {n: float((got[ph][n] - r).norm() / r.norm().clamp_min(1e-30))
               for n, r in ref[ph].items()}
        fl = ({n: float((floor[ph][n] - r).norm() / r.norm().clamp_min(1e-30))
               for n, r in ref[ph].items()} if bf16 else {n: 0.0 for n in rel})
        limit = {n: max(GRAD_LIMIT, BF16_FLOOR_FACTOR * fl[n]) for n in rel}
        name = max(rel, key=lambda n: rel[n] / limit[n])
        print(f'2D {ph} gradient ({label}), K5 vs its plain version: {len(rel)} parameters, '
              f'median relative L2 difference {float(np.median(list(rel.values()))):.3g}, worst '
              f'against its limit {rel[name]:.3g} ({name}; limit {limit[name]:.3g})'
              + (f'; one-ulp floor median {float(np.median(list(fl.values()))):.3g}, max '
                 f'{max(fl.values()):.3g}' if bf16 else '') + f' [{card}]')
        check(all(rel[n] <= limit[n] for n in rel),
              f'the 2D {ph} gradient ({label}) through K5 disagrees with the plain path')
        readings[ph] = {'median': float(np.median(list(rel.values()))), 'worst': rel[name],
                        'worst_limit': limit[name]}
    return readings


def stylegan2_train_phase(Trainer, Draws, sched, cfg, make_batch, counters, label, card,
                          device='cuda'):
    """The 2D baseline's step at full width and batch SG2_BATCH, random weights
    from a seed, a synthetic batch made on the card: one warm-up R1 + PL
    step and one plain, then TRAIN_PLAIN_STEPS timed plain steps and one R1
    + PL step. Losses finite, every parameter of G and D moved; K5 launched
    once per `bias_act` call that autograd does not record, by dtype, which
    is once per call of a no-grad 2D forward of the Dmain batch, of the
    `w_avg` mapping pass and of Gmain's frozen D on the patch parameters (its
    conditioning mappings); none inside PL's and R1's recorded graphs. ms
    per plain and per R1 + PL step, images/s at 15:1, peak memory."""
    from tdgp_torch.ops import bias_act
    from tdgp_torch.training import losses, train_step
    trainer = Trainer(cfg, device, seed=0)
    batch = make_batch(cfg, SG2_BATCH, 0, device)
    draws = Draws(torch.Generator(device=device).manual_seed(1))
    trainer.step(batch, sched, True, draws)
    trainer.step(batch, sched, False, draws)
    torch.cuda.synchronize()
    modules = {'G': trainer.G, 'D': trainer.D}
    before = {k: {n: p.detach().clone() for n, p in m.named_parameters()}
              for k, m in modules.items()}
    inside = collections.Counter()
    for what in ('_pl', '_r1'):  # K5's launches inside the recorded phases
        def wrapped(*args, _fn=getattr(trainer, what), _what=what):
            n0 = bias_act.bias_act.launches
            out = _fn(*args)
            inside[_what] += bias_act.bias_act.launches - n0
            return out
        setattr(trainer, what, wrapped)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    plain_ms, history = [], []
    with BiasActCalls() as calls:
        for _ in range(TRAIN_PLAIN_STEPS):
            t0 = time.perf_counter()
            history.append(trainer.step(batch, sched, False, draws))
            torch.cuda.synchronize()
            plain_ms.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        history.append(trainer.step(batch, sched, True, draws))
        torch.cuda.synchronize()
        r1_ms = 1e3 * (time.perf_counter() - t0)
    launches = launch_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    # what one step implies: a no-grad 2D forward of the Dmain batch and the w_avg pass,
    # and Gmain's D (frozen) on the patch parameters' own mappings, whose input needs no
    # gradient
    with torch.no_grad(), BiasActCalls() as one:
        z = torch.randn(SG2_BATCH, cfg.generator.z_dim, device=device)
        c = torch.zeros(SG2_BATCH, 0, device=device)
        out, pp = losses.g_forward_2d(trainer.G, z, c, sched, cfg, Draws(torch.Generator(
            device=device).manual_seed(5)))
        trainer.G.mapping(z, c)
    with BiasActCalls() as frozen_d:
        train_step._set_requires_grad(trainer.D, False)
        losses.d_forward(trainer.D, out.img.requires_grad_(True), c, sched, cfg,
                         patch_params=pp)
        train_step._set_requires_grad(trainer.D, True)
    steps = TRAIN_PLAIN_STEPS + 1
    losses_r1 = {k: float(v) for k, v in history[-1].items()}
    print('losses of the R1 + PL step: ' + ', '.join(f'{k} {v:.4g}'
                                                    for k, v in sorted(losses_r1.items())))
    check('Loss/pl_penalty' in losses_r1 and 'Loss/D/r1_penalty' in losses_r1,
          'the R1 step ran no PL or no R1')
    check(all(np.isfinite(float(v)) for st in history for v in st.values()), 'non-finite losses')
    check(float(trainer.pl_mean) > 0, 'pl_mean did not move')
    for k, m in modules.items():
        still = [n for n, p in m.named_parameters() if torch.equal(p, before[k][n])]
        check(not still, f'parameters of the 2D {k} did not move: {still[:5]}')
    per_step = {n: one.count[n] + frozen_d.unrecorded[n] for n in K5_NAMES.values()}
    expected = {**{c.__name__: 0 for c in counters if c.__name__ != 'bias_act'},
                **{n: per_step[n] * steps for n in K5_NAMES.values()}}
    print(f'2D launches over {steps} steps: {launches} (expected {expected}: per step K5 '
          f'{per_step}, the bias_act calls of a no-grad forward of the Dmain batch and the '
          f'w_avg pass {dict(one.count)} and of Gmain\'s frozen D on the patch parameters '
          f'{dict(frozen_d.unrecorded)}; autograd did not record {dict(calls.unrecorded)} of '
          f'{dict(calls.count)}); inside PL / R1: {dict(inside)} [{card}]')
    check(launches == expected and all(calls.unrecorded[n] == expected[n]
                                       for n in K5_NAMES.values()),
          'kernel launch counts of the 2D training path')
    check(sum(inside.values()) == 0, 'K5 launched inside the recorded PL or R1 graph')
    t_plain = float(np.median(plain_ms))
    imgs_per_s = 16 * SG2_BATCH / (15 * t_plain / 1e3 + r1_ms / 1e3)
    print(f'2D StyleGAN2 step, 256^2, {label}, batch {SG2_BATCH}: plain ms '
          f'{["%.1f" % t for t in plain_ms]}, median {t_plain:.1f} ms; R1 + PL step {r1_ms:.1f} '
          f'ms; {imgs_per_s:.2f} images/s at 15:1; peak memory {peak / 2**30:.2f} GiB; K5 per '
          f'step {per_step} [{card}]')
    readings = dict(plain_ms=t_plain, r1_pl_ms=r1_ms, images_per_s=imgs_per_s,
                    peak_gib=peak / 2 ** 30, k5_per_step=per_step)
    del trainer
    torch.cuda.empty_cache()
    return launches, readings


def stylegan2_loop_phase(tmp_dir, counters, card, device='cuda', overrides=()):
    """`python3 -m tdgp_torch.scripts.train --preset stylegan2` in process on
    a LOOP_IMAGES-image 256^2 folder, batch SG2_BATCH, no metric: three ticks
    of four steps (R1 and PL at step 0), a snapshot every tick, the image
    grid at tick 3; then a resume for one more tick. The snapshot carries
    `pl_mean` and G_ema; `load_run` 'latest' gives the trainer's G_ema, and
    `scripts.export_ema`'s `.npz` loads back equal. K5 once per `bias_act`
    call that autograd does not record; no other kernel."""
    from tdgp_torch import checkpoint as ckpt
    from tdgp_torch.scripts import export_ema
    from tdgp_torch.scripts import inference as inference_script
    from tdgp_torch.scripts import train as train_script
    data_dir = os.path.join(tmp_dir, 'data')
    subprocess.run([sys.executable, os.path.join(ROOT, 'data_scripts', 'make_synthetic_dataset.py'),
                    '--out', data_dir, '--res', '256', '--n', str(LOOP_IMAGES)], check=True,
                   timeout=300)
    steps_per_tick, ticks = 4, 3
    extra = overrides
    overrides = [f'dataset.path={data_dir}', f'training.batch_size={SG2_BATCH}',
                 f'training.tick_kimg={SG2_BATCH * steps_per_tick / 1e3}', 'training.snap=1',
                 f'training.image_snap={ticks}', 'training.metrics=[]',
                 'training.tensorboard=false']
    steps = steps_per_tick * ticks
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    t0 = time.perf_counter()
    with BiasActCalls() as calls:
        result = train_script.main(['--preset', 'stylegan2', '--run-root', tmp_dir, '--device',
                                    device, '--max-kimg', str(SG2_BATCH * steps / 1e3)]
                                   + overrides + list(extra))
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = launch_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    run_dir = result.run_dir
    lines = read_jsonl(os.path.join(run_dir, 'stats.jsonl'))
    check(result.cur_nimg == SG2_BATCH * steps and result.batch_idx == steps,
          f'the 2D loop stopped at {result.cur_nimg} images, step {result.batch_idx}')
    check(len(lines) == ticks and 'Loss/pl_penalty' in lines[0]
          and 'Loss/D/r1_penalty' in lines[0], 'no R1 + PL in the first tick')
    check(all(np.isfinite(v['mean']) for line in lines for k, v in line.items()
              if k.startswith('Loss/')), 'non-finite losses in the 2D loop')
    check(os.path.exists(os.path.join(run_dir, f'fakes{0:06d}.png')), 'no 2D image grid')
    expected = {**{c.__name__: 0 for c in counters if c.__name__ != 'bias_act'},
                **{n: calls.unrecorded[n] for n in K5_NAMES.values()}}
    print(f'2D loop launches over {steps} steps and the image grid: {launches} (expected '
          f'{expected})')
    check(launches == expected, 'kernel launch counts of the 2D loop')
    snap = ckpt.snapshot_path(run_dir, 0)
    state = torch.load(os.path.join(snap, ckpt.STATE_FILE), map_location='cpu',
                       weights_only=True)
    pl_mean = float(state['pl_mean'])
    check(pl_mean > 0 and pl_mean == float(result.trainer.pl_mean) and 'G_ema' in state,
          f'the snapshot does not carry pl_mean and G_ema ({pl_mean})')
    cfg, G = inference_script.load_run(run_dir, 'latest', device=device)
    ema = result.trainer.G_ema.state_dict()
    check(type(G).__name__ == 'StyleGAN2Generator'
          and all(torch.equal(v, ema[k]) for k, v in G.state_dict().items()),
          "load_run 'latest' is not the trainer's G_ema")
    out = export_ema.main(['--run-dir', run_dir, '--snapshot', 'latest',
                           '--out', os.path.join(tmp_dir, 'g_ema.npz')])
    _, from_npz = inference_script.load_run(run_dir, out, device=device)
    check(all(torch.equal(v, ema[k]) for k, v in from_npz.state_dict().items()),
          'the exported G_ema does not load back equal')
    sec_per_kimg = [line['Timing/sec_per_kimg']['mean'] for line in lines]
    steady = float(np.mean(sec_per_kimg[1:]))
    print(f'2D loop, stylegan2, batch {SG2_BATCH}: sec/kimg per tick '
          f'{[round(v, 2) for v in sec_per_kimg]} (tick 1 has R1 + PL and the warm-up), '
          f'{1e3 / steady:.2f} images/s over ticks 2-3; pl_mean {pl_mean:.4g}; peak memory '
          f'{peak / 2**30:.2f} GiB; {loop_s:.1f} s [{card}]')

    reset_counts(counters)
    resumed = train_script.main(['--run-dir', run_dir, '--device', device, '--max-kimg',
                                 str(SG2_BATCH * (steps + steps_per_tick) / 1e3)])
    torch.cuda.synchronize()
    print(f'2D resumed from {resumed.resumed_from} with {resumed.resume_meta}; stopped at '
          f'{resumed.cur_nimg} images, step {resumed.batch_idx}')
    check(resumed.resumed_from == snap and resumed.batch_idx == steps + steps_per_tick,
          'the resumed 2D loop lost its place')
    check(float(resumed.trainer.pl_mean) == pl_mean, 'the resume did not restore pl_mean')
    return launches, dict(loop_sec_per_kimg=sec_per_kimg, loop_images_per_s=1e3 / steady,
                          loop_peak_gib=peak / 2 ** 30, loop_s=loop_s, pl_mean=pl_mean)


CUT_Q = 0.5                 # NFS's quantile cut
NFS_KERNEL_LIMIT = 1e-5     # depth maps, K3's cut entry vs its plain version: of max |depth|
NFS_CPU_LIMIT = 1e-3        # depth maps, card vs CPU at the float32 cut: abs, every pixel uncut,
NFS_CPU_SHARE = 1e-3        # ... the share of pixels beyond it with the cut (rays where a
                            # density ulps apart crosses the threshold), and
NFS_CPU_REL = 1e-4          # ... the batch's NFS: relative
METRIC_IMAGES = 256         # KID, PR, IS: generated and real images (the registry's 50,000 cut)
PPL_PAIRS = 64              # PPL: pairs (the registry's 2048 cut)


def cut_kernel_phase(ray_march, g):
    """K3's cut entry (`ray_march_merged_cut`) against its plain version at
    the served chunk [4, 16384, 32 + 32, 3] with ties and at small shapes,
    q = 0.25 and 0.5, in the four marcher settings (<= 1e-5 on every
    output); timed at the served chunk with q = 0.5 beside the merged entry
    without the cut and the threshold alone. Returns its `kernels` entry."""
    b, r, c = 4, 16384, 3
    worst = 0.0
    shapes = [(b, r, 32, 32, c)] + [(2, 300, s1, s2, cc) for cc in (1, 4)
                                    for s1, s2 in ((5, 11), (40, 24))]
    for shape in shapes:
        sets = merged_sets(g, *shape)
        for q in (0.25, CUT_Q):
            for clamp_mode, inf_depth, last_back in K3_CASES:
                opts = (clamp_mode, 1.0, inf_depth, last_back)
                out = ray_march.ray_march_merged_cut(*sets, q, *opts)
                ref = ray_march.ray_march_merged_cut_plain(*sets, q, *opts)
                torch.cuda.synchronize()
                errs = [float((a - b_).abs().max()) for a, b_ in zip(out, ref)]
                check(all(e <= 1e-5 for e in errs),
                      f'K3 cut at [B,R,S1,S2,C] = {list(shape)} q={q} {clamp_mode} '
                      f'inf_depth={inf_depth} last_back={last_back} disagrees with its plain '
                      f'version: {errs}')
                worst = max(worst, *errs)
    sets = merged_sets(g, b, r, 32, 32, c)
    clamped = torch.cat([ray_march.clamp_densities(x).reshape(-1) for x in (sets[2], sets[5])])
    threshold = ray_march.cut_threshold(sets[2], sets[5], CUT_Q)
    zeroed = int((clamped < threshold).sum())
    print(f'K3 cut at [B,R,S1,S2,C] = [{b},{r},32,32,{c}] with ties and [2,300,S1,S2,C] for '
          f'(S1, S2) = (5, 11), (40, 24), C = 1, 4, at q = 0.25 and {CUT_Q} in the '
          f'{len(K3_CASES)} settings: max abs diff {worst:.3g} (<= 1e-5); at q = {CUT_Q} the '
          f'served chunk zeroes {zeroed} of {clamped.numel()} samples (threshold '
          f'{float(threshold):.6g})')
    times = timed(f'K3 cut at [{b},{r},32+32,{c}], q = {CUT_Q}',
                  lambda: ray_march.ray_march_merged_cut(*sets, CUT_Q), 200)
    threshold_ms = cuda_ms(lambda: ray_march.cut_threshold(sets[2], sets[5], CUT_Q), 50)
    uncut_ms = cold_ms(lambda: ray_march.ray_march_merged(*sets))
    plain_ms = cuda_ms(lambda: ray_march.ray_march_merged_cut_plain(*sets, CUT_Q), 20)
    bytes_moved, flops = k3_work(b, r, 64, c)
    flops += b * r * 64 * (7 * 2 + 1)  # the merge's binary search, and the compare
    bound_ms, bound_by = bound(bytes_moved, flops)
    print(f'K3 cut at [{b},{r},32+32,{c}]: {times["cold"]:.4f} ms cold, {times["warm"]:.4f} ms '
          f'warm ({threshold_ms:.4f} ms of it the threshold, a sort of '
          f'{clamped.numel()} densities); the merged entry without the cut {uncut_ms:.4f} ms '
          f'cold; plain {plain_ms:.4f} ms; bound {1e3 * bound_ms:.1f} us '
          f'({bytes_moved / 1e6:.1f} MB by {bound_by})')
    return dict(name='ray_march_merged_cut', route='cuda', source='tdgp_torch/csrc/ray_march.cu',
                replaces='tdgp/ops/pallas_kernels.py:86',
                also_replaces='tdgp/rendering/renderer.py:54 (the quantile cut of the jnp '
                              'final march, renderer.py:151-165)',
                max_abs_err=worst, ms=times['cold'], plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, ms_warm=times['warm'],
                ms_warm_prefilled=times['warm_prefilled'], ms_cold_clean=times['cold_clean'],
                host_us=times['host_us'], threshold_ms=threshold_ms, uncut_ms=uncut_ms,
                zeroed=zeroed, samples=clamped.numel())


def depth_maps(ctx, seed=0):
    return ctx.make_depth_sampler(CUT_Q)(ctx.batch_size, seed)


def metrics_phase(ray_march, counters, data_dir, device='cuda'):
    """The rest of the metric suite on the card. K3's cut entry alone
    (`cut_kernel_phase`); nfs256 on the committed flagship at its precision
    (256 depth maps from the mean camera, the loop's folder giving the
    labels): one batch of 4 depth maps through K3's cut entry against its
    plain version (<= NFS_KERNEL_LIMIT of max |depth|; K4 and K5 alike on
    both sides, then also swapped, printed; cuDNN deterministic), one batch
    card vs CPU at the float32 cut at a 64^2 output (without the cut <=
    NFS_CPU_LIMIT everywhere; with it, the share of pixels beyond that <=
    NFS_CPU_SHARE and the batch's NFS within NFS_CPU_REL), then the metric through
    the registry with its launches counted (K3's cut entry once per ray
    chunk, K4 twice, no other K3); InceptionV3 at 299^2 and VGG16 at 224^2
    at seeded random weights, ms per batch of 16; KID, precision/recall and
    IS of METRIC_IMAGES flagship images against METRIC_IMAGES of the folder
    and PPL at PPL_PAIRS pairs (VGG16 as its detector), the counts cut from
    the registry's. Returns (the nfs256 launches, the readings, K3's cut
    entry)."""
    from tdgp_torch.config import load_config
    from tdgp_torch.data.dataset import ImageFolderDataset
    from tdgp_torch.metrics import inception, registry, vgg
    from tdgp_torch.metrics import inception_score as is_mod
    from tdgp_torch.metrics import kid as kid_mod
    from tdgp_torch.metrics import nfs as nfs_mod
    from tdgp_torch.metrics import ppl as ppl_mod
    from tdgp_torch.metrics import precision_recall as pr_mod
    from tdgp_torch.metrics.detectors import RandomProjectionDetector
    from tdgp_torch.profile_serving import FP32, OVERRIDES, RUN_DIR
    from tdgp_torch.serving import load_generator
    g = torch.Generator(device=device).manual_seed(3)
    k3_cut = cut_kernel_phase(ray_march, g)
    readings = {}
    dataset = ImageFolderDataset(data_dir, resolution=256, use_labels=True)

    def context(overrides, dev, batch_size):
        cfg = load_config(os.path.join(RUN_DIR, 'experiment_config.yaml'), overrides)
        return registry.EvalContext(cfg=cfg, G=load_generator(RUN_DIR, dev, overrides),
                                    dataset=dataset, batch_size=batch_size)

    ctx4 = context(OVERRIDES, device, 4)
    # cuDNN's deterministic algorithms: another algorithm moves a density by ulps, and a
    # sample at the threshold then changes side (a ray's last sample, marched with
    # delta 1e10, moves its depth by up to the far end)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        kernels = depth_maps(ctx4)
        again = depth_maps(ctx4)
        with plain_versions(k1=False, k3=True):
            plain = depth_maps(ctx4)
        with plain_versions(k1=False, k3=True, k4=True, k5=True):
            all_plain = depth_maps(ctx4)
        uncut = ctx4.make_depth_sampler(0.0)(4, 0)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    scale = float(plain.abs().max())

    def beyond(a, b):
        diff = (a - b).abs()
        return float(diff.max()) / scale, float((diff > NFS_KERNEL_LIMIT * scale).float().mean())

    rel, share = beyond(kernels, plain)
    rel_all, share_all = beyond(kernels, all_plain)
    print(f'flagship depth maps [4, 256, 256, 1], cut at q = {CUT_Q}, cuDNN deterministic: K3 '
          f'cut entry vs its plain version {rel:.3g} of max |depth| (<= {NFS_KERNEL_LIMIT:g}; '
          f'{share:.3g} of the pixels above); twice through the kernels '
          f'{beyond(kernels, again)[0]:.3g}; with K4 and K5 plain too {rel_all:.3g} '
          f'({share_all:.3g} of the pixels above the limit: densities ulps apart cross the '
          f'threshold); without the cut {beyond(uncut, kernels)[0]:.3g}')
    check(rel <= NFS_KERNEL_LIMIT, 'depth maps: K3 cut entry disagrees with its plain version')
    del ctx4
    small = OVERRIDES + FP32 + ['dataset.resolution=64']  # a 64^2 output (finalize_config)
    card_ctx, cpu_ctx = context(small, device, 4), context(small, 'cpu', 4)
    ray = card_ctx.cfg.camera.ray
    maps = {}
    for q in (CUT_Q, 0.0):
        maps[q] = (card_ctx.make_depth_sampler(q)(4, 0).cpu(), cpu_ctx.make_depth_sampler(q)(4, 0))
    uncut_diff = float((maps[0.0][0] - maps[0.0][1]).abs().max())
    card, cpu = maps[CUT_Q]
    cpu_diff = float((card - cpu).abs().max())
    cpu_share = float(((card - cpu).abs() > NFS_CPU_LIMIT).float().mean())
    nfs_card, nfs_cpu = (nfs_mod.compute_nfs_from_depth_maps(m[..., 0].numpy(), ray.start, ray.end)
                         for m in (card, cpu))
    nfs_rel = abs(nfs_card - nfs_cpu) / abs(nfs_cpu)
    print(f'flagship depth maps [4, 64, 64, 1], float32 cut, card vs CPU: without the cut max abs '
          f'{uncut_diff:.3g} (<= {NFS_CPU_LIMIT:g}); with the cut max abs {cpu_diff:.3g}, '
          f'{cpu_share:.3g} of the pixels beyond {NFS_CPU_LIMIT:g} (<= {NFS_CPU_SHARE:g}), the '
          f"batch's NFS {nfs_card!r} on the card, {nfs_cpu!r} on the CPU (relative "
          f'{nfs_rel:.3g}, <= {NFS_CPU_REL:g})')
    check(uncut_diff <= NFS_CPU_LIMIT and cpu_share <= NFS_CPU_SHARE and nfs_rel <= NFS_CPU_REL,
          'depth maps: the card disagrees with the CPU')
    del card_ctx, cpu_ctx

    ctx = context(OVERRIDES, device, 16)
    torch.cuda.synchronize()
    reset_counts(counters)
    t0 = time.perf_counter()
    with BiasActCalls() as calls:
        nfs = registry.nfs256(ctx)['nfs256']
    torch.cuda.synchronize()
    nfs_s = time.perf_counter() - t0
    launches = launch_counts(counters)
    gc = ctx.cfg.generator
    # one launch per ray chunk of each render call (of _resolve_batch_gpu images)
    chunks = (256 // ctx._resolve_batch_gpu()) * (gc.img_resolution ** 2) // (gc.max_batch_res ** 2)
    expected = {'ray_march_merged_cut': chunks, 'ray_march_merged': 0, 'ray_march_reduced': 0,
                'triplane_mlp': 2 * chunks, **{n: calls.count[n] for n in K5_NAMES.values()}}
    got = {k: launches.get(k) for k in expected}
    print(f'nfs256 of the flagship: {nfs!r} in {nfs_s:.1f} s; launches {launches} (expected '
          f'{expected})')
    check(np.isfinite(nfs) and nfs >= 1.0, 'nfs256 is not a score')
    check(got == expected, 'kernel launch counts of nfs256')
    readings.update(nfs256=nfs, nfs256_s=nfs_s, depth_kernel_vs_plain=rel,
                    depth_all_plain=rel_all, depth_all_plain_share=share_all,
                    depth_card_vs_cpu=cpu_diff, depth_card_vs_cpu_share=cpu_share,
                    depth_card_vs_cpu_uncut=uncut_diff, batch_nfs_card_vs_cpu=nfs_rel,
                    cut_zeroed=k3_cut['zeroed'])

    images = torch.randint(0, 256, (16, 256, 256, 3), dtype=torch.uint8, device=device,
                           generator=g)
    torch.manual_seed(0)
    incep = inception.Detector(inception.InceptionV3FID().to(device), inception.preprocess)
    vgg16 = vgg.Detector(vgg.VGG16().to(device), vgg.preprocess)
    for name, det in (('inception_v3_299', incep), ('vgg16_224', vgg16)):
        ms = cuda_ms(lambda: det(images), 10, repeats=3)
        out = det(images)
        check(bool(torch.isfinite(out).all()), f'{name}: non-finite features')
        readings[f'{name}_ms_per_16'] = ms
        print(f'{name} at seeded random weights (exact_fp32): {ms:.2f} ms per batch of 16, '
              f'features {tuple(out.shape)}')

    ctx.detector = RandomProjectionDetector(2048, device=device)
    ctx.ppl_detector = vgg16
    reset_counts(counters)
    t0 = time.perf_counter()
    real, gen = registry._all_features(ctx, METRIC_IMAGES, METRIC_IMAGES)
    kid = kid_mod.compute_kid(real, gen)
    precision, recall = pr_mod.compute_pr(real, gen, device=device)
    is_mean, is_std = is_mod.compute_is(gen)
    suite_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ppl = ppl_mod.compute_ppl(ctx.make_pair_sampler(), ctx.ppl_detector, num_samples=PPL_PAIRS,
                              batch_size=ctx.batch_size)
    torch.cuda.synchronize()
    ppl_s = time.perf_counter() - t0
    sampler_launches = launch_counts(counters)
    print(f'{METRIC_IMAGES} flagship images vs {METRIC_IMAGES} of the folder (random projection, '
          f'2048): kid {kid!r}, precision {precision!r}, recall {recall!r}, IS ({is_mean!r}, '
          f'{is_std!r}; NaN: the projection is no probability, as in the JAX package) in '
          f'{suite_s:.1f} s; ppl2_wend at {PPL_PAIRS} pairs (VGG16, random weights) {ppl!r} in '
          f'{ppl_s:.1f} s; launches {sampler_launches}. Counts reduced from 50,000 and 2048.')
    check(np.isfinite(kid) and 0 <= precision <= 1 and 0 <= recall <= 1 and np.isfinite(ppl),
          'KID, precision/recall or PPL failed')
    check(sampler_launches['ray_march_merged'] > 0 and sampler_launches['triplane_mlp'] > 0,
          'the samplers did not run the kernels')
    readings.update(kid=kid, precision=precision, recall=recall, is_mean=is_mean, is_std=is_std,
                    ppl=ppl, kid_pr_is_s=suite_s, ppl_s=ppl_s, metric_images=METRIC_IMAGES,
                    ppl_pairs=PPL_PAIRS)
    return launches, readings, k3_cut


def serve_run(G, served, requests, label):
    """Serves `requests` with `G` after one warm-up: images [4, 256, 256, 3]
    in [0, 1]; ms per request, images/s, peak memory; each kernel's launches
    held to what a request implies (K3 merged 4, K4 8, K5 once per
    `bias_act` call on a CUDA tensor, by dtype); K5's bound over a request."""
    from tdgp_torch.profile_serving import BATCH, PSI
    from tdgp_torch.serving import make_serving_fn
    gc = G.cfg
    serve = make_serving_fn(G, truncation_psi=PSI)
    serve(*requests[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(served)
    images, times = [], []
    with BiasActCalls() as calls:
        for req in requests:
            t0 = time.perf_counter()
            images.append(serve(*req))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    launches = launch_counts(served)
    peak = torch.cuda.max_memory_allocated()
    res = gc.img_resolution
    chunks = (res * res) // (gc.max_batch_res ** 2)
    n = len(requests)
    for img in images:
        check(tuple(img.shape) == (BATCH, res, res, 3), f'image shape {tuple(img.shape)}')
        check(bool(torch.isfinite(img).all()), 'non-finite pixels')
        check(float(img.min()) >= 0.0 and float(img.max()) <= 1.0, 'pixels outside [0, 1]')
    print(f'{label}: images {tuple(images[0].shape)}, mean {float(images[0].mean()):.4f}, '
          f'std {float(images[0].std()):.4f}')
    print(f'{label}: launches over {n} requests {launches}; expected K3 merged {chunks} x {n}, '
          f'K3 unmerged 0, K4 2 x {chunks} x {n}, K5 the bias_act calls on CUDA tensors by '
          f'dtype {dict(calls.count)} ({calls.strided} on tensors that are not contiguous)')
    check(launches['ray_march_merged'] == chunks * n and launches['ray_march_reduced'] == 0,
          'K3 launch counts')
    check(launches['triplane_mlp'] == 2 * chunks * n, 'K4 launch count')
    for name in K5_NAMES.values():
        check(launches[name] == calls.count[name], f'K5 launch count ({name})')
    bf16 = not gc.fp32_only
    check((launches['bias_act_bf16'] > 0) == bf16, 'K5 bf16 launches where the blocks are not '
                                                   'bf16, or none where they are')
    k5_bound_ms, by = bound(calls.bytes / n, calls.flops / n)
    per_request = {name: launches[name] / n for name in K5_NAMES.values()}
    print(f'{label}: K5 over a request {sum(per_request.values()):g} launches '
          f'({per_request["bias_act"]:g} float32 + {per_request["bias_act_bf16"]:g} bf16), bound '
          f'{k5_bound_ms:.4f} ms ({calls.bytes / n / 1e9:.3f} GB; by {by})')
    ms = [1e3 * t for t in times]
    print(f'{label}: serving batch {BATCH} at {res}x{res}: ms per request '
          f'{["%.1f" % t for t in ms]}, median {np.median(ms):.1f} ms, '
          f'{BATCH / np.median(times):.2f} images/s, peak memory {peak / 2**30:.2f} GiB')
    return dict(serve=serve, images=images, launches=launches, k5_per_request=per_request,
                ms=float(np.median(ms)),
                images_per_s=BATCH / float(np.median(times)), peak_gib=peak / 2 ** 30,
                k5_bound_ms=k5_bound_ms)


def cross_check_cpu(load_generator, make_serving_fn, G, req):
    """The card against the port on the CPU at a 64x64 output: at the float32
    cut (<= 1e-3 max abs: the convolutions sum in another order) and at the
    flagship's own precision (relative L2 <= CROSS_BF16_OF_FLOOR x the bf16
    floor, the relative L2 between the card's bf16 and float32 images: a
    float32 sum in another order flips bf16 roundings, which the following
    bf16 blocks spread)."""
    from tdgp_torch.profile_serving import FP32, OVERRIDES, PSI, RUN_DIR
    images = {}
    for label, overrides in (('bf16', OVERRIDES), ('float32', OVERRIDES + FP32)):
        card_G = G if label == 'bf16' else load_generator(RUN_DIR, 'cuda', overrides)
        card = make_serving_fn(card_G, truncation_psi=PSI, resolution=64)(*req).cpu()
        G_cpu = load_generator(RUN_DIR, 'cpu', overrides)
        cpu = make_serving_fn(G_cpu, truncation_psi=PSI, resolution=64)(*[t.cpu() for t in req])
        images[label] = card, cpu
        del G_cpu
    diff = float((images['float32'][0] - images['float32'][1]).abs().max())
    print(f'card vs CPU at 64x64, float32 cut: max abs image diff {diff:.3g}')
    check(diff <= 1e-3, 'card disagrees with the CPU at float32')

    def rel(a, b):
        return float((a - b).norm() / b.norm())
    card, cpu = images['bf16']
    floor = rel(card, images['float32'][0])
    got = rel(card, cpu)
    print(f'card vs CPU at 64x64, bf16 blocks: relative L2 {got:.4g}, bf16 floor {floor:.4g} '
          f'({got / floor:.3f} of it; limit {CROSS_BF16_OF_FLOOR}); max abs '
          f'{float((card - cpu).abs().max()):.3g}')
    check(got <= CROSS_BF16_OF_FLOOR * floor, 'card disagrees with the CPU at bf16')


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from tdgp_torch import profile_training
    from tdgp_torch.models.layers import FullyConnected, init_weights
    from tdgp_torch.ops import bias_act, cuda_build, ray_march, splat, triplane_mlp
    from tdgp_torch.profile_serving import FP32, OVERRIDES, RUN_DIR, request
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
        k3, k3_merged = kernel_phase(ray_march)

    served = [ray_march.ray_march_reduced, ray_march.ray_march_merged,
              triplane_mlp.triplane_mlp, bias_act.bias_act]
    with phase('serve', seconds):
        G = load_generator(RUN_DIR, 'cuda', OVERRIDES)  # the precision it was trained at
        dec = G.synthesis.tri_plane_decoder
        bf16_blocks = [r for r in dec.resolutions if getattr(dec, f'b{r}').dtype is not None]
        print(f'flagship decoder blocks in bf16: {bf16_blocks} (num_fp16_res '
              f'{G.cfg.num_fp16_res}, fp32_only {G.cfg.fp32_only})')
        check(bf16_blocks == [64, 128, 256, 512], 'the flagship is not served at its precision')
        requests = [request(seed, G.cfg, 'cuda') for seed in range(3)]
        serve_own = serve_run(G, served, requests, 'own precision (bf16 blocks 64-512)')
        G32 = load_generator(RUN_DIR, 'cuda', OVERRIDES + FP32)
        serve_fp32 = serve_run(G32, served, requests, 'float32 cut')
        del G32
        rel = float((serve_own['images'][0] - serve_fp32['images'][0]).norm()
                    / serve_fp32['images'][0].norm())
        print(f'served image, bf16 blocks vs float32 cut: relative L2 {rel:.4g}')
        serve = serve_own['serve']

    with phase('cross-check', seconds):
        reset_counts(served[:2])
        with plain_versions():
            plain_img = serve(*requests[0])
        check(ray_march.ray_march_merged.launches == ray_march.ray_march_reduced.launches == 0,
              'the plain path launched K3')
        diff = float((plain_img - serve_own['images'][0]).abs().max())
        print(f'card, K3 merged vs the plain merge and marcher: max abs image diff {diff:.3g}')
        check(diff <= 1e-4, 'K3 image disagrees with the plain marcher')
        del plain_img
        cross_check_cpu(load_generator, make_serving_fn, G, requests[0])

    with phase('train kernels', seconds):
        k3_bwd, k1 = train_kernel_phase(ray_march, splat)

    cfg = profile_training.train_config()
    sched = compute_schedules(cfg, profile_training.CUR_NIMG)
    with phase('train check', seconds):
        for overrides in (profile_training.FP32, ()):
            train_check_phase(Trainer, Draws, sched, profile_training.train_config,
                              profile_training.make_batch, overrides)
        fresh_image_diff = {}
        for label, overrides in (('float32', profile_training.FP32), ('bf16', ())):
            fresh_image_diff[label] = fresh_fakes_check_phase(
                Trainer, Draws, sched, profile_training.train_config, profile_training.make_batch,
                overrides)

    with phase('inference kernels', seconds):
        k4, k5, k5_bf16 = inference_kernel_phase(bias_act, triplane_mlp, FullyConnected,
                                                 init_weights)

    with phase('inference', seconds), tempfile.TemporaryDirectory() as tmp_dir:
        infer_launches = inference_phase(served, tmp_dir, RUN_DIR, OVERRIDES)

    train_counters = [splat.triplane_splat, ray_march.ray_march_reduced,
                      ray_march.ray_march_reduced_bwd, ray_march.ray_march_merged,
                      triplane_mlp.triplane_mlp, bias_act.bias_act]
    with phase('train', seconds):
        train_launches, k1_step, train_own = train_phase(
            Trainer, Draws, sched, cfg, profile_training.make_batch,
            profile_training.capture_splat_calls, profile_training.BATCH, train_counters,
            'own precision (bf16 G and D)')
        cfg32 = profile_training.train_config(profile_training.FP32)
        train_fp32_launches, _, train_fp32 = train_phase(
            Trainer, Draws, sched, cfg32, profile_training.make_batch, None,
            profile_training.BATCH, train_counters, 'float32 cut')
        train_fresh_launches, _, train_fresh = train_phase(
            Trainer, Draws, sched, profile_training.train_config(FRESH),
            profile_training.make_batch, None, profile_training.BATCH, train_counters,
            'own precision, fresh Dmain fakes (training.dmain_reuse_fakes=false)')
        for what, r in (('reused fakes', train_own), ('fresh fakes', train_fresh),
                        ('reused fakes, float32 cut', train_fp32)):
            print(f'satellite step, {what}: {r["plain_ms"]:.1f} ms per plain step, '
                  f'{r["r1_ms"]:.1f} ms per R1 step, {r["images_per_s"]:.2f} images/s at 15:1, '
                  f'peak memory {r["peak_gib"]:.2f} GiB')
    train_images_per_s = train_own['images_per_s']
    k1.update(k1_step)

    with tempfile.TemporaryDirectory() as tmp_dir:
        with phase('loop', seconds):
            loop_launches, loop_readings = loop_phase(
                tmp_dir, [splat.triplane_splat, ray_march.ray_march_reduced,
                          ray_march.ray_march_reduced_bwd, ray_march.ray_march_merged,
                          triplane_mlp.triplane_mlp, bias_act.bias_act], train_images_per_s)
        with phase('metrics', seconds):
            metrics_launches, metrics_readings, k3_cut = metrics_phase(
                ray_march, [splat.triplane_splat, ray_march.ray_march_reduced,
                            ray_march.ray_march_reduced_bwd, ray_march.ray_march_merged,
                            ray_march.ray_march_merged_cut, triplane_mlp.triplane_mlp,
                            bias_act.bias_act], os.path.join(tmp_dir, 'data'))
    sg2_counters = [splat.triplane_splat, ray_march.ray_march_reduced,
                    ray_march.ray_march_reduced_bwd, ray_march.ray_march_merged,
                    triplane_mlp.triplane_mlp, bias_act.bias_act]
    card = smi.stdout.strip()
    with phase('stylegan2', seconds), tempfile.TemporaryDirectory() as tmp_dir:
        sg2_config = functools.partial(profile_training.train_config, preset='stylegan2')
        sg2_sched = compute_schedules(sg2_config(), profile_training.CUR_NIMG)
        sg2_check = {label: stylegan2_check_phase(Trainer, Draws, sg2_sched, sg2_config,
                                                  profile_training.make_batch, overrides, card)
                     for label, overrides in (('float32', profile_training.FP32),
                                              ('bf16', ()))}
        sg2_launches, sg2_own = stylegan2_train_phase(
            Trainer, Draws, sg2_sched, sg2_config(), profile_training.make_batch, sg2_counters,
            'own precision (G 32-256 and D 64-16 in bf16)', card)
        sg2_fp32_launches, sg2_fp32 = stylegan2_train_phase(
            Trainer, Draws, sg2_sched, sg2_config(profile_training.FP32),
            profile_training.make_batch, sg2_counters, 'float32 cut', card)
        sg2_loop_launches, sg2_loop = stylegan2_loop_phase(tmp_dir, sg2_counters, card)
    by_path = {'serve': serve_own['launches'], 'serve_float32': serve_fp32['launches'],
               'inference': infer_launches, 'train': train_launches,
               'train_float32': train_fp32_launches, 'train_fresh_fakes': train_fresh_launches,
               'loop': loop_launches, 'stylegan2': sg2_launches,
               'stylegan2_float32': sg2_fp32_launches, 'stylegan2_loop': sg2_loop_launches,
               'metrics': metrics_launches}
    k5['bound_ms_per_request'] = serve_fp32['k5_bound_ms']
    k5_bf16['bound_ms_per_request'] = serve_own['k5_bound_ms']
    k5['launches_per_request'] = {'own precision': serve_own['k5_per_request']['bias_act'],
                                  'float32 cut': serve_fp32['k5_per_request']['bias_act']}
    k5_bf16['launches_per_request'] = {'own precision':
                                       serve_own['k5_per_request']['bias_act_bf16']}
    for k in (k3, k3_merged, k3_cut, k3_bwd, k1, k4, k5, k5_bf16):
        k['launches_by_path'] = {path: got.get(k['name'], 0) for path, got in by_path.items()}
        k['launches'] = sum(k['launches_by_path'].values())

    print(f'phases (s): {json.dumps({k: round(v, 1) for k, v in seconds.items()})}, '
          f'total {time.perf_counter() - t_start:.1f} s')
    print(f'loop: {json.dumps(loop_readings)}')
    train_readings = {'reused_fakes': train_own, 'fresh_fakes': train_fresh,
                      'reused_fakes_float32': train_fp32, 'fresh_fake_image_diff': fresh_image_diff}
    print(f'train: {json.dumps(train_readings)}')
    sg2_readings = {'card': card, 'own': sg2_own, 'float32': sg2_fp32, 'loop': sg2_loop,
                    'check': sg2_check}
    print(f'stylegan2: {json.dumps(sg2_readings)}')
    print(f'metrics: {json.dumps(metrics_readings)}')
    print(json.dumps({'kernels': [k3, k3_merged, k3_cut, k3_bwd, k1, k4, k5, k5_bf16]}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
