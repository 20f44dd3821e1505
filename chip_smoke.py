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
                  the floor is the difference the plain path shows when K3's
                  outputs, the rendered patch and the depth, are changed by one
                  float32 ulp (x (1 + 2^-24 n), n ~ N(0, 1)), measured in the
                  same run.
                  With bf16 blocks the floor is also at least K3's own float32
                  spread: the plain path with K3's plain version summed in
                  float64 and rounded once.
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
 10. metrics:     the rest of the metric suite (`metrics_phase`). First the quantile
                  threshold's select kernel (`threshold_kernel_phase`:
                  `cut_threshold` and `quantile` on CUDA tensors, csrc/quantile.cu)
                  against the sort bit for bit (a zero of either sign as a zero) at the
                  served chunk [4, 16384, 32 + 32] (raw densities, float32 and bf16
                  loads, softplus and relu), the coarse chunk [4, 16384, 32] (clamped,
                  float32 and bf16) and small shapes (ties, all equal, a NaN, one value,
                  ±0, one top bin, relu's zeros, two sets of different sizes), q = 0.25,
                  0.5, 1; its in-kernel clamp against F.softplus bit for bit; timed cold
                  and warm beside the sort, torch.quantile and its bound. K3's cut entry
                  (`ray_march_merged_cut`: the merged march with NFS's quantile cut,
                  the threshold the select) against its plain version (the sort) at
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
                  registry: the value, its seconds, K3's cut entry once, the select
                  twice (the coarse and the final march) and K4 twice per ray chunk,
                  no other K3, the sort never (`SortCalls`), K5 once per bias_act call.
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
 12. the bf16 render views (PR 14), inside the phases above: 'render bf16 kernels'
                  (after 6: `render_bf16_kernel_phase`) holds K4's bf16 entry at the
                  served shape (a share of outputs one bf16 ulp apart, all within one ulp
                  at the outputs' scale: where the bias add cancels the product, a flip
                  of the product is many ulps of the output; also at both widths with
                  partial warp tiles, `k4_bf16_small_shapes`), K3's merged and cut entries
                  with bf16 loads at the served chunk and at the fresh fakes' training
                  shape with float32 densities (<= 1e-5) and K1's bf16 entry at the
                  step's points (its float32 sums <= 1e-5 x max, the stored bf16 gradient
                  within one ulp of the texel plus that, alone and with the other pass's
                  addend), each timed warm and cold beside its bound and its float32
                  sibling; 'serve render_bf16' (after 3: `render_bf16_serve_phase`)
                  serves the flagship with generator.render_bf16=true (K3 merged bf16 4,
                  K4 bf16 8 per request, the float32 entries never), beside the default
                  render, its density grid through the float32 K4, the image kernels vs
                  plain (cuDNN deterministic) and card vs CPU as a share of the floor; the
                  train check (5) also holds Gmain's gradient through the
                  gmain_render_bf16 view and Dmain's with the dmain_fake_bf16 view's
                  fresh fakes; the train phase (8) times the step with each view (K1 bf16
                  2 per step; K3 merged bf16 1 and K4 bf16 2 per Dmain microbatch); the
                  metrics phase (10) renders one nfs256 batch under render_bf16 (K3's cut
                  entry with bf16 loads vs plain). The inference phase (7) holds the
                  density grid at the flagship's own precision too (`density_grid_own_precision`).
 13. settings:    the settings the JAX package trains and earlier slices refused
                  (`settings_*_phase`, after 10, on the loop's folder). The satellite
                  step with SETTINGS (loss.r1_remat, G's grad_clip at SETTINGS_CLIP,
                  D's camera_cond, the Fourier camera encoding, discrete_uniform
                  patches of four scales, two of them masked, hybrid origin angles with
                  the force-mean regularizer off): the train check (5) with the
                  preset's bf16 blocks and at the float32 cut; SETTINGS_STEPS
                  steps at batch 16 at its own precision, the last with R1: each
                  step's clip factor (one at least below 1), losses finite, K1 2,
                  K3 and its backward 1 per step, K5 once per bias_act
                  call that autograd does not record, no other launch; one R1 step
                  with and without r1_remat from the same weights, batch and draws,
                  cuDNN deterministic: R1's gradients within GRAD_LIMIT (relative L2
                  per parameter) and the peak memory of each R1 phase. Then the
                  flagship's width (256^2, tri-planes 3 x 512^2 x 32, batch 4) with
                  random weights from a seed at the float32 cut: a 3-layer MLP (as its
                  layers; K3 merged 4 per request, K4 0) and the mip marcher (marched
                  in PyTorch: K3 0; K4 8, the MipNeRF clamp after it), each through the
                  kernels vs plain (<= 1e-4, cuDNN deterministic) and card vs CPU at
                  64^2 (<= 1e-3). Then one tick of four steps of `scripts.train
                  --preset synth256` with 'custom' origin angles from the folder
                  (training.learn_camera_dist=false): the angles reach every step.
                  The train check's one-ulp floor (5, 13) is, per parameter, the
                  largest over the perturbations FLOOR_SEEDS, each of the rendered
                  patch and of K3's depth where it enters the depth adaptor; the
                  distance is also printed against the limits of the first seed's
                  perturbation of the patch alone.
 14. pl:          path-length regularization of the 3DGP model (after 13,
                  `pl_*_phase`). K3's second-order entry (`ray_march_reduced_bwd_bwd`) at
                  PL's render shape [8, 4096, 32 + 32, 3] in the four settings, with and
                  without a depth cotangent, and K1's second-order entries
                  (`triplane_splat_gather`, `triplane_splat_dcoords`) at planes
                  [24, 512, 512, 32] and 8 x 64^2 x 32 points, with and without a
                  coordinate cotangent, and at small shapes with points on texel edges,
                  against their plain versions (autograd through the first-order plain
                  versions; K3's with its last sample near opaque against the plain
                  version in float64): each output <= PL_KERNEL_LIMIT x its largest
                  (K3's four per-ray totals one scale); timed beside the plain versions
                  and their bounds (K3's second order with the calls enqueued ahead,
                  since back to back its calls measure the host; also back to back and
                  cold). PL's G
                  gradient (`Trainer._pl` alone, after a warm-up R1 + PL step, batch
                  PL_CHECK_BATCH) through the kernels and through their
                  plain versions, per parameter at the float32 cut within
                  max(GRAD_LIMIT, 2 x its floor), with the preset's bf16 blocks within
                  max(GRAD_LIMIT, BF16_FLOOR_FACTOR x its floor); the floor the largest
                  of the plain path run again and FLOOR_SEEDS' perturbations of an ulp
                  on K1's and K3's first-order outputs (`first_order_ulp`): the camera
                  adaptor's PL gradient cancels, and the plain path against itself
                  moves it by ~2e-2. The penalty finite, `pl_mean` moved. Then the
                  satellite step with `loss.pl_weight=2` at batch 16 (PL at 8), at its
                  own precision and at the float32 cut: PL_PLAIN_STEPS plain steps and
                  one R1 + PL step, the launches held to what they imply (K3's second
                  order 1 and K1's gather 2 per R1 + PL step; its scatter 0: PL gives no
                  coordinate cotangent), ms per plain, R1 + PL and R1 step, and the peak
                  memory that PL adds.
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
import dataclasses
import functools
import itertools
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
FLOOR_SEEDS = (9, 10, 11, 12)  # the train check's one-ulp floor: the max over these perturbations


@contextlib.contextmanager
def plain_versions(k1=True, k3=True, k4=False, k5=False):
    """The generator with the plain PyTorch versions of K1 (backward), K3
    (forward and backward, the merged forward, its cut entry, and the coarse
    march's quantile threshold: the sort in place of the select), K4 and K5
    in place of the kernels' wrappers, on the card: the reference the
    kernels' path is held against."""
    from tdgp_torch.models import epigraf, layers, stylegan2
    from tdgp_torch.ops import bias_act, ray_march, splat, triplane_mlp
    from tdgp_torch.rendering import renderer
    saved = (epigraf.triplane_sample, epigraf.triplane_sample_pair, renderer.ray_march_reduced,
             renderer.ray_march_merged, renderer.ray_march_merged_cut, renderer.quantile,
             epigraf.triplane_mlp, layers.bias_act, stylegan2.bias_act)
    if k1:
        epigraf.triplane_sample = splat.triplane_sample_reference
        epigraf.triplane_sample_pair = splat.triplane_sample_pair_reference
    if k3:
        renderer.ray_march_reduced = ray_march.ray_march_reduced_reference
        renderer.ray_march_merged = ray_march.ray_march_merged_plain
        renderer.ray_march_merged_cut = ray_march.ray_march_merged_cut_plain
        renderer.quantile = ray_march.quantile_plain  # the coarse march's threshold
    if k4:
        def mlp_plain(feats, *weights):  # K4's plain version of the features' dtype
            if feats.dtype == torch.bfloat16:
                return triplane_mlp.triplane_mlp_plain_bf16(feats, *weights)
            return triplane_mlp.triplane_mlp_plain(feats, *weights)
        epigraf.triplane_mlp = mlp_plain
    if k5:
        layers.bias_act = stylegan2.bias_act = bias_act.bias_act_plain
    try:
        yield
    finally:
        (epigraf.triplane_sample, epigraf.triplane_sample_pair, renderer.ray_march_reduced,
         renderer.ray_march_merged, renderer.ray_march_merged_cut, renderer.quantile,
         epigraf.triplane_mlp, layers.bias_act, stylegan2.bias_act) = saved


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
    BF16_FLOOR_FACTOR x its floor), since a float32 ulp of the rendered
    patch can flip a bf16 rounding in D's and the decoder's backward. With
    bf16 blocks the floor is the larger of the one-ulp floor and K3's own
    float32 spread (its plain version summed exactly, in float64): K3's
    sums in another order move its outputs by more than an ulp, which
    reach D's bf16 blocks through the patch and the depth adaptor and,
    through the gmain_render_bf16 view, the bf16 MLP's backward, whose
    flipped roundings the coordinate gradient then spreads. Through the
    view K1's bf16 entry alone is held to the one-ulp floor. K1 and K3
    alone against plain are printed. The one-ulp floor of each
    parameter is the largest of FLOOR_SEEDS' perturbations of both of K3's
    outputs that G reads: the rendered patch and the depth that enters the
    depth adaptor (a single perturbation is one sample of a heavy-tailed
    statistic, and a perturbation of the patch reaches the depth adaptor
    only after it). The distance is also set against the limits of the
    single perturbation of the patch alone (seed FLOOR_SEEDS[0]; through
    the view with K3's spread, as before), printed. Returns the distances,
    both floors' medians and maxima, and K3's spread."""
    from tdgp_torch.models import epigraf
    from tdgp_torch.training import losses
    g_forward, importance_render = losses.g_forward, epigraf.importance_render

    def ulp(t, seed):  # t changed by about one float32 ulp: x (1 + 2^-24 n), n ~ N(0, 1)
        g = torch.Generator(device=device).manual_seed(seed)
        return t * (1 + 2.0 ** -24 * torch.randn(t.shape, device=device, generator=g))

    def one_ulp(seed, depth):  # -> the forward and the render, perturbed
        def render(*args, **kwargs):
            out, pp = g_forward(*args, **kwargs)
            return type(out)(img=ulp(out.img, seed), depth=out.depth, angles=out.angles), pp

        def march(*args, **kwargs):
            rgb, d, *rest = importance_render(*args, **kwargs)
            return (rgb, ulp(d, seed + 1000), *rest)
        return render, march if depth else importance_render

    bf16 = not train_config(overrides).generator.fp32_only
    view = train_config(overrides).training.gmain_render_bf16
    label = ('bf16 blocks' if bf16 else 'float32') + (', the render_bf16 view' if view else '')
    from tdgp_torch.ops import ray_march
    k3_plain_fns = ray_march.ray_march_reduced_plain, ray_march.ray_march_reduced_bwd_plain

    def in_float64(fn):  # K3's plain version summed in float64, rounded once to float32
        def run(*args, **kwargs):
            args = [a.double() if torch.is_tensor(a) else a for a in args]
            return tuple(t.float() for t in fn(*args, **kwargs))
        return run

    def gmain_grads(k1_plain, k3_plain, perturb=None, k3_exact=False):
        """`perturb`: None or (seed, whether the depth too)."""
        cfg = train_config(list(overrides) + ['generator.use_noise=false'])
        trainer = Trainer(cfg, device, seed=0)
        if perturb is not None:
            losses.g_forward, epigraf.importance_render = one_ulp(*perturb)
        if k3_exact:
            (ray_march.ray_march_reduced_plain,
             ray_march.ray_march_reduced_bwd_plain) = map(in_float64, k3_plain_fns)
        try:
            with plain_versions(k1_plain, k3_plain):
                stats = trainer.step(make_batch(cfg, 4, 2, device), sched, False,
                                     Draws(torch.Generator(device=device).manual_seed(3)),
                                     return_grads=True)
        finally:
            losses.g_forward, epigraf.importance_render = g_forward, importance_render
            ray_march.ray_march_reduced_plain, ray_march.ray_march_reduced_bwd_plain = k3_plain_fns
        return stats['_grads']['g']

    def rel_l2(a, b):
        return {n: float((a[n] - r).norm() / r.norm().clamp_min(1e-30)) for n, r in b.items()}

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref = gmain_grads(True, True)
        rel = rel_l2(gmain_grads(False, False), ref)
        floor_single = rel_l2(gmain_grads(True, True, perturb=(FLOOR_SEEDS[0], False)), ref)
        floors = [rel_l2(gmain_grads(True, True, perturb=(seed, True)), ref)
                  for seed in FLOOR_SEEDS]
        floor = {n: max(f[n] for f in floors) for n in ref}
        k1_alone = rel_l2(gmain_grads(False, True), ref)
        k3_alone = rel_l2(gmain_grads(True, False), ref)
        if bf16:
            # K3's own float32 spread: its plain version exact (float64, rounded once)
            floor_k3 = rel_l2(gmain_grads(True, True, k3_exact=True), ref)
            for what, r in (('K1 alone', k1_alone), ('K3 alone', k3_alone),
                            ("K3's plain version exact", floor_k3)):
                worst = max(r, key=r.get)
                print(f'Gmain gradient ({label}), {what} vs plain: median '
                      f'{float(np.median(list(r.values()))):.3g}, max {r[worst]:.3g} ({worst})')
            if view:
                check(all(k1_alone[n] <= max(GRAD_LIMIT, BF16_FLOOR_FACTOR * floor[n])
                          for n in k1_alone),
                      'the Gmain gradient through K1 bf16 alone disagrees with the plain path')
                floor_single = {n: max(floor_single[n], floor_k3[n]) for n in floor}
            floor = {n: max(floor[n], floor_k3[n]) for n in floor}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    def limits(fl):
        if bf16:
            return {n: max(GRAD_LIMIT, BF16_FLOOR_FACTOR * fl[n]) for n in rel}
        return {n: min(RAISED_LIMIT_CAP, max(GRAD_LIMIT, 2 * fl[n]))
                if n.startswith(DEPTH_ADAPTOR) else GRAD_LIMIT for n in rel}

    if not bf16:
        for what, r in (('K1 alone', k1_alone), ('K3 alone', k3_alone)):
            worst = max(r, key=r.get)
            print(f'Gmain gradient, {what} vs plain: median relative L2 difference '
                  f'{float(np.median(list(r.values()))):.3g}, max {r[worst]:.3g} ({worst})')
        check(max(k1_alone.values()) <= GRAD_LIMIT,
              'the Gmain gradient through K1 alone disagrees with the plain path')
    limit, limit_single = limits(floor), limits(floor_single)
    worst_single = max(rel, key=lambda n: rel[n] / limit_single[n])
    print(f'Gmain gradient ({label}), one-ulp floor: the single perturbation of the patch '
          f'(seed {FLOOR_SEEDS[0]}) median {float(np.median(list(floor_single.values()))):.3g}, '
          f'max {max(floor_single.values()):.3g}; the per-parameter max over {len(FLOOR_SEEDS)} '
          f'perturbations of the patch and the depth (seeds {list(FLOOR_SEEDS)}) median '
          f'{float(np.median(list(floor.values()))):.3g}, max {max(floor.values()):.3g}; '
          f'kernels vs plain against the single floor\'s limits: worst {rel[worst_single]:.3g} '
          f'({worst_single}; limit {limit_single[worst_single]:.3g}), '
          f'{"within" if all(rel[n] <= limit_single[n] for n in rel) else "beyond"} them')
    name = max(rel, key=lambda n: rel[n] / limit[n])
    over = {n: f'{rel[n]:.3g} (limit {limit[n]:.3g}, floor {floor[n]:.3g})'
            for n in sorted(rel) if rel[n] > GRAD_LIMIT}
    print(f'Gmain gradient ({label}), kernels vs plain versions: {len(rel)} parameters, median '
          f'relative L2 difference {float(np.median(list(rel.values()))):.3g}, worst against its '
          f'limit {rel[name]:.3g} ({name}; limit {limit[name]:.3g}); floor of the step: '
          f'median {float(np.median(list(floor.values()))):.3g}, max {max(floor.values()):.3g} '
          f'({max(floor, key=floor.get)}); above {GRAD_LIMIT:g}: {over}')
    check(all(rel[n] <= limit[n] for n in rel),
          f'the Gmain gradient ({label}) through the kernels disagrees with the plain path')
    worst_single_limit = max(rel[n] / limit_single[n] for n in rel)
    return dict(median=float(np.median(list(rel.values()))), worst=rel[name], worst_param=name,
                worst_of_limit=rel[name] / limit[name], worst_of_single_limit=worst_single_limit,
                floor_single_median=float(np.median(list(floor_single.values()))),
                floor_single_max=max(floor_single.values()),
                floor_median=float(np.median(list(floor.values()))),
                floor_max=max(floor.values()),
                k3_spread_max=max(floor_k3.values()) if bf16 else None,
                within_single=all(rel[n] <= limit_single[n] for n in rel))


FRESH = ['training.dmain_reuse_fakes=false']  # Dmain renders fresh fakes, without gradients
GMAIN_BF16 = ['training.gmain_render_bf16=true']  # Gmain renders through the render_bf16 view
FAKE_BF16 = ['training.dmain_fake_bf16=true']     # ... and Dmain's fresh fakes through the all-bf16 one


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
    view = cfg.training.dmain_fake_bf16
    bf16 = view or not cfg.generator.fp32_only
    label = ('the dmain_fake_bf16 view' if view else 'bf16 blocks') if bf16 else 'float32'
    counters = ([ray_march.ray_march_merged_bf16, triplane_mlp.triplane_mlp_bf16]
                if view else [ray_march.ray_march_merged, triplane_mlp.triplane_mlp])
    counters.append(bias_act.bias_act)
    if view:
        reset_counts([ray_march.ray_march_merged, triplane_mlp.triplane_mlp])

    def dmain_grads(plain, perturb=False):
        trainer = Trainer(cfg, device, seed=0)
        batch = make_batch(cfg, 4, 2, device)
        losses.g_forward = fake_render((plain, perturb))
        reset_counts(counters)
        try:
            with (plain_versions(k1=True, k3=True, k4=True, k5=True) if plain
                  else contextlib.nullcontext()), \
                    (ulp_after_bias_act(device) if perturb else contextlib.nullcontext()), \
                    exact_fp32():
                trainer._dmain(batch, sched, Draws(torch.Generator(device=device).manual_seed(3)),
                               1, lambda name, value: None, None, None)
        finally:
            losses.g_forward = g_forward
        launched = tuple(c.launches for c in counters)
        check(not any(launched) if plain else all(launched),
              f'the {"plain" if plain else "kernel"} fresh-fake render launched K3 merged, K4, '
              f'K5 {launched}')
        if view:
            check(ray_march.ray_march_merged.launches == triplane_mlp.triplane_mlp.launches == 0,
                  "the bf16 view's fresh fakes launched the float32 K3 merged or K4")
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


BF16_FLOPS = 989e12         # H100 SXM dense bf16 on the tensor cores, NVIDIA data sheet


def k4_bf16_small_shapes(triplane_mlp, g):
    """K4's bf16 entry against its plain version at both widths it is built
    for, (32, 64, 4) and (16, 32, 4), with point counts that leave a warp's
    tile of 32 partial (1, 33, 1000, 40001): at most one bf16 ulp at the
    outputs' scale. Returns the largest difference over that ulp."""
    worst = 0.0
    for f, hid in ((32, 64), (16, 32)):
        w = [(torch.randn(f, hid, device='cuda', generator=g) / f ** 0.5).to(torch.bfloat16),
             (torch.randn(hid, device='cuda', generator=g) * 0.1).to(torch.bfloat16),
             (torch.randn(hid, 4, device='cuda', generator=g) / hid ** 0.5).to(torch.bfloat16),
             (torch.randn(4, device='cuda', generator=g) * 0.1).to(torch.bfloat16)]
        for p in (1, 33, 1000, 40001):
            feats = torch.randn(1, p, f, device='cuda', generator=g).to(torch.bfloat16)
            got, ref = triplane_mlp.triplane_mlp(feats, *w), triplane_mlp.triplane_mlp_plain_bf16(feats, *w)
            torch.cuda.synchronize()
            scale_ulp = max(float(r.float().abs().max()) for r in ref) * 2.0 ** -7
            err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref))
            check(err <= scale_ulp, f'K4 bf16 at [1,{p},{f}] -> {hid} -> 4 disagrees with its plain '
                                    f'version: {err:.3g} (one ulp of the scale {scale_ulp:.3g})')
            worst = max(worst, err / scale_ulp)
    print(f'K4 bf16 at (F, HID) = (32, 64), (16, 32) and 1, 33, 1000, 40001 points: at most '
          f'{worst:.3g} of one bf16 ulp at the outputs\' scale')
    return worst


def render_bf16_kernel_phase(ray_march, splat, triplane_mlp, FullyConnected, init_weights):
    """The bf16 entries of the bf16 render views (`generator.render_bf16`)
    against their plain versions on the same inputs, timed warm and cold
    beside their bounds and their float32 siblings:
      - K4's bf16 entry at the served shape [4, 524288, 32] -> 64 -> 4:
        every output within one bf16 ulp, the share one ulp apart printed;
      - K3's merged entry with bf16 loads at the served chunk [4, 16384,
        32 + 32, 3] (ties), its cut entry there (q = 0.5), and the merged
        entry with float32 densities at the training shape of Dmain's fresh
        fakes [16, 4096, 32 + 32, 3] (jittered): <= 1e-5 on every output;
      - K1's bf16 entry at the training step's points (16 x 64^2 x 32, planes
        48 x 512^2 x 32): its float32 sums (`round_out=False`) <= 1e-5 x max
        |plain|, its stored bf16 gradient within one bf16 ulp, with and
        without the other pass's addend, g_coords <= 1e-5 x max |plain|.
    Returns the three entries' `kernels` records (K3 merged and its cut
    entry as two)."""
    bf = torch.bfloat16
    g = torch.Generator(device='cuda').manual_seed(5)
    cpu_gen = torch.Generator().manual_seed(5)
    out = []

    # K4 bf16
    n, p, f, hid, o = 4, 16384 * 32, 32, 64, 4
    fc0, fc1 = FullyConnected(f, hid, activation='lrelu'), FullyConnected(hid, o)
    for fc in (fc0, fc1):
        init_weights(fc, cpu_gen)
        with torch.no_grad():
            fc.bias.copy_(torch.randn(fc.bias.shape, generator=cpu_gen) * 0.1)
    fc0, fc1 = fc0.cuda(), fc1.cuda()
    feats32 = torch.randn(n, p, f, device='cuda', generator=g)
    feats = feats32.to(bf)
    with torch.no_grad():
        w16 = (*triplane_mlp.fold_fully_connected(fc0, bf),
               *triplane_mlp.fold_fully_connected(fc1, bf))
        w32 = (*triplane_mlp.fold_fully_connected(fc0), *triplane_mlp.fold_fully_connected(fc1))
        got = triplane_mlp.triplane_mlp(feats, *w16)
        ref = triplane_mlp.triplane_mlp_plain_bf16(feats, *w16)
        torch.cuda.synchronize()
        check(all(t.dtype == bf for t in got), 'K4 bf16 returned another dtype')
        ulps = torch.cat([bf16_ulps(a, b).reshape(-1) for a, b in zip(got, ref)])
        share = float((ulps > 0).float().mean())
        worst = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref))
        scale_ulp = max(2.0 ** (np.floor(np.log2(float(b.float().abs().max()))) - 7) for b in ref)
        print(f'K4 bf16 at [{n},{p},{f}] -> {hid} -> {o}: {share:.3g} of the outputs differ from '
              f'its plain version (the float32 sums in another order flip a bf16 rounding), at '
              f'most {int(ulps.max())} ulps of the output (where the bias add cancels the '
              f'product), max abs diff {worst:.3g} against one bf16 ulp at the outputs\' scale '
              f'{scale_ulp:.3g}')
        check(share <= 1e-3 and worst <= scale_ulp, 'K4 bf16 disagrees with its plain version')
        k4_bf16_small_shapes(triplane_mlp, g)
        fn16 = lambda: triplane_mlp.triplane_mlp(feats, *w16)  # noqa: E731
        fn32 = lambda: triplane_mlp.triplane_mlp(feats32, *w32)  # noqa: E731
        times = {label: dict(warm=cuda_ms(fn, 50), cold=cold_ms(fn))
                 for label, fn in (('bf16', fn16), ('float32', fn32))}
        plain_ms = cuda_ms(lambda: triplane_mlp.triplane_mlp_plain_bf16(feats, *w16), 10)
    t = n * p
    bytes_moved = 2 * (t * (f + o) + f * hid + hid + hid * o + o)
    flops = t * (2 * f * hid + 2 * hid * o)
    bound_ms, bound_by = bound(bytes_moved, flops, BF16_FLOPS)
    print(f'K4 bf16: warm {times["bf16"]["warm"]:.4f} ms, cold {times["bf16"]["cold"]:.4f} ms; '
          f'float32 K4 warm {times["float32"]["warm"]:.4f} ms, cold '
          f'{times["float32"]["cold"]:.4f} ms; plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms '
          f'(by {bound_by}: {bytes_moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP at bf16) '
          f'(sm, mem clocks {clocks()})')
    out.append(dict(name='triplane_mlp_bf16', route='cuda', source='tdgp_torch/csrc/triplane_mlp.cu',
                    replaces='tdgp/ops/pallas_kernels.py:305',
                    max_abs_err=worst, max_ulps=int(ulps.max()), ulp_share=share,
                    ms=times['bf16']['warm'], cold_ms=times['bf16']['cold'], plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                    float32_ms=times['float32']['warm'], float32_cold_ms=times['float32']['cold']))
    del feats, feats32, got, ref

    # K3 merged and cut with bf16 loads
    def to_bf16(sets, densities=True):
        return tuple(x.to(bf) if i in (1, 4) or (densities and i in (2, 5)) else x
                     for i, x in enumerate(sets))

    b, r, s1, s2, c = 4, 16384, 32, 32, 3
    served32 = merged_sets(g, b, r, s1, s2, c)
    served = to_bf16(served32)
    train = to_bf16(train_merged_sets(g, 16, 4096, s1, s2, c), densities=False)
    worst, worst_cut = 0.0, 0.0
    for label, sets in (('served', served), ('training, float32 densities', train)):
        for clamp_mode, inf_depth, last_back in K3_CASES:
            opts = (clamp_mode, 1.0, inf_depth, last_back)
            got = ray_march.ray_march_merged(*sets, *opts)
            ref = ray_march.ray_march_merged_plain(*sets, *opts)
            torch.cuda.synchronize()
            err = max(float((a - b_).abs().max()) for a, b_ in zip(got, ref))
            check(err <= 1e-5, f'K3 merged bf16 ({label}, {opts}) disagrees with its plain '
                               f'version: {err:.3g}')
            worst = max(worst, err)
            if label == 'served':
                for q in (0.25, 0.5):
                    got = ray_march.ray_march_merged_cut(*sets, q, *opts)
                    ref = ray_march.ray_march_merged_cut_plain(*sets, q, *opts)
                    torch.cuda.synchronize()
                    err = max(float((a - b_).abs().max()) for a, b_ in zip(got, ref))
                    check(err <= 1e-5, f'K3 cut bf16 (q {q}, {opts}) disagrees: {err:.3g}')
                    worst_cut = max(worst_cut, err)
    print(f'K3 merged with bf16 loads at [{b},{r},{s1}+{s2},{c}] (ties) and [16,4096,32+32,3] '
          f'(float32 densities), four settings: max abs diff {worst:.3g}; its cut entry at q = '
          f'0.25, 0.5: {worst_cut:.3g} (<= 1e-5)')
    k3 = {}
    for name, fn16, fn32 in (
            ('ray_march_merged_bf16', lambda: ray_march.ray_march_merged(*served),
             lambda: ray_march.ray_march_merged(*served32)),
            ('ray_march_merged_cut_bf16', lambda: ray_march.ray_march_merged_cut(*served, 0.5),
             lambda: ray_march.ray_march_merged_cut(*served32, 0.5))):
        k3[name] = {label: dict(warm=cuda_ms(fn, 200, prefill=True), cold=cold_ms(fn),
                                cold_clean=cold_ms(fn, clean=True))
                    for label, fn in (('bf16', fn16), ('float32', fn32))}
    plain_ms = cuda_ms(lambda: ray_march.ray_march_merged_plain(*served), 20)
    plain_cut_ms = cuda_ms(lambda: ray_march.ray_march_merged_cut_plain(*served, 0.5), 10)
    rays, s = b * r, s1 + s2
    bytes_moved = rays * s * (4 + 2 * c + 2) + 4 * rays * (c + 3)
    flops = rays * s * (2 * c + 14)
    bound_ms, bound_by = bound(bytes_moved, flops)
    for name, times in k3.items():
        print(f'{name} at [{b},{r},{s1}+{s2},{c}]: ' + '; '.join(
            f'{label} ' + ', '.join(f'{k} {v:.4f} ms' for k, v in tv.items())
            for label, tv in times.items()) + f'; bound {bound_ms:.4f} ms (by {bound_by}: '
            f'{bytes_moved / 1e6:.1f} MB) (sm, mem clocks {clocks()})')
        out.append(dict(name=name, route='cuda', source='tdgp_torch/csrc/ray_march.cu',
                        replaces='tdgp/ops/pallas_kernels.py:136',
                        max_abs_err=worst if 'cut' not in name else worst_cut,
                        ms=times['bf16']['warm'], cold_ms=times['bf16']['cold'],
                        cold_clean_ms=times['bf16']['cold_clean'],
                        plain_ms=plain_cut_ms if 'cut' in name else plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                        float32_ms=times['float32']['warm'],
                        float32_cold_ms=times['float32']['cold']))
    del served, served32, train

    # K1 bf16 at the training step's points
    n, h, w, f, scale = 16, 512, 512, 32, 0.5
    p = 64 * 64 * 32
    planes32 = torch.randn(3 * n, h, w, f, device='cuda', generator=g)
    planes = planes32.to(bf)
    coords = torch.rand(n, p, 3, device='cuda', generator=g) * 1.1 - 0.55
    coords[:, :64, 0] = scale
    coords[:, 64:128, 1] = -scale
    cot32 = torch.randn(n, p, f, device='cuda', generator=g)
    cot = cot32.to(bf)
    sums, g_coords = splat.triplane_splat_bf16(planes, coords, cot, scale, round_out=False)
    ref_sums, ref_coords = splat.triplane_sample_bwd_plain_bf16(planes, coords, cot, scale,
                                                                round_out=False)
    torch.cuda.synchronize()
    err_sums = float((sums - ref_sums).abs().max())
    rel_sums = err_sums / float(ref_sums.abs().max())
    rel_coords = float((g_coords - ref_coords).abs().max() / ref_coords.abs().max())
    print(f'K1 bf16 at planes [{3 * n},{h},{w},{f}], {n} x {p} points: float32 sums before the '
          f'store {rel_sums:.3g} x max |plain|, g_coords {rel_coords:.3g} x max |plain|')
    check(sums.dtype == torch.float32 and rel_sums <= 1e-5 and rel_coords <= 1e-5,
          'K1 bf16 disagrees with its plain version')
    worst_ulp, share, beyond = 0, 0.0, 0
    for addend in (None, ref_sums):
        got, _ = splat.triplane_splat_bf16(planes, coords, cot, scale, coords_grad=False,
                                           addend=addend)
        ref, _ = splat.triplane_sample_bwd_plain_bf16(planes, coords, cot, scale, False,
                                                      addend=addend)
        torch.cuda.synchronize()
        check(got.dtype == bf, 'K1 bf16 stored another dtype')
        ulps = bf16_ulps(got, ref)
        worst_ulp = max(worst_ulp, int(ulps.max()))
        share = max(share, float((ulps > 0).float().mean()))
        # one bf16 ulp of the texel (<= 2^-7 of it) beyond the float32 sums' own 1e-5 x max
        limit = ref.float().abs() * 2.0 ** -7 + 1e-5 * float(ref.float().abs().max())
        beyond += int(((got.float() - ref.float()).abs() > limit).sum())
    print(f'K1 bf16 stored gradient, alone and with the other pass\'s float32 addend: '
          f'{share:.3g} of the texels differ from the plain version, at most {worst_ulp} bf16 '
          f'ulps (texels whose float32 sum is near 0, where the sums\' order moves many ulps), '
          f'{beyond} beyond one ulp of the texel plus 1e-5 x max |plain|')
    check(beyond == 0, 'K1 bf16 stored gradient disagrees with its plain version')
    del sums, ref_sums, ref_coords, got, ref
    fn16 = lambda: splat.triplane_splat_bf16(planes, coords, cot, scale)  # noqa: E731
    fn32 = lambda: splat.triplane_splat(planes32, coords, cot32, scale)  # noqa: E731
    times = {label: dict(warm=cuda_ms(fn, 20), cold=cold_ms(fn, repeats=10))
             for label, fn in (('bf16', fn16), ('float32', fn32))}
    plain_ms = cuda_ms(lambda: splat.triplane_sample_bwd_plain_bf16(planes, coords, cot, scale), 3)
    _, flops, texels, most = k1_work(splat, planes32, coords, scale)
    bytes_moved = 2 * (texels * f + 3 * n * h * w * f + n * p * f) + 4 * n * p * 6
    bound_ms, bound_by = bound(bytes_moved, flops)
    print(f'K1 bf16: ' + '; '.join(f'{label} ' + ', '.join(f'{k} {v:.4f} ms' for k, v in tv.items())
                                   for label, tv in times.items())
          + f'; plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms (by {bound_by}: '
            f'{bytes_moved / 1e9:.3f} GB; {texels} texels touched, at most {most} corners on one) '
            f'(sm, mem clocks {clocks()})')
    out.append(dict(name='triplane_splat_bf16', route='cuda', source='tdgp_torch/csrc/splat.cu',
                    replaces='tdgp/ops/splat.py:258', max_abs_err=err_sums, max_ulps=worst_ulp,
                    ulp_share=share, ms=times['bf16']['warm'], cold_ms=times['bf16']['cold'],
                    plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                    float32_ms=times['float32']['warm'],
                    float32_cold_ms=times['float32']['cold']))
    return out


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
        expected = {**{k: 0 for k in got}, 'ray_march_merged': k3_expected,
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
    density_grid_own_precision(G, ws, cfg.camera.cube_scale)
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


def density_grid_own_precision(G, ws, cube_scale):
    """The 128^3 density grid of seed 0 at the flagship's own precision (bf16
    blocks 64-512), cuDNN deterministic: K4 + K5 against their plain
    versions, each decoding the planes (through K5 and through its plain
    version), <= 1e-5 x max |sigma| as at the float32 cut, and K4 alone on
    one set of decoded planes. Without cuDNN's deterministic algorithms two
    decodes give other planes: the 2.22e-5 that PR 10 read."""
    from tdgp_torch import geometry
    from tdgp_torch.models.epigraf import flatten_planes
    from tdgp_torch.utils.misc import exact_fp32
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        kernel = geometry.extract_density_grid(G, ws[:1], 128, cube_scale)
        again = geometry.extract_density_grid(G, ws[:1], 128, cube_scale)
        with plain_versions(k1=False, k3=False, k4=True, k5=True):
            plain = geometry.extract_density_grid(G, ws[:1], 128, cube_scale)
        coords = geometry.create_voxel_coords(128, cube_scale, 1, ws.device)[:, :32 ** 3]
        with torch.no_grad(), exact_fp32():
            planes = flatten_planes(G.synthesis.decode_planes(ws[:1]))
            k4 = G.synthesis.sample_densities(planes, coords)
            with plain_versions(k1=False, k3=False, k4=True):
                k4_plain = G.synthesis.sample_densities(planes, coords)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    scale = float(np.abs(plain).max())
    both = float(np.abs(kernel - plain).max()) / scale
    repeat = float(np.abs(kernel - again).max()) / scale
    alone = float((k4 - k4_plain).abs().max() / k4_plain.abs().max())
    print(f'density grid at the own precision (bf16 blocks), cuDNN deterministic: K4 + K5 vs '
          f'plain, each decoding, {both:.3g} x max |sigma| (<= 1e-5); K4 alone on the same '
          f'decoded planes {alone:.3g}; twice through the kernels {repeat:.3g}')
    check(both <= 1e-5 and alone <= 1e-5, 'the density grid through K4 and K5 at the own '
                                          'precision disagrees with the plain versions')
    return dict(k4_alone=alone, k4_k5=both, repeat=repeat)


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


def step_points_bf16_phase(calls):
    """K1's bf16 entry on the arguments of its two calls in a
    `gmain_render_bf16` step (`profile_training.capture_splat_bf16_calls`:
    the fine pass keeping its float32 sum, the coarse pass adding it and
    rounding once): its float32 sums and g_coords against its plain version
    (<= 1e-5 x max |plain|), the coarse call's stored bf16 gradient within
    one bf16 ulp of the texel plus 1e-5 x max |plain|; its time warm and
    cold beside its bound (the touched texels and the cotangent in 2 bytes,
    the addend read in 4, g_planes written in 2 or, kept in float32, 4)."""
    from tdgp_torch.ops import splat
    readings = {}
    for label, args in calls:
        args = {k: v.detach() if torch.is_tensor(v) else v for k, v in args.items()}
        planes, coords, scale, addend = args['planes'], args['coords'], args['scale'], args['addend']
        n3, h, w, f = planes.shape
        n, p = coords.shape[0], coords.shape[1]
        sums, g_coords = splat.triplane_splat_bf16(**{**args, 'round_out': False})
        ref_sums, ref_coords = splat.triplane_sample_bwd_plain_bf16(**{**args, 'round_out': False})
        torch.cuda.synchronize()
        err = float((sums - ref_sums).abs().max())
        rel = [err / float(ref_sums.abs().max())]
        if ref_coords is not None:
            rel.append(float((g_coords - ref_coords).abs().max() / ref_coords.abs().max()))
        del sums, g_coords, ref_sums, ref_coords
        beyond = 0
        if args['round_out']:
            got, _ = splat.triplane_splat_bf16(**args)
            ref, _ = splat.triplane_sample_bwd_plain_bf16(**args)
            limit = ref.float().abs() * 2.0 ** -7 + 1e-5 * float(ref.float().abs().max())
            beyond = int(((got.float() - ref.float()).abs() > limit).sum())
            del got, ref
        check(all(e <= 1e-5 for e in rel) and beyond == 0,
              f'K1 bf16 disagrees with its plain version on the {label} pass: {rel}, {beyond} '
              f'stored texels beyond one ulp')
        fn = lambda: splat.triplane_splat_bf16(**args)  # noqa: E731
        ms, cold = cuda_ms(fn, 20), cold_ms(fn, repeats=10)
        _, flops, texels, most = k1_work(splat, planes, coords, scale, args['coords_grad'])
        bytes_moved = (2 * ((texels * f if args['coords_grad'] else 0) + n * p * f)
                       + (2 if args['round_out'] else 4) * n3 * h * w * f
                       + (4 * n3 * h * w * f if addend is not None else 0)
                       + 4 * n * p * (6 if args['coords_grad'] else 3))
        bound_ms, bound_by = bound(bytes_moved, flops)
        print(f"K1 bf16 on the gmain_render_bf16 step's {label} points (planes "
              f'{list(planes.shape)}, coords {list(coords.shape)}, addend {addend is not None}, '
              f'stored in {"bf16" if args["round_out"] else "float32"}): max abs diff / max '
              f'|plain| {rel}; kernel {ms:.4f} ms warm, {cold:.4f} ms cold; bound {bound_ms:.4f} '
              f'ms ({bytes_moved / 1e9:.3f} GB by {bound_by}; {bin_summary(splat, coords, h, w, scale)})')
        readings.update({f'ms_step_{label}': ms, f'cold_ms_step_{label}': cold,
                         f'bound_ms_step_{label}': bound_ms, f'max_abs_err_step_{label}': err,
                         f'max_corners_per_texel_step_{label}': most})
    return readings


def gather_points_phase(calls):
    """K1's second-order gather entry on the arguments of its two calls in
    an R1 + PL step (`profile_training.capture_gather_calls`): against the
    plain second order (<= PL_KERNEL_LIMIT x each output's largest), its
    time warm and cold beside its bound."""
    from tdgp_torch.ops import splat
    readings = {}
    for label, args in calls:
        args = {k: v.detach() if torch.is_tensor(v) else v for k, v in args.items()}
        planes, coords, u_coords = args['planes'], args['coords'], args['u_coords']
        n3, h, w, f = planes.shape
        n, p = coords.shape[0], coords.shape[1]
        b_g, b_coords = splat.triplane_splat_gather(**args)
        _, ref_coords, ref_g = splat.triplane_sample_bwd_bwd_plain(**args)
        torch.cuda.synchronize()
        errs = [float((b_g - ref_g).abs().max()), float((b_coords - ref_coords).abs().max())]
        rel = [errs[0] / float(ref_g.abs().max()), errs[1] / float(ref_coords.abs().max())]
        del b_g, b_coords, ref_g, ref_coords
        check(all(e <= PL_KERNEL_LIMIT for e in rel),
              f"K1's gather disagrees with its plain version on PL's {label} pass: {rel}")
        fn = lambda: splat.triplane_splat_gather(**args)  # noqa: E731
        ms, cold = cuda_ms(fn, 20), cold_ms(fn, repeats=10)
        texels = int((corner_counts(splat, coords, args['scale'], n3, h, w) > 0).sum())
        bytes_moved = 4 * (texels * f * (2 if u_coords is not None else 1)
                           + n * p * (2 * f + (9 if u_coords is not None else 6)))
        bound_ms, bound_by = bound(bytes_moved, n * p * 3 * f * 14)
        print(f"K1's gather on the R1 + PL step's {label} pass (planes {list(planes.shape)}, "
              f'coords {list(coords.shape)}, coordinate cotangent {u_coords is not None}): max '
              f'abs diff / max |plain| of g\'s and the coordinates\' cotangents {rel}; kernel '
              f'{ms:.4f} ms warm, {cold:.4f} ms cold; bound {bound_ms:.4f} ms '
              f'({bytes_moved / 1e9:.3f} GB by {bound_by}; {texels} texels touched)')
        readings.update({f'ms_step_{label}': ms, f'cold_ms_step_{label}': cold,
                         f'bound_ms_step_{label}': bound_ms,
                         f'max_abs_err_step_{label}': max(errs)})
    return readings


def train_phase(Trainer, Draws, sched, cfg, make_batch, capture_splat_calls, batch_size,
                counters, label, device='cuda', step_points=step_points_phase):
    """The satellite step at full width: a warm-up step, whose K1 calls are
    held and timed by `step_points` (`step_points_phase`, or for the bf16
    entry `step_points_bf16_phase`; unless `capture_splat_calls` is None),
    then plain steps and one R1 step. Every kernel's launches are
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
        k1_step = step_points(calls)
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
    k1 = '_bf16' if cfg.training.gmain_render_bf16 else ''  # the bf16 render views' entries
    fake = '_bf16' if fresh and cfg.training.dmain_fake_bf16 else ''
    expected = {**{name: 0 for name in ('triplane_splat', 'triplane_splat_bf16',
                                        'ray_march_merged', 'ray_march_merged_bf16',
                                        'triplane_mlp', 'triplane_mlp_bf16')},
                'triplane_splat' + k1: 2 * n_micro * steps,  # coarse and fine pass of each Gmain render
                'ray_march_reduced': n_micro * steps, 'ray_march_reduced_bwd': n_micro * steps,
                'ray_march_merged' + fake: fresh * n_micro * steps,
                'triplane_mlp' + fake: fresh * 2 * n_micro * steps,
                **{n: bias_calls.unrecorded[n] for n in K5_NAMES.values()}}
    expected = {k: v for k, v in expected.items() if k in launches or v}
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


# the settings phase: the satellite step with the settings the JAX package trains and earlier
# slices of the port refused; hybrid cameras need the force-mean regularizer off (the JAX
# package's mean helper has no value for 'hybrid'), and the patch anneal is cut so that the
# support's smaller scales are masked and two remain
SETTINGS_CLIP = 1e-3  # G's gradient clip: below G's gradient norm at this width, so it clips
SETTINGS = ['loss.r1_remat=true', f'training.g_optim.grad_clip={SETTINGS_CLIP}',
            'discriminator.camera_cond=true', 'generator.camera_cond=true',
            'generator.camera_cond_raw=false', 'generator.patch.distribution=discrete_uniform',
            'generator.patch.discrete_support=[0.25,0.5,0.75,1.0]',
            'generator.patch.anneal_kimg=1000', 'camera.origin.angles.dist=hybrid',
            'camera.origin.angles.yaw.mean=0.0', 'camera.origin.angles.yaw.std=0.3',
            'camera.origin.angles.pitch.mean=1.5707963', 'camera.origin.angles.pitch.std=0.15',
            'generator.camera_adaptor.force_mean_weight=0.0']
SETTINGS_STEPS = 3  # the settings' satellite steps: two plain, then one with R1
# the flagship-width renders of the settings phase, random weights, the float32 cut
SETTINGS_RENDERS = {'three_layers': ['generator.tri_plane.mlp.n_layers=3'],
                    'mip': ['generator.ray_marcher_type=mip']}


def settings_train_phase(Trainer, Draws, sched, train_config, make_batch, counters, card,
                         device='cuda'):
    """The satellite step with SETTINGS (r1_remat, G's clip, D's camera_cond, the
    Fourier camera encoding, discrete_uniform patches, hybrid cameras): the train
    check's Gmain gradient through the kernels vs plain at batch 4, with the
    preset's bf16 blocks and at the float32 cut; at its own precision
    SETTINGS_STEPS steps at batch 16, the last
    with R1, each step's clip factor, losses finite, launches of K1 (2 per step),
    K3 and its backward (1 per step), K5 (the bias_act calls autograd does not
    record) and no other; then one R1 step with and without r1_remat from the same
    weights, batch and draws, cuDNN deterministic: R1's gradients per parameter
    (relative L2) and the peak memory of the R1 phase of each."""
    from tdgp_torch.profile_training import FP32
    cfg = train_config(SETTINGS)
    check_readings = {label: train_check_phase(Trainer, Draws, sched, train_config, make_batch,
                                               overrides, device)
                      for label, overrides in (('bf16', SETTINGS), ('float32', SETTINGS + FP32))}
    trainer = Trainer(cfg, device, seed=0)
    batch = make_batch(cfg, 16, 0, device)
    draws = Draws(torch.Generator(device=device).manual_seed(1))
    torch.cuda.synchronize()
    reset_counts(counters)
    step_ms, factors, history = [], [], []
    with BiasActCalls() as bias_calls:
        for i in range(SETTINGS_STEPS):
            t0 = time.perf_counter()
            stats = trainer.step(batch, sched, i == SETTINGS_STEPS - 1, draws)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            factors.append([float(f) for f in stats.pop('_g_clip')])
            history.append(stats)
    launches = launch_counts(counters)
    check('Loss/D/r1_penalty' in history[-1], 'the last settings step ran no R1')
    check(all(np.isfinite(float(v)) for st in history for v in st.values()),
          'non-finite losses in the settings steps')
    check(any(f < 1.0 for fs in factors for f in fs), f'the clip never acted: {factors}')
    expected = {**{k: 0 for k in launches},
                'triplane_splat': 2 * SETTINGS_STEPS, 'ray_march_reduced': SETTINGS_STEPS,
                'ray_march_reduced_bwd': SETTINGS_STEPS,
                **{n: bias_calls.unrecorded[n] for n in K5_NAMES.values()}}
    print(f'settings steps ({card}): ms {[round(t, 1) for t in step_ms]} (the first the warm-up, '
          f'the last with R1); G clip factor per step {factors}; launches {launches} (expected '
          f'{expected})')
    check(launches == expected, 'kernel launch counts of the settings steps')

    def r1_step(remat):
        c = train_config(SETTINGS + [f'loss.r1_remat={str(remat).lower()}'])
        tr = Trainer(c, device, seed=0)
        r1, inner = {}, tr._r1

        def measured(*args, **kwargs):
            torch.cuda.synchronize()
            start = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            inner(*args, **kwargs)
            torch.cuda.synchronize()
            r1.update(peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                      added_gib=(torch.cuda.max_memory_allocated() - start) / 2 ** 30)

        tr._r1 = measured
        stats = tr.step(make_batch(c, 16, 0, device), sched, True,
                        Draws(torch.Generator(device=device).manual_seed(1)), return_grads=True)
        del tr._r1  # the closure holds the trainer: free both before the next one
        return stats['_grads']['r1'], r1

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        del trainer
        grads_remat, mem_remat = r1_step(True)
        torch.cuda.empty_cache()
        grads_plain, mem_plain = r1_step(False)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    rel = {n: float((grads_remat[n] - g).norm() / g.norm().clamp_min(1e-30))
           for n, g in grads_plain.items()}
    worst = max(rel, key=rel.get)
    median = float(np.median(list(rel.values())))
    print(f'R1 with and without loss.r1_remat ({card}), cuDNN deterministic: R1 gradient '
          f'relative L2 max {rel[worst]:.3g} ({worst}), median {median:.3g}; '
          f'R1 phase peak memory {mem_remat["peak_gib"]:.2f} GiB with remat '
          f'(+{mem_remat["added_gib"]:.2f} over its start), {mem_plain["peak_gib"]:.2f} GiB '
          f'without (+{mem_plain["added_gib"]:.2f})')
    check(rel[worst] <= GRAD_LIMIT, 'R1 with r1_remat disagrees with R1 without it')
    return launches, dict(check=check_readings, step_ms=step_ms, clip_factors=factors,
                          r1_remat_rel_max=rel[worst], r1_memory_remat=mem_remat,
                          r1_memory_plain=mem_plain)


def settings_render_phase(counters, card, device='cuda'):
    """The flagship's width (256^2, tri-planes 3 x 512^2 x 32) with random weights
    from a seed at the float32 cut, served at batch 4 for each of SETTINGS_RENDERS:
    a 3-layer MLP (as its layers: K3 merged 4 per request, K4 never) and the mip
    marcher (marched in PyTorch: K3 never; the 2-layer MLP in K4, 8 per request,
    the MipNeRF clamp after it); K5 once per bias_act call. Each image through the
    kernels against their plain versions (cuDNN deterministic, <= 1e-4 max abs)
    and the card against the CPU at a 64^2 output (<= 1e-3)."""
    import copy
    from tdgp_torch.config import load_config
    from tdgp_torch.models.epigraf import Generator
    from tdgp_torch.models.layers import init_weights
    from tdgp_torch.profile_serving import FP32, OVERRIDES, PSI, RUN_DIR, request
    from tdgp_torch.serving import make_serving_fn
    readings, launches = {}, {}
    for label, overrides in SETTINGS_RENDERS.items():
        cfg = load_config(os.path.join(RUN_DIR, 'experiment_config.yaml'),
                          OVERRIDES + FP32 + overrides)
        G_cpu = init_weights(Generator(cfg.generator), torch.Generator().manual_seed(0)).eval()
        G = copy.deepcopy(G_cpu).to(device).eval()
        gc = G.cfg
        chunks = gc.img_resolution ** 2 // gc.max_batch_res ** 2
        req = request(0, gc, device)
        serve = make_serving_fn(G, truncation_psi=PSI)
        serve(*req)  # warm-up
        torch.cuda.synchronize()
        reset_counts(counters)
        with BiasActCalls() as calls:
            t0 = time.perf_counter()
            serve(*req)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
        got = launch_counts(counters)
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            img = serve(*req)
            with plain_versions(k1=False, k3=True, k4=True, k5=True):
                plain = serve(*req)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        mip, layers = gc.ray_marcher_type == 'mip', gc.tri_plane.mlp.n_layers
        expected = {**{k: 0 for k in got}, 'ray_march_merged': 0 if mip else chunks,
                    'triplane_mlp': 2 * chunks if layers == 2 else 0,
                    **{n: calls.count[n] for n in K5_NAMES.values()}}
        print(f'settings render {label} ({card}): {ms:.1f} ms per request of 4 at 256^2; '
              f'launches {got} (expected {expected})')
        check(got == expected, f'kernel launch counts of the {label} render')
        check(img.shape == (4, 256, 256, 3) and bool(torch.isfinite(img).all())
              and float(img.min()) >= 0.0 and float(img.max()) <= 1.0,
              f'the {label} render: shape {tuple(img.shape)}, values outside [0, 1]')
        diff = float((img - plain).abs().max())
        card_img = make_serving_fn(G, truncation_psi=PSI, resolution=64)(*req).cpu()
        cpu_img = make_serving_fn(G_cpu, truncation_psi=PSI, resolution=64)(
            *[t.cpu() for t in req])
        cpu_diff = float((card_img - cpu_img).abs().max())
        print(f'settings render {label}: kernels vs plain max abs image diff {diff:.3g}; card vs '
              f'CPU at 64x64 {cpu_diff:.3g}')
        check(diff <= 1e-4, f'the {label} render through the kernels disagrees with plain')
        check(cpu_diff <= 1e-3, f'the {label} render on the card disagrees with the CPU')
        readings[label] = dict(ms=ms, kernels_vs_plain=diff, card_vs_cpu=cpu_diff)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        del G, G_cpu
    return launches, readings


def settings_loop_phase(tmp_dir, counters, card):
    """One tick of four steps of `scripts.train --preset synth256` on the loop's
    folder with `camera.origin.angles.dist=custom`: every G batch takes the
    angles of random dataset items (`training.learn_camera_dist=false`: the camera
    regularizers draw prior cameras, which 'custom' has not, in the JAX package
    too). Checks the angles reached the step and are the folder's (their pitch: the
    loader mirrors the yaw of flipped items), the losses are finite, and K1 2, K3
    and its backward 1 per step."""
    import importlib.util
    from tdgp_torch.scripts import train as train_script
    from tdgp_torch.training import train_step
    data_dir = os.path.join(tmp_dir, 'data')
    with open(os.path.join(data_dir, 'dataset.json')) as f:
        pitches = {np.float32(a[1]) for _, a in json.load(f)['camera_angles']}
    tensorboard = importlib.util.find_spec('tensorboard') is not None
    seen, step = [], train_step.Trainer.step

    def recorded(self, batch, *args, **kwargs):
        seen.append(batch['gen_camera_angles_g'].cpu().numpy())
        return step(self, batch, *args, **kwargs)

    steps = 4
    train_step.Trainer.step = recorded
    reset_counts(counters)
    try:
        t0 = time.perf_counter()
        result = train_script.main(
            ['--preset', LOOP_PRESET, '--run-root', os.path.join(tmp_dir, 'custom'),
             '--max-kimg', str(16 * steps / 1e3), f'dataset.path={data_dir}',
             f'training.tick_kimg={16 * steps / 1e3}', 'camera.origin.angles.dist=custom',
             'training.learn_camera_dist=false', 'training.metrics=[]', 'training.snap=100',
             'training.image_snap=100', f'training.tensorboard={str(tensorboard).lower()}'])
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
    finally:
        train_step.Trainer.step = step
    got = launch_counts(counters)
    lines = read_jsonl(os.path.join(result.run_dir, 'stats.jsonl'))
    print(f'custom angles, one tick of {steps} steps ({card}): {loop_s:.1f} s; launches {got}')
    check(len(seen) == steps and all(np.float32(a[1]) in pitches for b in seen for a in b),
          "the custom angles are not the folder's (the pitch: the yaw is mirrored with xflip)")
    check(len(lines) == 1 and all(np.isfinite(v['mean']) for k, v in lines[0].items()
                                  if k.startswith('Loss/')), 'the custom tick')
    check(got['triplane_splat'] == 2 * steps and got['ray_march_reduced'] == steps
          and got['ray_march_reduced_bwd'] == steps, 'kernel launch counts of the custom tick')
    return got, dict(loop_s=loop_s)


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


PL = ['loss.pl_weight=2.0']  # path-length regularization at the 2D preset's weight
PL_PLAIN_STEPS = 2           # the pl phase's plain steps, before its R1 + PL step
PL_KERNEL_LIMIT = 1e-5       # the second-order entries vs plain: of each output's largest
PL_CHECK_BATCH = 8           # the PL check's batch: PL at 4, one mbstd group


def bwd_bwd_errors(out, ref):
    """Max abs diff of each of K3's second-order outputs from the plain
    version's, over its largest magnitude: each per-sample output (colors,
    densities, depths) its own; the four per-ray totals (g_rgb, g_depth,
    g_wsum, g_ftrans) one, their largest, since g_wsum's sum cancels to
    rounding where no light passes the ray (use_inf_depth), as in
    tests/test_torch_pl3d.py."""
    errs = [float((a - b).abs().max()) for a, b in zip(out, ref)]
    totals = max(float(b.abs().max()) for b in ref[3:])
    scales = [float(b.abs().max()) for b in ref[:3]] + [totals] * 4
    return errs, [e / max(s, 1e-30) for e, s in zip(errs, scales)]


def pl_kernel_phase(ray_march, splat):
    """K3's second-order entry (`ray_march_reduced_bwd_bwd`) and K1's two
    (`triplane_splat_gather`, `triplane_splat_dcoords`) against their plain
    versions (autograd through the first-order plain versions) at the shapes
    of the satellite step's PL render (batch 8: [8, 4096, 32 + 32, 3]
    marched; planes [24, 512, 512, 32], 8 x 64^2 x 32 points a pass), each
    output within PL_KERNEL_LIMIT x its largest; timed beside the plain
    version and the bound. The PL phase hands them no depth and no
    coordinate cotangent (its coordinates do not depend on ws), so K3's is
    held with and without one and the scatter, which only a coordinate
    cotangent launches, at random ones. K3's is first held at small shapes
    that take each of its widths (S = 7, 33, 65, 128: 1, 2, 4 samples a
    lane; an odd S stages unaligned rows) with 1, 3 and 4 channels, 74 rays
    (a block part full), then with the last sample near opaque under the
    infinite last delta (its density swept over [-26, -14] across 256 rays):
    its factor falls to 1e-10 and the sweep divides the sum behind it,
    exactly 0, by it. There the reference is the plain version in float64,
    which the float32 one misses by 1.4e-5 of the largest itself."""
    g_small = torch.Generator(device='cuda').manual_seed(6)
    for s, c in itertools.product((7, 33, 65, 128), (1, 3, 4)):
        colors = torch.rand(2, 37, s, c, device='cuda', generator=g_small)
        densities = torch.randn(2, 37, s, device='cuda', generator=g_small) * 2
        depths = (torch.rand(2, 37, s, device='cuda', generator=g_small).sort(-1).values * 0.5
                  + 0.75)
        cots = [torch.randn(2, 37, c, device='cuda', generator=g_small)] + [
            torch.randn(2, 37, device='cuda', generator=g_small) for _ in range(3)]
        us = [torch.randn(t.shape, device='cuda', generator=g_small)
              for t in (colors, densities, depths)]
        for clamp_mode, inf_depth, last_back in K3_CASES:
            for u in ((us[0], us[1], None), us, (None, us[1], None)):
                args = (colors, densities, depths, *cots, *u, clamp_mode, 1.0, inf_depth,
                        last_back)
                _, rel = bwd_bwd_errors(ray_march.ray_march_reduced_bwd_bwd(*args),
                                        ray_march.ray_march_reduced_bwd_bwd_plain(*args))
                check(all(e <= PL_KERNEL_LIMIT for e in rel),
                      f"K3's second-order entry at S={s}, C={c}, {clamp_mode} "
                      f'inf_depth={inf_depth} last_back={last_back}, u present '
                      f'{[v is not None for v in u]} disagrees with its plain version: {rel}')
    print("K3's second order at S = 7, 33, 65, 128, C = 1, 3, 4, 74 rays, every K3_CASES "
          'setting, u_depths present or null, u_colors null: as its plain version '
          f'(<= {PL_KERNEL_LIMIT} x max |plain|)')
    for s in (7, 64, 65, 128):
        colors = torch.rand(1, 256, s, 3, device='cuda', generator=g_small)
        densities = torch.randn(1, 256, s, device='cuda', generator=g_small) * 2
        densities[..., -1] = torch.linspace(-26, -14, 256, device='cuda')
        depths = (torch.rand(1, 256, s, device='cuda', generator=g_small).sort(-1).values * 0.5
                  + 0.75)
        cots = [torch.randn(1, 256, 3, device='cuda', generator=g_small)] + [
            torch.randn(1, 256, device='cuda', generator=g_small) for _ in range(3)]
        us = [torch.randn(t.shape, device='cuda', generator=g_small)
              for t in (colors, densities, depths)]
        for last_back in (False, True):
            args = (colors, densities, depths, *cots, *us)
            opts = ('softplus', 1.0, True, last_back)
            _, rel = bwd_bwd_errors(
                ray_march.ray_march_reduced_bwd_bwd(*args, *opts),
                ray_march.ray_march_reduced_bwd_bwd_plain(*[t.double() for t in args], *opts))
            check(all(e <= PL_KERNEL_LIMIT for e in rel),
                  f"K3's second-order entry at S={s} with the last sample near opaque, "
                  f'last_back={last_back}, disagrees with its plain version in float64: {rel}')
    print("K3's second order at S = 7, 64, 65, 128, the last sample near opaque under the "
          'infinite last delta, 256 rays: as its plain version in float64 '
          f'(<= {PL_KERNEL_LIMIT} x max |plain|)')
    g = torch.Generator(device='cuda').manual_seed(4)
    b, r, s, c = 8, 4096, 64, 3
    colors = torch.rand(b, r, s, c, device='cuda', generator=g)
    densities = torch.randn(b, r, s, device='cuda', generator=g) * 2
    depths = torch.rand(b, r, s, device='cuda', generator=g).sort(-1).values * 0.5 + 0.75
    cots = [torch.randn(b, r, c, device='cuda', generator=g)] + [
        torch.randn(b, r, device='cuda', generator=g) for _ in range(3)]
    us = [torch.randn(t.shape, device='cuda', generator=g) for t in (colors, densities, depths)]
    worst = 0.0
    for clamp_mode, inf_depth, last_back in K3_CASES:
        for u_depths in (None, us[2]):
            args = (colors, densities, depths, *cots, us[0], us[1], u_depths, clamp_mode, 1.0,
                    inf_depth, last_back)
            out = ray_march.ray_march_reduced_bwd_bwd(*args)
            ref = ray_march.ray_march_reduced_bwd_bwd_plain(*args)
            torch.cuda.synchronize()
            errs, rel = bwd_bwd_errors(out, ref)
            print(f'K3 second order {clamp_mode} inf_depth={inf_depth} last_back={last_back} '
                  f'depth cotangent={u_depths is not None}: max abs diff / max |plain| of the '
                  f'colours, densities, depths, g_rgb, g_depth, g_wsum, g_ftrans cotangents '
                  f'{[float(f"{e:.3g}") for e in rel]}')
            check(all(e <= PL_KERNEL_LIMIT for e in rel),
                  "K3's second-order entry disagrees with its plain version")
            worst = max(worst, *errs)
    args = (colors, densities, depths, *cots, us[0], us[1], None)
    # with the calls enqueued ahead: the host takes about as long as the kernel to launch it
    ms = cuda_ms(lambda: ray_march.ray_march_reduced_bwd_bwd(*args), 200, prefill=True)
    # as earlier kernels lines timed it, back to back with the host launching
    back_to_back = cuda_ms(lambda: ray_march.ray_march_reduced_bwd_bwd(*args), 200)
    cold = cold_ms(lambda: ray_march.ray_march_reduced_bwd_bwd(*args))
    plain_ms = cuda_ms(lambda: ray_march.ray_march_reduced_bwd_bwd_plain(*args), 10)
    n = b * r
    # inputs, the two cotangents and the seven outputs, each once
    bytes_moved = 4 * (n * s * (c + 2) + n * (c + 3) + n * s * (c + 1) + n * s * (c + 2)
                       + n * (c + 3))
    flops = n * s * (8 * c + 90)  # the backward's values, then its reverse sweep
    bound_ms, bound_by = bound(bytes_moved, flops)
    print(f"K3's second order at [{b},{r},{s},{c}] (no depth cotangent, as on the path): kernel "
          f'{ms:.4f} ms prefilled, {back_to_back:.4f} ms back to back, {cold:.4f} ms cold, '
          f'plain {plain_ms:.4f} ms, bound '
          f'{1e3 * bound_ms:.1f} us '
          f'({bytes_moved / 1e6:.1f} MB by {bound_by}), {bytes_moved / (ms * 1e-3) / 1e12:.2f} TB/s')
    k3_bwd_bwd = dict(name='ray_march_reduced_bwd_bwd', route='cuda',
                      source='tdgp_torch/csrc/ray_march.cu',
                      replaces='tdgp/ops/pallas_kernels.py:251', max_abs_err=worst, ms=ms,
                      back_to_back_ms=back_to_back, cold_ms=cold, plain_ms=plain_ms,
                      bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    del colors, densities, depths, cots, us

    # K1: small shapes (F = 8, 16; texel edges and points outside), then the path's
    g_small = torch.Generator(device='cuda').manual_seed(5)
    for n, h, w, f, p in [(2, 40, 50, 8, 300), (3, 33, 17, 16, 777), (2, 37, 21, 32, 1000)]:
        planes = torch.randn(3 * n, h, w, f, device='cuda', generator=g_small)
        coords = torch.rand(n, p, 3, device='cuda', generator=g_small) * 1.2 - 0.6
        coords[:, :8] = torch.tensor([-0.5, 0.5, 0.0], device='cuda')  # on texel edges
        cot = torch.randn(n, p, f, device='cuda', generator=g_small)
        u_planes = torch.randn(planes.shape, device='cuda', generator=g_small)
        u_coords = torch.randn(coords.shape, device='cuda', generator=g_small)
        for u_p, u_c in ((u_planes, None), (u_planes, u_coords), (None, u_coords)):
            out = splat.triplane_sample_bwd_bwd(planes, coords, cot, u_p, u_c, 0.5)
            ref = splat.triplane_sample_bwd_bwd_plain(planes, coords, cot, u_p, u_c, 0.5)
            rel = [float((a - b_).abs().max() / b_.abs().max())
                   for a, b_ in zip(out, ref) if a is not None]
            check(all(e <= PL_KERNEL_LIMIT for e in rel),
                  f"K1's second order at F={f}, planes {h}x{w} disagrees with its plain "
                  f'version: {rel}')
    print("K1's second order at F = 8, 16, 32, planes 40x50, 33x17, 37x21, points on texel "
          'edges and outside: as its plain version (<= 1e-5 x max |plain|)')

    n, h, w, f, scale = 8, 512, 512, 32, 0.5
    p = 64 * 64 * 32
    planes = torch.randn(3 * n, h, w, f, device='cuda', generator=g)
    coords = torch.rand(n, p, 3, device='cuda', generator=g) * 1.1 - 0.55
    cot = torch.randn(n, p, f, device='cuda', generator=g)
    u_planes = torch.randn(planes.shape, device='cuda', generator=g)
    u_coords = torch.randn(coords.shape, device='cuda', generator=g)
    worst_gather = worst_scatter = 0.0
    for u_p, u_c in ((u_planes, None), (u_planes, u_coords)):
        out = splat.triplane_sample_bwd_bwd(planes, coords, cot, u_p, u_c, scale)
        ref = splat.triplane_sample_bwd_bwd_plain(planes, coords, cot, u_p, u_c, scale)
        torch.cuda.synchronize()
        errs = [None if a is None else float((a - b_).abs().max()) for a, b_ in zip(out, ref)]
        rel = [None if e is None else e / float(b_.abs().max()) for e, b_ in zip(errs, ref)]
        print(f"K1's second order at planes [{3 * n},{h},{w},{f}], {n} x {p} points, coordinate "
              f'cotangent={u_c is not None}: max abs diff / max |plain| of the planes\', '
              f"coordinates' and g's cotangents {rel}")
        check(all(e is None or e <= PL_KERNEL_LIMIT for e in rel),
              "K1's second order disagrees with its plain version")
        worst_gather = max(worst_gather, errs[1], errs[2])
        if errs[0] is not None:
            worst_scatter = max(worst_scatter, errs[0])
        del out, ref
    gather_ms = cuda_ms(lambda: splat.triplane_splat_gather(planes, coords, cot, u_planes, None,
                                                            scale), 20)
    gather_plain_ms = cuda_ms(lambda: splat.triplane_sample_bwd_bwd_plain(
        planes, coords, cot, u_planes, None, scale), 3)
    scatter_ms = cuda_ms(lambda: splat.triplane_splat_dcoords(coords, cot, u_coords, scale, h, w),
                         20)
    scatter_plain_ms = cuda_ms(lambda: splat.triplane_sample_bwd_bwd_plain(
        planes, coords, cot, None, u_coords, scale), 3)
    counts = corner_counts(splat, coords, scale, 3 * n, h, w)
    texels = int((counts > 0).sum())
    # the gather on the path: the touched texels of the planes' cotangent, g and the
    # coordinates read, the cotangents of g and of the coordinates written
    gather_bytes = 4 * (texels * f + n * p * (2 * f + 6))
    gather_bound, gather_by = bound(gather_bytes, n * p * 3 * f * 14)
    # the scatter: g, the coordinates and their cotangent read, the planes' cotangent written
    scatter_bytes = 4 * (3 * n * h * w * f + n * p * (f + 6))
    scatter_bound, scatter_by = bound(scatter_bytes, n * p * 3 * f * 16)
    print(f"K1's gather entry (the path's form, no coordinate cotangent): kernel "
          f'{gather_ms:.4f} ms, plain {gather_plain_ms:.4f} ms, bound {gather_bound:.4f} ms '
          f'({gather_bytes / 1e9:.2f} GB by {gather_by}; {texels} of {3 * n * h * w} texels '
          f'touched); its scatter entry: kernel {scatter_ms:.4f} ms, plain (the whole second '
          f'order with a coordinate cotangent) {scatter_plain_ms:.4f} ms, bound '
          f'{scatter_bound:.4f} ms ({scatter_bytes / 1e9:.2f} GB by {scatter_by})')
    k1_gather = dict(name='triplane_splat_gather', route='cuda', source='tdgp_torch/csrc/splat.cu',
                     replaces='tdgp/ops/splat.py:1021', max_abs_err=worst_gather, ms=gather_ms,
                     plain_ms=gather_plain_ms, bound_ms=gather_bound, bound_by=gather_by,
                     library_ms=None)
    k1_dcoords = dict(name='triplane_splat_dcoords', route='cuda',
                      source='tdgp_torch/csrc/splat.cu', replaces='tdgp/ops/splat.py:1021',
                      max_abs_err=worst_scatter, ms=scatter_ms, plain_ms=scatter_plain_ms,
                      bound_ms=scatter_bound, bound_by=scatter_by, library_ms=None)
    return k3_bwd_bwd, k1_gather, k1_dcoords


@contextlib.contextmanager
def first_order_ulp(seed):
    """The plain versions of K1's and K3's backward with each output changed
    by about one float32 ulp (x (1 + 2^-24 n), n ~ N(0, 1), from `seed` and
    the call's index): PL's one-ulp floor, since PL reads the render only
    through those backwards (the image's value does not enter its
    gradient)."""
    from tdgp_torch.ops import ray_march, splat
    saved = ray_march.ray_march_reduced_bwd_plain, splat.triplane_sample_bwd_plain
    calls = [0]

    def perturbed(fn):
        def run(*args, **kwargs):
            calls[0] += 1
            out = fn(*args, **kwargs)
            g = torch.Generator(device=out[0].device).manual_seed(seed * 1000 + calls[0])
            return tuple(None if t is None else t * (1 + 2.0 ** -24 * torch.randn(
                t.shape, device=t.device, generator=g)) for t in out)
        return run

    ray_march.ray_march_reduced_bwd_plain, splat.triplane_sample_bwd_plain = map(perturbed, saved)
    try:
        yield
    finally:
        ray_march.ray_march_reduced_bwd_plain, splat.triplane_sample_bwd_plain = saved


def pl_check_phase(Trainer, Draws, sched, train_config, make_batch, overrides, card,
                   device='cuda'):
    """PL's G gradient at full width, batch PL_CHECK_BATCH (PL at half), with
    `overrides`, through the kernels and through their plain versions (K1
    and K3 with their second orders: `plain_versions`) on the same weights,
    Adam state and draws, after a warm-up R1 + PL step: `Trainer._pl` alone,
    so that Gmain's Adam update does not enter. cuDNN deterministic, the
    StyleGAN2 noise off (as the train check). Each parameter within
    max(GRAD_LIMIT, 2 x its floor) at float32 (the rule the train check
    gives the depth adaptor, here without its cap) and within
    max(GRAD_LIMIT, BF16_FLOOR_FACTOR x its floor) with bf16 blocks. The
    floor of a parameter is the largest of the plain path run again on the
    same inputs (its own spread: the plain splat adds with atomics) and of
    FLOOR_SEEDS' one-ulp perturbations of K1's and K3's first-order outputs
    (`first_order_ulp`): the camera adaptor's PL gradient is a sum over
    every sample of the render that cancels to a few percent of its terms,
    and the plain path against itself moves it by ~2e-2 on an H100. The
    penalty finite, `pl_mean` moved."""
    from tdgp_torch.training.train_step import sample_gen_inputs
    cfg = train_config(list(overrides) + PL + ['generator.use_noise=false'])
    bf16 = not cfg.generator.fp32_only
    label = 'bf16 blocks' if bf16 else 'float32'
    trainer = Trainer(cfg, device, seed=0)
    batch = make_batch(cfg, PL_CHECK_BATCH, 2, device)
    trainer.step(batch, sched, True, Draws(torch.Generator(device=device).manual_seed(1)))
    start = sg2_trainer_state(trainer)
    gen = sample_gen_inputs(Draws(torch.Generator(device=device).manual_seed(5)).scope('gen_g'),
                            PL_CHECK_BATCH, cfg, sched)

    def pl_grads(plain, seed=None):
        sg2_restore(trainer, start)
        trainer.G.zero_grad(set_to_none=True)
        stats = {}
        with (plain_versions() if plain else contextlib.nullcontext()), \
                (first_order_ulp(seed) if seed is not None else contextlib.nullcontext()):
            trainer._pl(gen, sched, Draws(torch.Generator(device=device).manual_seed(6)), stats)
        check(np.isfinite(float(stats['Loss/pl_penalty'])), 'non-finite PL penalty')
        check(float(trainer.pl_mean) != float(start['pl_mean']), 'pl_mean did not move')
        return {n: (torch.zeros_like(p) if p.grad is None else p.grad.detach().clone())
                for n, p in trainer.G.named_parameters()}, stats

    def rel_l2(a, b):
        return {n: float((a[n] - r).norm() / r.norm().clamp_min(1e-30)) for n, r in b.items()}

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref, ref_stats = pl_grads(True)
        got, got_stats = pl_grads(False)
        spread = rel_l2(pl_grads(True)[0], ref)
        floor = dict(spread)
        for seed in FLOOR_SEEDS:
            fl = rel_l2(pl_grads(True, seed)[0], ref)
            floor = {n: max(floor[n], fl[n]) for n in ref}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    rel = rel_l2(got, ref)
    factor = BF16_FLOOR_FACTOR if bf16 else 2
    limit = {n: max(GRAD_LIMIT, factor * floor[n]) for n in rel}
    raised = sorted(n for n in rel if limit[n] > GRAD_LIMIT)
    name = max(rel, key=lambda n: rel[n] / limit[n])
    penalty = (float(got_stats['Loss/pl_penalty']), float(ref_stats['Loss/pl_penalty']))
    print(f'PL gradient ({label}), kernels vs plain versions: {len(rel)} parameters, median '
          f'relative L2 difference {float(np.median(list(rel.values()))):.3g}, max '
          f'{max(rel.values()):.3g}; worst against its limit {rel[name]:.3g} ({name}; limit '
          f'{limit[name]:.3g}); the plain path against itself median '
          f'{float(np.median(list(spread.values()))):.3g}, max {max(spread.values()):.3g}; '
          f'floor median {float(np.median(list(floor.values()))):.3g}, max '
          f'{max(floor.values()):.3g}; {len(raised)} limits above {GRAD_LIMIT:g} '
          f'({raised[:3]}{" ..." if len(raised) > 3 else ""}); penalty {penalty[0]:.6g} (plain '
          f'{penalty[1]:.6g}) [{card}]')
    check(all(rel[n] <= limit[n] for n in rel),
          f'the PL gradient ({label}) through the kernels disagrees with the plain path')
    del trainer, start
    torch.cuda.empty_cache()
    return dict(median=float(np.median(list(rel.values()))), max=max(rel.values()),
                worst=rel[name], worst_param=name, worst_of_limit=rel[name] / limit[name],
                spread_median=float(np.median(list(spread.values()))),
                spread_max=max(spread.values()),
                floor_median=float(np.median(list(floor.values()))), floor_max=max(floor.values()),
                raised=len(raised), penalty=penalty[0])


def pl_train_phase(Trainer, Draws, sched, cfg, make_batch, batch_size, counters, label, card,
                   device='cuda', capture_gather_calls=None):
    """The satellite step with PL (`loss.pl_weight` 2) at batch BATCH, random
    weights from a seed: a warm-up R1 + PL step, then PL_PLAIN_STEPS plain
    steps and one R1 + PL step, counted: K1 2, K3 and its backward 1 per
    plain step; the R1 + PL step adds PL's render (K3 1 more), its
    gradient with respect to ws (K1 2, K3's backward 1, through the recorded
    backwards), and the penalty's gradient: K3's second order 1 and K1's
    gather entry 2 (one per render pass), with K1 2 more (the plane
    features' cotangent goes back through the forward's sampler), and K1's
    scatter entry never (no coordinate cotangent); K5 once per `bias_act`
    call that autograd does not record; the merged K3 and K4 never. Losses
    finite, `pl_mean` moved, every parameter of G and D moved. Then one R1
    step without PL (`pl_weight` 0) on the same trainer: ms per plain, R1 +
    PL and R1 step, the peak memory of the R1 + PL and the R1 step, and
    the memory the PL and the R1 phase hold at their start and their peaks.
    With `capture_gather_calls`, the warm-up step's calls of K1's gather
    are held and timed (`gather_points_phase`); returns their readings
    third."""
    trainer = Trainer(cfg, device, seed=0)
    batch = make_batch(cfg, batch_size, 0, device)
    draws = Draws(torch.Generator(device=device).manual_seed(1))
    gather_step = {}
    if capture_gather_calls is None:
        trainer.step(batch, sched, True, draws)
    else:
        calls = capture_gather_calls(trainer, batch, sched, draws)
        torch.cuda.synchronize()
        gather_step = gather_points_phase(calls)
        del calls
    torch.cuda.synchronize()
    modules = {'G': trainer.G, 'D': trainer.D}
    before = {k: {n: p.detach().clone() for n, p in m.named_parameters()}
              for k, m in modules.items()}
    pl_mean = float(trainer.pl_mean)
    phase_gib = {}  # PL's and R1's (held at the start, peak) in GiB; the step's peak is the max

    def measured(fn, what):
        def run(*args):
            torch.cuda.synchronize()
            before = torch.cuda.max_memory_allocated()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = fn(*args)
            torch.cuda.synchronize()
            phase_gib[what] = (held / 2 ** 30, torch.cuda.max_memory_allocated() / 2 ** 30)
            phase_gib['before_' + what] = before / 2 ** 30
            return out
        return run

    trainer._pl, trainer._r1 = measured(trainer._pl, 'pl'), measured(trainer._r1, 'r1')
    reset_counts(counters)
    plain_ms, history = [], []
    with BiasActCalls() as bias_calls:
        for _ in range(PL_PLAIN_STEPS):
            t0 = time.perf_counter()
            history.append(trainer.step(batch, sched, False, draws))
            torch.cuda.synchronize()
            plain_ms.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        history.append(trainer.step(batch, sched, True, draws))
        torch.cuda.synchronize()
        pl_ms = 1e3 * (time.perf_counter() - t0)
        pl_peak = max(phase_gib['before_pl'], phase_gib['pl'][1], phase_gib['r1'][1],
                      torch.cuda.max_memory_allocated() / 2 ** 30)
        pl_phases = {k: phase_gib[k] for k in ('pl', 'r1')}
    launches = launch_counts(counters)
    steps = PL_PLAIN_STEPS + 1
    n_micro = batch_size // (cfg.training.batch_gpu or batch_size)
    expected = {**{c: 0 for c in launches},
                'triplane_splat': 2 * n_micro * steps + 4,
                'ray_march_reduced': n_micro * steps + 1,
                'ray_march_reduced_bwd': n_micro * steps + 1, 'ray_march_reduced_bwd_bwd': 1,
                'triplane_splat_gather': 2, 'triplane_splat_dcoords': 0,
                **{n: bias_calls.unrecorded[n] for n in K5_NAMES.values()}}
    print(f'PL launches over {PL_PLAIN_STEPS} plain steps and one R1 + PL step ({label}): '
          f'{launches} (expected {expected}) [{card}]')
    check(launches == expected, 'kernel launch counts of the PL training path')
    losses = {k: float(v) for k, v in history[-1].items() if not k.startswith('_')}
    print('losses of the R1 + PL step: ' + ', '.join(f'{k} {v:.4g}'
                                                    for k, v in sorted(losses.items())))
    check('Loss/pl_penalty' in losses and 'Loss/D/r1_penalty' in losses,
          'the R1 step ran no PL or no R1')
    check(all(np.isfinite(float(v)) for st in history for k, v in st.items()
              if not k.startswith('_')), 'non-finite losses')
    check(float(trainer.pl_mean) != pl_mean, 'pl_mean did not move')
    for k, m in modules.items():
        still = [n for n, p in m.named_parameters() if torch.equal(p, before[k][n])]
        check(not still, f'parameters of {k} did not move: {still[:5]}')
    full = trainer.cfg
    trainer.cfg = dataclasses.replace(full, loss=dataclasses.replace(full.loss, pl_weight=0.0))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.step(batch, sched, True, draws)
    torch.cuda.synchronize()
    r1_ms = 1e3 * (time.perf_counter() - t0)
    r1_peak = max(phase_gib['before_r1'], phase_gib['r1'][1],
                  torch.cuda.max_memory_allocated() / 2 ** 30)
    trainer.cfg = full
    t_plain = float(np.median(plain_ms))
    print(f'satellite step with PL, {label}, batch {batch_size}: plain ms '
          f'{["%.1f" % t for t in plain_ms]}; R1 + PL step {pl_ms:.1f} ms, R1 step {r1_ms:.1f} '
          f'ms (PL adds {pl_ms - r1_ms:.1f} ms); peak memory of the R1 + PL step '
          f'{pl_peak:.2f} GiB, of the R1 step {r1_peak:.2f} GiB; the PL phase holds '
          f'{pl_phases["pl"][0]:.2f} GiB at its start and peaks at {pl_phases["pl"][1]:.2f}, the '
          f'R1 phase {pl_phases["r1"][0]:.2f} and {pl_phases["r1"][1]:.2f} [{card}]')
    del trainer
    torch.cuda.empty_cache()
    return launches, dict(plain_ms=t_plain, r1_pl_ms=pl_ms, r1_ms=r1_ms, peak_r1_pl_gib=pl_peak,
                          peak_r1_gib=r1_peak, pl_phase_gib=pl_phases['pl'],
                          r1_phase_gib=pl_phases['r1']), gather_step


CUT_Q = 0.5                 # NFS's quantile cut
NFS_KERNEL_LIMIT = 1e-5     # depth maps, K3's cut entry vs its plain version: of max |depth|
NFS_CPU_LIMIT = 1e-3        # depth maps, card vs CPU at the float32 cut: abs, every pixel uncut,
NFS_CPU_SHARE = 1e-3        # ... the share of pixels beyond it with the cut (rays where a
                            # density ulps apart crosses the threshold), and
NFS_CPU_REL = 1e-4          # ... the batch's NFS: relative
METRIC_IMAGES = 256         # KID, PR, IS: generated and real images (the registry's 50,000 cut)
PPL_PAIRS = 64              # PPL: pairs (the registry's 2048 cut)


def same_bits(got, ref):
    """Whether two one-element thresholds are the same bits, NaN as NaN and
    a zero of either sign as a zero (the select and the sort may order -0
    and +0 either way)."""
    a, b = float(got.float()), float(ref.float())
    if np.isnan(a) or np.isnan(b):
        return bool(np.isnan(a) and np.isnan(b))
    return got.dtype == ref.dtype and (a == b == 0.0 or bool(
        (got.view(torch.int16 if got.dtype == torch.bfloat16 else torch.int32)
         == ref.view(torch.int16 if ref.dtype == torch.bfloat16 else torch.int32)).all()))


class SortCalls:
    """Counts the calls of the sort (`ray_march.quantile_plain`) on CUDA
    tensors while it is entered: the card's path takes its thresholds by the
    select kernel and should show none."""

    def __enter__(self):
        from tdgp_torch.ops import ray_march
        self.count = 0
        self._saved = inner = ray_march.quantile_plain

        def counted(x, q):
            self.count += x.is_cuda
            return inner(x, q)

        ray_march.quantile_plain = counted
        return self

    def __exit__(self, *exc):
        from tdgp_torch.ops import ray_march
        ray_march.quantile_plain = self._saved


def threshold_kernel_phase(ray_march, g):
    """The quantile threshold's select kernel (`cut_threshold`, `quantile` on
    CUDA tensors) against the sort on the card, bit for bit (a zero of
    either sign as a zero): the final march's threshold over the raw
    densities of both sets at the served chunk [4, 16384, 32 + 32], float32
    and bf16 loads, softplus and relu, q = 0.25, 0.5, 1; the coarse march's
    over its clamped densities [4, 16384, 32], float32 and bf16 (softplus in
    bf16, JAX's chain); small shapes: ties, all equal, a NaN, one value, ±0,
    every value in one top bin, relu's many zeros, two sets of different
    sizes. The kernel's own clamp (the keys of its first pass) against
    `F.softplus` on the served chunk, bit for bit. Timed: the threshold at
    the served and the coarse chunk, cold and warm (the calls enqueued ahead),
    beside the sort, `torch.quantile` of the clamped values (one PyTorch call
    of the same function: 4,194,304 < 2^24 values) and the bound of the bytes
    (the densities read once). Returns the `cut_threshold` kernels record."""
    bf = torch.bfloat16
    checked, worst = 0, 0.0

    def hold_bits(got, ref, what):
        nonlocal checked, worst
        check(same_bits(got, ref), f'cut threshold, {what}: the select gives {got.tolist()}, '
                                   f'the sort {ref.tolist()}')
        diff = (got.float() - ref.float()).abs()
        worst = max(worst, float(torch.where(torch.isnan(diff), 0.0, diff).max()))
        checked += 1

    b, r, s1, s2 = 4, 16384, 32, 32
    d1 = torch.randn(b, r, s1, device='cuda', generator=g) * 2
    d2 = torch.randn(b, r, s2, device='cuda', generator=g) * 2
    for dtype in (torch.float32, bf):
        x1, x2 = d1.to(dtype), d2.to(dtype)
        for clamp_mode in ('softplus', 'relu'):
            for q in (0.25, 0.5, 1.0):
                hold_bits(ray_march.cut_threshold(x1, x2, q, clamp_mode),
                          ray_march.cut_threshold_plain(x1, x2, q, clamp_mode),
                          f'served chunk, {dtype} loads, {clamp_mode}, q {q}')
        for q in (0.25, 0.5, 1.0):
            clamped = ray_march.clamp_densities(x1)
            hold_bits(ray_march.quantile(clamped, q), ray_march.quantile_plain(clamped, q),
                      f'coarse chunk, {dtype}, q {q}')
    keys = ray_march.cut_threshold_keys(d1, d2)
    clamped = torch.cat([torch.nn.functional.softplus(x).reshape(-1) for x in (d1, d2)])
    clamp_same = bool((ray_march.key_values(keys).view(torch.int32)
                       == clamped.view(torch.int32)).all())
    check(clamp_same, 'the select clamps the densities otherwise than F.softplus')

    rs = np.random.RandomState(11)
    small = {'ties': np.round(rs.randn(4, 33, 20), 1), 'all_equal': np.full(777, 0.37),
             'nan': np.where(rs.rand(5000) < 1e-3, np.nan, rs.randn(5000)),
             'one_value': rs.randn(1), 'signed_zeros': np.where(rs.rand(999) < 0.5, 0.0, -0.0),
             'one_top_bin': 1.0 + rs.rand(3000) * 1e-3,
             'relu_zeros': np.maximum(rs.randn(10000), 0.0)}
    for name, x in small.items():
        for dtype in (torch.float32, bf):
            t = torch.from_numpy(x.astype(np.float32)).to('cuda', dtype)
            for q in (0.25, 0.5, 1.0):
                hold_bits(ray_march.quantile(t, q), ray_march.quantile_plain(t, q),
                          f'{name}, {dtype}, q {q}')
    for n1, n2 in ((1, 1), (5, 3000), (40000, 7)):
        x1 = torch.randn(n1, device='cuda', generator=g)
        x2 = torch.randn(n2, device='cuda', generator=g)
        x1[::3] = -5.0  # relu's zeros
        for clamp_mode in ('softplus', 'relu'):
            for q in (0.25, 0.5, 1.0):
                hold_bits(ray_march.cut_threshold(x1, x2, q, clamp_mode),
                          ray_march.cut_threshold_plain(x1, x2, q, clamp_mode),
                          f'sets of {n1} and {n2}, {clamp_mode}, q {q}')
    torch.cuda.synchronize()
    print(f'cut threshold: the select equals the sort bit for bit in {checked} cases (max abs '
          f'diff {worst:.3g}; served '
          f'chunk [{b},{r},{s1}+{s2}] float32 and bf16 loads, softplus and relu; coarse chunk '
          f'[{b},{r},{s1}] float32 and bf16; small shapes {sorted(small)}; two sets of different '
          f'sizes; q = 0.25, 0.5, 1); its clamp equals F.softplus bit for bit on the '
          f'{keys.numel()} served densities: {clamp_same}')

    times = {}
    clamped_cat = torch.cat([ray_march.clamp_densities(x).reshape(-1) for x in (d1, d2)])
    coarse = ray_march.clamp_densities(d1)
    d1b, d2b = d1.to(bf), d2.to(bf)
    for label, fn in (
            ('served', lambda: ray_march.cut_threshold(d1, d2, CUT_Q)),
            ('served_bf16', lambda: ray_march.cut_threshold(d1b, d2b, CUT_Q)),
            ('coarse', lambda: ray_march.quantile(coarse, CUT_Q)),
            ('served_sort', lambda: ray_march.cut_threshold_plain(d1, d2, CUT_Q)),
            ('coarse_sort', lambda: ray_march.quantile_plain(coarse, CUT_Q)),
            ('served_library', lambda: torch.quantile(clamped_cat, CUT_Q)),
            ('coarse_library', lambda: torch.quantile(coarse, CUT_Q))):
        times[label] = dict(warm=cuda_ms(fn, 50, prefill=True), cold=cold_ms(fn))
    lib_diff = float(torch.quantile(clamped_cat, CUT_Q) - ray_march.cut_threshold(d1, d2, CUT_Q))
    n = d1.numel() + d2.numel()
    bytes_moved, flops = 4 * n + 4, 4 * n  # densities read once; scale, exp, log1p, divide
    bound_ms, bound_by = bound(bytes_moved, flops)
    coarse_bound_ms, _ = bound(4 * coarse.numel() + 4, 0)
    print('cut threshold: ' + '; '.join(
        f'{label} warm {t["warm"]:.4f} ms, cold {t["cold"]:.4f} ms' for label, t in times.items())
        + f'; bound {bound_ms:.4f} ms at the served chunk ({bytes_moved / 1e6:.1f} MB by '
          f'{bound_by}), {coarse_bound_ms:.4f} ms at the coarse chunk; torch.quantile minus the '
          f'threshold {lib_diff:.3g} (its own interpolation) (sm, mem clocks {clocks()})')
    return dict(name='cut_threshold', route='cuda', source='tdgp_torch/csrc/quantile.cu',
                replaces='tdgp/rendering/renderer.py:54 (_apply_cut_quantile\'s jnp.quantile, '
                         'renderer.py:80 and :125; no Pallas kernel)',
                max_abs_err=worst, cases_bit_for_bit=checked, clamp_equals_softplus=clamp_same,
                ms=times['served']['cold'], ms_warm=times['served']['warm'],
                plain_ms=times['served_sort']['warm'],
                library_ms=times['served_library']['warm'], bound_ms=bound_ms,
                bound_by=bound_by, bf16_ms=times['served_bf16']['cold'],
                coarse_ms=times['coarse']['cold'], coarse_ms_warm=times['coarse']['warm'],
                coarse_plain_ms=times['coarse_sort']['warm'],
                coarse_library_ms=times['coarse_library']['warm'],
                coarse_bound_ms=coarse_bound_ms)


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
          f'warm ({threshold_ms:.4f} ms of it the threshold, the select over '
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
    the registry's; one nfs256 batch under render_bf16 through K3's cut entry
    with bf16 loads (vs plain, launches held). Returns (the launches of nfs256
    and that batch, the readings, K3's cut
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
    threshold = threshold_kernel_phase(ray_march, g)
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
    with BiasActCalls() as calls, SortCalls() as sorts:
        nfs = registry.nfs256(ctx)['nfs256']
    torch.cuda.synchronize()
    nfs_s = time.perf_counter() - t0
    launches = launch_counts(counters)
    gc = ctx.cfg.generator
    # one launch per ray chunk of each render call (of _resolve_batch_gpu images)
    chunks = (256 // ctx._resolve_batch_gpu()) * (gc.img_resolution ** 2) // (gc.max_batch_res ** 2)
    # the threshold: one select for the coarse march and one for the final march of a chunk
    expected = {'ray_march_merged_cut': chunks, 'ray_march_merged': 0, 'ray_march_reduced': 0,
                'cut_threshold': 2 * chunks, 'triplane_mlp': 2 * chunks,
                **{n: calls.count[n] for n in K5_NAMES.values()}}
    got = {k: launches.get(k) for k in expected}
    print(f'nfs256 of the flagship: {nfs!r} in {nfs_s:.1f} s; launches {launches} (expected '
          f'{expected}); the sort on the card {sorts.count} times (expected 0)')
    check(np.isfinite(nfs) and nfs >= 1.0, 'nfs256 is not a score')
    check(got == expected and sorts.count == 0, 'kernel launch counts of nfs256')

    # one batch of nfs256's depth maps under generator.render_bf16: the cut entry's bf16 loads
    ctx16 = context(OVERRIDES + RENDER_BF16, device, 4)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        reset_counts(counters)
        with BiasActCalls() as calls16, SortCalls() as sorts16:
            maps16 = depth_maps(ctx16)
        launches16 = launch_counts(counters)
        with plain_versions(k1=False, k3=True):
            plain16 = depth_maps(ctx16)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    chunks16 = (4 // ctx16._resolve_batch_gpu()) * (gc.img_resolution ** 2) // (gc.max_batch_res ** 2)
    expected16 = {**{k: 0 for k in launches16 if k not in K5_NAMES.values()},
                  'ray_march_merged_cut_bf16': chunks16, 'cut_threshold': 2 * chunks16,
                  'triplane_mlp_bf16': 2 * chunks16,
                  **{n: calls16.count[n] for n in K5_NAMES.values()}}
    rel16 = float((maps16 - plain16).abs().max()) / float(plain16.abs().max())
    print(f'nfs256 depth maps under render_bf16 [4, 256, 256, 1], cuDNN deterministic: K3 cut '
          f'entry with bf16 loads vs its plain version {rel16:.3g} of max |depth| (<= '
          f'{NFS_KERNEL_LIMIT:g}); launches {launches16} (expected {expected16})')
    check(launches16 == expected16 and sorts16.count == 0,
          'kernel launch counts of nfs256 under render_bf16')
    check(rel16 <= NFS_KERNEL_LIMIT, 'render_bf16 depth maps: K3 cut bf16 disagrees with its plain '
                                     'version')
    for k, v in launches16.items():  # the metrics path's launches: nfs256 and this batch
        launches[k] = launches.get(k, 0) + v
    readings.update(depth_render_bf16_kernel_vs_plain=rel16)
    del ctx16
    readings.update(nfs256=nfs, nfs256_s=nfs_s, depth_kernel_vs_plain=rel,
                    depth_all_plain=rel_all, depth_all_plain_share=share_all,
                    depth_card_vs_cpu=cpu_diff, depth_card_vs_cpu_share=cpu_share,
                    depth_card_vs_cpu_uncut=uncut_diff, batch_nfs_card_vs_cpu=nfs_rel,
                    cut_zeroed=k3_cut['zeroed'], nfs256_sorts_on_card=sorts.count)

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
    return launches, readings, k3_cut, threshold


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
          f'K3 unmerged 0, K4 2 x {chunks} x {n} (in their bf16 entries under render_bf16, the '
          f'float32 ones never), K5 the bias_act calls on CUDA tensors by dtype '
          f'{dict(calls.count)} ({calls.strided} on tensors that are not contiguous)')
    sfx, other = ('_bf16', '') if gc.render_bf16 else ('', '_bf16')  # the bf16 render's entries
    check(launches['ray_march_merged' + sfx] == chunks * n and launches['ray_march_reduced'] == 0
          and launches.get('ray_march_merged' + other, 0) == 0, 'K3 launch counts')
    check(launches['triplane_mlp' + sfx] == 2 * chunks * n
          and launches.get('triplane_mlp' + other, 0) == 0, 'K4 launch count')
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


RENDER_BF16 = ['generator.render_bf16=true']  # the bf16 render view of the served flagship
RENDER_BF16_CPU_OF_FLOOR = 1.0  # render_bf16, card vs CPU at 64^2: relative L2 over the floor


def render_bf16_serve_phase(served, requests, serve_own, density_counters, device='cuda'):
    """The committed flagship served with `generator.render_bf16=true` at its
    own precision (bf16 blocks 64-512): 3 requests after a warm-up
    (`serve_run`: K3's merged entry with bf16 loads 4 and K4's bf16 entry 8
    launches per request, their float32 entries never), ms per request,
    images/s and peak memory beside the default render, and the relative L2
    to its image; the density grid of one chunk of 32^3 points still
    through the float32 K4 (`compute_densities` casts nothing, as in JAX);
    the image through K3's and K4's bf16 entries against their plain
    versions on the card with cuDNN deterministic (K3 alone <= 1e-4 max abs;
    K4 and K5 too as a share of the bf16 floor, printed); and the card
    against the port on the CPU at a 64^2 output, relative L2 within
    RENDER_BF16_CPU_OF_FLOOR x the floor (the card's render_bf16 image
    against its default render at 64^2). Returns the serve readings."""
    from tdgp_torch.profile_serving import OVERRIDES, PSI, RUN_DIR
    from tdgp_torch.serving import load_generator, make_serving_fn
    from tdgp_torch.ops import triplane_mlp
    G = load_generator(RUN_DIR, device, OVERRIDES + RENDER_BF16)
    check(G.cfg.render_bf16 and not G.cfg.fp32_only, 'the render_bf16 view is not served')
    r = serve_run(G, served, requests, 'render_bf16 (bf16 planes, features and MLP; blocks '
                                       '64-512 bf16)')

    def rel(a, b):
        return float((a - b).norm() / b.norm())
    floor = rel(r['images'][0], serve_own['images'][0])
    print(f'render_bf16 vs the default render (bf16 blocks), served image: relative L2 '
          f'{floor:.4g}; ms per request {r["ms"]:.1f} vs {serve_own["ms"]:.1f}, images/s '
          f'{r["images_per_s"]:.2f} vs {serve_own["images_per_s"]:.2f}, peak memory '
          f'{r["peak_gib"]:.2f} vs {serve_own["peak_gib"]:.2f} GiB')
    with torch.no_grad():
        z, c, angles = requests[0][:3]
        ws = G.map_ws(z[:1], c[:1], camera_angles=angles[:1], truncation_psi=PSI)
        coords = torch.rand(1, 32 ** 3, 3, device=device) - 0.5
        reset_counts(density_counters)
        sigma = G.synthesis.compute_densities(ws, coords)
    check(sigma.dtype == torch.float32 and triplane_mlp.triplane_mlp.launches == 1
          and triplane_mlp.triplane_mlp_bf16.launches == 0,
          'the density grid under render_bf16 left the float32 K4')
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        serve = make_serving_fn(G, truncation_psi=PSI)
        kernels = serve(*requests[0])
        with plain_versions(k1=False, k3=True):
            k3_plain = serve(*requests[0])
        with plain_versions(k1=False, k3=True, k4=True, k5=True):
            all_plain = serve(*requests[0])
    finally:
        torch.backends.cudnn.deterministic = deterministic
    k3_diff = float((kernels - k3_plain).abs().max())
    all_rel = rel(kernels, all_plain) / floor
    print(f'render_bf16 image, cuDNN deterministic: K3 merged bf16 vs its plain version max abs '
          f'{k3_diff:.3g} (<= 1e-4); K3, K4 and K5 all plain: relative L2 {all_rel:.3g} of the '
          f'bf16 floor (K4 bf16 and K5 flip bf16 roundings by their sum orders)')
    check(k3_diff <= 1e-4, 'render_bf16: K3 merged bf16 disagrees with its plain version')
    card = make_serving_fn(G, truncation_psi=PSI, resolution=64)(*requests[0]).cpu()
    card_default = make_serving_fn(load_generator(RUN_DIR, device, OVERRIDES), truncation_psi=PSI,
                                   resolution=64)(*requests[0]).cpu()
    G_cpu = load_generator(RUN_DIR, 'cpu', OVERRIDES + RENDER_BF16)
    cpu = make_serving_fn(G_cpu, truncation_psi=PSI, resolution=64)(
        *[t.cpu() for t in requests[0]])
    del G_cpu
    cpu_floor = rel(card, card_default)
    got = rel(card, cpu)
    print(f'render_bf16, card vs CPU at 64x64: relative L2 {got:.4g}, floor {cpu_floor:.4g} '
          f'({got / cpu_floor:.3f} of it; limit {RENDER_BF16_CPU_OF_FLOOR})')
    check(got <= RENDER_BF16_CPU_OF_FLOOR * cpu_floor, 'render_bf16: the card disagrees with the CPU')
    r.update(rel_to_default=floor, all_plain_of_floor=all_rel, k3_plain_max_abs=k3_diff,
             cpu_of_floor=got / cpu_floor)
    return r


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
    card = smi.stdout.strip()
    print(f'card: {card}')
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}')

    seconds = {}
    with phase('build', seconds):
        for name, path in cuda_build.build(list(cuda_build.sources()), ptxas_info=True).items():
            print(f'built {name}: {os.path.relpath(path, ROOT)}')

    with phase('kernel', seconds):
        k3, k3_merged = kernel_phase(ray_march)

    served = [ray_march.ray_march_reduced, ray_march.ray_march_merged,
              ray_march.ray_march_merged_bf16, triplane_mlp.triplane_mlp,
              triplane_mlp.triplane_mlp_bf16, bias_act.bias_act]
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

    with phase('serve render_bf16', seconds):
        serve_bf16 = render_bf16_serve_phase(served, requests, serve_own,
                                             [triplane_mlp.triplane_mlp,
                                              triplane_mlp.triplane_mlp_bf16])

    with phase('train kernels', seconds):
        k3_bwd, k1 = train_kernel_phase(ray_march, splat)

    cfg = profile_training.train_config()
    sched = compute_schedules(cfg, profile_training.CUR_NIMG)
    with phase('train check', seconds):
        train_checks = {label: train_check_phase(Trainer, Draws, sched,
                                                 profile_training.train_config,
                                                 profile_training.make_batch, overrides)
                        for label, overrides in (('float32', profile_training.FP32),
                                                 ('bf16', ()), ('gmain_render_bf16', GMAIN_BF16))}
        fresh_image_diff = {}
        for label, overrides in (('float32', profile_training.FP32), ('bf16', ()),
                                 ('dmain_fake_bf16', FAKE_BF16)):
            fresh_image_diff[label] = fresh_fakes_check_phase(
                Trainer, Draws, sched, profile_training.train_config, profile_training.make_batch,
                overrides)

    with phase('inference kernels', seconds):
        k4, k5, k5_bf16 = inference_kernel_phase(bias_act, triplane_mlp, FullyConnected,
                                                 init_weights)

    with phase('render bf16 kernels', seconds):
        k4_bf16, k3_merged_bf16, k3_cut_bf16, k1_bf16 = render_bf16_kernel_phase(
            ray_march, splat, triplane_mlp, FullyConnected, init_weights)

    with phase('inference', seconds), tempfile.TemporaryDirectory() as tmp_dir:
        infer_launches = inference_phase(served, tmp_dir, RUN_DIR, OVERRIDES)

    train_counters = [splat.triplane_splat, splat.triplane_splat_bf16,
                      ray_march.ray_march_reduced, ray_march.ray_march_reduced_bwd,
                      ray_march.ray_march_merged, ray_march.ray_march_merged_bf16,
                      triplane_mlp.triplane_mlp, triplane_mlp.triplane_mlp_bf16, bias_act.bias_act]
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
        train_gmain16_launches, k1_bf16_step, train_gmain16 = train_phase(
            Trainer, Draws, sched, profile_training.train_config(GMAIN_BF16),
            profile_training.make_batch, profile_training.capture_splat_bf16_calls,
            profile_training.BATCH, train_counters,
            'own precision, training.gmain_render_bf16=true', step_points=step_points_bf16_phase)
        train_fake16_launches, _, train_fake16 = train_phase(
            Trainer, Draws, sched, profile_training.train_config(FRESH + FAKE_BF16),
            profile_training.make_batch, None, profile_training.BATCH, train_counters,
            'own precision, fresh Dmain fakes through training.dmain_fake_bf16=true')
        for what, r in (('reused fakes', train_own), ('fresh fakes', train_fresh),
                        ('reused fakes, float32 cut', train_fp32),
                        ('reused fakes, gmain_render_bf16', train_gmain16),
                        ('fresh fakes, dmain_fake_bf16', train_fake16)):
            print(f'satellite step, {what}: {r["plain_ms"]:.1f} ms per plain step, '
                  f'{r["r1_ms"]:.1f} ms per R1 step, {r["images_per_s"]:.2f} images/s at 15:1, '
                  f'peak memory {r["peak_gib"]:.2f} GiB')
    train_images_per_s = train_own['images_per_s']
    k1.update(k1_step)
    k1_bf16.update(k1_bf16_step)

    with tempfile.TemporaryDirectory() as tmp_dir:
        with phase('loop', seconds):
            loop_launches, loop_readings = loop_phase(
                tmp_dir, [splat.triplane_splat, ray_march.ray_march_reduced,
                          ray_march.ray_march_reduced_bwd, ray_march.ray_march_merged,
                          triplane_mlp.triplane_mlp, bias_act.bias_act], train_images_per_s)
        with phase('metrics', seconds):
            metrics_launches, metrics_readings, k3_cut, threshold = metrics_phase(
                ray_march, [splat.triplane_splat, ray_march.ray_march_reduced,
                            ray_march.ray_march_reduced_bwd, ray_march.ray_march_merged,
                            ray_march.ray_march_merged_cut, ray_march.ray_march_merged_bf16,
                            ray_march.ray_march_merged_cut_bf16, ray_march.cut_threshold,
                            triplane_mlp.triplane_mlp, triplane_mlp.triplane_mlp_bf16,
                            bias_act.bias_act],
                os.path.join(tmp_dir, 'data'))
        with phase('settings', seconds):
            settings_launches, settings_train = settings_train_phase(
                Trainer, Draws, sched, profile_training.train_config, profile_training.make_batch,
                train_counters, card)
            settings_render_launches, settings_render = settings_render_phase(served, card)
            custom_launches, custom_loop = settings_loop_phase(
                tmp_dir, [splat.triplane_splat, ray_march.ray_march_reduced,
                          ray_march.ray_march_reduced_bwd, ray_march.ray_march_merged,
                          triplane_mlp.triplane_mlp, bias_act.bias_act], card)
    pl_counters = [splat.triplane_splat, splat.triplane_splat_gather,
                   splat.triplane_splat_dcoords, ray_march.ray_march_reduced,
                   ray_march.ray_march_reduced_bwd, ray_march.ray_march_reduced_bwd_bwd,
                   ray_march.ray_march_merged, triplane_mlp.triplane_mlp, bias_act.bias_act]
    with phase('pl', seconds):
        k3_bwd_bwd, k1_gather, k1_dcoords = pl_kernel_phase(ray_march, splat)
        pl_checks = {label: pl_check_phase(Trainer, Draws, sched, profile_training.train_config,
                                           profile_training.make_batch, overrides, card)
                     for label, overrides in (('float32', profile_training.FP32), ('bf16', ()))}
        pl_launches, pl_own, gather_step = pl_train_phase(
            Trainer, Draws, sched, profile_training.train_config(PL), profile_training.make_batch,
            profile_training.BATCH, pl_counters, 'own precision (bf16 G and D)', card,
            capture_gather_calls=profile_training.capture_gather_calls)
        k1_gather.update(gather_step)
        pl_fp32_launches, pl_fp32, _ = pl_train_phase(
            Trainer, Draws, sched, profile_training.train_config(profile_training.FP32 + PL),
            profile_training.make_batch, profile_training.BATCH, pl_counters, 'float32 cut', card)
    sg2_counters = [splat.triplane_splat, ray_march.ray_march_reduced,
                    ray_march.ray_march_reduced_bwd, ray_march.ray_march_merged,
                    triplane_mlp.triplane_mlp, bias_act.bias_act]
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
               'serve_render_bf16': serve_bf16['launches'],
               'inference': infer_launches, 'train': train_launches,
               'train_float32': train_fp32_launches, 'train_fresh_fakes': train_fresh_launches,
               'train_gmain_render_bf16': train_gmain16_launches,
               'train_dmain_fake_bf16': train_fake16_launches,
               'loop': loop_launches, 'settings_train': settings_launches,
               'settings_render': settings_render_launches,
               'settings_custom_loop': custom_launches, 'stylegan2': sg2_launches,
               'stylegan2_float32': sg2_fp32_launches, 'stylegan2_loop': sg2_loop_launches,
               'metrics': metrics_launches, 'pl': pl_launches, 'pl_float32': pl_fp32_launches}
    k5['bound_ms_per_request'] = serve_fp32['k5_bound_ms']
    k5_bf16['bound_ms_per_request'] = serve_own['k5_bound_ms']
    k5['launches_per_request'] = {'own precision': serve_own['k5_per_request']['bias_act'],
                                  'float32 cut': serve_fp32['k5_per_request']['bias_act']}
    k5_bf16['launches_per_request'] = {'own precision':
                                       serve_own['k5_per_request']['bias_act_bf16']}
    new_entries = (k4_bf16, k3_merged_bf16, k3_cut_bf16, k1_bf16, threshold, k3_bwd_bwd,
                   k1_gather, k1_dcoords)
    for k in (k3, k3_merged, k3_cut, k3_bwd, k1, k4, k5, k5_bf16, *new_entries):
        k['launches_by_path'] = {path: got.get(k['name'], 0) for path, got in by_path.items()}
        k['launches'] = sum(k['launches_by_path'].values())

    print(f'phases (s): {json.dumps({k: round(v, 1) for k, v in seconds.items()})}, '
          f'total {time.perf_counter() - t_start:.1f} s')
    print(f'loop: {json.dumps(loop_readings)}')
    print(f'train check: {json.dumps({"card": card, **train_checks})}')
    print(f'settings: ' + json.dumps({'card': card, 'train': settings_train,
                                      'render': settings_render, 'custom_loop': custom_loop}))
    train_readings = {'reused_fakes': train_own, 'fresh_fakes': train_fresh,
                      'reused_fakes_float32': train_fp32, 'fresh_fake_image_diff': fresh_image_diff,
                      'gmain_render_bf16': train_gmain16, 'dmain_fake_bf16': train_fake16}
    print(f'train: {json.dumps(train_readings)}')
    sg2_readings = {'card': card, 'own': sg2_own, 'float32': sg2_fp32, 'loop': sg2_loop,
                    'check': sg2_check}
    print(f'stylegan2: {json.dumps(sg2_readings)}')
    print(f'metrics: {json.dumps(metrics_readings)}')
    print(f'pl: ' + json.dumps({'card': card, 'check': pl_checks, 'own': pl_own,
                                'float32': pl_fp32}))
    print(f'serve render_bf16: ' + json.dumps({k: v for k, v in serve_bf16.items()
                                               if k not in ('serve', 'images')}))
    print(json.dumps({'kernels': [k3, k3_merged, k3_cut, k3_bwd, k1, k4, k5, k5_bf16,
                                  *new_entries]}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
