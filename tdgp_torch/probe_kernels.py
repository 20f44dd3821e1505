"""Where the time of a kernel goes, on one card: K4's bf16 entry, the
quantile threshold's select, K1's bf16 entry, K3's merged entry with bf16
loads and K3's second order.

    python3 -m tdgp_torch.probe_kernels [--only mlp_bf16|select|k1_bf16|k1_float32_caps|
                                               shared_atomic|k3_merged_bf16|k3_bwd_bwd]
                                        [--parent DIR]

Builds variants of a kernel's source of this tree, each a copy under
`tdgp_torch/build/probe/` with a few lines of the source replaced (the
edits are listed below; the source itself has no hooks for them), and
times each at the shapes of the main path, warm (`chip_smoke.cuda_ms`, the
calls enqueued ahead) and cold after an L2 flush
(`chip_smoke.cold_ms`), in turns (every variant once, then again in reverse
order):
  - K4 bf16 (`csrc/triplane_mlp.cu`) at [4, 524288, 32] -> 64 -> 4: the
    kernel at 2, 4 (its own) and 8 blocks per SM, its loads only, and its
    loads and stores without the products and the epilogue; and a plain
    copy kernel that reads the same features (16 bytes a thread) and writes
    the same 8 bytes a point, the floor of the bytes (151 MB, 0.0451 ms at
    3.35 TB/s). The kernel variants' outputs are held against the plain
    version (within one bf16 ulp of the outputs' scale).
  - The select (`csrc/quantile.cu`) at the served chunk's raw densities
    [4, 16384, 32 + 32] (softplus in the kernel) and the coarse chunk's
    clamped ones [4, 16384, 32]: all three passes (held bit for bit against
    the sort), the first two, the first alone, the first without the keys'
    store, and the memset of the counters alone.
  - K1's bf16 entry (`csrc/splat.cu`) at `chip_smoke.py`'s uniform points
    and on the two calls of a `gmain_render_bf16` step (`k1_parts`): the
    whole wrapper, the bins, the rank kernel, the memset of the (dtx, dty)
    scratch, and the entry given the bins whole, without its coordinate
    kernel, and with every strip walked as empty; this tree's at 12 and 20
    blocks an SM beside its own 16; with `--parent DIR` the same parts of
    DIR's `splat.cu`, in the same turns.
  - `k1_float32_caps`: K1's float32 entry (uniform points, a plain
    satellite step's two calls) and its second-order scatter (the `pl`
    phase's shapes) at caps of 12, 16 and 20 blocks an SM, in turns.
  - `shared_atomic`: the SASS of a float atomicAdd to shared memory.
  - `k3_merged_bf16`: K3's merged entry (`csrc/ray_march.cu`) at the served
    chunk with bf16 colours and densities [4, 16384, 32 + 32, 3], at the
    training shape with bf16 colours and float32 densities [16, 4096,
    32 + 32, 3] (Dmain's fresh fakes), and in float32 at the served chunk
    (`K3_VARIANTS`): this tree's kernel whole, its stage alone, with the
    merge search, without the merge (each lane's samples in set order), its
    march without device memory (every warp stages the first rays, which
    the L2 holds), at 4 and 16 lanes a ray, and at 12 and 16 blocks an SM;
    the whole kernel and the march also with the relu clamp; with
    `--parent DIR` DIR's kernel whole, its stage alone, with the widen, and
    with the merge search. The whole kernels and the lane variants held
    against the plain version (<= 1e-5); each build's registers, stack and
    shared memory (`cuobjdump --dump-resource-usage`) and the static SASS
    counts of the merged kernel printed.
  - `k3_bwd_bwd`: K3's second order at PL's render [8, 4096, 64, 3] (no
    depth cotangent, as on the path, and with one): this tree's kernel
    whole (also with the relu clamp), its staging alone, and without the
    outputs' stores; DIR's kernel with
    `--parent DIR`. The whole kernels held to the plain version
    (`chip_smoke.PL_KERNEL_LIMIT`); registers and SASS counts printed.
Prints the card's name and power limit, one line per variant, and a JSON
object of the times as its last line. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

from tdgp_torch.ops import cuda_build, triplane_mlp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, P, F, HID, OUT = 4, 16384 * 32, 32, 64, 4
BF16_ENTRY = '// ------------------------------------------------------------ the bf16 entry'
PRODUCTS = ('#pragma unroll\n    for (int m = 0; m < 2; ++m) {',
            "    __syncwarp();\n    // the warp's 32 sigmas")
TILE_READY = '    const long long first = tile * kWarpTile;\n'


def per_sm(n):
    """K4 bf16 at n blocks per SM (its launch bounds and its grid)."""
    return lambda head, entry: head + entry.replace('kBlocksPerSm', str(n))


def loads_only(head, entry):
    """K4 bf16 with every tile skipped once its loads have landed."""
    return head + _replace(entry, TILE_READY, TILE_READY + '    __syncwarp();\n    continue;\n')


def loads_and_stores(head, entry):
    """K4 bf16 with the products and the epilogue replaced by a copy of each
    lane's first 8 bytes of features to its outputs' stage."""
    start, end = entry.index(PRODUCTS[0]), entry.index(PRODUCTS[1])
    copy = ('    for (int o = 0; o < 2; ++o)\n      ys[2 * lane + o] = '
            '*reinterpret_cast<const uint32_t*>(xs + lane * kRow + 2 * o);\n')
    return head + entry[:start] + copy + entry[end:]


VARIANTS = {  # name -> edit of (the source before the bf16 entry, the bf16 entry), or None
    'kernel': None, 'kernel_2_per_sm': per_sm(2), 'kernel_8_per_sm': per_sm(8),
    'loads_only': loads_only, 'loads_and_stores': loads_and_stores}

COPY_SOURCE = r'''
#include <cuda_runtime.h>
// Reads 64 bytes (4 x 16) and writes 8 bytes a point, grid-stride.
__global__ void copy_kernel(const uint4* __restrict__ in, uint2* __restrict__ out,
                            long long n_points) {
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < n_points;
       p += (long long)gridDim.x * blockDim.x) {
    const uint4 a = in[4 * p], b = in[4 * p + 1], c = in[4 * p + 2], d = in[4 * p + 3];
    out[p] = make_uint2(a.x ^ b.y ^ c.z ^ d.w, a.w ^ b.z ^ c.y ^ d.x);
  }
}
extern "C" int probe_copy(const void* in, void* out, long long n_points, void* stream) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  copy_kernel<<<sms * 8, 256, 0, (cudaStream_t)stream>>>(
      static_cast<const uint4*>(in), static_cast<uint2*>(out), n_points);
  return (int)cudaGetLastError();
}
'''


PASSES = 'pass < kPasses && e == cudaSuccess'
KEY_STORE = '      if (i < n) keys[i] = k;\n'
AFTER_MEMSET = '  if (e != cudaSuccess) return (int)e;\n'
SELECT_VARIANTS = {  # name -> the select's source edits (old, new), each found once
    'select': (), 'passes_1_2': ((PASSES, PASSES.replace('kPasses', '2')),),
    'pass_1': ((PASSES, PASSES.replace('kPasses', '1')),),
    'pass_1_no_keys': ((PASSES, PASSES.replace('kPasses', '1')), (KEY_STORE, '')),
    'memset': ((AFTER_MEMSET, '  return (int)e;\n'),)}


def _replace(text, old, new):
    if text.count(old) != 1:
        raise ValueError(f'the probe\'s edit expects {old!r} once in the source, found '
                         f'{text.count(old)}: the source has changed')
    return text.replace(old, new)


def build_all(texts):
    """{name: CUDA source text} -> {name: library}: each written to
    `build/probe/<name>.cu` and built with the port's nvcc flags (`csrc/` on
    the include path), one nvcc for each, all started together."""
    folder = os.path.join(cuda_build.BUILD_DIR, 'probe')
    os.makedirs(folder, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        path, out = os.path.join(folder, f'{name}.cu'), os.path.join(folder, f'lib{name}.so')
        with open(path, 'w') as f:
            f.write(text)
        procs[name] = out, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, '-I', cuda_build.CSRC_DIR, '-o', out,
             path])
    for name, (_, proc) in procs.items():
        if proc.wait():
            raise RuntimeError(f'nvcc failed on the probe variant {name}')
    return {name: ctypes.CDLL(out) for name, (out, _) in procs.items()}


def build(name, text):
    """`build_all` of one source."""
    return build_all({name: text})[name]


def source(name):
    with open(cuda_build.sources()[name]) as f:
        return f.read()


def in_turns(chip_smoke, fns):
    """{name: {'warm': [ms, ms], 'cold': [ms, ms]}}: every variant once, then in reverse order."""
    times = {name: {'warm': [], 'cold': []} for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            times[name]['warm'].append(chip_smoke.cuda_ms(fns[name], 50, prefill=True))
            times[name]['cold'].append(chip_smoke.cold_ms(fns[name]))
    return times


def report(label, times, bound_ms=None, bytes_moved=None):
    for name, t in times.items():
        bound = ('' if bound_ms is None else
                 f'; bound of the bytes {bound_ms:.4f} ms ({bytes_moved / 1e6:.1f} MB)')
        print(f'{label} {name}: warm {t["warm"][0]:.4f} / {t["warm"][1]:.4f} ms, cold '
              f'{t["cold"][0]:.4f} / {t["cold"][1]:.4f} ms (turns: forward, reverse){bound}')


def mlp_bf16(chip_smoke):
    bf = torch.bfloat16
    g = torch.Generator(device='cuda').manual_seed(0)
    feats = torch.randn(N, P, F, device='cuda', generator=g).to(bf)
    weights = [(torch.randn(F, HID, device='cuda', generator=g) / F ** 0.5).to(bf),
               (torch.randn(HID, device='cuda', generator=g) * 0.1).to(bf),
               (torch.randn(HID, OUT, device='cuda', generator=g) / HID ** 0.5).to(bf),
               (torch.randn(OUT, device='cuda', generator=g) * 0.1).to(bf)]
    rgb = torch.empty(N, P, OUT - 1, dtype=bf, device='cuda')
    sigma = torch.empty(N, P, dtype=bf, device='cuda')
    ref = triplane_mlp.triplane_mlp_plain_bf16(feats, *weights)
    scale_ulp = max(float(r.float().abs().max()) for r in ref) * 2.0 ** -7

    fns = {}
    text = source('triplane_mlp')
    at = text.index(BF16_ENTRY)
    for name, edit in VARIANTS.items():
        variant = text if edit is None else edit(text[:at], text[at:])
        fn = build(f'mlp_bf16_{name}', variant).tdgp_triplane_mlp_bf16
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_void_p]
        fns[name] = lambda fn=fn: fn(*[t.data_ptr() for t in (feats, *weights, rgb, sigma)],
                                     N * P, F, HID, OUT, torch.cuda.current_stream().cuda_stream)
        if name.startswith('kernel'):  # the whole kernel: held against the plain version
            if fns[name]():
                raise RuntimeError(f'{name} failed to launch')
            torch.cuda.synchronize()
            worst = max(float((a.float() - b.float()).abs().max())
                        for a, b in zip((rgb, sigma), ref))
            print(f'K4 bf16 {name}: max abs diff from the plain version {worst:.3g} (one bf16 ulp '
                  f"at the outputs' scale {scale_ulp:.3g})")
            if worst > scale_ulp:
                raise AssertionError(f'{name} disagrees with the plain version')
    copy = build('copy', COPY_SOURCE).probe_copy
    copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    copy_out = torch.empty(N * P, 4, dtype=bf, device='cuda')
    fns['copy'] = lambda: copy(feats.data_ptr(), copy_out.data_ptr(), N * P,
                               torch.cuda.current_stream().cuda_stream)
    times = in_turns(chip_smoke, fns)
    bytes_moved = 2 * N * P * (F + OUT)
    bound_ms = 1e3 * bytes_moved / chip_smoke.HBM_BYTES_PER_S
    report('K4 bf16', times, bound_ms, bytes_moved)
    return {'bound_ms': bound_ms, 'times': times}


def select(chip_smoke):
    from tdgp_torch.ops import ray_march
    g = torch.Generator(device='cuda').manual_seed(0)
    d1, d2 = (torch.randn(4, 16384, 32, device='cuda', generator=g) * 2 for _ in range(2))
    coarse = ray_march.clamp_densities(d1)
    out = torch.empty(1, device='cuda')
    text = source('quantile')
    libs = {}
    for name, edits in SELECT_VARIANTS.items():
        variant = text
        for old, new in edits:
            variant = _replace(variant, old, new)
        libs[name] = build(f'select_{name}', variant)
    result = {}
    for label, a, b, clamp in (('served', d1, d2, 0), ('coarse', coarse, None, -1)):
        n = a.numel() + (0 if b is None else b.numel())
        low, high, w_low, w_high = ray_march._quantile_weights(n, 0.5)
        scratch = torch.empty(ray_march._select_kernel()[1](n), dtype=torch.uint8, device='cuda')
        fns = {}
        for name, lib in libs.items():
            fn = lib.tdgp_quantile_select
            fn.argtypes = ray_march._select_kernel()[0].argtypes
            args = (a.data_ptr(), a.numel(), 0 if b is None else b.data_ptr(),
                    0 if b is None else b.numel(), 0, clamp, 1.0, low, high, float(w_low),
                    float(w_high), out.data_ptr(), 0, scratch.data_ptr())
            fns[name] = lambda fn=fn, args=args: fn(*args, torch.cuda.current_stream().cuda_stream)
        ref = (ray_march.cut_threshold_plain(d1, d2, 0.5) if b is not None
               else ray_march.quantile_plain(coarse, 0.5))
        if fns['select']():
            raise RuntimeError('the select failed to launch')
        torch.cuda.synchronize()
        if not chip_smoke.same_bits(out, ref):
            raise AssertionError(f'select at the {label} chunk: {out.tolist()} against the '
                                 f'sort\'s {ref.tolist()}')
        times = in_turns(chip_smoke, fns)
        bytes_moved = 4 * n
        report(f'select {label}', times, 1e3 * bytes_moved / chip_smoke.HBM_BYTES_PER_S,
               bytes_moved)
        result[label] = times
    return result


K1_AFTER_WALK = '  if (err != 0 || !coords_grad) return err;\n'
K1_WALK = 'for (int base = first; base < last; base += 32) {'
K1_VARIANTS = {  # name -> K1's source edits (old, new), each found at least once
    'entry': (), 'no_coords_kernel': ((K1_AFTER_WALK, '  return err;\n'),),
    'store_only': ((K1_AFTER_WALK, '  return err;\n'),
                   (K1_WALK, K1_WALK.replace('< last', '< first')))}
K1_OCCUPANCY = {  # this tree's bf16 group walk at other caps of blocks an SM (its registers)
    f'blocks_{n}': (('constexpr int kGroupBlocksPerSmBf16 = 16;',
                     f'constexpr int kGroupBlocksPerSmBf16 = {n};'),) for n in (12, 20)}
K1_F32_OCCUPANCY = {  # the float32 entry's and the second-order scatter's caps
    f'f32_blocks_{n}': (('constexpr int kGroupBlocksPerSmF32 = 12;',
                         f'constexpr int kGroupBlocksPerSmF32 = {n};'),) for n in (12, 16, 20)}

SHARED_ATOMIC_SOURCE = r'''
#include <cuda_runtime.h>
// One float atomicAdd to shared memory, for its SASS.
__global__ void shared_float_atomic(float* out, const float* in) {
  __shared__ float s[32];
  s[threadIdx.x & 31] = 0.f;
  __syncthreads();
  atomicAdd(&s[(threadIdx.x * 7) & 31], in[threadIdx.x]);
  __syncthreads();
  out[threadIdx.x] = s[threadIdx.x & 31];
}
extern "C" int probe_shared_atomic(float* out, const float* in) {
  shared_float_atomic<<<1, 64>>>(out, in);
  return (int)cudaGetLastError();
}
'''


def _replace_all(text, old, new):
    if old not in text:
        raise ValueError(f'the probe\'s edit expects {old!r} in the source: the source has changed')
    return text.replace(old, new)


def edited(text, edits):
    for old, new in edits:
        text = _replace_all(text, old, new)
    return text


def k1_bf16_inputs(gen):
    """K1 bf16's inputs: `chip_smoke.py`'s uniform points, and the two calls
    of one `gmain_render_bf16` step of the satellite trainer (the fine pass
    keeping its float32 sum, the coarse pass adding it)."""
    from tdgp_torch import compare_kernels, profile_training
    planes, coords, g, scale = compare_kernels.uniform_points(gen, dtype=torch.bfloat16)
    out = [('uniform', dict(planes=planes, coords=coords, g=g, scale=scale))]
    trainer, *step = compare_kernels.training_trainer(['training.gmain_render_bf16=true'])
    for label, args in profile_training.capture_splat_bf16_calls(trainer, *step):
        out.append((f'step_{label}', {k: v.detach() if torch.is_tensor(v) else v
                                      for k, v in args.items()}))
    return out


def k1_parts(chip_smoke, sources, gen):
    """K1's bf16 entry split into its parts, for each source of `sources`
    ({label: the text of a splat.cu}), on `k1_bf16_inputs`: the whole
    wrapper; the bins (both kernels and torch's sum of the counts), and the
    rank kernel alone; the memset of the (dtx, dty) scratch; and the entry
    given the bins as a variant of the source: all of it ('entry': memset,
    strip walk, coordinate kernel), without the coordinate kernel, and with
    every strip walked as empty ('store_only': the offsets read, the zeros
    or the addend stored). walk = no_coords_kernel - store_only, the
    coordinate kernel = entry - no_coords_kernel, wrapper_rest = wrapper -
    entry - bins (each source's own bins: an earlier `splat.cu` without the
    rank kernel in its two passes, `compare_kernels.two_pass_bins`). For this tree also its
    entry at other caps of blocks an SM (`K1_OCCUPANCY`). The bound counts
    the touched texels and the cotangent in 2 bytes, the addend read in 4,
    g_planes written in 2 (bf16) or 4 (kept in float32)."""
    from tdgp_torch import compare_kernels
    from tdgp_torch.ops import splat
    variants = {(who, name): edits for who in sources for name, edits in K1_VARIANTS.items()}
    if 'this' in sources:
        variants.update({('this', name): edits for name, edits in K1_OCCUPANCY.items()})
    built = build_all({f'k1_{who}_{name}': edited(sources[who], edits)
                       for (who, name), edits in variants.items()})
    libs = {key: splat.bind(built[f'k1_{key[0]}_{key[1]}']) for key in variants}
    result = {}
    for label, args in k1_bf16_inputs(gen):
        planes, coords, g, scale = args['planes'], args['coords'], args['g'], args['scale']
        n3, h, w, f = planes.shape
        n, p = coords.shape[0], coords.shape[1]
        addend, round_out = args.get('addend'), args.get('round_out', True)
        coords_grad = args.get('coords_grad', True)
        entries, offsets = splat.triplane_splat_bins(coords, h, w, scale)
        g_planes = torch.empty(planes.shape, device='cuda',
                               dtype=torch.bfloat16 if round_out else torch.float32)
        d_scratch = torch.empty(n3, p, 2, device='cuda')
        g_coords = torch.empty(n, p, 3, device='cuda')
        g16 = g.to(torch.bfloat16).contiguous()
        counts = torch.empty(len(offsets) - 1, dtype=torch.int32, device='cuda')
        ranks = torch.empty(n3 * p, 4, dtype=torch.int32, device='cuda')

        def entry(lib):
            grad = (planes, d_scratch, g_coords) if coords_grad else (None, None, None)
            ptrs = [t.data_ptr() if t is not None else None
                    for t in (grad[0], g16, coords, entries, offsets, addend, g_planes, *grad[1:])]
            scalars = (n, p, h, w, f, splat._inv_scale(scale), 0.5 * (w - 1) / scale,
                       0.5 * (h - 1) / scale, int(round_out))
            return lambda: lib.tdgp_triplane_splat_bf16(
                *ptrs, *scalars, torch.cuda.current_stream().cuda_stream)

        fns = {}
        for who in sources:
            fns[f'{who}_wrapper'] = compare_kernels.on_library(
                libs[who, 'entry'], lambda: splat.triplane_splat_bf16(**args))
        for (who, name), lib in libs.items():
            fns[f'{who}_{name}'] = entry(lib)
        for who in sources:  # each source's own bins (an earlier one's in two passes)
            lib = libs[who, 'entry']
            fns[f'{who}_bins'] = (
                compare_kernels.on_library(
                    lib, lambda: splat.triplane_splat_bins(coords, h, w, scale))
                if getattr(lib, 'tdgp_splat_bin_ranks', None) is not None else
                lambda lib=lib: compare_kernels.two_pass_bins(lib, coords, h, w, scale))
        lib = splat._library()
        fns['bin_ranks'] = lambda: lib.tdgp_splat_bin_ranks(
            coords.data_ptr(), counts.data_ptr(), ranks.data_ptr(), n, p, h, w,
            splat._inv_scale(scale), torch.cuda.current_stream().cuda_stream)
        fns['memset'] = d_scratch.zero_
        times = in_turns(chip_smoke, fns)
        texels = int((chip_smoke.corner_counts(splat, coords, scale, n3, h, w) > 0).sum())
        bytes_moved = (2 * ((texels * f if coords_grad else 0) + n * p * f)
                       + (2 if round_out else 4) * n3 * h * w * f
                       + (4 * n3 * h * w * f if addend is not None else 0)
                       + 4 * n * p * (6 if coords_grad else 3))
        report(f'K1 bf16 {label}', times, 1e3 * bytes_moved / chip_smoke.HBM_BYTES_PER_S,
               bytes_moved)
        warm = {k: t['warm'][0] for k, t in times.items()}
        for who in sources:
            parts = dict(bins=warm[f'{who}_bins'],
                         walk=warm[f'{who}_no_coords_kernel'] - warm[f'{who}_store_only'],
                         coords_kernel=warm[f'{who}_entry'] - warm[f'{who}_no_coords_kernel'],
                         store=warm[f'{who}_store_only'] - warm['memset'],
                         wrapper_rest=warm[f'{who}_wrapper'] - warm[f'{who}_entry']
                         - warm[f'{who}_bins'])
            print(f'K1 bf16 {label} {who}: parts (warm, first turn) ' + ', '.join(
                f'{k} {v:.4f} ms' for k, v in parts.items()) + f'; this tree\'s rank kernel '
                f'{warm["bin_ranks"]:.4f} ms, the memset {warm["memset"]:.4f} ms')
            times[f'{who}_parts'] = parts
        result[label] = times
        del entries, offsets, g_planes, d_scratch, g_coords
    return result


def k1_float32_caps(chip_smoke, gen):
    """K1's float32 entry and its second-order scatter at caps of 12 (its
    own), 16 and 20 blocks an SM (`K1_F32_OCCUPANCY`), in turns: K1 at the
    uniform points and on the two calls of a plain satellite step, the
    scatter at the `pl` phase's shapes with a random coordinate cotangent;
    the outputs held to the plain versions (<= 1e-5 x max) at each cap."""
    from tdgp_torch import compare_kernels, profile_training
    from tdgp_torch.ops import splat
    text = source('splat')
    built = build_all({f'k1_{name}': edited(text, edits)
                       for name, edits in K1_F32_OCCUPANCY.items()})
    libs = {name: splat.bind(built[f'k1_{name}']) for name in K1_F32_OCCUPANCY}
    trainer, *step = compare_kernels.training_trainer()
    calls = [(f'step_{label}', tuple(a.detach() if torch.is_tensor(a) else a for a in args))
             for label, args in profile_training.capture_splat_calls(trainer, *step)]
    del trainer, step
    calls.append(('uniform', compare_kernels.uniform_points(gen)))
    result = {}
    for label, (planes, coords, g, scale, *rest) in calls:
        coords_grad = rest[0] if rest else True
        g = g.contiguous()
        run = {name: compare_kernels.on_library(lib, lambda: splat.triplane_splat(
            planes, coords, g, scale, coords_grad)) for name, lib in libs.items()}
        ref = splat.triplane_sample_bwd_plain(planes, coords, g, scale, coords_grad)
        for name, fn in run.items():
            rel = [float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(fn(), ref) if b is not None]
            if not all(r <= 1e-5 for r in rel):
                raise AssertionError(f'K1 float32 {label} at {name} disagrees: {rel}')
        del ref
        times = in_turns(chip_smoke, run)
        report(f'K1 float32 {label}', times)
        result[f'k1_{label}'] = times
    del calls
    torch.cuda.empty_cache()
    planes, coords, g, scale = compare_kernels.uniform_points(gen, n=8)
    u_coords = torch.randn(coords.shape, device='cuda', generator=gen)
    h, w = planes.shape[1], planes.shape[2]
    run = {name: compare_kernels.on_library(lib, lambda: splat.triplane_splat_dcoords(
        coords, g, u_coords, scale, h, w)) for name, lib in libs.items()}
    ref = splat.triplane_sample_bwd_bwd_plain(planes, coords, g, None, u_coords, scale)[0]
    for name, fn in run.items():
        rel = float((fn() - ref).abs().max() / ref.abs().max())
        if not rel <= 1e-5:
            raise AssertionError(f'K1 scatter at {name} disagrees: {rel}')
    del ref
    times = in_turns(chip_smoke, run)
    report('K1 scatter (second order) at the pl shapes', times)
    result['k1_scatter'] = times
    return result


def shared_atomic():
    """The SASS of a float atomicAdd to shared memory on sm_90a: its ATOMS
    lines (a single instruction, or a compare-and-swap loop)."""
    lib_path = os.path.join(cuda_build.BUILD_DIR, 'probe', 'libshared_atomic.so')
    build('shared_atomic', SHARED_ATOMIC_SOURCE)
    cuobjdump = os.path.join(os.path.dirname(cuda_build._nvcc()), 'cuobjdump')
    sass = subprocess.run([cuobjdump, '-sass', lib_path], capture_output=True, text=True,
                          check=True).stdout
    lines = [ln.strip() for ln in sass.splitlines()
             if any(op in ln for op in ('ATOMS', 'ATOM', 'RED', 'BRA', 'BSSY', 'CAS'))]
    print('float atomicAdd to shared memory, sm_90a SASS:\n  ' + '\n  '.join(lines))
    return lines


def resource_usage(lib_path, names):
    """`cuobjdump --dump-resource-usage` of a built library: the lines of the
    kernels whose mangled names contain one of `names`."""
    cuobjdump = os.path.join(os.path.dirname(cuda_build._nvcc()), 'cuobjdump')
    out = subprocess.run([cuobjdump, '--dump-resource-usage', lib_path], capture_output=True,
                         text=True, check=True).stdout.splitlines()
    lines = []
    for i, line in enumerate(out):
        found = [n for n in names if 'Function' in line and n in line]
        if found:
            usage = out[i + 1].strip() if i + 1 < len(out) else ''
            name = line.strip().split()[-1].rstrip(':')
            lines.append(f'{name[name.index(found[0]):][:70]}: {usage}')
    return lines


# every probe build of ray_march.cu instantiates its kernels for 3 channels only (the
# probes' inputs), which cuts each build to a quarter
C3_ONLY = ('    case 1: return with_c(Int<1>{});\n    case 2: return with_c(Int<2>{});\n'
           '    case 3: return with_c(Int<3>{});\n    default: return with_c(Int<4>{});',
           '    default: return with_c(Int<3>{});')


def three_channels(text):
    return _replace_all(text, *C3_ONLY)


K3_STAGED = '  staged();\n  const int n = q < nq ? s : 0;\n'
K3_MARCH = '  Sums<C> acc;\n  march<C, L, K, Cut>(ts, xs, cs, merged,'
K3_MARCH_CALL = '  march<C, L, K, Cut>(ts, xs, cs, merged,'
K3_SOURCES = ('t1 + ray0 * s1', 't2 + ray0 * s2', 'x1 + ray0 * s1', 'x2 + ray0 * s2',
              'c1 + ray0 * s1 * C', 'c2 + ray0 * s2 * C')
K3_BOUNDS = '__launch_bounds__(32 * kWarpsPerBlock)\nray_march_merged_kernel('
K3_WIDTH = '      return launch(cc, Int<kMinLanes>{}, Int<8>{});'
K3_VARIANTS = {  # this tree's merged kernel: name -> edits (old, new), each found once
    'whole': (),
    'stage_only': ((K3_STAGED, '  staged();\n  return;\n  const int n = q < nq ? s : 0;\n'),),
    'merge_search': ((K3_MARCH, '  if (merged.a < 0) rgb_out[0] = 0.f;\n  return;\n' + K3_MARCH),),
    'no_merge': ((K3_MARCH_CALL, K3_MARCH_CALL.replace('merged,', 'InOrder(q * s, li * K),')),),
    # every warp stages the first rays' samples (in the L2): the march without device memory
    'march_only': tuple((src, src.replace('ray0 *', '0 *')) for src in K3_SOURCES),
    'lanes_4': ((K3_WIDTH, '      return launch(cc, Int<4>{}, Int<16>{});'),),
    'lanes_16': ((K3_WIDTH, '      return launch(cc, Int<kWideLanes>{}, Int<4>{});'),),
    **{f'blocks_{n}': ((K3_BOUNDS, K3_BOUNDS.replace('(32 * kWarpsPerBlock)',
                                                     f'(32 * kWarpsPerBlock, {n})')),)
       for n in (12, 16)}}
K3_OLD_STAGED = '  staged();\n  if constexpr (kRawX) {'
K3_OLD_SEARCH = '  const int n = q < nq ? s : 0;\n  const Merged merged('
K3_OLD_MARCH = '  Sums<C> acc;\n  if constexpr (Cut) {'
K3_PARENT_VARIANTS = {  # the first design's merged kernel, which widens bf16 in shared memory
    'whole': (),
    'stage_only': ((K3_OLD_STAGED, '  staged();\n  return;\n  if constexpr (kRawX) {'),),
    'widen': ((K3_OLD_SEARCH, '  return;\n' + K3_OLD_SEARCH),),
    'merge_search': ((K3_OLD_MARCH, '  if (merged.a < 0) rgb_out[0] = 0.f;\n  return;\n'
                                    + K3_OLD_MARCH),)}


def sass_counts(lib_path, name_part):
    """The SASS of the first kernel of a built library whose mangled name
    contains `name_part`: (its instructions, {opcode: count}), static (the
    unrolled loops as they stand in the code)."""
    cuobjdump = os.path.join(os.path.dirname(cuda_build._nvcc()), 'cuobjdump')
    sass = subprocess.run([cuobjdump, '-sass', lib_path], capture_output=True, text=True,
                          check=True).stdout.splitlines()
    counts, inside = {}, False
    for line in sass:
        if 'Function :' in line:
            if inside:
                break
            inside = name_part in line
        elif inside and line.strip().startswith('/*') and '*/' in line:
            text = line.split('*/', 1)[1].strip()
            if not text:
                continue
            op = text.split()[0]
            if op.startswith('@'):
                op = text.split()[1]
            op = op.split('.')[0].rstrip(';')
            counts[op] = counts.get(op, 0) + 1
    return sum(counts.values()), dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def to_bf16(sets, densities=True):
    """Merged sets with bf16 colours, and bf16 densities where `densities`."""
    return tuple(x.to(torch.bfloat16) if i in (1, 4) or (densities and i in (2, 5)) else x
                 for i, x in enumerate(sets))


def merged_call(ns, sets, clamp_mode=0):
    """One launch of the merged entry of the bound `ray_march.cu` `ns`
    (`ray_march.bind`) on `sets` (`clamp_mode` 0 softplus, 1 relu; infinite
    last delta, no last_back) -> a function returning (rgb, depth, wsum,
    ftrans)."""
    b, r, s1 = sets[0].shape
    s2, c = sets[3].shape[2], sets[1].shape[3]
    out = [torch.empty(b, r, c, device='cuda')] + [torch.empty(b, r, device='cuda')
                                                   for _ in range(3)]
    bf16 = sets[1].dtype == torch.bfloat16
    fn = ns.merged_bf16 if bf16 else ns.merged
    extra = [int(sets[2].dtype == torch.bfloat16)] if bf16 else []
    ptrs = [t.data_ptr() for t in (*sets, *out)]

    def run():
        err = fn(*ptrs, b * r, s1, s2, c, clamp_mode, 1.0, 1e10, 0, *extra,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f'the merged entry failed to launch: {err}')
        return out
    return run


def k3_merged_bf16(chip_smoke, parent_text=None):
    """K3's merged entry split into its parts (the module docstring)."""
    from tdgp_torch.ops import ray_march
    g = torch.Generator(device='cuda').manual_seed(5)
    served32 = chip_smoke.merged_sets(g, 4, 16384, 32, 32, 3)
    inputs = {'served_bf16': to_bf16(served32),
              'train_bf16_float32_densities': to_bf16(
                  chip_smoke.train_merged_sets(g, 16, 4096, 32, 32, 3), densities=False),
              'served_float32': served32}
    texts = {('this', name): edited_once(three_channels(source('ray_march')), edits)
             for name, edits in K3_VARIANTS.items()}
    if parent_text is not None:
        texts.update({('parent', name): edited_once(three_channels(parent_text), edits)
                      for name, edits in K3_PARENT_VARIANTS.items()})
    built = build_all({f'k3_{who}_{name}': text for (who, name), text in texts.items()})
    folder = os.path.join(cuda_build.BUILD_DIR, 'probe')
    for who in ('this', 'parent'):
        if (who, 'whole') in texts:
            for line in resource_usage(os.path.join(folder, f'libk3_{who}_whole.so'),
                                       ('ray_march_merged_kernelILi3ELi8ELi8E',
                                        'ray_march_reduced_kernelILi3ELi8ELi8E')):
                print(f'K3 merged, {who}: {line}')
    for who, name, kernel in (('this', 'whole', 'ray_march_merged_kernelILi3ELi8ELi8ELb0E13__nv_bfloat16S1_'),
                              ('this', 'whole', 'ray_march_merged_kernelILi3ELi8ELi8ELb0EffE'),
                              ('parent', 'whole', 'ray_march_merged_kernelILi3ELi8ELi8ELb0E13__nv_bfloat16S1_')):
        if (who, name) in texts:
            total, ops = sass_counts(os.path.join(folder, f'libk3_{who}_{name}.so'), kernel)
            print(f'K3 merged, {who} {kernel[24:]}: {total} SASS instructions; '
                  + ', '.join(f'{k} {v}' for k, v in list(ops.items())[:16]))
    libs = {key: ray_march.bind(built[f'k3_{key[0]}_{key[1]}']) for key in texts}
    result = {}
    for label, sets in inputs.items():
        fns = {f'{who}_{name}': merged_call(ns, sets) for (who, name), ns in libs.items()}
        fns.update({f'{who}_{name}_relu': merged_call(libs[who, name], sets, 1)
                    for who, name in libs if name in ('whole', 'march_only')})
        ref = ray_march.ray_march_merged_plain(*sets)
        for name, fn in fns.items():
            if name.endswith(('whole', 'lanes_4', 'lanes_16')):  # softplus
                err = max(float((a - b).abs().max()) for a, b in zip(fn(), ref))
                if not err <= 1e-5:
                    raise AssertionError(f'K3 merged {label} {name} disagrees: {err}')
        del ref
        times = in_turns(chip_smoke, fns)
        rays, s = sets[0].shape[0] * sets[0].shape[1], sets[0].shape[2] + sets[3].shape[2]
        c = sets[1].shape[3]
        bytes_moved = (rays * s * (4 + sets[2].element_size() + c * sets[1].element_size())
                       + 4 * rays * (c + 3))
        report(f'K3 merged {label}', times, 1e3 * bytes_moved / chip_smoke.HBM_BYTES_PER_S,
               bytes_moved)
        result[label] = times
    return result


BB_STAGED = '  staged();\n  auto cot = [&](int i) {  // a_i'
BB_UNSTAGE = ('  unstage(b_colors + ray * S * C, ucs, S * C, lane);\n'
              '  unstage(b_densities + ray * S, uxs, S, lane);\n'
              '  unstage(b_depths + ray * S, uts, S, lane);\n')
BB_VARIANTS = {  # this tree's second order: name -> edits (old, new), each found once
    'whole': (),
    'stage_only': ((BB_STAGED, '  staged();\n  return;\n' + BB_STAGED[len('  staged();\n'):]),),
    'no_store': ((BB_UNSTAGE, ''),)}


def k3_bwd_bwd(chip_smoke, parent_text=None):
    """K3's second order split into its parts (the module docstring)."""
    from tdgp_torch.ops import ray_march
    g = torch.Generator(device='cuda').manual_seed(4)
    b, r, s, c = 8, 4096, 64, 3
    colors = torch.rand(b, r, s, c, device='cuda', generator=g)
    densities = torch.randn(b, r, s, device='cuda', generator=g) * 2
    depths = torch.rand(b, r, s, device='cuda', generator=g).sort(-1).values * 0.5 + 0.75
    cots = [torch.randn(b, r, c, device='cuda', generator=g)] + [
        torch.randn(b, r, device='cuda', generator=g) for _ in range(3)]
    us = [torch.randn(t.shape, device='cuda', generator=g) for t in (colors, densities, depths)]
    texts = {('this', name): edited_once(three_channels(source('ray_march')), edits)
             for name, edits in BB_VARIANTS.items()}
    if parent_text is not None:
        texts[('parent', 'whole')] = three_channels(parent_text)
    built = build_all({f'bb_{who}_{name}': text for (who, name), text in texts.items()})
    folder = os.path.join(cuda_build.BUILD_DIR, 'probe')
    for who, name in texts:
        if name == 'whole':
            for line in resource_usage(os.path.join(folder, f'libbb_{who}_{name}.so'),
                                       ('ray_march_reduced_bwd_bwd_kernel',)):
                print(f'K3 second order, {who} {name}: {line}')
    for who, kernel in (('this', 'ray_march_reduced_bwd_bwd_kernelILi3ELi2E'),
                        ('parent', 'ray_march_reduced_bwd_bwd_kernelILi2E')):
        if (who, 'whole') in texts:
            total, ops = sass_counts(os.path.join(folder, f'libbb_{who}_whole.so'), kernel)
            print(f'K3 second order, {who} {kernel[32:]}: {total} SASS instructions; '
                  + ', '.join(f'{k} {v}' for k, v in list(ops.items())[:16]))
    libs = {key: ray_march.bind(built[f'bb_{key[0]}_{key[1]}']) for key in texts}
    result = {}
    for label, u_depths in (('path', None), ('depth_cotangent', us[2])):
        args = (colors, densities, depths, *cots, us[0], us[1], u_depths)
        outs = [torch.empty_like(t) for t in (colors, densities, depths, *cots)]
        ptrs = [None if t is None else t.data_ptr() for t in (*args, *outs)]
        fns = {}
        for (who, name), ns in libs.items():
            for clamp in ((0, 1) if name == 'whole' else (0,)):
                def run(fn=ns.bwd_bwd, clamp=clamp):
                    err = fn(*ptrs, b * r, s, c, clamp, 1.0, 1e10, 0,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f'the second order failed to launch: {err}')
                    return outs
                fns[f'{who}_{name}' + ('_relu' if clamp else '')] = run
        ref = ray_march.ray_march_reduced_bwd_bwd_plain(*args)
        for name, fn in fns.items():
            if name.endswith('whole'):
                _, rel = chip_smoke.bwd_bwd_errors(fn(), ref)
                if not all(e <= chip_smoke.PL_KERNEL_LIMIT for e in rel):
                    raise AssertionError(f'K3 second order {label} {name} disagrees: {rel}')
        del ref
        times = in_turns(chip_smoke, fns)
        n = b * r
        bytes_moved = 4 * (n * s * (c + 2) + n * (c + 3) + n * s * (c + 1 + (u_depths is not None))
                           + n * s * (c + 2) + n * (c + 3))
        report(f'K3 second order {label}', times,
               1e3 * bytes_moved / chip_smoke.HBM_BYTES_PER_S, bytes_moved)
        result[label] = times
    return result


def edited_once(text, edits):
    for old, new in edits:
        text = _replace(text, old, new)
    return text


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--only', choices=('mlp_bf16', 'select', 'k1_bf16', 'k1_float32_caps',
                                       'shared_atomic', 'k3_merged_bf16', 'k3_bwd_bwd'))
    ap.add_argument('--parent', help='a checkout of an earlier commit: k1_bf16, k3_merged_bf16 and '
                                     'k3_bwd_bwd also time its kernels (parts)')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('probe_kernels: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f'card: {card}')
    result = {'card': card}
    sources = {'this': source('splat')}
    parent_k3 = None
    if args.parent:
        with open(os.path.join(args.parent, 'tdgp_torch', 'csrc', 'splat.cu')) as f:
            sources['parent'] = f.read()
        with open(os.path.join(args.parent, 'tdgp_torch', 'csrc', 'ray_march.cu')) as f:
            parent_k3 = f.read()
    gen = torch.Generator(device='cuda').manual_seed(0)
    for name, probe in (('mlp_bf16', mlp_bf16), ('select', select),
                        ('k1_bf16', lambda cs: k1_parts(cs, sources, gen)),
                        ('k1_float32_caps', lambda cs: k1_float32_caps(cs, gen)),
                        ('shared_atomic', lambda cs: shared_atomic()),
                        ('k3_merged_bf16', lambda cs: k3_merged_bf16(cs, parent_k3)),
                        ('k3_bwd_bwd', lambda cs: k3_bwd_bwd(cs, parent_k3))):
        if args.only in (None, name):
            result[name] = probe(chip_smoke)
    print(f'clocks (sm, mem): {chip_smoke.clocks()}')
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
