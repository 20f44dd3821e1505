"""Where the time of a kernel goes, on one card: K4's bf16 entry and the
quantile threshold's select.

    python3 -m tdgp_torch.probe_kernels [--only mlp_bf16|select]

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


def build(name, text):
    """`text`, a CUDA source, written to `build/probe/<name>.cu` and built
    with the port's nvcc flags (`csrc/` on the include path)."""
    folder = os.path.join(cuda_build.BUILD_DIR, 'probe')
    os.makedirs(folder, exist_ok=True)
    path, out = os.path.join(folder, f'{name}.cu'), os.path.join(folder, f'lib{name}.so')
    with open(path, 'w') as f:
        f.write(text)
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, '-I', cuda_build.CSRC_DIR,
                    '-o', out, path], check=True)
    return ctypes.CDLL(out)


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


def report(label, times, bound_ms, bytes_moved):
    for name, t in times.items():
        print(f'{label} {name}: warm {t["warm"][0]:.4f} / {t["warm"][1]:.4f} ms, cold '
              f'{t["cold"][0]:.4f} / {t["cold"][1]:.4f} ms (turns: forward, reverse); bound of '
              f'the bytes {bound_ms:.4f} ms ({bytes_moved / 1e6:.1f} MB)')


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--only', choices=('mlp_bf16', 'select'))
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
    for name, probe in (('mlp_bf16', mlp_bf16), ('select', select)):
        if args.only in (None, name):
            result[name] = probe(chip_smoke)
    print(f'clocks (sm, mem): {chip_smoke.clocks()}')
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
