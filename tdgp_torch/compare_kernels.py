"""Time K1, K4, K3 and K3 cut's threshold against another checkout, in turns, on one card.

    python3 -m tdgp_torch.compare_kernels --parent DIR

DIR is a checkout of an earlier commit. Each kernel whose source
(`tdgp_torch/csrc/<name>.cu`) differs there is compared; the others are
skipped as unchanged. The earlier kernels are called through these C
interfaces: K1's entries through this tree's wrappers in `ops/splat.py`
with the earlier `splat.cu` bound in place of this tree's (`splat_library`:
its bins, float32, bf16 and second-order gather entries, the interfaces of
the binned splat), K4's `tdgp_triplane_mlp` and K3's
`tdgp_ray_march_reduced` as now. They are built here with this tree's nvcc
flags. On the same inputs, this tree's wrapper and the earlier kernel (with
the zero fill its wrapper made) are timed in the order earlier, this, this,
earlier (`chip_smoke.cuda_ms` each; K1's entries warm and cold,
`chip_smoke.cold_ms`; K3 with `chip_smoke.timed`: warm, warm
with the calls enqueued ahead, cold after a write that evicts the L2, cold
with a clean L2, and the host's time per call), and their results are held
against each other (<= 1e-5 x max |earlier|; K3 <= 1e-5 absolute):
  - K1 on the uniform points of `chip_smoke.py` (batch 16, 64^2 x 32 points,
    planes 48 x 512^2 x 32), and on the coarse and the fine pass of one
    warm-up step of the satellite 256^2 `Trainer` (batch 16);
  - K1's bf16 entry at the uniform points alone and with a float32 addend,
    and on the fine and the coarse call of one `gmain_render_bf16` step (the
    fine pass keeping its float32 sum, the coarse pass adding it): the
    float32 sums and g_coords as above, the stored bf16 gradient within one
    bf16 ulp of the texel plus 1e-5 x max;
  - K1's second-order gather on the two calls of one R1 + PL step
    (`loss.pl_weight=2`) and at the uniform points of batch 8, with the
    planes' cotangent alone and with a coordinate cotangent too, and its
    second-order scatter there;
  - K4 at the served shape, [4, 524288, 32] -> 64 -> 4;
  - K3 at the served chunk [4, 16384, 64, 3] and at the training shape
    [16, 4096, 64, 3]; and the earlier two-step final march of a served
    chunk, the earlier checkout's own `unify_samples_sorted`
    (`tdgp_torch/rendering/renderer.py` there) then its K3, against this
    tree's merged entry on the same two sets of 32 samples; and the earlier
    merged entry (`tdgp_ray_march_merged`, where the checkout has it)
    against this tree's;
  - K4's bf16 entry (`tdgp_triplane_mlp_bf16`, where the checkout has it)
    at the served shape in bf16, its outputs held to this tree's at one
    bf16 ulp of their scale, at most 1e-3 of them apart;
  - K3's cut path at the served chunk [4, 16384, 32 + 32, 3], q = 0.5,
    where this tree's threshold source (`csrc/quantile.cu`) is new or
    differs: the earlier threshold (the checkout's own `cut_threshold` in
    `tdgp_torch/ops/ray_march.py`, a sort there) then its
    `tdgp_ray_march_merged_cut`, against this tree's `ray_march_merged_cut`
    (the select, then the cut entry), with `chip_smoke.timed`; the two
    thresholds alone, and at the coarse chunk [4, 16384, 32] the earlier
    `quantile` against this tree's, with `chip_smoke.cuda_ms` and
    `chip_smoke.cold_ms`; thresholds bit for bit (a zero of either sign as a
    zero), the march <= 1e-5 absolute.
  - K3's merged entry with bf16 loads at the served chunk (bf16 colours and
    densities) and at the training shape [16, 4096, 32 + 32, 3] with float32
    densities (Dmain's fresh fakes), its cut entry with bf16 loads at the
    served chunk (q = 0.5, the threshold by this tree's select for both),
    and K3's second order at PL's render [8, 4096, 64, 3] without a depth
    cotangent (the path's form) and with one: this tree's wrappers on this
    tree's `ray_march.cu` and on the earlier one (`ray_march_library`), warm
    with the calls enqueued ahead, cold, and cold with a clean L2; <= 1e-5
    absolute, the second order <= `chip_smoke.PL_KERNEL_LIMIT` x each
    output's largest.
Prints the card's name and power limit, one line per input, and a JSON
object of the times as its last line. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import glob
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import torch

from tdgp_torch.ops import cuda_build, ray_march, splat, triplane_mlp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.cache
def build_earlier(parent: str, name: str) -> ctypes.CDLL:
    """`parent`'s `csrc/<name>.cu`, built to a library named by a hash of it
    and its headers, so that earlier sources of one name load side by side."""
    src = os.path.join(parent, 'tdgp_torch', 'csrc', f'{name}.cu')
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    h = hashlib.sha256()
    for path in [src, *sorted(glob.glob(os.path.join(os.path.dirname(src), '*.cuh')))]:
        with open(path, 'rb') as f:
            h.update(f.read())
    out = os.path.join(cuda_build.BUILD_DIR, f'libearlier_{name}-{h.hexdigest()[:16]}.so')
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, '-o', out, src], check=True)
    return ctypes.CDLL(out)


def two_pass_bins(lib, coords, h, w, scale):
    """K1's bins by the interface of the earlier `splat.cu`s that lack
    `tdgp_splat_bin_ranks`: a histogram, the offsets summed in torch, a
    scatter through cursors that start at them."""
    geometry = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float]
    lib.tdgp_splat_bin_counts.argtypes = [ctypes.c_void_p] * 2 + geometry + [ctypes.c_void_p]
    lib.tdgp_splat_bin_entries.argtypes = [ctypes.c_void_p] * 3 + geometry + [ctypes.c_void_p]
    n, p = coords.shape[0], coords.shape[1]
    strips_y, strips_x = splat._strips(h, w)
    geometry = (n, p, h, w, splat._inv_scale(scale))
    stream = torch.cuda.current_stream().cuda_stream
    counts = torch.empty(3 * n * strips_y * strips_x, dtype=torch.int32, device=coords.device)
    if lib.tdgp_splat_bin_counts(coords.data_ptr(), counts.data_ptr(), *geometry, stream):
        raise RuntimeError('the earlier bin counts failed to launch')
    offsets = torch.cat([torch.zeros(1, dtype=torch.int32, device=coords.device),
                         counts.cumsum(0, dtype=torch.int32)])
    cursor = offsets[:-1].clone()
    entries = torch.empty(4 * 3 * n * p, dtype=torch.int32, device=coords.device)
    if lib.tdgp_splat_bin_entries(coords.data_ptr(), cursor.data_ptr(), entries.data_ptr(),
                                  *geometry, stream):
        raise RuntimeError('the earlier bin scatter failed to launch')
    return entries, offsets


@contextlib.contextmanager
def splat_library(lib):
    """`ops/splat.py`'s wrappers (bins and entries alike) on the built
    `splat.cu` `lib` (`splat.bind`) in place of this tree's: the earlier
    kernels called as this tree calls its own, its bins by
    `two_pass_bins` where it has no `tdgp_splat_bin_ranks`."""
    saved = splat._library, splat.triplane_splat_bins
    splat._library = lambda: lib
    if getattr(lib, 'tdgp_splat_bin_ranks', None) is None:
        splat.triplane_splat_bins = lambda coords, h, w, scale: two_pass_bins(lib, coords, h, w,
                                                                              scale)
    try:
        yield
    finally:
        splat._library, splat.triplane_splat_bins = saved


@contextlib.contextmanager
def ray_march_library(ns):
    """`ops/ray_march.py`'s wrappers on the bound `ray_march.cu` `ns`
    (`ray_march.bind`) in place of this tree's."""
    saved = ray_march._kernels
    ray_march._kernels = lambda: ns
    try:
        yield
    finally:
        ray_march._kernels = saved


def on_ray_march(ns, fn):
    """`fn` run with `ray_march_library(ns)`."""
    def run():
        with ray_march_library(ns):
            return fn()
    return run


def on_library(lib, fn):
    """`fn` run with `splat_library(lib)`."""
    def run():
        with splat_library(lib):
            return fn()
    return run


def earlier_mlp(lib):
    fn = lib.tdgp_triplane_mlp
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(feats, w0, b0, w1, b1):
        n, p, f = feats.shape
        hid, out = w0.shape[1], w1.shape[1]
        rgb = torch.empty((n, p, out - 1), device=feats.device)
        sigma = torch.empty((n, p), device=feats.device)
        err = fn(feats.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                 rgb.data_ptr(), sigma.data_ptr(), n * p, f, hid, out,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f'the earlier K4 failed to launch: {err}')
        return rgb, sigma
    return run


def earlier_mlp_bf16(lib):
    """The earlier bf16 entry of K4, or None where the checkout predates it."""
    fn = getattr(lib, 'tdgp_triplane_mlp_bf16', None)
    if fn is None:
        return None
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(feats, w0, b0, w1, b1):
        n, p, f = feats.shape
        hid, out = w0.shape[1], w1.shape[1]
        rgb = torch.empty((n, p, out - 1), dtype=feats.dtype, device=feats.device)
        sigma = torch.empty((n, p), dtype=feats.dtype, device=feats.device)
        err = fn(*[t.data_ptr() for t in (feats, w0, b0, w1, b1, rgb, sigma)], n * p, f, hid, out,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f'the earlier K4 bf16 failed to launch: {err}')
        return rgb, sigma
    return run


def earlier_cut(lib, threshold_fn):
    """The earlier cut path: `threshold_fn` (the checkout's `cut_threshold`)
    then its `tdgp_ray_march_merged_cut`, or None where it predates it."""
    fn = getattr(lib, 'tdgp_ray_march_merged_cut', None)
    if fn is None:
        return None
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(*sets, q=0.5):  # softplus, inf depth, no last_back
        b, r, s1 = sets[0].shape
        s2, c = sets[3].shape[2], sets[1].shape[3]
        threshold = threshold_fn(sets[2], sets[5], q)
        rgb = torch.empty((b, r, c), device=sets[0].device)
        depth, wsum, ftrans = (torch.empty((b, r), device=sets[0].device) for _ in range(3))
        err = fn(*[t.data_ptr() for t in (*sets, threshold, rgb, depth, wsum, ftrans)], b * r, s1,
                 s2, c, 0, 1.0, 1e10, 0, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f'the earlier K3 cut failed to launch: {err}')
        return rgb, depth, wsum, ftrans
    return run


def earlier_march(lib):
    fn = lib.tdgp_ray_march_reduced
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_float, ctypes.c_float,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(colors, densities, depths):  # softplus, inf depth, no last_back
        b, r, s, c = colors.shape
        rgb = torch.empty((b, r, c), device=colors.device)
        depth, wsum, ftrans = (torch.empty((b, r), device=colors.device) for _ in range(3))
        err = fn(colors.data_ptr(), densities.data_ptr(), depths.data_ptr(), rgb.data_ptr(),
                 depth.data_ptr(), wsum.data_ptr(), ftrans.data_ptr(), b * r, s, c, 0, 1.0, 1e10,
                 0, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f'the earlier K3 failed to launch: {err}')
        return rgb, depth, wsum, ftrans
    return run


def earlier_merged(lib):
    """The earlier merged entry (`tdgp_ray_march_merged`), or None where the
    checkout predates it."""
    fn = getattr(lib, 'tdgp_ray_march_merged', None)
    if fn is None:
        return None
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(*sets):  # softplus, inf depth, no last_back
        b, r, s1 = sets[0].shape
        s2, c = sets[3].shape[2], sets[1].shape[3]
        rgb = torch.empty((b, r, c), device=sets[0].device)
        depth, wsum, ftrans = (torch.empty((b, r), device=sets[0].device) for _ in range(3))
        err = fn(*[t.data_ptr() for t in (*sets, rgb, depth, wsum, ftrans)], b * r, s1, s2, c, 0,
                 1.0, 1e10, 0, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f'the earlier merged K3 failed to launch: {err}')
        return rgb, depth, wsum, ftrans
    return run


def earlier_module(parent: str, rel_path: str, name: str):
    """A module of the earlier checkout, loaded under another name (its own
    imports resolve to this tree's package)."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(parent, rel_path))
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module  # for its dataclasses
    spec.loader.exec_module(module)
    return module


def changed(parent: str, name: str) -> bool:
    """Whether `csrc/<name>.cu` of the earlier checkout differs from this
    tree's, or is not there."""
    path = os.path.join(parent, 'tdgp_torch', 'csrc', f'{name}.cu')
    if not os.path.exists(path):
        return True
    with open(path, 'rb') as f:
        earlier = f.read()
    with open(cuda_build.sources()[name], 'rb') as f:
        return f.read() != earlier


def in_turns(cuda_ms, earlier, this, iters):
    """(earlier ms, this ms) as [first, last] and [second, third] of four turns."""
    first = cuda_ms(earlier, iters)
    mine = [cuda_ms(this, iters), cuda_ms(this, iters)]
    return [first, cuda_ms(earlier, iters)], mine


def agree(a_out, b_out, what):
    rel = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(a_out, b_out)
           if b is not None]
    if not all(r <= 1e-5 for r in rel):
        raise AssertionError(f'{what}: this tree and the earlier kernel disagree: {rel}')
    return rel


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--parent', required=True, help='checkout of the earlier commit')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('compare_kernels: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke

    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f'card: {card}')
    cuda_build.build(['splat', 'triplane_mlp', 'ray_march', 'quantile'])
    result = {}
    gen = torch.Generator(device='cuda').manual_seed(0)
    if changed(args.parent, 'splat'):
        old = k1_phase(args.parent, chip_smoke, result, gen)
        k1_bf16_phase(args.parent, chip_smoke, result, gen, old)
        gather_phase(args.parent, chip_smoke, result, gen, old)
    else:
        print('splat.cu: unchanged, not compared')
    for name, compare in (('triplane_mlp', k4_phase), ('triplane_mlp', k4_bf16_phase),
                          ('ray_march', k3_phase), ('ray_march', k3_bf16_phase),
                          ('quantile', cut_phase)):
        if changed(args.parent, name):
            compare(args.parent, chip_smoke, result, gen)
        else:
            print(f'{name}.cu: unchanged, not compared')
    print(json.dumps({'card': card, **result}))
    return 0


def training_trainer(overrides=()):
    from tdgp_torch import profile_training
    from tdgp_torch.training.schedules import compute_schedules
    from tdgp_torch.training.train_step import Trainer
    from tdgp_torch.utils.draws import Draws
    cfg = profile_training.train_config(list(overrides))
    trainer = Trainer(cfg, 'cuda', seed=0)
    return (trainer, profile_training.make_batch(cfg, profile_training.BATCH, 0, 'cuda'),
            compute_schedules(cfg, profile_training.CUR_NIMG),
            Draws(torch.Generator(device='cuda').manual_seed(1)))


def uniform_points(gen, n=16, dtype=torch.float32):
    """`chip_smoke.py`'s uniform points: planes [3n, 512, 512, 32], n x 64^2 x 32
    points (some on the planes' last texel and first row), a cotangent."""
    h, w, f, scale = 512, 512, 32, 0.5
    p = 64 * 64 * 32
    planes = torch.randn(3 * n, h, w, f, device='cuda', generator=gen).to(dtype)
    coords = torch.rand(n, p, 3, device='cuda', generator=gen) * 1.1 - 0.55
    coords[:, :64, 0] = scale
    coords[:, 64:128, 1] = -scale
    return planes, coords, torch.randn(n, p, f, device='cuda', generator=gen).to(dtype), scale


def turns_warm_cold(chip_smoke, earlier, this, iters):
    """{'warm': {'earlier_ms', 'this_ms'}, 'cold': ...} in turns (earlier, this, this, earlier)."""
    out = {}
    for key, measure in (('warm', lambda fn, _: chip_smoke.cuda_ms(fn, iters)),
                         ('cold', lambda fn, _: chip_smoke.cold_ms(fn, repeats=10))):
        first, mine = in_turns(measure, earlier, this, iters)
        out[key] = {'earlier_ms': first, 'this_ms': mine}
    return out


def print_turns(label, times, note=''):
    print(f'{label}: ' + '; '.join(
        f'{key} earlier {t["earlier_ms"][0]:.4f} / {t["earlier_ms"][1]:.4f} ms, this '
        f'{t["this_ms"][0]:.4f} / {t["this_ms"][1]:.4f} ms' for key, t in times.items())
        + f' (turns: earlier, this, this, earlier){note}')


def k1_phase(parent, chip_smoke, result, gen):
    from tdgp_torch import profile_training
    old = splat.bind(build_earlier(parent, 'splat'))

    def k1(label, planes, coords, g, scale, coords_grad=True):
        this = lambda: splat.triplane_splat(planes, coords, g, scale, coords_grad)  # noqa: E731
        earlier = on_library(old, this)
        rel = agree(this(), earlier(), f'K1 {label}')
        times = turns_warm_cold(chip_smoke, earlier, this, 20)
        print_turns(f'K1 {label}', times, f'; agree to {rel}')
        result[f'k1_{label}'] = times

    trainer, *step = training_trainer()
    calls = profile_training.capture_splat_calls(trainer, *step)
    del trainer, step
    for label, (planes, coords, g, scale, coords_grad) in calls:
        k1(f'step_{label}', planes.detach(), coords.detach(), g.detach().contiguous(), scale,
           coords_grad)
    del calls, planes, coords, g
    torch.cuda.empty_cache()
    k1('uniform', *uniform_points(gen))
    torch.cuda.empty_cache()
    return old


def k1_bf16_phase(parent, chip_smoke, result, gen, old):
    """K1's bf16 entry: at the uniform points alone and with the other pass's
    float32 addend, and on the two calls of one `gmain_render_bf16` step
    (the fine pass keeping its float32 sum, the coarse pass adding it): the
    float32 sums and g_coords <= 1e-5 x max |earlier|, the stored bf16
    gradient within one bf16 ulp of the texel plus 1e-5 x max."""
    from tdgp_torch import profile_training

    def k1_bf16(label, planes, coords, g, scale, coords_grad=True, addend=None, round_out=True):
        def this():
            return splat.triplane_splat_bf16(planes, coords, g, scale, coords_grad, addend,
                                             round_out)
        earlier = on_library(old, this)
        sums = lambda: splat.triplane_splat_bf16(planes, coords, g, scale, coords_grad,  # noqa: E731
                                                 addend, False)
        rel = agree(sums(), on_library(old, sums)(), f'K1 bf16 {label}')
        got, ref = this()[0].float(), earlier()[0].float()
        limit = ref.abs() * 2.0 ** -7 + 1e-5 * float(ref.abs().max())
        beyond = int(((got - ref).abs() > limit).sum())
        if beyond:
            raise AssertionError(f'K1 bf16 {label}: {beyond} stored texels beyond one ulp')
        times = turns_warm_cold(chip_smoke, earlier, this, 20)
        print_turns(f'K1 bf16 {label}', times, f'; float32 sums and g_coords agree to {rel}, the '
                                              f'store within one ulp')
        result[f'k1_bf16_{label}'] = times

    trainer, *step = training_trainer(['training.gmain_render_bf16=true'])
    calls = profile_training.capture_splat_bf16_calls(trainer, *step)
    del trainer, step
    for label, args in calls:
        args = {k: v.detach() if torch.is_tensor(v) else v for k, v in args.items()}
        k1_bf16(f'step_{label}', **args)
    del calls, args
    torch.cuda.empty_cache()
    planes, coords, g, scale = uniform_points(gen, dtype=torch.bfloat16)
    k1_bf16('uniform', planes, coords, g, scale)
    addend = torch.randn(planes.shape, device='cuda', generator=gen)
    k1_bf16('uniform_addend', planes, coords, g, scale, addend=addend)
    del planes, coords, g, addend
    torch.cuda.empty_cache()


def gather_phase(parent, chip_smoke, result, gen, old):
    """K1's second-order gather entry on the two calls of one R1 + PL step
    of the satellite trainer (`loss.pl_weight=2`, PL at batch 8) and at the
    `pl` phase's random inputs (planes [24, 512, 512, 32], 8 x 64^2 x 32
    points), each with the planes' cotangent alone (the path's form) and
    with a coordinate cotangent too; its scatter entry at those inputs with
    the random coordinate cotangent: <= 1e-5 x max |earlier|."""
    from tdgp_torch import profile_training

    def gather(label, planes, coords, g, u_planes, u_coords, scale):
        this = lambda: splat.triplane_splat_gather(planes, coords, g, u_planes,  # noqa: E731
                                                   u_coords, scale)
        earlier = on_library(old, this)
        rel = agree(this(), earlier(), f'K1 gather {label}')
        times = turns_warm_cold(chip_smoke, earlier, this, 20)
        print_turns(f'K1 gather {label}', times, f'; agree to {rel}')
        result[f'k1_gather_{label}'] = times

    trainer, *step = training_trainer(['loss.pl_weight=2.0'])
    calls = profile_training.capture_gather_calls(trainer, *step)
    del trainer, step
    for label, args in calls:
        gather(f'pl_{label}', **{k: v.detach() if torch.is_tensor(v) else v
                                 for k, v in args.items()})
    del calls, args
    torch.cuda.empty_cache()
    planes, coords, g, scale = uniform_points(gen, n=8)
    u_planes = torch.randn(planes.shape, device='cuda', generator=gen)
    u_coords = torch.randn(coords.shape, device='cuda', generator=gen)
    gather('uniform', planes, coords, g, u_planes, None, scale)
    gather('uniform_coords_cotangent', planes, coords, g, u_planes, u_coords, scale)
    h, w = planes.shape[1], planes.shape[2]
    this = lambda: splat.triplane_splat_dcoords(coords, g, u_coords, scale, h, w)  # noqa: E731
    earlier = on_library(old, this)
    rel = agree((this(),), (earlier(),), 'K1 scatter')
    times = turns_warm_cold(chip_smoke, earlier, this, 20)
    print_turns('K1 scatter (second order) uniform', times, f'; agree to {rel}')
    result['k1_scatter_uniform'] = times
    del planes, coords, g, u_planes, u_coords
    torch.cuda.empty_cache()


def k4_phase(parent, chip_smoke, result, gen):
    old_mlp = earlier_mlp(build_earlier(parent, 'triplane_mlp'))
    n, p, f, hid, out = 4, 16384 * 32, 32, 64, 4  # K4 at the served shape
    feats = torch.randn(n, p, f, device='cuda', generator=gen)
    weights = (torch.randn(f, hid, device='cuda', generator=gen) / f ** 0.5,
               torch.randn(hid, device='cuda', generator=gen) * 0.1,
               torch.randn(hid, out, device='cuda', generator=gen) / hid ** 0.5,
               torch.randn(out, device='cuda', generator=gen) * 0.1)
    rel = agree(triplane_mlp.triplane_mlp(feats, *weights), old_mlp(feats, *weights), 'K4')
    earlier, this = in_turns(chip_smoke.cuda_ms, lambda: old_mlp(feats, *weights),
                             lambda: triplane_mlp.triplane_mlp(feats, *weights), 50)
    print(f'K4 [{n},{p},{f}] -> {hid} -> {out}: earlier {earlier[0]:.4f} / {earlier[1]:.4f} ms, '
          f'this {this[0]:.4f} / {this[1]:.4f} ms (turns: earlier, this, this, earlier); '
          f'agree to {rel}')
    result['k4_served'] = {'earlier_ms': earlier, 'this_ms': this}
    del feats
    torch.cuda.empty_cache()


def k4_bf16_phase(parent, chip_smoke, result, gen):
    old_mlp = earlier_mlp_bf16(build_earlier(parent, 'triplane_mlp'))
    if old_mlp is None:
        print('K4 bf16: the earlier checkout has no bf16 entry, not compared')
        return
    bf = torch.bfloat16
    n, p, f, hid, out = 4, 16384 * 32, 32, 64, 4
    feats = torch.randn(n, p, f, device='cuda', generator=gen).to(bf)
    weights = [(torch.randn(f, hid, device='cuda', generator=gen) / f ** 0.5).to(bf),
               (torch.randn(hid, device='cuda', generator=gen) * 0.1).to(bf),
               (torch.randn(hid, out, device='cuda', generator=gen) / hid ** 0.5).to(bf),
               (torch.randn(out, device='cuda', generator=gen) * 0.1).to(bf)]
    got, ref = triplane_mlp.triplane_mlp(feats, *weights), old_mlp(feats, *weights)
    share = float(torch.cat([(a != b).reshape(-1) for a, b in zip(got, ref)]).float().mean())
    worst = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref))
    scale_ulp = max(float(b.float().abs().max()) for b in ref) * 2.0 ** -7
    if not (share <= 1e-3 and worst <= scale_ulp):
        raise AssertionError(f'K4 bf16: this tree and the earlier kernel disagree: {share:.3g} of '
                             f'the outputs, at most {worst:.3g} (one ulp of the scale {scale_ulp:.3g})')
    runs = {}
    for key, measure in (('warm', lambda fn: chip_smoke.cuda_ms(fn, 50, prefill=True)),
                         ('cold', chip_smoke.cold_ms)):
        earlier, this = in_turns(lambda fn, iters: measure(fn), lambda: old_mlp(feats, *weights),
                                 lambda: triplane_mlp.triplane_mlp(feats, *weights), 50)
        runs[key] = {'earlier_ms': earlier, 'this_ms': this}
        print(f'K4 bf16 [{n},{p},{f}] -> {hid} -> {out} {key}: earlier {earlier[0]:.4f} / '
              f'{earlier[1]:.4f} ms, this {this[0]:.4f} / {this[1]:.4f} ms (turns: earlier, this, '
              f'this, earlier); {share:.3g} of the outputs apart, at most {worst:.3g} (one ulp of '
              f'the scale {scale_ulp:.3g})')
    result['k4_bf16_served'] = {**runs, 'share_apart': share, 'max_abs_diff': worst}
    del feats
    torch.cuda.empty_cache()


def cut_phase(parent, chip_smoke, result, gen):
    old_module = earlier_module(parent, 'tdgp_torch/ops/ray_march.py', 'earlier_ray_march')
    old_cut = earlier_cut(build_earlier(parent, 'ray_march'), old_module.cut_threshold)
    if old_cut is None:
        print('K3 cut: the earlier checkout has no cut entry, not compared')
        return
    q = 0.5
    sets = chip_smoke.merged_sets(gen, 4, 16384, 32, 32, 3)
    thresholds = (ray_march.cut_threshold(sets[2], sets[5], q),
                  old_module.cut_threshold(sets[2], sets[5], q))
    coarse = ray_march.clamp_densities(sets[2])
    coarse_thresholds = ray_march.quantile(coarse, q), old_module.quantile(coarse, q)
    if not (chip_smoke.same_bits(*thresholds) and chip_smoke.same_bits(*coarse_thresholds)):
        raise AssertionError(f'K3 cut: the thresholds differ: {thresholds}, {coarse_thresholds}')
    err = max(float((a - b).abs().max()) for a, b in zip(ray_march.ray_march_merged_cut(*sets, q),
                                                         old_cut(*sets, q=q)))
    if not err <= 1e-5:
        raise AssertionError(f'K3 cut: this tree and the earlier path disagree: {err}')
    runs = [chip_smoke.timed(f'K3 cut, {who}', fn, 200)
            for who, fn in (('earlier', lambda: old_cut(*sets, q=q)),
                            ('this', lambda: ray_march.ray_march_merged_cut(*sets, q)),
                            ('this', lambda: ray_march.ray_march_merged_cut(*sets, q)),
                            ('earlier', lambda: old_cut(*sets, q=q)))]
    result['k3_cut'] = {'earlier': [runs[0], runs[3]], 'this': runs[1:3], 'max_abs_diff': err}
    for key in runs[0]:
        print(f'K3 cut at [4,16384,32+32,3] {key}: earlier {runs[0][key]:.4f} / '
              f'{runs[3][key]:.4f}, this {runs[1][key]:.4f} / {runs[2][key]:.4f} (turns: earlier, '
              f'this, this, earlier); agree to {err:.3g}')
    for label, earlier_fn, this_fn in (
            ('threshold_served', lambda: old_module.cut_threshold(sets[2], sets[5], q),
             lambda: ray_march.cut_threshold(sets[2], sets[5], q)),
            ('threshold_coarse', lambda: old_module.quantile(coarse, q),
             lambda: ray_march.quantile(coarse, q))):
        times = {}
        for key, measure in (('warm', lambda fn: chip_smoke.cuda_ms(fn, 50, prefill=True)),
                             ('cold', chip_smoke.cold_ms)):
            earlier, this = in_turns(lambda fn, iters: measure(fn), earlier_fn, this_fn, 50)
            times[key] = {'earlier_ms': earlier, 'this_ms': this}
            print(f'{label} {key}: earlier {earlier[0]:.4f} / {earlier[1]:.4f} ms, this '
                  f'{this[0]:.4f} / {this[1]:.4f} ms (turns: earlier, this, this, earlier)')
        result[label] = times


def k3_bf16_phase(parent, chip_smoke, result, gen):
    """K3's entries with bf16 loads and its second order against the
    earlier `ray_march.cu` (the module docstring)."""
    old = ray_march.bind(build_earlier(parent, 'ray_march'))

    def compare(label, this, limit=None):
        earlier = on_ray_march(old, this)
        got, ref = this(), earlier()
        if limit is None:
            err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
            ok = err <= 1e-5
        else:
            _, rel = chip_smoke.bwd_bwd_errors(got, ref)
            err, ok = max(rel), all(e <= limit for e in rel)
        if not ok:
            raise AssertionError(f'{label}: this tree and the earlier kernel disagree: {err}')
        times = {}
        for key, measure in (('warm', lambda fn: chip_smoke.cuda_ms(fn, 200, prefill=True)),
                             ('cold', chip_smoke.cold_ms),
                             ('cold_clean', lambda fn: chip_smoke.cold_ms(fn, clean=True))):
            first, mine = in_turns(lambda fn, _: measure(fn), earlier, this, 0)
            times[key] = {'earlier_ms': first, 'this_ms': mine}
        print_turns(label, times, f'; agree to {err:.3g}')
        result[label] = times

    def bf16(sets, densities=True):
        return tuple(x.to(torch.bfloat16) if i in (1, 4) or (densities and i in (2, 5)) else x
                     for i, x in enumerate(sets))

    served = bf16(chip_smoke.merged_sets(gen, 4, 16384, 32, 32, 3))
    train = bf16(chip_smoke.train_merged_sets(gen, 16, 4096, 32, 32, 3), densities=False)
    compare('k3_merged_bf16_served', lambda: ray_march.ray_march_merged(*served))
    compare('k3_merged_bf16_train_float32_densities', lambda: ray_march.ray_march_merged(*train))
    compare('k3_cut_bf16_served', lambda: ray_march.ray_march_merged_cut(*served, 0.5))
    del served, train
    b, r, s, c = 8, 4096, 64, 3
    colors = torch.rand(b, r, s, c, device='cuda', generator=gen)
    densities = torch.randn(b, r, s, device='cuda', generator=gen) * 2
    depths = torch.rand(b, r, s, device='cuda', generator=gen).sort(-1).values * 0.5 + 0.75
    cots = [torch.randn(b, r, c, device='cuda', generator=gen)] + [
        torch.randn(b, r, device='cuda', generator=gen) for _ in range(3)]
    us = [torch.randn(t.shape, device='cuda', generator=gen) for t in (colors, densities, depths)]
    for label, u_depths in (('k3_bwd_bwd_pl', None), ('k3_bwd_bwd_pl_depth_cotangent', us[2])):
        compare(label, lambda u_depths=u_depths: ray_march.ray_march_reduced_bwd_bwd(
            colors, densities, depths, *cots, us[0], us[1], u_depths),
            chip_smoke.PL_KERNEL_LIMIT)
    torch.cuda.empty_cache()


def k3_phase(parent, chip_smoke, result, gen):
    old_lib = build_earlier(parent, 'ray_march')
    old_march = earlier_march(old_lib)
    old_merged = earlier_merged(old_lib)
    old_renderer = earlier_module(parent, 'tdgp_torch/rendering/renderer.py', 'earlier_renderer')

    def same(a_out, b_out, what):
        err = max(float((a - b).abs().max()) for a, b in zip(a_out, b_out))
        if not err <= 1e-5:
            raise AssertionError(f'{what}: this tree and the earlier kernel disagree: {err}')
        return err

    def turns(label, earlier, this, err):
        """`chip_smoke.timed` of the earlier and this version in the order
        earlier, this, this, earlier."""
        runs = [chip_smoke.timed(f'{label}, {who}', fn, 200)
                for who, fn in (('earlier', earlier), ('this', this), ('this', this),
                                ('earlier', earlier))]
        result[label] = {'earlier': [runs[0], runs[3]], 'this': runs[1:3], 'max_abs_diff': err}
        for key in runs[0]:
            print(f'{label} {key}: earlier {runs[0][key]:.4f} / {runs[3][key]:.4f}, this '
                  f'{runs[1][key]:.4f} / {runs[2][key]:.4f} (turns: earlier, this, this, '
                  f'earlier); agree to {err:.3g}')

    s, c = 64, 3
    for label, b, r in (('k3_served', 4, 16384), ('k3_train_shape', 16, 4096)):
        colors = torch.randn(b, r, s, c, device='cuda', generator=gen)
        densities = torch.randn(b, r, s, device='cuda', generator=gen) * 2
        depths = torch.rand(b, r, s, device='cuda', generator=gen).sort(-1).values * 0.5 + 0.75
        err = same(ray_march.ray_march_reduced(colors, densities, depths),
                   old_march(colors, densities, depths), f'K3 {label}')
        turns(label, lambda: old_march(colors, densities, depths),
              lambda: ray_march.ray_march_reduced(colors, densities, depths), err)
        del colors, densities, depths

    sets = chip_smoke.merged_sets(gen, 4, 16384, 32, 32, c)

    def two_step():
        all_depths, all_colors, all_densities = old_renderer.unify_samples_sorted(*sets)
        return old_march(all_colors, all_densities, all_depths)

    err = same(ray_march.ray_march_merged(*sets), two_step(), 'K3 merged')
    turns('k3_merged_vs_two_step', two_step, lambda: ray_march.ray_march_merged(*sets), err)
    if old_merged is not None:  # the merged entry itself, before and after
        err = same(ray_march.ray_march_merged(*sets), old_merged(*sets), 'K3 merged')
        turns('k3_merged', lambda: old_merged(*sets), lambda: ray_march.ray_march_merged(*sets),
              err)


if __name__ == '__main__':
    sys.exit(main())
