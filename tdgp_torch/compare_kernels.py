"""Time K1, K4 and K3 against the kernels of another checkout, in turns, on one card.

    python3 -m tdgp_torch.compare_kernels --parent DIR

DIR is a checkout of an earlier commit. Each kernel whose source
(`tdgp_torch/csrc/<name>.cu`) differs there is compared; the others are
skipped as unchanged. The earlier kernels are called through these C
interfaces: K1 as `tdgp_triplane_splat(planes, coords, g, g_planes,
g_coords, n, p, h, w, f, scale, stream)` into a zeroed g_planes (the
interface before the binned splat), K4's `tdgp_triplane_mlp` and K3's
`tdgp_ray_march_reduced` as now. They are built here with this tree's nvcc
flags. On the same inputs, this tree's wrapper and the earlier kernel (with
the zero fill its wrapper made) are timed in the order earlier, this, this,
earlier (`chip_smoke.cuda_ms` each; K3 with `chip_smoke.timed`: warm, warm
with the calls enqueued ahead, cold after a write that evicts the L2, cold
with a clean L2, and the host's time per call), and their results are held
against each other (<= 1e-5 x max |earlier|; K3 <= 1e-5 absolute):
  - K1 on the uniform points of `chip_smoke.py` (batch 16, 64^2 x 32 points,
    planes 48 x 512^2 x 32), and on the coarse and the fine pass of one
    warm-up step of the satellite 256^2 `Trainer` (batch 16);
  - K4 at the served shape, [4, 524288, 32] -> 64 -> 4;
  - K3 at the served chunk [4, 16384, 64, 3] and at the training shape
    [16, 4096, 64, 3]; and the earlier two-step final march of a served
    chunk, the earlier checkout's own `unify_samples_sorted`
    (`tdgp_torch/rendering/renderer.py` there) then its K3, against this
    tree's merged entry on the same two sets of 32 samples; and the earlier
    merged entry (`tdgp_ray_march_merged`, where the checkout has it)
    against this tree's.
Prints the card's name and power limit, one line per input, and a JSON
object of the times as its last line. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

import torch

from tdgp_torch.ops import cuda_build, ray_march, splat, triplane_mlp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_earlier(parent: str, name: str) -> ctypes.CDLL:
    src = os.path.join(parent, 'tdgp_torch', 'csrc', f'{name}.cu')
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(cuda_build.BUILD_DIR, f'libearlier_{name}.so')
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, '-o', out, src], check=True)
    return ctypes.CDLL(out)


def earlier_splat(lib):
    fn = lib.tdgp_triplane_splat
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(planes, coords, g, scale, coords_grad=True):
        n3, h, w, f = planes.shape
        n, p = coords.shape[0], coords.shape[1]
        g_planes = torch.zeros_like(planes)
        g_coords = torch.empty((n, p, 3), device=planes.device) if coords_grad else None
        err = fn(planes.data_ptr() if coords_grad else None, coords.data_ptr(), g.data_ptr(),
                 g_planes.data_ptr(), g_coords.data_ptr() if coords_grad else None, n, p, h, w,
                 f, float(scale), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f'the earlier K1 failed to launch: {err}')
        return g_planes, g_coords
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
    """Whether `csrc/<name>.cu` of the earlier checkout differs from this tree's."""
    with open(os.path.join(parent, 'tdgp_torch', 'csrc', f'{name}.cu'), 'rb') as f:
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
    cuda_build.build(['splat', 'triplane_mlp', 'ray_march'])
    result = {}
    gen = torch.Generator(device='cuda').manual_seed(0)
    for name, compare in (('splat', k1_phase), ('triplane_mlp', k4_phase),
                          ('ray_march', k3_phase)):
        if changed(args.parent, name):
            compare(args.parent, chip_smoke, result, gen)
        else:
            print(f'{name}.cu: unchanged, not compared')
    print(json.dumps({'card': card, **result}))
    return 0


def k1_phase(parent, chip_smoke, result, gen):
    from tdgp_torch import profile_training
    from tdgp_torch.training.schedules import compute_schedules
    from tdgp_torch.training.train_step import Trainer
    from tdgp_torch.utils.draws import Draws
    old_splat = earlier_splat(build_earlier(parent, 'splat'))

    def k1(label, planes, coords, g, scale, coords_grad=True):
        rel = agree(splat.triplane_splat(planes, coords, g, scale, coords_grad),
                    old_splat(planes, coords, g, scale, coords_grad), f'K1 {label}')
        earlier, this = in_turns(
            chip_smoke.cuda_ms, lambda: old_splat(planes, coords, g, scale, coords_grad),
            lambda: splat.triplane_splat(planes, coords, g, scale, coords_grad), 20)
        print(f'K1 {label}: earlier {earlier[0]:.4f} / {earlier[1]:.4f} ms, this '
              f'{this[0]:.4f} / {this[1]:.4f} ms (turns: earlier, this, this, earlier); '
              f'agree to {rel}')
        result[f'k1_{label}'] = {'earlier_ms': earlier, 'this_ms': this}

    cfg = profile_training.train_config()
    trainer = Trainer(cfg, 'cuda', seed=0)
    calls = profile_training.capture_splat_calls(
        trainer, profile_training.make_batch(cfg, profile_training.BATCH, 0, 'cuda'),
        compute_schedules(cfg, profile_training.CUR_NIMG),
        Draws(torch.Generator(device='cuda').manual_seed(1)))
    del trainer
    for label, (planes, coords, g, scale, coords_grad) in calls:
        k1(f'step_{label}', planes.detach(), coords.detach(), g.detach().contiguous(), scale,
           coords_grad)
    del calls, planes, coords, g
    torch.cuda.empty_cache()

    n, h, w, f, scale = 16, 512, 512, 32, 0.5  # chip_smoke's uniform points
    p = 64 * 64 * 32
    planes = torch.randn(3 * n, h, w, f, device='cuda', generator=gen)
    coords = torch.rand(n, p, 3, device='cuda', generator=gen) * 1.1 - 0.55
    coords[:, :64, 0] = scale
    coords[:, 64:128, 1] = -scale
    k1('uniform', planes, coords, torch.randn(n, p, f, device='cuda', generator=gen), scale)
    del planes, coords
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
