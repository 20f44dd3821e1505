"""Kernel K3: reduced classical volume integration and its gradient, in
CUDA C++ for Hopper, with a forward that also takes in the sample merge.

Port of `tdgp/ops/pallas_kernels.py:ray_march_fused`: the forward replaces
`ray_march_pallas` (kernel `:86`), the backward the analytic jnp VJP
`_ray_march_bwd` (`:251`). Both packages reach it through the renderer's
final march when `generator.ray_march_impl` is 'fused'. The kernels are in
`csrc/ray_march.cu`; its source notes give the bounds and the design.

`ray_march_reduced` is differentiable (`RayMarchReduced`, which saves only
the three inputs, as the JAX VJP does). For CUDA tensors its forward
launches the forward kernel and counts the launch in
`ray_march_reduced.launches`, and its backward launches the backward kernel
and counts it in `ray_march_reduced_bwd.launches`. For CPU tensors, and
only for them, it computes `ray_march_reduced_plain` and
`ray_march_reduced_bwd_plain`, the same functions in plain PyTorch, which
the tests and the on-card comparison use as the reference.

`ray_march_merged` takes the two per-ray sorted sample sets of the render
(coarse and fine) as the model evaluated them and computes what
`unify_samples_sorted` followed by `ray_march_reduced` computes, in one
kernel launch (counted in `ray_march_merged.launches`) for CUDA tensors and
as `ray_march_merged_plain` for CPU tensors. It has no backward, and refuses
CUDA inputs that autograd records: training merges with
`unify_samples_sorted` and marches with `ray_march_reduced`.

`ray_march_merged_cut` is the same march with the JAX package's eval-time
quantile cut (NFS's depth maps; the JAX package marches it in jnp): the
clamped densities below their quantile over both sets are marched as 0. The
threshold is taken on the device (`quantile`, a sort, as `jnp.quantile`
interpolates), and the merged kernel's cut instantiation reads it there
(`ray_march_merged_cut.launches`); `ray_march_merged_cut_plain` for CPU
tensors.
"""
from __future__ import annotations

import ctypes
import functools
import types
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tdgp_torch.ops import cuda_build

_CLAMP_MODES = {'softplus': 0, 'relu': 1}
MAX_CHANNELS = 4
MAX_MERGED = 128  # S1 + S2 that the merged kernel takes (kMaxMerged in csrc/ray_march.cu)


def _last_delta(use_inf_depth: bool) -> float:
    return 1e10 if use_inf_depth else 1e-3


def quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """`jnp.quantile(x, q)` over all of x (its default linear interpolation),
    as a one-element float32 tensor on x's device: x sorted, the positions
    floor and ceil of q (n - 1) and their weights in float32 as JAX takes
    them, NaN if x holds one. A sort, not `torch.quantile`, which refuses
    inputs of 2^24 elements and more."""
    flat = x.reshape(-1)
    n = flat.numel()
    pos = np.float32(q) * (np.float32(n) - np.float32(1))
    low, high = np.floor(pos), np.ceil(pos)
    high_weight = np.float32(pos - low)
    low_weight = np.float32(1) - high_weight
    low, high = (int(min(max(i, 0), n - 1)) for i in (low, high))
    ordered = torch.sort(flat).values
    out = ordered[low:low + 1] * low_weight + ordered[high:high + 1] * high_weight
    return torch.where(torch.isnan(flat).any(), torch.full_like(out, float('nan')), out)


def clamp_densities(densities: torch.Tensor, clamp_mode: str = 'softplus',
                    sp_beta: float = 1.0) -> torch.Tensor:
    if clamp_mode == 'softplus':
        return F.softplus(sp_beta * densities) / sp_beta
    if clamp_mode == 'relu':
        return F.relu(densities)
    raise NotImplementedError(f'Unknown clamp mode: {clamp_mode}')


def cut_below_quantile(clamped: torch.Tensor, q: float) -> torch.Tensor:
    """Clamped densities below their q-quantile set to 0
    (`tdgp/rendering/renderer.py:54 _apply_cut_quantile`); q <= 0 cuts nothing."""
    if q <= 0.0:
        return clamped
    return torch.where(clamped < quantile(clamped, q), torch.zeros_like(clamped), clamped)


def classical_ray_march_plain(colors: torch.Tensor, densities: torch.Tensor,
                              depths: torch.Tensor, clamp_mode: str = 'softplus',
                              sp_beta: float = 1.0, use_inf_depth: bool = True,
                              last_back: bool = False, cut_quantile: float = 0.0):
    """The classical marcher of `tdgp/rendering/renderer.py:62-105`, the
    densities below their `cut_quantile`-quantile over the whole tensor
    zeroed after the clamp.

    colors [B,R,S,C], densities [B,R,S], depths [B,R,S]
    -> (rgb [B,R,C], depth [B,R], weights [B,R,S], final_transmittance [B,R]).
    """
    deltas = depths[..., 1:] - depths[..., :-1]
    deltas = torch.cat([deltas, torch.full_like(depths[..., :1], _last_delta(use_inf_depth))], -1)
    densities = cut_below_quantile(clamp_densities(densities, clamp_mode, sp_beta), cut_quantile)
    alphas = 1.0 - torch.exp(-deltas * densities)
    trans = torch.cumprod(1.0 - alphas + 1e-10, dim=-1)
    final_transmittance = trans[..., -1]
    weights = alphas * torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    if last_back:
        weights_agg = weights.sum(-1)
        weights = torch.cat([weights[..., :-1], weights[..., -1:] + (1.0 - weights_agg)[..., None]], -1)
    rgb = (weights[..., None] * colors).sum(-2)
    depth = (weights * depths).sum(-1)
    return rgb, depth, weights, final_transmittance


def ray_march_reduced_plain(colors, densities, depths, clamp_mode: str = 'softplus',
                            sp_beta: float = 1.0, use_inf_depth: bool = True,
                            last_back: bool = False):
    """-> (rgb [B,R,C], depth [B,R], weights_sum [B,R], final_transmittance [B,R])."""
    rgb, depth, weights, ftrans = classical_ray_march_plain(
        colors, densities, depths, clamp_mode, sp_beta, use_inf_depth, last_back)
    return rgb, depth, weights.sum(-1), ftrans


def unify_samples_sorted(depths1, colors1, densities1, depths2, colors2, densities2):
    """Merge two per-ray sorted sample sets into one sorted set
    (`tdgp/rendering/renderer.py:281`).

    Merged positions come from comparison counts, strict for set 1 and
    non-strict for set 2, so ties go to set 1 first and the positions are a
    permutation; the values are scattered to them.
    """
    s1, s2 = depths1.shape[-1], depths2.shape[-1]
    pos1 = torch.arange(s1, device=depths1.device) + (
        depths2[..., None, :] < depths1[..., :, None]).sum(-1)
    pos2 = torch.arange(s2, device=depths2.device) + (
        depths1[..., None, :] <= depths2[..., :, None]).sum(-1)
    pos = torch.cat([pos1, pos2], -1)                                   # [B,R,S]

    def merge(v1, v2):
        v = torch.cat([v1, v2], -1)
        return torch.empty_like(v).scatter_(-1, pos, v)

    all_depths = merge(depths1, depths2)
    all_densities = merge(densities1, densities2)
    colors = torch.cat([colors1, colors2], -2)
    idx = pos[..., None].expand_as(colors)
    all_colors = torch.empty_like(colors).scatter_(-2, idx, colors)
    return all_depths, all_colors, all_densities


def ray_march_merged_plain(depths1, colors1, densities1, depths2, colors2, densities2,
                           clamp_mode: str = 'softplus', sp_beta: float = 1.0,
                           use_inf_depth: bool = True, last_back: bool = False,
                           cut_quantile: float = 0.0):
    """`unify_samples_sorted` followed by the classical march, its densities
    cut below their `cut_quantile`-quantile as JAX's marcher cuts them
    (softplus, quantile, compare, march)
    -> (rgb [B,R,C], depth [B,R], weights_sum [B,R], final_transmittance [B,R])."""
    depths, colors, densities = unify_samples_sorted(depths1, colors1, densities1, depths2,
                                                     colors2, densities2)
    rgb, depth, weights, ftrans = classical_ray_march_plain(
        colors, densities, depths, clamp_mode, sp_beta, use_inf_depth, last_back, cut_quantile)
    return rgb, depth, weights.sum(-1), ftrans


def ray_march_reduced_bwd_plain(colors, densities, depths, g_rgb, g_depth, g_wsum,
                                g_ftrans, clamp_mode: str = 'softplus', sp_beta: float = 1.0,
                                use_inf_depth: bool = True, last_back: bool = False):
    """The gradient of `ray_march_reduced_plain` from its three inputs and
    four cotangents, by the closed form of the JAX package's `_ray_march_bwd`
    -> (g_colors [B,R,S,C], g_densities [B,R,S], g_depths [B,R,S])."""
    deltas = depths[..., 1:] - depths[..., :-1]
    deltas = torch.cat([deltas, torch.full_like(depths[..., :1], _last_delta(use_inf_depth))], -1)
    if clamp_mode == 'softplus':
        sigma = F.softplus(sp_beta * densities) / sp_beta
        dsigma = torch.sigmoid(sp_beta * densities)
    elif clamp_mode == 'relu':
        sigma = F.relu(densities)
        dsigma = (densities > 0).to(densities.dtype)
    else:
        raise NotImplementedError(f'Unknown clamp mode: {clamp_mode}')
    e = torch.exp(-deltas * sigma)
    alpha = 1.0 - e
    factor = 1.0 - alpha + 1e-10
    trans_incl = torch.cumprod(factor, dim=-1)
    t_excl = torch.cat([torch.ones_like(trans_incl[..., :1]), trans_incl[..., :-1]], -1)
    w = alpha * t_excl
    w_corr = w
    if last_back:
        w_corr = torch.cat([w[..., :-1], w[..., -1:] + (1.0 - w.sum(-1, keepdim=True))], -1)
    a = (colors * g_rgb[..., None, :]).sum(-1) + depths * g_depth[..., None] + g_wsum[..., None]
    g = a
    if last_back:
        g = torch.cat([(a - a[..., -1:])[..., :-1], torch.zeros_like(a[..., :1])], -1)
    gw = g * w
    suffix = gw.flip(-1).cumsum(-1).flip(-1) - gw
    gf = -g * t_excl + (suffix + g_ftrans[..., None] * trans_incl[..., -1:]) / factor
    g_densities = gf * (-deltas * e) * dsigma
    g_colors = w_corr[..., None] * g_rgb[..., None, :]
    gd = (gf * (-sigma * e))[..., :-1]
    g_depths = w_corr * g_depth[..., None]
    g_depths = g_depths - F.pad(gd, (0, 1)) + F.pad(gd, (1, 0))
    return g_colors, g_densities, g_depths


@functools.cache
def _kernels():
    lib = cuda_build.library('ray_march')
    scalars = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fwd = lib.tdgp_ray_march_reduced
    fwd.argtypes = [ctypes.c_void_p] * 7 + scalars
    fwd.restype = ctypes.c_int
    bwd = lib.tdgp_ray_march_reduced_bwd
    bwd.argtypes = [ctypes.c_void_p] * 10 + scalars
    bwd.restype = ctypes.c_int
    merged = lib.tdgp_ray_march_merged
    merged.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    merged.restype = ctypes.c_int
    cut = lib.tdgp_ray_march_merged_cut
    cut.argtypes = [ctypes.c_void_p] * 11 + merged.argtypes[10:]
    cut.restype = ctypes.c_int
    lib.tdgp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tdgp_cuda_error_string.restype = ctypes.c_char_p
    return types.SimpleNamespace(fwd=fwd, bwd=bwd, merged=merged, cut=cut,
                                 error_string=lib.tdgp_cuda_error_string)


def _launch(fn, error_string, what, device, tensors, n_rays, s, c, clamp_mode, sp_beta,
            use_inf_depth, last_back):
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f'{what} takes contiguous tensors')
    with torch.cuda.device(device):
        err = fn(*[t.data_ptr() for t in tensors], n_rays, s, c, _CLAMP_MODES[clamp_mode],
                 float(sp_beta), _last_delta(use_inf_depth), int(last_back),
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'{what} launch failed: {error_string(err).decode()}')


def _check(colors: torch.Tensor, densities: torch.Tensor, depths: torch.Tensor,
           clamp_mode: str) -> None:
    if clamp_mode not in _CLAMP_MODES:
        raise NotImplementedError(f'Unknown clamp mode: {clamp_mode}')
    if colors.ndim != 4 or densities.shape != colors.shape[:3] or depths.shape != densities.shape:
        raise ValueError(f'expected colors [B,R,S,C] and densities/depths [B,R,S], got '
                         f'{tuple(colors.shape)}, {tuple(densities.shape)}, {tuple(depths.shape)}')
    if not 1 <= colors.shape[3] <= MAX_CHANNELS or colors.shape[2] < 1:
        raise ValueError(f'need 1 <= C <= {MAX_CHANNELS} and S >= 1, got {tuple(colors.shape)}')
    for t in (colors, densities, depths):
        if t.dtype != torch.float32:
            raise TypeError(f'ray_march_reduced takes float32, got {t.dtype}')
        if t.device != colors.device:
            raise ValueError(f'inputs on {colors.device} and {t.device}')


def _forward(colors, densities, depths, clamp_mode, sp_beta, use_inf_depth, last_back):
    device = colors.device
    if device.type == 'cpu':
        return ray_march_reduced_plain(colors, densities, depths, clamp_mode, sp_beta,
                                       use_inf_depth, last_back)
    if device.type != 'cuda':
        raise ValueError(f'ray_march_reduced runs on CUDA or CPU tensors, not {device}')
    b, r, s, c = colors.shape
    rgb = torch.empty((b, r, c), dtype=torch.float32, device=device)
    depth, wsum, ftrans = (torch.empty((b, r), dtype=torch.float32, device=device)
                           for _ in range(3))
    k = _kernels()
    _launch(k.fwd, k.error_string, 'ray_march_reduced', device,
            (colors, densities, depths, rgb, depth, wsum, ftrans), b * r, s, c,
            clamp_mode, sp_beta, use_inf_depth, last_back)
    ray_march_reduced.launches += 1
    return rgb, depth, wsum, ftrans


def ray_march_reduced_bwd(colors, densities, depths, g_rgb, g_depth, g_wsum, g_ftrans,
                          clamp_mode: str = 'softplus', sp_beta: float = 1.0,
                          use_inf_depth: bool = True, last_back: bool = False):
    """The backward kernel for CUDA tensors, `ray_march_reduced_bwd_plain`
    for CPU tensors -> (g_colors, g_densities, g_depths)."""
    _check(colors, densities, depths, clamp_mode)
    device = colors.device
    if device.type == 'cpu':
        return ray_march_reduced_bwd_plain(colors, densities, depths, g_rgb, g_depth, g_wsum,
                                           g_ftrans, clamp_mode, sp_beta, use_inf_depth,
                                           last_back)
    if device.type != 'cuda':
        raise ValueError(f'ray_march_reduced_bwd runs on CUDA or CPU tensors, not {device}')
    b, r, s, c = colors.shape
    grads = [g.to(torch.float32).contiguous() for g in (g_rgb, g_depth, g_wsum, g_ftrans)]
    g_colors = torch.empty_like(colors)
    g_densities, g_depths = torch.empty_like(densities), torch.empty_like(depths)
    k = _kernels()
    _launch(k.bwd, k.error_string, 'ray_march_reduced_bwd', device,
            (colors, densities, depths, *grads, g_colors, g_densities, g_depths), b * r, s, c,
            clamp_mode, sp_beta, use_inf_depth, last_back)
    ray_march_reduced_bwd.launches += 1
    return g_colors, g_densities, g_depths


class RayMarchReduced(torch.autograd.Function):
    """K3 forward and backward, or with `plain` their plain versions on any
    device; the context keeps only the three inputs."""

    @staticmethod
    def forward(ctx, colors, densities, depths, clamp_mode, sp_beta, use_inf_depth, last_back,
                plain):
        ctx.save_for_backward(colors, densities, depths)
        ctx.opts = (clamp_mode, sp_beta, use_inf_depth, last_back)
        ctx.plain = plain
        fwd = ray_march_reduced_plain if plain else _forward
        return fwd(colors, densities, depths, clamp_mode, sp_beta, use_inf_depth, last_back)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_rgb, g_depth, g_wsum, g_ftrans):
        colors, densities, depths = ctx.saved_tensors
        grads = [torch.zeros_like(ref) if g is None else g
                 for g, ref in ((g_rgb, colors[..., 0, :]), (g_depth, depths[..., 0]),
                                (g_wsum, depths[..., 0]), (g_ftrans, depths[..., 0]))]
        bwd = ray_march_reduced_bwd_plain if ctx.plain else ray_march_reduced_bwd
        return (*bwd(colors, densities, depths, *grads, *ctx.opts),
                None, None, None, None, None)


def ray_march_reduced(colors: torch.Tensor, densities: torch.Tensor, depths: torch.Tensor,
                      clamp_mode: str = 'softplus', sp_beta: float = 1.0,
                      use_inf_depth: bool = True, last_back: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """colors [B,R,S,C], densities [B,R,S], depths [B,R,S], float32
    -> (rgb [B,R,C], depth [B,R], weights_sum [B,R], final_transmittance [B,R]).
    Differentiable in all three inputs (first order)."""
    _check(colors, densities, depths, clamp_mode)
    return RayMarchReduced.apply(colors, densities, depths, clamp_mode, sp_beta,
                                 use_inf_depth, last_back, False)


def ray_march_reduced_reference(colors, densities, depths, clamp_mode: str = 'softplus',
                                sp_beta: float = 1.0, use_inf_depth: bool = True,
                                last_back: bool = False):
    """`ray_march_reduced` through the plain forward and backward on any
    device: the reference the kernels are held against on the card."""
    _check(colors, densities, depths, clamp_mode)
    return RayMarchReduced.apply(colors, densities, depths, clamp_mode, sp_beta,
                                 use_inf_depth, last_back, True)


def _check_merged(sets, clamp_mode: str) -> None:
    if clamp_mode not in _CLAMP_MODES:
        raise NotImplementedError(f'Unknown clamp mode: {clamp_mode}')
    shapes = [tuple(t.shape) for t in sets]
    (t1, c1, x1), (t2, c2, x2) = shapes[:3], shapes[3:]
    if not (len(t1) == 3 and len(t2) == 3 and x1 == t1 and x2 == t2 and c1 == (*t1, c1[-1])
            and c2 == (*t2, c1[-1]) and t1[:2] == t2[:2]):
        raise ValueError(f'expected depths/densities [B,R,S1] and [B,R,S2] with colors '
                         f'[B,R,S1,C] and [B,R,S2,C], got {shapes}')
    if not (t1[2] >= 1 and t2[2] >= 1 and t1[2] + t2[2] <= MAX_MERGED):
        raise ValueError(f'need S1, S2 >= 1 and S1 + S2 <= {MAX_MERGED}, got {t1[2]} + {t2[2]}')
    if not 1 <= c1[-1] <= MAX_CHANNELS:
        raise ValueError(f'need 1 <= C <= {MAX_CHANNELS}, got {c1[-1]}')
    for t in sets:
        if t.dtype != torch.float32:
            raise TypeError(f'ray_march_merged takes float32, got {t.dtype}')
        if t.device != sets[0].device:
            raise ValueError(f'inputs on {sets[0].device} and {t.device}')
        if not t.is_contiguous():
            raise ValueError('ray_march_merged takes contiguous tensors')


def ray_march_merged(depths1: torch.Tensor, colors1: torch.Tensor, densities1: torch.Tensor,
                     depths2: torch.Tensor, colors2: torch.Tensor, densities2: torch.Tensor,
                     clamp_mode: str = 'softplus', sp_beta: float = 1.0,
                     use_inf_depth: bool = True, last_back: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The final march over the merge of two per-ray sorted sample sets:
    depths [B,R,S1], colors [B,R,S1,C], densities [B,R,S1] and the same with
    S2, float32, contiguous, S1 + S2 <= 128, C <= 4
    -> (rgb [B,R,C], depth [B,R], weights_sum [B,R], final_transmittance [B,R]),
    what `ray_march_merged_plain` computes. Not differentiable on the card."""
    sets = (depths1, colors1, densities1, depths2, colors2, densities2)
    _check_merged(sets, clamp_mode)
    device = depths1.device
    if device.type == 'cpu':
        return ray_march_merged_plain(*sets, clamp_mode, sp_beta, use_inf_depth, last_back)
    if device.type != 'cuda':
        raise ValueError(f'ray_march_merged runs on CUDA or CPU tensors, not {device}')
    if torch.is_grad_enabled() and any(t.requires_grad for t in sets):
        raise RuntimeError('ray_march_merged has no backward: where autograd records, merge '
                           'with unify_samples_sorted and march with ray_march_reduced')
    b, r, s1 = depths1.shape
    s2, c = depths2.shape[2], colors1.shape[3]
    rgb = torch.empty((b, r, c), dtype=torch.float32, device=device)
    depth, wsum, ftrans = (torch.empty((b, r), dtype=torch.float32, device=device)
                           for _ in range(3))
    k = _kernels()
    with torch.cuda.device(device):
        err = k.merged(*[t.data_ptr() for t in (*sets, rgb, depth, wsum, ftrans)], b * r, s1, s2,
                     c, _CLAMP_MODES[clamp_mode], float(sp_beta), _last_delta(use_inf_depth),
                     int(last_back), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'ray_march_merged launch failed: {k.error_string(err).decode()}')
    ray_march_merged.launches += 1
    return rgb, depth, wsum, ftrans


def cut_threshold(densities1: torch.Tensor, densities2: torch.Tensor, cut_quantile: float,
                  clamp_mode: str = 'softplus', sp_beta: float = 1.0) -> torch.Tensor:
    """The `cut_quantile`-quantile of the clamped densities of both sample
    sets together (one-element tensor on their device): the threshold of
    the merged march, which a quantile takes in any order."""
    return quantile(torch.cat([clamp_densities(x, clamp_mode, sp_beta).reshape(-1)
                               for x in (densities1, densities2)]), cut_quantile)


def ray_march_merged_cut_plain(depths1, colors1, densities1, depths2, colors2, densities2,
                               cut_quantile: float, clamp_mode: str = 'softplus',
                               sp_beta: float = 1.0, use_inf_depth: bool = True,
                               last_back: bool = False):
    """`ray_march_merged_plain` with the cut, in `ray_march_merged_cut`'s signature."""
    return ray_march_merged_plain(depths1, colors1, densities1, depths2, colors2, densities2,
                                  clamp_mode, sp_beta, use_inf_depth, last_back, cut_quantile)


def ray_march_merged_cut(depths1: torch.Tensor, colors1: torch.Tensor, densities1: torch.Tensor,
                         depths2: torch.Tensor, colors2: torch.Tensor, densities2: torch.Tensor,
                         cut_quantile: float, clamp_mode: str = 'softplus', sp_beta: float = 1.0,
                         use_inf_depth: bool = True, last_back: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """`ray_march_merged` with the clamped densities below their
    `cut_quantile`-quantile over both sets (0 < cut_quantile <= 1) set to 0
    before the march, as the JAX package's eval-time cut has them: the
    threshold by `cut_threshold` on the inputs' device, then one launch of
    the merged kernel's cut entry, which reads it there (counted in
    `ray_march_merged_cut.launches`); `ray_march_merged_cut_plain` for CPU
    tensors."""
    sets = (depths1, colors1, densities1, depths2, colors2, densities2)
    _check_merged(sets, clamp_mode)
    if not 0.0 < cut_quantile <= 1.0:
        raise ValueError(f'cut_quantile must be in (0, 1], got {cut_quantile}')
    device = depths1.device
    if device.type == 'cpu':
        return ray_march_merged_cut_plain(*sets, cut_quantile, clamp_mode, sp_beta,
                                          use_inf_depth, last_back)
    if device.type != 'cuda':
        raise ValueError(f'ray_march_merged_cut runs on CUDA or CPU tensors, not {device}')
    if torch.is_grad_enabled() and any(t.requires_grad for t in sets):
        raise RuntimeError('ray_march_merged_cut has no backward')
    threshold = cut_threshold(densities1, densities2, cut_quantile, clamp_mode, sp_beta)
    b, r, s1 = depths1.shape
    s2, c = depths2.shape[2], colors1.shape[3]
    rgb = torch.empty((b, r, c), dtype=torch.float32, device=device)
    depth, wsum, ftrans = (torch.empty((b, r), dtype=torch.float32, device=device)
                           for _ in range(3))
    k = _kernels()
    with torch.cuda.device(device):
        err = k.cut(*[t.data_ptr() for t in (*sets, threshold, rgb, depth, wsum, ftrans)], b * r,
                  s1, s2, c, _CLAMP_MODES[clamp_mode], float(sp_beta),
                  _last_delta(use_inf_depth), int(last_back),
                  torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'ray_march_merged_cut launch failed: {k.error_string(err).decode()}')
    ray_march_merged_cut.launches += 1
    return rgb, depth, wsum, ftrans


ray_march_reduced.launches = 0
ray_march_reduced_bwd.launches = 0
ray_march_merged.launches = 0
ray_march_merged_cut.launches = 0
