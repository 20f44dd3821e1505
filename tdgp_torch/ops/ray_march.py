"""Kernel K3: reduced classical volume integration and its gradient, in
CUDA C++ for Hopper, with a forward that also takes in the sample merge.

Port of `tdgp/ops/pallas_kernels.py:ray_march_fused`: the forward replaces
`ray_march_pallas` (kernel `:86`), the backward the analytic jnp VJP
`_ray_march_bwd` (`:251`). Both packages reach it through the renderer's
final march when `generator.ray_march_impl` is 'fused'. The kernels are in
`csrc/ray_march.cu`; its source notes give the bounds and the design.

`ray_march_reduced` is differentiable twice (`RayMarchReduced`, which
saves only the three inputs, as the JAX VJP does, and whose backward is
itself a recorded function, `RayMarchReducedBackward`). For CUDA tensors
its forward launches the forward kernel and counts the launch in
`ray_march_reduced.launches`, its backward launches the backward kernel and
counts it in `ray_march_reduced_bwd.launches`, and the backward's own
backward (a gradient of a gradient: the 3DGP model's path-length
regularization) launches the second-order kernel, counted in
`ray_march_reduced_bwd_bwd.launches`. For CPU tensors, and only for them,
it computes `ray_march_reduced_plain`, `ray_march_reduced_bwd_plain` and
`ray_march_reduced_bwd_bwd_plain` (autograd through the backward's plain
version), the same functions in plain PyTorch, which the tests and the
on-card comparison use as the reference.

`ray_march_merged` takes the two per-ray sorted sample sets of the render
(coarse and fine) as the model evaluated them and computes what
`unify_samples_sorted` followed by `ray_march_reduced` computes, in one
kernel launch (counted in `ray_march_merged.launches`) for CUDA tensors and
as `ray_march_merged_plain` for CPU tensors. It has no backward, and refuses
CUDA inputs that autograd records: training merges with
`unify_samples_sorted` and marches with `ray_march_reduced`.

Under the bf16 render views (`generator.render_bf16`) the model gives bf16
colours and densities (densities in float32 where a training render added
its noise). `ray_march_merged` and `ray_march_merged_cut` hand them to their
bf16-load entries, `ray_march_merged_bf16` and `ray_march_merged_cut_bf16`
(their own launch counts), which stage the values as bf16, widen each to
float32 exactly as the march reads it and march in float32, as the JAX
package does after its merge promotes them; the plain versions are the
same functions, since
`unify_samples_sorted` returns float32 as JAX's one-hot merge does.

`ray_march_merged_cut` is the same march with the JAX package's eval-time
quantile cut (NFS's depth maps; the JAX package marches it in jnp): the
clamped densities below their quantile over both sets are marched as 0. The
threshold is taken on the device by a radix select (`cut_threshold`, kernel
in `csrc/quantile.cu`, which reads the raw densities of both sets and
clamps them as the march does), and the merged kernel's cut instantiation
reads it there (`ray_march_merged_cut.launches`); `ray_march_merged_cut_plain`
for CPU tensors. The coarse march of a cut render takes its threshold by the
same kernel: the renderer hands `quantile` (the select on CUDA tensors) to
`cut_below_quantile`. The select's launches count in
`cut_threshold.launches`, one per threshold; its plain version is the sort,
`quantile_plain` (`cut_threshold_plain`), which every plain version takes on
any device, and `quantile_radix_plain` walks the kernel's passes in PyTorch.
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


def _quantile_weights(n: int, q: float):
    """(low, high, low_weight, high_weight) of `jnp.quantile`'s linear
    interpolation over n values: the positions floor and ceil of q (n - 1)
    and their weights, in float32 as JAX takes them."""
    pos = np.float32(q) * (np.float32(n) - np.float32(1))
    low, high = np.floor(pos), np.ceil(pos)
    high_weight = np.float32(pos - low)
    low_weight = np.float32(1) - high_weight
    low, high = (int(min(max(i, 0), n - 1)) for i in (low, high))
    return low, high, low_weight, high_weight


def _interpolate(lo: torch.Tensor, hi: torch.Tensor, low_weight, high_weight, dtype, has_nan):
    """lo * w_low + hi * w_high in float32 (bf16 widened), rounded once to
    `dtype`; NaN where `has_nan`."""
    out = (widen(lo) * low_weight + widen(hi) * high_weight).to(dtype)
    return torch.where(has_nan, torch.full_like(out, float('nan')), out)


def quantile_plain(x: torch.Tensor, q: float) -> torch.Tensor:
    """`jnp.quantile(x, q)` over all of x (its default linear interpolation),
    as a one-element tensor of x's dtype on x's device: x sorted, the
    positions floor and ceil of q (n - 1) and their weights in float32 as JAX
    takes them (bf16 values widened, the result rounded once), NaN if x
    holds one. A sort, not `torch.quantile`, which refuses
    inputs of 2^24 elements and more."""
    flat = x.reshape(-1)
    low, high, low_weight, high_weight = _quantile_weights(flat.numel(), q)
    ordered = torch.sort(flat).values
    return _interpolate(ordered[low:low + 1], ordered[high:high + 1], low_weight, high_weight,
                        flat.dtype, torch.isnan(flat).any())


# (shift, bits) of the select's digits, from the top of the 32-bit keys (csrc/quantile.cu)
QUANTILE_DIGITS = ((21, 11), (10, 11), (0, 10))


def quantile_keys(values: torch.Tensor) -> torch.Tensor:
    """The select's order-preserving keys of float32 (or bf16, widened)
    values, as int64 in [0, 2^32): the float's bits with the sign bit
    flipped for a positive value, all bits flipped for a negative one."""
    bits = widen(values).contiguous().view(torch.int32).to(torch.int64) & 0xffffffff
    return torch.where(bits >> 31 == 1, bits ^ 0xffffffff, bits | 0x80000000)


def key_values(keys: torch.Tensor) -> torch.Tensor:
    """The float32 values of `quantile_keys`' keys (int64)."""
    bits = torch.where(keys >> 31 == 1, keys ^ 0x80000000, keys ^ 0xffffffff)
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32).view(torch.float32)


def quantile_radix_plain(x: torch.Tensor, q: float, blocks: int = 3) -> torch.Tensor:
    """`quantile_plain(x, q)` by the select kernel's passes
    (`csrc/quantile.cu`), in PyTorch: the values' keys (`quantile_keys`);
    for each digit of QUANTILE_DIGITS, every block of the values (`blocks`
    of them, as the kernel's blocks split them) counts the digits of the keys
    that share the prefix found so far for rank low, and, where it differs,
    for rank high, the blocks' histograms are added, and the bin that holds
    each rank gives the next digit of its prefix and its rank within the bin;
    after the last digit the prefixes are the keys of ranks low and high,
    interpolated as `quantile_plain` does."""
    flat = x.reshape(-1)
    n = flat.numel()
    low, high, low_weight, high_weight = _quantile_weights(n, q)
    keys = quantile_keys(flat)
    parts = keys.tensor_split(blocks)
    prefix, rank = [0, 0], [low, high]
    for shift, bits in QUANTILE_DIGITS:
        above = ~((1 << (shift + bits)) - 1) & 0xffffffff
        two = prefix[0] != prefix[1]
        hists = [sum(torch.bincount((part[(part & above) == prefix[t]] >> shift) & ((1 << bits) - 1),
                                    minlength=1 << bits) for part in parts)
                 for t in range(2 if two else 1)]
        for t in range(2):
            hist = hists[t if two else 0]
            before = torch.cumsum(hist, 0) - hist
            digit = int(torch.nonzero((before <= rank[t]) & (rank[t] < before + hist))[0, 0])
            prefix[t] |= digit << shift
            rank[t] -= int(before[digit])
    lo, hi = key_values(torch.tensor(prefix, dtype=torch.int64)).split(1)
    return _interpolate(lo, hi, low_weight, high_weight, flat.dtype, torch.isnan(flat).any())


@functools.cache
def _select_kernel():
    lib = cuda_build.library('quantile')
    fn = lib.tdgp_quantile_select
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.tdgp_quantile_scratch_bytes.argtypes = [ctypes.c_longlong]
    lib.tdgp_quantile_scratch_bytes.restype = ctypes.c_longlong
    lib.tdgp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tdgp_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.tdgp_quantile_scratch_bytes, lib.tdgp_cuda_error_string


def _select(values, q: float, clamp_mode, sp_beta: float, out_dtype: torch.dtype,
            keys_out: bool = False):
    """One select (`csrc/quantile.cu`) over the values of one or two CUDA
    tensors of one dtype (float32 or bf16), each clamped first by
    `clamp_mode` (None: as they are) -> the q-quantile as a one-element
    tensor of `out_dtype` on their device, counted in `cut_threshold.launches`;
    with `keys_out`, also the keys its first pass wrote (int64, as
    `quantile_keys` gives them), for holding its clamp on the card."""
    device = values[0].device
    if device.type != 'cuda':
        raise ValueError(f'cut_threshold runs on CUDA or CPU tensors, not {device}')
    dtype = values[0].dtype
    if dtype not in (torch.float32, torch.bfloat16) or any(
            v.dtype != dtype or v.device != device for v in values):
        raise TypeError(f'cut_threshold takes float32 or bf16 tensors of one dtype on one '
                        f'device, got {[(v.dtype, str(v.device)) for v in values]}')
    if clamp_mode is not None and clamp_mode not in _CLAMP_MODES:
        raise NotImplementedError(f'Unknown clamp mode: {clamp_mode}')
    if not 0.0 <= q <= 1.0:
        raise ValueError(f'q must be in [0, 1], got {q}')
    values = [v.contiguous() for v in values]
    sizes = [v.numel() for v in values]
    n = sum(sizes)
    if not 1 <= n < 2 ** 31:
        raise ValueError(f'cut_threshold takes 1 to 2^31 - 1 values, got {n}')
    low, high, low_weight, high_weight = _quantile_weights(n, q)
    fn, scratch_bytes, error_string = _select_kernel()
    scratch = torch.empty(scratch_bytes(n), dtype=torch.uint8, device=device)
    out = torch.empty(1, dtype=out_dtype, device=device)
    a, b = values[0], values[1] if len(values) > 1 else None
    with torch.cuda.device(device):
        err = fn(a.data_ptr(), sizes[0], 0 if b is None else b.data_ptr(),
                 0 if b is None else sizes[1], int(dtype == torch.bfloat16),
                 -1 if clamp_mode is None else _CLAMP_MODES[clamp_mode], float(sp_beta), low,
                 high, float(low_weight), float(high_weight), out.data_ptr(),
                 int(out_dtype == torch.bfloat16), scratch.data_ptr(),
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'cut_threshold launch failed: {error_string(err).decode()}')
    cut_threshold.launches += 1
    if keys_out:
        keys = scratch[scratch_bytes(0):].view(torch.int32).to(torch.int64) & 0xffffffff
        return out, keys
    return out


def quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """`jnp.quantile(x, q)` over all of x, as a one-element tensor of x's
    dtype on x's device: on CUDA tensors (float32 or bf16) by the select
    kernel (counted in `cut_threshold.launches`), on CPU tensors by the sort,
    `quantile_plain`, which gives the same bits (a zero may differ in sign)."""
    if x.device.type == 'cpu':
        return quantile_plain(x, q)
    return _select((x,), q, None, 1.0, x.dtype)


def widen(x: torch.Tensor) -> torch.Tensor:
    """bf16 -> float32 (exact); other dtypes as they are."""
    return x.float() if x.dtype == torch.bfloat16 else x


def clamp_densities(densities: torch.Tensor, clamp_mode: str = 'softplus',
                    sp_beta: float = 1.0) -> torch.Tensor:
    """softplus(beta x) / beta or relu(x). In bf16 (the coarse march of an
    eval render under `generator.render_bf16`) softplus is JAX's chain,
    max(x, 0) + log1p(exp(-|x|)), each step rounded to bf16."""
    if clamp_mode == 'softplus' and densities.dtype == torch.bfloat16:
        x = sp_beta * densities
        return (x.clamp_min(0.0) + torch.log1p(torch.exp(-x.abs()))) / sp_beta
    if clamp_mode == 'softplus':
        return F.softplus(sp_beta * densities) / sp_beta
    if clamp_mode == 'relu':
        return F.relu(densities)
    raise NotImplementedError(f'Unknown clamp mode: {clamp_mode}')


def cut_below_quantile(clamped: torch.Tensor, q: float, quantile_fn=None) -> torch.Tensor:
    """Clamped densities below their q-quantile set to 0
    (`tdgp/rendering/renderer.py:54 _apply_cut_quantile`); q <= 0 cuts nothing.
    The threshold by `quantile_fn` (x, q): the sort, `quantile_plain`, unless
    the caller passes `quantile`, which launches the select on CUDA tensors."""
    if q <= 0.0:
        return clamped
    threshold = (quantile_fn or quantile_plain)(clamped, q)
    return torch.where(clamped < threshold, torch.zeros_like(clamped), clamped)


def classical_ray_march_plain(colors: torch.Tensor, densities: torch.Tensor,
                              depths: torch.Tensor, clamp_mode: str = 'softplus',
                              sp_beta: float = 1.0, use_inf_depth: bool = True,
                              last_back: bool = False, cut_quantile: float = 0.0,
                              quantile_fn=None):
    """The classical marcher of `tdgp/rendering/renderer.py:62-105`, the
    densities below their `cut_quantile`-quantile over the whole tensor
    zeroed after the clamp (the threshold by `cut_below_quantile`, with
    `quantile_fn`).

    colors [B,R,S,C], densities [B,R,S], depths [B,R,S]
    -> (rgb [B,R,C], depth [B,R], weights [B,R,S], final_transmittance [B,R]).
    """
    deltas = depths[..., 1:] - depths[..., :-1]
    deltas = torch.cat([deltas, torch.full_like(depths[..., :1], _last_delta(use_inf_depth))], -1)
    densities = cut_below_quantile(clamp_densities(densities, clamp_mode, sp_beta), cut_quantile,
                                   quantile_fn)
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
    permutation; the values are scattered to them. bf16 colours and
    densities come out in the depths' dtype (float32), as JAX's float32
    one-hot products promote them.
    """
    s1, s2 = depths1.shape[-1], depths2.shape[-1]
    pos1 = torch.arange(s1, device=depths1.device) + (
        depths2[..., None, :] < depths1[..., :, None]).sum(-1)
    pos2 = torch.arange(s2, device=depths2.device) + (
        depths1[..., None, :] <= depths2[..., :, None]).sum(-1)
    pos = torch.cat([pos1, pos2], -1)                                   # [B,R,S]

    dtype = depths1.dtype

    def merge(v1, v2):
        v = torch.cat([v1.to(torch.promote_types(v1.dtype, dtype)),
                       v2.to(torch.promote_types(v2.dtype, dtype))], -1)
        return torch.empty_like(v).scatter_(-1, pos, v)

    all_depths = merge(depths1, depths2)
    all_densities = merge(densities1, densities2)
    colors = torch.cat([c.to(torch.promote_types(c.dtype, dtype)) for c in (colors1, colors2)],
                       -2)
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
    return bind(cuda_build.library('ray_march'))


def bind(lib):
    """The entries of a built `csrc/ray_march.cu` (`lib`, a ctypes library)
    with their argument types, as the wrappers call them."""
    scalars = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fwd = lib.tdgp_ray_march_reduced
    fwd.argtypes = [ctypes.c_void_p] * 7 + scalars
    fwd.restype = ctypes.c_int
    bwd = lib.tdgp_ray_march_reduced_bwd
    bwd.argtypes = [ctypes.c_void_p] * 10 + scalars
    bwd.restype = ctypes.c_int
    bwd_bwd = lib.tdgp_ray_march_reduced_bwd_bwd
    bwd_bwd.argtypes = [ctypes.c_void_p] * 17 + scalars
    bwd_bwd.restype = ctypes.c_int
    merged = lib.tdgp_ray_march_merged
    merged.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    merged.restype = ctypes.c_int
    cut = lib.tdgp_ray_march_merged_cut
    cut.argtypes = [ctypes.c_void_p] * 11 + merged.argtypes[10:]
    cut.restype = ctypes.c_int
    merged_bf16 = lib.tdgp_ray_march_merged_bf16
    merged_bf16.argtypes = merged.argtypes[:-1] + [ctypes.c_int, ctypes.c_void_p]
    merged_bf16.restype = ctypes.c_int
    cut_bf16 = lib.tdgp_ray_march_merged_cut_bf16
    cut_bf16.argtypes = cut.argtypes[:-1] + [ctypes.c_int, ctypes.c_void_p]
    cut_bf16.restype = ctypes.c_int
    lib.tdgp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tdgp_cuda_error_string.restype = ctypes.c_char_p
    return types.SimpleNamespace(fwd=fwd, bwd=bwd, bwd_bwd=bwd_bwd, merged=merged, cut=cut,
                                 merged_bf16=merged_bf16, cut_bf16=cut_bf16,
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


MAX_STEPS_BWD_BWD = 128  # samples a ray that the second-order kernel takes (csrc/ray_march.cu)


def ray_march_reduced_bwd_bwd_plain(colors, densities, depths, g_rgb, g_depth, g_wsum,
                                    g_ftrans, u_colors, u_densities, u_depths,
                                    clamp_mode: str = 'softplus', sp_beta: float = 1.0,
                                    use_inf_depth: bool = True, last_back: bool = False):
    """The derivative of `ray_march_reduced_bwd_plain`: autograd through it,
    from the cotangents (u_colors, u_densities, u_depths; None for zero) of
    its three outputs -> those of its seven inputs (colors, densities,
    depths, g_rgb, g_depth, g_wsum, g_ftrans)."""
    inputs = [t.detach().requires_grad_(True)
              for t in (colors, densities, depths, g_rgb, g_depth, g_wsum, g_ftrans)]
    with torch.enable_grad():
        outs = ray_march_reduced_bwd_plain(*inputs, clamp_mode, sp_beta, use_inf_depth,
                                           last_back)
    pairs = [(o, u) for o, u in zip(outs, (u_colors, u_densities, u_depths)) if u is not None]
    if not pairs:
        return tuple(torch.zeros_like(t) for t in inputs)
    grads = torch.autograd.grad([o for o, _ in pairs], inputs, [u for _, u in pairs],
                                allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g for g, t in zip(grads, inputs))


def ray_march_reduced_bwd_bwd(colors, densities, depths, g_rgb, g_depth, g_wsum, g_ftrans,
                              u_colors, u_densities, u_depths, clamp_mode: str = 'softplus',
                              sp_beta: float = 1.0, use_inf_depth: bool = True,
                              last_back: bool = False):
    """The second-order kernel for CUDA tensors (counted in
    `ray_march_reduced_bwd_bwd.launches`), `ray_march_reduced_bwd_bwd_plain`
    for CPU tensors -> the cotangents of (colors, densities, depths, g_rgb,
    g_depth, g_wsum, g_ftrans). A cotangent u_* of None is zero."""
    _check(colors, densities, depths, clamp_mode)
    device = colors.device
    if device.type == 'cpu':
        return ray_march_reduced_bwd_bwd_plain(colors, densities, depths, g_rgb, g_depth, g_wsum,
                                               g_ftrans, u_colors, u_densities, u_depths,
                                               clamp_mode, sp_beta, use_inf_depth, last_back)
    if device.type != 'cuda':
        raise ValueError(f'ray_march_reduced_bwd_bwd runs on CUDA or CPU tensors, not {device}')
    b, r, s, c = colors.shape
    if s > MAX_STEPS_BWD_BWD:
        raise NotImplementedError(f'the second-order kernel takes up to {MAX_STEPS_BWD_BWD} '
                                  f'samples a ray, not {s}')
    grads = [g.to(torch.float32).contiguous() for g in (g_rgb, g_depth, g_wsum, g_ftrans)]
    us = [None if u is None else u.to(torch.float32).contiguous()
          for u in (u_colors, u_densities, u_depths)]
    outs = [torch.empty_like(t) for t in (colors, densities, depths, *grads)]
    for t in (colors, densities, depths, *grads, *[u for u in us if u is not None]):
        if not t.is_contiguous():
            raise ValueError('ray_march_reduced_bwd_bwd takes contiguous tensors')
    k = _kernels()
    with torch.cuda.device(device):
        err = k.bwd_bwd(*[t.data_ptr() for t in (colors, densities, depths, *grads)],
                        *[None if u is None else u.data_ptr() for u in us],
                        *[t.data_ptr() for t in outs], b * r, s, c, _CLAMP_MODES[clamp_mode],
                        float(sp_beta), _last_delta(use_inf_depth), int(last_back),
                        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'ray_march_reduced_bwd_bwd launch failed: '
                           f'{k.error_string(err).decode()}')
    ray_march_reduced_bwd_bwd.launches += 1
    return tuple(outs)


class RayMarchReducedBackward(torch.autograd.Function):
    """K3's backward as a recorded function of its seven inputs: the backward
    kernel (or with `plain` its plain version on any device) forward, the
    second-order kernel (or autograd through the plain version) backward."""

    @staticmethod
    def forward(ctx, colors, densities, depths, g_rgb, g_depth, g_wsum, g_ftrans, opts, plain):
        ctx.save_for_backward(colors, densities, depths, g_rgb, g_depth, g_wsum, g_ftrans)
        ctx.opts, ctx.plain = opts, plain
        ctx.set_materialize_grads(False)  # an unused output's cotangent stays None
        bwd = ray_march_reduced_bwd_plain if plain else ray_march_reduced_bwd
        return bwd(colors, densities, depths, g_rgb, g_depth, g_wsum, g_ftrans, *opts)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, u_colors, u_densities, u_depths):
        bwd_bwd = ray_march_reduced_bwd_bwd_plain if ctx.plain else ray_march_reduced_bwd_bwd
        return (*bwd_bwd(*ctx.saved_tensors, u_colors, u_densities, u_depths, *ctx.opts),
                None, None)


class RayMarchReduced(torch.autograd.Function):
    """K3 forward and backward, or with `plain` their plain versions on any
    device; the context keeps only the three inputs. The backward is
    `RayMarchReducedBackward`, which autograd records where a gradient of
    the gradient is asked for (`create_graph=True`)."""

    @staticmethod
    def forward(ctx, colors, densities, depths, clamp_mode, sp_beta, use_inf_depth, last_back,
                plain):
        ctx.save_for_backward(colors, densities, depths)
        ctx.opts = (clamp_mode, sp_beta, use_inf_depth, last_back)
        ctx.plain = plain
        fwd = ray_march_reduced_plain if plain else _forward
        return fwd(colors, densities, depths, clamp_mode, sp_beta, use_inf_depth, last_back)

    @staticmethod
    def backward(ctx, g_rgb, g_depth, g_wsum, g_ftrans):
        colors, densities, depths = ctx.saved_tensors
        grads = [torch.zeros_like(ref) if g is None else g
                 for g, ref in ((g_rgb, colors[..., 0, :]), (g_depth, depths[..., 0]),
                                (g_wsum, depths[..., 0]), (g_ftrans, depths[..., 0]))]
        return (*RayMarchReducedBackward.apply(colors, densities, depths, *grads, ctx.opts,
                                               ctx.plain),
                None, None, None, None, None)


def ray_march_reduced(colors: torch.Tensor, densities: torch.Tensor, depths: torch.Tensor,
                      clamp_mode: str = 'softplus', sp_beta: float = 1.0,
                      use_inf_depth: bool = True, last_back: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """colors [B,R,S,C], densities [B,R,S], depths [B,R,S], float32
    -> (rgb [B,R,C], depth [B,R], weights_sum [B,R], final_transmittance [B,R]).
    Differentiable in all three inputs, twice."""
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
    depths, values = (sets[0], sets[3]), (sets[1], sets[2], sets[4], sets[5])
    if any(t.dtype != torch.float32 for t in depths) or not (
            all(t.dtype == torch.float32 for t in values)
            or (sets[1].dtype == sets[4].dtype == torch.bfloat16
                and sets[2].dtype == sets[5].dtype
                and sets[2].dtype in (torch.bfloat16, torch.float32))):
        raise TypeError(f'ray_march_merged takes float32 depths with float32 colours and '
                        f'densities, or bf16 colours and bf16 or float32 densities; got '
                        f'{[t.dtype for t in sets]}')
    for t in sets:
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
    if colors1.dtype == torch.bfloat16:
        return ray_march_merged_bf16(*sets, clamp_mode, sp_beta, use_inf_depth, last_back)
    if depths1.device.type == 'cpu':
        return ray_march_merged_plain(*sets, clamp_mode, sp_beta, use_inf_depth, last_back)
    out = _launch_merged('ray_march_merged', sets, None, clamp_mode, sp_beta, use_inf_depth,
                         last_back)
    ray_march_merged.launches += 1
    return out


def _launch_merged(what, sets, threshold, clamp_mode, sp_beta, use_inf_depth, last_back):
    """One launch of the merged kernel's entry for `sets`' dtypes, with the
    cut where `threshold` is given -> (rgb, depth, weights_sum, final_transmittance)."""
    device = sets[0].device
    if device.type != 'cuda':
        raise ValueError(f'{what} runs on CUDA or CPU tensors, not {device}')
    if torch.is_grad_enabled() and any(t.requires_grad for t in sets):
        raise RuntimeError(f'{what} has no backward: where autograd records, merge with '
                           f'unify_samples_sorted and march with ray_march_reduced')
    b, r, s1 = sets[0].shape
    s2, c = sets[3].shape[2], sets[1].shape[3]
    rgb = torch.empty((b, r, c), dtype=torch.float32, device=device)
    depth, wsum, ftrans = (torch.empty((b, r), dtype=torch.float32, device=device)
                           for _ in range(3))
    k = _kernels()
    bf16 = sets[1].dtype == torch.bfloat16
    fn = {(False, False): k.merged, (False, True): k.cut, (True, False): k.merged_bf16,
          (True, True): k.cut_bf16}[bf16, threshold is not None]
    pointers = [t.data_ptr() for t in (*sets, *([] if threshold is None else [threshold]),
                                       rgb, depth, wsum, ftrans)]
    extra = [int(sets[2].dtype == torch.bfloat16)] if bf16 else []
    with torch.cuda.device(device):
        err = fn(*pointers, b * r, s1, s2, c, _CLAMP_MODES[clamp_mode], float(sp_beta),
                 _last_delta(use_inf_depth), int(last_back), *extra,
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'{what} launch failed: {k.error_string(err).decode()}')
    return rgb, depth, wsum, ftrans


def ray_march_merged_bf16(depths1: torch.Tensor, colors1: torch.Tensor, densities1: torch.Tensor,
                          depths2: torch.Tensor, colors2: torch.Tensor, densities2: torch.Tensor,
                          clamp_mode: str = 'softplus', sp_beta: float = 1.0,
                          use_inf_depth: bool = True, last_back: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3's merged entry with bf16 loads: `ray_march_merged` for bf16 colours
    and bf16 or float32 densities (float32 depths), each widened to float32
    as it is loaded; counted in `ray_march_merged_bf16.launches`;
    `ray_march_merged_plain` for CPU tensors."""
    sets = (depths1, colors1, densities1, depths2, colors2, densities2)
    _check_merged(sets, clamp_mode)
    if colors1.dtype != torch.bfloat16:
        raise TypeError(f'ray_march_merged_bf16 takes bf16 colours, got {colors1.dtype}')
    if depths1.device.type == 'cpu':
        return ray_march_merged_plain(*sets, clamp_mode, sp_beta, use_inf_depth, last_back)
    out = _launch_merged('ray_march_merged_bf16', sets, None, clamp_mode, sp_beta,
                         use_inf_depth, last_back)
    ray_march_merged_bf16.launches += 1
    return out


def cut_threshold_keys(densities1: torch.Tensor, densities2: torch.Tensor,
                       clamp_mode: str = 'softplus', sp_beta: float = 1.0) -> torch.Tensor:
    """The keys of the clamped densities that the select's first pass writes
    on the card (int64, both sets in order; `key_values` turns them back
    into the clamped values): the clamp inside the kernel, to be held
    against `clamp_densities`."""
    return _select((densities1, densities2), 0.5, clamp_mode, sp_beta, torch.float32,
                   keys_out=True)[1]


def cut_threshold_plain(densities1: torch.Tensor, densities2: torch.Tensor,
                        cut_quantile: float, clamp_mode: str = 'softplus',
                        sp_beta: float = 1.0) -> torch.Tensor:
    """`cut_threshold` by a sort: both sets clamped (bf16 widened first),
    concatenated and taken by `quantile_plain`."""
    return quantile_plain(torch.cat([clamp_densities(widen(x), clamp_mode, sp_beta).reshape(-1)
                                     for x in (densities1, densities2)]), cut_quantile)


def cut_threshold(densities1: torch.Tensor, densities2: torch.Tensor, cut_quantile: float,
                  clamp_mode: str = 'softplus', sp_beta: float = 1.0) -> torch.Tensor:
    """The `cut_quantile`-quantile of the clamped densities of both sample
    sets together (one-element float32 tensor on their device): the
    threshold of the merged march, which a quantile takes in any order. On
    CUDA tensors one select (`csrc/quantile.cu`) reads the raw densities
    (float32 or bf16) and clamps them as the march does, without a
    concatenation or a clamped copy; `cut_threshold_plain` on CPU tensors."""
    if densities1.device.type == 'cpu':
        return cut_threshold_plain(densities1, densities2, cut_quantile, clamp_mode, sp_beta)
    return _select((densities1, densities2), cut_quantile, clamp_mode, sp_beta, torch.float32)


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
    if colors1.dtype == torch.bfloat16:
        return ray_march_merged_cut_bf16(*sets, cut_quantile, clamp_mode, sp_beta,
                                         use_inf_depth, last_back)
    return _merged_cut(ray_march_merged_cut, sets, cut_quantile, clamp_mode, sp_beta,
                       use_inf_depth, last_back)


def _merged_cut(counter, sets, cut_quantile, clamp_mode, sp_beta, use_inf_depth, last_back):
    what = counter.__name__
    if not 0.0 < cut_quantile <= 1.0:
        raise ValueError(f'cut_quantile must be in (0, 1], got {cut_quantile}')
    if sets[0].device.type == 'cpu':
        return ray_march_merged_cut_plain(*sets, cut_quantile, clamp_mode, sp_beta,
                                          use_inf_depth, last_back)
    threshold = cut_threshold(sets[2], sets[5], cut_quantile, clamp_mode, sp_beta)
    out = _launch_merged(what, sets, threshold, clamp_mode, sp_beta, use_inf_depth, last_back)
    counter.launches += 1
    return out


def ray_march_merged_cut_bf16(depths1: torch.Tensor, colors1: torch.Tensor,
                              densities1: torch.Tensor, depths2: torch.Tensor,
                              colors2: torch.Tensor, densities2: torch.Tensor,
                              cut_quantile: float, clamp_mode: str = 'softplus',
                              sp_beta: float = 1.0, use_inf_depth: bool = True,
                              last_back: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3's cut entry with bf16 loads (`ray_march_merged_cut` for bf16
    colours and bf16 or float32 densities): the threshold over the widened
    clamped densities, then one launch, counted in
    `ray_march_merged_cut_bf16.launches`; `ray_march_merged_cut_plain` for
    CPU tensors."""
    sets = (depths1, colors1, densities1, depths2, colors2, densities2)
    _check_merged(sets, clamp_mode)
    if colors1.dtype != torch.bfloat16:
        raise TypeError(f'ray_march_merged_cut_bf16 takes bf16 colours, got {colors1.dtype}')
    return _merged_cut(ray_march_merged_cut_bf16, sets, cut_quantile, clamp_mode, sp_beta,
                       use_inf_depth, last_back)


ray_march_reduced.launches = 0
ray_march_reduced_bwd.launches = 0
ray_march_reduced_bwd_bwd.launches = 0
ray_march_merged.launches = 0
ray_march_merged_cut.launches = 0
ray_march_merged_bf16.launches = 0
ray_march_merged_cut_bf16.launches = 0
cut_threshold.launches = 0
