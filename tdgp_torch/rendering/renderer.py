"""Two-pass (coarse + importance) volume renderer
(port of `tdgp/rendering/renderer.py`).

At eval sampling draws nothing: the coarse samples sit mid-bin and the fine
samples come from the deterministic inverse CDF (`det=True`). In training
(`draws` given) the coarse samples are jittered within their bins, the fine
samples come from a stratified random u, and Gaussian noise of the given
std is added to the densities, all drawn from `draws`. The coarse pass
needs every per-sample weight for the importance sampler and marches in
plain PyTorch without gradients (the JAX package stops them there; with a
quantile cut its threshold comes from `quantile`, the select kernel on the
card, handed to the plain march); the
final pass needs only the per-ray sums and goes through kernel K3
(`tdgp_torch/ops/ray_march.py`, `march_merged`): where autograd does not
record, the merge of the coarse and fine samples and the march are one
launch of its merged entry; where it records (training), the samples are
merged by `unify_samples_sorted` and marched by K3's forward and backward.
A bf16 model (`generator.render_bf16`) gives bf16 colours and densities:
the eval coarse march clamps its densities in bf16, as the JAX package's
does; in training the densities turn float32 where the noise is added (an
array there, of zeros too); the merged entry loads bf16 as it is, and the
recorded merge returns float32, which the float32 K3 marches.
On CPU tensors the wrappers compute the plain versions. The mip marcher
(`ray_marcher_type='mip'`, MipNeRF's mid-point quadrature) is the JAX
package's jnp function in PyTorch, on any device: JAX marches it in jnp
whatever `march_impl` says, and K3 is classical only, as `ray_march_pallas`
is. Its coarse samples sit on the bin edges plus a jitter of one bin, its
importance sampler smooths the weights by a max and a mean pool, and the
final pass merges the two sets by `unify_samples_sorted`.

Shapes: colors [B, R, S, C]; densities and depths [B, R, S].
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from tdgp_torch.ops.ray_march import (classical_ray_march_plain, cut_below_quantile, quantile,
                                      ray_march_merged, ray_march_merged_cut, ray_march_reduced,
                                      unify_samples_sorted)
from tdgp_torch.utils.draws import Draws

MARCH_IMPLS = ('fused', 'jnp')


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    num_proposal_steps: int = 32
    num_fine_steps: int = 32
    ray_start: float = 0.75
    ray_end: float = 1.25
    clamp_mode: str = 'softplus'
    sp_beta: float = 1.0
    use_inf_depth: bool = True
    last_back: bool = False
    # eval-time cleanup (NFS's depth maps): the clamped densities below their
    # cut_quantile-quantile over the whole pass (every ray of the call, every
    # sample) set to 0 in both marches; 0 cuts nothing
    cut_quantile: float = 0.0
    ray_marcher_type: str = 'classical'  # 'classical' | 'mip'
    white_back: bool = False             # mip: the background white
    density_bias: float = 0.0            # mip: added to the densities before the softplus
    # 'fused': final march in kernel K3, its merged entry where autograd does
    # not record, forward and backward where it does (their plain versions
    # on CPU tensors); 'jnp', the JAX package's name for its plain path, is
    # the same on CPU tensors and refused on the card
    march_impl: str = 'fused'


def classical_ray_march(colors: torch.Tensor, densities: torch.Tensor, depths: torch.Tensor,
                        opts: RenderOptions):
    """-> (rgb [B,R,C], depth [B,R], weights [B,R,S], final_transmittance [B,R])."""
    return classical_ray_march_plain(colors, densities, depths, opts.clamp_mode,
                                     opts.sp_beta, opts.use_inf_depth, opts.last_back,
                                     opts.cut_quantile, quantile)


def mip_ray_march(colors: torch.Tensor, densities: torch.Tensor, depths: torch.Tensor,
                  opts: RenderOptions):
    """MipNeRF's marcher (`tdgp/rendering/renderer.py:108 mip_ray_march`):
    colours, densities and depths at the mid-points of consecutive samples
    (the last sample kept, at an infinite delta, with `use_inf_depth`), the
    softplus of the densities plus `density_bias`, the quantile cut, and the
    colour rescaled from the sigmoid's [0, 1] to [-1, 1].
    -> (rgb [B,R,C], depth [B,R], weights [B,R,S'], final_transmittance [B,R])."""
    if opts.clamp_mode != 'softplus':
        raise ValueError("the mip marcher takes clamp_mode='softplus' only")
    deltas = depths[..., 1:] - depths[..., :-1]
    colors_mid = 0.5 * (colors[..., :-1, :] + colors[..., 1:, :])
    densities_mid = 0.5 * (densities[..., :-1] + densities[..., 1:])
    depths_mid = 0.5 * (depths[..., :-1] + depths[..., 1:])
    if opts.use_inf_depth:
        deltas = torch.cat([deltas, torch.full_like(deltas[..., :1], 1e10)], -1)
        colors_mid = torch.cat([colors_mid, colors[..., -1:, :]], -2)
        densities_mid = torch.cat([densities_mid, densities[..., -1:]], -1)
        depths_mid = torch.cat([depths_mid, depths[..., -1:]], -1)
    densities_mid = cut_below_quantile(F.softplus(densities_mid + opts.density_bias),
                                       opts.cut_quantile, quantile)
    alpha = 1.0 - torch.exp(-densities_mid * deltas)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], -1),
                          dim=-1)
    weights = alpha * trans[..., :-1]
    rgb = (weights[..., None] * colors_mid).sum(-2)
    depth = (weights * depths_mid).sum(-1)
    if opts.white_back:
        rgb = rgb + (1.0 - weights.sum(-1, keepdim=True))
    return rgb * 2.0 - 1.0, depth, weights, trans[..., -1]


def march(colors: torch.Tensor, densities: torch.Tensor, depths: torch.Tensor,
          opts: RenderOptions):
    """Every per-sample weight: the coarse pass's march, of either marcher."""
    if opts.ray_marcher_type == 'mip':
        return mip_ray_march(colors, densities, depths, opts)
    return classical_ray_march(colors, densities, depths, opts)


def _check_march_impl(opts: RenderOptions, device: torch.device) -> None:
    if opts.march_impl not in MARCH_IMPLS:
        raise ValueError(f'march_impl must be one of {MARCH_IMPLS}, got {opts.march_impl!r}')
    if opts.march_impl == 'jnp' and device.type != 'cpu':
        raise NotImplementedError("march_impl 'jnp' (the plain marcher) runs on CPU tensors "
                                  "only; on the card the march runs in kernel K3 ('fused')")


def march_reduced(colors: torch.Tensor, densities: torch.Tensor, depths: torch.Tensor,
                  opts: RenderOptions):
    """Final-pass march -> (rgb, depth, weights_sum, final_transmittance)."""
    _check_march_impl(opts, colors.device)
    return ray_march_reduced(colors, densities, depths, opts.clamp_mode, opts.sp_beta,
                             opts.use_inf_depth, opts.last_back)


def march_merged(depths1, colors1, densities1, depths2, colors2, densities2,
                 opts: RenderOptions):
    """Final-pass march over the merge of two per-ray sorted sample sets
    -> (rgb, depth, weights_sum, final_transmittance).

    Where autograd records (training), `unify_samples_sorted` then
    `march_reduced`, whose backward needs the merged tensors; elsewhere one
    call of K3's merged entry, `ray_march_merged`, or with a quantile cut
    of its cut entry, `ray_march_merged_cut`. The mip marcher merges by
    `unify_samples_sorted` and marches by `mip_ray_march` in either case."""
    sets = (depths1, colors1, densities1, depths2, colors2, densities2)
    if opts.ray_marcher_type == 'mip':
        depths, colors, densities = unify_samples_sorted(*sets)
        rgb, depth, weights, ftrans = mip_ray_march(colors, densities, depths, opts)
        return rgb, depth, weights.sum(-1), ftrans
    if torch.is_grad_enabled() and any(t.requires_grad for t in sets):
        if opts.cut_quantile > 0.0:
            raise NotImplementedError('the quantile cut renders without gradients only')
        depths, colors, densities = unify_samples_sorted(*sets)
        return march_reduced(colors, densities, depths, opts)
    _check_march_impl(opts, depths1.device)
    sets = tuple(t.contiguous() for t in sets)
    if opts.cut_quantile > 0.0:
        return ray_march_merged_cut(*sets, opts.cut_quantile, opts.clamp_mode, opts.sp_beta,
                                    opts.use_inf_depth, opts.last_back)
    return ray_march_merged(*sets, opts.clamp_mode, opts.sp_beta, opts.use_inf_depth,
                            opts.last_back)


def sample_stratified(batch: int, num_rays: int, num_steps: int, device: torch.device,
                      ray_start: float = 0.0, ray_end: float = 1.0,
                      jitter: Optional[torch.Tensor] = None,
                      ray_marcher_type: str = 'classical') -> torch.Tensor:
    """Samples in [ray_start, ray_end], one per bin: at `jitter` [B, R, S]
    in [0, 1) of the way through each bin, or mid-bin when it is None. The
    classical marcher's bins run between the mid-points of S evenly spaced
    values, the mip marcher's from each of them one step on. -> [B, R, S]."""
    base = torch.linspace(ray_start, ray_end, num_steps, dtype=torch.float32, device=device)
    if ray_marcher_type == 'mip':
        delta = (ray_end - ray_start) / (num_steps - 1)
        if jitter is None:
            return (base + 0.5 * delta).expand(batch, num_rays, num_steps)
        return base + jitter * delta
    mids = 0.5 * (base[1:] + base[:-1])
    upper = torch.cat([mids, base[-1:]])
    lower = torch.cat([base[:1], mids])
    if jitter is None:
        return (lower + (upper - lower) * 0.5).expand(batch, num_rays, num_steps)
    return lower + (upper - lower) * jitter


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_importance: int,
               eps: float = 1e-5, u_rand: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-CDF sampling.

    bins [N, W] sorted bin edges, weights [N, W-1] -> [N, n_importance], sorted.
    With `u_rand` [N, n_importance] in [0, 1) the i-th u is (i + u_rand) / I,
    stratified as in the JAX package; without it u runs evenly over [0, 1]
    (`det=True`). The cdf is non-decreasing, so `searchsorted(right=True)`
    counts the cdf values <= u, as the JAX package's comparison count does.
    """
    n_rays, n_bins = bins.shape
    weights = weights + eps
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)], -1)  # [N, W]
    if u_rand is None:
        u = torch.linspace(0.0, 1.0, n_importance, dtype=cdf.dtype, device=cdf.device)
        u = u.expand(n_rays, n_importance).contiguous()
    else:
        base = torch.arange(n_importance, dtype=cdf.dtype, device=cdf.device) / n_importance
        u = (base + u_rand / n_importance).contiguous()
    inds = torch.searchsorted(cdf, u, right=True)
    below = (inds - 1).clamp(min=0)
    above = inds.clamp(max=n_bins - 1)
    cdf_lo, cdf_hi = cdf.gather(1, below), cdf.gather(1, above)
    bins_lo, bins_hi = bins.gather(1, below), bins.gather(1, above)
    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bins_lo + (u - cdf_lo) / denom * (bins_hi - bins_lo)


def sample_importance(z_vals: torch.Tensor, weights: torch.Tensor, n_importance: int,
                      u_rand: Optional[torch.Tensor] = None,
                      ray_marcher_type: str = 'classical') -> torch.Tensor:
    """z_vals [B,R,S], coarse weights [B,R,S] -> fine samples [B,R,n_importance].
    `u_rand` [B*R, n_importance]: see `sample_pdf`. The mip marcher's
    weights are smoothed first: a max pool of 2 (stride 1, padded by one on
    each side), a mean pool of 2, plus 0.01."""
    batch, num_rays, s = z_vals.shape
    z = z_vals.reshape(batch * num_rays, s)
    w = weights.reshape(batch * num_rays, -1)
    if ray_marcher_type == 'mip':
        pad = torch.full_like(w[:, :1], float('-inf'))
        wp = torch.cat([pad, w, pad], -1)
        wmax = torch.maximum(wp[:, :-1], wp[:, 1:])
        w = 0.5 * (wmax[:, :-1] + wmax[:, 1:]) + 0.01
    else:
        w = w + 1e-5
    z_mid = 0.5 * (z[:, :-1] + z[:, 1:])
    samples = sample_pdf(z_mid, w[:, 1:-1], n_importance, u_rand=u_rand)
    return samples.reshape(batch, num_rays, n_importance)


RunModelFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def importance_render(run_model: RunModelFn, ray_origins: torch.Tensor,
                      ray_directions: torch.Tensor, opts: RenderOptions,
                      draws: Optional[Draws] = None, density_noise: float = 0.0):
    """Coarse + importance rendering.

    run_model(coords [B, P, 3]) -> (rgb [B, P, C], sigma [B, P]).
    ray_origins/directions: [B, R, 3]. `draws` None renders at eval; given,
    it supplies 'jitter' [B,R,S], 'u' [B*R, S_fine] and, when
    `density_noise` is not 0, 'noise_coarse' / 'noise_fine' [B, R*S].
    Returns (rgb [B,R,C], depth [B,R], weights_sum [B,R], final_transmittance [B,R]).
    """
    batch, num_rays, _ = ray_origins.shape
    n_coarse, n_fine = opts.num_proposal_steps, opts.num_fine_steps

    def s_to_t(s):
        return s * opts.ray_end + (1.0 - s) * opts.ray_start

    def eval_model(tdist, noise_name):
        s = tdist.shape[-1]
        coords = ray_origins[:, :, None, :] + tdist[..., None] * ray_directions[:, :, None, :]
        rgb, sigma = run_model(coords.reshape(batch, num_rays * s, 3))
        if draws is not None:  # JAX adds its noise array, of 0 too: bf16 sigma turns float32
            sigma = sigma.to(torch.promote_types(sigma.dtype, tdist.dtype))
        if draws is not None and density_noise != 0.0:
            sigma = sigma + draws.normal(noise_name, sigma.shape) * density_noise
        return (rgb.reshape(batch, num_rays, s, rgb.shape[-1]),
                sigma.reshape(batch, num_rays, s))

    jitter = None if draws is None else draws.uniform('jitter', (batch, num_rays, n_coarse))
    sdist_coarse = sample_stratified(batch, num_rays, n_coarse, ray_origins.device,
                                     jitter=jitter, ray_marcher_type=opts.ray_marcher_type)
    tdist_coarse = s_to_t(sdist_coarse)
    colors_coarse, densities_coarse = eval_model(tdist_coarse, 'noise_coarse')
    with torch.no_grad():
        _, _, weights, _ = march(colors_coarse, densities_coarse, sdist_coarse, opts)
        u_rand = None if draws is None else draws.uniform('u', (batch * num_rays, n_fine))
        sdist_fine = sample_importance(sdist_coarse, weights, n_fine, u_rand=u_rand,
                                       ray_marcher_type=opts.ray_marcher_type)
    tdist_fine = s_to_t(sdist_fine)
    colors_fine, densities_fine = eval_model(tdist_fine, 'noise_fine')
    return march_merged(tdist_coarse, colors_coarse, densities_coarse, tdist_fine, colors_fine,
                        densities_fine, opts)
