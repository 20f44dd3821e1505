"""K3's second order in its kernel's order (`ray_march_reduced_bwd_bwd_lanes`
below: a ray's samples on the 32 lanes of a warp, K consecutive samples a
lane, serial sums in a lane, scans over the lanes; csrc/ray_march.cu)
against the plain version
(autograd through the closed-form backward) and against JAX's autodiff of
the JAX package's analytic VJP `_ray_march_bwd`
(tdgp/ops/pallas_kernels.py:251), on the same numpy inputs, float32, at
S = 1, 7, 64, 65 and 128 (the kernel's widths: 32 lanes of 1, 1, 2, 4 and
4 samples, the lanes past S empty; against JAX S = 2 in place of 1: neither
`_ray_march_bwd` nor JAX's jnp marcher traces a ray of one sample, whose
delta slices are empty), both clamps, `last_back` on and off, and each
cotangent u_* present or null. Each per-sample result within 1e-5 of its
largest magnitude; the four per-ray results within 1e-5 of their largest
together (g_wsum's cancels to its rounding where the last delta is 1e10
and no light passes the ray).
"""
import itertools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from tdgp.ops.pallas_kernels import _ray_march_bwd

from tdgp_torch.ops import ray_march

TOL = 1e-5
STEPS = (1, 7, 64, 65, 128)
CASES = [(s, clamp_mode, last_back) for s in STEPS for clamp_mode in ('softplus', 'relu')
         for last_back in (False, True)]
JAX_CASES = [(max(s, 2), clamp_mode, last_back) for s, clamp_mode, last_back in CASES]
PRESENT = list(itertools.product((True, False), repeat=3))  # u_colors, u_densities, u_depths
LANES = 32  # lanes a ray of the second-order kernel: a warp (csrc/ray_march.cu)


def bwd_bwd_widths(samples: int) -> tuple:
    """(L, K) of the second-order kernel for a ray of `samples` samples: L =
    LANES lanes of K consecutive samples, the least power of two K
    with L K >= samples."""
    k = 1
    while LANES * k < samples:
        k *= 2
    return LANES, k


def _lanes_scan(v: torch.Tensor, op) -> torch.Tensor:
    """Inclusive scan over dim 1 (a ray's lanes) as the kernel's shuffles
    take it: at each level lane l takes op(its value, lane l - off's)."""
    off = 1
    while off < v.shape[1]:
        v = torch.cat([v[:, :off], op(v[:, off:], v[:, :-off])], 1)
        off *= 2
    return v


def _lanes_suffix_sum(v: torch.Tensor) -> torch.Tensor:
    """Inclusive sum over dim 1 from the end, as the kernel's down shuffles."""
    off = 1
    while off < v.shape[1]:
        v = torch.cat([v[:, :-off] + v[:, off:], v[:, -off:]], 1)
        off *= 2
    return v


def _lanes_allsum(v: torch.Tensor) -> torch.Tensor:
    """The sum over dim 1 on every lane, by the kernel's xor butterfly."""
    idx = torch.arange(v.shape[1], device=v.device)
    off = v.shape[1] // 2
    while off:
        v = v + v[:, idx ^ off]
        off //= 2
    return v


def _lane_before(v: torch.Tensor, first: float) -> torch.Tensor:
    """Lane l - 1's value, `first` on the first lane."""
    return torch.cat([torch.full_like(v[:, :1], first), v[:, :-1]], 1)


def ray_march_reduced_bwd_bwd_lanes(colors, densities, depths, g_rgb, g_depth, g_wsum,
                                    g_ftrans, u_colors, u_densities, u_depths,
                                    clamp_mode: str = 'softplus', sp_beta: float = 1.0,
                                    use_inf_depth: bool = True, last_back: bool = False):
    """`ray_march_reduced_bwd_bwd_plain` in the second-order kernel's order
    (csrc/ray_march.cu): a ray's S <= 128 samples on L lanes of K
    consecutive samples (`bwd_bwd_widths`), the samples past S empty
    (factor 1, no weight); each lane's products and prefix and suffix sums
    over its K samples serially, relative to what lies in front of its
    first, then one scan over the lanes (`_lanes_scan`); the sweep's three
    parts as the kernel takes them. Same arguments and results."""
    b, r, s, c = colors.shape
    if s > ray_march.MAX_STEPS_BWD_BWD:
        raise NotImplementedError(f'the second-order kernel takes up to '
                                  f'{ray_march.MAX_STEPS_BWD_BWD} samples a ray, not {s}')
    lanes, per_lane = bwd_bwd_widths(s)
    n, last = b * r, s - 1
    pad = lanes * per_lane - s

    def keep(mask, v):  # v where mask, 0 elsewhere
        return torch.where(mask, v, torch.zeros_like(v))

    def laid(v):  # [n, s] or [n, s, c] -> K tensors [n, L] or [n, L, c]: sample l K + k
        v = F.pad(v, (0, 0, 0, pad) if v.ndim == 3 else (0, pad))
        v = v.reshape(n, lanes, per_lane, *v.shape[2:])
        return [v[:, :, k] for k in range(per_lane)]

    slot = torch.arange(lanes * per_lane, device=colors.device).reshape(lanes, per_lane)
    index = [slot[:, k] for k in range(per_lane)]  # sample l K + k of lane l, [L]
    valid = [i < s for i in index]
    t = depths.reshape(n, s)
    cols = colors.reshape(n, s, c)
    grgb = g_rgb.reshape(n, c)
    gdep, gws, gft = (v.reshape(n, 1) for v in (g_depth, g_wsum, g_ftrans))
    last_delta = ray_march._last_delta(use_inf_depth)
    dl = torch.cat([t[:, 1:] - t[:, :-1], torch.full_like(t[:, :1], last_delta)], 1)
    a = t * gdep + gws
    for ch in range(c):
        a = a + cols[..., ch] * grgb[:, ch:ch + 1]
    g = a
    if last_back:
        g = torch.cat([(a - a[:, -1:])[:, :-1], torch.zeros_like(a[:, :1])], 1)
    x = densities.reshape(n, s)
    if clamp_mode == 'softplus':
        sg_all, ds_all = F.softplus(sp_beta * x) / sp_beta, torch.sigmoid(sp_beta * x)
        d2_all = sp_beta * ds_all * (1.0 - ds_all)
    elif clamp_mode == 'relu':
        sg_all, ds_all = F.relu(x), (x > 0).to(x.dtype)
        d2_all = torch.zeros_like(x)
    else:
        raise NotImplementedError(f'Unknown clamp mode: {clamp_mode}')
    e_all = torch.exp(-dl * sg_all)
    zeros = torch.zeros_like(t)
    ux_all = zeros if u_densities is None else u_densities.reshape(n, s)
    ut_all = zeros if u_depths is None else u_depths.reshape(n, s)
    uc = None if u_colors is None else u_colors.reshape(n, s, c)
    bwc_all = ut_all * gdep  # the cotangent of the corrected weight
    if uc is not None:
        for ch in range(c):
            bwc_all = bwc_all + uc[..., ch] * grgb[:, ch:ch + 1]
    b_gd_all = torch.cat([ut_all[:, 1:] - ut_all[:, :-1], zeros[:, :1]], 1)
    sg, ds, d2, e, gk, dlk, ux, ut, bwc, b_gd, tk = (
        laid(v) for v in (sg_all, ds_all, d2_all, e_all, g, dl, ux_all, ut_all, bwc_all,
                          b_gd_all, t))
    colors_laid = laid(cols)
    uc_laid = None if uc is None else laid(uc)
    e = [torch.where(v, ek, torch.ones_like(ek)) for v, ek in zip(valid, e)]
    f = [(1.0 - (1.0 - ek)) + 1e-10 for ek in e]
    f = [torch.where(v, fk, torch.ones_like(fk)) for v, fk in zip(valid, f)]
    inv_f = [1.0 / fk for fk in f]  # the kernel multiplies by the factors' reciprocals

    # the backward's values, each lane's relative to its front, then the ray's
    prod = torch.ones(n, lanes, device=colors.device)
    w_lane = torch.zeros_like(prod)
    T, gw = [], []
    for k in range(per_lane):
        T.append(prod)
        w = (1.0 - e[k]) * prod
        w_lane = w_lane + w
        gw.append(keep(valid[k], gk[k] * w))
        prod = prod * f[k]
    rest = [None] * per_lane  # sum over the lane's samples after, then the ray's
    gw_after = torch.zeros_like(prod)
    for k in reversed(range(per_lane)):
        rest[k] = gw_after
        gw_after = gw_after + gw[k]
    incl = _lanes_scan(prod, torch.mul)
    front = _lane_before(incl, 1.0)
    t_s = incl[:, -1:]
    w_total = _lanes_allsum(front * w_lane)
    beyond = _lanes_suffix_sum(front * gw_after)  # a suffix sum: exactly 0 behind the last
    gw_lanes_after = torch.cat([beyond[:, 1:], torch.zeros_like(beyond[:, :1])], 1)
    T = [tk_ * front for tk_ in T]
    rest = [(gw_lanes_after + front * rk) + gft * t_s for rk in rest]

    # the reverse sweep, part 1
    bG = torch.zeros(n, lanes, c, device=colors.device)
    b_gdep, b_ts_lane, b_gft, q_lane = (torch.zeros_like(prod) for _ in range(4))
    q_ex, b_gf = [], []
    for k in range(per_lane):
        q_ex.append(q_lane)
        w = (1.0 - e[k]) * T[k]
        wc = torch.where((index[k] == last) & last_back, w + (1.0 - w_total), w)
        wc = keep(valid[k], wc)
        if uc_laid is not None:
            bG = bG + wc[..., None] * uc_laid[k]
        b_gdep = b_gdep + wc * ut[k]
        bgf = b_gd[k] * (-sg[k] * e[k]) + ux[k] * (-dlk[k] * e[k] * ds[k])
        bgf = keep(valid[k], bgf)
        b_gf.append(bgf)
        q = bgf * inv_f[k]
        b_gft = b_gft + q * t_s
        b_ts_lane = b_ts_lane + q * gft
        q_lane = q_lane + q
    q_before = _lane_before(_lanes_scan(q_lane, torch.add), 0.0)
    b_ts = _lanes_allsum(b_ts_lane)
    b_wsum_all = -bwc_all[:, last:] if last_back else torch.zeros_like(t_s)

    # part 2
    b_g, b_w = [], []
    bg_rest_lane = torch.zeros_like(prod)
    for k in range(per_lane):
        p = q_before + q_ex[k]
        bg = -b_gf[k] * T[k] + p * ((1.0 - e[k]) * T[k])
        bw = (bwc[k] + p * gk[k]) + b_wsum_all
        bg = keep(valid[k], bg)
        bw = keep(valid[k], bw)
        b_g.append(bg)
        b_w.append(bw)
        bg_rest_lane = bg_rest_lane + keep(index[k] < last, bg)
    btt_after = [None] * per_lane
    btt_lane = torch.zeros_like(prod)
    for k in reversed(range(per_lane)):
        btt_after[k] = btt_lane
        btt = (-b_gf[k] * gk[k] + b_w[k] * (1.0 - e[k])) * T[k]
        btt_lane = btt_lane + keep(valid[k], btt)
    after = _lanes_suffix_sum(btt_lane)
    btt_lanes_after = torch.cat([after[:, 1:], torch.zeros_like(after[:, :1])], 1)
    bg_rest = _lanes_allsum(bg_rest_lane)

    # part 3
    out_x, ba, bdl = [], [], []
    b_gws = torch.zeros_like(prod)
    for k in range(per_lane):
        bak = (torch.where(index[k] < last, b_g[k], -bg_rest) if last_back else b_g[k])
        bak = keep(valid[k], bak)
        bG = bG + bak[..., None] * colors_laid[k]
        b_gdep = b_gdep + bak * tk[k]
        b_gws = b_gws + bak
        gf = -gk[k] * T[k] + rest[k] * inv_f[k]
        q = b_gf[k] * inv_f[k]
        b_f = -q * rest[k] * inv_f[k]
        bf = b_f + ((btt_lanes_after + btt_after[k]) + b_ts * t_s) * inv_f[k]
        balpha = b_w[k] * T[k] - bf
        be = (b_gd[k] * gf * (-sg[k]) + ux[k] * gf * (-dlk[k] * ds[k])) - balpha
        bsg = b_gd[k] * gf * (-e[k]) + be * (-dlk[k] * e[k])
        ox = bsg * ds[k] + ux[k] * gf * (-dlk[k] * e[k]) * d2[k]
        bd = ux[k] * gf * (-e[k] * ds[k]) + be * (-sg[k] * e[k])
        bd = keep(index[k] < last, bd)
        out_x.append(ox)
        ba.append(bak)
        bdl.append(bd)
    left = _lane_before(bdl[-1], 0.0)
    out_t = []
    for k in range(per_lane):
        out_t.append(ba[k] * gdep - bdl[k] + left)
        left = bdl[k]

    def unlaid(vs):  # K tensors [n, L] -> [b, r, s]
        return torch.stack(vs, -1).reshape(n, lanes * per_lane)[:, :s].reshape(b, r, s)

    b_colors = unlaid(ba)[..., None] * g_rgb.reshape(b, r, 1, c)
    totals = [_lanes_allsum(v)[:, 0] for v in (b_gdep, b_gws, b_gft)]
    b_rgb = _lanes_allsum(bG)[:, 0]
    return (b_colors, unlaid(out_x), unlaid(out_t), b_rgb.reshape(b, r, c),
            *(v.reshape(b, r) for v in totals))


def _inputs(s, seed):
    """Colours, densities, depths, the four cotangents and the three u_*
    (numpy, float32) for 2 x 3 rays of s samples."""
    rs = np.random.RandomState(seed)
    b, r, c = 2, 3, 3
    colors = rs.rand(b, r, s, c).astype(np.float32)
    densities = (rs.randn(b, r, s) * 2).astype(np.float32)
    depths = np.sort(rs.uniform(0.8, 1.2, (b, r, s)), -1).astype(np.float32)
    cots = [rs.randn(b, r, c).astype(np.float32)] + [rs.randn(b, r).astype(np.float32)
                                                     for _ in range(3)]
    us = [rs.randn(*v.shape).astype(np.float32) for v in (colors, densities, depths)]
    return (colors, densities, depths), cots, us


def _close(got, want, what):
    got = [np.asarray(v, np.float64) for v in got]
    want = [np.asarray(v, np.float64) for v in want]
    totals = max(float(np.abs(v).max()) for v in want[3:])
    for i, (a, b) in enumerate(zip(got, want)):
        scale = float(np.abs(b).max()) if i < 3 else totals
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL * max(scale, 1e-30),
                                   err_msg=f'{what}: output {i}')


def _torch(v):
    return None if v is None else torch.from_numpy(v)


@pytest.mark.parametrize('s,clamp_mode,last_back', CASES)
def test_lanes_sweep_matches_plain(s, clamp_mode, last_back):
    """Against `ray_march_reduced_bwd_bwd_plain`, every u_* present or null
    (eight combinations), use_inf_depth on for odd S and off for even."""
    ins, cots, us = _inputs(s, seed=s)
    args = [torch.from_numpy(v) for v in (*ins, *cots)]
    opts = (clamp_mode, 1.0, s % 2 == 1, last_back)
    for present in PRESENT:
        u = [_torch(v) if p else None for v, p in zip(us, present)]
        got = ray_march_reduced_bwd_bwd_lanes(*args, *u, *opts)
        want = ray_march.ray_march_reduced_bwd_bwd_plain(*args, *u, *opts)
        assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
        _close([g.numpy() for g in got], [w.numpy() for w in want], f'u present {present}')


@pytest.mark.parametrize('s,clamp_mode,last_back', JAX_CASES)
def test_lanes_sweep_matches_jax(s, clamp_mode, last_back):
    """Against `jax.vjp` of `_ray_march_bwd` in its seven inputs, with the
    u_* as its output cotangents (a null one as zeros): all three present,
    and each null alone; use_inf_depth off for odd S and on for even."""
    ins, cots, us = _inputs(s, seed=100 + s)
    inf_depth = s % 2 == 0

    def bwd(colors, densities, depths, *gs):
        return _ray_march_bwd(clamp_mode, 1.0, inf_depth, last_back, (colors, densities, depths),
                              gs)

    _, vjp = jax.vjp(bwd, *[jnp.asarray(v) for v in (*ins, *cots)])
    args = [torch.from_numpy(v) for v in (*ins, *cots)]
    for present in PRESENT[:4] + [PRESENT[-1]]:
        u = [v if p else np.zeros_like(v) for v, p in zip(us, present)]
        want = [np.asarray(w) for w in vjp(tuple(jnp.asarray(v) for v in u))]
        got = ray_march_reduced_bwd_bwd_lanes(
            *args, *[_torch(v) if p else None for v, p in zip(us, present)], clamp_mode, 1.0,
            inf_depth, last_back)
        _close([g.numpy() for g in got], want, f'u present {present}')



@pytest.mark.parametrize('s', (7, 64, 65, 128))
@pytest.mark.parametrize('last_back', (False, True))
def test_lanes_sweep_at_a_last_sample_near_opaque(s, last_back):
    """The infinite last delta (1e10) with the last sample's density swept
    over [-26, -14] across 256 rays (softplus): its factor f = e + 1e-10 runs
    from 1e-10 to ~1, and the sweep divides the sum behind it, exactly 0,
    by f. Taken as the ray's total less a prefix, that sum kept its
    rounding, and the densities' output missed by 0.93 of its largest.
    Against the plain version in float64 (in float32 it misses by up to
    1.4e-5 of the largest itself), every u_* present."""
    rs = np.random.RandomState(300 + s)
    b, r, c = 1, 256, 3
    colors = rs.rand(b, r, s, c).astype(np.float32)
    densities = (rs.randn(b, r, s) * 2).astype(np.float32)
    densities[..., -1] = np.linspace(-26, -14, r, dtype=np.float32)
    depths = np.sort(rs.uniform(0.8, 1.2, (b, r, s)), -1).astype(np.float32)
    cots = [rs.randn(b, r, c).astype(np.float32)] + [rs.randn(b, r).astype(np.float32)
                                                     for _ in range(3)]
    us = [rs.randn(*v.shape).astype(np.float32) for v in (colors, densities, depths)]
    args = [torch.from_numpy(v) for v in (colors, densities, depths, *cots, *us)]
    opts = ('softplus', 1.0, True, last_back)
    got = ray_march_reduced_bwd_bwd_lanes(*args, *opts)
    want = ray_march.ray_march_reduced_bwd_bwd_plain(*[v.double() for v in args], *opts)
    _close([g.numpy() for g in got], [w.numpy() for w in want], 'a last sample near opaque')

def test_widths_of_the_kernel():
    """The kernel's lanes and samples a lane: 32 lanes of the least power of
    two that covers S, up to 128; S > 128 refused."""
    assert [bwd_bwd_widths(s) for s in (1, 7, 32, 33, 64, 65, 128)] == [
        (32, 1), (32, 1), (32, 1), (32, 2), (32, 2), (32, 4), (32, 4)]
    ins, cots, us = _inputs(129, seed=0)
    with pytest.raises(NotImplementedError, match='128'):
        ray_march_reduced_bwd_bwd_lanes(
            *[torch.from_numpy(v) for v in (*ins, *cots, *us)])
