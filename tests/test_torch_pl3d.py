"""Path-length regularization (PL) of the 3DGP model: the second order of
the sampler's and the marcher's backward, and the R1 + PL step.

- The plain versions' second order: `torch.autograd.gradgradcheck` in
  float64 of K3's march (`RayMarchReduced`, softplus and relu, `last_back`
  on and off) and of the tri-plane sampler (`TriplaneSample`, with a point
  outside the plane; a point exactly on a texel edge, where the
  coordinates' first derivative jumps, with the planes and the cotangent
  as the differentiated inputs).
- The same second order against JAX: `jax.grad` of a scalar of `jax.vjp` of
  the JAX package's jnp gather (`tdgp.models.epigraf.tri_plane_sample`,
  impl 'jnp', with points on texel edges: both take the side of `floor`)
  and of its jnp marcher (`classical_ray_march`, the weights summed), on
  the same numpy inputs, at 1e-4 of each result's largest magnitude.
- JAX's R1 + PL step (`make_train_step(controlled=True)`, `loss.pl_weight`
  2, `tiny_test_config` with D at float32, batch 4, so PL at 2) against the
  port's, every draw replayed (PL's 'pl/patch', 'pl/noise/...',
  'pl/render/...' and 'pl/pl_noise' from one key, as JAX draws them): the
  losses (`Loss/pl_penalty`, `Loss/G/reg` among them), each phase's
  gradients with PL's own (JAX's read where its step hands it to G's Adam,
  a `jax.debug.callback` in a wrapped `make_optimizers`, as
  tests/test_torch_train_step_2d.py reads it), `pl_mean`, and G, D and the
  G EMA after the step, at the limits of tests/test_torch_train_step.py.
  tests/test_torch_pl3d_mixed.py holds a second step the same way, with
  Dmain's fresh fakes, the mip marcher and a 3-layer MLP.
- The one combination still refused: PL through `training.gmain_render_bf16`.

About 100 s alone with the tier-1 command's flags (ROADMAP; one compiled JAX step; its
lowering and compile take ~70 s).
"""
import dataclasses
from unittest import mock

import numpy as np
import optax
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from tdgp.models.epigraf import tri_plane_sample as jax_tri_plane_sample
from tdgp.models.stylegan2 import sg2_block_resolutions
from tdgp.rendering import renderer as jax_renderer
from tdgp.training import train_step as jts
from tdgp.training.patch import sample_patch_params as jax_patch_params

from tdgp_torch.config import apply_overrides, tiny_test_config
from tdgp_torch.ops import ray_march, splat
from tdgp_torch.training.train_step import Trainer
from tdgp_torch.utils.draws import Replay
from tdgp_torch.weights import _to_port_layout, flat_key, flatten_tree

from test_torch_train_step import (CUR_NIMG, N, T, check_part, flax_key, fp32_d, port_trainer,
                                   setup_step, step_draws)

PL = ('loss.pl_weight=2.0',)
TOL = 1e-4


@pytest.fixture(scope='module', autouse=True)
def _one_thread_per_worker():
    """One torch and one BLAS thread while this module runs: the test workers
    share the cores, and OpenBLAS's threads spin while the others hold them."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api='blas'):
        yield
    torch.set_num_threads(saved)


def close(got, want, err_msg=''):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=TOL,
                               atol=TOL * max(float(np.abs(want).max()), 1e-30), err_msg=err_msg)


# ------------------------------------------------ the plain versions' second order

@pytest.mark.parametrize('clamp_mode', ['softplus', 'relu'])
@pytest.mark.parametrize('last_back', [False, True])
def test_march_second_order_gradgradcheck(clamp_mode, last_back):
    """K3's plain forward and backward twice differentiated, float64,
    against finite differences (relu's densities kept off its kink)."""
    rs = np.random.RandomState(3)
    x = rs.randn(1, 2, 6)
    x = np.where(np.abs(x) < 0.1, 0.5, x)
    depths = np.sort(rs.uniform(0.8, 1.2, (1, 2, 6)), -1)
    inputs = [torch.tensor(v, dtype=torch.float64, requires_grad=True)
              for v in (rs.rand(1, 2, 6, 3), x, depths)]

    def march(colors, densities, depths):
        return ray_march.RayMarchReduced.apply(colors, densities, depths, clamp_mode, 1.0,
                                               False, last_back, True)

    assert torch.autograd.gradgradcheck(march, inputs)


def _sample_inputs(points, seed=4, h=5, w=6, f=3):
    rs = np.random.RandomState(seed)
    planes = torch.tensor(rs.randn(3, h, w, f), dtype=torch.float64, requires_grad=True)
    coords = torch.tensor(np.asarray(points, np.float64)[None], requires_grad=True)
    return planes, coords


def _sample(planes, coords):
    return splat.TriplaneSample.apply(planes, coords, 1.0, True)


def test_gather_second_order_gradgradcheck():
    """The sampler's forward and backward twice differentiated, float64: a
    point inside, one outside the plane (x > 1) and one whose x/y corners
    are partly outside."""
    planes, coords = _sample_inputs([[0.13, -0.41, 0.27], [1.3, 0.23, -0.3],
                                     [-0.97, 0.93, 0.11]])
    assert torch.autograd.gradgradcheck(_sample, (planes, coords))


def test_gather_second_order_on_a_texel_edge_gradgradcheck():
    """A point whose x and y fall exactly on texel edges (x = -0.6 is pixel
    1.0 of 6 columns, y = 0.5 pixel 3.0 of 5 rows): the planes and the
    cotangent differentiated twice, the coordinates held (their first
    derivative jumps at the edge; the edge against JAX is below)."""
    planes, coords = _sample_inputs([[-0.6, 0.5, 0.0]])
    coords = coords.detach()
    g = torch.randn(1, 1, 3, dtype=torch.float64, requires_grad=True)

    def backward(planes, g):
        return splat.triplane_sample_bwd_plain(planes, coords, g, 1.0)

    assert torch.autograd.gradgradcheck(backward, (planes, g))


# ------------------------------------------------ the second order against JAX

def test_gather_second_order_matches_jax():
    """d/d(planes, coords, g) of <vjp(g)_planes, U_p> + <vjp(g)_coords, U_c>
    for the jnp gather and the port's `triplane_sample`, float32, with points
    on texel edges (pixel 2.0 and 4.0 of 8) and outside the planes."""
    rs = np.random.RandomState(5)
    n, p, h, w, f = 2, 40, 8, 8, 4
    planes = rs.randn(3 * n, h, w, f).astype(np.float32)
    coords = rs.uniform(-1.2, 1.2, (n, p, 3)).astype(np.float32)
    coords[0, :3] = [[2 / 7 * 2 - 1, 4 / 7 * 2 - 1, 0.1], [-1.0, 1.0, -1.0], [0.3, 1.25, 0.0]]
    g = rs.randn(n, p, f).astype(np.float32)
    u_p, u_c = rs.randn(*planes.shape).astype(np.float32), rs.randn(n, p, 3).astype(np.float32)

    def jax_scalar(planes, coords, g):
        _, vjp = jax.vjp(lambda a, b: jax_tri_plane_sample(a, b, 1.0, impl='jnp'), planes, coords)
        gp, gc = vjp(g)
        return jnp.sum(gp * u_p) + jnp.sum(gc * u_c)

    want = jax.jit(jax.grad(jax_scalar, argnums=(0, 1, 2)))(planes, coords, g)
    tp, tc, tg = (torch.tensor(v, requires_grad=True) for v in (planes, coords, g))
    feats = splat.triplane_sample(tp, tc, 1.0)
    gp, gc = torch.autograd.grad(feats, (tp, tc), tg, create_graph=True)
    got = torch.autograd.grad((gp * T(u_p)).sum() + (gc * T(u_c)).sum(), (tp, tc, tg))
    for name, a, b in zip(('planes', 'coords', 'g'), got, want):
        close(a.numpy(), b, name)


@pytest.mark.parametrize('clamp_mode,last_back,use_inf_depth', [
    ('softplus', False, True), ('softplus', True, False), ('relu', True, True)])
def test_march_second_order_matches_jax(clamp_mode, last_back, use_inf_depth):
    """d/d(colors, densities, depths, cotangents) of a scalar of the VJP of
    JAX's jnp marcher (weights summed) and of the port's
    `ray_march_reduced`, float32. The four per-ray cotangents' results, sums
    over the ray, share one scale, their largest: g_wsum's cancels to ~1e-7
    where the last delta is 1e10 (no light passes the ray), and would
    otherwise be held to its own rounding."""
    rs = np.random.RandomState(6)
    b, r, s, c = 2, 5, 12, 3
    colors = rs.rand(b, r, s, c).astype(np.float32)
    densities = (rs.randn(b, r, s) * 2).astype(np.float32)
    depths = np.sort(rs.uniform(0.8, 1.2, (b, r, s)), -1).astype(np.float32)
    cots = [rs.randn(b, r, c).astype(np.float32)] + [rs.randn(b, r).astype(np.float32)
                                                     for _ in range(3)]
    us = [rs.randn(*v.shape).astype(np.float32) for v in (colors, densities, depths)]
    opts = jax_renderer.RenderOptions(clamp_mode=clamp_mode, last_back=last_back,
                                      use_inf_depth=use_inf_depth)

    def jax_march(colors, densities, depths):
        rgb, depth, weights, ftrans = jax_renderer.classical_ray_march(colors, densities,
                                                                       depths, opts)
        return rgb, depth, weights.sum(-1), ftrans

    def jax_scalar(colors, densities, depths, *cots):
        _, vjp = jax.vjp(jax_march, colors, densities, depths)
        return sum(jnp.sum(a * u) for a, u in zip(vjp(tuple(cots)), us))

    want = jax.jit(jax.grad(jax_scalar, argnums=tuple(range(7))))(colors, densities, depths,
                                                                  *cots)
    ins = [torch.tensor(v, requires_grad=True) for v in (colors, densities, depths, *cots)]
    outs = ray_march.ray_march_reduced(*ins[:3], clamp_mode, 1.0, use_inf_depth, last_back)
    firsts = torch.autograd.grad(outs, ins[:3], ins[3:], create_graph=True)
    got = torch.autograd.grad(sum((a * T(u)).sum() for a, u in zip(firsts, us)), ins)
    for i in range(3):
        close(got[i].numpy(), want[i], f'input {i}')
    totals = max(float(np.abs(np.asarray(v)).max()) for v in want[3:])
    for i in range(3, 7):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=TOL,
                                   atol=TOL * totals, err_msg=f'input {i}')


# ------------------------------------------------------------- the R1 + PL step

def pl_draws(jcfg, rng, jsched):
    """PL's draws of the JAX step from `rng`, under the port's names: the
    patch, the decoder noise and the render's draws all from k_pl_fwd (JAX
    hands that one key to 'noise', 'render', 'depth' and 'dropout', and to
    the patch), the penalty's noise from k_pl_noise."""
    gc = jcfg.generator
    n = max(N // max(jcfg.loss.pl_batch_shrink, 1), 1)
    k_fwd, k_noise = jax.random.split(jax.random.split(rng, 8)[7])
    pp = jax_patch_params(k_fwd, n, gc.patch, min_scale=jsched.patch_min_scale,
                          beta=jsched.patch_beta)
    values = {'pl/patch': {k: T(v) for k, v in pp.items()}}
    for res in sg2_block_resolutions(0, gc.tri_plane.res):
        for name in (['conv1'] if res == 4 else ['conv0', 'conv1']):
            k = flax_key(k_fwd, 'synthesis', 'tri_plane_decoder', f'b{res}', name)
            values[f'pl/noise/b{res}/{name}'] = T(jax.random.normal(k, (n, res, res, 1)))
    k_strat, k_n1, k_imp, k_n2 = jax.random.split(flax_key(k_fwd, 'synthesis'), 4)
    rays, s = gc.patch.resolution ** 2, gc.num_ray_steps
    values.update({
        'pl/render/jitter': T(jax.random.uniform(k_strat, (n, rays, s))),
        'pl/render/noise_coarse': T(jax.random.normal(k_n1, (n, rays * s))),
        'pl/render/u': T(jax.random.uniform(k_imp, (n * rays, s))),
        'pl/render/noise_fine': T(jax.random.normal(k_n2, (n, rays * s))),
        'pl/pl_noise': T(jax.random.normal(k_noise, (n, gc.patch.resolution,
                                                     gc.patch.resolution, 3)))})
    return values


def recording_optimizers(record):
    """`jts.make_optimizers` whose G transform hands each gradient it
    updates with (Gmain's, then PL's) to `record`."""
    real = jts.make_optimizers

    def make(cfg):
        g_tx, d_tx = real(cfg)

        def update(grads, state, params=None):
            jax.debug.callback(record, grads, ordered=True)
            return g_tx.update(grads, state, params)

        return optax.GradientTransformation(g_tx.init, update), d_tx

    return make


@dataclasses.dataclass
class PLStep:
    stats: dict
    after: object
    port: dict
    trainer: object
    draws: object


def run_pl(overrides):
    """Both packages' R1 + PL step with `overrides` -> PLStep; JAX's PL
    gradient in stats['_debug']['pl_grads']."""
    s = setup_step(CUR_NIMG, overrides=overrides)
    seen = []

    def step(st, b, r, sc):
        with mock.patch.object(jts, 'make_optimizers', recording_optimizers(seen.append)):
            return jts.make_train_step(s.jcfg, s.G, s.D, controlled=True)(st, b, r, sc,
                                                                           do_r1=True)

    after, stats = jax.device_get(jax.jit(step)(s.state, s.jb, s.rng, s.jsched))
    jax.effects_barrier()
    assert len(seen) == 2  # Gmain's update, then PL's
    stats['_debug']['pl_grads'] = jax.device_get(seen[1])
    trainer = port_trainer(s.cfg, s.state)
    draws = Replay({**step_draws(s.jcfg, s.rng, s.jsched), **pl_draws(s.jcfg, s.rng, s.jsched)})
    port = trainer.step(s.pb, s.sched, True, draws, return_grads=True)
    return PLStep(stats, after, port, trainer, draws)


@pytest.fixture(scope='module')
def pl_step():
    return run_pl(PL)


def check_pl_part(step, part):
    """'pl' (PL's own gradient), 'pl_mean', or a part of `check_part`."""
    steps = (step.stats, step.after, step.port, step.trainer, step.draws)
    if part == 'pl':
        flat = flatten_tree({'params': step.stats['_debug']['pl_grads']})
        scale = max(float(np.abs(v).max()) for v in flat.values())
        port = step.port['_grads']['pl']
        assert len(port) == len(flat)
        for name, g in port.items():
            ref = _to_port_layout(name, flat[flat_key(name)], g.ndim)
            np.testing.assert_allclose(g.numpy(), ref, rtol=TOL, atol=TOL * scale, err_msg=name)
    elif part == 'pl_mean':
        assert float(step.after.pl_mean) > 0.0
        np.testing.assert_allclose(float(step.trainer.pl_mean), float(step.after.pl_mean),
                                   rtol=TOL, atol=TOL)
    else:
        check_part(steps, part)


PL_PARTS = ['draws', 'losses', 'g', 'pl', 'd', 'r1', 'pl_mean', 'G', 'D', 'G_ema']


@pytest.mark.parametrize('part', PL_PARTS)
def test_r1_and_pl_step(pl_step, part):
    """Every draw replayed, the losses (the penalty and `Loss/G/reg` among
    them), the gradients of Gmain, PL, Dmain and R1, `pl_mean`, and the
    modules after the step, at 1e-4."""
    assert {'Loss/pl_penalty', 'Loss/G/reg'} <= set(pl_step.port)
    check_pl_part(pl_step, part)


def test_pl_through_the_bf16_render_view_is_refused():
    """JAX's PL renders through G_main, the `gmain_render_bf16` view: its
    second order would run through K1's bf16 pair, which has no
    second-order entry."""
    cfg = apply_overrides(fp32_d(tiny_test_config()),
                          PL + ('training.gmain_render_bf16=true',))
    with pytest.raises(NotImplementedError, match='loss.pl_weight with '
                                                  'training.gmain_render_bf16'):
        Trainer(cfg, 'cpu')
