"""The ADA pipe and its resampling ops: the port (`tdgp_torch.training.augment`,
`tdgp_torch.ops.upfirdn2d.downsample2d`, `tdgp_torch.ops.grid_sample.grid_sample_nhwc`)
against the JAX package on the same inputs, on the CPU.

The pipe's draws are the JAX pipe's own: `jax_pipe_draws` walks its 40 keys in
the order the JAX pipe takes them and hands each value to the port under the
port's name, through `Replay`. Every group alone at p = 1, all groups at
p = 1 and at p = 0.5, the identity at p = 0, and the depth channel untouched
by the colour groups. For each: the output, the gradient in the images (a
VJP) and an R1-style gradient of a gradient (a parameter's gradient of
||d D(aug(x)) / dx||^2 for a small nonlinear D), at rtol = atol = 1e-4
(the gradients' atol x their largest magnitude).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tdgp.config import AugmentCfg as JaxAugmentCfg
from tdgp.ops.grid_sample import grid_sample_nhwc as jax_grid_sample
from tdgp.ops.upfirdn2d import downsample2d as jax_downsample2d
from tdgp.ops.upfirdn2d import setup_filter as jax_setup_filter
from tdgp.training.augment import SYM6, AugmentPipe as JaxPipe

from tdgp_torch.config import AugmentCfg
from tdgp_torch.ops.grid_sample import grid_sample_nhwc
from tdgp_torch.ops.upfirdn2d import downsample2d, setup_filter
from tdgp_torch.training.augment import AugmentPipe
from tdgp_torch.utils.draws import Replay

from _jax_draws import jax_pipe_draws

SHAPE = (4, 32, 32, 4)  # the image filter reflects 21 pixels, fewer than the side
GEOMETRIC = ('xflip', 'rotate90', 'xint', 'scale', 'rotate', 'aniso', 'xfrac')
COLOR = ('brightness', 'contrast', 'lumaflip', 'hue', 'saturation')
GROUPS = GEOMETRIC + COLOR + ('imgfilter', 'noise', 'cutout')


def T(x):
    return torch.from_numpy(np.array(x))


def only(*groups, **kwargs):
    """An AugmentCfg with every group's weight 0 but those of `groups` (1)."""
    weights = {g: (1.0 if g in groups else 0.0) for g in GROUPS}
    return dict(mode='ada', **weights, **kwargs)


def inputs(seed=0, shape=SHAPE):
    rs = np.random.RandomState(seed)
    return (rs.uniform(-1, 1, shape).astype(np.float32),
            rs.randn(*shape).astype(np.float32),
            rs.uniform(0.5, 1.5, shape[-1]).astype(np.float32))


def jax_results(cfg_kwargs, p, x, cot, a, rng):
    pipe = JaxPipe(JaxAugmentCfg(**cfg_kwargs))

    def aug(img):
        return pipe(img, jnp.float32(p), rng)

    def d_logits(img, a):
        return jnp.sum(jnp.tanh(aug(img) * a))

    def r1(a):
        g = jax.grad(d_logits)(jnp.asarray(x), a)
        return jnp.sum(g ** 2)

    out, vjp = jax.vjp(aug, jnp.asarray(x))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(cot))[0]), np.asarray(jax.grad(r1)(
        jnp.asarray(a)))


def port_results(cfg_kwargs, p, x, cot, a, draws):
    pipe = AugmentPipe(AugmentCfg(**cfg_kwargs))
    img = T(x).requires_grad_(True)
    out = pipe(img, p, draws)
    (g_img,) = torch.autograd.grad(out, img, T(cot))
    a_t = T(a).requires_grad_(True)
    img = T(x).requires_grad_(True)
    logits = torch.tanh(pipe(img, p, draws) * a_t).sum()
    (g,) = torch.autograd.grad(logits, img, create_graph=True)
    (g_a,) = torch.autograd.grad(g.square().sum(), a_t)
    return out.detach().numpy(), g_img.numpy(), g_a.numpy()


def assert_close(got, ref, what):
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * max(scale, 1.0), err_msg=what)


CASES = [(f'{g} alone', only(g), 1.0) for g in GROUPS] + [
    ('all', only(*GROUPS), 1.0), ('all at p=0.5', only(*GROUPS), 0.5)]


@pytest.mark.parametrize('label,cfg_kwargs,p', CASES, ids=[c[0] for c in CASES])
def test_pipe_against_jax(label, cfg_kwargs, p):
    x, cot, a = inputs()
    rng = jax.random.PRNGKey(3)
    draws = Replay(jax_pipe_draws(JaxAugmentCfg(**cfg_kwargs), rng, SHAPE))
    ref = jax_results(cfg_kwargs, p, x, cot, a, rng)
    got = port_results(cfg_kwargs, p, x, cot, a, draws)
    assert draws.used == set(draws.values)
    for what, r, g in zip(('output', 'VJP', 'grad of grad'), ref, got):
        assert_close(g, r, f'{label}: {what}')


def test_identity_at_p_zero():
    """At p = 0 every coin fails and the pipe returns its input (to float32
    rounding of the resampling: the identity transform resamples once)."""
    x, _, _ = inputs()
    cfg_kwargs = only(*[g for g in GROUPS if g not in ('noise', 'cutout')])
    draws = Replay(jax_pipe_draws(JaxAugmentCfg(**cfg_kwargs), jax.random.PRNGKey(5), SHAPE))
    out = AugmentPipe(AugmentCfg(**cfg_kwargs))(T(x), 0.0, draws)
    np.testing.assert_allclose(out.numpy(), x, rtol=1e-4, atol=1e-4)


def test_color_leaves_depth_untouched():
    """The colour groups and their matrix touch channels 0-2 only: channel 3
    comes out as it does from the pipe without them (the geometric step,
    identity here, runs in both)."""
    x, _, _ = inputs()
    cfg_kwargs = only(*COLOR)
    draws = Replay(jax_pipe_draws(JaxAugmentCfg(**cfg_kwargs), jax.random.PRNGKey(1), SHAPE))
    out = AugmentPipe(AugmentCfg(**cfg_kwargs))(T(x), 1.0, draws)
    bare = AugmentPipe(AugmentCfg(**only()))(T(x), 1.0, Replay({}))
    assert torch.equal(out[..., 3], bare[..., 3])
    assert not torch.allclose(out[..., :3], bare[..., :3], atol=1e-2)


@pytest.mark.parametrize('padding,flip', [(0, False), (-6, True), ((1, 2, -1, 3), False)])
def test_downsample2d_against_jax(padding, flip):
    x = np.random.RandomState(0).randn(2, 20, 18, 3).astype(np.float32)
    ref = jax_downsample2d(jnp.asarray(x), jax_setup_filter(SYM6), down=2, padding=padding,
                           flip_filter=flip)
    got = downsample2d(T(x), setup_filter(SYM6), down=2, padding=padding, flip_filter=flip)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('align_corners', [False, True])
def test_grid_sample_nhwc_against_jax(align_corners):
    """Output, VJP in x and in the grid, and a gradient of a gradient in x
    (points outside the image included)."""
    rs = np.random.RandomState(1)
    x = rs.randn(2, 7, 9, 3).astype(np.float32)
    grid = rs.uniform(-1.2, 1.2, (2, 5, 6, 2)).astype(np.float32)
    cot = rs.randn(2, 5, 6, 3).astype(np.float32)
    a = rs.uniform(0.5, 1.5, 3).astype(np.float32)

    def jfn(xx, gg):
        return jax_grid_sample(xx, gg, align_corners=align_corners)

    ref, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(grid))
    ref_gx, ref_gg = vjp(jnp.asarray(cot))
    ref_gga = jax.grad(lambda aa: jnp.sum(jax.grad(
        lambda xx: jnp.sum(jnp.tanh(jfn(xx, jnp.asarray(grid)) * aa)))(jnp.asarray(x)) ** 2))(
        jnp.asarray(a))

    xt, gt = T(x).requires_grad_(True), T(grid).requires_grad_(True)
    out = grid_sample_nhwc(xt, gt, align_corners=align_corners)
    gx, gg = torch.autograd.grad(out, (xt, gt), T(cot))
    at, xt = T(a).requires_grad_(True), T(x).requires_grad_(True)
    (g,) = torch.autograd.grad(torch.tanh(grid_sample_nhwc(xt, T(grid), align_corners) * at).sum(),
                               xt, create_graph=True)
    (gga,) = torch.autograd.grad(g.square().sum(), at)
    for got, r in ((out, ref), (gx, ref_gx), (gg, ref_gg), (gga, ref_gga)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)
