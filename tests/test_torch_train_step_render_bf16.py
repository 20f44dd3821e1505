"""One training step with the bf16 render views: the port's `Trainer.step`
vs the JAX package's `make_train_step(controlled=True)`, on
`tiny_test_config` with fresh Dmain fakes (`training.dmain_reuse_fakes=
false`), `training.dmain_fake_bf16` and `training.gmain_render_bf16` on
(`VIEWS`), every draw of the JAX step replayed (`test_torch_train_step`'s
`setup_step` and `run_setup`). One compiled JAX step holds both views; the
floor is a second, the same step without them (JAX's float32 render).

Gmain's render runs through the `render_bf16` view (the decoder at the
config's float32), so its gradient flows back through the bf16 MLP layers,
K1's bf16 entry (its plain version here) and the cast of the planes;
Dmain's fresh fakes are rendered through the view with every decoder block
from 8x8 up in bf16 as well, without gradients (K4's and K3's bf16 entries'
plain versions). JAX's CPU step takes the plane gradient by its jnp route,
whose scatter-add sums in bf16: 0.71 of the bf16 floor from the TPU route's
float32 sum on the gather alone (`test_torch_render_bf16.test_jnp_route_gap`),
while the port sums in float32 as the TPU route does. A JAX step on the TPU
route (`plane_sample_impl='fused_interpret'`) does not build at this size
(the Pallas splat wants planes 128 texels wide; the tiny config's are 32),
so the port is held against the CPU step, and that gap is part of what the
limits take: Gmain's decoder parameters, whose gradients pass the plane
gradient, read a median of 0.15 of their floors, their largest ratios
(0.44-0.66) being biases and noise strengths, which JAX also sums in bf16.

Limits, each a share of the floor (the relative L2 distance between JAX's
step with the views and without them), measured first:
  - each phase's gradients concatenated: <= WHOLE_OF_FLOOR (Gmain 0.36,
    Dmain 0.53); the median over its parameters: <= MEDIAN_OF_FLOOR (0.15,
    0.50); each parameter <= MAX_OF_FLOOR (the largest: Gmain's MLP biases,
    1.08-1.28, whose gradients JAX sums in bf16; Dmain 1.02). Mutation
    witness: the port's step without the views (0.998 and 0.9987 for both
    phases).
  - the losses: the largest |port - JAX| within LOSS_OF_FLOOR x the largest
    |JAX with the views - JAX without| (0.015 measured).
  - Dmain's fresh fakes: the view's fake image against JAX's view on the
    same draws, <= FAKE_OF_FLOOR x the floor (JAX's view against JAX's G;
    0.43 measured). Mutation witness: the view's decoder blocks left at the
    config's float32 (0.94; `num_fp16_res=4` already reaches 8x8 at the tiny
    config's 32^2 planes, so that witness would be the view itself).
  - Gmain's gradient with `dmain_fake_bf16` alone is the step's without it
    bit for bit, as the JAX package asserts (tests/test_train_step.py:396).
"""
import dataclasses

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax

from tdgp.training.losses import g_forward as jax_g_forward

from tdgp_torch import config as port_config
from tdgp_torch.training import losses
from tdgp_torch.utils.draws import Replay
from tdgp_torch.weights import _to_port_layout, flat_key, flatten_tree

from test_torch_train_step import (CUR_NIMG, N, port_step, port_trainer, render_draws,
                                   run_setup, setup_step)

FRESH = ('training.dmain_reuse_fakes=false',)
FAKE_BF16 = ('training.dmain_fake_bf16=true',)
VIEWS = FRESH + FAKE_BF16 + ('training.gmain_render_bf16=true',)
WHOLE_OF_FLOOR = 0.6   # a phase's gradients concatenated (Gmain 0.36, Dmain 0.53)
MEDIAN_OF_FLOOR = 0.7  # the median of its parameters' ratios (0.15, 0.50)
MAX_OF_FLOOR = 1.5     # the largest (1.28: the MLP's fc1 bias, 1.02: D's b64.conv0 bias)
LOSS_OF_FLOOR = 0.6    # the losses (0.015)
FAKE_OF_FLOOR = 0.6    # the fresh fake image (0.43; the float32-block view 0.94)


@pytest.fixture(scope='module', autouse=True)
def _one_thread_per_worker():
    """One torch and one BLAS thread while this module runs: the test workers
    share the cores, and OpenBLAS's threads spin while the others hold them."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api='blas'):
        yield
    torch.set_num_threads(saved)


@pytest.fixture(scope='module')
def views_setup():
    return setup_step(CUR_NIMG, overrides=VIEWS)


@pytest.fixture(scope='module')
def views_steps(views_setup):
    """(JAX stats, JAX state, port stats, port trainer, draws) with the views."""
    return run_setup(views_setup)


@pytest.fixture(scope='module')
def floor_steps():
    """The same step without the views, in both packages."""
    return run_setup(setup_step(CUR_NIMG, overrides=FRESH))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def of_floor(views_steps, floor_steps, phase, port_grads):
    """(the phase's gradients concatenated, the median and the largest over
    its parameters):
    the relative L2 distance of `port_grads` to JAX's step with the views
    over that of JAX's step without them. Parameters the views leave alone
    (D's KD head, which the fakes do not reach) have no floor and sit out
    the median."""
    ref = flatten_tree({'params': views_steps[0]['_debug'][f'{phase}_grads']})
    ref32 = flatten_tree({'params': floor_steps[0]['_debug'][f'{phase}_grads']})
    got, want, want32, ratios = [], [], [], []
    for name, g in port_grads.items():
        r = _to_port_layout(name, ref[flat_key(name)], g.ndim)
        r32 = _to_port_layout(name, ref32[flat_key(name)], g.ndim)
        got.append(g.numpy().ravel()), want.append(r.ravel()), want32.append(r32.ravel())
        if _rel(r, r32) > 0:
            ratios.append(_rel(g.numpy(), r) / _rel(r, r32))
    whole = _rel(np.concatenate(got), np.concatenate(want)) / _rel(np.concatenate(want),
                                                                     np.concatenate(want32))
    return whole, float(np.median(ratios)), max(ratios)


def test_views_step_replays_every_draw_and_keeps_float32_state(views_steps):
    _, _, port, trainer, draws = views_steps
    assert draws.used == set(draws.values)
    assert trainer.G_main.synthesis.cfg.render_bf16 and trainer.G_fake.synthesis.cfg.render_bf16
    assert not trainer.G.synthesis.cfg.render_bf16
    assert all(p.dtype == torch.float32 and bool(torch.isfinite(p).all())
               for m in (trainer.G, trainer.D, trainer.G_ema) for p in m.parameters())
    assert all(g.dtype == torch.float32 for grads in port['_grads'].values()
               for g in grads.values())


def test_views_step_losses(views_steps, floor_steps):
    ref, ref32, port = views_steps[0], floor_steps[0], views_steps[2]
    names = [k for k in ref if not k.startswith('_')]
    floor = max(abs(float(ref[k]) - float(ref32[k])) for k in names)
    worst = max(abs(float(port[k]) - float(ref[k])) for k in names)
    assert worst <= LOSS_OF_FLOOR * floor, (worst, floor)


@pytest.mark.parametrize('phase', ['g', 'd'])
def test_views_step_gradients(views_steps, floor_steps, phase):
    """Gmain through the render_bf16 view, Dmain on the all-bf16 view's
    fresh fakes."""
    whole, median, largest = of_floor(views_steps, floor_steps, phase,
                                      views_steps[2]['_grads'][phase])
    assert whole <= WHOLE_OF_FLOOR and median <= MEDIAN_OF_FLOOR, (whole, median)
    assert largest <= MAX_OF_FLOOR, largest


@pytest.mark.parametrize('phase', ['g', 'd'])
def test_step_without_the_views_misses_the_limit(views_steps, floor_steps, phase):
    """Mutation witness: the port's step without the views (the float32
    render) against JAX's with them."""
    whole, median, _ = of_floor(views_steps, floor_steps, phase, floor_steps[2]['_grads'][phase])
    assert whole > WHOLE_OF_FLOOR and median > MEDIAN_OF_FLOOR, (whole, median)


def test_gmain_is_unchanged_by_dmain_fake_bf16(floor_steps):
    """`dmain_fake_bf16` changes Dmain's render only: Gmain's gradient is the
    step's without it bit for bit, and Dmain's is not."""
    port, _, _ = port_step(setup_step(CUR_NIMG, overrides=FRESH + FAKE_BF16))
    without = floor_steps[2]['_grads']
    assert all(torch.equal(g, without['g'][n]) for n, g in port['_grads']['g'].items())
    assert not all(torch.equal(g, without['d'][n]) for n, g in port['_grads']['d'].items())


def test_views_share_the_generator_parameters(views_steps):
    trainer = views_steps[3]
    for view in (trainer.G_main, trainer.G_fake):
        assert view is not trainer.G
        assert all(a is b for a, b in zip(view.parameters(), trainer.G.parameters()))
        assert all(a is b for a, b in zip(view.buffers(), trainer.G.buffers()))
    dec, fake_dec = trainer.G.synthesis.tri_plane_decoder, trainer.G_fake.synthesis.tri_plane_decoder
    assert [getattr(fake_dec, f'b{r}').dtype for r in fake_dec.resolutions] == [
        None, torch.bfloat16, torch.bfloat16, torch.bfloat16]
    assert all(getattr(dec, f'b{r}').dtype is None for r in dec.resolutions)
    w = trainer.G.synthesis.tri_plane_mlp.fc0.weight
    with torch.no_grad():
        w.add_(1.0)
        assert torch.equal(trainer.G_fake.synthesis.tri_plane_mlp.fc0.weight, w)
        w.sub_(1.0)
    assert set(trainer.G.state_dict()) == set(trainer.G_main.state_dict())


# ------------------------------------------------------------------ the fresh fake image

def _jax_fake(setup, view, key):
    """JAX's training render of Dmain's inputs through G (`view` False) or
    its all-bf16 render view, at the step's starting weights."""
    gc = setup.jcfg.generator
    G = setup.G
    if view:
        G = type(setup.G)(dataclasses.replace(gc, render_bf16=True, fp32_only=False,
                                              num_fp16_res=16))
    s = setup.state
    g_vars = {'params': s.g_params, 'consts': s.g_consts, 'ema': s.g_ema_coll}
    jb = setup.jb
    fwd = jax.jit(lambda v: jax_g_forward(G, v, jb['gen_z_d'], jb['gen_c_d'], jb['gen_cam_d'],
                                          jb['gen_cam_d'].angles, setup.jsched, key,
                                          setup.jcfg)[0].img)
    return np.asarray(fwd(g_vars))


def _port_fake(setup, trainer, key, all_blocks=True):
    cfg = setup.cfg
    view = trainer.G.view(port_config.render_bf16_view(cfg.generator, all_blocks=all_blocks))
    draws = Replay(render_draws(setup.jcfg, key, N, setup.jsched, 'fake')).scope('fake')
    pb = setup.pb
    with torch.no_grad():
        out, _ = losses.g_forward(view, pb['gen_z_d'], pb['gen_c_d'], pb['gen_cam_d'],
                                  pb['gen_cam_d'].angles, setup.sched, cfg, draws)
    return out.img.numpy()


@pytest.fixture(scope='module')
def fakes(views_setup):
    key = jax.random.PRNGKey(21)
    trainer = port_trainer(views_setup.cfg, views_setup.state)
    return (_jax_fake(views_setup, True, key), _jax_fake(views_setup, False, key),
            trainer, key)


def test_fresh_fake_image_through_the_view(views_setup, fakes):
    ref, ref32, trainer, key = fakes
    ratio = _rel(_port_fake(views_setup, trainer, key), ref) / _rel(ref, ref32)
    assert ratio <= FAKE_OF_FLOOR, ratio


def test_fresh_fake_view_with_float32_blocks_misses(views_setup, fakes):
    """Mutation witness: the view with `render_bf16` but its decoder blocks
    left at the config's float32."""
    ref, ref32, trainer, key = fakes
    ratio = _rel(_port_fake(views_setup, trainer, key, all_blocks=False), ref) / _rel(ref, ref32)
    assert ratio > FAKE_OF_FLOOR, ratio
