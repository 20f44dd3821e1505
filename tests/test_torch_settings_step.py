"""The training settings in one G+D step with R1: the port's `Trainer.step`
against the JAX package's `make_train_step(controlled=True)` on
`tiny_test_config` (D at float32), from the same weights, batch and draws
(tests/test_torch_train_step.py's machinery), in two compiled JAX steps,
A here and B in tests/test_torch_settings_step_fresh.py:

  A. `loss.r1_remat`, G's gradient clip at a norm that clips Gmain's
     update, D's `camera_cond`, the Fourier camera encoding
     (`generator.camera_cond_raw=false`), `discrete_uniform` patches
     (support 0.125-1 with 0.125 below the annealed min scale of 0.25) and
     `hybrid` origin angles with the force-mean regularizer off (its mean
     helper has no value for 'hybrid' in the JAX package);
  B. the mip marcher, a 3-layer tri-plane MLP, `architecture: orig`, G's
     clip at a norm above the gradient's (no clip) and Dmain on fresh
     fakes (their render without gradients: the mip march and the 3-layer
     MLP as layers).

With HYBRID in step B as well (`run(STEP_B + HYBRID)`), the fresh fakes
agree to ~1e-5 and D's Dmain gradient of b32.conv0.bias misses its limit
by ~2x, while each pair of B's settings with it holds at ~0.01 of the
limits. In float64 that combined step agrees on every part to ~1e-14
(tests/test_torch_settings_step_f64.py): the float32 miss is rounding
that the step amplifies, not a difference of the two functions.

Held at the step test's limits: every draw replayed, the losses rtol = atol
= 1e-4, each phase's gradients and the modules after the step rtol = 1e-4
and atol = 1e-4 x the largest of the phase or module, and G's Adam moments
(which the clip scales) at the same limits.
"""
import dataclasses

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from tdgp.config import asdict
from tdgp.config import tiny_test_config as jax_tiny
from tdgp.infra.experiment import apply_overrides as jax_apply_overrides
from tdgp.rendering.camera import sample_camera_params as jax_sample_camera
from tdgp.training import train_step as jts
from tdgp.training.schedules import compute_schedules as jax_schedules

from tdgp_torch.config import apply_overrides, tiny_test_config
from tdgp_torch.training.schedules import compute_schedules
from tdgp_torch.utils.draws import Replay
from tdgp_torch.weights import _to_port_layout, flat_key, flatten_tree

from test_torch_train_step import (CUR_NIMG, N, PARTS, Setup, check_part, fp32_d, make_inputs,
                                   port_trainer, step_draws)

CLIP = 0.05  # below Gmain's gradient norm at this step (~0.4): the update is clipped
HYBRID = ('camera.origin.angles.dist=hybrid', 'camera.origin.angles.yaw.mean=0.2',
          'camera.origin.angles.yaw.std=0.3', 'camera.origin.angles.pitch.mean=1.5',
          'camera.origin.angles.pitch.std=0.2', 'generator.camera_adaptor.force_mean_weight=0.0')
STEP_A = ('loss.r1_remat=true', f'training.g_optim.grad_clip={CLIP}',
          'discriminator.camera_cond=true', 'generator.camera_cond_raw=false',
          'generator.patch.distribution=discrete_uniform',
          'generator.patch.discrete_support=[0.125,0.25,0.5,0.75,1.0]',
          'generator.patch.anneal_kimg=100') + HYBRID


@pytest.fixture(scope='module', autouse=True)
def _one_thread_per_worker():
    """One torch and one BLAS thread while this module runs: the test workers
    share the cores, and OpenBLAS's threads spin while the others hold them."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api='blas'):
        yield
    torch.set_num_threads(saved)


def jax_state(cfg):
    """A TrainState as `create_train_state` builds it (D initialised with
    camera angles, which a camera-conditioned D needs), the inits jitted."""
    G, D = jts.build_models(cfg)
    gc = cfg.generator
    z, c = jnp.zeros((N, gc.z_dim)), jnp.zeros((N, gc.c_dim))
    cam = jax_sample_camera(jax.random.PRNGKey(0), asdict(cfg.camera), N)

    def init_fwd(g):
        ws = g.mapping(z, c, camera_angles=cam.angles, train=True)
        return g.synthesis(ws, g.synthesis.apply_camera_adaptor(cam, z, c), train=True,
                           concat_depth=True)

    g_vars = jax.jit(lambda r: G.init(r, method=init_fwd))(jts.init_rngs(0))
    res = cfg.discriminator.input_resolution
    d_vars = jax.jit(lambda k: D.init(
        {'params': k}, jnp.zeros((N, res, res, 4)), c,
        patch_params={'scales': jnp.ones((N, 2)), 'offsets': jnp.zeros((N, 2))},
        camera_angles=cam.angles, predict_feat=True, train=True))(jax.random.PRNGKey(1))
    g_tx, d_tx = jts.make_optimizers(cfg)
    state = jts.TrainState(
        step=jnp.zeros((), jnp.int32), g_params=g_vars['params'], g_consts=g_vars['consts'],
        g_ema_coll=g_vars['ema'], d_params=d_vars['params'],
        ema_params=jax.tree.map(jnp.copy, g_vars['params']),
        ema_ema_coll=jax.tree.map(jnp.copy, g_vars['ema']), g_opt=g_tx.init(g_vars['params']),
        d_opt=d_tx.init(d_vars['params']), pl_mean=jnp.zeros(()))
    return state, G, D


def run(overrides, dtype=np.float32):
    """Both packages' step with `overrides` -> (JAX stats, JAX state after,
    port stats, port trainer, the draws). With dtype float64 the weights and
    the batch are float64; the caller has turned on float64 in both
    frameworks."""
    jcfg = jax_apply_overrides(fp32_d(jax_tiny()), overrides)
    cfg = apply_overrides(fp32_d(tiny_test_config()), overrides)
    state, G, D = jax_state(jcfg)
    state = jax.tree.map(lambda a: a.astype(dtype) if a.dtype == np.float32 else a, state)
    jsched, sched = jax_schedules(jcfg, CUR_NIMG), compute_schedules(cfg, CUR_NIMG)
    jb, pb = make_inputs(jcfg, jsched, 0, dtype)
    s = Setup(jcfg, cfg, state, G, D, jsched, sched, jb, pb, jax.random.PRNGKey(7), dtype)
    step = jax.jit(lambda st, b, r, sc: jts.make_train_step(jcfg, G, D, controlled=True)(
        st, b, r, sc, do_r1=True))
    after, stats = jax.device_get(step(s.state, s.jb, s.rng, s.jsched))
    values = step_draws(jcfg, s.rng, jsched)
    if jcfg.generator.camera_adaptor.force_mean_weight == 0:
        del values['reg/force_mean/batch']  # the regularizer is off: no draw
    draws = Replay(values)
    trainer = port_trainer(cfg, state, dtype)
    port = trainer.step(pb, sched, True, draws, return_grads=True)
    return stats, after, port, trainer, draws


@pytest.fixture(scope='module')
def step_a():
    return run(STEP_A)


def adam_state(opt_state):
    """The ScaleByAdamState inside G's (chained) optax state."""
    for leaf in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, 'mu')):
        if hasattr(leaf, 'mu'):
            return leaf
    raise ValueError('no Adam state')


def check_g_adam(steps):
    _, after, _, trainer, _ = steps
    adam = adam_state(after.g_opt)
    for moment, key in ((adam.mu, 'exp_avg'), (adam.nu, 'exp_avg_sq')):
        flat = flatten_tree({'params': moment})
        scale = max(float(np.abs(v).max()) for v in flat.values())
        for name, p in trainer.G.named_parameters():
            ref = _to_port_layout(name, flat[flat_key(name)], p.ndim)
            np.testing.assert_allclose(trainer.g_opt.state[p][key].numpy(), ref, rtol=1e-4,
                                       atol=1e-4 * scale, err_msg=f'{key} {name}')


@pytest.mark.parametrize('part', PARTS + ['g_adam'])
def test_step_a_remat_clip_camera_cond_fourier_discrete_hybrid(step_a, part):
    if part == 'g_adam':
        check_g_adam(step_a)
    else:
        check_part(step_a, part)


def test_the_clip_acts_in_step_a(step_a):
    """Step A's Gmain update is clipped (factor < 1: the Adam moments above
    hold the clipped gradient); the gradients the step returns are before
    the clip, as JAX's `_debug` ones are."""
    (factor_a,) = step_a[2]['_g_clip']
    assert float(factor_a) < 1.0
    norm = float(torch.sqrt(sum(g.square().sum() for g in step_a[2]['_grads']['g'].values())))
    np.testing.assert_allclose(float(factor_a), CLIP / norm, rtol=1e-5)


def test_the_settings_reach_step_a(step_a):
    """Step A's patches take support values of at least the min scale
    (0.125 masked), D conditions on the angles (its head mapping's embed
    takes the 2 angles), its cameras are hybrid draws."""
    _, _, _, trainer_a, draws_a = step_a
    scales = np.concatenate([np.asarray(v['scales']).ravel() for k, v in draws_a.values.items()
                             if k.endswith('/patch')])
    assert set(np.round(scales, 6)) <= {0.25, 0.5, 0.75, 1.0}
    cfg = trainer_a.cfg
    assert trainer_a.D.head_mapping.embed.weight.shape[1] == \
        trainer_a.D.scalar_enc.out_dim + cfg.discriminator.c_dim + 2
    assert cfg.camera.origin.angles.dist == 'hybrid'
