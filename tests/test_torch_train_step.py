"""One G+D training step: the port's `Trainer.step` vs the JAX package's
`make_train_step` in its controlled-inputs mode (train_step.py:226-232), on
`tiny_test_config` with the discriminator at float32 (the port trains at
float32 only), batch 4, R1 on.

Both start from the same weights: the JAX `TrainState` is carried into the
port by `tdgp_torch.weights.load_train_state`; both optimizers start at zero.
z, labels, cameras and the real patches' parameters come in the batch, as
the controlled mode takes them. Every other draw of the JAX step is
recomputed here from the step's key, through flax's key derivation for the
draws modules make with `make_rng` (StyleGAN2 noise, the render's jitter,
importance u and density noise, the depth adaptor's pick), and replayed into
the port. Nothing is pinned.

The schedules are those at 300 kimg (blur faded out, nerf noise on). With
the D-input blur of the first 200 kimg the step is too sensitive to float32
rounding for 1e-4: D's bias gradients differ by up to 2e-3 between the two
frameworks at float32 and by 1e-15 when both run in float64 (ROADMAP §3).
That blur-on step is held in float64 by tests/test_torch_train_step_f64.py,
through `run_step` here; the blur itself is held to 1e-4 in
tests/test_torch_train_modules.py.

Losses: rtol = atol = 1e-4. Gradients: rtol = 1e-4 and atol = 1e-4 x the
largest gradient of the phase. Parameters after the step: rtol = 1e-4 and
atol = 1e-4 x the largest parameter (Adam moves a parameter whose gradient
is near its eps by a step that rounding can change).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core.scope import LazyRng

from tdgp.config import asdict, tiny_test_config as jax_tiny
from tdgp.models.stylegan2 import sg2_block_resolutions
from tdgp.rendering.camera import sample_camera_params as jax_sample_camera
from tdgp.training import train_step as jts
from tdgp.training.patch import sample_patch_params as jax_patch_params
from tdgp.training.patch import sample_random_c as jax_random_c
from tdgp.training.schedules import compute_schedules as jax_schedules

from tdgp_torch.config import tiny_test_config
from tdgp_torch.training.schedules import compute_schedules
from tdgp_torch.training.train_step import Trainer
from tdgp_torch.utils.draws import Replay
from tdgp_torch.utils.tensor_group import TensorGroup
from tdgp_torch.weights import _to_port_layout, flat_key, flatten_tree, load_train_state

N = 4
CUR_NIMG = 300_000


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def T(x):
    return torch.from_numpy(np.array(x))


def port_cam(cam):
    return TensorGroup(**{k: T(cam[k]) for k in ('angles', 'fov', 'radius', 'look_at')})


def fp32_d(cfg):
    return dataclasses.replace(cfg, discriminator=dataclasses.replace(cfg.discriminator,
                                                                      fp32_only=True))


def flax_key(key, *path):
    return LazyRng.create(key, *path, 1).as_jax_rng()


def jax_state(cfg):
    """A TrainState as `create_train_state` builds it, with the inits jitted."""
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
    d_vars = jax.jit(lambda k: D.init({'params': k}, jnp.zeros((N, res, res, 4)), c,
                                      patch_params={'scales': jnp.ones((N, 2)),
                                                    'offsets': jnp.zeros((N, 2))},
                                      predict_feat=True, train=True))(jax.random.PRNGKey(1))
    g_tx, d_tx = jts.make_optimizers(cfg)
    state = jts.TrainState(
        step=jnp.zeros((), jnp.int32), g_params=g_vars['params'], g_consts=g_vars['consts'],
        g_ema_coll=g_vars['ema'], d_params=d_vars['params'],
        ema_params=jax.tree.map(jnp.copy, g_vars['params']),
        ema_ema_coll=jax.tree.map(jnp.copy, g_vars['ema']), g_opt=g_tx.init(g_vars['params']),
        d_opt=d_tx.init(d_vars['params']), pl_mean=jnp.zeros(()))
    return state, G, D


def step_draws(cfg, rng, sched):
    """Every draw the JAX step makes from `rng`, under the port's names."""
    gc = cfg.generator
    k_gen_g, k_gen_d, k_gfwd, _, k_reg, _, _, _ = jax.random.split(rng, 8)
    values = {'gen_g/spoof': T(jax.random.uniform(jax.random.split(k_gen_g, 4)[3], (N,))),
              'gen_d/spoof': T(jax.random.uniform(jax.random.split(k_gen_d, 4)[3], (N,)))}
    k_patch, k_noise, k_render, k_depth, _, _ = jax.random.split(jax.random.fold_in(k_gfwd, 0), 6)
    pp = jax_patch_params(k_patch, N, gc.patch, min_scale=sched.patch_min_scale,
                          beta=sched.patch_beta)
    values['gmain/0/patch'] = {k: T(v) for k, v in pp.items()}
    for res in sg2_block_resolutions(0, gc.tri_plane.res):
        for name in (['conv1'] if res == 4 else ['conv0', 'conv1']):
            key = flax_key(k_noise, 'synthesis', 'tri_plane_decoder', f'b{res}', name)
            values[f'gmain/0/noise/b{res}/{name}'] = T(jax.random.normal(key, (N, res, res, 1)))
    k_strat, k_n1, k_imp, k_n2 = jax.random.split(flax_key(k_render, 'synthesis'), 4)
    rays, s = gc.patch.resolution ** 2, gc.num_ray_steps
    values.update({
        'gmain/0/render/jitter': T(jax.random.uniform(k_strat, (N, rays, s))),
        'gmain/0/render/noise_coarse': T(jax.random.normal(k_n1, (N, rays * s))),
        'gmain/0/render/u': T(jax.random.uniform(k_imp, (N * rays, s))),
        'gmain/0/render/noise_fine': T(jax.random.normal(k_n2, (N, rays * s)))})
    n_out = gc.depth_adaptor.num_hid_layers + 1
    prog = float(sched.depth_progress)
    start_p = (1.0 / n_out) * (1.0 - prog) + gc.depth_adaptor.selection_start_p * prog
    slope = (1.0 - n_out * start_p) * 2.0 / (n_out * (n_out - 1))
    logits = jnp.log(jnp.arange(n_out) * slope + start_p + 1e-12)[None].repeat(N, 0)
    values['gmain/0/depth/select'] = T(jax.random.categorical(
        flax_key(k_depth, 'synthesis', 'depth_adaptor'), logits))
    k_emd, k_fm, _ = jax.random.split(k_reg, 3)
    for name, key, n in (('emd', k_emd, gc.camera_adaptor.emd.num_samples),
                         ('force_mean', k_fm, 256)):
        k_z, k_c, k_cam = jax.random.split(key, 3)
        values[f'reg/{name}/batch'] = (
            T(jax.random.normal(k_z, (n, gc.z_dim))), T(jax_random_c(k_c, n, gc.c_dim)),
            port_cam(jax_sample_camera(k_cam, asdict(cfg.camera), n)))
    return values


def run_step(cur_nimg, dtype=np.float32):
    """One step of both packages from the same weights, batch and draws
    -> (JAX stats, JAX new state, port stats, port trainer, the draws).
    With dtype float64 the weights and the batch are float64; the caller
    has turned on float64 in both frameworks."""
    jcfg, cfg = fp32_d(jax_tiny()), fp32_d(tiny_test_config())
    state, G, D = jax_state(jcfg)
    state = jax.tree.map(lambda a: a.astype(dtype) if a.dtype == np.float32 else a, state)
    jsched, sched = jax_schedules(jcfg, cur_nimg), compute_schedules(cfg, cur_nimg)
    rs = np.random.RandomState(0)
    res, gc = jcfg.dataset.resolution, jcfg.generator
    batch = dict(
        img=rs.uniform(-1, 1, (N, res, res, 3)).astype(dtype),
        depth=rs.uniform(-1, 1, (N, res, res, 1)).astype(dtype),
        c=np.eye(4, dtype=dtype)[np.arange(N) % 4],
        camera_angles=np.concatenate([rs.uniform(0.5, 1.5, (N, 2)), np.zeros((N, 1))],
                                     1).astype(dtype),
        embs=rs.randn(N, jcfg.dataset.embedding_dim).astype(dtype),
        gen_z_g=rs.randn(N, gc.z_dim).astype(dtype),
        gen_z_d=rs.randn(N, gc.z_dim).astype(dtype),
        gen_c_g=np.eye(4, dtype=dtype)[(np.arange(N) + 1) % 4],
        gen_c_d=np.eye(4, dtype=dtype)[(np.arange(N) + 2) % 4])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb['sample_idx'] = jnp.arange(N, dtype=jnp.int32)
    ks = jax.random.split(jax.random.PRNGKey(42), 3)
    jb['gen_cam_g'] = jax_sample_camera(ks[0], asdict(jcfg.camera), N)
    jb['gen_cam_d'] = jax_sample_camera(ks[1], asdict(jcfg.camera), N)
    pp = jax_patch_params(ks[2], N, gc.patch, min_scale=jsched.patch_min_scale,
                          beta=jsched.patch_beta)
    jb['real_pp_scales'], jb['real_pp_offsets'] = pp['scales'], pp['offsets']
    rng = jax.random.PRNGKey(7)
    step = jax.jit(lambda s, b, r, sc: jts.make_train_step(jcfg, G, D, controlled=True)(
        s, b, r, sc, do_r1=True))
    new_state, stats = jax.device_get(step(state, jb, rng, jsched))

    trainer = Trainer(cfg, 'cpu')
    for module in (trainer.G, trainer.D, trainer.G_ema):
        module.to(torch.from_numpy(np.zeros((), dtype)).dtype)
    s = jax.device_get(state)
    load_train_state(trainer, s.g_params, s.g_consts, s.g_ema_coll, s.d_params, s.ema_params,
                     s.ema_ema_coll)
    pb = {k: T(v) for k, v in batch.items()}
    pb.update(gen_cam_g=port_cam(jb['gen_cam_g']), gen_cam_d=port_cam(jb['gen_cam_d']),
              real_pp_scales=T(pp['scales']), real_pp_offsets=T(pp['offsets']))
    draws = Replay(step_draws(jcfg, rng, jsched))
    port_stats = trainer.step(pb, sched, True, draws, return_grads=True)
    return stats, new_state, port_stats, trainer, draws


@pytest.fixture(scope='module')
def steps():
    return run_step(CUR_NIMG)


def test_every_draw_of_the_jax_step_is_replayed(steps):
    draws = steps[4]
    assert draws.used == set(draws.values)


def test_losses(steps):
    stats, _, port_stats, _, _ = steps
    names = [k for k in stats if not k.startswith('_')]
    assert set(names) == {k for k in port_stats if not k.startswith('_')}
    for k in names:
        np.testing.assert_allclose(float(port_stats[k]), float(stats[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize('phase', ['g', 'd', 'r1'])
def test_gradients(steps, phase):
    """Gmain (with the camera regularizers), Dmain (with KD) and R1."""
    stats, _, port_stats, _, _ = steps
    flat = flatten_tree({'params': stats['_debug'][f'{phase}_grads']})
    scale = max(float(np.abs(v).max()) for v in flat.values())
    port = port_stats['_grads'][phase]
    assert len(port) == len(flat)
    for name, g in port.items():
        ref = _to_port_layout(name, flat[flat_key(name)], g.ndim)
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4, atol=1e-4 * scale, err_msg=name)


@pytest.mark.parametrize('module', ['G', 'D', 'G_ema'])
def test_parameters_and_buffers_after_the_step(steps, module):
    """Adam's updates, the w_avg EMA and the G EMA."""
    _, s, _, trainer, _ = steps
    trees = {'G': {'params': s.g_params, 'consts': s.g_consts, 'ema': s.g_ema_coll},
             'D': {'params': s.d_params},
             'G_ema': {'params': s.ema_params, 'consts': s.g_consts, 'ema': s.ema_ema_coll}}
    flat = flatten_tree(trees[module])
    scale = max(float(np.abs(v).max()) for v in flat.values())
    state = getattr(trainer, module).state_dict()
    assert {flat_key(k) for k in state} == set(flat)
    for name, value in state.items():
        ref = _to_port_layout(name, flat[flat_key(name)], value.ndim)
        np.testing.assert_allclose(value.numpy(), ref, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)


def test_microbatched_step_runs_and_checks_batch_gpu():
    """With batch_gpu the step runs Gmain and Dmain per microbatch of whole
    mbstd groups, R1 per r1_batch_gpu; a batch_gpu that does not divide the
    batch is refused."""
    cfg = fp32_d(tiny_test_config())
    cfg = dataclasses.replace(cfg, training=dataclasses.replace(cfg.training, batch_gpu=2),
                              loss=dataclasses.replace(cfg.loss, r1_batch_gpu=4))
    trainer = Trainer(cfg, 'cpu')
    from tdgp_torch import profile_training
    from tdgp_torch.utils.draws import Draws
    batch = profile_training.make_batch(cfg, 4, 0, 'cpu')
    stats = trainer.step(batch, compute_schedules(cfg, CUR_NIMG), True,
                         Draws(torch.Generator().manual_seed(0)))
    assert all(torch.isfinite(v) for v in stats.values())
    with pytest.raises(ValueError, match='batch_gpu 3'):
        bad = dataclasses.replace(cfg, training=dataclasses.replace(cfg.training, batch_gpu=3))
        Trainer(bad, 'cpu').step(batch, compute_schedules(cfg, CUR_NIMG), False,
                                 Draws(torch.Generator().manual_seed(0)))
