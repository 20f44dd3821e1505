"""One G+D training step: the port's `Trainer.step` vs the JAX package's
`make_train_step` in its controlled-inputs mode (train_step.py:226-232), on
`tiny_test_config` with the discriminator at float32, batch 4, R1 on; and
the same step at the config's own precision with G's bf16 blocks on
(`generator.fp32_only=false`; D's are on by default), held to a share of
its bf16 floor (the tests at the end of the file).

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
import functools
import re

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp
from flax.core.scope import LazyRng

from tdgp.config import asdict, tiny_test_config as jax_tiny
from tdgp.infra.experiment import apply_overrides as jax_apply_overrides
from tdgp.models.stylegan2 import sg2_block_resolutions
from tdgp.rendering.camera import sample_camera_params as jax_sample_camera
from tdgp.training import train_step as jts
from tdgp.training.patch import sample_patch_params as jax_patch_params
from tdgp.training.patch import sample_random_c as jax_random_c
from tdgp.training.schedules import compute_schedules as jax_schedules

from tdgp_torch.config import apply_overrides, tiny_test_config
from tdgp_torch.training.schedules import compute_schedules
from tdgp_torch.training.train_step import Trainer
from tdgp_torch.utils.draws import Replay
from tdgp_torch.utils.tensor_group import TensorGroup
from tdgp_torch.weights import _to_port_layout, flat_key, flatten_tree, load_train_state

from _jax_draws import jax_pipe_draws

N = 4
CUR_NIMG = 300_000


@pytest.fixture(scope='module', autouse=True)
def _one_thread_per_worker():
    """One torch and one BLAS thread while this module runs: the test workers
    share the cores, and OpenBLAS's threads spin while the others hold them."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api='blas'):
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


@functools.lru_cache(maxsize=None)
def _jax_variables(model_name, generator, discriminator, camera):
    """(G, D, G's variables, D's variables), the inits jitted: computed once
    for all the configs of a process that share these models (the training
    settings do not enter)."""
    cfg = dataclasses.replace(jax_tiny(), model_name=model_name, generator=generator,
                              discriminator=discriminator, camera=camera)
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
    return G, D, g_vars, d_vars


def jax_state(cfg):
    """A TrainState as `create_train_state` builds it, with the inits jitted."""
    G, D, g_vars, d_vars = _jax_variables(cfg.model_name, cfg.generator, cfg.discriminator,
                                          cfg.camera)
    g_tx, d_tx = jts.make_optimizers(cfg)
    state = jts.TrainState(
        step=jnp.zeros((), jnp.int32), g_params=g_vars['params'], g_consts=g_vars['consts'],
        g_ema_coll=g_vars['ema'], d_params=d_vars['params'],
        ema_params=jax.tree.map(jnp.copy, g_vars['params']),
        ema_ema_coll=jax.tree.map(jnp.copy, g_vars['ema']), g_opt=g_tx.init(g_vars['params']),
        d_opt=d_tx.init(d_vars['params']), pl_mean=jnp.zeros(()))
    return state, G, D


def render_draws(cfg, key, n, sched, prefix):
    """The draws of one Gmain render of `n` samples from its key."""
    gc = cfg.generator
    values = {}
    k_patch, k_noise, k_render, k_depth, _, _ = jax.random.split(key, 6)
    pp = jax_patch_params(k_patch, n, gc.patch, min_scale=sched.patch_min_scale,
                          beta=sched.patch_beta)
    values[f'{prefix}/patch'] = {k: T(v) for k, v in pp.items()}
    for res in sg2_block_resolutions(0, gc.tri_plane.res):
        for name in (['conv1'] if res == 4 else ['conv0', 'conv1']):
            k = flax_key(k_noise, 'synthesis', 'tri_plane_decoder', f'b{res}', name)
            values[f'{prefix}/noise/b{res}/{name}'] = T(jax.random.normal(k, (n, res, res, 1)))
    k_strat, k_n1, k_imp, k_n2 = jax.random.split(flax_key(k_render, 'synthesis'), 4)
    rays, s = gc.patch.resolution ** 2, gc.num_ray_steps
    values.update({
        f'{prefix}/render/jitter': T(jax.random.uniform(k_strat, (n, rays, s))),
        f'{prefix}/render/noise_coarse': T(jax.random.normal(k_n1, (n, rays * s))),
        f'{prefix}/render/u': T(jax.random.uniform(k_imp, (n * rays, s))),
        f'{prefix}/render/noise_fine': T(jax.random.normal(k_n2, (n, rays * s)))})
    n_out = gc.depth_adaptor.num_hid_layers + 1
    prog = float(sched.depth_progress)
    start_p = (1.0 / n_out) * (1.0 - prog) + gc.depth_adaptor.selection_start_p * prog
    slope = (1.0 - n_out * start_p) * 2.0 / (n_out * (n_out - 1))
    logits = jnp.log(jnp.arange(n_out) * slope + start_p + 1e-12)[None].repeat(n, 0)
    values[f'{prefix}/depth/select'] = T(jax.random.categorical(
        flax_key(k_depth, 'synthesis', 'depth_adaptor'), logits))
    return values


def step_draws(cfg, rng, sched, n_micro=1, n_micro_r1=1):
    """Every draw the JAX step makes from `rng`, under the port's names. A
    microbatch's draws come from its phase key folded with the index of its
    first sample, as `make_train_step` folds them."""
    gc = cfg.generator
    k_gen_g, k_gen_d, k_gfwd, k_dfwd, k_reg, _, k_aug, _ = jax.random.split(rng, 8)
    values = {'gen_g/spoof': T(jax.random.uniform(jax.random.split(k_gen_g, 4)[3], (N,))),
              'gen_d/spoof': T(jax.random.uniform(jax.random.split(k_gen_d, 4)[3], (N,)))}
    m = N // n_micro
    for i in range(n_micro):
        values.update(render_draws(cfg, jax.random.fold_in(k_gfwd, i * m), m, sched,
                                   f'gmain/{i}'))
    if not cfg.training.dmain_reuse_fakes:  # Dmain's fresh fakes, rendered per microbatch
        k_dg = jax.random.split(k_dfwd, 3)[0]
        for i in range(n_micro):
            values.update(render_draws(cfg, jax.random.fold_in(k_dg, i * m), m, sched,
                                       f'dmain/{i}'))
    k_emd, k_fm, _ = jax.random.split(k_reg, 3)
    for name, key, n in (('emd', k_emd, gc.camera_adaptor.emd.num_samples),
                         ('force_mean', k_fm, 256)):
        k_z, k_c, k_cam = jax.random.split(key, 3)
        values[f'reg/{name}/batch'] = (
            T(jax.random.normal(k_z, (n, gc.z_dim))), T(jax_random_c(k_c, n, gc.c_dim)),
            port_cam(jax_sample_camera(k_cam, asdict(cfg.camera), n)))
    if cfg.training.augment.mode != 'noaug':
        res, ch = cfg.discriminator.input_resolution, cfg.discriminator.img_channels
        for phase, fold, micro in (('gmain', 0, n_micro), ('dmain_fake', 1, n_micro),
                                   ('dmain_real', 2, n_micro), ('r1', 3, n_micro_r1)):
            mm = N // micro
            for i in range(micro):
                key = jax.random.fold_in(jax.random.fold_in(k_aug, fold), i * mm)
                for name, v in jax_pipe_draws(cfg.training.augment, key, (mm, res, res, ch),
                                              num_color_channels=gc.img_channels).items():
                    values[f'aug/{phase}/{i}/{name}'] = v
    return values


def make_inputs(jcfg, jsched, seed=0, dtype=np.float32):
    """A batch of N with the controlled generator inputs (z, labels, cameras)
    and the real patches' parameters, from numpy seed `seed` and JAX key
    42 + seed -> (the JAX batch, the port's batch)."""
    rs = np.random.RandomState(seed)
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
    ks = jax.random.split(jax.random.PRNGKey(42 + seed), 3)
    jb['gen_cam_g'] = jax_sample_camera(ks[0], asdict(jcfg.camera), N)
    jb['gen_cam_d'] = jax_sample_camera(ks[1], asdict(jcfg.camera), N)
    pp = jax_patch_params(ks[2], N, gc.patch, min_scale=jsched.patch_min_scale,
                          beta=jsched.patch_beta)
    jb['real_pp_scales'], jb['real_pp_offsets'] = pp['scales'], pp['offsets']
    pb = {k: T(v) for k, v in batch.items()}
    pb.update(gen_cam_g=port_cam(jb['gen_cam_g']), gen_cam_d=port_cam(jb['gen_cam_d']),
              real_pp_scales=T(pp['scales']), real_pp_offsets=T(pp['offsets']))
    return jb, pb


def port_trainer(cfg, state, dtype=np.float32):
    """A CPU `Trainer` holding the weights of the JAX `TrainState` `state`."""
    trainer = Trainer(cfg, 'cpu')
    for module in (trainer.G, trainer.D, trainer.G_ema):
        module.to(torch.from_numpy(np.zeros((), dtype)).dtype)
    s = jax.device_get(state)
    load_train_state(trainer, s.g_params, s.g_consts, s.g_ema_coll, s.d_params, s.ema_params,
                     s.ema_ema_coll)
    return trainer


def replay(jcfg, rng, jsched):
    """The JAX step's draws from `rng`, for the port (`step_draws`), with
    its microbatches."""
    bg, rbg = jcfg.training.batch_gpu, jcfg.loss.r1_batch_gpu
    n_micro = N // bg if bg and bg < N else 1
    return Replay(step_draws(jcfg, rng, jsched, n_micro, N // rbg if rbg else n_micro))


@dataclasses.dataclass
class Setup:
    """The configs, JAX state, schedules, batch and key of one step."""
    jcfg: object
    cfg: object
    state: object
    G: object
    D: object
    jsched: object
    sched: object
    jb: dict
    pb: dict
    rng: object
    dtype: type


def setup_step(cur_nimg, dtype=np.float32, overrides=(), ada_p=0.0):
    """`overrides` are dotted config overrides for both packages, `ada_p`
    the augment pipe's p. With dtype float64 the weights and the batch are
    float64; the caller has turned on float64 in both frameworks."""
    jcfg = jax_apply_overrides(fp32_d(jax_tiny()), overrides)
    cfg = apply_overrides(fp32_d(tiny_test_config()), overrides)
    state, G, D = jax_state(jcfg)
    state = jax.tree.map(lambda a: a.astype(dtype) if a.dtype == np.float32 else a, state)
    jsched = jax_schedules(jcfg, cur_nimg, ada_p=ada_p)
    sched = compute_schedules(cfg, cur_nimg, ada_p=ada_p)
    jb, pb = make_inputs(jcfg, jsched, 0, dtype)
    return Setup(jcfg, cfg, state, G, D, jsched, sched, jb, pb, jax.random.PRNGKey(7), dtype)


def port_step(s: Setup):
    """The port's step of `s` -> (its stats, the trainer, the draws)."""
    trainer = port_trainer(s.cfg, s.state, s.dtype)
    draws = replay(s.jcfg, s.rng, s.jsched)
    port_stats = trainer.step(s.pb, s.sched, True, draws, return_grads=True)
    return port_stats, trainer, draws


def run_setup(s: Setup):
    """Both packages' step of `s` -> (JAX stats, JAX new state, port stats,
    port trainer, the draws)."""
    step = jax.jit(lambda st, b, r, sc: jts.make_train_step(s.jcfg, s.G, s.D, controlled=True)(
        st, b, r, sc, do_r1=True))
    new_state, stats = jax.device_get(step(s.state, s.jb, s.rng, s.jsched))
    return (stats, new_state) + port_step(s)


def run_step(cur_nimg, dtype=np.float32, overrides=(), ada_p=0.0):
    """One step of both packages from the same weights, batch and draws
    -> (JAX stats, JAX new state, port stats, port trainer, the draws);
    the arguments are `setup_step`'s."""
    return run_setup(setup_step(cur_nimg, dtype, overrides, ada_p))


@pytest.fixture(scope='module')
def steps():
    return run_step(CUR_NIMG)


def test_every_draw_of_the_jax_step_is_replayed(steps):
    draws = steps[4]
    assert draws.used == set(draws.values)


def check_losses(steps):
    stats, _, port_stats, _, _ = steps
    names = [k for k in stats if not k.startswith('_')]
    assert set(names) == {k for k in port_stats if not k.startswith('_')}
    for k in names:
        np.testing.assert_allclose(float(port_stats[k]), float(stats[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def check_gradients(steps, phase):
    stats, _, port_stats, _, _ = steps
    flat = flatten_tree({'params': stats['_debug'][f'{phase}_grads']})
    scale = max(float(np.abs(v).max()) for v in flat.values())
    port = port_stats['_grads'][phase]
    assert len(port) == len(flat)
    for name, g in port.items():
        ref = _to_port_layout(name, flat[flat_key(name)], g.ndim)
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4, atol=1e-4 * scale, err_msg=name)


def check_module(steps, module):
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


def check_part(steps, part):
    """'draws' (every JAX draw replayed), 'losses', a phase's gradients ('g',
    'd', 'r1') or a module after the step ('G', 'D', 'G_ema')."""
    if part == 'draws':
        assert steps[4].used == set(steps[4].values)
    elif part == 'losses':
        check_losses(steps)
    elif part in ('g', 'd', 'r1'):
        check_gradients(steps, part)
    else:
        check_module(steps, part)


PARTS = ['draws', 'losses', 'g', 'd', 'r1', 'G', 'D', 'G_ema']


def test_losses(steps):
    check_losses(steps)


@pytest.mark.parametrize('phase', ['g', 'd', 'r1'])
def test_gradients(steps, phase):
    """Gmain (with the camera regularizers), Dmain (with KD) and R1."""
    check_gradients(steps, phase)


@pytest.mark.parametrize('module', ['G', 'D', 'G_ema'])
def test_parameters_and_buffers_after_the_step(steps, module):
    """Adam's updates, the w_avg EMA and the G EMA."""
    check_module(steps, module)


@pytest.fixture(scope='module')
def micro_steps():
    return run_step(CUR_NIMG, overrides=('training.batch_gpu=2', 'loss.r1_batch_gpu=4'))


@pytest.mark.parametrize('part', PARTS)
def test_microbatched_step(micro_steps, part):
    """Gmain and Dmain in two microbatches of 2 (`batch_gpu`), R1 in one of 4
    (`r1_batch_gpu`), against the JAX step's `lax.scan` accumulation with
    the same settings: every draw, the losses, the gradients of each phase
    and the modules after the step, at the limits above."""
    check_part(micro_steps, part)


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


# ------------------------------------------------------------------ fresh Dmain fakes

FRESH = ('training.dmain_reuse_fakes=false',)


@pytest.fixture(scope='module')
def fresh_setup():
    return setup_step(CUR_NIMG, overrides=FRESH)


@pytest.fixture(scope='module')
def fresh_steps(fresh_setup):
    return run_setup(fresh_setup)


@pytest.mark.parametrize('part', PARTS)
def test_fresh_fakes_step(fresh_steps, part):
    """`training.dmain_reuse_fakes=false`: Dmain scores fakes that the
    updated G renders without gradients from Dmain's own z, labels and
    cameras, with the draws 'dmain/<i>/...' replayed from the JAX step's
    key (`step_draws`). Every draw, the losses, each phase's gradients and
    the modules after the step, at the limits above."""
    check_part(fresh_steps, part)


def test_fresh_fakes_scored_with_gmain_labels_miss_the_limit(fresh_setup, fresh_steps,
                                                            monkeypatch):
    """Mutation witness: the fresh fakes scored with Gmain's labels `cg` in
    place of Dmain's `cd` miss the Dmain gradient's limit."""
    from tdgp_torch.training import losses
    g_forward, d_forward = losses.g_forward, losses.d_forward
    fresh = set()

    def render(*args, **kwargs):
        out, pp = g_forward(*args, **kwargs)
        if not torch.is_grad_enabled():
            fresh.add(id(out.img))
        return out, pp

    def score(D, img, c, *args, **kwargs):
        if id(img) in fresh:
            c = fresh_setup.pb['gen_c_g']
        return d_forward(D, img, c, *args, **kwargs)

    monkeypatch.setattr(losses, 'g_forward', render)
    monkeypatch.setattr(losses, 'd_forward', score)
    mutated = fresh_steps[:2] + port_step(fresh_setup)
    assert fresh, 'no fresh fakes were rendered'
    check_gradients(fresh_steps, 'd')
    with pytest.raises(AssertionError):
        check_gradients(mutated, 'd')


def test_training_render_reads_no_w_avg():
    """The port moves `w_avg` before Dmain renders its fresh fakes, JAX
    after (its render takes the step's old 'ema' collection): the same,
    since the training render takes no truncation. A `w_avg` of NaN
    changes nothing in `losses.g_forward`."""
    from tdgp_torch.training import losses
    from tdgp_torch.utils.draws import Draws
    cfg = apply_overrides(fp32_d(tiny_test_config()), FRESH)
    trainer = Trainer(cfg, 'cpu')
    sched = compute_schedules(cfg, CUR_NIMG)
    z, c = torch.randn(2, cfg.generator.z_dim), torch.eye(4)[:2]
    from tdgp_torch.rendering.camera import sample_camera_params
    cam = sample_camera_params(Draws(torch.Generator().manual_seed(1)), cfg.camera, 2)

    def render():
        with torch.no_grad():
            out, _ = losses.g_forward(trainer.G, z, c, cam, cam.angles, sched, cfg,
                                      Draws(torch.Generator().manual_seed(2)))
        return out.img

    before = render()
    trainer.G.mapping.w_avg.fill_(float('nan'))
    after = render()
    assert torch.isfinite(before).all() and torch.equal(before, after)


# ------------------------------------------------------------------ the bf16 blocks

BF16 = ('generator.fp32_only=false', 'discriminator.fp32_only=false')
# the conv weights of the tiny config's bf16 blocks: G's 8-32, D's 64-8
BF16_CONVS = re.compile(r'(synthesis\.tri_plane_decoder\.b(8|16|32)|b(64|32|16|8))\.'
                        r'(conv0|conv1|torgb|skip|fromrgb)\.weight$')
LOSS_OF_FLOOR = 0.6       # each loss: |port - JAX| over the step's largest loss floor
GRAD_OF_FLOOR = 1.0       # a phase's gradients, concatenated: relative L2 over the floor
CONV_MEDIAN_OF_FLOOR = 0.8  # the bf16 blocks' conv weights: median of their ratios ...
CONV_MAX_OF_FLOOR = 1.1     # ... and the largest (within JAX's own spread, the witness below)
FRESH_CONV_MAX_OF_FLOOR = 1.25  # the largest with fresh Dmain fakes (Dmain's: 1.01)


@pytest.fixture(scope='module')
def bf16_steps():
    return run_step(CUR_NIMG, overrides=BF16)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def floor_ratios(bf16_steps, steps, phase, port_grads):
    """(the phase's gradients concatenated, {bf16 conv weight: ratio}): the
    relative L2 distance of `port_grads` to JAX's step in bf16 over that of
    JAX's step in float32 (the floor)."""
    ref = flatten_tree({'params': bf16_steps[0]['_debug'][f'{phase}_grads']})
    ref32 = flatten_tree({'params': steps[0]['_debug'][f'{phase}_grads']})
    got, want, want32, convs = [], [], [], {}
    for name, g in port_grads.items():
        r = _to_port_layout(name, ref[flat_key(name)], g.ndim)
        r32 = _to_port_layout(name, ref32[flat_key(name)], g.ndim)
        got.append(g.numpy().ravel()), want.append(r.ravel()), want32.append(r32.ravel())
        if BF16_CONVS.match(name):
            convs[name] = _rel(g.numpy(), r) / _rel(r, r32)
    whole = _rel(np.concatenate(got), np.concatenate(want)) / _rel(np.concatenate(want),
                                                                     np.concatenate(want32))
    return whole, convs


def test_bf16_step_keeps_float32_state(bf16_steps):
    """The step at the tiny config's own precision: every draw replayed,
    parameters, gradients and the EMA in float32, the blocks in bf16."""
    _, _, port_stats, trainer, draws = bf16_steps
    assert draws.used == set(draws.values)
    dec = trainer.G.synthesis.tri_plane_decoder
    assert dec.b32.dtype == torch.bfloat16 and dec.b4.dtype is None
    assert trainer.D.b64.dtype == torch.bfloat16
    for module in (trainer.G, trainer.D, trainer.G_ema):
        assert all(p.dtype == torch.float32 and bool(torch.isfinite(p).all())
                   for p in module.parameters())
    assert all(g.dtype == torch.float32 for grads in port_stats['_grads'].values()
               for g in grads.values())


def test_bf16_step_losses(bf16_steps, steps):
    """Each loss within LOSS_OF_FLOOR x the step's loss floor (the largest
    |JAX bf16 - JAX float32| of the step's losses; witness 0.39)."""
    ref32, ref, port = steps[0], bf16_steps[0], bf16_steps[2]
    names = [k for k in ref if not k.startswith('_')]
    floor = max(abs(float(ref[k]) - float(ref32[k])) for k in names)
    worst = max(abs(float(port[k]) - float(ref[k])) for k in names)
    assert worst <= LOSS_OF_FLOOR * floor, (worst, floor)


@pytest.mark.parametrize('phase', ['g', 'd', 'r1'])
def test_bf16_step_gradients(bf16_steps, steps, phase):
    """Gmain, Dmain and R1 through the bf16 blocks against the JAX step at
    the same precision. JAX on the CPU sums the gradients of biases, styles
    and noise strengths in bf16, as far from their float32 sums as bf16 is
    from float32, so the phase as a whole is held to its floor (witness:
    0.95 / 0.87 / 0.37) and the bf16 blocks' conv weights, whose gradients
    JAX sums in float32, to a share of theirs (median 0.40 / 0.65 / 0.37,
    largest 0.57 / 1.034 / 0.44: D's `b8.skip`, within JAX's own spread,
    `test_bf16_d_limit_within_jax_self_spread`)."""
    whole, convs = floor_ratios(bf16_steps, steps, phase, bf16_steps[2]['_grads'][phase])
    assert len(convs) == (9 if phase == 'g' else 13), sorted(convs)
    assert whole <= GRAD_OF_FLOOR, whole
    assert float(np.median(list(convs.values()))) <= CONV_MEDIAN_OF_FLOOR, convs
    assert max(convs.values()) <= CONV_MAX_OF_FLOOR, convs


def _f32_conv(conv):
    """`jax.lax.conv_general_dilated` taken as the port's CPU route takes a
    bf16 convolution: float32 on the bf16 operands, rounded once."""
    def f(lhs, rhs, *args, **kwargs):
        if lhs.dtype == jnp.bfloat16:
            return conv(lhs.astype(jnp.float32), rhs.astype(jnp.float32), *args,
                        **kwargs).astype(jnp.bfloat16)
        return conv(lhs, rhs, *args, **kwargs)
    return f


def d_alone_spread(n_batches):
    """JAX's D with the step's starting weights on `n_batches` batches of
    random real patches (numpy seeds 0, 1, ...), differentiated through
    Dmain's real-pass loss (softplus(-logits) summed, plus the mean KD
    distance to the batch's embeddings): per batch, {bf16 conv weight: the
    relative L2 distance of JAX's bf16 D with its convolutions taken as the
    port's CPU route to its own bf16 D, over the floor (to its float32 D)}."""
    from unittest import mock
    from tdgp.training import losses as jax_losses
    s = setup_step(CUR_NIMG, overrides=BF16)
    D32 = jts.build_models(jax_apply_overrides(fp32_d(jax_tiny()), ()))[1]
    pp = {'scales': s.jb['real_pp_scales'], 'offsets': s.jb['real_pp_offsets']}
    res = s.cfg.discriminator.input_resolution
    batches = [np.random.RandomState(seed).uniform(-1, 1, (N, res, res, 4)).astype(np.float32)
               for seed in range(n_batches)]

    def grads(D, route=False):
        def loss(params, x):
            logits, feats = D.apply({'params': params}, x, s.jb['c'], patch_params=pp,
                                    predict_feat=True)
            return (jnp.sum(jax.nn.softplus(-logits))
                    + jnp.mean(jax_losses.kd_loss(feats, s.jb['embs'], 'l2')))

        conv = _f32_conv(jax.lax.conv_general_dilated) if route else jax.lax.conv_general_dilated
        with mock.patch.object(jax.lax, 'conv_general_dilated', conv):  # traced in here
            grad = jax.jit(jax.grad(loss))
            return [flatten_tree({'params': jax.device_get(grad(s.state.d_params, x))})
                    for x in batches]

    out = []
    for ref, ref32, spread in zip(grads(s.D), grads(D32), grads(s.D, route=True)):
        out.append({k: _rel(spread[k], ref[k]) / _rel(ref[k], ref32[k]) for k in ref
                    if BF16_CONVS.match(k.replace('params/', '').replace('/', '.'))})
    return out


def test_bf16_d_limit_within_jax_self_spread():
    """Witness for CONV_MAX_OF_FLOOR. The largest of D's bf16 conv weight
    ratios is a heavy-tailed statistic of the batch. On the step's own batch
    JAX's bf16 step against itself with its convolutions taken as the port's
    CPU route reads 0.566 (G's alone 0.391, D's alone 0.510) and the port
    1.034 (0.996 given JAX's own fakes; with KD off 0.59 against the route's
    0.79). On six batches of D alone (`d_alone_spread`) the route reads
    1.02 / 0.93 / 0.80 / 0.84 / 1.14 / 2.76 (`b8.skip`, 2.76) and the port
    1.60 / 0.51 / 0.70 / 0.32 / 0.87 / 2.69: JAX's own roundings reach the
    limit."""
    batches = d_alone_spread(6)
    assert all(len(ratios) == 13 for ratios in batches)
    largest = [max(ratios.values()) for ratios in batches]
    assert max(largest) >= CONV_MAX_OF_FLOOR, largest


@pytest.mark.parametrize('phase', ['g', 'd', 'r1'])
def test_bf16_step_gradients_at_float32_miss_the_limit(bf16_steps, steps, phase):
    """Mutation witness: the port's step at float32 (no bf16 block) is at
    least the floor away from JAX's bf16 step on the conv weights (median
    1.007 / 1.007 / 1.05)."""
    _, convs = floor_ratios(bf16_steps, steps, phase, steps[2]['_grads'][phase])
    assert float(np.median(list(convs.values()))) > CONV_MEDIAN_OF_FLOOR, convs


@pytest.fixture(scope='module')
def bf16_fresh_steps():
    return run_step(CUR_NIMG, overrides=BF16 + FRESH)


def test_bf16_fresh_fakes_step_losses(bf16_fresh_steps, fresh_steps):
    """Fresh fakes at the tiny config's own precision, against the JAX step
    at that precision: every draw replayed, state in float32, each loss
    within LOSS_OF_FLOOR x the step's loss floor (JAX's fresh-fakes step in
    bf16 against JAX's in float32; witness 0.39)."""
    _, _, port, trainer, draws = bf16_fresh_steps
    assert draws.used == set(draws.values)
    assert trainer.D.b64.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in trainer.G.parameters())
    ref32, ref = fresh_steps[0], bf16_fresh_steps[0]
    names = [k for k in ref if not k.startswith('_')]
    floor = max(abs(float(ref[k]) - float(ref32[k])) for k in names)
    worst = max(abs(float(port[k]) - float(ref[k])) for k in names)
    assert worst <= LOSS_OF_FLOOR * floor, (worst, floor)


@pytest.mark.parametrize('phase', ['g', 'd', 'r1'])
def test_bf16_fresh_fakes_step_gradients(bf16_fresh_steps, fresh_steps, phase):
    """Each phase's gradients with fresh fakes at bf16, held as the reused
    fakes' above: the phase within GRAD_OF_FLOOR x its floor, the bf16
    blocks' conv weights' median within CONV_MEDIAN_OF_FLOOR and their
    largest within FRESH_CONV_MAX_OF_FLOOR: Dmain's fakes now pass G's
    bf16 blocks before D's, so D's gradient carries the flips of both
    (witness: whole 0.95 / 0.85 / 0.64, median 0.40 / 0.73 / 0.72, largest
    0.57 / 1.01 / 0.88)."""
    whole, convs = floor_ratios(bf16_fresh_steps, fresh_steps, phase,
                                bf16_fresh_steps[2]['_grads'][phase])
    assert whole <= GRAD_OF_FLOOR, whole
    assert float(np.median(list(convs.values()))) <= CONV_MEDIAN_OF_FLOOR, convs
    assert max(convs.values()) <= FRESH_CONV_MAX_OF_FLOOR, convs


@pytest.mark.parametrize('phase', ['g', 'd', 'r1'])
def test_bf16_fresh_fakes_gradients_at_float32_miss_the_limit(bf16_fresh_steps, fresh_steps,
                                                              phase):
    """Mutation witness: the port's fresh-fakes step at float32 misses the
    conv weights' median limit against JAX's bf16 step (1.007 / 1.005 /
    0.998)."""
    _, convs = floor_ratios(bf16_fresh_steps, fresh_steps, phase, fresh_steps[2]['_grads'][phase])
    assert float(np.median(list(convs.values()))) > CONV_MEDIAN_OF_FLOOR, convs
