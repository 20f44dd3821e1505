"""The modules of the training slice: port (tdgp_torch) vs JAX package (tdgp)
on the CPU, at `tiny_test_config` size.

Each test makes its inputs with numpy from a seed, initialises the JAX
module from fixed keys, carries its variables into the port's module through
`tdgp_torch.weights`, and compares the outputs (and gradients, where the
slice differentiates). Random draws are recomputed with `jax.random` on the
JAX side's own keys (through flax's key derivation where a module draws
with `make_rng`) and handed to the port through `Replay`. rtol = atol = 1e-4
unless a test says otherwise (XLA:CPU vs PyTorch float32 sums,
tests/conftest.py:18-33).
"""
import dataclasses
import re

import numpy as np
import optax
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp
from flax.core.scope import LazyRng

import tdgp.config as jcfg
from tdgp.infra.experiment import finalize_config as jax_finalize, load_config as jax_load
from tdgp.models import camera_adaptor as jax_ca
from tdgp.models.depth_adaptor import DepthAdaptor as JaxDepthAdaptor
from tdgp.models.discriminator import Discriminator as JaxDiscriminator
from tdgp.models.epigraf import Generator as JaxGenerator
from tdgp.models.layers import MappingNetwork as JaxMapping
from tdgp.models.stylegan2 import SynthesisBlocksSequence as JaxBlocks
from tdgp.ops.bias_act import bias_act as jax_bias_act
from tdgp.ops.conv2d_resample import conv2d_resample as jax_conv2d_resample
from tdgp.ops.upfirdn2d import filter2d as jax_filter2d, setup_filter as jax_setup_filter
from tdgp.ops.upfirdn2d import upfirdn2d as jax_upfirdn2d
from tdgp.rendering import camera as jax_camera, rays as jax_rays, renderer as jax_renderer
from tdgp.training import blur as jax_blur, losses as jax_losses, patch as jax_patch
from tdgp.training.schedules import compute_schedules as jax_schedules
from tdgp.training.train_step import make_optimizers as jax_make_optimizers
from tdgp.utils.tensor_group import TensorGroup as JaxTensorGroup

from tdgp_torch import config as pcfg
from tdgp_torch.models.camera_adaptor import CameraAdaptor
from tdgp_torch.models.depth_adaptor import DepthAdaptor
from tdgp_torch.models.discriminator import Discriminator
from tdgp_torch.models.epigraf import Generator
from tdgp_torch.models.layers import MappingNetwork
from tdgp_torch.models.stylegan2 import SynthesisBlocksSequence
from tdgp_torch.ops.bias_act import bias_act
from tdgp_torch.ops.conv2d_resample import conv2d_resample
from tdgp_torch.ops.upfirdn2d import filter2d, setup_filter, upfirdn2d
from tdgp_torch.rendering import camera, rays, renderer
from tdgp_torch.training import blur, losses, patch
from tdgp_torch.training.schedules import compute_schedules
from tdgp_torch.training.train_step import Trainer, make_optimizers
from tdgp_torch.utils.draws import Draws, Replay
from tdgp_torch.utils.misc import linear_schedule, nan_to_num
from tdgp_torch.utils.tensor_group import TensorGroup
from tdgp_torch.weights import flatten_tree, load_flat

TOL = dict(rtol=1e-4, atol=1e-4)
RUN_YAML = 'experiments/synth256-3dgp-p64-b16-8839f23-r5-flagship/experiment_config.yaml'


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


def close(port, ref, **tol):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), **(tol or TOL))


def load(module, jax_vars):
    load_flat(module, flatten_tree(jax.device_get(jax_vars)))
    return module


def flax_key(key, *path):
    """The key a flax module at `path` gets from its first `make_rng`."""
    return LazyRng.create(key, *path, 1).as_jax_rng()


def fp32_d(cfg):
    return dataclasses.replace(cfg, discriminator=dataclasses.replace(cfg.discriminator,
                                                                      fp32_only=True))


# ------------------------------------------------------------------ config

@pytest.mark.parametrize('name', ['tiny_test_config', 'satellite_config', 'Config'])
def test_config_sections_match_the_jax_package(name):
    port, ref = getattr(pcfg, name)(), getattr(jcfg, name)()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(pcfg.finalize_config(port)) == \
        dataclasses.asdict(jax_finalize(ref))


def test_flagship_config_loads_whole():
    assert dataclasses.asdict(pcfg.load_config(RUN_YAML)) == dataclasses.asdict(jax_load(RUN_YAML))


@pytest.mark.parametrize('cur_nimg', [0, 100_000, 500_000, 20_000_000])
def test_schedules(cur_nimg):
    cfg = pcfg.satellite_config()
    port = dataclasses.asdict(compute_schedules(cfg, cur_nimg, ada_p=0.3))
    ref = jax_schedules(jcfg.satellite_config(), cur_nimg, ada_p=0.3)
    for k, v in port.items():
        np.testing.assert_allclose(v, float(getattr(ref, k)), rtol=1e-6, err_msg=k)


def test_linear_schedule_and_nan_to_num():
    assert linear_schedule(5, 1.0, 0.0, 10) == 0.5
    assert linear_schedule(-1, 1.0, 0.0, 10) == 1.0 and linear_schedule(11, 1.0, 0.0, 10) == 0.0
    x = torch.tensor([float('nan'), float('inf'), -float('inf'), 2.0])
    assert nan_to_num(x).tolist() == [0.0, 1e5, -1e5, 2.0]


# ------------------------------------------------------------------ draws

def test_replay_gives_values_by_name_and_checks_them():
    d = Replay({'a/x': np.zeros(3, np.float32), 'a/c': 7})
    assert d.scope('a').uniform('x', (3,)).shape == (3,)
    assert d.scope('a').draw('c', lambda _: 0) == 7
    assert d.draw('b', lambda s: s.prefix) == 'b/'
    with pytest.raises(KeyError, match="'a/y'"):
        d.scope('a').normal('y', (3,))
    with pytest.raises(ValueError, match='needs'):
        d.scope('a').uniform('x', (4,))
    g1, g2 = (Draws(torch.Generator().manual_seed(5)) for _ in range(2))
    assert torch.equal(g1.normal('n', (4,)), g2.scope('s').normal('other', (4,)))


# ------------------------------------------------------------------ camera, patches, rays

def _camera_draws(key, n, cam_cfg):
    """The uniforms `tdgp.rendering.camera.sample_camera_params` draws."""
    k_ang, k_fov, _, k_la = jax.random.split(key, 4)
    k_yaw, k_pitch, _ = jax.random.split(k_ang, 3)
    k_ang2, k_rad2 = jax.random.split(k_la)
    k_yaw2, k_pitch2, _ = jax.random.split(k_ang2, 3)
    u = lambda k: T(jax.random.uniform(k, (n,)))  # noqa: E731
    return {'angles/yaw': u(k_yaw), 'angles/pitch': u(k_pitch), 'fov': u(k_fov),
            'look_at/angles/yaw': u(k_yaw2), 'look_at/angles/pitch': u(k_pitch2),
            'look_at/radius': u(k_rad2)}


@pytest.mark.parametrize('angles', ['uniform', 'truncnorm'])
def test_sample_camera_params(angles):
    cam = pcfg.CameraConfig()
    if angles == 'truncnorm':
        oa = dataclasses.replace(cam.origin.angles, dist='truncnorm',
                                 yaw=dataclasses.replace(cam.origin.angles.yaw, std=0.3),
                                 pitch=dataclasses.replace(cam.origin.angles.pitch, std=0.2))
        cam = dataclasses.replace(cam, origin=dataclasses.replace(cam.origin, angles=oa))
    key, n = jax.random.PRNGKey(3), 16
    ref = jax_camera.sample_camera_params(key, dataclasses.asdict(cam), n)
    port = camera.sample_camera_params(Replay(_camera_draws(key, n, cam)), cam, n)
    for k in ('angles', 'fov', 'radius', 'look_at'):
        close(port[k], ref[k])


def test_patch_coords_and_extraction():
    rng = np.random.RandomState(0)
    pp = {'scales': np.repeat(rng.uniform(0.25, 1, (2, 1)), 2, 1).astype(np.float32),
          'offsets': rng.uniform(0, 0.5, (2, 2)).astype(np.float32)}
    img = rng.randn(2, 32, 32, 4).astype(np.float32)
    ref = jax_patch.extract_patches(jnp.asarray(img), {k: jnp.asarray(v) for k, v in pp.items()}, 8)
    port = patch.extract_patches(T(img), {k: T(v) for k, v in pp.items()}, 8)
    close(port, ref)


def test_sample_patch_params_uniform_replays_the_jax_draws():
    cfg = dataclasses.replace(pcfg.PatchCfg(), distribution='uniform', mbstd_group_size=2)
    key = jax.random.PRNGKey(4)
    k_scale, k_off = jax.random.split(key)
    ref = jax_patch.sample_patch_params(key, 8, dataclasses.replace(
        jcfg.PatchCfg(), distribution='uniform', mbstd_group_size=2), min_scale=0.3)
    port = patch.sample_patch_params(
        Replay({'scale': T(jax.random.uniform(k_scale, (4,))),
                'offset': T(jax.random.uniform(k_off, (4, 2)))}), 8, cfg, min_scale=0.3)
    for k in ('scales', 'offsets'):
        close(port[k], ref[k])


def test_sample_patch_params_beta_is_grouped_and_bounded():
    cfg = pcfg.PatchCfg()  # beta, groups of 4
    pp = patch.sample_patch_params(Draws(torch.Generator().manual_seed(0)), 64, cfg,
                                   min_scale=0.25, beta=0.04)
    s, o = pp['scales'], pp['offsets']
    assert torch.equal(s[:, 0], s[:, 1]) and torch.equal(s[::4], s[3::4])
    assert torch.equal(o[::4], o[1::4])
    assert bool((s >= 0.25).all() and (s <= 1.0).all() and (o >= 0).all() and (o <= 1 - s).all())


def test_sample_random_c():
    c = patch.sample_random_c(Draws(torch.Generator().manual_seed(1)), 10, 4)
    assert c.shape == (10, 4) and torch.equal(c.sum(1), torch.ones(10))
    assert patch.sample_random_c(Draws(torch.Generator()), 3, 0).shape == (3, 0)


def test_patch_rays():
    rng = np.random.RandomState(5)
    cams = dict(angles=np.stack([rng.uniform(-1, 1, 2), rng.uniform(1, 2, 2), np.zeros(2)],
                                1).astype(np.float32),
                fov=rng.uniform(10, 40, 2).astype(np.float32), radius=np.ones(2, np.float32),
                look_at=rng.uniform(0, 0.1, (2, 3)).astype(np.float32))
    pp = {'scales': rng.uniform(0.3, 1, (2, 2)).astype(np.float32),
          'offsets': rng.uniform(0, 0.3, (2, 2)).astype(np.float32)}
    jc2w = jax_camera.compute_cam2world_matrix(JaxTensorGroup(**{k: jnp.asarray(v)
                                                                 for k, v in cams.items()}))
    ref = jax_rays.sample_rays(jc2w, jnp.asarray(cams['fov']), (6, 6),
                               {k: jnp.asarray(v) for k, v in pp.items()})
    c2w = camera.compute_cam2world_matrix(TensorGroup(**{k: T(v) for k, v in cams.items()}))
    port = rays.sample_rays(c2w, T(cams['fov']), (6, 6), {k: T(v) for k, v in pp.items()})
    for p, r in zip(port, ref):
        close(p, r)


# ------------------------------------------------------------------ renderer

def test_importance_render_in_training_and_its_gradient():
    """Jittered coarse samples, stratified random u, density noise: the JAX
    renderer's draws replayed; the gradient flows to the field's parameters
    through the plain K3 backward and the sample merge."""
    rng = np.random.RandomState(3)
    a = rng.randn(3, 3).astype(np.float32) * 3
    b = rng.randn(3).astype(np.float32) * 4
    bsz, n_rays, s = 2, 16, 8
    ro = np.repeat(rng.uniform(-1, 1, (bsz, 1, 3)), n_rays, 1).astype(np.float32) * 1.5
    rd = rng.randn(bsz, n_rays, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    key = jax.random.PRNGKey(9)
    jopts = jax_renderer.RenderOptions(num_proposal_steps=s, num_fine_steps=s)

    def jloss(a_, b_):
        def field(x):
            return jnp.sin(x @ a_), 6 * jnp.cos(x @ b_) - 2
        rgb, depth, wsum, _ = jax_renderer.importance_render(
            field, jnp.asarray(ro), jnp.asarray(rd), key, jopts, density_noise=0.3, jitter=True)
        return jnp.sum(rgb * 0.3) + jnp.sum(depth * 0.7) - jnp.sum(wsum), (rgb, depth)

    (_, (ref_rgb, ref_depth)), ref_grads = jax.value_and_grad(jloss, argnums=(0, 1),
                                                              has_aux=True)(a, b)
    k_strat, k_n1, k_imp, k_n2 = jax.random.split(key, 4)
    draws = Replay({'jitter': T(jax.random.uniform(k_strat, (bsz, n_rays, s))),
                    'noise_coarse': T(jax.random.normal(k_n1, (bsz, n_rays * s))),
                    'u': T(jax.random.uniform(k_imp, (bsz * n_rays, s))),
                    'noise_fine': T(jax.random.normal(k_n2, (bsz, n_rays * s)))})
    at, bt = T(a).requires_grad_(True), T(b).requires_grad_(True)
    rgb, depth, wsum, _ = renderer.importance_render(
        lambda x: (torch.sin(x @ at), 6 * torch.cos(x @ bt) - 2), T(ro), T(rd),
        renderer.RenderOptions(num_proposal_steps=s, num_fine_steps=s), draws=draws,
        density_noise=0.3)
    (rgb.sum() * 0.3 + depth.sum() * 0.7 - wsum.sum()).backward()
    close(rgb, ref_rgb)
    close(depth, ref_depth)
    for p, r in zip((at.grad, bt.grad), ref_grads):
        close(p, r, rtol=1e-4, atol=1e-4 * float(np.abs(r).max()))
    assert draws.used == set(draws.values)


# ------------------------------------------------------------------ generator modules

def test_decoder_with_random_noise():
    """The StyleGAN2 stack with noise drawn per layer, as flax's 'noise' keys give it."""
    kw = dict(w_dim=32, out_resolution=32, out_channels=24, cbase=1024, cmax=64)
    jseq = JaxBlocks(in_resolution=0, in_channels=0, fp32_only=True, **kw)
    ws = np.random.RandomState(0).randn(2, jseq.num_ws, 32).astype(np.float32)
    keys = {'params': jax.random.PRNGKey(0), 'noise': jax.random.PRNGKey(1)}
    variables = jax.jit(lambda k: jseq.init(k, jnp.asarray(ws)))(keys)
    seq = SynthesisBlocksSequence(**kw)
    load(seq, variables)
    with torch.no_grad():  # noise strengths start at 0: give them weight
        for name, p in seq.named_parameters():
            if name.endswith('noise_strength'):
                p.fill_(0.7)
    params = {**variables, 'params': jax.tree_util.tree_map_with_path(
        lambda path, v: jnp.full_like(v, 0.7) if 'noise_strength' in str(path[-1]) else v,
        variables['params'])}
    k_noise = jax.random.PRNGKey(2)
    ref = jseq.apply(params, jnp.asarray(ws), noise_mode='random', rngs={'noise': k_noise})
    values = {}
    for res in seq.resolutions:
        for name in (['conv1'] if res == 4 else ['conv0', 'conv1']):
            values[f'b{res}/{name}'] = T(jax.random.normal(flax_key(k_noise, f'b{res}', name),
                                                           (2, res, res, 1)))
    port = seq(T(ws), seq.draw_noise(Replay(values), 2))
    close(port, ref)


@pytest.mark.parametrize('kind', ['generator', 'hypernetwork'])
def test_mapping_in_training(kind):
    rng = np.random.RandomState(1)
    if kind == 'generator':  # camera-conditioned, with the w_avg EMA
        jmap = JaxMapping(z_dim=16, c_dim=4, w_dim=32, num_ws=5, camera_cond=True)
        pmap = MappingNetwork(z_dim=16, c_dim=4, w_dim=32, num_ws=5, camera_cond=True)
        z = rng.randn(4, 16).astype(np.float32)
    else:  # the discriminator's: no z, no ws, no EMA
        jmap = JaxMapping(z_dim=0, c_dim=12, w_dim=32, num_ws=None, w_avg_beta=None)
        pmap = MappingNetwork(z_dim=0, c_dim=12, w_dim=32, num_ws=None, w_avg_beta=None)
        z = None
    c = rng.randn(4, 4 if kind == 'generator' else 12).astype(np.float32)
    ang = rng.uniform(-3, 3, (4, 3)).astype(np.float32)
    jz = None if z is None else jnp.asarray(z)
    variables = jmap.init(jax.random.PRNGKey(0), jz, jnp.asarray(c), camera_angles=jnp.asarray(ang))
    if kind == 'generator':
        variables = {**variables, 'ema': {'w_avg': jnp.asarray(rng.randn(32).astype(np.float32))}}
    load(pmap, variables)
    ref, new = jmap.apply(variables, jz, jnp.asarray(c), camera_angles=jnp.asarray(ang),
                          update_emas=True, mutable=['ema'])
    port = pmap(None if z is None else T(z), T(c), camera_angles=T(ang), update_emas=True)
    close(port, ref)
    if kind == 'generator':
        close(pmap.w_avg, new['ema']['w_avg'])


@pytest.mark.parametrize('train', [False, True])
def test_depth_adaptor(train):
    cfg = jcfg.tiny_test_config().generator.depth_adaptor
    jda = JaxDepthAdaptor(cfg, min_depth=0.75, max_depth=1.25)
    depth = np.random.RandomState(2).uniform(0.7, 1.3, (5, 8, 8, 1)).astype(np.float32)
    variables = jda.init(jax.random.PRNGKey(0), jnp.asarray(depth), None)
    k = jax.random.PRNGKey(4)
    ref = jda.apply(variables, jnp.asarray(depth), None, progress=0.3, train=train,
                    rngs={'depth': k})
    pda = load(DepthAdaptor(pcfg.tiny_test_config().generator.depth_adaptor, 0.75, 1.25),
               variables)
    draws = None
    if train:
        n_out = cfg.num_hid_layers + 1
        start_p = (1.0 / n_out) * 0.7 + cfg.selection_start_p * 0.3
        slope = (1.0 - n_out * start_p) * 2.0 / (n_out * (n_out - 1))
        logits = jnp.log(jnp.arange(n_out) * slope + start_p + 1e-12)[None].repeat(5, 0)
        draws = Replay({'select': T(jax.random.categorical(flax_key(k), logits))})
    close(pda(T(depth), progress=0.3, draws=draws), ref)


@pytest.mark.parametrize('variant', ['default', 'residual'])
def test_camera_adaptor(variant):
    acfg = dataclasses.replace(jcfg.tiny_test_config().generator.camera_adaptor,
                               residual=variant == 'residual')
    cam_cfg = jcfg.CameraConfig()
    prior = jax_camera.sample_camera_params(jax.random.PRNGKey(1), dataclasses.asdict(cam_cfg), 6)
    rng = np.random.RandomState(3)
    z = rng.randn(6, acfg.z_dim).astype(np.float32)
    c = np.eye(4, dtype=np.float32)[np.arange(6) % 4]
    jca = jax_ca.CameraAdaptor(acfg, cam_cfg)
    variables = jca.init(jax.random.PRNGKey(0), prior, jnp.asarray(z), jnp.asarray(c))
    ref = jca.apply(variables, prior, jnp.asarray(z), jnp.asarray(c))
    pacfg = dataclasses.replace(pcfg.tiny_test_config().generator.camera_adaptor,
                                residual=variant == 'residual')
    pca = load(CameraAdaptor(pacfg, pcfg.CameraConfig()), variables)
    port = pca(TensorGroup(**{k: T(prior[k]) for k in ('angles', 'fov', 'radius', 'look_at')}),
               T(z), T(c))
    for k in ('angles', 'fov', 'radius', 'look_at'):
        close(port[k], ref[k])


# ------------------------------------------------------------------ discriminator

@pytest.fixture(scope='module')
def disc():
    """The tiny discriminator (float32), its JAX variables and an input."""
    cfg = fp32_d(jcfg.tiny_test_config()).discriminator
    rng = np.random.RandomState(4)
    n = 4
    img = rng.uniform(-1, 1, (n, 16, 16, 4)).astype(np.float32)
    c = np.eye(4, dtype=np.float32)[np.arange(n)]
    pp = {'scales': np.repeat(np.array([[0.5], [0.5], [0.8], [0.8]], np.float32), 2, 1),
          'offsets': rng.uniform(0, 0.2, (n, 2)).astype(np.float32)}
    jd = JaxDiscriminator(cfg)
    variables = jax.jit(lambda k: jd.init(k, jnp.asarray(img), jnp.asarray(c), patch_params={
        k_: jnp.asarray(v) for k_, v in pp.items()}, predict_feat=True))(jax.random.PRNGKey(1))
    port = load(Discriminator(fp32_d(pcfg.tiny_test_config()).discriminator), variables)
    return jd, variables, port, img, c, pp


def test_discriminator_logits_and_kd_features(disc):
    jd, variables, port, img, c, pp = disc
    ref_logits, ref_feats = jd.apply(variables, jnp.asarray(img), jnp.asarray(c), patch_params={
        k: jnp.asarray(v) for k, v in pp.items()}, predict_feat=True)
    logits, feats = port(T(img), T(c), {k: T(v) for k, v in pp.items()}, predict_feat=True)
    close(logits, ref_logits)
    close(feats, ref_feats)


def test_discriminator_r1_gradient_of_a_gradient(disc):
    """R1's penalty, d/dparams of |d logits / d img|^2, through D twice."""
    jd, variables, port, img, c, pp = disc
    jpp = {k: jnp.asarray(v) for k, v in pp.items()}

    def penalty(params):
        g = jax.grad(lambda x: jnp.sum(jd.apply({'params': params}, x, jnp.asarray(c),
                                                patch_params=jpp)[0]))(jnp.asarray(img))
        return jnp.sum(jnp.square(g))

    ref_pen, ref_grads = jax.jit(jax.value_and_grad(penalty))(variables['params'])
    x = T(img).requires_grad_(True)
    logits, _ = port(x, T(c), {k: T(v) for k, v in pp.items()})
    (gx,) = torch.autograd.grad(logits.sum(), x, create_graph=True)
    pen = gx.square().sum()
    pen.backward()
    close(pen, ref_pen)
    flat = flatten_tree({'params': jax.device_get(ref_grads)})
    from tdgp_torch.weights import _to_port_layout, flat_key
    scale = max(float(np.abs(v).max()) for v in flat.values())
    for name, p in port.named_parameters():
        ref = _to_port_layout(name, flat[flat_key(name)], p.ndim)
        got = torch.zeros_like(p) if p.grad is None else p.grad  # the KD head: unused
        close(got, ref, rtol=1e-4, atol=1e-4 * scale)
    port.zero_grad()


def test_minibatch_std_follows_the_jax_grouping():
    from tdgp.models.discriminator import MinibatchStdLayer
    from tdgp_torch.models.discriminator import minibatch_std
    x = np.random.RandomState(6).randn(8, 3, 3, 6).astype(np.float32)
    ref = MinibatchStdLayer(4, 2).apply({}, jnp.asarray(x))
    close(minibatch_std(T(x), 4, 2), ref)


# ------------------------------------------------------------------ ops and blur

@pytest.mark.parametrize('k,bias', [(1, False), (3, True)])
def test_conv2d_resample_down(k, bias):
    rng = np.random.RandomState(k)
    x = rng.randn(2, 12, 12, 5).astype(np.float32)
    w = rng.randn(k, k, 5, 7).astype(np.float32)
    f = jax_setup_filter([1, 3, 3, 1])
    ref = jax_conv2d_resample(jnp.asarray(x), jnp.asarray(w), f=f, down=2, padding=k // 2)
    port = conv2d_resample(T(x), T(w.transpose(3, 2, 0, 1)), f=setup_filter([1, 3, 3, 1]),
                           down=2, padding=k // 2)
    close(port, ref)


def test_upfirdn2d_down_and_filter2d():
    rng = np.random.RandomState(7)
    x = rng.randn(2, 10, 10, 3).astype(np.float32)
    f2 = rng.rand(5, 5).astype(np.float32)
    close(upfirdn2d(T(x), T(f2), down=2, padding=1), jax_upfirdn2d(jnp.asarray(x), jnp.asarray(f2),
                                                                  down=2, padding=1))
    close(filter2d(T(x), T(f2)), jax_filter2d(jnp.asarray(x), jnp.asarray(f2)))


@pytest.mark.parametrize('act', ['relu', 'softplus', 'tanh', 'sigmoid'])
def test_bias_act_activations_with_gain(act):
    rng = np.random.RandomState(8)
    x, b = rng.randn(3, 4, 6).astype(np.float32) * 3, rng.randn(6).astype(np.float32)
    ref = jax_bias_act(jnp.asarray(x), jnp.asarray(b), act=act, gain=0.7, clamp=2.0)
    close(bias_act(T(x), T(b), act=act, gain=0.7, clamp=2.0), ref)


@pytest.mark.parametrize('sigma', [0.0, 2.5])
def test_blur(sigma):
    img = np.random.RandomState(9).randn(2, 16, 16, 4).astype(np.float32)
    ref = jax_blur.blur_depth_channel(jax_blur.maybe_blur(jnp.asarray(img), jnp.asarray(sigma),
                                                          10.0), jnp.asarray(sigma), 10.0)
    port = blur.blur_depth_channel(blur.maybe_blur(T(img), sigma, 10.0), sigma, 10.0)
    close(port, ref)


# ------------------------------------------------------------------ losses

def test_adversarial_and_kd_losses():
    rng = np.random.RandomState(10)
    logits = rng.randn(6).astype(np.float32) * 3
    for kind in ('non_saturating', 'hinge'):
        close(losses.adv_loss_g(T(logits), kind), jax_losses.adv_loss_g(jnp.asarray(logits), kind))
        close(losses.adv_loss_d_fake(T(logits), kind, 2.0),
              jax_losses.adv_loss_d_fake(jnp.asarray(logits), kind, 2.0))
        close(losses.adv_loss_d_real(T(logits), kind, 2.0),
              jax_losses.adv_loss_d_real(jnp.asarray(logits), kind, 2.0))
    feats, embs = rng.randn(6, 5).astype(np.float32), rng.randn(6, 5).astype(np.float32)
    for kind in ('l2', 'kl'):
        close(losses.kd_loss(T(feats), T(embs), kind),
              jax_losses.kd_loss(jnp.asarray(feats), jnp.asarray(embs), kind))
    pp = {'scales': rng.uniform(0.2, 1, (6, 2)).astype(np.float32)}
    close(losses.compute_sample_weights({k: T(v) for k, v in pp.items()}),
          jax_losses.compute_sample_weights({k: jnp.asarray(v) for k, v in pp.items()}))


@pytest.fixture(scope='module')
def adaptor_only():
    """A JAX generator with only its camera adaptor initialised, and a port
    generator holding the same adaptor weights."""
    cfg = dataclasses.replace(
        jcfg.tiny_test_config(),
        generator=dataclasses.replace(
            jcfg.tiny_test_config().generator,
            camera_adaptor=dataclasses.replace(
                jcfg.tiny_test_config().generator.camera_adaptor,
                lipschitz_weights=jcfg.LipschitzCfg(enabled=True, angles=1.0, radius=0.5,
                                                    fov=0.1, look_at=0.2))))
    G = JaxGenerator(cfg.generator)
    prior = jax_camera.sample_camera_params(jax.random.PRNGKey(0),
                                            dataclasses.asdict(cfg.camera), 2)
    z, c = jnp.zeros((2, 32)), jnp.zeros((2, 4))
    g_vars = G.init({'params': jax.random.PRNGKey(2)},
                    method=lambda g: g.synthesis.apply_camera_adaptor(prior, z, c))
    pcfg_ = dataclasses.replace(
        pcfg.tiny_test_config(),
        generator=dataclasses.replace(
            pcfg.tiny_test_config().generator,
            camera_adaptor=dataclasses.replace(
                pcfg.tiny_test_config().generator.camera_adaptor,
                lipschitz_weights=pcfg.LipschitzCfg(enabled=True, angles=1.0, radius=0.5,
                                                    fov=0.1, look_at=0.2))))
    pG = Generator(pcfg_.generator)
    load(pG.synthesis.camera_adaptor, {'params': g_vars['params']['synthesis']['camera_adaptor']})
    return cfg, G, g_vars, pcfg_, pG


def _prior_batch(key, n, cfg):
    """The z, labels and prior cameras a camera regularizer draws from `key`."""
    k_z, k_c, k_cam = jax.random.split(key, 3)
    gc = cfg.generator
    cam = jax_camera.sample_camera_params(k_cam, dataclasses.asdict(cfg.camera), n)
    return (T(jax.random.normal(k_z, (n, gc.z_dim))),
            T(jax_patch.sample_random_c(k_c, n, gc.c_dim)),
            TensorGroup(**{k: T(cam[k]) for k in ('angles', 'fov', 'radius', 'look_at')}))


@pytest.mark.parametrize('reg', ['emd', 'force_mean', 'lipschitz'])
def test_camera_regularizers_and_their_gradients(adaptor_only, reg):
    """The Lipschitz penalty's gradient is held to rtol 1e-3: its 1 / (|d| + 1e-4)
    terms amplify the rounding of near-zero derivatives, which JAX takes in
    forward mode (jacfwd) and the port in reverse mode."""
    cfg, G, g_vars, pcfg_, pG = adaptor_only
    key = jax.random.PRNGKey(11)
    sched = jax_schedules(cfg, 300_000)
    fn = {'emd': lambda p: jax_losses.camera_emd_reg(G, {'params': p}, sched, key, cfg)[0],
          'force_mean': lambda p: jax_losses.camera_force_mean_reg(G, {'params': p}, key, cfg)[0],
          'lipschitz': lambda p: jax_losses.camera_lipschitz_reg(G, {'params': p}, key, cfg)[0]}
    ref, ref_grads = jax.jit(jax.value_and_grad(fn[reg]))(g_vars['params'])
    n = cfg.generator.camera_adaptor.emd.num_samples if reg == 'emd' else 256
    draws = Replay({'batch': _prior_batch(key, n, cfg)})
    psched = compute_schedules(pcfg_, 300_000)
    port = {'emd': lambda: losses.camera_emd_reg(pG, psched, pcfg_, draws)[0],
            'force_mean': lambda: losses.camera_force_mean_reg(pG, pcfg_, draws)[0],
            'lipschitz': lambda: losses.camera_lipschitz_reg(pG, pcfg_, draws)[0]}[reg]()
    port.backward()
    close(port, ref)
    flat = flatten_tree({'params': jax.device_get(ref_grads)['synthesis']['camera_adaptor']})
    from tdgp_torch.weights import _to_port_layout, flat_key
    scale = max(float(np.abs(v).max()) for v in flat.values())
    for name, p in pG.synthesis.camera_adaptor.named_parameters():
        ref_g = _to_port_layout(name, flat[flat_key(name)], p.ndim)
        close(p.grad, ref_g, rtol=1e-3 if reg == 'lipschitz' else 1e-4, atol=1e-4 * scale)
    pG.zero_grad()


# ------------------------------------------------------------------ optimizers and entry point

def test_adam_steps_match_optax():
    cfg = fp32_d(pcfg.tiny_test_config())
    g_tx, d_tx = jax_make_optimizers(fp32_d(jcfg.tiny_test_config()))
    rng = np.random.RandomState(12)
    for which, tx in ((0, g_tx), (1, d_tx)):
        p0 = rng.randn(5, 3).astype(np.float32)
        grads = [rng.randn(5, 3).astype(np.float32) for _ in range(3)]
        params, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
        for g in grads:
            upd, state = tx.update(jnp.asarray(g), state, params)
            params = optax.apply_updates(params, upd)
        pt = torch.nn.Parameter(T(p0))
        plist = torch.nn.ParameterList([pt])
        opt = make_optimizers(cfg, plist, plist)[which]
        for g in grads:
            pt.grad = T(g)
            opt.step()
        close(pt, params, rtol=1e-6, atol=1e-6)


def test_trainer_needs_a_card_unless_given_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(fp32_d(pcfg.tiny_test_config()))


@pytest.mark.parametrize('setting,override', [
    ('training.augment.mode', 'training.augment.mode=adaptive'),
    ('loss.pl_weight with training.gmain_render_bf16',
     'loss.pl_weight=2.0 training.gmain_render_bf16=true'),
    ('num_devices', 'num_devices=4')])
def test_trainer_refuses_unported_settings(setting, override):
    """`override` holds one or more overrides, space-separated."""
    cfg = pcfg.apply_overrides(fp32_d(pcfg.tiny_test_config()), override.split())
    with pytest.raises(NotImplementedError, match=re.escape(setting)):
        Trainer(cfg, 'cpu')


def test_dmain_fake_bf16_with_reused_fakes_warns_as_jax():
    """With Dmain reusing Gmain's fakes (the default) there is no Dmain
    render for the bf16 view: the JAX step warns that the setting has no
    effect, and so does the port, which then builds no view."""
    cfg = pcfg.apply_overrides(fp32_d(pcfg.tiny_test_config()), ['training.dmain_fake_bf16=true'])
    with pytest.warns(UserWarning, match='dmain_fake_bf16 has no effect'):
        trainer = Trainer(cfg, 'cpu')
    assert trainer.G_fake is trainer.G


@pytest.mark.parametrize('setting', ['plane_sample_impl', 'ray_march_impl'])
def test_plain_impl_is_refused_off_the_cpu(setting):
    """'jnp', the JAX package's name for its plain path, is the plain version
    on CPU tensors (as 'fused' is there); on any other device the kernels
    run, and 'jnp' is refused. Meta tensors stand in for the card's."""
    meta = torch.device('meta')
    cfg = pcfg.apply_overrides(pcfg.tiny_test_config(), [f'generator.{setting}=jnp'])
    synthesis = Generator(cfg.generator).synthesis
    if setting == 'plane_sample_impl':
        assert callable(synthesis._sample_fn(torch.device('cpu')))
        with pytest.raises(NotImplementedError, match="'jnp'"):
            synthesis._sample_fn(meta)
        return
    opts = synthesis.render_opts()
    assert opts.march_impl == 'jnp'
    colors, densities = torch.rand(2, 3, 4, 3), torch.rand(2, 3, 4)
    depths = torch.linspace(0.8, 1.2, 4).expand(2, 3, 4).contiguous()
    ref = renderer.march_reduced(colors, densities, depths, dataclasses.replace(
        opts, march_impl='fused'))
    for a, b in zip(renderer.march_reduced(colors, densities, depths, opts), ref):
        assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="'jnp'"):
        renderer.march_reduced(*(t.to(meta) for t in (colors, densities, depths)), opts)
