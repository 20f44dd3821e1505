"""The settings that the port trains and renders as the JAX package does,
held module by module against `tdgp` on the CPU: the generator's
`architecture` (JAX always builds the skip decoder), the Fourier camera
encoding (`generator.camera_cond_raw=false`), D's `camera_cond`, tri-plane
MLPs of 3 layers, the mip marcher, the `discrete_uniform` patch scales, the
`hybrid` and `custom` angle distributions, G's gradient clip and R1's
rematerialization; and the y row JAX's rays take.

The generators are `tiny_test_config`'s (float32), initialised by JAX and
carried into the port by `tdgp_torch.weights.load_flat`; the served image
(`tdgp.serving.make_serving_fn`, JAX's jnp marcher) is held at rtol = atol
= 1e-4, and so are D's logits, the mapping and the marchers. Draws are fed
from outside: JAX's, recomputed from its keys, replayed into the port.
"""
import dataclasses
import math

import numpy as np
import optax
import pytest
import torch
from flax import traverse_util
from flax.core.scope import LazyRng
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from tdgp import serving as jax_serving
from tdgp.config import asdict
from tdgp.config import tiny_test_config as jax_tiny
from tdgp.infra.experiment import apply_overrides as jax_apply_overrides
from tdgp.models.discriminator import Discriminator as JaxDiscriminator
from tdgp.models.epigraf import Generator as JaxGenerator
from tdgp.models import layers as jax_layers
from tdgp.rendering import camera as jax_camera
from tdgp.rendering import renderer as jax_renderer
from tdgp.training import patch as jax_patch
from tdgp.utils.tensor_group import TensorGroup as JaxTensorGroup

from tdgp_torch import serving
from tdgp_torch.config import apply_overrides, tiny_test_config
from tdgp_torch.models import layers
from tdgp_torch.models.discriminator import Discriminator
from tdgp_torch.models.epigraf import Generator
from tdgp_torch.rendering import camera, renderer
from tdgp_torch.training import patch
from tdgp_torch.training.train_step import Trainer, _clip
from tdgp_torch.utils.draws import Draws, Replay
from tdgp_torch.weights import load_flat

TOL = dict(rtol=1e-4, atol=1e-4)


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


def flat_variables(variables):
    return {'/'.join(k): np.asarray(v)
            for k, v in traverse_util.flatten_dict(jax.device_get(variables)).items()}


def _request(seed, n, z_dim, c_dim):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, z_dim).astype(np.float32),
            np.eye(c_dim, dtype=np.float32)[np.arange(n) % c_dim],
            np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(1.3, 1.8, n),
                      np.zeros(n)], 1).astype(np.float32),
            rng.uniform(15, 30, n).astype(np.float32), np.ones(n, np.float32),
            np.stack([rng.uniform(-3, 3, n), rng.uniform(0, 3, n),
                      rng.uniform(0, 0.1, n)], 1).astype(np.float32)]


def jax_generator(overrides):
    """The JAX generator of `tiny_test_config` with `overrides`, initialised
    from fixed keys -> (G, its variables, their flat arrays)."""
    gc = jax_apply_overrides(jax_tiny(), overrides).generator
    G = JaxGenerator(gc)
    z, c, angles, fov, radius, look_at = map(jnp.asarray, _request(0, 2, gc.z_dim, gc.c_dim))
    cam = JaxTensorGroup(angles=angles, fov=fov, radius=radius, look_at=look_at)
    rngs = {k: jax.random.PRNGKey(i + 1)
            for i, k in enumerate(('params', 'noise', 'render', 'depth', 'dropout'))}

    def init_fwd(g):
        g.synthesis.apply_camera_adaptor(cam, z, c)
        return g(z, c, cam, camera_angles_cond=angles, resolution=8)

    g_vars = jax.jit(lambda r: G.init(r, method=init_fwd))(rngs)
    return G, g_vars, flat_variables(g_vars)


def served_pair(overrides):
    """The served image of JAX's generator and of the port's with the same
    weights, on the same request -> (port, JAX, the port's generator)."""
    G, g_vars, flat = jax_generator(overrides)
    port = Generator(apply_overrides(tiny_test_config(), overrides).generator)
    load_flat(port, flat)
    req = _request(3, 2, G.cfg.z_dim, G.cfg.c_dim)
    ref = jax.jit(jax_serving.make_serving_fn(G, g_vars, truncation_psi=0.7))(
        *map(jnp.asarray, req))
    got = serving.make_serving_fn(port.eval(), truncation_psi=0.7)(*req)
    return got.numpy(), np.asarray(ref), port


# ------------------------------------------------------------ the generator

@pytest.mark.parametrize('overrides', [
    ['generator.architecture=orig'],
    ['generator.camera_cond_raw=false'],
    ['generator.tri_plane.mlp.n_layers=3'],
    ['generator.ray_marcher_type=mip'],
    ['generator.ray_marcher_type=mip', 'generator.white_back=true',
     'generator.density_bias=-1.0'],
], ids=['architecture_orig', 'fourier_camera', 'three_layers', 'mip', 'mip_white_bias'])
def test_served_image_matches_jax(overrides):
    """Each setting alone: G built in both packages, JAX's weights carried
    across, the served image at 1e-4. `architecture: orig` builds the skip
    decoder, as `tdgp/models/epigraf.py:147` does whatever the field says."""
    got, ref, _ = served_pair(overrides)
    assert got.shape == ref.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, ref, **TOL)


def test_every_new_parameter_crosses_and_the_forwards_match():
    """One tiny config with every new parameter (G's Fourier camera encoder,
    a 3-layer MLP's fc2, D's camera-conditioned head mapping, whose embed
    takes the two angles, and D's patch encoder's const_embed table) loads
    from JAX's variables, every array used, and G's served image and D's
    logits match."""
    overrides = ['generator.camera_cond_raw=false', 'generator.tri_plane.mlp.n_layers=3',
                 'discriminator.camera_cond=true']
    got, ref, port = served_pair(overrides)
    np.testing.assert_allclose(got, ref, **TOL)
    names = {n for n, _ in port.named_parameters()}
    assert 'synthesis.tri_plane_mlp.fc2.weight' in names
    assert port.mapping.embed.weight.shape[1] == 4 + 24  # c_dim + 2 angles x 12 features
    jd, d_vars, pd, inputs = discriminator_pair(overrides)
    assert pd.head_mapping.embed.weight.shape[1] == pd.scalar_enc.out_dim + 4 + 2
    assert pd.scalar_enc.const_embed.embedding.shape == (1001, 256)
    logits = jax.jit(lambda v: jd.apply(v, *inputs[:2], patch_params=inputs[2],
                                        camera_angles=inputs[3], train=True)[0])(d_vars)
    with torch.no_grad():
        port_logits, _ = pd(*[T(x) for x in inputs[:2]],
                            patch_params={k: T(v) for k, v in inputs[2].items()},
                            camera_angles=T(inputs[3]))
    np.testing.assert_allclose(port_logits.numpy(), np.asarray(logits), **TOL)


def test_fourier_camera_encoding_matches_jax():
    """`ScalarEncoder1d(2, 64, 0)` of the mapping (6 frequencies, sin then
    cos) and `ScalarEncoder1d(3, 1000, 256)` with its const_embed table, on
    the same inputs and table."""
    rs = np.random.RandomState(0)
    x = rs.uniform(-1, 1, (5, 2)).astype(np.float32)
    ref = jax_layers.ScalarEncoder1d(2, 64.0, 0).apply({}, jnp.asarray(x))
    enc = layers.ScalarEncoder1d(2, 64.0, 0)
    assert enc.out_dim == 24
    np.testing.assert_allclose(enc(T(x)).numpy(), np.asarray(ref), **TOL)
    x3 = rs.uniform(0, 1, (5, 3)).astype(np.float32)
    jenc = jax_layers.ScalarEncoder1d(3, 1000.0, 256)
    v = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x3))
    enc3 = layers.ScalarEncoder1d(3, 1000.0, 256)
    load_flat(enc3, flat_variables(v))
    np.testing.assert_allclose(enc3(T(x3)).detach().numpy(), np.asarray(jenc.apply(v, x3)),
                               **TOL)


def test_mapping_with_fourier_camera_and_dropout_matches_jax():
    """G's mapping with the Fourier camera encoding and camera_cond_drop_p:
    JAX's dropout mask replayed as the draw 'cond_drop' (flax's bernoulli is
    a uniform below the keep probability)."""
    gc = jax_apply_overrides(jax_tiny(), ['generator.camera_cond_raw=false',
                                          'generator.camera_cond_drop_p=0.5']).generator
    G = JaxGenerator(gc)
    z, c, angles = map(jnp.asarray, _request(1, 4, gc.z_dim, gc.c_dim)[:3])
    v = G.init(jax.random.PRNGKey(0), z, c, camera_angles=angles, train=True,
               method=lambda g, *a, **k: g.mapping(*a, **k))
    key = jax.random.PRNGKey(5)
    ref = G.apply(v, z, c, camera_angles=angles, train=True, rngs={'dropout': key},
                  method=lambda g, *a, **k: g.mapping(*a, **k))
    port = Generator(apply_overrides(tiny_test_config(), ['generator.camera_cond_raw=false',
                                                          'generator.camera_cond_drop_p=0.5'
                                                          ]).generator).mapping
    load_flat(port, {k.replace('/mapping/', '/', 1): a for k, a in flat_variables(v).items()})
    drop_key = LazyRng.create(key, 'mapping', 'Dropout_0', 1).as_jax_rng()
    draws = Replay({'cond_drop': T(jax.random.uniform(drop_key, (4, 24)))})
    got = port(T(z), T(c), camera_angles=T(angles), draws=draws)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


def test_three_layer_mlp_without_gradients_matches_jax():
    """The 3-layer MLP runs as its layers without gradients, as JAX's
    `TriPlaneMLP` runs it, on the same features and weights; and under
    the mip marcher with the MipNeRF colour clamp."""
    for marcher in ('classical', 'mip'):
        overrides = ['generator.tri_plane.mlp.n_layers=3',
                     f'generator.ray_marcher_type={marcher}']
        G, g_vars, flat = jax_generator(overrides)
        port = Generator(apply_overrides(tiny_test_config(), overrides).generator)
        load_flat(port, flat)
        feats = np.random.RandomState(2).randn(2, 7, 8).astype(np.float32)
        rgb, sigma = G.apply(g_vars, jnp.asarray(feats),
                             method=lambda g, x: g.synthesis.tri_plane_mlp(x))
        with torch.no_grad():
            prgb, psigma = port.synthesis.tri_plane_mlp(T(feats))
        np.testing.assert_allclose(prgb.numpy(), np.asarray(rgb), **TOL)
        np.testing.assert_allclose(psigma.numpy(), np.asarray(sigma), **TOL)


# ------------------------------------------------------------ D's camera_cond

def discriminator_pair(overrides):
    """JAX's D at float32 and the port's with JAX's weights -> (JAX D, its
    variables, the port's D, inputs (img, c, patch params, camera angles))."""
    overrides = list(overrides) + ['discriminator.fp32_only=true']
    dc = jax_apply_overrides(jax_tiny(), overrides).discriminator
    rs = np.random.RandomState(4)
    n, res = 4, dc.input_resolution
    img = rs.uniform(-1, 1, (n, res, res, dc.img_channels)).astype(np.float32)
    c = np.eye(4, dtype=np.float32)[np.arange(n) % 4]
    s = np.repeat(rs.uniform(0.3, 1, (n, 1)), 2, 1).astype(np.float32)
    pp = {'scales': s, 'offsets': (rs.uniform(0, 1, (n, 2)) * (1 - s)).astype(np.float32)}
    angles = np.stack([rs.uniform(-4, 4, n), rs.uniform(0.5, 2.5, n), np.zeros(n)],
                      1).astype(np.float32)
    jd = JaxDiscriminator(dc)
    d_vars = jax.jit(lambda k: jd.init({'params': k}, img, c, patch_params=pp,
                                       camera_angles=angles, predict_feat=True,
                                       train=True))(jax.random.PRNGKey(1))
    pd = Discriminator(apply_overrides(tiny_test_config(), overrides).discriminator)
    load_flat(pd, flat_variables(d_vars))
    return jd, d_vars, pd, (img, c, pp, angles)


@pytest.mark.parametrize('overrides', [
    ['discriminator.camera_cond=true'],
    ['discriminator.camera_cond=true', 'discriminator.c_dim=0',
     'discriminator.patch.patch_params_cond=false', 'discriminator.hyper_mod=false'],
], ids=['with_labels_and_patches', 'angles_alone'])
def test_camera_conditioned_discriminator_matches_jax(overrides):
    """D's head mapping takes yaw and pitch wrapped into [-1, 1] as raw
    scalars; the logits and their gradient with respect to the angles (which
    Gmain takes back into the camera adaptor) at 1e-4."""
    jd, d_vars, pd, (img, c, pp, angles) = discriminator_pair(overrides)
    c_in = c if pd.cfg.c_dim else np.zeros((4, 0), np.float32)

    def jax_logits(a):
        return jd.apply(d_vars, img, c_in, patch_params=pp, camera_angles=a, train=True)[0]

    ref = jax_logits(angles)
    ref_grad = jax.grad(lambda a: jax_logits(a).sum())(angles)
    a = T(angles).requires_grad_(True)
    got, _ = pd(T(img), T(c_in), patch_params={k: T(v) for k, v in pp.items()}, camera_angles=a)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(ref_grad), **TOL)


def test_camera_cond_dropout_in_d_needs_a_draw_as_jax():
    """With camera_cond_drop_p > 0 JAX's training D raises for want of a
    dropout key, which the step does not give it; the port raises without
    draws and, given JAX's mask as the draw 'cond_drop', matches JAX."""
    overrides = ['discriminator.camera_cond=true', 'discriminator.camera_cond_drop_p=0.5']
    jd, d_vars, pd, (img, c, pp, angles) = discriminator_pair(overrides)
    tpp = {k: T(v) for k, v in pp.items()}
    with pytest.raises(Exception, match='dropout'):
        jd.apply(d_vars, img, c, patch_params=pp, camera_angles=angles, train=True)
    with pytest.raises(ValueError, match='cond_drop'):
        pd(T(img), T(c), patch_params=tpp, camera_angles=T(angles))
    key = jax.random.PRNGKey(3)
    ref = jd.apply(d_vars, img, c, patch_params=pp, camera_angles=angles, train=True,
                   rngs={'dropout': key})[0]
    mask_key = LazyRng.create(key, 'head_mapping', 'Dropout_0', 1).as_jax_rng()
    draws = Replay({'cond_drop': T(jax.random.uniform(mask_key, (4, 2)))})
    with torch.no_grad():
        got, _ = pd(T(img), T(c), patch_params=tpp, camera_angles=T(angles), draws=draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


# ------------------------------------------------------------ marchers

def _march_inputs(seed=0, b=2, r=5, s=8, c=3):
    rs = np.random.RandomState(seed)
    return (rs.rand(b, r, s, c).astype(np.float32), rs.randn(b, r, s).astype(np.float32),
            np.sort(rs.uniform(0.75, 1.25, (b, r, s)), -1).astype(np.float32))


@pytest.mark.parametrize('use_inf_depth', [True, False])
@pytest.mark.parametrize('white_back,density_bias,cut', [
    (False, 0.0, 0.0), (True, 0.0, 0.0), (False, -1.0, 0.0), (False, 0.0, 0.5)])
def test_mip_ray_march_matches_jax(use_inf_depth, white_back, density_bias, cut):
    colors, densities, depths = _march_inputs()
    kw = dict(ray_marcher_type='mip', white_back=white_back, density_bias=density_bias,
              cut_quantile=cut, use_inf_depth=use_inf_depth)
    ref = jax.jit(lambda a, b, z: jax_renderer.mip_ray_march(
        a, b, z, jax_renderer.RenderOptions(**kw)))(colors, densities, depths)
    got = renderer.mip_ray_march(T(colors), T(densities), T(depths),
                                 renderer.RenderOptions(**kw))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def test_mip_samplers_match_jax():
    """The mip stratified samples (jittered and at eval) and the importance
    sampler's smoothed weights, with JAX's u."""
    b, r, s = 2, 5, 8
    key = jax.random.PRNGKey(1)
    ref = jax_renderer.sample_stratified(key, b, r, s, 'mip', 0.0, 1.0, jitter=True)
    jit = T(jax.random.uniform(key, (b, r, s)))
    got = renderer.sample_stratified(b, r, s, 'cpu', jitter=jit, ray_marcher_type='mip')
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    ref = jax_renderer.sample_stratified(key, b, r, s, 'mip', 0.0, 1.0, jitter=False)
    got = renderer.sample_stratified(b, r, s, 'cpu', ray_marcher_type='mip')
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    z = np.asarray(ref)
    w = np.random.RandomState(0).rand(b, r, s).astype(np.float32)
    ref = jax_renderer.sample_importance(key, z, w, 6, 'mip')
    u = T(jax.random.uniform(key, (b * r, 6)))
    got = renderer.sample_importance(T(z), T(w), 6, u_rand=u, ray_marcher_type='mip')
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_mip_render_merges_and_marches_in_torch_on_any_device(monkeypatch):
    """K3 is classical only: the mip render merges by `unify_samples_sorted`
    and marches in PyTorch whether autograd records or not, on CPU tensors
    and off them (meta tensors stand in for the card's); no K3 entry runs."""
    def no_k3(*args, **kwargs):
        raise AssertionError('K3 called under the mip marcher')

    for name in ('ray_march_merged', 'ray_march_merged_cut', 'ray_march_reduced'):
        monkeypatch.setattr(renderer, name, no_k3)
    opts = renderer.RenderOptions(ray_marcher_type='mip', num_proposal_steps=4,
                                  num_fine_steps=4)
    for device in ('cpu', 'meta'):
        def run_model(coords):
            n, p, _ = coords.shape
            return torch.zeros(n, p, 3, device=device), coords.sum(-1)

        o = torch.zeros(1, 6, 3, device=device)
        d = torch.ones(1, 6, 3, device=device) / math.sqrt(3)
        rgb, depth, wsum, ftrans = renderer.importance_render(run_model, o, d, opts)
        assert rgb.shape == (1, 6, 3) and depth.shape == wsum.shape == (1, 6)


# ------------------------------------------------------------ patches and cameras

def _patch_cfg(dist, support=()):
    return dataclasses.replace(tiny_test_config().generator.patch, distribution=dist,
                               discrete_support=tuple(support))


@pytest.mark.parametrize('min_scale', [0.125, 0.3, 0.6])
def test_discrete_uniform_patches_match_jax(min_scale):
    """The support outside [min_scale, max_scale] is masked and one value is
    drawn per group: JAX's categorical index, fed as the draw 'scale_index'
    (its position among the values in range), gives JAX's scales and
    offsets, repeated over each group."""
    support = (0.125, 0.25, 0.5, 0.75, 1.0)
    jcfg = dataclasses.replace(jax_tiny().generator.patch, distribution='discrete_uniform',
                               discrete_support=support)
    key = jax.random.PRNGKey(11)
    n = 8
    groups = n // jcfg.mbstd_group_size
    ref = jax_patch.sample_patch_params(key, n, jcfg, min_scale=min_scale)
    k_scale, k_off = jax.random.split(key)
    valid = [i for i, v in enumerate(support) if np.float32(v) >= np.float32(min_scale)]
    logits = jnp.where(jnp.isin(jnp.arange(len(support)), jnp.asarray(valid)), 0.0, -jnp.inf)
    picked = jax.random.categorical(k_scale, jnp.broadcast_to(logits, (groups, len(support))))
    draws = Replay({'scale_index': T([valid.index(int(i)) for i in picked]),
                    'offset': T(jax.random.uniform(k_off, (groups, 2)))})
    got = patch.sample_patch_params(draws, n, _patch_cfg('discrete_uniform', support),
                                    min_scale=min_scale)
    for k in ('scales', 'offsets'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), **TOL)
    assert set(np.unique(got['scales'].numpy())) <= {np.float32(support[i]) for i in valid}


def test_discrete_uniform_draws_only_scales_in_range():
    support = (0.1, 0.25, 0.5, 2.0)
    cfg = _patch_cfg('discrete_uniform', support)
    draws = Draws(torch.Generator().manual_seed(0))
    scales = patch.sample_patch_params(draws, 4000, cfg, min_scale=0.2)['scales'][:, 0]
    values, counts = np.unique(scales.numpy(), return_counts=True)
    np.testing.assert_array_equal(values, np.float32([0.25, 0.5]))
    assert abs(counts[0] - counts[1]) < 0.1 * counts.sum()


@pytest.mark.parametrize('min_scale', [0.25, 0.6])
def test_discrete_uniform_with_an_empty_support_is_the_uniform_draw(min_scale):
    """An empty `discrete_support` falls back to the uniform draw: the same
    draws give the same patches as `distribution: uniform`, and JAX's."""
    values = {'scale': T(np.random.RandomState(1).rand(2).astype(np.float32)),
              'offset': T(np.random.RandomState(2).rand(2, 2).astype(np.float32))}
    got = patch.sample_patch_params(Replay(values), 4, _patch_cfg('discrete_uniform'),
                                    min_scale)
    ref = patch.sample_patch_params(Replay(values), 4, _patch_cfg('uniform'), min_scale)
    for k in ('scales', 'offsets'):
        assert torch.equal(got[k], ref[k])
    jcfg = dataclasses.replace(jax_tiny().generator.patch, distribution='discrete_uniform')
    key = jax.random.PRNGKey(2)
    jref = jax_patch.sample_patch_params(key, 4, jcfg, min_scale=min_scale)
    k_scale, k_off = jax.random.split(key)
    g = jcfg.mbstd_group_size
    got = patch.sample_patch_params(
        Replay({'scale': T(jax.random.uniform(k_scale, (4 // g,))),
                'offset': T(jax.random.uniform(k_off, (4 // g, 2)))}), 4,
        _patch_cfg('discrete_uniform'), min_scale)
    for k in ('scales', 'offsets'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(jref[k]), **TOL)


def _angles_cfg(dist):
    a = jax_tiny().camera.origin.angles
    yaw = dataclasses.replace(a.yaw, mean=0.3, std=0.4)
    pitch = dataclasses.replace(a.pitch, mean=1.5, std=0.2)
    return dataclasses.replace(a, dist=dist, yaw=yaw, pitch=pitch)


def hybrid_draws(key, n):
    """JAX's hybrid draws from `key`, under the port's names."""
    k_yaw, k_pitch, k_sel = jax.random.split(key, 3)
    kn_yaw, kn_pitch = jax.random.split(jax.random.fold_in(key, 1))
    return {'yaw': T(jax.random.uniform(k_yaw, (n,))),
            'pitch': T(jax.random.uniform(k_pitch, (n,))),
            'normal/yaw': T(jax.random.normal(kn_yaw, (n,))),
            'normal/pitch': T(jax.random.normal(kn_pitch, (n,))),
            'select': T(jax.random.uniform(k_sel, ()))}


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_hybrid_angles_match_jax_and_select_once_per_batch(seed):
    """'hybrid' draws the whole batch from the wide uniform or from the
    normal: one selection per batch (the keys 0-3 take both branches)."""
    cfg = _angles_cfg('hybrid')
    key = jax.random.PRNGKey(seed)
    ref = jax_camera.sample_camera_angles(key, asdict(cfg), 16)
    values = hybrid_draws(key, 16)
    got = camera.sample_camera_angles(Replay(values), cfg, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    take_uniform = float(values['select']) < 0.5
    spread = 2 * cfg.yaw.std
    inside = (got[:, 0] - cfg.yaw.mean).abs() <= spread + 1e-6
    if take_uniform:
        assert bool(inside.all())
    u_yaw = (values['yaw'] - 0.5) * 2 * cfg.yaw.std * 2 + cfg.yaw.mean
    n_yaw = values['normal/yaw'] * cfg.yaw.std + cfg.yaw.mean
    assert torch.equal(got[:, 0], u_yaw if take_uniform else n_yaw)


def test_hybrid_keys_take_both_branches():
    picks = {float(jax.random.uniform(jax.random.split(jax.random.PRNGKey(s), 3)[2], ())) < 0.5
             for s in range(4)}
    assert picks == {True, False}


def test_custom_angles_come_from_the_dataset_as_in_jax():
    """'custom' has nothing to draw: both packages raise without the
    dataset's angles and take them as they are given."""
    cfg = dataclasses.replace(jax_tiny().camera, origin=dataclasses.replace(
        jax_tiny().camera.origin, angles=_angles_cfg('custom')))
    pcfg = dataclasses.replace(tiny_test_config().camera, origin=dataclasses.replace(
        tiny_test_config().camera.origin, angles=_angles_cfg('custom')))
    with pytest.raises(ValueError, match='custom'):
        jax_camera.sample_camera_params(jax.random.PRNGKey(0), asdict(cfg), 4)
    with pytest.raises(ValueError, match='custom'):
        camera.sample_camera_params(Draws(torch.Generator()), pcfg, 4)
    angles = np.stack([np.linspace(-1, 1, 4), np.full(4, 1.2), np.zeros(4)], 1).astype(np.float32)
    got = camera.sample_camera_params(Draws(torch.Generator()), pcfg, 4,
                                      origin_angles=T(angles))
    assert torch.equal(got.angles, T(angles))


def test_custom_angles_reach_the_step():
    """A step with 'custom' angles (and `training.learn_camera_dist=false`:
    the camera regularizers draw prior cameras, which 'custom' has not, in
    the JAX package too) renders Gmain's and Dmain's fakes from the batch's
    'gen_camera_angles_g' / '_d', as the JAX step's `_sample_gen_inputs`
    takes them; the cameras equal JAX's `sample_camera_params` with those
    origin angles."""
    from tdgp_torch import profile_training
    from tdgp_torch.training import losses
    from tdgp_torch.training.schedules import compute_schedules
    overrides = ['camera.origin.angles.dist=custom', 'training.learn_camera_dist=false',
                 'training.dmain_reuse_fakes=false', 'discriminator.fp32_only=true']
    cfg = apply_overrides(tiny_test_config(), overrides)
    trainer = Trainer(cfg, 'cpu', seed=0)
    batch = profile_training.make_batch(cfg, 4, 0, 'cpu')
    rs = np.random.RandomState(0)
    given = {k: T(np.stack([rs.uniform(-3, 3, 4), rs.uniform(1, 2, 4), np.zeros(4)],
                           1).astype(np.float32))
             for k in ('gen_camera_angles_g', 'gen_camera_angles_d')}
    seen, g_forward = [], losses.g_forward

    def recorded(G, z, c, cam, *args, **kwargs):
        seen.append(cam.angles)
        return g_forward(G, z, c, cam, *args, **kwargs)

    losses.g_forward = recorded
    try:
        stats = trainer.step({**batch, **given}, compute_schedules(cfg, 300_000), True,
                             Draws(torch.Generator().manual_seed(0)))
    finally:
        losses.g_forward = g_forward
    assert all(torch.isfinite(v) for v in stats.values())
    assert torch.equal(seen[0], given['gen_camera_angles_g'])
    assert torch.equal(seen[1], given['gen_camera_angles_d'])
    jcfg = jax_apply_overrides(jax_tiny(), overrides)
    ref = jax_camera.sample_camera_params(jax.random.PRNGKey(0), asdict(jcfg.camera), 4,
                                          origin_angles=jnp.asarray(given['gen_camera_angles_g']))
    np.testing.assert_array_equal(np.asarray(ref.angles), given['gen_camera_angles_g'].numpy())


@pytest.mark.parametrize('dist', ['hybrid', 'custom'])
def test_mean_and_max_helpers_raise_as_jax(dist):
    """`get_mean_angles_values`, `get_mean_sampling_value` and
    `get_max_sampling_value` have no value for these distributions in the
    JAX package (`tdgp/rendering/camera.py:135-162`): both raise the same
    NotImplementedError, so the camera adaptor's force-mean regularizer
    needs `force_mean_weight=0` with them, in both packages."""
    cfg = _angles_cfg(dist)
    for jfn, pfn, arg in ((jax_camera.get_mean_angles_values, camera.get_mean_angles_values, cfg),
                          (jax_camera.get_mean_sampling_value, camera.get_mean_sampling_value,
                           dataclasses.replace(cfg.yaw, dist=dist)),
                          (jax_camera.get_max_sampling_value, camera.get_max_sampling_value,
                           dataclasses.replace(cfg.yaw, dist=dist))):
        with pytest.raises(NotImplementedError, match=dist):
            jfn(asdict(arg))
        with pytest.raises(NotImplementedError, match=dist):
            pfn(arg)


# ------------------------------------------------------------ the rays' rows

def test_negated_row_is_not_the_reversed_row():
    """`jnp.linspace(1, -1, h)` under `jit`, the rays' y row, is the negated
    row of `jnp.linspace(-1, 1, h)` (`utils.xla_float.linspace_row`); the
    reversed row differs from it at 64 and 256 (and agrees at 2, 3 and
    17). The port's rays still take `torch.linspace`'s rows (ROADMAP §3)."""
    from tdgp_torch.utils.xla_float import linspace_row
    for h in (2, 3, 17, 64, 256):
        ref = np.asarray(jax.jit(lambda: jnp.linspace(1.0, -1.0, h))())
        np.testing.assert_array_equal((-linspace_row(h)).numpy(), ref)
        assert np.array_equal(linspace_row(h).flip(0).numpy(), ref) == (h in (2, 3, 17))


# ------------------------------------------------------------ the step's pieces

def _grad_tree(seed, scale):
    rs = np.random.RandomState(seed)
    return {'a': (rs.randn(3, 4) * scale).astype(np.float32),
            'b': {'c': (rs.randn(7) * scale).astype(np.float32)},
            'd': np.zeros(2, np.float32)}


@pytest.mark.parametrize('max_norm', [0.5, 3.0, 100.0])
def test_grad_clip_is_optaxs(max_norm):
    """`_clip` against `optax.clip_by_global_norm` above and below the
    threshold (the trees' norm is ~4.5): g / norm x max_norm above, no
    epsilon, unchanged below; `clip_grad_norm_`'s max_norm / (norm + 1e-6)
    is not this rule."""
    tree = _grad_tree(0, 1.0)
    ref, _ = optax.clip_by_global_norm(max_norm).update(tree, optax.EmptyState())
    ref = traverse_util.flatten_dict(ref, sep='/')
    params = [torch.nn.Parameter(torch.zeros(v.shape)) for v in
              traverse_util.flatten_dict(tree, sep='/').values()]
    for p, v in zip(params, traverse_util.flatten_dict(tree, sep='/').values()):
        p.grad = T(v)
    norm = math.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                         for v in traverse_util.flatten_dict(tree, sep='/').values()))
    factor = _clip(params, max_norm)
    for p, v in zip(params, ref.values()):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(v), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(factor), min(1.0, max_norm / norm), rtol=1e-6)
    assert (max_norm < norm) == (float(factor) < 1.0)


def test_r1_remat_recomputes_d_and_changes_no_number():
    """One R1 step with and without `loss.r1_remat` from the same weights and
    draws: R1's gradient is the same, bit for bit, and D's forward runs more
    often with it (counted on `D.forward`; module hooks do not fire in a
    checkpoint's recomputation): once without, three times with, the
    forward and its recomputation in each of R1's two backwards (the
    gradient with respect to the image, with `create_graph`, and the
    gradient of the penalty)."""
    cfg = apply_overrides(tiny_test_config(), ['discriminator.fp32_only=true'])
    from tdgp_torch import profile_training
    from tdgp_torch.training.schedules import compute_schedules
    sched = compute_schedules(cfg, 300_000)
    results = {}
    for remat in (False, True):
        c = apply_overrides(cfg, [f'loss.r1_remat={str(remat).lower()}'])
        trainer = Trainer(c, 'cpu', seed=0)
        calls, forward = [], trainer.D.forward

        def counted(*args, **kwargs):
            calls.append(1)
            return forward(*args, **kwargs)

        r1 = {}
        orig = trainer._r1

        def counted_r1(*args, **kwargs):
            trainer.D.forward = counted
            try:
                orig(*args, **kwargs)
            finally:
                del trainer.D.forward
            r1['d_forwards'] = len(calls)

        trainer._r1 = counted_r1
        batch = profile_training.make_batch(c, 4, 0, 'cpu')
        stats = trainer.step(batch, sched, True, Draws(torch.Generator().manual_seed(1)),
                             return_grads=True)
        results[remat] = (stats['_grads']['r1'], r1['d_forwards'])
    assert (results[False][1], results[True][1]) == (1, 3)
    for name, g in results[False][0].items():
        assert torch.equal(results[True][0][name], g), name
