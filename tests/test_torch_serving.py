"""The served generator: port (tdgp_torch) vs JAX package (tdgp) on the CPU.

Quick tier: the JAX `Generator` on `tiny_test_config` (fp32) is initialised
from fixed keys, its variables are flattened to numpy and loaded through
`tdgp_torch.weights`, and the port's serving function is held against
`tdgp.serving.make_serving_fn` on the same z, c, cameras and psi = 0.7. The
JAX side runs with `ray_march_impl='fused'` under Pallas interpret mode, so
its final march goes through the TPU kernel K3; the port's wrapper takes its
plain version for CPU tensors. Mapping and plane decoding are compared on
their own too, so that a failure names its module. The weight bridge is
checked on the trained flagship npz at full width.

Slow tier: the trained flagship at full width, JAX vs port, at a 64x64 output.
rtol = atol = 1e-4 throughout (XLA:CPU vs PyTorch float32 skew,
tests/conftest.py:18-33).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util
from jax.experimental.pallas import tpu as pltpu

from tdgp import serving as jax_serving
from tdgp.checkpoint import variables_from_flat
from tdgp.config import replace as jax_replace
from tdgp.config import tiny_test_config as jax_tiny_test_config
from tdgp.infra.experiment import load_config as jax_load_config
from tdgp.models.epigraf import Generator as JaxGenerator

from tdgp_torch import serving
from tdgp_torch.config import load_config, tiny_test_config
from tdgp_torch.models.epigraf import Generator
from tdgp_torch.weights import flat_key, load_flat

TOL = dict(rtol=1e-4, atol=1e-4)
RUN_DIR = os.path.join(os.path.dirname(__file__), '..', 'experiments',
                       'synth256-3dgp-p64-b16-8839f23-r5-flagship')
FP32 = ['generator.fp32_only=true']


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _request(seed, n, z_dim, c_dim):
    """z, one-hot c and cameras around the mean camera, as numpy float32."""
    rng = np.random.RandomState(seed)
    return dict(
        z=rng.randn(n, z_dim).astype(np.float32),
        c=np.eye(c_dim, dtype=np.float32)[np.arange(n) % c_dim],
        angles=np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(1.3, 1.8, n),
                         np.zeros(n)], 1).astype(np.float32),
        fov=rng.uniform(15, 30, n).astype(np.float32),
        radius=np.ones(n, np.float32),
        look_at=np.stack([rng.uniform(-3, 3, n), rng.uniform(0, 3, n),
                          rng.uniform(0, 0.1, n)], 1).astype(np.float32))


def _args(req):
    return [req[k] for k in ('z', 'c', 'angles', 'fov', 'radius', 'look_at')]


@pytest.fixture(scope='module')
def tiny():
    """(JAX generator, its variables, their flat numpy arrays, a request)."""
    gc = jax_tiny_test_config().generator
    G = JaxGenerator(gc)
    req = _request(0, 2, gc.z_dim, gc.c_dim)
    z, c, angles, fov, radius, look_at = map(jnp.asarray, _args(req))
    from tdgp.utils.tensor_group import TensorGroup as JaxTensorGroup
    cam = JaxTensorGroup(angles=angles, fov=fov, radius=radius, look_at=look_at)
    rngs = {k: jax.random.PRNGKey(i + 1)
            for i, k in enumerate(('params', 'noise', 'render', 'depth', 'dropout'))}
    def init_fwd(g):  # the camera adaptor too: the port's Generator holds it
        g.synthesis.apply_camera_adaptor(cam, z, c)
        return g(z, c, cam, camera_angles_cond=angles, resolution=8)

    g_vars = jax.jit(lambda r: G.init(r, method=init_fwd))(rngs)
    flat = {'/'.join(k): np.asarray(v)
            for k, v in traverse_util.flatten_dict(jax.device_get(g_vars)).items()}
    return G, g_vars, flat, req


@pytest.fixture(scope='module')
def tiny_port(tiny):
    G = Generator(tiny_test_config().generator)
    load_flat(G, tiny[2])
    return G.eval()


def test_config_loads_the_flagship_run_as_the_jax_package_does():
    port = load_config(os.path.join(RUN_DIR, 'experiment_config.yaml'), FP32)
    ref = jax_load_config(os.path.join(RUN_DIR, 'experiment_config.yaml'), FP32)
    assert dataclasses.asdict(port.generator) == dataclasses.asdict(ref.generator)
    assert dataclasses.asdict(port.camera) == dataclasses.asdict(ref.camera)


def test_tiny_config_matches_the_jax_package():
    assert (dataclasses.asdict(tiny_test_config().generator)
            == dataclasses.asdict(jax_tiny_test_config().generator))


def test_map_ws_matches_jax(tiny, tiny_port):
    G, g_vars, _, req = tiny
    ref = G.apply(g_vars, jnp.asarray(req['z']), jnp.asarray(req['c']),
                  jnp.asarray(req['angles']), 0.7, method=JaxGenerator.map_ws)
    with torch.no_grad():
        port = tiny_port.map_ws(torch.from_numpy(req['z']), torch.from_numpy(req['c']),
                                torch.from_numpy(req['angles']), truncation_psi=0.7)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **TOL)


def test_decode_planes_matches_jax(tiny, tiny_port):
    G, g_vars, _, _ = tiny
    ws = np.random.RandomState(1).randn(2, tiny_port.synthesis.num_ws,
                                        G.cfg.w_dim).astype(np.float32)
    ref = jax.jit(lambda v, w: G.apply(
        v, w, method=lambda g, w_: g.synthesis.decode_planes(w_, noise_mode='const')))(
        g_vars, jnp.asarray(ws))
    with torch.no_grad():
        port = tiny_port.synthesis.decode_planes(torch.from_numpy(ws))
    assert port.shape == ref.shape
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **TOL)


def test_serving_matches_jax(tiny, tiny_port):
    G, g_vars, _, req = tiny
    G_fused = JaxGenerator(jax_replace(G.cfg, ray_march_impl='fused'))
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(jax_serving.make_serving_fn(G_fused, g_vars, truncation_psi=0.7))(
            *map(jnp.asarray, _args(req)))
        ref = np.asarray(ref)
    port = serving.make_serving_fn(tiny_port, truncation_psi=0.7)(*_args(req))
    assert port.shape == ref.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(port.numpy(), ref, **TOL)


def test_bridge_consumes_every_flagship_array():
    """The trained flagship npz loads into the full-width port model, the
    depth and camera adaptors included: every array is used, and every
    shape matches."""
    cfg = load_config(os.path.join(RUN_DIR, 'experiment_config.yaml'), FP32)
    G = Generator(cfg.generator)
    with np.load(os.path.join(RUN_DIR, serving.WEIGHTS_FILE)) as flat:
        keys = set(flat.files)
        load_flat(G, flat)
        used = {flat_key(name) for name in G.state_dict()}
        assert used == keys
        assert any(k.startswith('params/synthesis/camera_adaptor/') for k in used)
        conv = 'synthesis.tri_plane_decoder.b64.conv0.weight'
        np.testing.assert_array_equal(G.state_dict()[conv].numpy(),
                                      flat[flat_key(conv)].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(G.mapping.w_avg.numpy(), flat['ema/mapping/w_avg'])
    assert G.synthesis.tri_plane_decoder.b512.conv1.weight.shape == (64, 64, 3, 3)


@pytest.mark.parametrize('fault', ['missing', 'mis-shaped', 'unknown'])
def test_bridge_rejects_mismatched_weights(tiny, fault):
    flat = dict(tiny[2])
    key = 'params/mapping/fc0/weight'
    if fault == 'missing':
        del flat[key]
    elif fault == 'mis-shaped':
        flat[key] = flat[key][:-1]
    else:
        flat['params/synthesis/extra/weight'] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match=fault.replace('unknown', 'unused')):
        load_flat(Generator(tiny_test_config().generator), flat)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.load_generator(RUN_DIR, overrides=FP32)


@pytest.mark.slow
def test_flagship_serving_matches_jax_at_full_width():
    """Trained weights, full width (tri-planes 3x512^2x32), batch 1, 64x64 output."""
    req = _request(2, 1, 512, 4)
    jcfg = jax_load_config(os.path.join(RUN_DIR, 'experiment_config.yaml'), FP32)
    G = JaxGenerator(jcfg.generator)
    with np.load(os.path.join(RUN_DIR, serving.WEIGHTS_FILE)) as flat:
        g_vars = variables_from_flat(flat)
    ref = np.asarray(jax.jit(jax_serving.make_serving_fn(G, g_vars, truncation_psi=0.7,
                                                         resolution=64))(
        *map(jnp.asarray, _args(req))))
    port_G = serving.load_generator(RUN_DIR, 'cpu', FP32)
    port = serving.make_serving_fn(port_G, truncation_psi=0.7, resolution=64)(*_args(req))
    assert port.shape == ref.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(port.numpy(), ref, **TOL)
