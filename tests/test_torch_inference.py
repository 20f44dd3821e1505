"""Inference: port (tdgp_torch.inference) vs JAX package (tdgp.inference) on the CPU.

Quick tier, at `tiny_test_config` widths: the JAX `Generator` is initialised
from fixed keys, its variables are carried into the port's `Generator` by
`tdgp_torch.weights`, and each function of the port is held against its JAX
counterpart on the same inputs: the seeded z's and the five camera
trajectories exactly, the canonical cameras through the camera adaptor,
the per-class truncation (with the JAX package's per-class z draws fed to
the port, since torch cannot replay `jax.random`), the batched rendering
with its padded tail batch, trajectories and grids at rtol = atol = 1e-4
(XLA:CPU vs PyTorch float32, tests/conftest.py:18-33). The entry points run
on a tiny run directory on the CPU.

Slow tier: the trained flagship at full width, a seed grid through both
packages at a 64x64 output.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
import yaml

import jax
import jax.numpy as jnp
from flax import traverse_util

from tdgp import inference as jax_inference
from tdgp.checkpoint import variables_from_flat
from tdgp.config import tiny_test_config as jax_tiny_test_config
from tdgp.infra.experiment import load_config as jax_load_config
from tdgp.models.epigraf import Generator as JaxGenerator
from tdgp.utils.tensor_group import TensorGroup as JaxTensorGroup

from tdgp_torch import inference
from tdgp_torch.config import tiny_test_config
from tdgp_torch.models.epigraf import Generator
from tdgp_torch.scripts import extract_geometry as geometry_script
from tdgp_torch.scripts import inference as inference_script
from tdgp_torch.serving import WEIGHTS_FILE
from tdgp_torch.utils.tensor_group import TensorGroup
from tdgp_torch.weights import load_flat

TOL = dict(rtol=1e-4, atol=1e-4)
RUN_DIR = os.path.join(os.path.dirname(__file__), '..', 'experiments',
                       'synth256-3dgp-p64-b16-8839f23-r5-flagship')
TRAJ = dict(num_frames=3, fov_diff=1.0, yaw_diff=0.5, pitch_diff=0.3, yaw_left=-0.5,
            yaw_right=0.5, yaw_start=-0.5, yaw_end=0.5, pitch_start=1.5, pitch_end=1.4,
            fov=None, yaw_offset=0.1, pitch_offset=0.05, fov_offset=0.5,
            yaw_offsets=[-0.4, 0.0, 0.4])


@pytest.fixture(scope='module', autouse=True)
def _one_thread_per_worker():
    """One torch and one BLAS thread while this module runs: the test workers
    share the cores, and OpenBLAS's threads spin while the others hold them."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api='blas'):
        yield
    torch.set_num_threads(saved)


def _jax_generator(cfg):
    """A JAX generator initialised from fixed keys, camera adaptor included,
    and its variables as flat numpy arrays."""
    G = JaxGenerator(cfg.generator)
    n = 2
    z = jnp.zeros((n, cfg.generator.z_dim))
    c = jnp.eye(cfg.generator.c_dim)[:n]
    cam = jax_inference.canonical_cameras(cfg, n)
    rngs = {k: jax.random.PRNGKey(i + 1)
            for i, k in enumerate(('params', 'noise', 'render', 'depth', 'dropout'))}

    def init_fwd(g):
        g.synthesis.apply_camera_adaptor(cam, z, c)
        return g(z, c, cam, camera_angles_cond=cam.angles, resolution=8)

    g_vars = jax.jit(lambda r: G.init(r, method=init_fwd))(rngs)
    flat = {'/'.join(k): np.asarray(v)
            for k, v in traverse_util.flatten_dict(jax.device_get(g_vars)).items()}
    return G, g_vars, flat


@pytest.fixture(scope='module')
def tiny():
    """(JAX config, JAX generator, its variables, port config, port generator, flat arrays)."""
    jcfg = jax_tiny_test_config()
    G, g_vars, flat = _jax_generator(jcfg)
    cfg = tiny_test_config()
    port = Generator(cfg.generator)
    load_flat(port, flat)
    return jcfg, G, g_vars, cfg, port.eval(), flat


def _same_cameras(port, ref, exact=True):
    for k in ('angles', 'fov', 'radius', 'look_at'):
        if exact:
            np.testing.assert_array_equal(port[k].numpy(), np.asarray(ref[k]), err_msg=k)
        else:
            np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]), **TOL, err_msg=k)


def test_seeded_z_is_bit_identical():
    np.testing.assert_array_equal(inference.sample_z_from_seeds([0, 3, 17], 32).numpy(),
                                  np.asarray(jax_inference.sample_z_from_seeds([0, 3, 17], 32)))


@pytest.mark.parametrize('name', ['point', 'points', 'front_circle', 'line', 'wiggle'])
def test_trajectories_match_jax_exactly(name):
    traj = dict(TRAJ, name=name, num_frames=1 if name == 'point' else TRAJ['num_frames'])
    ref = jax_inference.generate_camera_trajectory(
        traj, jax_inference.canonical_cameras(jax_tiny_test_config(), 2))
    port = inference.generate_camera_trajectory(
        traj, inference.canonical_cameras(tiny_test_config(), 2))
    assert len(port) == len(ref)
    _same_cameras(port, ref)


def test_line_with_a_fixed_fov_and_an_unknown_name():
    traj = dict(TRAJ, name='line', fov=20.0)
    ref = jax_inference.generate_camera_trajectory(
        traj, jax_inference.canonical_cameras(jax_tiny_test_config(), 2))
    port = inference.generate_camera_trajectory(
        traj, inference.canonical_cameras(tiny_test_config(), 2))
    _same_cameras(port, ref)
    with pytest.raises(NotImplementedError, match='spiral'):
        inference.generate_camera_trajectory(dict(name='spiral'),
                                             inference.canonical_cameras(tiny_test_config(), 1))


def test_canonical_cameras_with_the_camera_adaptor_match_jax(tiny):
    jcfg, G, g_vars, cfg, port, _ = tiny
    z = np.random.RandomState(4).randn(3, cfg.generator.z_dim).astype(np.float32)
    c = np.eye(4, dtype=np.float32)[[0, 2, 3]]
    _same_cameras(inference.canonical_cameras(cfg, 3), jax_inference.canonical_cameras(jcfg, 3))
    ref = jax_inference.canonical_cameras(jcfg, 3, G=G, g_vars=g_vars, z=jnp.asarray(z),
                                          c=jnp.asarray(c), use_posterior=True)
    got = inference.canonical_cameras(cfg, 3, G=port, z=torch.from_numpy(z),
                                      c=torch.from_numpy(c), use_posterior=True)
    assert not np.allclose(np.asarray(ref.look_at),
                           np.asarray(jax_inference.canonical_cameras(jcfg, 3).look_at))
    _same_cameras(got, ref, exact=False)


def test_per_class_truncation_matches_jax_with_its_draws(tiny):
    jcfg, G, g_vars, cfg, port, _ = tiny
    seeds = [0, 1, 2, 5, 6]
    labels = [s % 4 for s in seeds]
    c = np.eye(4, dtype=np.float32)[labels]
    angles = np.array(jax_inference.canonical_cameras(jcfg, len(seeds)).angles)
    ref = jax_inference.sample_ws_from_seeds(G, g_vars, seeds, jnp.asarray(c),
                                             jnp.asarray(angles), truncation_psi=0.7)
    class_zs = {k: np.asarray(jax.random.normal(jax.random.PRNGKey(k),
                                                (256, cfg.generator.z_dim)))
                for k in set(labels)}
    got = inference.sample_ws_from_seeds(port, seeds, torch.from_numpy(c),
                                         torch.from_numpy(angles), truncation_psi=0.7,
                                         class_zs=class_zs)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    untruncated = inference.sample_ws_from_seeds(port, seeds, torch.from_numpy(c),
                                                 torch.from_numpy(angles))
    np.testing.assert_allclose(untruncated.numpy(), np.asarray(jax_inference.sample_ws_from_seeds(
        G, g_vars, seeds, jnp.asarray(c), jnp.asarray(angles))), **TOL)
    own = inference.sample_ws_from_seeds(port, seeds, torch.from_numpy(c),
                                         torch.from_numpy(angles), truncation_psi=0.7)
    assert own.shape == got.shape and bool(torch.isfinite(own).all())


def _ws_and_cameras(cfg, n, seed):
    rng = np.random.RandomState(seed)
    ws = rng.randn(n, 8, cfg.generator.w_dim).astype(np.float32)
    angles = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(1.3, 1.8, n),
                       np.zeros(n)], 1).astype(np.float32)
    mean = inference.canonical_cameras(cfg, n)
    cams = dict(angles=angles, fov=mean.fov.numpy(), radius=mean.radius.numpy(),
                look_at=mean.look_at.numpy())
    return ws, cams


def test_generate_pads_the_tail_batch_as_jax_does(tiny):
    jcfg, G, g_vars, cfg, port, _ = tiny
    ws, cams = _ws_and_cameras(cfg, 3, seed=2)
    ws = ws[:, :port.synthesis.num_ws]
    ref = jax_inference.generate(G, g_vars, jnp.asarray(ws),
                                 JaxTensorGroup(**{k: jnp.asarray(v) for k, v in cams.items()}),
                                 batch_size=2, resolution=16)
    got = inference.generate(port, torch.from_numpy(ws),
                             TensorGroup(**{k: torch.from_numpy(v) for k, v in cams.items()}),
                             batch_size=2, resolution=16)
    assert got.shape == np.asarray(ref).shape == (3, 16, 16, 3)
    assert got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


def test_generate_trajectory_matches_jax(tiny):
    jcfg, G, g_vars, cfg, port, _ = tiny
    ws, _ = _ws_and_cameras(cfg, 2, seed=3)
    ws = ws[:, :port.synthesis.num_ws]
    traj = dict(TRAJ, name='front_circle')
    ref = jax_inference.generate_trajectory(
        G, g_vars, jnp.asarray(ws),
        jax_inference.generate_camera_trajectory(traj, jax_inference.canonical_cameras(jcfg, 2)),
        batch_size=4, resolution=16)
    got = inference.generate_trajectory(
        port, torch.from_numpy(ws),
        inference.generate_camera_trajectory(traj, inference.canonical_cameras(cfg, 2)),
        batch_size=4, resolution=16)
    assert got.shape == np.asarray(ref).shape == (3, 2, 16, 16, 3)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


def test_make_grid_matches_jax():
    imgs = np.random.RandomState(0).rand(5, 6, 7, 3).astype(np.float32)
    for nrow, pad in ((None, 2), (3, 1), (5, 0)):
        np.testing.assert_array_equal(inference.make_grid(imgs, nrow, pad),
                                      jax_inference.make_grid(imgs, nrow, pad))


def test_images_and_videos_are_written(tmp_path):
    import PIL.Image
    img = np.random.RandomState(1).rand(16, 16, 3).astype(np.float32)
    inference.save_image(img, str(tmp_path / 'x.png'))
    np.testing.assert_allclose(np.asarray(PIL.Image.open(tmp_path / 'x.png')) / 255.0, img,
                               atol=0.01)
    frames = np.random.RandomState(2).rand(4, 16, 16, 3).astype(np.float32)
    inference.save_video_frames(frames, str(tmp_path / 'v.gif'), fps=5)
    assert PIL.Image.open(tmp_path / 'v.gif').n_frames == 4


def _plain(value):
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    return value


@pytest.fixture(scope='module')
def tiny_run(tiny, tmp_path_factory):
    """A run directory of the tiny config: its experiment_config.yaml and its
    EMA export, as `scripts/infra/export_ema.py` lays them out."""
    run = tmp_path_factory.mktemp('tiny_run')
    with open(run / 'experiment_config.yaml', 'w') as f:
        yaml.safe_dump(_plain(dataclasses.asdict(tiny[3])), f)
    np.savez(run / WEIGHTS_FILE, **tiny[5])
    return str(run)


def test_entry_points_run_on_the_cpu(tiny_run, tmp_path):
    run = ['--run-dir', tiny_run, '--device', 'cpu']
    inference_script.main(run + ['--seeds', '0-2', '--truncation', '0.7', '--batch-size', '2',
                                 '--output', str(tmp_path / 'grid.png')])
    inference_script.main(run + ['--vis', 'video_grid', '--seeds', '1', '--num-frames', '2',
                                 '--classes', '3', '--output', str(tmp_path / 'video.gif')])
    geometry_script.main(run + ['--seeds', '0', '--resolution', '12', '--save-mrc',
                                '--out-dir', str(tmp_path)])
    assert {'grid.png', 'video.gif', 'seed0000.obj', 'seed0000.mrc'} <= set(os.listdir(tmp_path))


def test_load_run_matches_the_jax_config_and_weights(tiny, tiny_run):
    cfg, G = inference_script.load_run(tiny_run, device='cpu')
    ref = jax_load_config(os.path.join(tiny_run, 'experiment_config.yaml'), finalize=False)
    assert dataclasses.asdict(cfg.generator) == dataclasses.asdict(ref.generator)
    np.testing.assert_array_equal(G.mapping.w_avg.numpy(), tiny[5]['ema/mapping/w_avg'])
    assert not G.training


def test_entry_points_refuse_orbax_snapshots_and_need_a_card(tiny_run, monkeypatch):
    """A run directory without the port's own snapshots (`network-snapshot-*`
    with its `state.pt`) has no 'latest' or 'best' for the entry points;
    the JAX package's orbax snapshots reach the port through their `.npz`
    export."""
    for snapshot in ('latest', 'best'):
        with pytest.raises(FileNotFoundError, match='no snapshot'):
            inference_script.load_run(tiny_run, snapshot, device='cpu')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inference_script.main(['--run-dir', tiny_run])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        geometry_script.main(['--run-dir', tiny_run])


def test_seed_parsing():
    assert inference_script.parse_seeds('0-3,7,9-10') == [0, 1, 2, 3, 7, 9, 10]


@pytest.mark.slow
def test_flagship_seed_grid_matches_jax_at_full_width():
    """Trained weights, full width (tri-planes 3x512^2x32), seeds 0-1 with the
    per-class truncation at 0.7, rendered at 64x64."""
    fp32 = ['generator.fp32_only=true']
    jcfg = jax_load_config(os.path.join(RUN_DIR, 'experiment_config.yaml'), fp32,
                           finalize=False)
    G = JaxGenerator(jcfg.generator)
    with np.load(os.path.join(RUN_DIR, WEIGHTS_FILE)) as flat:
        g_vars = variables_from_flat(flat)
    seeds = [0, 1]
    c = np.eye(4, dtype=np.float32)[[s % 4 for s in seeds]]
    jcams = jax_inference.canonical_cameras(jcfg, 2)
    ref_ws = jax_inference.sample_ws_from_seeds(G, g_vars, seeds, jnp.asarray(c), jcams.angles,
                                                truncation_psi=0.7)
    ref = jax_inference.generate(G, g_vars, ref_ws, jcams, batch_size=2, resolution=64)

    cfg, port = inference_script.load_run(RUN_DIR, device='cpu', overrides=fp32)
    cams = inference.canonical_cameras(cfg, 2)
    class_zs = {k: np.asarray(jax.random.normal(jax.random.PRNGKey(k), (256, 512)))
                for k in (0, 1)}
    ws = inference.sample_ws_from_seeds(port, seeds, torch.from_numpy(c), cams.angles,
                                        truncation_psi=0.7, class_zs=class_zs)
    np.testing.assert_allclose(ws.numpy(), np.asarray(ref_ws), **TOL)
    got = inference.generate(port, ws, cams, batch_size=2, resolution=64)
    assert got.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
