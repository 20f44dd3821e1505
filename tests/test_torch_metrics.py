"""The port's FID machinery (`tdgp_torch.metrics`) against the JAX package's
(`tdgp.metrics`), on the CPU.

  - the random projection detector: its projection against
    `RandomProjectionDetector(2048)._proj` (abs 1e-4; erfinv's float32
    approximation in XLA differs by ~2e-5 before the 1/sqrt(3072) scale),
    its features on the same images (rel 1e-4);
  - the feature statistics and the Frechet distance on the same features
    (rel 1e-4); the dataset's statistics on a tiny folder through both
    packages' detectors, with the cache;
  - the registry: the FID entries, the metrics not ported raising by name,
    and the generator sampler on a tiny G (uint8 images of the sampler's
    shape, its render batches).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tdgp.data.dataset import ImageFolderDataset as JaxDataset
from tdgp.metrics import detectors as jax_detectors
from tdgp.metrics import features as jax_features
from tdgp.metrics import fid as jax_fid

from tdgp_torch.config import apply_overrides, tiny_test_config
from tdgp_torch.data.dataset import ImageFolderDataset
from tdgp_torch.metrics import detectors, features, fid, registry
from tdgp_torch.models.epigraf import Generator
from tdgp_torch.models.layers import init_weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def jax_detector():
    return jax_detectors.RandomProjectionDetector(2048)


@pytest.fixture(scope='module')
def port_detector():
    return detectors.RandomProjectionDetector(2048)


def test_projection_is_jax_draw(jax_detector, port_detector):
    ref = np.asarray(jax_detector._proj)
    got = port_detector.proj.numpy()
    assert got.shape == ref.shape == (3072, 2048) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize('seed,shape', [(0, (5, 7)), (11, (3, 4, 6))])
def test_jax_normal_other_seeds_and_shapes(seed, shape):
    import jax
    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    np.testing.assert_allclose(detectors.jax_normal(seed, shape), ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize('res', [32, 64])
def test_detector_features_as_jax(jax_detector, port_detector, res):
    """At 32^2 no pooling, at 64^2 a 2x2 average pool."""
    images = np.random.RandomState(res).randint(0, 256, (6, res, res, 3)).astype(np.uint8)
    ref = np.asarray(jax_detector(jnp.asarray(images)))
    got = port_detector(images).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def test_feature_stats_and_fid_as_jax():
    rs = np.random.RandomState(0)
    a, b = rs.randn(300, 16).astype(np.float32), (rs.randn(250, 16) * 1.3 + 0.2).astype(
        np.float32)
    stats = {}
    for name, mod, kw in (('port', features, {}), ('jax', jax_features,
                                                    {'capture_mean_cov': True})):
        real = mod.FeatureStats(max_items=280, **kw)
        gen = mod.FeatureStats(**kw)
        for chunk in np.array_split(a, 4):
            real.append(chunk)
        for chunk in np.array_split(b, 3):
            gen.append(chunk)
        stats[name] = (real, gen)
    (pr, pg), (jr, jg) = stats['port'], stats['jax']
    assert pr.num_items == jr.num_items == 280
    for x, y in zip(pr.get_mean_cov() + pg.get_mean_cov(), jr.get_mean_cov() + jg.get_mean_cov()):
        np.testing.assert_allclose(x, y, rtol=1e-12, atol=1e-12)
    ref = jax_fid.compute_fid(jr, jg)
    assert ref > 0
    np.testing.assert_allclose(fid.compute_fid(pr, pg), ref, rtol=1e-4)


def test_dataset_stats_as_jax_and_cached(tmp_path, jax_detector, port_detector):
    out = str(tmp_path / 'synth64')
    subprocess.run([sys.executable, os.path.join(ROOT, 'data_scripts', 'make_synthetic_dataset.py'),
                    '--out', out, '--n', '10', '--res', '64'], check=True, capture_output=True,
                   timeout=120)
    cache = str(tmp_path / 'cache')
    port = features.compute_feature_stats_for_dataset(
        ImageFolderDataset(out, resolution=64), port_detector, batch_size=8, cache_dir=cache)
    ref = jax_features.compute_feature_stats_for_dataset(
        JaxDataset(out, resolution=64), jax_detector, batch_size=8, capture_mean_cov=True,
        rank=0, num_shards=1)
    assert port.num_items == ref.num_items == 10
    for x, y in zip(port.get_mean_cov(), ref.get_mean_cov()):
        np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-4 * np.abs(y).max())
    assert len(os.listdir(cache)) == 1
    cached = features.compute_feature_stats_for_dataset(
        ImageFolderDataset(out, resolution=64), None, batch_size=8, cache_dir=cache)
    np.testing.assert_array_equal(cached.get_mean_cov()[1], port.get_mean_cov()[1])


def test_registry_names():
    assert {'fid2k_full', 'fid5k_5k', 'fid50k_full', 'kid50k', 'kid50k_full', 'pr50k3',
            'pr50k3_full', 'is50k', 'ppl2_wend', 'nfs256'} == set(registry.list_metrics())
    ctx = registry.EvalContext(cfg=tiny_test_config(), G=None)
    for name in ('nfs256', 'kid50k', 'ppl2_wend'):
        with pytest.raises(NotImplementedError, match=name):
            registry.calc_metric(name, ctx)
    with pytest.raises(ValueError, match='unknown metric'):
        registry.calc_metric('fid1k', ctx)


@pytest.mark.parametrize('res,expected', [(64, 16), (256, 4)])
def test_render_batch(res, expected):
    cfg = apply_overrides(tiny_test_config(), [f'generator.img_resolution={res}'])
    assert registry.EvalContext(cfg=cfg, G=None)._resolve_batch_gpu() == expected


def test_image_sampler_and_fid_on_a_tiny_generator(port_detector):
    """fid through the registry's own path, with a small sample: the
    sampler's images are uint8 [16, 64, 64, 3], z is JAX's draw for the
    seed, and two calls with one seed give the same images."""
    cfg = tiny_test_config()
    G = init_weights(Generator(cfg.generator), torch.Generator().manual_seed(0)).eval()
    ctx = registry.EvalContext(cfg=cfg, G=G, detector=port_detector)
    images = ctx.make_image_sampler()(16, 3)
    assert images.dtype == torch.uint8 and tuple(images.shape) == (16, 64, 64, 3)
    assert torch.equal(images, ctx.make_image_sampler()(16, 3))
    assert not torch.equal(images, ctx.make_image_sampler()(16, 4))
    real = features.FeatureStats()
    real.append(port_detector(np.random.RandomState(0).randint(0, 256, (40, 64, 64, 3),
                                                                dtype=np.uint8)).numpy())
    gen = features.compute_feature_stats_for_generator(
        ctx.make_image_sampler(), port_detector, batch_size=16, max_items=40)
    assert gen.num_items == 40 and np.isfinite(fid.compute_fid(real, gen))
