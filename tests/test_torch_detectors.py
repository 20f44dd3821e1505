"""The port's detectors (`tdgp_torch.metrics.inception`, `.vgg`, `.detectors`)
against the JAX package's, on the CPU.

Random weights (a torch InceptionV3 with torchvision's names through
`scripts/convert_inception.py`, the batch norms' statistics randomized; VGG16
drawn in `scripts/convert_vgg.py`'s layout) are written to one `.npz` and
loaded into both packages. The repo holds no pretrained weights.

- InceptionV3 (FID variant) at its smallest input, 75^2, with and without
  pytorch-fid's branch pools (`fid_pool`): pool features and logits within
  1e-4 of the largest |JAX value|; the port with `fid_pool` flipped misses.
- VGG16 at 32^2 (fc6 takes 512 inputs there): fc7 features within 1e-4.
- The preprocessing: 256^2 -> 299^2 (an upsample, half-pixel centres) and
  256^2 -> 224^2 (a downsample, antialiased as `jax.image.resize`) within
  1e-5; the upsample with aligned corners and the downsample without
  antialias miss.
- `load_inception_detector`: $TDGP_INCEPTION_WEIGHTS, the '__meta__/fid_pool'
  marker and $TDGP_INCEPTION_FID_POOL as the JAX package reads them, the
  softmax detector; a missing file raises FileNotFoundError as in JAX; the
  scripts' choice falls back to the random projection.
- `split`, `jax_uniform` and `jax_normal` of a split key against jax.random.
The forwards at 299^2 and 224^2 (`slow`) hold the whole detectors, resize
included, at the same limits.
"""
import os
import sys

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp
from flax import traverse_util

from tdgp.metrics import detectors as jax_detectors
from tdgp.metrics import inception as jax_inception
from tdgp.metrics import vgg as jax_vgg

from tdgp_torch.metrics import detectors, inception, vgg

from _torch_inception import TorchInceptionV3FID

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', 'scripts'))

FEAT_TOL = 1e-4   # features and logits: max |port - JAX| over max |JAX|
PRE_TOL = 1e-5    # preprocessed images: absolute (VGG's divides by a std of ~0.22)


@pytest.fixture(scope='module', autouse=True)
def _one_thread_per_worker():
    """One torch and one BLAS thread while this module runs: the test workers
    share the cores, and OpenBLAS's threads spin while the others hold them."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api='blas'):
        yield
    torch.set_num_threads(saved)


def _inception_flat(seed):
    """A torch InceptionV3 with torchvision's names (tests/_torch_inception.py)
    at random weights, its batch norms' statistics and affine terms
    randomized, through `scripts/convert_inception.py`'s `convert`."""
    from convert_inception import convert
    torch.manual_seed(seed)
    model = TorchInceptionV3FID(num_logits=1008)
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.running_mean.copy_(torch.from_numpy(rs.randn(n).astype(np.float32) * 0.1))
                m.running_var.copy_(torch.from_numpy(0.5 + np.abs(rs.randn(n)).astype(np.float32)))
                m.weight.add_(torch.from_numpy(rs.randn(n).astype(np.float32) * 0.1))
                m.bias.add_(torch.from_numpy(rs.randn(n).astype(np.float32) * 0.1))
    return convert(model.state_dict())


def _vgg_flat(size, seed):
    """VGG16 weights in the layout of `scripts/convert_vgg.py` at a size^2
    input (fc6 takes (size / 32)^2 x 512), drawn from numpy."""
    rs = np.random.RandomState(seed)
    flat, cin, i = {}, 3, 0
    for spec in jax_vgg.VGG16_PLAN:
        if spec != 'M':
            flat[f'params/conv{i}/kernel'] = rs.randn(3, 3, cin, spec) * np.sqrt(2 / (9 * cin))
            flat[f'params/conv{i}/bias'] = rs.randn(spec) * 0.05
            cin, i = spec, i + 1
    for name, n_in, n_out in (('fc6', (size // 32) ** 2 * 512, 4096), ('fc7', 4096, 4096),
                              ('fc8', 4096, 1000)):
        flat[f'params/{name}/kernel'] = rs.randn(n_in, n_out) * np.sqrt(2 / n_in)
        flat[f'params/{name}/bias'] = rs.randn(n_out) * 0.05
    return {k: v.astype(np.float32) for k, v in flat.items()}


def _tree(flat):
    return traverse_util.unflatten_dict({tuple(k.split('/')): jnp.asarray(v)
                                         for k, v in flat.items()})


def _rel(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(ref).max())


@pytest.fixture(scope='module')
def inception_npz(tmp_path_factory):
    flat = _inception_flat(1)
    path = str(tmp_path_factory.mktemp('weights') / 'inception.npz')
    np.savez(path, **flat, **{'__meta__/fid_pool': np.asarray(True)})
    return path, flat


@pytest.mark.parametrize('fid_pool', [False, True])
def test_inception_as_jax(inception_npz, fid_pool):
    path, flat = inception_npz
    x = np.random.RandomState(2).uniform(-1, 1, (2, 75, 75, 3)).astype(np.float32)
    feats, logits = jax_inception.InceptionV3FID(fid_pool=fid_pool).apply(_tree(flat),
                                                                           jnp.asarray(x))
    port = inception.make_detector(inception.load_weights(path), fid_pool=fid_pool).model
    flipped = inception.make_detector(inception.load_weights(path),
                                      fid_pool=not fid_pool).model
    with torch.no_grad():
        pf, pl = port(torch.from_numpy(x).permute(0, 3, 1, 2))
        wf, _ = flipped(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert pf.shape == (2, 2048) and pl.shape == (2, 1008)
    print(f'fid_pool={fid_pool}: features {_rel(pf, feats):.3g}, logits {_rel(pl, logits):.3g}, '
          f'fid_pool flipped {_rel(wf, feats):.3g}')
    assert _rel(pf, feats) <= FEAT_TOL and _rel(pl, logits) <= FEAT_TOL
    assert _rel(wf, feats) > FEAT_TOL


def test_vgg16_as_jax(tmp_path):
    """The detector (the ImageNet normalization, no resize at 32^2, fc7)."""
    flat = _vgg_flat(32, 3)
    path = str(tmp_path / 'vgg16.npz')
    np.savez(path, **flat)
    images = np.random.RandomState(5).randint(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    feats, logits = jax_vgg.VGG16().apply(_tree(flat),
                                          jax_vgg.preprocess(jnp.asarray(images), 32))
    det = vgg.make_detector(vgg.load_weights(path), size=32)
    got = det(images)
    with torch.no_grad():
        _, pl = det.model(vgg.preprocess(images, 32))
    assert got.shape == (2, 4096)
    print(f'VGG16 at 32^2: fc7 {_rel(got, feats):.3g}, logits {_rel(pl, logits):.3g}')
    assert _rel(got, feats) <= FEAT_TOL and _rel(pl, logits) <= FEAT_TOL


@pytest.mark.parametrize('which', ['inception_upsample', 'vgg_downsample'])
def test_preprocess_as_jax(which, monkeypatch):
    images = np.random.RandomState(6).randint(0, 256, (2, 256, 256, 3), dtype=np.uint8)
    if which == 'inception_upsample':
        ref, got = jax_inception.preprocess(jnp.asarray(images)), inception.preprocess(images)
    else:
        ref, got = jax_vgg.preprocess(jnp.asarray(images)), vgg.preprocess(images)
    ref = np.asarray(ref)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=PRE_TOL)
    interpolate = torch.nn.functional.interpolate

    def other_choice(x, size, mode, align_corners, antialias):  # the witness
        if which == 'inception_upsample':
            return interpolate(x, size=size, mode=mode, align_corners=True)
        return interpolate(x, size=size, mode=mode, align_corners=False, antialias=False)

    monkeypatch.setattr(inception.F, 'interpolate', other_choice)
    wrong = (inception.preprocess(images) if which == 'inception_upsample'
             else vgg.preprocess(images)).permute(0, 2, 3, 1).numpy()
    assert float(np.abs(wrong - ref).max()) > 100 * PRE_TOL


def test_load_inception_detector(inception_npz, monkeypatch, capsys, tmp_path):
    path, flat = inception_npz
    monkeypatch.delenv('TDGP_INCEPTION_FID_POOL', raising=False)
    monkeypatch.setenv('TDGP_INCEPTION_WEIGHTS', str(tmp_path / 'missing.npz'))
    for load in (jax_detectors.load_inception_detector, detectors.load_inception_detector):
        with pytest.raises(FileNotFoundError, match='TDGP_INCEPTION_WEIGHTS'):
            load()
    assert isinstance(detectors.make_fid_detector('cpu'), detectors.RandomProjectionDetector)
    assert 'RandomProjectionDetector' in capsys.readouterr().out

    monkeypatch.setenv('TDGP_INCEPTION_WEIGHTS', path)
    det = detectors.load_inception_detector()
    assert det.model.Mixed_5b.fid_pool and not det.return_logits   # the '__meta__' marker
    monkeypatch.setenv('TDGP_INCEPTION_FID_POOL', '0')
    assert not detectors.load_inception_detector().model.Mixed_5b.fid_pool
    assert detectors.load_inception_detector(fid_pool=True).model.Mixed_7c.fid_pool
    assert isinstance(detectors.make_fid_detector('cpu'), inception.Detector)
    probs = inception.make_detector(inception.load_weights(path), return_logits=True)
    images = np.random.RandomState(8).randint(0, 256, (1, 75, 75, 3), dtype=np.uint8)
    with torch.no_grad():
        p = probs.model(torch.zeros(1, 3, 75, 75))[1]
    assert p.shape == (1, 1008)
    assert det.model.fc.weight.shape == (1008, 2048)
    assert inception.npz_meta(path) == jax_inception.npz_meta(path) == {'fid_pool': True}
    assert set(inception.load_weights(path)) == set(flat)
    assert images.dtype == np.uint8


@pytest.mark.parametrize('seed', [0, 7])
def test_key_helpers_as_jax_random(seed):
    key = jax.random.PRNGKey(seed)
    ref_keys = np.asarray(jax.random.split(key, 3))
    keys = detectors.split(detectors.prng_key(seed), 3)
    np.testing.assert_array_equal(np.asarray(keys, np.uint32), ref_keys)
    for got_key, ref_key in zip(keys, jax.random.split(key, 3)):
        np.testing.assert_array_equal(detectors.jax_uniform(got_key, (5, 3)),
                                      np.asarray(jax.random.uniform(ref_key, (5, 3))))
        np.testing.assert_allclose(detectors.jax_normal(got_key, (4, 6)),
                                   np.asarray(jax.random.normal(ref_key, (4, 6))),
                                   rtol=0, atol=1e-4)


@pytest.mark.slow
@pytest.mark.parametrize('fid_pool', [False, True])
def test_inception_at_299_as_jax(tmp_path, fid_pool):
    flat = _inception_flat(9)
    path = str(tmp_path / 'inception.npz')
    np.savez(path, **flat)
    images = np.random.RandomState(10).randint(0, 256, (2, 256, 256, 3), dtype=np.uint8)
    ref = np.asarray(jax_inception.make_detector(_tree(flat), fid_pool=fid_pool)(
        jnp.asarray(images)))
    got = inception.make_detector(inception.load_weights(path), fid_pool=fid_pool)(images)
    assert _rel(got, ref) <= FEAT_TOL


@pytest.mark.slow
def test_vgg16_at_224_as_jax(tmp_path, monkeypatch):
    flat = _vgg_flat(224, 11)
    path = str(tmp_path / 'vgg16.npz')
    np.savez(path, **flat)
    images = np.random.RandomState(12).randint(0, 256, (2, 256, 256, 3), dtype=np.uint8)
    ref = np.asarray(jax_vgg.make_detector(_tree(flat))(jnp.asarray(images)))
    det = vgg.make_detector(vgg.load_weights(path))
    assert _rel(det(images), ref) <= FEAT_TOL
    interpolate = torch.nn.functional.interpolate
    monkeypatch.setattr(inception.F, 'interpolate', lambda x, **kw: interpolate(
        x, **dict(kw, antialias=False)))
    assert _rel(det(images), ref) > FEAT_TOL
