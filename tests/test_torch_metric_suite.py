"""KID, precision/recall, IS and PPL of the port against the JAX package's,
on the CPU.

- The metric functions on seeded features: `compute_kid` (the same
  RandomState subsets, 1e-12 relative), `compute_pr` (the coverage counts,
  hence precision and recall, exactly), `compute_is` (1e-12 relative on
  probabilities; NaN where JAX gives NaN, on features with negative
  entries), `compute_ppl` (the same detector on the same pairs: 1e-12).
- The registry entries kid50k, kid50k_full, pr50k3, pr50k3_full and is50k
  on a tiny generator with the same weights in both packages, at a reduced
  count of generated images (NUM_GEN; the count their functions pass is
  capped by a wrapper, and both packages' images are rendered once), on
  an in-memory dataset of 16 images; the conditioning (labels and cameras)
  is JAX's stream, fed to the port (torch cannot replay jax.random's
  cameras). Their values within the limits stated there: the two
  packages' uint8 images differ in a few pixels by one level.
- `ppl2_wend`'s pair sampler: the same images at t and t + epsilon for
  the seed's z0, z1 and t (drawn by both as `jax.random.split` into 3, two
  normals and a uniform), and ppl2_wend through the registry at 8 pairs
  (one batch of 16).
- No entry raises NotImplementedError on a 3D generator; the samplers
  refuse a 2D one, as the JAX package has none.
"""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from tdgp.config import tiny_test_config as jax_tiny_test_config
from tdgp.metrics import detectors as jax_detectors
from tdgp.metrics import features as jax_features
from tdgp.metrics import inception_score as jax_is
from tdgp.metrics import kid as jax_kid
from tdgp.metrics import ppl as jax_ppl
from tdgp.metrics import precision_recall as jax_pr
from tdgp.metrics import registry as jax_registry

from tdgp_torch.config import load_config, tiny_test_config
from tdgp_torch.metrics import detectors, inception_score, kid, ppl
from tdgp_torch.metrics import precision_recall, registry
from tdgp_torch.models.epigraf import Generator
from tdgp_torch.utils.tensor_group import TensorGroup
from tdgp_torch.weights import load_flat

from test_torch_inference import _jax_generator

NUM_GEN = 16             # generated images of the registry entries here
FEATURES = 64            # the random projection's width here
KID_TOL = 1e-4           # kid: relative, the images differing in a few pixels
PR_TOL = 1 / NUM_GEN     # precision, recall: one sample of NUM_GEN


@pytest.fixture(scope='module', autouse=True)
def _one_thread_per_worker():
    """One torch and one BLAS thread while this module runs: the test workers
    share the cores, and OpenBLAS's threads spin while the others hold them."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api='blas'):
        yield
    torch.set_num_threads(saved)


def _features(seed, n=120, d=16, shift=0.0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, d) * (1 + shift) + shift).astype(np.float32)


@pytest.mark.parametrize('sizes', [(120, 90, 1000), (40, 50, 30)], ids=['one_subset_size',
                                                                        'capped_subsets'])
def test_compute_kid_as_jax(sizes):
    n_real, n_gen, max_subset = sizes
    real, gen = _features(0, n_real), _features(1, n_gen, shift=0.3)
    ref = jax_kid.compute_kid(real, gen, num_subsets=20, max_subset_size=max_subset)
    got = kid.compute_kid(real, gen, num_subsets=20, max_subset_size=max_subset)
    assert ref > 0
    np.testing.assert_allclose(got, ref, rtol=1e-12)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_compute_pr_counts_as_jax(seed):
    real, gen = _features(seed, 300, 32), _features(seed + 10, 250, 32, shift=0.1)
    ref = jax_pr.compute_pr(real, gen)
    got = precision_recall.compute_pr(real, gen)
    assert got == ref and 0 < ref[0] < 1 and 0 < ref[1] < 1


def test_pr_blocks_cover_every_row(monkeypatch):
    """Blocks of 7 rows give the counts of one block."""
    real, gen = _features(5, 50, 8), _features(6, 45, 8, shift=0.2)
    whole = precision_recall.compute_pr(real, gen)
    monkeypatch.setattr(precision_recall, 'BLOCK_ELEMENTS', 7 * 50)
    assert precision_recall._rows(50) == 7
    assert precision_recall.compute_pr(real, gen) == whole == jax_pr.compute_pr(real, gen)


def test_compute_is_as_jax():
    logits = _features(3, 100, 10) * 2
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    ref = jax_is.compute_is(probs)
    np.testing.assert_allclose(inception_score.compute_is(probs), ref, rtol=1e-12)
    raw = _features(4, 100, 10)  # features, not probabilities: log of negatives
    ref_raw = jax_is.compute_is(raw)
    with np.errstate(invalid='ignore'):
        got_raw = inception_score.compute_is(raw)
    assert np.isnan(ref_raw[0]) and np.isnan(got_raw[0])


def test_compute_ppl_as_jax():
    rs = np.random.RandomState(9)
    pairs = [(rs.randint(0, 256, (4, 8, 8, 3), dtype=np.uint8),) * 2 for _ in range(4)]
    pairs = [(a, np.clip(a.astype(int) + rs.randint(-2, 3, a.shape), 0, 255).astype(np.uint8))
             for a, _ in pairs]
    proj = rs.randn(8 * 8 * 3, 5).astype(np.float32)

    def detector(images):
        return np.asarray(images, np.float32).reshape(len(images), -1) @ proj

    def sample_pair(batch, seed):
        return pairs[seed]

    ref = jax_ppl.compute_ppl(sample_pair, detector, num_samples=14, batch_size=4)
    got = ppl.compute_ppl(sample_pair, detector, num_samples=14, batch_size=4)
    assert ref > 0
    np.testing.assert_allclose(got, ref, rtol=1e-12)


# ------------------------------------------------------------- a tiny generator

class Images:
    """16 seeded uint8 images of 64^2 with one-hot labels over 4 classes, in
    the dataset interface both packages read."""
    name = 'seeded16'

    def __init__(self):
        rs = np.random.RandomState(11)
        self.images = rs.randint(0, 256, (16, 64, 64, 3), dtype=np.uint8)
        self.labels = np.eye(4, dtype=np.float32)[np.arange(16) % 4]

    def __len__(self):
        return 16

    def __getitem__(self, i):
        return {'image': self.images[i]}

    def get_label(self, i):
        return self.labels[i]


def _jax_conditioning(jcfg, dataset, batch_size, seed=0, device='cpu'):
    """JAX's conditioning stream, each batch as the port's (torch tensors)."""
    for cond in jax_features.iterate_random_conditioning(jcfg, dataset, batch_size, seed):
        cam = cond['camera_params']
        yield {'c': torch.tensor(np.asarray(cond['c'], np.float32)),
               'camera_params': TensorGroup(**{k: torch.tensor(np.asarray(cam[k]))
                                               for k in ('angles', 'fov', 'radius', 'look_at')})}


def _capped_once(fn, rendered):
    """`fn` (compute_feature_stats_for_generator) with max_items capped at
    NUM_GEN, the stats of each capture kind computed once."""
    def capped(sample_fn, detector, **kw):
        kw['max_items'] = min(kw.get('max_items', 2048), NUM_GEN)
        key = kw.get('capture_all', False)
        if key not in rendered:
            rendered[key] = fn(sample_fn, detector, **kw)
        return rendered[key]
    return capped


@pytest.fixture(scope='module')
def contexts():
    """(JAX EvalContext, port EvalContext) on the same tiny generator, dataset
    and conditioning, with the random projection (FEATURES wide)."""
    jcfg = jax_tiny_test_config()
    G, g_vars, flat = _jax_generator(jcfg)
    cfg = tiny_test_config()
    port = Generator(cfg.generator)
    load_flat(port, flat)
    dataset = Images()
    mp = pytest.MonkeyPatch()
    mp.setattr(registry, 'iterate_random_conditioning',
               lambda cfg, ds, bs, device='cpu': _jax_conditioning(jcfg, ds, bs))
    jax_rendered, port_rendered = {}, {}
    mp.setattr(jax_registry, 'compute_feature_stats_for_generator',
               _capped_once(jax_registry.compute_feature_stats_for_generator, jax_rendered))
    mp.setattr(registry, 'compute_feature_stats_for_generator',
               _capped_once(registry.compute_feature_stats_for_generator, port_rendered))
    jctx = jax_registry.EvalContext(
        cfg=jcfg, G=G, g_vars=g_vars, dataset=dataset, batch_size=16,
        detector=jax_detectors.RandomProjectionDetector(FEATURES))
    ctx = registry.EvalContext(cfg=cfg, G=port.eval(), dataset=dataset, batch_size=16,
                               detector=detectors.RandomProjectionDetector(FEATURES))
    yield jctx, ctx
    mp.undo()


@pytest.mark.parametrize('name', ['kid50k', 'kid50k_full', 'pr50k3', 'pr50k3_full', 'is50k'])
def test_registry_entry_as_jax(contexts, name):
    jctx, ctx = contexts
    ref = getattr(jax_registry, name)(jctx)
    with np.errstate(invalid='ignore'):
        got = getattr(registry, name)(ctx)
    print(f'{name} at {NUM_GEN} generated images: port {got}, JAX {ref}')
    assert set(got) == set(ref)
    for key in ref:
        if name.startswith('kid'):
            np.testing.assert_allclose(got[key], ref[key], rtol=KID_TOL)
        elif name.startswith('pr'):
            assert abs(got[key] - ref[key]) <= PR_TOL
        else:  # the random projection's features are no probabilities: NaN, as in JAX
            assert np.isnan(got[key]) == np.isnan(ref[key])


def test_registry_images_as_jax(contexts):
    """The image sampler on JAX's conditioning: the uint8 images of JAX's
    sampler, but for a few pixels one level apart."""
    jctx, ctx = contexts
    ref = np.asarray(jctx.make_image_sampler()(16, 0)).astype(int)
    got = ctx.make_image_sampler()(16, 0).numpy().astype(int)
    diff = np.abs(got - ref)
    print(f'image sampler: {np.mean(diff > 0):.3g} of the values differ, by at most {diff.max()}')
    assert diff.max() <= 1 and np.mean(diff > 0) <= 1e-3


def test_ppl_pairs_as_jax(contexts, monkeypatch):
    jctx, ctx = contexts
    captured = {}

    def capture(sample_pair, detector, **kw):
        captured.update(sample_pair=sample_pair, kw=kw)
        return 0.0

    monkeypatch.setattr(jax_ppl, 'compute_ppl', capture)
    jax_registry.ppl2_wend(jctx)
    assert captured['kw']['num_samples'] == 2048 and captured['kw']['epsilon'] == 1e-4
    ref = [np.asarray(a).astype(int) for a in captured['sample_pair'](16, 3)]
    got = [a.numpy().astype(int) for a in ctx.make_pair_sampler()(16, 3)]
    for a, b in zip(got, ref):
        diff = np.abs(a - b)
        assert a.shape == (16, 64, 64, 3) and diff.max() <= 1 and np.mean(diff > 0) <= 1e-3
    assert not np.array_equal(got[0], got[1])  # t + epsilon moves the image
    real = ppl.compute_ppl
    monkeypatch.setattr(ppl, 'compute_ppl', lambda fn, det, **kw: real(
        fn, det, **dict(kw, num_samples=8)))
    value = registry.ppl2_wend(ctx)['ppl2_wend']
    assert np.isfinite(value) and value >= 0


class Reached(Exception):
    pass


def test_no_entry_refuses_a_3d_generator_and_2d_is_refused(contexts, monkeypatch):
    """Every entry of the registry reaches one of the 3D model's samplers
    (stopped there); on a 2D model the samplers raise NotImplementedError."""
    _, ctx = contexts
    assert set(registry.list_metrics()) == set(jax_registry.list_metrics())
    with monkeypatch.context() as m:
        for name in ('make_image_sampler', 'make_depth_sampler', 'make_pair_sampler'):
            m.setattr(registry.EvalContext, name, lambda self, *a, **k: (_ for _ in ()).throw(
                Reached()))
        for name in registry.list_metrics():
            with pytest.raises(Reached):
                registry.calc_metric(name, ctx)
    ctx2d = registry.EvalContext(cfg=load_config(preset='stylegan2'), G=None)
    for name in ('nfs256', 'is50k', 'ppl2_wend'):
        with pytest.raises(NotImplementedError, match='2D StyleGAN2'):
            registry.calc_metric(name, ctx2d)
