"""The port's own snapshots through its entry points, the EMA export and the
offline metric scripts, against the JAX package on the CPU.

- `checkpoint.find_best_checkpoint` against `tdgp.checkpoint`'s on the same
  run directories: the best value, ties, a metric line of a deleted
  snapshot, no metric file, no snapshot;
- `weights.flat_from_module` -> `.npz` -> `tdgp.checkpoint.variables_from_flat`
  and the JAX `Generator`: the keys of JAX's variables, and the same image
  as the port's at rtol = atol = 1e-4 (XLA:CPU vs PyTorch float32);
- a tiny run written by `tdgp_torch.scripts.train --preset tiny --device
  cpu` at 32^2 (two ticks, a snapshot at each, fid2k_full at the second, on
  FID_IMAGES generated images):
  `load_run` with 'latest', 'best' and
  the snapshot's path gives the trainer's G_ema exactly; `export_ema` then
  `load_run` of the `.npz` gives the same image bit for bit; `calc_metrics`
  gives the loop's fid2k_full for the snapshot (the same G_ema, detector,
  dataset, batch and draws: held to 1e-9 relative, as two runs of the same
  float64 statistics);
- `calc_metrics --metrics nfs256` on the snapshot against the JAX registry's
  nfs256 on the same weights, at 1e-4 relative;
- `calc_metrics_for_dataset` (fid and kid) against `tdgp`'s FID and KID of
  the same two folders with the same detector, at 1e-4 relative.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from tdgp import checkpoint as jax_ckpt
from tdgp import inference as jax_inference
from tdgp.checkpoint import variables_from_flat
from tdgp.config import tiny_test_config as jax_tiny_test_config
from tdgp.models.epigraf import Generator as JaxGenerator
from tdgp.utils.tensor_group import TensorGroup as JaxTensorGroup

from tdgp_torch import checkpoint as ckpt
from tdgp_torch import inference
from tdgp_torch.config import tiny_test_config
from tdgp_torch.metrics import registry
from tdgp_torch.models.epigraf import Generator
from tdgp_torch.models.layers import init_weights
from tdgp_torch.scripts import calc_metrics, calc_metrics_for_dataset, export_ema
from tdgp_torch.scripts import inference as inference_script
from tdgp_torch.scripts import train as train_script
from tdgp_torch.utils.tensor_group import TensorGroup
from tdgp_torch.weights import flat_from_module, load_flat

from test_torch_inference import _jax_generator, _ws_and_cameras

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
BATCH, STEPS_PER_TICK, TICKS, RES = 4, 2, 2, 32
FID_IMAGES = 64  # generated images of fid2k_full here (its own count is 2048)


@pytest.fixture(scope='module', autouse=True)
def _one_thread_per_worker():
    """One torch and one BLAS thread while this module runs: the test workers
    share the cores, and OpenBLAS's threads spin while the others hold them."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api='blas'):
        yield
    torch.set_num_threads(saved)


# ------------------------------------------------------------- best snapshot

BEST_CASES = {
    # name: (snapshot kimgs, metric lines (snapshot label, value)), expected kimg
    'best': ([0, 4, 8], [('000000', 5.0), ('000004', 3.0), ('network-snapshot-000008', 4.0)], 4),
    'ties': ([0, 4, 8], [('000008', 3.0), ('000004', 3.0), ('000000', 5.0)], 8),
    'deleted_snapshot': ([0, 4, 8], [('000012', 1.0), ('000004', 3.0), ('000008', 4.0)], 4),
    'no_metric_file': ([0, 4, 8], None, 8),
    'no_snapshot': ([], [('000004', 3.0)], None),
}


@pytest.mark.parametrize('case', list(BEST_CASES))
def test_find_best_checkpoint_as_jax(case, tmp_path):
    kimgs, lines, expected = BEST_CASES[case]
    run_dir = str(tmp_path)
    for kimg in kimgs:
        os.makedirs(ckpt.snapshot_path(run_dir, kimg))
    if lines is not None:
        with open(os.path.join(run_dir, 'metric-fid2k_full.jsonl'), 'w') as f:
            for label, value in lines:
                f.write(json.dumps({'results': {'fid2k_full': value}, 'snapshot': label}) + '\n')
    got = ckpt.find_best_checkpoint(run_dir)
    assert got == jax_ckpt.find_best_checkpoint(run_dir)
    assert got == (None if expected is None else ckpt.snapshot_path(run_dir, expected))


# ------------------------------------------------------------- the export layout

def test_flat_from_module_is_read_by_both_packages(tmp_path):
    """A port generator with weights of its own, exported: the keys are those
    of JAX's EMA variables, the port reads it back exactly, and the JAX
    `Generator` on `variables_from_flat` renders the port's image."""
    cfg, jcfg = tiny_test_config(), jax_tiny_test_config()
    port = init_weights(Generator(cfg.generator), torch.Generator().manual_seed(3)).eval()
    with torch.no_grad():
        port.mapping.w_avg.normal_(generator=torch.Generator().manual_seed(4))
    path = str(tmp_path / 'g_ema.npz')
    np.savez(path, **flat_from_module(port))
    _, _, jax_flat = _jax_generator(jcfg)
    with np.load(path) as flat:
        assert set(flat.files) == set(jax_flat)
        assert all(flat[k].shape == jax_flat[k].shape for k in flat.files)
        g_vars = variables_from_flat(flat)
        again = Generator(cfg.generator)
        load_flat(again, flat)
    for name, value in port.state_dict().items():
        assert torch.equal(again.state_dict()[name], value), name
    ws, cams = _ws_and_cameras(cfg, 2, seed=5)
    ws = ws[:, :port.synthesis.num_ws]
    ref = jax_inference.generate(JaxGenerator(jcfg.generator), g_vars, jnp.asarray(ws),
                                 JaxTensorGroup(**{k: jnp.asarray(v) for k, v in cams.items()}),
                                 batch_size=2, resolution=16)
    got = inference.generate(port, torch.from_numpy(ws),
                             TensorGroup(**{k: torch.from_numpy(v) for k, v in cams.items()}),
                             batch_size=2, resolution=16)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


# ------------------------------------------------------------- a run of the port

@pytest.fixture(scope='module')
def folder(tmp_path_factory):
    out = str(tmp_path_factory.mktemp('data') / f'synth{RES}')
    subprocess.run([sys.executable, os.path.join(ROOT, 'data_scripts', 'make_synthetic_dataset.py'),
                    '--out', out, '--n', '16', '--res', str(RES)], check=True,
                   capture_output=True, timeout=120)
    return out


def capped_fid(monkeypatch):
    """fid2k_full on FID_IMAGES generated images instead of 2048 (the CPU's
    render time; the loop and calc_metrics are held to each other, and the
    FID itself to tdgp's in tests/test_torch_metrics.py)."""
    real = registry.compute_feature_stats_for_generator
    monkeypatch.setattr(registry, 'compute_feature_stats_for_generator',
                        lambda *a, **kw: real(*a, **dict(kw, max_items=min(kw['max_items'],
                                                                             FID_IMAGES))))


@pytest.fixture(scope='module')
def tiny_run(folder, tmp_path_factory):
    """`scripts.train --preset tiny --device cpu` at 32^2 for two ticks of
    two steps, a snapshot at each tick and fid2k_full (`capped_fid`) at the
    second -> (the loop's result, its run directory)."""
    mp = pytest.MonkeyPatch()
    capped_fid(mp)
    overrides = ['discriminator.fp32_only=true', 'loss.kd.weight=0', f'dataset.path={folder}',
                 f'generator.img_resolution={RES}', f'dataset.resolution={RES}',
                 f'training.tick_kimg={BATCH * STEPS_PER_TICK / 1e3}',
                 'training.tensorboard=false', 'training.snap=1', f'training.val_freq={TICKS}',
                 'training.image_snap=100', 'training.metrics=[fid2k_full]']
    try:
        result = train_script.main(['--preset', 'tiny', '--device', 'cpu', '--run-root',
                                    str(tmp_path_factory.mktemp('runs')), '--max-kimg',
                                    str(TICKS * STEPS_PER_TICK * BATCH / 1e3)] + overrides)
    finally:
        mp.undo()
    return result, result.run_dir


def _same_module(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert set(sa) == set(sb)
    for name in sa:
        assert torch.equal(sa[name], sb[name]), name


@pytest.mark.parametrize('snapshot', ['latest', 'best', 'path'])
def test_load_run_reads_the_ports_snapshots(tiny_run, snapshot):
    result, run_dir = tiny_run
    path = ckpt.snapshot_path(run_dir, 0)
    cfg, G = inference_script.load_run(run_dir, path if snapshot == 'path' else snapshot,
                                       device='cpu')
    assert not G.training and cfg.generator == result.trainer.cfg.generator
    _same_module(G, result.trainer.G_ema)


def _image(G, cfg):
    z = inference.sample_z_from_seeds([0, 1], cfg.generator.z_dim, 'cpu')
    c = torch.eye(cfg.generator.c_dim)[:2]
    cams = inference.canonical_cameras(cfg, 2, G=G, z=z, c=c)
    ws = inference.sample_ws_from_seeds(G, [0, 1], c, cams.angles)
    return inference.generate(G, ws, cams, batch_size=2, resolution=16)


def test_export_ema_is_the_snapshots_generator(tiny_run, tmp_path):
    """`export_ema` then `load_run` of its `.npz` (the default name beside
    the snapshot, and an explicit `--out`): the same weights and image."""
    result, run_dir = tiny_run
    out = export_ema.main(['--run-dir', run_dir, '--snapshot', 'best'])
    assert out == os.path.join(run_dir, 'network-snapshot-000000-g_ema.npz')
    cfg, from_npz = inference_script.load_run(run_dir, os.path.basename(out), device='cpu')
    _, from_snapshot = inference_script.load_run(run_dir, 'latest', device='cpu')
    _same_module(from_npz, from_snapshot)
    np.testing.assert_array_equal(_image(from_npz, cfg), _image(from_snapshot, cfg))
    explicit = str(tmp_path / 'g.npz')
    export_ema.main(['--run-dir', run_dir, '--out', explicit])
    with np.load(out) as a, np.load(explicit) as b:
        assert a.files == b.files and all(np.array_equal(a[k], b[k]) for k in a.files)


def test_calc_metrics_gives_the_loops_value(tiny_run, monkeypatch):
    result, run_dir = tiny_run
    capped_fid(monkeypatch)
    metric_file = os.path.join(run_dir, 'metric-fid2k_full.jsonl')
    with open(metric_file) as f:
        loop = [json.loads(line) for line in f]
    assert [r['snapshot'] for r in loop] == ['000000']
    got = calc_metrics.main(['--run-dir', run_dir, '--snapshot', 'latest', '--device', 'cpu'])
    value = got[0]['results']['fid2k_full']
    np.testing.assert_allclose(value, loop[-1]['results']['fid2k_full'], rtol=1e-9)
    with open(metric_file) as f:
        last = json.loads(f.readlines()[-1])
    assert last['snapshot'] == '000000' and last['results']['fid2k_full'] == value


def test_calc_metrics_refuses_the_unported_metrics(tiny_run):
    """Every metric of the registry is ported; a name it lacks is refused."""
    with pytest.raises(ValueError, match='unknown metric'):
        calc_metrics.main(['--run-dir', tiny_run[1], '--snapshot', 'latest', '--device', 'cpu',
                           '--metrics', 'kid1k'])


def test_calc_metrics_nfs256_as_jax(tiny_run, folder):
    """`calc_metrics --metrics nfs256` on the snapshot against the JAX
    registry's nfs256 on the same weights (`flat_from_module` ->
    `variables_from_flat`) and dataset labels: within 1e-4 relative."""
    from tdgp.data.dataset import ImageFolderDataset as JaxDataset
    from tdgp.infra.experiment import load_config as jax_load_config
    from tdgp.metrics import registry as jax_registry
    result, run_dir = tiny_run
    got = calc_metrics.main(['--run-dir', run_dir, '--snapshot', 'latest', '--device', 'cpu',
                             '--metrics', 'nfs256'])[0]['results']['nfs256']
    jcfg = jax_load_config(os.path.join(run_dir, 'experiment_config.yaml'))
    ctx = jax_registry.EvalContext(
        cfg=jcfg, G=JaxGenerator(jcfg.generator),
        g_vars=variables_from_flat(flat_from_module(result.trainer.G_ema)),
        dataset=JaxDataset(folder, resolution=RES, use_labels=True))
    ref = jax_registry.nfs256(ctx)['nfs256']
    print(f'nfs256 of the snapshot: port {got!r}, JAX {ref!r}')
    assert got >= 1.0
    np.testing.assert_allclose(got, ref, rtol=1e-4)


# ------------------------------------------------------------- dataset vs dataset

def test_calc_metrics_for_dataset_fid_as_jax(folder, tmp_path, monkeypatch):
    """FID and KID of `calc_metrics_for_dataset` (its default `--metrics
    fid,kid`) against tdgp's on the same two folders with the same
    detector, a random projection to 256 features (the script's 2048 cut
    for time: the JAX package's sqrtm of a 2048^2 product takes minutes on a
    busy CPU), at 1e-4 relative."""
    from tdgp.data.dataset import ImageFolderDataset as JaxDataset
    from tdgp.metrics.detectors import RandomProjectionDetector as JaxDetector
    from tdgp.metrics.features import compute_feature_stats_for_dataset as jax_stats
    from tdgp.metrics.fid import compute_fid as jax_fid
    from tdgp.metrics.kid import compute_kid as jax_kid
    from tdgp_torch.metrics import detectors
    other = str(tmp_path / 'other')
    subprocess.run([sys.executable, os.path.join(ROOT, 'data_scripts', 'make_synthetic_dataset.py'),
                    '--out', other, '--n', '16', '--res', str(RES), '--seed', '1'], check=True,
                   capture_output=True, timeout=120)
    monkeypatch.setattr(detectors, 'make_fid_detector',
                        lambda device: detectors.RandomProjectionDetector(256, device=device))
    got = calc_metrics_for_dataset.main(['--real', folder, '--fake', other, '--device', 'cpu'])
    detector = JaxDetector(256)
    real, fake = (jax_stats(JaxDataset(d), detector, capture_mean_cov=True, capture_all=True)
                  for d in (folder, other))
    assert got['fid'] > 0
    np.testing.assert_allclose(got['fid'], jax_fid(real, fake), rtol=1e-4)
    np.testing.assert_allclose(got['kid'], jax_kid(real.get_all(), fake.get_all()), rtol=1e-4)


def test_calc_metrics_for_dataset_refuses_kid_and_needs_a_card(folder, monkeypatch):
    """KID is ported now; a metric the script lacks is refused, and the
    script runs on the card unless given the CPU."""
    with pytest.raises(ValueError, match='unknown metrics'):
        calc_metrics_for_dataset.main(['--real', folder, '--fake', folder, '--metrics', 'fid,is',
                                       '--device', 'cpu'])
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calc_metrics_for_dataset.main(['--real', folder, '--fake', folder])
