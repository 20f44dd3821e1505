"""The port's training loop and its entry point, on the CPU at `tiny_test_config`
(float32 D, KD off: the synthetic folder has no embeddings), fed from a tiny
folder that `data_scripts/make_synthetic_dataset.py` writes; and the presets
and config loading against the JAX package's.

The loop: six ticks of two steps with ADA reacting every tick (its target
set below the logged signs, so that p rises), a snapshot every tick and an
in-loop metric at every tick that fails on its first and fourth calls. Then
stats.jsonl (the JAX loop's keys, ADA's p by the controller's formula), the
metric's containment (the failures logged, two val ticks skipped after each,
re-armed by a success), the snapshot (its meta, its modules, optimizers and
random state as the run ended) and a resume (cur_nimg, batch_idx and ada_p
restored).
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from tdgp.config import asdict as jax_asdict
from tdgp.infra.experiment import load_config as jax_load_config
from tdgp.training.schedules import compute_schedules as jax_schedules
from tdgp.training.telemetry import progress_scalars as jax_progress_scalars

from tdgp_torch import checkpoint as ckpt
from tdgp_torch.config import load_config
from tdgp_torch.infra.experiment import create_experiment_dir
from tdgp_torch.metrics import registry
from tdgp_torch.scripts import train as train_script
from tdgp_torch.training.loop import ada_adjust, training_loop
from tdgp_torch.training.train_step import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TICKS, STEPS_PER_TICK, BATCH = 6, 2, 4
CAMERA_KEYS = {f'Camera/{tag}/{name}/{stat}' for tag in ('posterior', 'prior')
               for name in ('yaw', 'pitch', 'fov', 'radius', 'look_at_x', 'look_at_y',
                            'look_at_z') for stat in ('mean', 'std')}
TIMING_KEYS = {'Timing/sec_per_tick', 'Timing/sec_per_kimg', 'Timing/data',
               'Timing/step_dispatch', 'Timing/ada_sync', 'Timing/stats_sync'}


@pytest.fixture(scope='module', autouse=True)
def _one_thread_per_worker():
    """One torch and one BLAS thread while this module runs: the test workers
    share the cores, and OpenBLAS's threads spin while the others hold them."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api='blas'):
        yield
    torch.set_num_threads(saved)


@pytest.fixture(scope='module')
def folder(tmp_path_factory):
    out = str(tmp_path_factory.mktemp('data') / 'synth64')
    subprocess.run([sys.executable, os.path.join(ROOT, 'data_scripts', 'make_synthetic_dataset.py'),
                    '--out', out, '--n', '16', '--res', '64'], check=True, capture_output=True,
                   timeout=120)
    return out


def overrides(folder):
    return ['discriminator.fp32_only=true', 'loss.kd.weight=0', f'dataset.path={folder}',
            f'training.tick_kimg={BATCH * STEPS_PER_TICK / 1e3}', 'training.tensorboard=false',
            'training.augment.mode=ada', f'training.augment.ada_interval={STEPS_PER_TICK}',
            'training.augment.ada_kimg=1', 'training.augment.target=-2.0', 'training.snap=1',
            'training.val_freq=1', 'training.image_snap=100', 'training.metrics=[probe]']


def read(run_dir):
    with open(os.path.join(run_dir, 'stats.jsonl')) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope='module')
def run(folder, tmp_path_factory):
    cfg = load_config(overrides=overrides(folder), preset='tiny')
    run_dir = str(tmp_path_factory.mktemp('run'))
    calls = []

    def metric_fn(trainer, cur_nimg):
        calls.append(cur_nimg)
        if len(calls) in (1, 3):
            raise RuntimeError('simulated metric failure')
        return {'probe': 1.0 / len(calls)}

    result = training_loop(cfg, run_dir, device='cpu', metric_fn=metric_fn,
                           max_kimg=TICKS * STEPS_PER_TICK * BATCH / 1e3, verbose=False)
    return cfg, run_dir, result, calls, read(run_dir)


def test_stats_jsonl_has_the_jax_loop_keys(run):
    cfg, _, _, _, lines = run
    progress = set(jax_progress_scalars(jax_schedules(jax_load_config(preset='tiny'), 0), 0.0))
    assert len(lines) == TICKS
    for line in lines:
        missing = (progress | CAMERA_KEYS | TIMING_KEYS | {'timestamp', 'Loss/G/loss',
                                                          'Loss/D/loss', 'Loss/signs/real'}
                   ) - set(line)
        assert not missing
        assert all(np.isfinite(v['mean']) for k, v in line.items() if k.startswith('Loss/'))
    assert 'Loss/D/r1_penalty' in lines[0] and 'Loss/D/r1_penalty' not in lines[1]


def test_ada_p_follows_the_controller(run):
    cfg, _, result, _, lines = run
    p, expected = 0.0, []
    for line in lines:
        p = min(max(p + ada_adjust(line['Loss/signs/real']['mean'], cfg, BATCH), 0.0), 1.0)
        expected.append(p)
    logged = [line['Progress/augment_p']['mean'] for line in lines]
    np.testing.assert_allclose(logged, expected, rtol=0, atol=1e-12)
    assert expected[-1] == pytest.approx(TICKS * BATCH * STEPS_PER_TICK / 1000)
    assert result.ada_p == pytest.approx(expected[-1])


@pytest.mark.parametrize('signs,p,expected', [(0.9, 0.0, 0.016), (0.1, 0.01, 0.0),
                                               (0.9, 0.995, 1.0)])
def test_ada_step_and_clamp(signs, p, expected):
    cfg = load_config(overrides=['training.augment.ada_kimg=1', 'training.augment.ada_interval=4'],
                      preset='tiny')
    assert min(max(p + ada_adjust(signs, cfg, 4), 0.0), 1.0) == pytest.approx(expected)


def test_metric_failure_containment_rearms(run):
    """Failures at ticks 1 and 4 (the first and third call), each followed by
    2^1 val ticks without a call; the successes at ticks 3 and 6 re-arm."""
    _, _, _, calls, lines = run
    assert calls == [t * STEPS_PER_TICK * BATCH for t in (1, 3, 4, 6)]
    failed = [i + 1 for i, line in enumerate(lines) if 'Metrics/eval_failed' in line]
    probed = [i + 1 for i, line in enumerate(lines) if 'Metrics/probe' in line]
    assert failed == [1, 4] and probed == [3, 6]


def test_snapshot_holds_the_end_of_the_run(run):
    cfg, run_dir, result, _, _ = run
    snaps = ckpt.list_snapshots(run_dir)
    assert [k for k, _ in snaps] == [0]
    path = snaps[0][1]
    with open(path + '.meta.json') as f:
        meta = json.load(f)
    assert meta == {'cur_nimg': result.cur_nimg, 'batch_idx': TICKS * STEPS_PER_TICK,
                    'ada_p': result.ada_p}
    fresh = Trainer(cfg, 'cpu', seed=5)
    generator = torch.Generator()
    ckpt.load_snapshot(path, fresh, generator)
    for name in ('G', 'D', 'G_ema'):
        a, b = getattr(fresh, name).state_dict(), getattr(result.trainer, name).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a), name
    for name in ('g_opt', 'd_opt'):
        a, b = getattr(fresh, name).state_dict(), getattr(result.trainer, name).state_dict()
        assert all(torch.equal(a['state'][i]['exp_avg'], b['state'][i]['exp_avg'])
                   for i in a['state']), name
    assert ckpt.resolve_resume(run_dir, 'latest') == path
    assert ckpt.resolve_resume(run_dir, 'none') is None
    assert ckpt.snapshot_kimg(path) == 0 and ckpt.snapshot_kimg('000012') == 12


def test_resume_restores_the_loop_state(run, folder, tmp_path):
    cfg, run_dir, result, _, lines = run
    resumed_dir = str(tmp_path / 'resumed')
    os.makedirs(resumed_dir)
    src = ckpt.list_snapshots(run_dir)[0][1]
    dst = os.path.join(resumed_dir, os.path.basename(src))
    shutil.copytree(src, dst)
    with open(src + '.meta.json') as f, open(dst + '.meta.json', 'w') as g:
        g.write(f.read())
    cfg = dataclasses.replace(cfg, training=dataclasses.replace(cfg.training, metrics=()))
    more = training_loop(cfg, resumed_dir, device='cpu',
                         max_kimg=(TICKS + 1) * STEPS_PER_TICK * BATCH / 1e3, verbose=False)
    assert more.resumed_from == dst
    assert more.resume_meta == {'cur_nimg': result.cur_nimg, 'batch_idx': result.batch_idx,
                                'ada_p': result.ada_p}
    assert (more.cur_nimg, more.batch_idx) == (result.cur_nimg + STEPS_PER_TICK * BATCH,
                                               result.batch_idx + STEPS_PER_TICK)
    line = read(resumed_dir)[-1]
    assert line['Progress/augment_p']['mean'] == pytest.approx(
        result.ada_p + ada_adjust(line['Loss/signs/real']['mean'], cfg, BATCH))


@pytest.mark.parametrize('preset', ['default', 'tiny', 'satellite', 'synth64', 'synth256',
                                    'stylegan2', 'imagenet'])
@pytest.mark.parametrize('finalize', [False, True])
def test_presets_as_jax(preset, finalize):
    assert dataclasses.asdict(load_config(preset=preset, finalize=finalize)) == jax_asdict(
        jax_load_config(preset=preset, finalize=finalize))


def test_frozen_yaml_with_a_preset_key_as_jax(tmp_path):
    path = str(tmp_path / 'cfg.yaml')
    with open(path, 'w') as f:
        f.write('preset: synth64\ntraining:\n  batch_size: 8\n  augment:\n    p: 0.3\n')
    ov = ['training.augment.mode=fixed', 'dataset.path=x']
    assert dataclasses.asdict(load_config(path, ov, preset='tiny')) == jax_asdict(
        jax_load_config(path, ov, preset='tiny'))


def test_experiment_dir_and_its_frozen_config(tmp_path):
    cfg = load_config(preset='synth256', overrides=['dataset.path=x'])
    run_dir = create_experiment_dir(cfg, str(tmp_path), desc='probe')
    assert os.path.basename(run_dir).startswith('synth256-3dgp-p64-b16-')
    assert run_dir.endswith('-probe')
    frozen = os.path.join(run_dir, 'experiment_config.yaml')
    assert dataclasses.asdict(load_config(frozen)) == dataclasses.asdict(cfg)
    assert jax_asdict(jax_load_config(frozen)) == dataclasses.asdict(cfg)


def test_train_script_on_the_cpu(folder, tmp_path, capsys):
    """`scripts.train --preset tiny --device cpu`: a dry run prints the config;
    a run of two ticks writes the run directory, a snapshot and the image
    grid, and `--run-dir` resumes it from its frozen config."""
    base = ['--preset', 'tiny', '--device', 'cpu', '--run-root', str(tmp_path)]
    ov = overrides(folder)[:-1] + ['training.metrics=[]', 'training.image_snap=2']
    train_script.main(base + ['--dry-run'] + ov)
    printed = json.loads(capsys.readouterr().out)
    assert printed['training']['augment']['mode'] == 'ada'
    result = train_script.main(base + ['--max-kimg', str(2 * STEPS_PER_TICK * BATCH / 1e3)] + ov)
    names = set(os.listdir(result.run_dir))
    assert {'experiment_config.yaml', 'stats.jsonl', 'network-snapshot-000000',
            'fakes000000.png'} <= names
    again = train_script.main(['--device', 'cpu', '--run-dir', result.run_dir, '--max-kimg',
                               str(3 * STEPS_PER_TICK * BATCH / 1e3)])
    assert again.resumed_from.endswith('network-snapshot-000000')
    assert again.batch_idx == 3 * STEPS_PER_TICK


def test_train_script_records_fid_nfs_and_a_best_snapshot(tmp_path, monkeypatch):
    """`scripts.train` with `training.metrics=[fid2k_full,nfs256]` (the
    default metrics of the satellite and imagenet presets), tiny at 32^2 for
    one tick, fid2k_full on 64 generated images (its own 2048 take minutes on
    the CPU): both metric files get a finite line, the tick's stats carry
    both and no failed evaluation, and the snapshot is the run's best."""
    real = registry.compute_feature_stats_for_generator
    monkeypatch.setattr(registry, 'compute_feature_stats_for_generator',
                        lambda *a, **kw: real(*a, **dict(kw, max_items=64)))
    folder32 = str(tmp_path / 'synth32')
    subprocess.run([sys.executable, os.path.join(ROOT, 'data_scripts', 'make_synthetic_dataset.py'),
                    '--out', folder32, '--n', '16', '--res', '32'], check=True,
                   capture_output=True, timeout=120)
    ov = ['discriminator.fp32_only=true', 'loss.kd.weight=0', f'dataset.path={folder32}',
          'generator.img_resolution=32', 'dataset.resolution=32',
          f'training.tick_kimg={BATCH / 1e3}', 'training.tensorboard=false', 'training.snap=1',
          'training.val_freq=1', 'training.image_snap=100',
          'training.metrics=[fid2k_full,nfs256]']
    result = train_script.main(['--preset', 'tiny', '--device', 'cpu', '--run-root',
                                str(tmp_path / 'runs'), '--max-kimg', str(BATCH / 1e3)] + ov)
    run_dir = result.run_dir
    for name in ('fid2k_full', 'nfs256'):
        with open(os.path.join(run_dir, f'metric-{name}.jsonl')) as f:
            lines = [json.loads(line) for line in f]
        assert len(lines) == 1 and np.isfinite(lines[0]['results'][name]), name
    stats = read(run_dir)[-1]
    assert {'Metrics/fid2k_full', 'Metrics/nfs256'} <= set(stats)
    assert 'Metrics/eval_failed' not in stats
    assert stats['Metrics/nfs256']['mean'] >= 1.0
    assert ckpt.find_best_checkpoint(run_dir) == ckpt.snapshot_path(run_dir, 0)


def test_train_script_takes_overrides_between_its_options(folder, capsys):
    """Dotted overrides may come before, between and after the flags."""
    train_script.main(['--preset', 'tiny', f'dataset.path={folder}', '--device', 'cpu',
                       'training.dmain_reuse_fakes=false', '--dry-run', 'loss.kd.weight=0'])
    printed = json.loads(capsys.readouterr().out)
    assert printed['training']['dmain_reuse_fakes'] is False
    assert printed['loss']['kd']['weight'] == 0 and printed['dataset']['path'] == folder


def test_train_script_needs_a_card_unless_given_the_cpu(folder, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_script.main(['--preset', 'tiny'] + overrides(folder))


def test_synthetic_batches_and_the_memory_watchdog(tmp_path):
    """Without a dataset the loop trains on synthetic batches (KD on, with
    their embeddings); above `max_rss_gb` it snapshots after the tick and
    stops before `max_kimg`."""
    cfg = load_config(overrides=['discriminator.fp32_only=true', 'training.tensorboard=false',
                                 'training.tick_kimg=0.008', 'training.snap=100',
                                 'training.max_rss_gb=0.000001'], preset='tiny')
    result = training_loop(cfg, str(tmp_path), device='cpu', max_kimg=1.0, verbose=False)
    assert (result.cur_nimg, result.batch_idx) == (8, 2)
    lines = read(str(tmp_path))
    assert len(lines) == 1 and 'Loss/kd/D_loss' in lines[0]
    assert [k for k, _ in ckpt.list_snapshots(str(tmp_path))] == [0]


@pytest.mark.parametrize('fov,radius,scale', [(12.0, 1.0, 0.5), (30.0, 1.0, 0.5),
                                              (12.0, 1.3, 0.5), (18.0, 1.0, 1.0)])
def test_frustum_validation_as_jax(fov, radius, scale):
    from tdgp.rendering.camera import validate_frustum as jax_validate
    from tdgp_torch.rendering.camera import validate_frustum
    args = dict(fov=fov, near=0.75, far=1.25, radius=radius, scale=scale, step=0.05)
    assert validate_frustum(**args) == jax_validate(**args)
