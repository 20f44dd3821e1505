"""The training loop: data, schedules, ticks, snapshots, metrics, logging
(port of `tdgp/training/loop.py`, for one device).

The step is `Trainer.step`; this module owns what happens around it: the
batch prefetch and its copy to the device, the schedules, the R1 cadence,
the ADA controller, the tick's statistics in stats.jsonl, snapshots and
resume, best-snapshot retention, the in-loop metric with a failure
containment that re-arms, and a host-memory watchdog.
"""
from __future__ import annotations

import dataclasses
import os
import time
import traceback
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from tdgp_torch import checkpoint as ckpt
from tdgp_torch.config import Config
from tdgp_torch.data.dataset import BatchLoader, ImageFolderDataset, normalize_batch
from tdgp_torch.training.schedules import compute_schedules
from tdgp_torch.training.telemetry import (TBWriter, camera_posterior,
                                           camera_posterior_report, progress_scalars)
from tdgp_torch.training.train_step import Trainer
from tdgp_torch.utils.draws import Draws
from tdgp_torch.utils.misc import resolve_device
from tdgp_torch.utils.profiling import PhaseTimer, trace
from tdgp_torch.utils.stats import JsonlLogger, StatsCollector


def _rss_gb() -> float:
    """Resident set size of this process in GB (0.0 if unreadable)."""
    try:
        with open('/proc/self/status') as f:
            for line in f:
                if line.startswith('VmRSS'):
                    return int(line.split()[1]) / 1e6
    except (OSError, ValueError, IndexError):
        pass
    return 0.0


def synthetic_batch_iterator(cfg: Config, batch_size: int, seed: int = 0):
    """Random batches in the loader's format, for runs without a dataset."""
    rng = np.random.RandomState(seed)
    res = cfg.dataset.resolution
    c_dim = cfg.dataset.c_dim
    while True:
        c = np.zeros((batch_size, c_dim), dtype=np.float32)
        if c_dim > 0:
            c[np.arange(batch_size), rng.randint(0, c_dim, batch_size)] = 1
        yield {
            'img': rng.uniform(-1, 1, (batch_size, res, res, 3)).astype(np.float32),
            'depth': rng.uniform(-1, 1, (batch_size, res, res, 1)).astype(np.float32),
            'c': c,
            'camera_angles': np.concatenate([
                rng.uniform(0.5, 1.5, (batch_size, 2)),
                np.zeros((batch_size, 1))], axis=1).astype(np.float32),
            'embs': rng.randn(batch_size, cfg.dataset.embedding_dim).astype(np.float32),
        }


def with_gen_conditioning(iterator, dataset, cfg: Config, seed: int = 0):
    """Attach the generator's conditioning to each batch: labels of random
    dataset items ('gen_c_g', 'gen_c_d'), and their camera angles too
    ('gen_camera_angles_g', ...) when the angle distribution is 'custom'."""
    rng = np.random.RandomState(seed + 0x9e3779)
    custom = cfg.camera.origin.angles.dist == 'custom'
    use_labels = cfg.dataset.c_dim > 0
    if not (custom or use_labels):
        yield from iterator
        return
    for batch in iterator:
        n = len(batch['img'])
        out = dict(batch)
        for suffix in ('g', 'd'):
            idx = rng.randint(len(dataset), size=n)
            if use_labels:
                out[f'gen_c_{suffix}'] = np.stack(
                    [dataset.get_label(i) for i in idx]).astype(np.float32)
            if custom:
                out[f'gen_camera_angles_{suffix}'] = np.stack(
                    [dataset.get_camera_angles(i) for i in idx]).astype(np.float32)
        yield out


def make_data_iterator(cfg: Config, batch_size: int):
    """The training batches: from `cfg.dataset.path` through a prefetching
    loader when it is set, else synthetic. Returns (iterator, loader or None)."""
    t = cfg.training
    if cfg.dataset.path:
        dataset = ImageFolderDataset(
            cfg.dataset.path, resolution=cfg.dataset.resolution,
            use_labels=cfg.dataset.c_dim > 0, use_depth=t.use_depth,
            use_embeddings=cfg.dataset.use_embeddings and cfg.loss.kd.weight > 0,
            mirror=cfg.dataset.mirror, max_size=cfg.dataset.max_size,
            embeddings_path=cfg.dataset.embeddings_path,
            embeddings_desc_path=cfg.dataset.embeddings_desc_path)
        loader = BatchLoader(dataset, batch_size, seed=t.seed, num_threads=2)
        return with_gen_conditioning(
            (normalize_batch(b, compact=t.compact_transfer) for b in loader),
            dataset, cfg, seed=t.seed), loader
    return synthetic_batch_iterator(cfg, batch_size, seed=t.seed), None


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A numpy batch as float32 tensors on `device`. Raw u8 images and u16
    depth (`normalize_batch(compact=True)`) are copied as they are and
    normalized there, with `normalize_batch`'s arithmetic."""
    out = {}
    for k, v in batch.items():
        if k == 'img' and v.dtype == np.uint8:
            out[k] = torch.from_numpy(v).to(device).float() / 127.5 - 1.0
        elif k == 'depth' and v.dtype == np.uint16:
            # copied as int16 bits, widened on the device: few of torch's
            # device operations take uint16
            raw = torch.from_numpy(v.view(np.int16)).to(device).int() & 0xFFFF
            out[k] = raw.float() / 65536 * 2.0 - 1.0
        else:
            out[k] = torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)).to(device)
    return out


@dataclasses.dataclass
class LoopResult:
    """Where a run of the loop stopped."""
    trainer: Trainer
    run_dir: str
    cur_nimg: int
    batch_idx: int
    ada_p: float
    resumed_from: Optional[str]
    resume_meta: Dict


def ada_adjust(signs: float, cfg: Config, batch_size: int) -> float:
    """The ADA controller's step of p: sign(signs - target) x the images
    since its last step over ada_kimg thousand."""
    a = cfg.training.augment
    return float(np.sign(signs - a.target) * (batch_size * a.ada_interval) / (a.ada_kimg * 1000))


def training_loop(
    cfg: Config,
    run_dir: str,
    *,
    device: Union[str, torch.device] = 'cuda',
    metric_fn: Optional[Callable] = None,      # (trainer, cur_nimg) -> {name: value}
    vis_fn: Optional[Callable] = None,         # (trainer, cur_nimg) -> None
    max_kimg: Optional[float] = None,
    verbose: bool = True,
) -> LoopResult:
    device = resolve_device(device)
    os.makedirs(run_dir, exist_ok=True)
    t = cfg.training
    batch_size = t.batch_size
    total_kimg = max_kimg if max_kimg is not None else t.total_kimg

    trainer = Trainer(cfg, device, seed=t.seed)
    generator = torch.Generator(device=device).manual_seed(t.seed)
    draws = Draws(generator)
    cur_nimg = 0
    resume_meta: dict = {}
    resume_path = ckpt.resolve_resume(run_dir, t.resume)
    if resume_path:
        resume_meta = ckpt.load_snapshot(resume_path, trainer, generator)
        cur_nimg = int(resume_meta.get('cur_nimg', 0))
        if verbose:
            print(f'Resumed from {resume_path} at {cur_nimg / 1e3:.3f} kimg')

    collector = StatsCollector()
    jsonl = JsonlLogger(os.path.join(run_dir, 'stats.jsonl'))
    tb = TBWriter(os.path.join(run_dir, 'tensorboard'), enabled=t.tensorboard)
    timer = PhaseTimer()
    profile_ctx = trace(os.path.join(run_dir, 'profiling_logs'), enabled=t.run_profiling)
    profile_ctx.__enter__()  # closed after tick 2
    profiling = t.run_profiling
    batch_idx = int(resume_meta.get('batch_idx', 0))
    cur_tick = 0
    tick_start_nimg = cur_nimg
    tick_start_time = time.time()
    start_time = tick_start_time
    ada_p = 0.0 if t.augment.mode != 'fixed' else t.augment.p
    ada_p = float(resume_meta.get('ada_p', ada_p))
    ada_signs_acc: list = []
    best_metric = None
    best_snapshot_path = None
    main_metric = t.metrics[0] if t.metrics else None
    # a failed metric evaluation skips 2^streak val ticks (at most 8) before
    # it is tried again; a success re-arms it fully
    metric_fail_streak = 0
    metric_retry_tick = 0
    # step statistics stay on the device until the tick: reading a value
    # waits for the card
    stats_buf: list = []

    def drain_stats():
        for s in stats_buf:
            collector.report_dict({k: float(v) for k, v in s.items()})
        stats_buf.clear()

    def snapshot():
        return ckpt.save_snapshot(run_dir, trainer, generator, cur_nimg=cur_nimg,
                                  meta={'batch_idx': batch_idx, 'ada_p': ada_p})

    batch_iterator, loader = make_data_iterator(cfg, batch_size)
    try:
        while True:
            with timer.phase('data'):
                batch = next(batch_iterator)
                batch.pop('_indices', None)
                local_angles = batch.get('gen_camera_angles_g', batch.get('camera_angles'))
                batch = to_device(batch, device)
            sched = compute_schedules(cfg, cur_nimg, ada_p=ada_p)
            do_r1 = (cfg.loss.r1_gamma > 0) and (batch_idx % cfg.loss.r1_interval == 0)
            with timer.phase('step_dispatch'):
                stats = trainer.step(batch, sched, do_r1, draws)
            stats_buf.append(stats)
            if 'Loss/signs/real' in stats:
                ada_signs_acc.append(stats['Loss/signs/real'])
            cur_nimg += batch_size
            batch_idx += 1

            # the ADA controller; p stays in [0, 1]
            if (t.augment.mode == 'ada' and batch_idx % t.augment.ada_interval == 0
                    and ada_signs_acc):
                # reading the signs waits for the card, so this phase takes
                # up the device time the dispatch did not
                with timer.phase('ada_sync'):
                    signs = float(np.mean([float(s) for s in ada_signs_acc]))
                ada_p = min(max(ada_p + ada_adjust(signs, cfg, batch_size), 0.0), 1.0)
                ada_signs_acc = []

            done = cur_nimg >= total_kimg * 1000
            if not done and cur_nimg < tick_start_nimg + t.tick_kimg * 1000:
                continue

            # ------------------------------------------------------------ tick
            cur_tick += 1
            with timer.phase('stats_sync', sync=device):
                drain_stats()
            now = time.time()
            sec_per_tick = now - tick_start_time
            sec_per_kimg = sec_per_tick / max((cur_nimg - tick_start_nimg) / 1e3, 1e-8)
            collector.report('Timing/sec_per_tick', sec_per_tick)
            collector.report('Timing/sec_per_kimg', sec_per_kimg)
            collector.report_dict(timer.means())
            timer.reset()
            collector.report_dict(progress_scalars(sched, ada_p))
            collector.report_dict(camera_posterior_report(
                camera_posterior(trainer.G, cfg, draws.scope('posterior'),
                                 origin_angles=local_angles), tb=tb, step=cur_nimg))
            if cur_tick == 2 and profiling:
                profile_ctx.__exit__(None, None, None)
                profiling = False
            if verbose:
                print(f"tick {cur_tick:<5d} kimg {cur_nimg / 1e3:<8.3f} "
                      f"time {now - start_time:<10.1f} sec/kimg {sec_per_kimg:<7.2f} "
                      f"G_loss {collector.mean('Loss/G/loss'):<6.3f} "
                      f"D_loss {collector.mean('Loss/D/loss'):<6.3f} augment_p {ada_p:.3f}",
                      flush=True)

            if vis_fn is not None and cur_tick % t.image_snap == 0:
                vis_fn(trainer, cur_nimg)

            # the snapshot comes before the metric, so that a failed
            # evaluation cannot lose the tick's weights
            path = snapshot() if (cur_tick % t.snap == 0 or done) else None

            metric_results: Dict[str, float] = {}
            if (metric_fn is not None and t.metrics and cur_tick >= metric_retry_tick
                    and (cur_tick % t.val_freq == 0 or done)):
                try:
                    metric_results = metric_fn(trainer, cur_nimg)
                    for name, value in metric_results.items():
                        collector.report(f'Metrics/{name}', value)
                    metric_fail_streak = 0
                except Exception as e:  # noqa: BLE001 - contained, logged, retried
                    metric_fail_streak += 1
                    skip = min(2 ** metric_fail_streak, 8)
                    metric_retry_tick = cur_tick + skip * t.val_freq
                    collector.report('Metrics/eval_failed', 1.0)
                    if verbose:
                        traceback.print_exc()
                        print(f'WARNING: in-loop metric eval failed ({type(e).__name__}: '
                              f'{str(e)[:200]}); streak {metric_fail_streak}, retrying '
                              f'at tick {metric_retry_tick}', flush=True)

            if path is not None and main_metric and main_metric in metric_results:
                value = metric_results[main_metric]
                if best_metric is None or value < best_metric:
                    if best_snapshot_path and best_snapshot_path != path:
                        prev_kimg = ckpt.snapshot_kimg(best_snapshot_path)
                        if prev_kimg % (t.snap * t.tick_kimg) != 0:
                            ckpt.delete_snapshot(best_snapshot_path)
                    best_metric, best_snapshot_path = value, path

            tick_stats = collector.as_dict()
            jsonl.write(tick_stats)
            tb.scalars({k: v['mean'] for k, v in tick_stats.items()}, cur_nimg)
            tb.flush()
            collector.reset()
            tick_start_nimg = cur_nimg
            tick_start_time = time.time()
            if done:
                break
            # host-memory watchdog: snapshot and stop, for a restart that
            # resumes from the run directory
            if t.max_rss_gb and _rss_gb() > t.max_rss_gb:
                if path is None:
                    snapshot()
                if verbose:
                    print(f'RSS {_rss_gb():.1f} GB > training.max_rss_gb={t.max_rss_gb}: '
                          f'snapshot saved at {cur_nimg / 1e3:.3f} kimg; stopping for a '
                          f'restart (resume with --run-dir)', flush=True)
                break
    finally:
        if profiling:
            profile_ctx.__exit__(None, None, None)
        jsonl.close()
        tb.close()
        if loader is not None:
            loader.close()
    return LoopResult(trainer=trainer, run_dir=run_dir, cur_nimg=cur_nimg, batch_idx=batch_idx,
                      ada_p=ada_p, resumed_from=resume_path, resume_meta=resume_meta)
