"""Metrics of a trained run's EMA generator (port of `scripts/calc_metrics.py`).

    python3 -m tdgp_torch.scripts.calc_metrics --run-dir RUN --metrics fid2k_full \
        [--snapshot best|latest|<path>] [--data DIR] [--batch-size 16] [--device cuda]

The flags are the JAX script's, plus `--device` (default cuda; cpu runs on
the CPU). `--snapshot` is read as by `tdgp_torch.scripts.inference`: the
port's own snapshots, a snapshot directory or an `.npz` export. Each result
is printed and appended to the run's metric-<name>.jsonl under the
snapshot's kimg (the label the training loop writes), or under the `.npz`
as given. Every metric of the registry runs (`tdgp_torch.metrics.registry`:
fid2k_full, fid5k_5k, fid50k_full, kid50k, kid50k_full, pr50k3,
pr50k3_full, is50k, ppl2_wend, nfs256). The detector is chosen as the JAX
script chooses it: InceptionV3 from the converted weights that
$TDGP_INCEPTION_WEIGHTS names, else (the repo holds none) the random
projection detector, the FID proxy of the JAX runs and of the training
loop; with the loop's batch size (16) and dataset, a snapshot's fid2k_full
is then the value the loop recorded for it.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Sequence

from tdgp_torch import checkpoint as ckpt
from tdgp_torch.scripts.inference import load_run, resolve_snapshot


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--run-dir', required=True)
    ap.add_argument('--snapshot', default='best')
    ap.add_argument('--metrics', default='fid2k_full')
    ap.add_argument('--data', default=None, help='dataset path (defaults to the config\'s)')
    ap.add_argument('--batch-size', type=int, default=16)
    ap.add_argument('--batch-gpu', type=int, default=None,
                    help='images rendered at once (default: the whole batch below 256^2, '
                         'else 4)')
    ap.add_argument('--device', default='cuda', help='cuda (default) or cpu')
    args = ap.parse_args(argv)

    from tdgp_torch.data.dataset import ImageFolderDataset
    from tdgp_torch.metrics.detectors import make_fid_detector
    from tdgp_torch.metrics.registry import EvalContext, calc_metric, report_metric

    path = resolve_snapshot(args.run_dir, args.snapshot)
    cfg, G = load_run(args.run_dir, path, args.device)
    device = next(G.parameters()).device
    data_path = args.data or cfg.dataset.path
    dataset = ImageFolderDataset(data_path, resolution=cfg.dataset.resolution,
                                 use_labels=cfg.dataset.c_dim > 0) if data_path else None
    detector = make_fid_detector(device)
    ctx = EvalContext(cfg=cfg, G=G, dataset=dataset, detector=detector,
                      batch_size=args.batch_size, batch_gpu=args.batch_gpu,
                      cache_dir=os.path.join(args.run_dir, 'metric-cache'))
    kimg = None if path.endswith('.npz') else ckpt.snapshot_kimg(path)
    label = args.snapshot if kimg is None else f'{kimg:06d}'
    results = []
    for name in args.metrics.split(','):
        result = calc_metric(name, ctx)
        report_metric(result, run_dir=args.run_dir, snapshot=label)
        results.append(result)
    return results


if __name__ == '__main__':
    main()
