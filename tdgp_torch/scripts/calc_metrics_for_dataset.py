"""FID between two image folders or zips, no generator involved (port of
`scripts/calc_metrics_for_dataset.py`).

    python3 -m tdgp_torch.scripts.calc_metrics_for_dataset --real A --fake B \
        [--metrics fid] [--max-items N] [--resolution R] [--device cuda]

The flags are the JAX script's, plus `--device` (default cuda; cpu runs on
the CPU); `--metrics` defaults to fid, the one metric ported here (KID,
the JAX script's other one, raises NotImplementedError: ROADMAP.md
section 1, item 6). The features come from the random projection detector,
as in `tdgp_torch.scripts.calc_metrics` (the repo has no InceptionV3
weights).
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

from tdgp_torch.utils.misc import resolve_device


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--real', required=True)
    ap.add_argument('--fake', required=True)
    ap.add_argument('--metrics', default='fid')
    ap.add_argument('--max-items', type=int, default=None)
    ap.add_argument('--resolution', type=int, default=None)
    ap.add_argument('--device', default='cuda', help='cuda (default) or cpu')
    args = ap.parse_args(argv)

    metrics = args.metrics.split(',')
    if 'kid' in metrics:
        raise NotImplementedError('kid is not ported to tdgp_torch (ROADMAP.md section 1, '
                                  'item 6)')
    unknown = set(metrics) - {'fid'}
    if unknown:
        raise ValueError(f'unknown metrics {sorted(unknown)}; have fid')

    from tdgp_torch.data.dataset import ImageFolderDataset
    from tdgp_torch.metrics.detectors import RandomProjectionDetector
    from tdgp_torch.metrics.features import compute_feature_stats_for_dataset
    from tdgp_torch.metrics.fid import compute_fid

    device = resolve_device(args.device)
    print('WARNING: using RandomProjectionDetector (no InceptionV3 weights)')
    detector = RandomProjectionDetector(2048, device=device)
    real = ImageFolderDataset(args.real, resolution=args.resolution)
    fake = ImageFolderDataset(args.fake, resolution=args.resolution)
    real_stats = compute_feature_stats_for_dataset(real, detector, max_items=args.max_items)
    fake_stats = compute_feature_stats_for_dataset(fake, detector, max_items=args.max_items)
    fid = compute_fid(real_stats, fake_stats)
    print(f'fid: {fid:.4f}')
    return {'fid': fid}


if __name__ == '__main__':
    main()
