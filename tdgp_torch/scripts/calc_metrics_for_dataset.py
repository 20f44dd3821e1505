"""FID and KID between two image folders or zips, no generator involved
(port of `scripts/calc_metrics_for_dataset.py`).

    python3 -m tdgp_torch.scripts.calc_metrics_for_dataset --real A --fake B \
        [--metrics fid,kid] [--max-items N] [--resolution R] [--device cuda]

The flags are the JAX script's, plus `--device` (default cuda; cpu runs on
the CPU). The detector is chosen as in `tdgp_torch.scripts.calc_metrics`:
InceptionV3 where $TDGP_INCEPTION_WEIGHTS names converted weights, else
the random projection detector (the repo holds no weights).
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

from tdgp_torch.utils.misc import resolve_device


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--real', required=True)
    ap.add_argument('--fake', required=True)
    ap.add_argument('--metrics', default='fid,kid')
    ap.add_argument('--max-items', type=int, default=None)
    ap.add_argument('--resolution', type=int, default=None)
    ap.add_argument('--device', default='cuda', help='cuda (default) or cpu')
    args = ap.parse_args(argv)

    metrics = args.metrics.split(',')
    unknown = set(metrics) - {'fid', 'kid'}
    if unknown:
        raise ValueError(f'unknown metrics {sorted(unknown)}; have fid, kid')

    from tdgp_torch.data.dataset import ImageFolderDataset
    from tdgp_torch.metrics.detectors import make_fid_detector
    from tdgp_torch.metrics.features import compute_feature_stats_for_dataset
    from tdgp_torch.metrics.fid import compute_fid
    from tdgp_torch.metrics.kid import compute_kid

    device = resolve_device(args.device)
    detector = make_fid_detector(device)
    real = ImageFolderDataset(args.real, resolution=args.resolution)
    fake = ImageFolderDataset(args.fake, resolution=args.resolution)
    want_all = 'kid' in metrics
    real_stats, fake_stats = (compute_feature_stats_for_dataset(
        d, detector, max_items=args.max_items, capture_all=want_all) for d in (real, fake))
    out = {}
    if 'fid' in metrics:
        out['fid'] = compute_fid(real_stats, fake_stats)
        print(f'fid: {out["fid"]:.4f}')
    if 'kid' in metrics:
        out['kid'] = compute_kid(real_stats.get_all(), fake_stats.get_all())
        print(f'kid: {out["kid"]:.6f}')
    return out

if __name__ == '__main__':
    main()
