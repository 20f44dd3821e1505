"""The EMA generator of a training snapshot as a flat `.npz` (port of
`scripts/infra/export_ema.py`).

    python3 -m tdgp_torch.scripts.export_ema --run-dir RUN [--snapshot latest|best|<path>]
        [--out g_ema.npz]

Reads G_ema alone from one of the port's snapshots (`network-snapshot-*`,
as `tdgp_torch.scripts.train` writes them; 'best' is the lowest fid2k_full)
and writes its parameters and buffers under the JAX names and layouts
('params/...', 'ema/...', 'consts/...', `tdgp_torch.weights.flat_from_module`),
by default as `<snapshot>-g_ema.npz` in the run directory. The file is what
`tdgp_torch.scripts.inference --snapshot` and the JAX package's
`scripts/inference.py` (`tdgp.checkpoint.variables_from_flat`) both load.
The export computes nothing, so it reads and writes on the CPU and needs no
card.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from tdgp_torch.scripts.inference import load_run, resolve_snapshot
from tdgp_torch.weights import flat_from_module


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--run-dir', required=True)
    ap.add_argument('--snapshot', default='latest', help='latest | best | a snapshot path')
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)

    path = resolve_snapshot(args.run_dir, args.snapshot)
    _, G = load_run(args.run_dir, path, device='cpu')
    flat = flat_from_module(G)
    out = args.out or os.path.join(args.run_dir, os.path.basename(path) + '-g_ema.npz')
    np.savez(out, **flat)
    total = sum(v.nbytes for v in flat.values())
    print(f'{out}: {len(flat)} arrays, {total / 1e6:.1f} MB (from {os.path.basename(path)})')
    return out


if __name__ == '__main__':
    main()
