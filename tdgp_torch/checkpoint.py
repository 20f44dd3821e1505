"""Training snapshots: save, resume, best-snapshot retention (port of
`tdgp/checkpoint.py`, with torch files in place of orbax).

A snapshot is the directory `network-snapshot-<kimg:06d>` of the run
directory, holding `state.pt`: G, D and G_ema's state dicts, both Adam
states and the state of the loop's random generator; beside it,
`<snapshot>.meta.json` holds `cur_nimg` and the loop's own state
(`batch_idx`, `ada_p`). The names, the 'latest' resume and the retention
follow the JAX package, whose orbax snapshots the port does not read.
`find_best_checkpoint` picks the snapshot with the lowest recorded metric,
as the JAX package's does; `load_g_ema` reads a snapshot's EMA generator
alone, for the entry points.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional

import torch

SNAPSHOT_RE = re.compile(r'network-snapshot-(\d{6})$')
STATE_FILE = 'state.pt'


def snapshot_path(run_dir: str, kimg: int) -> str:
    return os.path.join(run_dir, f'network-snapshot-{int(kimg):06d}')


def save_snapshot(run_dir: str, trainer, generator: torch.Generator, *, cur_nimg: int,
                  meta: Optional[Dict[str, Any]] = None) -> str:
    """Write the trainer's modules and optimizers and the random generator's
    state under network-snapshot-{cur_nimg // 1000:06d}, replacing a
    snapshot of that name; returns its path."""
    path = os.path.abspath(snapshot_path(run_dir, cur_nimg // 1000))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    state = {'G': trainer.G.state_dict(), 'D': trainer.D.state_dict(),
             'G_ema': trainer.G_ema.state_dict(), 'g_opt': trainer.g_opt.state_dict(),
             'd_opt': trainer.d_opt.state_dict(), 'pl_mean': trainer.pl_mean,
             'rng': generator.get_state()}
    torch.save(state, os.path.join(path, STATE_FILE))
    with open(path + '.meta.json', 'w') as f:
        json.dump({'cur_nimg': int(cur_nimg), **(meta or {})}, f)
    return path


def load_snapshot(path: str, trainer, generator: torch.Generator) -> Dict[str, Any]:
    """Restore the trainer and the random generator from a snapshot; returns
    its meta (empty without a meta file)."""
    state = torch.load(os.path.join(path, STATE_FILE), map_location=trainer.device,
                       weights_only=True)
    for name in ('G', 'D', 'G_ema'):
        getattr(trainer, name).load_state_dict(state[name])
    trainer.g_opt.load_state_dict(state['g_opt'])
    trainer.d_opt.load_state_dict(state['d_opt'])
    if 'pl_mean' in state:  # snapshots written before the path-length phase have none
        trainer.pl_mean = state['pl_mean'].to(trainer.device)
    generator.set_state(state['rng'].cpu())
    meta = {}
    if os.path.exists(path + '.meta.json'):
        with open(path + '.meta.json') as f:
            meta = json.load(f)
    return meta


def snapshot_kimg(snap) -> Optional[int]:
    """The kimg of a snapshot reference: a zero-padded kimg string, a
    snapshot directory's name or a full path."""
    if snap is None:
        return None
    if isinstance(snap, int):
        return snap
    name = os.path.basename(str(snap).rstrip('/'))
    m = SNAPSHOT_RE.match(name)
    if m:
        return int(m.group(1))
    return int(name) if name.isdigit() else None


def list_snapshots(run_dir: str):
    """Sorted (kimg, path) pairs of the snapshots in run_dir."""
    if not os.path.isdir(run_dir):
        return []
    out = []
    for name in os.listdir(run_dir):
        m = SNAPSHOT_RE.match(name)
        if m and os.path.isdir(os.path.join(run_dir, name)):
            out.append((int(m.group(1)), os.path.join(run_dir, name)))
    return sorted(out)


def resolve_resume(run_dir: str, resume: str) -> Optional[str]:
    """'latest' -> the newest snapshot's path; a path -> itself; None if nothing."""
    if resume in (None, '', 'none'):
        return None
    if resume == 'latest':
        snaps = list_snapshots(run_dir)
        return snaps[-1][1] if snaps else None
    return resume


def find_best_checkpoint(run_dir: str, metric: str = 'fid2k_full') -> Optional[str]:
    """The snapshot with the lowest value of `metric` in
    metric-<metric>.jsonl among the snapshots that exist (the first of
    equal values), else the newest snapshot; None without a snapshot."""
    snaps = dict(list_snapshots(run_dir))
    if not snaps:
        return None
    jsonl = os.path.join(run_dir, f'metric-{metric}.jsonl')
    if os.path.exists(jsonl):
        best_val, best_kimg = None, None
        with open(jsonl) as f:
            for line in f:
                rec = json.loads(line)
                val = rec.get('results', {}).get(metric)
                kimg = snapshot_kimg(rec.get('snapshot'))
                if val is None or kimg is None:
                    continue
                if kimg in snaps and (best_val is None or val < best_val):
                    best_val, best_kimg = val, kimg
        if best_kimg is not None:
            return snaps[best_kimg]
    return snaps[max(snaps)]


def load_g_ema(path: str, G: torch.nn.Module) -> torch.nn.Module:
    """Load the EMA generator's state of the snapshot at `path` into `G`
    (read on the CPU; the rest of the snapshot is not kept); returns G."""
    state = torch.load(os.path.join(path, STATE_FILE), map_location='cpu', weights_only=True,
                       mmap=True)
    G.load_state_dict(state['G_ema'])
    return G


def delete_snapshot(path: str) -> None:
    if os.path.isdir(path):
        shutil.rmtree(path)
    meta = path + '.meta.json'
    if os.path.exists(meta):
        os.remove(meta)
