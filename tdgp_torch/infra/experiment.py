"""Run directories with a frozen config (port of `tdgp/infra/experiment.py`;
the config loading itself is `tdgp_torch.config.load_config`).

Each run directory holds `experiment_config.yaml`, the finalized config as
the run started, which `--run-dir` reloads to resume, and which the JAX
package's loader reads too.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
from typing import Any, Dict, Optional

import yaml

from tdgp_torch.config import Config


def config_to_dict(cfg: Config) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def _git_hash() -> str:
    try:
        out = subprocess.run(['git', 'rev-parse', '--short', 'HEAD'],
                             capture_output=True, text=True, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return 'nogit'


def save_config(cfg: Config, path: str) -> None:
    with open(path, 'w') as f:
        yaml.safe_dump(config_to_dict(cfg), f, sort_keys=False)


def create_experiment_dir(cfg: Config, root: str, desc: Optional[str] = None) -> str:
    """<root>/<dataset>-<model>-p<patch>-b<batch>-<git hash>[-<desc>], with the
    frozen config written once (an existing directory of that name is
    reused, and resumed from)."""
    name_parts = [cfg.dataset.name or 'dataset', cfg.model_name,
                  f'p{cfg.generator.patch.resolution}',
                  f'b{cfg.training.batch_size}', _git_hash()]
    if desc:
        name_parts.append(desc)
    run_dir = os.path.join(root, '-'.join(name_parts))
    os.makedirs(run_dir, exist_ok=True)
    frozen = os.path.join(run_dir, 'experiment_config.yaml')
    if not os.path.exists(frozen):
        save_config(cfg, frozen)
    return run_dir
