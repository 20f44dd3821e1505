"""Weight bridge: the JAX package's flat generator arrays -> the port's modules.

A trained generator is stored as flat arrays named 'params/...', 'ema/...'
and 'consts/...' (the layout `scripts/infra/export_ema.py` writes and
`tdgp/checkpoint.py:variables_from_flat` reads; `flax.traverse_util.flatten_dict`
of a JAX `G.init` gives the same names). A port parameter or buffer
`a.b.c` takes the array at '<collection>/a/b/c', where the collection is
'ema' for `w_avg`, 'consts' for `noise_const` and 'params' otherwise.

Layouts: dense weights [in, out] -> [out, in]; conv weights
[kh, kw, ci, co] -> [co, ci, kh, kw]; everything else, the NHWC const input
included, is taken as it is.
"""
from __future__ import annotations

from typing import List, Mapping

import numpy as np
import torch
from torch import nn

# Weights of modules the serving path does not run (see models/epigraf.py).
SKIPPED_PREFIXES = ('params/synthesis/depth_adaptor/', 'params/synthesis/camera_adaptor/')

_COLLECTIONS = {'w_avg': 'ema', 'noise_const': 'consts'}


def flat_key(name: str) -> str:
    leaf = name.rsplit('.', 1)[-1]
    return f"{_COLLECTIONS.get(leaf, 'params')}/{name.replace('.', '/')}"


def _to_port_layout(name: str, value: np.ndarray, ndim: int) -> np.ndarray:
    if name.endswith('weight') and ndim == 2:
        return value.T
    if name.endswith('weight') and ndim == 4:
        return value.transpose(3, 2, 0, 1)
    return value


def load_flat(module: nn.Module, flat: Mapping[str, np.ndarray]) -> List[str]:
    """Copy every parameter and persistent buffer of `module` from `flat`.

    Raises on a missing or mis-shaped array and on any array that is neither
    used nor under `SKIPPED_PREFIXES`. Returns the names of the skipped
    arrays.
    """
    keys = set(flat.keys()) if hasattr(flat, 'keys') else set(flat.files)
    state = module.state_dict()
    used, missing, mis_shaped = set(), [], []
    with torch.no_grad():
        for name, target in state.items():
            key = flat_key(name)
            if key not in keys:
                missing.append(key)
                continue
            value = _to_port_layout(name, np.asarray(flat[key]), target.ndim)
            if tuple(value.shape) != tuple(target.shape):
                mis_shaped.append(f'{key}: {tuple(value.shape)} for {tuple(target.shape)}')
                continue
            target.copy_(torch.tensor(value))
            used.add(key)
    skipped = sorted(k for k in keys - used if k.startswith(SKIPPED_PREFIXES))
    unknown = sorted(keys - used - set(skipped))
    if missing or mis_shaped or unknown:
        raise ValueError(f'weights do not match the model: missing {missing}, '
                         f'mis-shaped {mis_shaped}, unused {unknown}')
    return skipped
