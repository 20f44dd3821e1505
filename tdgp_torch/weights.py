"""Weight bridge between the JAX package's arrays and the port's modules.

A trained generator is stored as flat arrays named 'params/...', 'ema/...'
and 'consts/...' (the layout `scripts/infra/export_ema.py` writes and
`tdgp/checkpoint.py:variables_from_flat` reads; `flax.traverse_util.flatten_dict`
of a JAX `G.init` gives the same names). A port parameter or buffer
`a.b.c` takes the array at '<collection>/a/b/c', where the collection is
'ema' for `w_avg`, 'consts' for `noise_const` and 'params' otherwise.

Layouts: dense weights [in, out] -> [out, in]; conv weights
[kh, kw, ci, co] -> [co, ci, kh, kw]; everything else, the NHWC const input
and the embedding tables included, is taken as it is.

`flat_from_module` is the inverse of `load_flat`: a port module as those
flat arrays, with the JAX names and layouts, so that both packages read
the file it is saved to.

The names need no table per model: the tri-plane `Generator` and the 2D
`StyleGAN2Generator` ('mapping/...', 'synthesis/b<res>/...') cross the same
way.

`load_train_state` carries a whole JAX `TrainState` (G with its adaptors,
its consts and 'ema' collection, D, the EMA copy of G, and the path-length
mean `pl_mean` when given), given as nested dicts of numpy arrays, into a
`tdgp_torch.training.train_step.Trainer`. The optimizers' state is not
carried: both packages start it at zero.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

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


def _to_jax_layout(name: str, value: np.ndarray) -> np.ndarray:
    if name.endswith('weight') and value.ndim == 2:
        return value.T
    if name.endswith('weight') and value.ndim == 4:
        return value.transpose(2, 3, 1, 0)
    return value


def flat_from_module(module: nn.Module) -> Dict[str, np.ndarray]:
    """Every parameter and persistent buffer of `module` as
    {'<collection>/a/b/c': array} in the JAX package's layout: what
    `load_flat` reads back. The arrays are copies."""
    return {flat_key(name): _to_jax_layout(name, value.detach().cpu().numpy()).copy()
            for name, value in module.state_dict().items()}


def load_flat(module: nn.Module, flat: Mapping[str, np.ndarray]) -> None:
    """Copy every parameter and persistent buffer of `module` from `flat`.

    Raises on a missing or mis-shaped array and on any array that is not used.
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
    unknown = sorted(keys - used)
    if missing or mis_shaped or unknown:
        raise ValueError(f'weights do not match the model: missing {missing}, '
                         f'mis-shaped {mis_shaped}, unused {unknown}')


def flatten_tree(tree: Mapping, prefix: str = '') -> Dict[str, np.ndarray]:
    """Nested dicts of arrays -> {'a/b/c': array}."""
    flat = {}
    for key, value in tree.items():
        name = f'{prefix}{key}'
        if isinstance(value, Mapping):
            flat.update(flatten_tree(value, name + '/'))
        else:
            flat[name] = np.asarray(value)
    return flat


def load_train_state(trainer, g_params: Mapping, g_consts: Mapping, g_ema: Mapping,
                     d_params: Mapping, ema_params: Mapping, ema_ema: Mapping,
                     pl_mean=None) -> None:
    """Load the fields of a JAX `TrainState` (g_params, g_consts, g_ema_coll,
    d_params, ema_params, ema_ema_coll, pl_mean), as nested dicts of numpy
    arrays."""
    if pl_mean is not None:
        trainer.pl_mean = torch.tensor(np.asarray(pl_mean, np.float32),
                                       device=trainer.pl_mean.device)
    load_flat(trainer.G, flatten_tree({'params': g_params, 'consts': g_consts, 'ema': g_ema}))
    load_flat(trainer.D, flatten_tree({'params': d_params}))
    load_flat(trainer.G_ema, flatten_tree({'params': ema_params, 'consts': g_consts,
                                           'ema': ema_ema}))
