"""The JAX augment pipe's draws under the port's names, for the parity tests
(tests/test_torch_augment.py, tests/test_torch_train_step.py)."""
import numpy as np
import torch

import jax


def T(x):
    return torch.from_numpy(np.array(x))


def jax_pipe_draws(cfg, rng, shape, num_color_channels=3, num_bands=4):
    """The JAX pipe's draws from `rng`, in its order, under the port's names."""
    n, h, w, c = shape
    keys = iter(jax.random.split(rng, 40))
    values = {}

    def uniform(name, s):
        values[name] = T(jax.random.uniform(next(keys), s))

    def normal(name, s):
        values[name] = T(jax.random.normal(next(keys), s))

    gated = {'xflip': uniform, 'rotate90': uniform, 'xint': uniform, 'scale': normal,
             'aniso': normal, 'xfrac': normal, 'brightness': normal, 'contrast': normal,
             'lumaflip': uniform, 'hue': uniform, 'saturation': normal}
    shapes = {'xint': (n, 2), 'xfrac': (n, 2)}

    def group(name):
        if getattr(cfg, name) > 0:
            gated[name](name, shapes.get(name, (n,)))
            uniform(f'{name}/gate', (n,))

    for name in ('xflip', 'rotate90', 'xint', 'scale'):
        group(name)
    if cfg.rotate > 0:
        uniform('rotate/0', (n,))
        uniform('rotate/0/gate', (n,))
    group('aniso')
    if cfg.rotate > 0:
        uniform('rotate/1', (n,))
        uniform('rotate/1/gate', (n,))
    for name in ('xfrac', 'brightness', 'contrast', 'lumaflip'):
        group(name)
    if num_color_channels > 1:
        group('hue')
        group('saturation')
    if cfg.imgfilter > 0:
        for i in range(num_bands):
            normal(f'imgfilter/{i}', (n,))
            uniform(f'imgfilter/{i}/gate', (n,))
    if cfg.noise > 0:
        normal('noise', (n,))
        uniform('noise/gate', (n,))
        normal('noise/pixels', shape)
    if cfg.cutout > 0:
        uniform('cutout/gate', (n,))
        uniform('cutout/center', (n, 2))
    return values
