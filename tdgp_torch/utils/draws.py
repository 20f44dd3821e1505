"""Named random draws from an explicit `torch.Generator`.

Every random number of a training step comes from a `Draws` object: the
stratified jitter, the importance sampler's u, the density noise, the
StyleGAN2 noise buffers, the depth adaptor's selection, the patch and camera
parameters. Each draw has a '/'-separated name, built with `scope`. The
names do not change what `Draws` returns; they let `Replay` hand back given
values instead, which is how the tests feed the JAX package's draws to the
port (PyTorch cannot reproduce `jax.random`'s streams).

`draw(name, fn)` is a composite draw: `fn(draws)` computes a value from
draws of its own (a camera, patch parameters), and `Replay` may give the
whole value instead.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping, Sequence

import torch


class Draws:
    def __init__(self, generator: torch.Generator, prefix: str = ''):
        self.generator = generator
        self.prefix = prefix

    @property
    def device(self) -> torch.device:
        return self.generator.device

    def scope(self, name: str) -> 'Draws':
        return Draws(self.generator, f'{self.prefix}{name}/')

    def uniform(self, name: str, shape: Sequence[int]) -> torch.Tensor:
        """U[0, 1) float32."""
        return torch.rand(tuple(shape), generator=self.generator, device=self.device)

    def normal(self, name: str, shape: Sequence[int]) -> torch.Tensor:
        """N(0, 1) float32."""
        return torch.randn(tuple(shape), generator=self.generator, device=self.device)

    def gamma(self, name: str, alpha: torch.Tensor) -> torch.Tensor:
        """Gamma(alpha, 1), one draw per element of `alpha`."""
        return torch._standard_gamma(alpha.to(self.device), generator=self.generator)

    def randint(self, name: str, low: int, high: int, shape: Sequence[int]) -> torch.Tensor:
        """Integers uniform in [low, high), int64."""
        return torch.randint(low, high, tuple(shape), generator=self.generator,
                             device=self.device)

    def draw(self, name: str, fn: Callable[['Draws'], Any]) -> Any:
        return fn(self.scope(name))


class Replay(Draws):
    """Draws that return given values by full name; a plain draw that is not
    given raises, a composite one falls back to its own draws."""

    def __init__(self, values: Mapping[str, Any], device='cpu', prefix: str = ''):
        self.values = values
        self._device = torch.device(device)
        self.prefix = prefix
        self.used = set() if not prefix else None

    @property
    def device(self) -> torch.device:
        return self._device

    def scope(self, name: str) -> 'Replay':
        child = Replay(self.values, self._device, f'{self.prefix}{name}/')
        child.used = self.used
        return child

    def _get(self, name: str, shape=None):
        key = self.prefix + name
        if key not in self.values:
            raise KeyError(f'no value given for the draw {key!r}')
        value = self.values[key]
        if self.used is not None:
            self.used.add(key)
        if shape is not None:
            value = torch.as_tensor(value, dtype=torch.float32, device=self._device)
            if tuple(value.shape) != tuple(shape):
                raise ValueError(f'draw {key!r}: given {tuple(value.shape)}, needs {tuple(shape)}')
        return value

    def uniform(self, name, shape):
        return self._get(name, shape)

    def normal(self, name, shape):
        return self._get(name, shape)

    def gamma(self, name, alpha):
        return self._get(name, alpha.shape)

    def randint(self, name, low, high, shape):
        value = torch.as_tensor(self._get(name), dtype=torch.int64, device=self._device)
        if tuple(value.shape) != tuple(shape):
            raise ValueError(f'draw {self.prefix + name!r}: given {tuple(value.shape)}, '
                             f'needs {tuple(shape)}')
        return value

    def draw(self, name, fn):
        if self.prefix + name in self.values:
            return self._get(name)
        return fn(self.scope(name))
