"""TensorGroup: named tensors aligned along the first axis.

The camera-parameter container of `tdgp/utils/tensor_group.py`, reduced to
what the port uses: access by attribute or by name, and a slice along the
first axis. A camera is
`TensorGroup(angles [N,3], fov [N], radius [N], look_at [N,3])`.
"""
from __future__ import annotations

from typing import List

import torch


class TensorGroup:
    __slots__ = ('_data',)

    def __init__(self, **tensors: torch.Tensor):
        self._data = dict(tensors)

    def __getattr__(self, name: str) -> torch.Tensor:
        try:
            return self._data[name]
        except KeyError:
            raise AttributeError(name) from None

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._data[name]

    def select(self, index) -> 'TensorGroup':
        """Every tensor indexed along the first axis."""
        return TensorGroup(**{k: v[index] for k, v in self._data.items()})

    def keys(self) -> List[str]:
        return list(self._data)

    def __repr__(self) -> str:
        return f'TensorGroup({ {k: tuple(v.shape) for k, v in self._data.items()} })'
