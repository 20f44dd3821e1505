"""TensorGroup: named tensors aligned along the first axis; EasyDict.

The camera-parameter container of `tdgp/utils/tensor_group.py`, reduced to
what the port uses: access by attribute or by name, the length of the first
axis, a slice or a repeat along it, and concatenation of groups. A camera
is `TensorGroup(angles [N,3], fov [N], radius [N], look_at [N,3])`.
"""
from __future__ import annotations

from typing import Any, List, Sequence

import torch


class EasyDict(dict):
    """A dict with attribute access."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @staticmethod
    def init_recursively(value: Any) -> Any:
        """Nested dicts -> nested EasyDicts."""
        if isinstance(value, dict):
            return EasyDict(**{k: EasyDict.init_recursively(v) for k, v in value.items()})
        return value


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

    def __len__(self) -> int:
        return int(next(iter(self._data.values())).shape[0])

    def select(self, index) -> 'TensorGroup':
        """Every tensor indexed along the first axis."""
        return TensorGroup(**{k: v[index] for k, v in self._data.items()})

    def repeat_interleave(self, repeats: int) -> 'TensorGroup':
        """Every row repeated `repeats` times in place, along the first axis."""
        return TensorGroup(**{k: v.repeat_interleave(repeats, dim=0)
                              for k, v in self._data.items()})

    @staticmethod
    def cat(groups: Sequence['TensorGroup']) -> 'TensorGroup':
        """Groups with the same names, concatenated along the first axis."""
        return TensorGroup(**{k: torch.cat([g[k] for g in groups]) for k in groups[0].keys()})

    def keys(self) -> List[str]:
        return list(self._data)

    def __repr__(self) -> str:
        return f'TensorGroup({ {k: tuple(v.shape) for k, v in self._data.items()} })'
