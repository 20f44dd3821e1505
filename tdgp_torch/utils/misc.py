"""Small utilities of the entry points and the training step (port of
`tdgp/utils/misc.py`)."""
from __future__ import annotations

import contextlib
from typing import Union

import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device an entry point runs on; a CUDA device needs a card."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return device


@contextlib.contextmanager
def exact_fp32():
    """Full float32 matrix products and convolutions on the card: TF32,
    cuDNN's default for convolutions, keeps about three decimal digits."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def linear_schedule(step: float, val_start: float, val_end: float, period: float,
                    start_step: float = 0.0) -> float:
    """Linear annealing from `val_start` to `val_end` over `period`."""
    if period <= 0 or step >= start_step + period:
        return val_end
    if step <= start_step:
        return val_start
    return val_start + (val_end - val_start) * (step - start_step) / period


def nan_to_num(x: torch.Tensor, nan: float = 0.0, posinf: float = 1e5,
               neginf: float = -1e5) -> torch.Tensor:
    """The gradient scrub applied before every optimizer step."""
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)
