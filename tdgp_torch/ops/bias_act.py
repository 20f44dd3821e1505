"""Bias + activation + gain + clamp, channels last.

Port of `tdgp/ops/bias_act.py`, with the activations the generator, the
adaptors and the discriminator use. PyTorch runs it as a few elementwise
kernels, differentiable to any order (R1 differentiates the discriminator
twice); the fused Hopper kernel for it (the JAX package's
`bias_act_pallas`, K5) is still to be ported.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

# name -> (function, default gain): lrelu has slope 0.2 and the sqrt(2) gain of StyleGAN
activation_funcs = {
    'linear': (lambda x: x, 1.0),
    'relu': (F.relu, math.sqrt(2)),
    'lrelu': (lambda x: F.leaky_relu(x, 0.2), math.sqrt(2)),
    'tanh': (torch.tanh, 1.0),
    'sigmoid': (torch.sigmoid, 1.0),
    'softplus': (F.softplus, 1.0),
}


def bias_act(x: torch.Tensor, b: Optional[torch.Tensor] = None, *, act: str = 'linear',
             gain: Optional[float] = None, clamp: Optional[float] = None) -> torch.Tensor:
    """Add `b` along the last axis, apply `act`, scale by `gain` (the
    activation's default gain when None), clamp to +-clamp."""
    func, def_gain = activation_funcs[act]
    gain = def_gain if gain is None else gain
    if b is not None:
        x = x + b.to(x.dtype)
    x = func(x)
    if gain != 1.0:
        x = x * gain
    if clamp is not None:
        if clamp < 0:
            raise ValueError(f'clamp must be non-negative, got {clamp}')
        x = x.clamp(-clamp, clamp)
    return x
