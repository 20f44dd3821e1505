"""Bias + activation + gain + clamp, channels last.

Port of `tdgp/ops/bias_act.py`, with the activations the generator uses.
PyTorch runs it as a few elementwise kernels; the fused Hopper kernel for it
(the JAX package's `bias_act_pallas`, K5) is still to be ported.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

# name -> (function, gain): lrelu has slope 0.2 and the sqrt(2) gain of StyleGAN
activation_funcs = {
    'linear': (lambda x: x, 1.0),
    'lrelu': (lambda x: F.leaky_relu(x, 0.2), math.sqrt(2)),
}


def bias_act(x: torch.Tensor, b: Optional[torch.Tensor] = None, *, act: str = 'linear',
             clamp: Optional[float] = None) -> torch.Tensor:
    """Add `b` along the last axis, apply `act` and its gain, clamp to +-clamp."""
    func, gain = activation_funcs[act]
    if b is not None:
        x = x + b.to(x.dtype)
    x = func(x)
    if gain != 1.0:
        x = x * gain
    if clamp is not None:
        x = x.clamp(-clamp, clamp)
    return x
