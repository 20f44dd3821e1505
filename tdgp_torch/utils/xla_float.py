"""Float32 arithmetic as the JAX package's jitted step does it on the CPU:
its `jnp.linspace(-1, 1, n)` row and the multiply-adds that XLA contracts
into one rounding. The port places its patches' sample positions this way
and sums the bilinear sampler's corners so, and its training step reads the
same pixels as the JAX package's, bit for bit."""
from __future__ import annotations

import torch


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a x b + c rounded once to a's dtype (b and c tensors or numbers): the
    float64 product of two float32 values is exact."""
    def wide(v):
        return v.double() if torch.is_tensor(v) else v
    return (a.double() * wide(b) + wide(c)).to(a.dtype)


def linspace_row(resolution: int, device=None) -> torch.Tensor:
    """`jnp.linspace(-1, 1, resolution)` as XLA computes it under `jit`:
    step = i x (1 / (n - 1)) and -(1 - step) + step in float32, the last
    entry exactly 1. `torch.linspace` places up to half of them an ulp or
    more away."""
    if resolution < 2:
        return torch.full((resolution,), -1.0, device=device)
    div = resolution - 1
    step = torch.arange(div, dtype=torch.float32, device=device) \
        * (torch.tensor(1.0, device=device) / div)
    return torch.cat([-(1.0 - step) + step, torch.ones(1, device=device)])


def to_patch(x: torch.Tensor, scales: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """(x + 1) x scales - 1 + offsets x 2: the first three rounded once, as
    XLA's fused multiply-add gives them, then the offset added in float32."""
    return fma(x + 1.0, scales, -1.0) + offsets * 2.0
