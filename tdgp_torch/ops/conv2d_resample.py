"""2-D convolution with optional FIR up- or downsampling; NHWC at the interface.

Port of `tdgp/ops/conv2d_resample.py` for the cases the generator and the
discriminator have. Weights are in PyTorch's layout [Co, Ci, kh, kw].
In float32, upsampling takes the transposed-convolution route of the
StyleGAN2 reference: a stride-`up` `conv_transpose2d`, then the FIR filter,
which never builds the zero-upsampled input. Below float32 (the bf16
blocks) it takes the JAX package's composition instead, the FIR upsampling
and then a valid convolution, because each step rounds its output to
`x.dtype`, and the other order rounds at another point: it would differ
from the JAX package by about as much as bf16 differs from float32.
Downsampling is the JAX package's composition: pad, a valid convolution,
then the FIR filter with stride `down`. Without resampling it is one
`F.conv2d`. The weight is cast to `x.dtype`, and the output is in it. All of
it is differentiable twice, as R1 needs.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from tdgp_torch.ops.upfirdn2d import conv2d, get_filter_size, upfirdn2d


def conv2d_resample(x: torch.Tensor, w: torch.Tensor, f: Optional[torch.Tensor] = None,
                    up: int = 1, down: int = 1, padding: int = 0,
                    flip_weight: bool = True) -> torch.Tensor:
    """x: [N,H,W,Ci], w: [Co,Ci,kh,kw], f: FIR filter (setup_filter output).

    `padding` is given with respect to the upsampled image. flip_weight=True
    is correlation, as `F.conv2d` computes it.
    """
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f'expected 4-D x and w, got {tuple(x.shape)}, {tuple(w.shape)}')
    if padding < 0:
        raise ValueError(f'padding must be non-negative, got {padding}')
    if up > 1 and down > 1:
        raise NotImplementedError('up- and downsampling in one convolution')
    kh, kw = int(w.shape[2]), int(w.shape[3])
    if down > 1:
        fw, fh = get_filter_size(f)
        if not flip_weight and (kh > 1 or kw > 1):
            w = w.flip([2, 3])
        p0 = padding + (fw - down + 1) // 2
        p1 = padding + (fw - down) // 2
        y = F.pad(x, (0, 0, p0, p1, p0, p1)).permute(0, 3, 1, 2)
        y = conv2d(y, w.to(x.dtype)).permute(0, 2, 3, 1)
        return upfirdn2d(y, f, down=down)
    if up > 1 and x.element_size() < 4:
        fw, fh = get_filter_size(f)
        y = upfirdn2d(x, f, up=up, gain=up ** 2, padding=(
            padding + (fw + up - 1) // 2, padding + (fw - up) // 2,
            padding + (fh + up - 1) // 2, padding + (fh - up) // 2))
        if not flip_weight and (kh > 1 or kw > 1):
            w = w.flip([2, 3])
        return conv2d(y.permute(0, 3, 1, 2), w.to(x.dtype)).permute(0, 2, 3, 1)
    flip = (not flip_weight) if up == 1 else flip_weight  # conv_transpose2d convolves
    if flip and (kh > 1 or kw > 1):
        w = w.flip([2, 3])
    xc = x.permute(0, 3, 1, 2)
    if up == 1:
        return conv2d(xc, w.to(x.dtype), padding=padding).permute(0, 2, 3, 1)

    fw, fh = get_filter_size(f)
    px0 = padding + (fw + up - 1) // 2 - (kw - 1)
    px1 = padding + (fw - up) // 2 - (kw - up)
    py0 = padding + (fh + up - 1) // 2 - (kh - 1)
    py1 = padding + (fh - up) // 2 - (kh - up)
    pxt = max(min(-px0, -px1), 0)
    pyt = max(min(-py0, -py1), 0)
    y = F.conv_transpose2d(xc, w.transpose(0, 1).to(x.dtype), stride=up, padding=(pyt, pxt))
    return upfirdn2d(y.permute(0, 2, 3, 1), f,
                     padding=(px0 + pxt, px1 + pxt, py0 + pyt, py1 + pyt), gain=up ** 2)
