"""upfirdn2d: zero-upsample, pad, FIR filter, downsample; NHWC at the interface.

Port of `tdgp/ops/upfirdn2d.py`. The JAX package folds the whole pipeline
into one dilated depthwise convolution. Here the zero-upsampling is a
reshape and pad, the (possibly negative) padding is `F.pad`, and the filter
and the downsampling are one strided depthwise `F.conv2d`, which PyTorch
differentiates to any order. Tensors are
NHWC; `permute(0, 3, 1, 2)` gives the channels-last NCHW view the
convolution takes, without a copy. Filters are 2-D.

In bfloat16 (the bf16 blocks) the filter, scaled by `gain` in float32, is
cast to `x.dtype` as in the JAX package, and the output is in `x.dtype`
(the convolution accumulates in float32 in cuDNN and oneDNN).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F


def _parse_padding(padding: Union[int, Sequence[int]]) -> Tuple[int, int, int, int]:
    """int or (x0, x1, y0, y1)."""
    if isinstance(padding, int):
        return padding, padding, padding, padding
    px0, px1, py0, py1 = padding
    return int(px0), int(px1), int(py0), int(py1)


def get_filter_size(f: Optional[torch.Tensor]) -> Tuple[int, int]:
    """(fw, fh) of a 2-D filter; (1, 1) for none."""
    if f is None:
        return 1, 1
    return int(f.shape[1]), int(f.shape[0])


def setup_filter(f, device: Union[str, torch.device] = 'cpu') -> torch.Tensor:
    """A 1-D filter's normalized outer product (2-D filters are normalized as
    they are). The JAX package keeps filters of 8 or more taps separable;
    their outer product is the same filter."""
    f = torch.as_tensor(f, dtype=torch.float32, device=device)
    if f.ndim == 1:
        f = torch.outer(f, f)
    return f / f.sum()


def conv2d(x: torch.Tensor, w: torch.Tensor, **kwargs) -> torch.Tensor:
    """`F.conv2d` of NCHW `x` and `w` (`kwargs`: stride, padding, groups).

    Below float32 a convolution accumulates in float32 and rounds its output
    once, in cuDNN and in the JAX package. On CPU tensors the port computes
    it so, as the float32 convolution of the operands rounded to `x.dtype`:
    PyTorch's CPU bfloat16 convolution gives the same output, but its double
    backward (R1) accumulates in bfloat16 on some shapes and loses most of
    the gradient. The gradients of the casts are casts, so every derivative
    is the float32 one rounded once, as in the JAX package."""
    if x.device.type == 'cpu' and x.element_size() < 4:
        return F.conv2d(x.float(), w.float(), **kwargs).to(x.dtype)
    return F.conv2d(x, w, **kwargs)


def upfirdn2d(x: torch.Tensor, f: Optional[torch.Tensor], up: int = 1, down: int = 1,
              padding: Union[int, Sequence[int]] = 0, flip_filter: bool = False,
              gain: float = 1.0) -> torch.Tensor:
    """x: [N, H, W, C], f: [fh, fw] -> [N, H', W', C]."""
    if x.ndim != 4:
        raise ValueError(f'expected NHWC, got {tuple(x.shape)}')
    px0, px1, py0, py1 = _parse_padding(padding)
    n, h, w, c = x.shape

    if f is None:
        f = torch.ones((1, 1), dtype=torch.float32, device=x.device)
    f = (f.to(x.device) * gain).to(x.dtype)
    if not flip_filter:
        f = f.flip([0, 1])  # conv2d correlates; the FIR is a convolution

    if up > 1:  # zeros after every sample, trailing ones included
        x = x.reshape(n, h, 1, w, 1, c)
        x = F.pad(x, (0, 0, 0, up - 1, 0, 0, 0, up - 1))
        x = x.reshape(n, h * up, w * up, c)
    x = F.pad(x, (0, 0, px0, px1, py0, py1))
    weight = f[None, None].expand(c, 1, *f.shape).contiguous()
    y = conv2d(x.permute(0, 3, 1, 2), weight, stride=down, groups=c)
    return y.permute(0, 2, 3, 1)


def filter2d(x: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Same-size FIR filtering."""
    fw, fh = get_filter_size(f)
    return upfirdn2d(x, f, padding=((fw - 1) // 2, fw // 2, (fh - 1) // 2, fh // 2))


def upsample2d(x: torch.Tensor, f: torch.Tensor, up: int = 2) -> torch.Tensor:
    """Upsample by `up` with FIR smoothing, keeping the signal's scale."""
    fw, fh = get_filter_size(f)
    padding = ((fw + up - 1) // 2, (fw - up) // 2, (fh + up - 1) // 2, (fh - up) // 2)
    return upfirdn2d(x, f, up=up, padding=padding, gain=up * up)


def downsample2d(x: torch.Tensor, f: torch.Tensor, down: int = 2,
                 padding: Union[int, Sequence[int]] = 0,
                 flip_filter: bool = False) -> torch.Tensor:
    """FIR-smoothed downsampling by `down`; `padding` (int or (x0, x1, y0,
    y1), may be negative) is added to the filter's own."""
    px0, px1, py0, py1 = _parse_padding(padding)
    fw, fh = get_filter_size(f)
    padding = (px0 + (fw - down + 1) // 2, px1 + (fw - down) // 2,
               py0 + (fh - down + 1) // 2, py1 + (fh - down) // 2)
    return upfirdn2d(x, f, down=down, padding=padding, flip_filter=flip_filter)
