"""Kernel K4: the 2-layer tri-plane MLP, forward, in CUDA C++ for Hopper.

Port of `tdgp/ops/pallas_kernels.py:316 triplane_mlp_pallas` (kernel
`:305`): plane-averaged features [N, P, F] -> h = lrelu(x @ w0 + b0, 0.2)
* sqrt(2) -> y = h @ w1 + b1 -> (rgb = y[..., :-1], sigma = y[..., -1]),
with the equalized-lr scales folded into w0 [F, HID], b0 [HID],
w1 [HID, OUT] and b1 [OUT], as the TPU kernel takes them
(`fold_fully_connected` folds a `FullyConnected`). The kernel is in
`csrc/triplane_mlp.cu`; its source note gives the bound and the design: the
first product on the tensor cores as 3xTF32 (float32 accuracy from three
TF32 products), the second on the CUDA cores in float32.

`triplane_mlp` computes `triplane_mlp_plain` for CPU tensors, and only for
them; for CUDA tensors it launches the kernel, counted in
`triplane_mlp.launches`, or raises. It has no backward: `TriPlaneMLP`
calls it only where autograd does not record (`models/epigraf.py`).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from tdgp_torch.ops import cuda_build

# (F, HID, OUT) the kernel is instantiated for (csrc/triplane_mlp.cu)
KERNEL_WIDTHS = ((32, 64, 4), (16, 32, 4), (8, 16, 4))


def fold_fully_connected(fc) -> Tuple[torch.Tensor, torch.Tensor]:
    """A `FullyConnected` layer -> (weight [in, out], bias [out]) with its
    equalized-lr scales applied."""
    return (fc.weight * fc.weight_gain).t(), fc.bias * fc.lr_multiplier


def triplane_mlp_plain(feats: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                       w1: torch.Tensor, b1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The folded 2-layer MLP in PyTorch operations -> (rgb [N,P,OUT-1], sigma [N,P])."""
    h = F.leaky_relu(feats @ w0 + b0, 0.2) * math.sqrt(2.0)
    y = h @ w1 + b1
    return y[..., :-1], y[..., -1]


@functools.cache
def _kernel():
    lib = cuda_build.library('triplane_mlp')
    fn = lib.tdgp_triplane_mlp
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.tdgp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tdgp_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.tdgp_cuda_error_string


def triplane_mlp(feats: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, w1: torch.Tensor,
                 b1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """feats [N, P, F], w0 [F, HID], b0 [HID], w1 [HID, OUT], b1 [OUT], float32
    -> (rgb [N, P, OUT-1], sigma [N, P]). Not differentiable on the card."""
    n, p, f = feats.shape
    hid, out = w0.shape[1], w1.shape[1]
    if w0.shape != (f, hid) or b0.shape != (hid,) or w1.shape != (hid, out) or b1.shape != (out,):
        raise ValueError(f'weights {tuple(w0.shape)}, {tuple(b0.shape)}, {tuple(w1.shape)}, '
                         f'{tuple(b1.shape)} do not fit features {tuple(feats.shape)}')
    device = feats.device
    if device.type == 'cpu':
        return triplane_mlp_plain(feats, w0, b0, w1, b1)
    if device.type != 'cuda':
        raise ValueError(f'triplane_mlp runs on CUDA or CPU tensors, not {device}')
    if (f, hid, out) not in KERNEL_WIDTHS:
        raise NotImplementedError(f'kernel K4 is built for (F, HID, OUT) in {KERNEL_WIDTHS}, '
                                  f'not {(f, hid, out)}')
    weights = [t.detach().contiguous() for t in (w0, b0, w1, b1)]
    for t in (feats, *weights):
        if t.dtype != torch.float32 or t.device != device:
            raise TypeError(f'triplane_mlp takes float32 tensors on {device}, '
                            f'got {t.dtype} on {t.device}')
    if not feats.is_contiguous() or feats.data_ptr() % 16:
        raise ValueError('triplane_mlp takes contiguous, 16-byte aligned features')
    rgb = torch.empty((n, p, out - 1), dtype=torch.float32, device=device)
    sigma = torch.empty((n, p), dtype=torch.float32, device=device)
    if n * p == 0:
        return rgb, sigma
    fn, error_string = _kernel()
    with torch.cuda.device(device):
        err = fn(feats.data_ptr(), *[t.data_ptr() for t in weights], rgb.data_ptr(),
                 sigma.data_ptr(), n * p, f, hid, out,
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'triplane_mlp launch failed: {error_string(err).decode()}')
    triplane_mlp.launches += 1
    return rgb, sigma


triplane_mlp.launches = 0
