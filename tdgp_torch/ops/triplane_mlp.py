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

Its bf16 entry, `triplane_mlp_bf16` (to which `triplane_mlp` hands bf16
features), is the MLP of the bf16 render views (`generator.render_bf16`),
where the JAX package runs the two `FullyConnected` layers in bf16 in place
of its float32 Pallas kernel (`tdgp/models/epigraf.py:287-289`,
`tdgp/models/layers.py:38-52`): the weights folded as JAX folds them (cast
to bf16, then scaled by the gain rounded to bf16; `fold_fully_connected`
with `torch.bfloat16`), each product summed in float32 and rounded once to
bf16, the bias add, the leaky ReLU and its sqrt(2) gain each rounded to
bf16 as K5's bf16 instantiation rounds them, then the second product
rounded, its bias added and rounded: `triplane_mlp_plain_bf16`. The kernel
runs both products on the tensor cores in bf16 and the rounding chain in
bf16 pairs (`csrc/triplane_mlp.cu`); its launches count in
`triplane_mlp_bf16.launches`.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from tdgp_torch.ops import cuda_build
from tdgp_torch.ops.bias_act import bias_act_plain, round_to

# (F, HID, OUT) the kernel is instantiated for (csrc/triplane_mlp.cu)
KERNEL_WIDTHS = ((32, 64, 4), (16, 32, 4), (8, 16, 4))
KERNEL_WIDTHS_BF16 = ((32, 64, 4), (16, 32, 4))  # the bf16 entry's (F a multiple of 16)


def fold_fully_connected(fc, dtype: torch.dtype = torch.float32
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A `FullyConnected` layer -> (weight [in, out], bias [out]) with its
    equalized-lr scales applied. In bf16 as the layer computes on bf16
    inputs: the weight cast, then scaled by the gain rounded to bf16; the
    bias scaled in float32, then cast."""
    if dtype == torch.float32:
        return (fc.weight * fc.weight_gain).t(), fc.bias * fc.lr_multiplier
    return ((fc.weight.to(dtype) * round_to(fc.weight_gain, dtype)).t(),
            (fc.bias * fc.lr_multiplier).to(dtype))


def triplane_mlp_plain(feats: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                       w1: torch.Tensor, b1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The folded 2-layer MLP in PyTorch operations -> (rgb [N,P,OUT-1], sigma [N,P])."""
    h = F.leaky_relu(feats @ w0 + b0, 0.2) * math.sqrt(2.0)
    y = h @ w1 + b1
    return y[..., :-1], y[..., -1]


def triplane_mlp_plain_bf16(feats: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                            w1: torch.Tensor, b1: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two bf16 `FullyConnected` layers of the bf16 render views, from
    bf16 features and folded bf16 weights: each product summed in float32
    and rounded once, the bias, leaky ReLU and gain of the hidden layer as
    `bias_act` computes them in bf16, the output's bias added in bf16
    -> (rgb [N,P,OUT-1], sigma [N,P]), bf16."""
    h = (feats.float() @ w0.float()).to(feats.dtype)
    h = bias_act_plain(h, b0, act='lrelu')
    y = (h.float() @ w1.float()).to(feats.dtype) + b1
    return y[..., :-1], y[..., -1]


@functools.cache
def _kernel():
    lib = cuda_build.library('triplane_mlp')
    fn = lib.tdgp_triplane_mlp
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn16 = lib.tdgp_triplane_mlp_bf16
    fn16.argtypes = fn.argtypes
    fn16.restype = ctypes.c_int
    lib.tdgp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tdgp_cuda_error_string.restype = ctypes.c_char_p
    return {torch.float32: fn, torch.bfloat16: fn16}, lib.tdgp_cuda_error_string


def _check_widths(feats, w0, b0, w1, b1) -> None:
    f, hid, out = feats.shape[2], w0.shape[1], w1.shape[1]
    if w0.shape != (f, hid) or b0.shape != (hid,) or w1.shape != (hid, out) or b1.shape != (out,):
        raise ValueError(f'weights {tuple(w0.shape)}, {tuple(b0.shape)}, {tuple(w1.shape)}, '
                         f'{tuple(b1.shape)} do not fit features {tuple(feats.shape)}')


def _launch(feats, weights, dtype, what):
    """Launches K4's `dtype` entry -> (rgb, sigma) in `dtype`."""
    n, p, f = feats.shape
    hid, out = weights[0].shape[1], weights[2].shape[1]
    device = feats.device
    if device.type != 'cuda':
        raise ValueError(f'{what} runs on CUDA or CPU tensors, not {device}')
    widths = KERNEL_WIDTHS if dtype == torch.float32 else KERNEL_WIDTHS_BF16
    if (f, hid, out) not in widths:
        raise NotImplementedError(f'{what} is built for (F, HID, OUT) in {widths}, '
                                  f'not {(f, hid, out)}')
    weights = [t.detach().contiguous() for t in weights]
    for t in (feats, *weights):
        if t.dtype != dtype or t.device != device:
            raise TypeError(f'{what} takes {dtype} tensors on {device}, '
                            f'got {t.dtype} on {t.device}')
    if not feats.is_contiguous() or feats.data_ptr() % 16:
        raise ValueError(f'{what} takes contiguous, 16-byte aligned features')
    rgb = torch.empty((n, p, out - 1), dtype=dtype, device=device)
    sigma = torch.empty((n, p), dtype=dtype, device=device)
    if n * p == 0:
        return rgb, sigma
    fns, error_string = _kernel()
    with torch.cuda.device(device):
        err = fns[dtype](feats.data_ptr(), *[t.data_ptr() for t in weights], rgb.data_ptr(),
                         sigma.data_ptr(), n * p, f, hid, out,
                         torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'{what} launch failed: {error_string(err).decode()}')
    return rgb, sigma


def triplane_mlp(feats: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, w1: torch.Tensor,
                 b1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """feats [N, P, F], w0 [F, HID], b0 [HID], w1 [HID, OUT], b1 [OUT], float32
    -> (rgb [N, P, OUT-1], sigma [N, P]). bf16 features go to
    `triplane_mlp_bf16`. Not differentiable on the card."""
    _check_widths(feats, w0, b0, w1, b1)
    if feats.dtype == torch.bfloat16:
        return triplane_mlp_bf16(feats, w0, b0, w1, b1)
    if feats.device.type == 'cpu':
        return triplane_mlp_plain(feats, w0, b0, w1, b1)
    out = _launch(feats, (w0, b0, w1, b1), torch.float32, 'triplane_mlp')
    triplane_mlp.launches += 1
    return out


def triplane_mlp_bf16(feats: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                      w1: torch.Tensor, b1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's bf16 entry: feats [N, P, F] and the weights folded in bf16
    (`fold_fully_connected(fc, torch.bfloat16)`), all bf16
    -> (rgb [N, P, OUT-1], sigma [N, P]) in bf16, what
    `triplane_mlp_plain_bf16` computes. Not differentiable on the card."""
    _check_widths(feats, w0, b0, w1, b1)
    if feats.device.type == 'cpu':
        return triplane_mlp_plain_bf16(feats, w0, b0, w1, b1)
    out = _launch(feats, (w0, b0, w1, b1), torch.bfloat16, 'triplane_mlp_bf16')
    triplane_mlp_bf16.launches += 1
    return out


triplane_mlp.launches = 0
triplane_mlp_bf16.launches = 0
