"""Bias + activation + gain + clamp, channels last, with kernel K5.

Port of `tdgp/ops/bias_act.py` (the nine activations, their default alpha
and gain) and of `bias_act_pallas` (`tdgp/ops/pallas_kernels.py:52`, K5),
whose counterpart is the CUDA kernel of `csrc/bias_act.cu`; its source note
gives the bound and the design.

`bias_act_plain` is the function in PyTorch elementwise operations,
differentiable to any order (R1 differentiates the discriminator twice).
`bias_act` dispatches:
  - a CPU tensor: `bias_act_plain`;
  - a CUDA tensor that autograd would record (grad mode on and `x` or `b`
    requiring grad, as in training): `bias_act_plain`, because K5 has no
    backward, in the JAX package either;
  - any other CUDA tensor: kernel K5, counted in `bias_act.launches` (all
    launches) and `bias_act.launches_by_dtype` ('float32', 'bfloat16'), or an
    error when the kernel does not take it (a dtype other than float32 and
    bfloat16, a layout that is not dense). It takes a view whose channel
    stride is not 1 (an NHWC view of an NCHW convolution output) as it is,
    without a copy, and returns a tensor with the input's strides.

Below float32 (the bf16 blocks of the generator and the discriminator) the
result is the JAX package's, which computes in `x.dtype`: the bias is cast
to `x.dtype`, the constants alpha, gain and clamp are rounded to it (a
Python float is weakly typed in JAX), and every operation rounds its result
to it. So the activations whose JAX form is a chain of operations (sigmoid,
softplus, selu, swish) run as that chain there (`Activation.stepwise`). At
float32 each activation is the one PyTorch function, as before.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from tdgp_torch.ops import cuda_build


class Activation(NamedTuple):
    func: Callable[[torch.Tensor, float], torch.Tensor]
    def_alpha: float
    def_gain: float
    # below float32: the JAX package's chain of operations, each rounding to x.dtype
    stepwise: Optional[Callable[[torch.Tensor, float], torch.Tensor]] = None


_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


@functools.lru_cache(maxsize=None)
def round_to(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype`, as JAX rounds a weakly typed Python float
    that meets an array of that dtype."""
    return float(torch.tensor(value, dtype=dtype))


def _sigmoid_stepwise(x: torch.Tensor) -> torch.Tensor:
    return torch.reciprocal(torch.exp(-x) + 1.0)  # XLA's logistic, rounded per operation


def _selu_stepwise(x: torch.Tensor, alpha: float) -> torch.Tensor:
    expm1 = torch.expm1(x.clamp_max(0.0)) * round_to(_SELU_ALPHA, x.dtype)
    return torch.where(x > 0, x, expm1) * round_to(_SELU_SCALE, x.dtype)


activation_funcs = {
    'linear': Activation(lambda x, alpha: x, 0.0, 1.0),
    'relu': Activation(lambda x, alpha: F.relu(x), 0.0, math.sqrt(2)),
    'lrelu': Activation(lambda x, alpha: F.leaky_relu(x, alpha), 0.2, math.sqrt(2)),
    'tanh': Activation(lambda x, alpha: torch.tanh(x), 0.0, 1.0),
    'sigmoid': Activation(lambda x, alpha: torch.sigmoid(x), 0.0, 1.0,
                          lambda x, alpha: _sigmoid_stepwise(x)),
    'elu': Activation(lambda x, alpha: F.elu(x), 0.0, 1.0),
    'selu': Activation(lambda x, alpha: F.selu(x), 0.0, 1.0, _selu_stepwise),
    'softplus': Activation(lambda x, alpha: F.softplus(x), 0.0, 1.0,
                           lambda x, alpha: x.clamp_min(0.0) + torch.log1p(torch.exp(-x.abs()))),
    'swish': Activation(lambda x, alpha: torch.sigmoid(x) * x, 0.0, math.sqrt(2),
                        lambda x, alpha: _sigmoid_stepwise(x) * x),
}
_ACT_CODES = {name: i for i, name in enumerate(activation_funcs)}  # the order of csrc/bias_act.cu


def _resolve(act: str, alpha: Optional[float], gain: Optional[float], clamp: Optional[float]):
    spec = activation_funcs[act]
    if clamp is not None and clamp < 0:
        raise ValueError(f'clamp must be non-negative, got {clamp}')
    return (spec, float(spec.def_alpha if alpha is None else alpha),
            float(spec.def_gain if gain is None else gain))


def bias_act_plain(x: torch.Tensor, b: Optional[torch.Tensor] = None, *, act: str = 'linear',
                   alpha: Optional[float] = None, gain: Optional[float] = None,
                   clamp: Optional[float] = None) -> torch.Tensor:
    """Add `b` along the last axis, apply `act` (with `alpha`, lrelu's slope),
    scale by `gain`, clamp to +-clamp; None takes the activation's default.
    Computed in `x.dtype` (see the module's docstring)."""
    spec, alpha, gain = _resolve(act, alpha, gain, clamp)
    func = spec.func
    if x.element_size() < 4 and spec.stepwise is not None:
        func = spec.stepwise
    if b is not None:
        x = x + b.to(x.dtype)
    x = func(x, round_to(alpha, x.dtype))
    if gain != 1.0:
        x = x * round_to(gain, x.dtype)
    if clamp is not None:
        clamp = round_to(clamp, x.dtype)
        x = x.clamp(-clamp, clamp)
    return x


@functools.cache
def _kernel():
    lib = cuda_build.library('bias_act')
    fn = lib.tdgp_bias_act
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_float, ctypes.c_float,
                                           ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.tdgp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tdgp_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.tdgp_cuda_error_string


def channel_stride(x: torch.Tensor) -> Optional[int]:
    """The memory stride of the last axis when `x` is dense (its elements
    fill a block of memory with no gap or overlap, in some order of its
    axes), else None. Then the element at offset m has channel
    (m // stride) % C."""
    dims = sorted((d for d in range(x.ndim) if x.shape[d] != 1), key=lambda d: x.stride(d))
    expected = 1
    for d in dims:
        if x.stride(d) != expected:
            return None
        expected *= x.shape[d]
    return x.stride(-1) if x.shape[-1] != 1 else 1


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's instantiations


def _launch(x: torch.Tensor, b: Optional[torch.Tensor], act: str, alpha: float, gain: float,
            clamp: Optional[float]) -> torch.Tensor:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f'bias_act takes float32 or bfloat16 on the card, got {x.dtype}')
    c = x.shape[-1]
    if b is not None:
        if b.shape != (c,) or b.device != x.device:
            raise ValueError(f'bias {tuple(b.shape)} on {b.device} for x {tuple(x.shape)} '
                             f'on {x.device}')
        b = b.to(x.dtype).contiguous()
    inner = channel_stride(x)
    if inner is None:
        raise ValueError(f'bias_act takes dense tensors, got shape {tuple(x.shape)} with '
                         f'strides {x.stride()}')
    n = x.numel()
    if n >= 2 ** 31:
        raise ValueError(f'bias_act takes fewer than 2^31 elements, got {n}')
    y = torch.empty_like(x)  # the same strides as x, since x is dense
    if n == 0:
        return y
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, y) + ((b,) if b is not None else ()))
    per_access = 16 // x.element_size()  # elements in one 16-byte load
    mode = 0
    if aligned and inner == 1 and c % per_access == 0:
        mode = 1
    elif aligned and inner % per_access == 0:
        mode = 2
    fn, error_string = _kernel()
    dtype = x.dtype
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), 0 if b is None else b.data_ptr(), y.data_ptr(), n, inner, c,
                 _ACT_CODES[act], round_to(alpha, dtype), round_to(gain, dtype),
                 math.inf if clamp is None else round_to(clamp, dtype), mode,
                 _DTYPE_CODES[dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'bias_act launch failed: {error_string(err).decode()}')
    bias_act.launches += 1
    bias_act.launches_by_dtype[str(dtype).removeprefix('torch.')] += 1
    return y


def bias_act(x: torch.Tensor, b: Optional[torch.Tensor] = None, *, act: str = 'linear',
             alpha: Optional[float] = None, gain: Optional[float] = None,
             clamp: Optional[float] = None) -> torch.Tensor:
    """`bias_act_plain` on CPU tensors and where autograd records the call;
    kernel K5 on other CUDA tensors (see the module's docstring)."""
    if x.device.type == 'cpu':
        return bias_act_plain(x, b, act=act, alpha=alpha, gain=gain, clamp=clamp)
    if torch.is_grad_enabled() and (x.requires_grad or (b is not None and b.requires_grad)):
        return bias_act_plain(x, b, act=act, alpha=alpha, gain=gain, clamp=clamp)
    if x.device.type != 'cuda':
        raise ValueError(f'bias_act runs on CUDA or CPU tensors, not {x.device}')
    _, alpha, gain = _resolve(act, alpha, gain, clamp)
    return _launch(x, b, act, alpha, gain, clamp)


def reset_launches() -> None:
    bias_act.launches = 0
    bias_act.launches_by_dtype = collections.Counter()


reset_launches()
