"""Kernel K5's plain version and dispatch: port (tdgp_torch) vs JAX package (tdgp).

`tdgp_torch.ops.bias_act.bias_act_plain` is held against the JAX package's
`bias_act` and its TPU kernel `bias_act_pallas` (run in Pallas interpret
mode, as tests/test_pallas.py runs it) on the same numpy inputs, for all
nine activations with default and given alpha, gain and clamp, and at row
counts around the TPU kernel's tile of 1024 rows; rtol = atol = 1e-5
(elementwise float32). The CUDA kernel itself runs only on the card, where
`chip_smoke.py` holds it against the plain version. Here: the wrapper's
dispatch (CPU tensors and tensors that autograd records take the plain
version; other tensors go to the kernel or raise), the channel addressing
that the kernel uses for a strided NHWC view, and the plain version's
double backward.
"""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tdgp.ops.bias_act import activation_funcs as jax_activation_funcs
from tdgp.ops.bias_act import bias_act as jax_bias_act
from tdgp.ops.pallas_kernels import bias_act_pallas

from tdgp_torch.ops import bias_act as K5
from tdgp_torch.ops.bias_act import activation_funcs, bias_act, bias_act_plain, channel_stride

TOL = dict(rtol=1e-5, atol=1e-5)
ACTS = list(activation_funcs)
OPTS = [dict(), dict(alpha=0.3, gain=0.7, clamp=2.0)]


@pytest.fixture(scope='module', autouse=True)
def _one_thread_per_worker():
    """One torch and one BLAS thread while this module runs: the test workers
    share the cores, and OpenBLAS's threads spin while the others hold them."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api='blas'):
        yield
    torch.set_num_threads(saved)


def run_interpreted(fn, *args, **kwargs):
    """A Pallas TPU kernel in interpret mode off the TPU (tests/test_pallas.py:18)."""
    if jax.devices()[0].platform != 'tpu':
        with pltpu.force_tpu_interpret_mode():
            return fn(*args, **kwargs)
    return fn(*args, **kwargs)


def _inputs(rows, c, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(rows, c).astype(np.float32) * 2.0, rng.randn(c).astype(np.float32))


def test_the_nine_activations_with_the_jax_packages_defaults():
    assert ACTS == list(jax_activation_funcs)
    for name, spec in activation_funcs.items():
        ref = jax_activation_funcs[name]
        assert (spec.def_alpha, spec.def_gain) == (ref.def_alpha, ref.def_gain), name


@pytest.mark.parametrize('opts', OPTS, ids=['defaults', 'alpha-gain-clamp'])
@pytest.mark.parametrize('act', ACTS)
def test_plain_matches_jax_and_the_tpu_kernel(act, opts):
    x, b = _inputs(1025, 8)
    port = bias_act_plain(torch.from_numpy(x), torch.from_numpy(b), act=act, **opts).numpy()
    np.testing.assert_allclose(port, np.asarray(jax_bias_act(jnp.asarray(x), jnp.asarray(b),
                                                             act=act, **opts)), **TOL)
    pallas = run_interpreted(bias_act_pallas, jnp.asarray(x), jnp.asarray(b), act=act, **opts)
    np.testing.assert_allclose(port, np.asarray(pallas), **TOL)


@pytest.mark.parametrize('rows', [1, 1023, 1024, 1025])
def test_row_counts_around_the_tpu_tile(rows):
    x, b = _inputs(rows, 16, seed=rows)
    port = bias_act(torch.from_numpy(x), torch.from_numpy(b), act='lrelu', clamp=1.5).numpy()
    pallas = run_interpreted(bias_act_pallas, jnp.asarray(x), jnp.asarray(b), act='lrelu',
                             clamp=1.5)
    np.testing.assert_allclose(port, np.asarray(pallas), **TOL)


def test_without_bias_and_on_a_4d_activation():
    x = np.random.RandomState(3).randn(2, 5, 5, 12).astype(np.float32)
    port = bias_act(torch.from_numpy(x), act='swish', gain=0.5, clamp=0.8).numpy()
    ref = jax_bias_act(jnp.asarray(x), act='swish', gain=0.5, clamp=0.8)
    np.testing.assert_allclose(port, np.asarray(ref), **TOL)


def test_negative_clamp_is_refused():
    with pytest.raises(ValueError, match='clamp'):
        bias_act(torch.zeros(2, 3), clamp=-1.0)


def test_cpu_tensors_take_the_plain_version_in_either_grad_mode():
    x, b = (torch.from_numpy(a) for a in _inputs(7, 4))
    before = bias_act.launches
    ref = bias_act_plain(x, b, act='elu', clamp=1.0)
    with torch.no_grad():
        np.testing.assert_array_equal(bias_act(x, b, act='elu', clamp=1.0).numpy(), ref.numpy())
    xg = x.clone().requires_grad_()
    out = bias_act(xg, b, act='elu', clamp=1.0)
    assert out.requires_grad
    np.testing.assert_array_equal(out.detach().numpy(), ref.numpy())
    assert bias_act.launches == before


def test_off_the_cpu_only_recorded_calls_take_the_plain_version():
    """On a device that is neither the CPU nor a card ('meta'), a call that
    autograd records runs the plain version, and any other call goes to the
    kernel's branch, which refuses the device: the rule a CUDA tensor meets."""
    x = torch.empty(4, 8, device='meta')
    b = torch.empty(8, device='meta')
    with pytest.raises(ValueError, match='CUDA or CPU'):
        bias_act(x, b, act='lrelu')
    with torch.no_grad(), pytest.raises(ValueError, match='CUDA or CPU'):
        bias_act(x.requires_grad_(), b, act='lrelu')
    out = bias_act(x, b, act='lrelu')  # x requires grad, grad mode on
    assert out.device.type == 'meta' and out.requires_grad
    out = bias_act(torch.empty(4, 8, device='meta'), b.requires_grad_(), act='lrelu')
    assert out.requires_grad


def _memory_order_channels(x):
    """The channel of each element in the order the elements lie in memory."""
    c = x.shape[-1]
    index = torch.arange(x.numel()).reshape(x.shape) % c  # channel of each logical element
    flat = torch.empty(x.numel(), dtype=torch.long)
    offsets = torch.zeros(x.shape, dtype=torch.long)
    for d in range(x.ndim):
        shape = [1] * x.ndim
        shape[d] = x.shape[d]
        offsets = offsets + torch.arange(x.shape[d]).reshape(shape) * x.stride(d)
    flat[(offsets - offsets.min()).flatten()] = index.flatten()
    return flat


@pytest.mark.parametrize('layout', ['nhwc', 'nchw-view'])
def test_channel_addressing_of_strided_views(layout):
    """The kernel reads element m of memory with bias[(m // inner) % C]; for a
    contiguous NHWC tensor inner is 1, for the NHWC view of an NCHW
    convolution output it is H * W."""
    n, h, w, c = 2, 3, 5, 4
    x = torch.randn(n, h, w, c) if layout == 'nhwc' else torch.randn(n, c, h, w).permute(0, 2, 3, 1)
    inner = channel_stride(x)
    assert inner == (1 if layout == 'nhwc' else h * w)
    m = torch.arange(x.numel())
    np.testing.assert_array_equal(((m // inner) % c).numpy(), _memory_order_channels(x).numpy())
    assert torch.empty_like(x).stride() == x.stride()  # the output keeps the layout


def test_channel_stride_refuses_tensors_with_gaps():
    assert channel_stride(torch.randn(4, 6)[:, :3]) is None
    assert channel_stride(torch.randn(4, 6)[::2]) is None
    assert channel_stride(torch.randn(3, 1, 5)) == 1


@pytest.mark.parametrize('act', ACTS)
def test_plain_version_has_its_double_backward(act):
    rng = np.random.RandomState(5)
    x = torch.tensor(rng.randn(3, 4) * 1.5 + 0.05, dtype=torch.float64, requires_grad=True)
    b = torch.tensor(rng.randn(4) * 0.1, dtype=torch.float64, requires_grad=True)

    def fn(x_, b_):
        return bias_act_plain(x_, b_, act=act, alpha=0.3, gain=0.9, clamp=50.0)

    assert torch.autograd.gradcheck(fn, (x, b))
    assert torch.autograd.gradgradcheck(fn, (x, b))


def test_kernel_refuses_what_it_does_not_take():
    """The launch path checks dtype and layout before it loads the library."""
    with pytest.raises(TypeError, match='float32'):
        K5._launch(torch.zeros(2, 4, dtype=torch.float64), None, 'linear', 0.0, 1.0, None)
    with pytest.raises(ValueError, match='dense'):
        K5._launch(torch.zeros(4, 8)[:, :4], None, 'linear', 0.0, 1.0, None)
    with pytest.raises(ValueError, match='bias'):
        K5._launch(torch.zeros(2, 4), torch.zeros(3), 'linear', 0.0, 1.0, None)
