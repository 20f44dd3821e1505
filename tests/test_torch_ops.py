"""Port (tdgp_torch.ops) vs JAX package (tdgp.ops) on the same inputs.

Inputs come from np.random.RandomState; both sides run float32 on the CPU.
Tolerance rtol = atol = 1e-4: XLA:CPU's compiled kernels differ from
PyTorch's by ~1e-5 in float32 (tests/conftest.py:18-33).
"""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from tdgp.models.epigraf import tri_plane_sample as jax_tri_plane_sample
from tdgp.ops.bias_act import bias_act as jax_bias_act
from tdgp.ops.conv2d_resample import conv2d_resample as jax_conv2d_resample
from tdgp.ops.grid_sample import grid_sample_2d as jax_grid_sample_2d
from tdgp.ops.modulated_conv2d import modulated_conv2d as jax_modulated_conv2d
from tdgp.ops.upfirdn2d import setup_filter as jax_setup_filter
from tdgp.ops.upfirdn2d import upfirdn2d as jax_upfirdn2d
from tdgp.ops.upfirdn2d import upsample2d as jax_upsample2d

from tdgp_torch.models.epigraf import tri_plane_sample
from tdgp_torch.ops.bias_act import bias_act
from tdgp_torch.ops.conv2d_resample import conv2d_resample
from tdgp_torch.ops.grid_sample import grid_sample_2d
from tdgp_torch.ops.modulated_conv2d import modulated_conv2d
from tdgp_torch.ops.upfirdn2d import setup_filter, upfirdn2d, upsample2d

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope='module', autouse=True)
def _one_thread_per_worker():
    """One torch and one BLAS thread while this module runs: the test workers
    share the cores, and OpenBLAS's threads spin while the others hold them."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api='blas'):
        yield
    torch.set_num_threads(saved)


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **TOL)


def _conv_weight_to_port(w):
    """[kh, kw, ci, co] -> [co, ci, kh, kw]."""
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize('act,clamp', [('linear', None), ('linear', 0.5), ('lrelu', None),
                                       ('lrelu', 1.0)])
def test_bias_act(act, clamp):
    rng = np.random.RandomState(0)
    x, b = _rand(rng, 2, 5, 6, 16), _rand(rng, 16)
    port = bias_act(torch.from_numpy(x), torch.from_numpy(b), act=act, clamp=clamp)
    _close(port, jax_bias_act(jnp.asarray(x), jnp.asarray(b), act=act, clamp=clamp))


@pytest.mark.parametrize('up,down,padding,flip_filter,gain', [
    (1, 1, 1, False, 1.0),
    (2, 1, (2, 1, 2, 1), False, 4.0),
    (2, 1, (2, 1, 1, 2), True, 4.0),
    (1, 2, (1, 1, 1, 1), False, 1.0),
    (1, 1, (-1, 2, 0, -1), False, 2.0),
])
def test_upfirdn2d(up, down, padding, flip_filter, gain):
    rng = np.random.RandomState(1)
    x = _rand(rng, 2, 7, 9, 3)
    f = rng.rand(4, 3).astype(np.float32)  # asymmetric: catches a missed flip
    port = upfirdn2d(torch.from_numpy(x), torch.from_numpy(f), up=up, down=down,
                     padding=padding, flip_filter=flip_filter, gain=gain)
    ref = jax_upfirdn2d(jnp.asarray(x), jnp.asarray(f), up=up, down=down, padding=padding,
                        flip_filter=flip_filter, gain=gain)
    _close(port, ref)


def test_setup_filter_and_upsample2d():
    rng = np.random.RandomState(2)
    x = _rand(rng, 2, 5, 5, 4)
    f, jf = setup_filter([1, 3, 3, 1]), jax_setup_filter([1, 3, 3, 1])
    _close(f, jf)
    _close(upsample2d(torch.from_numpy(x), f), jax_upsample2d(jnp.asarray(x), jf))


@pytest.mark.parametrize('k,up,padding,flip_weight', [
    (3, 1, 1, True),      # SynthesisLayer conv1
    (1, 1, 0, True),      # ToRGB
    (3, 2, 1, False),     # SynthesisLayer conv0: transposed conv + filter
    (3, 2, 1, True),
    (1, 2, 0, False),
])
def test_conv2d_resample(k, up, padding, flip_weight):
    rng = np.random.RandomState(3)
    x, w = _rand(rng, 2, 8, 8, 5), _rand(rng, k, k, 5, 6)
    f = jax_setup_filter([1, 3, 3, 1]) if up > 1 else None
    port = conv2d_resample(torch.from_numpy(x), _conv_weight_to_port(w),
                           f=None if f is None else torch.from_numpy(np.array(f)),
                           up=up, padding=padding, flip_weight=flip_weight)
    ref = jax_conv2d_resample(jnp.asarray(x), jnp.asarray(w), f=f, up=up, padding=padding,
                              flip_weight=flip_weight)
    _close(port, ref)


@pytest.mark.parametrize('k,up,demodulate,with_noise', [
    (3, 1, True, True), (3, 2, True, True), (1, 1, False, False)])
def test_modulated_conv2d(k, up, demodulate, with_noise):
    rng = np.random.RandomState(4)
    n, h, ci, co = 2, 6, 8, 5
    x, w, styles = _rand(rng, n, h, h, ci), _rand(rng, k, k, ci, co), _rand(rng, n, ci)
    noise = _rand(rng, 1, h * up, h * up, 1) if with_noise else None
    f = jax_setup_filter([1, 3, 3, 1]) if up > 1 else None
    port = modulated_conv2d(
        torch.from_numpy(x), _conv_weight_to_port(w), torch.from_numpy(styles),
        noise=None if noise is None else torch.from_numpy(noise), up=up, padding=k // 2,
        resample_filter=None if f is None else torch.from_numpy(np.array(f)),
        demodulate=demodulate, flip_weight=(up == 1))
    ref = jax_modulated_conv2d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(styles),
        noise=None if noise is None else jnp.asarray(noise), up=up, padding=k // 2,
        resample_filter=f, demodulate=demodulate, flip_weight=(up == 1))
    _close(port, ref)


def test_grid_sample_2d():
    rng = np.random.RandomState(5)
    x = _rand(rng, 3, 6, 10, 4)  # H != W: catches a swapped coordinate
    coords = rng.uniform(-1.2, 1.2, size=(3, 50, 2)).astype(np.float32)  # some outside
    port = grid_sample_2d(torch.from_numpy(x), torch.from_numpy(coords))
    _close(port, jax_grid_sample_2d(jnp.asarray(x), jnp.asarray(coords)))


def test_tri_plane_sample():
    rng = np.random.RandomState(6)
    n, res, f, p = 2, 8, 4, 40
    planes = _rand(rng, n * 3, res, res, f)
    coords = rng.uniform(-0.55, 0.55, size=(n, p, 3)).astype(np.float32)
    port = tri_plane_sample(torch.from_numpy(planes), torch.from_numpy(coords), scale=0.5)
    ref = jax_tri_plane_sample(jnp.asarray(planes), jnp.asarray(coords), scale=0.5, impl='jnp')
    _close(port, ref)
