"""The gradient of kernel K3 (tdgp_torch/ops/ray_march.py) vs the JAX
package's `ray_march_fused` VJP.

`ray_march_reduced` is a `torch.autograd.Function`: its backward is the CUDA
kernel on the card, where `chip_smoke.py` holds it against
`ray_march_reduced_bwd_plain`; for CPU tensors it is that plain version.
Here it is held against `jax.vjp` of `ray_march_fused` (its forward the
Pallas kernel in interpret mode, as tests/test_pallas.py:61 runs it, its
backward the analytic `_ray_march_bwd`) over clamp_mode x last_back x
use_inf_depth, with all four outputs' cotangents. rtol = 1e-4, atol = 1e-4 x
the largest magnitude of the reference gradient: the same float32 formula,
summed in another order.
"""
import itertools

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tdgp.ops.pallas_kernels import ray_march_fused

from tdgp_torch.ops.ray_march import (ray_march_reduced, ray_march_reduced_bwd,
                                      ray_march_reduced_bwd_plain, ray_march_reduced_plain,
                                      ray_march_reduced_reference)

CASES = list(itertools.product(['softplus', 'relu'], [False, True], [True, False]))


@pytest.fixture(scope='module', autouse=True)
def _one_thread_per_worker():
    """One torch and one BLAS thread while this module runs: the test workers
    share the cores, and OpenBLAS's threads spin while the others hold them."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api='blas'):
        yield
    torch.set_num_threads(saved)


def _inputs(seed, b=2, r=16, s=24, c=3):
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, r, s, c).astype(np.float32),
         (rng.randn(b, r, s) * 2).astype(np.float32),
         (np.sort(rng.rand(b, r, s), axis=-1) + 0.5).astype(np.float32))
    cots = (rng.randn(b, r, c).astype(np.float32),) + tuple(
        rng.randn(b, r).astype(np.float32) for _ in range(3))
    return x, cots


@pytest.mark.parametrize('clamp_mode,last_back,use_inf_depth', CASES)
def test_backward_matches_jax_vjp(clamp_mode, last_back, use_inf_depth):
    (colors, densities, depths), cots = _inputs(1)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda c, d, t: ray_march_fused(c, d, t, clamp_mode, 1.0,
                                                         use_inf_depth, last_back),
                         jnp.asarray(colors), jnp.asarray(densities), jnp.asarray(depths))
        refs = jax.jit(vjp)(tuple(jnp.asarray(g) for g in cots))
    inputs = [torch.from_numpy(a).requires_grad_(True) for a in (colors, densities, depths)]
    outs = ray_march_reduced(*inputs, clamp_mode, 1.0, use_inf_depth, last_back)
    torch.autograd.backward(outs, [torch.from_numpy(g) for g in cots])
    for t, ref, name in zip(inputs, refs, ('colors', 'densities', 'depths')):
        ref = np.asarray(ref)
        np.testing.assert_allclose(t.grad.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * max(float(np.abs(ref).max()), 1.0), err_msg=name)


@pytest.mark.parametrize('clamp_mode,last_back,use_inf_depth', CASES[::3])
def test_plain_backward_is_the_adjoint_of_the_plain_forward(clamp_mode, last_back,
                                                            use_inf_depth):
    """In float64, the closed form equals autograd through the plain marcher."""
    x, cots = _inputs(2)
    inputs = [torch.from_numpy(a).double().requires_grad_(True) for a in x]
    outs = ray_march_reduced_plain(*inputs, clamp_mode, 1.0, use_inf_depth, last_back)
    g64 = [torch.from_numpy(g).double() for g in cots]
    refs = torch.autograd.grad(outs, inputs, g64)
    got = ray_march_reduced_bwd_plain(*[t.detach() for t in inputs], *g64, clamp_mode, 1.0,
                                      use_inf_depth, last_back)
    for a, b in zip(got, refs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9, atol=1e-9)


def test_missing_cotangents_count_as_zero_and_no_kernel_runs_on_the_cpu():
    x, cots = _inputs(3)
    inputs = [torch.from_numpy(a).requires_grad_(True) for a in x]
    before = (ray_march_reduced.launches, ray_march_reduced_bwd.launches)
    rgb, _, _, _ = ray_march_reduced(*inputs)
    rgb.backward(torch.from_numpy(cots[0]))
    zeros = [torch.zeros_like(torch.from_numpy(g)) for g in cots[1:]]
    ref = ray_march_reduced_bwd_plain(*[torch.from_numpy(a) for a in x],
                                      torch.from_numpy(cots[0]), *zeros)
    for t, r in zip(inputs, ref):
        np.testing.assert_allclose(t.grad.numpy(), r.numpy(), rtol=1e-6, atol=1e-6)
    assert (ray_march_reduced.launches, ray_march_reduced_bwd.launches) == before


def test_plain_route_matches_the_kernel_route_on_the_cpu():
    """`ray_march_reduced_reference` (the plain forward and backward on any
    device, the card's reference in chip_smoke.py) and `ray_march_reduced`
    compute the same function; on CPU tensors both are the plain version."""
    x, cots = _inputs(4)
    grads = []
    for march in (ray_march_reduced, ray_march_reduced_reference):
        inputs = [torch.from_numpy(a).requires_grad_(True) for a in x]
        torch.autograd.backward(march(*inputs), [torch.from_numpy(g) for g in cots])
        grads.append([t.grad for t in inputs])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
