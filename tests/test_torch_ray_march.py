"""Kernel K3's plain version and wrapper (tdgp_torch/ops/ray_march.py) vs the
JAX package's classical marcher and its Pallas kernel.

The CUDA kernel itself runs only on the card; `chip_smoke.py` holds it
against `ray_march_reduced_plain` there. Here the plain version is held
against `classical_ray_march` + a sum of the weights and against
`ray_march_pallas` in interpret mode (as tests/test_pallas.py runs it), at
1e-5: the same float32 formula, summed in another order.
"""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tdgp.ops.pallas_kernels import ray_march_pallas
from tdgp.rendering.renderer import RenderOptions, classical_ray_march

from tdgp_torch.ops import cuda_build
from tdgp_torch.ops.ray_march import ray_march_reduced, ray_march_reduced_plain

TOL = dict(rtol=1e-5, atol=1e-5)
CASES = [  # (clamp_mode, use_inf_depth, last_back)
    ('softplus', True, False), ('softplus', False, False), ('softplus', False, True),
    ('relu', True, False)]


@pytest.fixture(scope='module', autouse=True)
def _one_thread_per_worker():
    """One torch and one BLAS thread while this module runs: the test workers
    share the cores, and OpenBLAS's threads spin while the others hold them."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api='blas'):
        yield
    torch.set_num_threads(saved)


def _inputs(seed, b=2, r=64, s=32, c=3):
    rng = np.random.RandomState(seed)
    colors = rng.randn(b, r, s, c).astype(np.float32)
    densities = (rng.randn(b, r, s) * 2).astype(np.float32)
    depths = (np.sort(rng.rand(b, r, s), axis=-1) * 0.5 + 0.75).astype(np.float32)
    return colors, densities, depths


def _plain(colors, densities, depths, clamp_mode, use_inf_depth, last_back):
    out = ray_march_reduced_plain(torch.from_numpy(colors), torch.from_numpy(densities),
                                  torch.from_numpy(depths), clamp_mode, 1.0,
                                  use_inf_depth, last_back)
    return [t.numpy() for t in out]


@pytest.mark.parametrize('clamp_mode,use_inf_depth,last_back', CASES)
def test_plain_matches_classical_ray_march(clamp_mode, use_inf_depth, last_back):
    colors, densities, depths = _inputs(0)
    opts = RenderOptions(clamp_mode=clamp_mode, use_inf_depth=use_inf_depth,
                         last_back=last_back)
    rgb, depth, weights, ftrans = classical_ray_march(
        jnp.asarray(colors), jnp.asarray(densities), jnp.asarray(depths), opts)
    ref = [rgb, depth, jnp.sum(weights, -1), ftrans]
    for port, want in zip(_plain(colors, densities, depths, clamp_mode, use_inf_depth,
                                 last_back), ref):
        np.testing.assert_allclose(port, np.asarray(want), **TOL)


@pytest.mark.parametrize('clamp_mode,use_inf_depth,last_back', CASES)
def test_plain_matches_pallas_kernel(clamp_mode, use_inf_depth, last_back):
    colors, densities, depths = _inputs(1)
    with pltpu.force_tpu_interpret_mode():
        ref = ray_march_pallas(jnp.asarray(colors), jnp.asarray(densities),
                               jnp.asarray(depths), clamp_mode=clamp_mode,
                               use_inf_depth=use_inf_depth, last_back=last_back)
        ref = jax.device_get(ref)
    for port, want in zip(_plain(colors, densities, depths, clamp_mode, use_inf_depth,
                                 last_back), ref):
        np.testing.assert_allclose(port, np.asarray(want), **TOL)


def test_wrapper_takes_plain_version_for_cpu_tensors():
    colors, densities, depths = (torch.from_numpy(a) for a in _inputs(2))
    before = ray_march_reduced.launches
    out = ray_march_reduced(colors, densities, depths, 'softplus', 1.0, True, False)
    ref = ray_march_reduced_plain(colors, densities, depths, 'softplus', 1.0, True, False)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert ray_march_reduced.launches == before  # counts kernel launches only


@pytest.mark.parametrize('case', ['float64', 'shape', 'channels', 'clamp_mode', 'device'])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    colors, densities, depths = (torch.from_numpy(a) for a in _inputs(3, c=3))
    clamp_mode = 'softplus'
    error = ValueError
    if case == 'float64':
        densities, error = densities.double(), TypeError
    elif case == 'shape':
        depths = depths[:, :, :-1]
    elif case == 'channels':
        colors = torch.zeros(*colors.shape[:3], 5)
    elif case == 'clamp_mode':
        clamp_mode, error = 'exp', NotImplementedError
    else:
        colors = colors.to('meta')
    with pytest.raises(error):
        ray_march_reduced(colors, densities, depths, clamp_mode)


def test_cuda_sources_build_keyed_by_content(tmp_path, monkeypatch):
    """Every CUDA source is found, and its library name follows its content."""
    assert 'ray_march' in cuda_build.sources()
    path = cuda_build.library_path('ray_march')
    assert path.startswith(cuda_build.BUILD_DIR) and path.endswith('.so')
    src = tmp_path / 'ray_march.cu'
    src.write_text(open(cuda_build.sources()['ray_march']).read() + '\n// changed\n')
    monkeypatch.setattr(cuda_build, 'CSRC_DIR', str(tmp_path))
    assert cuda_build.library_path('ray_march') != path
