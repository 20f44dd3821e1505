"""The real patches as the JAX package's jitted step computes them on the
CPU (`tdgp_torch.utils.xla_float`), bit for bit: the `jnp.linspace(-1, 1, n)`
row, the positions (row + 1) x scale - 1 + offset x 2, and the bilinear
sampler's sum of the four corners."""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from tdgp.ops.grid_sample import grid_sample_nhwc as jax_grid_sample
from tdgp.training import patch as jax_patch

from tdgp_torch.ops.grid_sample import grid_sample_nhwc
from tdgp_torch.training import patch
from tdgp_torch.utils.xla_float import linspace_row


@pytest.fixture(scope='module', autouse=True)
def _one_thread_per_worker():
    """One torch and one BLAS thread while this module runs: the test workers
    share the cores, and OpenBLAS's threads spin while the others hold them."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api='blas'):
        yield
    torch.set_num_threads(saved)


def _patch_params(rs, n):
    s = np.repeat(rs.uniform(0.2, 1, (n, 1)), 2, 1).astype(np.float32)
    o = (rs.uniform(0, 1, (n, 2)) * (1 - s)).astype(np.float32)
    return {'scales': s, 'offsets': o}


@pytest.mark.parametrize('n', [1, 2, 3, 16, 17, 64, 100, 256])
def test_linspace_row_is_jaxs(n):
    ref = np.asarray(jax.jit(lambda: jnp.linspace(-1.0, 1.0, n))())
    np.testing.assert_array_equal(linspace_row(n).numpy(), ref)


@pytest.mark.parametrize('res,size', [(16, 32), (32, 64), (64, 256)])
def test_patches_are_jaxs(res, size):
    """`compute_patch_coords` and `extract_patches` against the jitted JAX
    functions; `torch.linspace`'s row misses."""
    rs = np.random.RandomState(res)
    pp = _patch_params(rs, 4)
    img = rs.randn(4, size, size, 3).astype(np.float32)
    jpp = {k: jnp.asarray(v) for k, v in pp.items()}
    tpp = {k: torch.from_numpy(v) for k, v in pp.items()}
    coords = np.asarray(jax.jit(lambda p: jax_patch.compute_patch_coords(p, res))(jpp))
    np.testing.assert_array_equal(patch.compute_patch_coords(tpp, res).numpy(), coords)
    ref = np.asarray(jax.jit(lambda x, p: jax_patch.extract_patches(x, p, res))(
        jnp.asarray(img), jpp))
    np.testing.assert_array_equal(patch.extract_patches(torch.from_numpy(img), tpp, res).numpy(),
                                  ref)
    x = torch.linspace(-1.0, 1.0, res)[None, :].expand(res, res)
    off = torch.stack([x, -x.t()], dim=2)[None]
    off = (off + 1.0) * tpp['scales'][:, None, None, :] - 1.0 + tpp['offsets'][:, None, None, :] * 2
    assert not np.array_equal(torch.stack([off[..., 0], -off[..., 1]], -1).numpy(), coords)


@pytest.mark.parametrize('align_corners', [True, False])
def test_bilinear_sum_is_jaxs(align_corners):
    rs = np.random.RandomState(7)
    x = rs.randn(2, 9, 9, 3).astype(np.float32)
    grid = rs.uniform(-1.1, 1.1, (2, 6, 5, 2)).astype(np.float32)
    ref = jax.jit(lambda a, g: jax_grid_sample(a, g, align_corners=align_corners))(x, grid)
    got = grid_sample_nhwc(torch.from_numpy(x), torch.from_numpy(grid),
                           align_corners=align_corners)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
