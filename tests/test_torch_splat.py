"""Tri-plane sampling with kernel K1 as its backward (tdgp_torch/ops/splat.py)
vs the JAX package's fused sampler and its Pallas splat kernels (K1, K2).

The CUDA kernel runs only on the card, where `chip_smoke.py` holds it against
`triplane_sample_bwd_plain`; on CPU tensors the wrapper computes that plain
version, which is held here against
  - `jax.vjp` of `triplane_sample_fused` (plane and coordinate gradients,
    Pallas splat K1 in interpret mode) and the scatter reference
    `triplane_splat_ref`, at a plane shape that meets the splat's tiling
    (W a multiple of 128);
  - K2, `triplane_splat` with 4- and 8-row windows and with overlapping
    windows, in interpret mode, after tests/test_splat.py.
rtol = 1e-4 and atol = 1e-4 x the largest magnitude of the reference: the
same float32 sums, taken in another order.
"""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from tdgp.ops.splat import triplane_sample_fused, triplane_splat as jax_triplane_splat
from tdgp.ops.splat import triplane_splat_ref

from tdgp_torch.ops.splat import (tri_plane_sample, triplane_sample, triplane_sample_bwd_plain,
                                  triplane_splat, triplane_splat_plain)

SCALE = 0.5


@pytest.fixture(scope='module', autouse=True)
def _one_thread_per_worker():
    """One torch and one BLAS thread while this module runs: the test workers
    share the cores, and OpenBLAS's threads spin while the others hold them."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api='blas'):
        yield
    torch.set_num_threads(saved)


def assert_close(port, ref, what=''):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(port), ref, rtol=1e-4,
                               atol=1e-4 * max(float(np.abs(ref).max()), 1.0), err_msg=what)


@pytest.fixture(scope='module')
def inputs():
    """planes [6, 64, 128, 8], coords [2, 97, 3] straddling the cube (some
    outside, some on the first row and the last column exactly), the
    cotangent of the plane mean and independent per-plane rows."""
    rng = np.random.RandomState(7)
    n, h, w, f, p = 2, 64, 128, 8, 97
    planes = rng.randn(3 * n, h, w, f).astype(np.float32)
    coords = rng.uniform(-0.62, 0.62, (n, p, 3)).astype(np.float32)
    coords[:, :8, 0] = SCALE        # gx = W-1: the +1 corner lies outside
    coords[:, 8:16, 1] = -SCALE     # gy = 0 on the x/y plane, gx = 0 on y/z
    coords[:, 16:24, 2] = SCALE
    g = rng.randn(n, p, f).astype(np.float32)
    g_pts = rng.randn(3 * n, p, f).astype(np.float32)
    return planes, coords, g, g_pts


@pytest.mark.parametrize('pack', ['none', 'quad'])
def test_plane_and_coords_gradients_match_jax_vjp(inputs, pack):
    planes, coords, g, _ = inputs
    out, vjp = jax.vjp(lambda pl, co: triplane_sample_fused(pl, co, SCALE, True, pack),
                       jnp.asarray(planes), jnp.asarray(coords))
    ref_planes, ref_coords = jax.jit(vjp)(jnp.asarray(g))
    pl_t = torch.from_numpy(planes).requires_grad_(True)
    co_t = torch.from_numpy(coords).requires_grad_(True)
    port = triplane_sample(pl_t, co_t, SCALE)
    port.backward(torch.from_numpy(g))
    assert_close(port.detach().numpy(), out, 'forward')
    assert_close(pl_t.grad.numpy(), ref_planes, 'g_planes')
    assert_close(co_t.grad.numpy(), ref_coords, 'g_coords')


def test_plane_gradient_matches_scatter_reference(inputs):
    planes, coords, g, _ = inputs
    n3, h, w, _ = planes.shape
    g_pts = np.repeat(g[:, None] / 3.0, 3, axis=1).reshape(n3, -1, g.shape[-1])
    ref = triplane_splat_ref(jnp.asarray(g_pts), jnp.asarray(coords), SCALE, n3, h, w)
    port, _ = triplane_splat(torch.from_numpy(planes), torch.from_numpy(coords),
                             torch.from_numpy(g), SCALE)
    assert_close(port.numpy(), ref)
    assert np.abs(np.asarray(ref)).max() > 0


def test_plain_splat_matches_scatter_reference(inputs):
    planes, coords, _, g_pts = inputs
    n3, h, w, _ = planes.shape
    ref = triplane_splat_ref(jnp.asarray(g_pts), jnp.asarray(coords), SCALE, n3, h, w)
    port = triplane_splat_plain(torch.from_numpy(g_pts), torch.from_numpy(coords), SCALE,
                                n3, h, w)
    assert_close(port.numpy(), ref)


@pytest.mark.parametrize('wrows,overlap', [(4, False), (8, False), (2, True), (4, True)])
def test_splat_matches_wide_and_overlap_windows(inputs, wrows, overlap):
    """K2: the same adjoint over wrows-row (or overlapping) window tables."""
    planes, coords, _, g_pts = inputs
    n3, h, w, _ = planes.shape
    ref = jax.jit(lambda gp, c: jax_triplane_splat(gp, c, SCALE, n3, h, w, interpret=True,
                                                   wrows=wrows, overlap=overlap))(
        jnp.asarray(g_pts), jnp.asarray(coords))
    port = triplane_splat_plain(torch.from_numpy(g_pts), torch.from_numpy(coords), SCALE,
                                n3, h, w)
    assert_close(port.numpy(), ref)


def test_wrapper_matches_wide_windows_on_the_mean_cotangent(inputs):
    planes, coords, g, _ = inputs
    n3, h, w, _ = planes.shape
    g_pts = np.repeat(g[:, None] / 3.0, 3, axis=1).reshape(n3, -1, g.shape[-1])
    ref = jax_triplane_splat(jnp.asarray(g_pts), jnp.asarray(coords), SCALE, n3, h, w,
                             interpret=True, wrows=4)
    port, _ = triplane_splat(torch.from_numpy(planes), torch.from_numpy(coords),
                             torch.from_numpy(g), SCALE)
    assert_close(port.numpy(), ref)


def test_gradients_match_autograd_of_the_plain_forward(inputs):
    """The plain backward is the exact adjoint of the forward (float64)."""
    planes, coords, g, _ = inputs
    pl = torch.from_numpy(planes).double().requires_grad_(True)
    co = torch.from_numpy(coords).double().requires_grad_(True)
    ref = torch.autograd.grad(tri_plane_sample(pl, co, SCALE), (pl, co),
                              torch.from_numpy(g).double())
    port = triplane_sample_bwd_plain(pl.detach(), co.detach(), torch.from_numpy(g).double(),
                                     SCALE)
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=1e-10)


def test_coordinate_gradient_is_skipped_when_not_needed(inputs):
    planes, coords, g, _ = inputs
    pl_t = torch.from_numpy(planes).requires_grad_(True)
    triplane_sample(pl_t, torch.from_numpy(coords), SCALE).backward(torch.from_numpy(g))
    _, g_coords = triplane_splat(torch.from_numpy(planes), torch.from_numpy(coords),
                                 torch.from_numpy(g), SCALE, coords_grad=False)
    assert pl_t.grad is not None and g_coords is None


def test_wrapper_counts_no_launch_and_checks_its_inputs(inputs):
    planes, coords, g, _ = inputs
    before = triplane_splat.launches
    triplane_splat(torch.from_numpy(planes), torch.from_numpy(coords), torch.from_numpy(g), SCALE)
    assert triplane_splat.launches == before  # CPU tensors take the plain version
    with pytest.raises(TypeError, match='float32'):
        triplane_sample(torch.from_numpy(planes).double(), torch.from_numpy(coords), SCALE)
    with pytest.raises(ValueError, match=r'\[3N,H,W,F\]'):
        triplane_sample(torch.from_numpy(planes[:5]), torch.from_numpy(coords), SCALE)
    with pytest.raises(ValueError, match='CUDA or CPU'):
        triplane_splat(torch.from_numpy(planes).to('meta'), torch.from_numpy(coords).to('meta'),
                       torch.from_numpy(g).to('meta'), SCALE)
