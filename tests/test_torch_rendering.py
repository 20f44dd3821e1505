"""Port (tdgp_torch.rendering) vs JAX package (tdgp.rendering) at eval:
cameras, rays, mid-bin and inverse-CDF sampling, the sorted merge and the
whole two-pass render over a small analytic field. Inputs from
np.random.RandomState; float32; rtol = atol = 1e-4 (XLA:CPU vs PyTorch
float32 skew, tests/conftest.py:18-33)."""
import dataclasses

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from tdgp.config import CameraConfig as JaxCameraConfig
from tdgp.rendering import camera as jax_camera
from tdgp.rendering import rays as jax_rays
from tdgp.rendering import renderer as jax_renderer
from tdgp.utils.tensor_group import TensorGroup as JaxTensorGroup

from tdgp_torch.config import CameraConfig
from tdgp_torch.rendering import camera, rays, renderer
from tdgp_torch.utils.tensor_group import TensorGroup

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


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **TOL)


def _cameras(seed, n=3):
    rng = np.random.RandomState(seed)
    return dict(
        angles=np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(0.8, 2.3, n),
                         np.zeros(n)], 1).astype(np.float32),
        fov=rng.uniform(10, 45, n).astype(np.float32),
        radius=np.ones(n, np.float32),
        look_at=np.stack([rng.uniform(-3, 3, n), rng.uniform(0, 3, n),
                          rng.uniform(0, 0.2, n)], 1).astype(np.float32))


def _both_cameras(seed):
    cams = _cameras(seed)
    return (TensorGroup(**{k: torch.from_numpy(v) for k, v in cams.items()}),
            JaxTensorGroup(**{k: jnp.asarray(v) for k, v in cams.items()}))


def test_mean_camera_params():
    port = camera.get_mean_camera_params(CameraConfig(), device='cpu')
    ref = jax_camera.get_mean_camera_params(dataclasses.asdict(JaxCameraConfig()))
    assert port.keys() == ['angles', 'fov', 'radius', 'look_at']
    for k in port.keys():
        _close(port[k], ref[k])


def test_cam2world_and_rays():
    cam, jcam = _both_cameras(0)
    c2w = camera.compute_cam2world_matrix(cam)
    jc2w = jax_camera.compute_cam2world_matrix(jcam)
    _close(c2w, jc2w)
    ro, rd = rays.sample_rays(c2w, cam.fov, resolution=(6, 4))
    jro, jrd = jax_rays.sample_rays(jc2w, jcam.fov, resolution=(6, 4))
    _close(ro, jro)
    _close(rd, jrd)


def test_sample_stratified_mid_bin():
    port = renderer.sample_stratified(2, 3, 7, device=torch.device('cpu'))
    ref = jax_renderer.sample_stratified(None, 2, 3, 7, jitter=False)
    _close(port, ref)


def test_sample_importance_deterministic():
    rng = np.random.RandomState(1)
    z = np.sort(rng.rand(2, 5, 12), -1).astype(np.float32)
    w = (rng.rand(2, 5, 12) ** 4).astype(np.float32)  # peaked: exercises the clipping
    port = renderer.sample_importance(torch.from_numpy(z), torch.from_numpy(w), 9)
    ref = np.asarray(
        jax_renderer.sample_importance(None, jnp.asarray(z), jnp.asarray(w), 9, det=True))
    _close(port[..., :-1], ref[..., :-1])
    # u = 1 lands at the end of the cdf, which rounds to just above or just
    # below 1 depending on the summation order: either way it lies in the
    # last bin of the midpoints z_mid
    z_mid = 0.5 * (z[..., 1:] + z[..., :-1])
    for last in (port[..., -1].numpy(), ref[..., -1]):
        assert np.all(last >= z_mid[..., -2] - 1e-6) and np.all(last <= z_mid[..., -1] + 1e-6)
    assert bool((port[..., 1:] >= port[..., :-1]).all())


def test_unify_samples_sorted_with_ties():
    rng = np.random.RandomState(2)
    d1 = np.sort(rng.rand(2, 4, 6), -1).astype(np.float32)
    d2 = np.sort(rng.rand(2, 4, 5), -1).astype(np.float32)
    d2[:, :, 2] = d1[:, :, 3]  # equal depths across the sets
    d2 = np.sort(d2, -1)
    c1, c2 = rng.randn(2, 4, 6, 3).astype(np.float32), rng.randn(2, 4, 5, 3).astype(np.float32)
    s1, s2 = rng.randn(2, 4, 6).astype(np.float32), rng.randn(2, 4, 5).astype(np.float32)
    port = renderer.unify_samples_sorted(*(torch.from_numpy(a) for a in (d1, c1, s1, d2, c2, s2)))
    ref = jax_renderer.unify_samples_sorted(*(jnp.asarray(a) for a in (d1, c1, s1, d2, c2, s2)))
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))


@pytest.mark.parametrize('march_impl,route', [
    pytest.param('fused', 'merged', id='fused'), pytest.param('jnp', 'merged', id='jnp'),
    pytest.param('fused', 'recording', id='fused-recording'),
    pytest.param('jnp', 'recording', id='jnp-recording')])
def test_importance_render(march_impl, route):
    """The whole two-pass render over a smooth analytic field: where autograd
    does not record, through K3's merged entry, which must also give what the
    recording route gives; where it records (training), through
    unify_samples_sorted and the differentiable march."""
    rng = np.random.RandomState(3)
    a = rng.randn(3, 3).astype(np.float32) * 3
    b = rng.randn(3).astype(np.float32) * 4

    def field(coords, a, b, sin, cos):
        return sin(coords @ a), 6 * cos(coords @ b) - 2

    cam, jcam = _both_cameras(4)
    ro, rd = rays.sample_rays(camera.compute_cam2world_matrix(cam), cam.fov, resolution=(8, 8))
    jro, jrd = jax_rays.sample_rays(jax_camera.compute_cam2world_matrix(jcam), jcam.fov,
                                    resolution=(8, 8))
    opts = renderer.RenderOptions(num_proposal_steps=12, num_fine_steps=12, march_impl=march_impl)
    jopts = jax_renderer.RenderOptions(num_proposal_steps=12, num_fine_steps=12)

    def render(record):
        a_t = torch.from_numpy(a).requires_grad_(record)
        with torch.set_grad_enabled(record):
            return a_t, renderer.importance_render(
                lambda x: field(x, a_t, torch.from_numpy(b), torch.sin, torch.cos), ro, rd, opts)

    a_t, port = render(route == 'recording')
    ref = jax_renderer.importance_render(
        lambda x: field(x, jnp.asarray(a), jnp.asarray(b), jnp.sin, jnp.cos),
        jro, jrd, jax.random.PRNGKey(0), jopts, jitter=False)
    for p, r in zip(port, ref):
        _close(p, r)
    if route == 'merged':
        assert all(p.grad_fn is None for p in port)
        for p, r in zip(port, render(True)[1]):
            assert torch.equal(p, r.detach())
    else:
        port[0].sum().backward()
        assert a_t.grad is not None and bool(torch.isfinite(a_t.grad).all())
