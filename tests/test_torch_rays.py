"""The rays on the JAX package's rows: `jax_row_rays` below builds
`tdgp/rendering/rays.py:sample_rays` as the jitted JAX step computes it on
the CPU, bit for bit, with PyTorch:
  - x is `utils/xla_float.linspace_row(w)` (`jnp.linspace(-1, 1, w)` under
    XLA), y its negation (not the reversed row:
    tests/test_torch_settings.py::test_negated_row_is_not_the_reversed_row);
  - a patch's positions by `xla_float.to_patch` (XLA's fused multiply-add);
  - degrees to radians by one float32 constant,
    f32(f32(f32(1 / 360) * 2) * f32(pi)), as XLA folds `/ 360 * 2 * pi`;
  - the focal's tangent by the C library's `tanf`, as XLA:CPU takes it,
    with the derivative 1 + tan^2 of its value, as JAX's.
The port's renderer (`tdgp_torch/rendering/rays.py`) still takes
`torch.linspace`'s rows and `torch.tan` (ROADMAP §3.1: with JAX's rows the
card's bf16 train check through the `gmain_render_bf16` view misses its
limit); here it is held within 2e-6 of JAX's rays, and the recipe bit for
bit at 64^2 and 256^2, with and without a patch's scale and offset, over
seeded cameras and fovs.
"""
import ctypes
import ctypes.util
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tdgp.rendering import rays as jax_rays
from tdgp.rendering.camera import compute_cam2world_matrix as jax_cam2world
from tdgp.utils.tensor_group import TensorGroup as JaxGroup

from tdgp_torch.rendering import rays
from tdgp_torch.rendering.camera import compute_cam2world_matrix, normalize_vec
from tdgp_torch.utils.tensor_group import TensorGroup
from tdgp_torch.utils.xla_float import linspace_row, to_patch

DEG_TO_RAD = float(np.float32(np.float32(np.float32(1.0 / 360.0) * np.float32(2.0))
                              * np.float32(math.pi)))


@functools.cache
def _tanf():
    fn = ctypes.CDLL(ctypes.util.find_library('m')).tanf
    fn.argtypes, fn.restype = [ctypes.c_float], ctypes.c_float
    return fn


class Tanf(torch.autograd.Function):
    """tan of a float32 CPU tensor by the C library's `tanf`; its derivative
    1 + tan^2 of the value."""

    @staticmethod
    def forward(ctx, x):
        out = torch.tensor([_tanf()(v) for v in x.detach().reshape(-1).tolist()],
                           dtype=torch.float32).reshape(x.shape)
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        t, = ctx.saved_tensors
        return g * (1.0 + t * t)


def jax_row_rays(c2w, fov, resolution, patch_params=None):
    """`rays.sample_rays` on jitted JAX's rows (the module docstring)."""
    n = c2w.shape[0]
    w, h = resolution
    x = linspace_row(w)[None, :].expand(h, w).reshape(1, -1).expand(n, -1)
    y = (-linspace_row(h))[:, None].expand(h, w).reshape(1, -1).expand(n, -1)
    if patch_params is not None:
        scales, offsets = patch_params['scales'], patch_params['offsets']
        x = to_patch(x, scales[:, 0:1], offsets[:, 0:1])
        y = to_patch(y, scales[:, 1:2], offsets[:, 1:2])
    fov_rad = fov.to(torch.float32).reshape(-1).expand(n)[:, None] * DEG_TO_RAD
    z = -torch.ones_like(x) / Tanf.apply(fov_rad * 0.5)
    ray_d = torch.einsum('bij,bpj->bpi', c2w[:, :3, :3], normalize_vec(torch.stack([x, y, z], 2)))
    return c2w[:, None, :3, 3].expand_as(ray_d), ray_d


def _cameras(seed, n=4):
    """Seeded cameras: angles, radius, fov in [6, 40] degrees, look-at
    (numpy), and a patch's scales and offsets."""
    rs = np.random.RandomState(seed)
    cam = dict(angles=np.concatenate([rs.uniform(0, 2 * math.pi, (n, 1)),
                                      rs.uniform(0.3, 2.8, (n, 1)), np.zeros((n, 1))], 1),
               radius=rs.uniform(1.5, 3.0, n), fov=rs.uniform(6.0, 40.0, n),
               look_at=rs.uniform(-0.1, 0.1, (n, 3)))
    cam = {k: v.astype(np.float32) for k, v in cam.items()}
    pp = {'scales': rs.uniform(0.125, 1.0, (n, 2)).astype(np.float32),
          'offsets': rs.uniform(0.0, 0.5, (n, 2)).astype(np.float32)}
    return cam, pp


def _both(seed, res, patch):
    """(JAX's jitted rays, the port's c2w, fov and patch) on `_cameras(seed)`."""
    cam, pp = _cameras(seed)
    jc2w = jax_cam2world(JaxGroup(**{k: jnp.asarray(v) for k, v in cam.items()}))
    jpp = {k: jnp.asarray(v) for k, v in pp.items()} if patch else None
    jro, jrd = jax.jit(lambda c, f, p: jax_rays.sample_rays(c, f, (res, res), p))(
        jc2w, jnp.asarray(cam['fov']), jpp)
    c2w = compute_cam2world_matrix(TensorGroup(**{k: torch.from_numpy(v) for k, v in cam.items()}))
    tpp = {k: torch.from_numpy(v) for k, v in pp.items()} if patch else None
    return (np.asarray(jro), np.asarray(jrd)), (torch.from_numpy(np.array(jc2w)),
                                                torch.from_numpy(cam['fov']), tpp)


@pytest.mark.parametrize('patch', [False, True], ids=['image', 'patch'])
@pytest.mark.parametrize('res', [64, 256])
def test_jax_rows_give_jitted_jax_rays_bit_for_bit(res, patch):
    for seed in (0, 1):
        (jro, jrd), (c2w, fov, pp) = _both(seed, res, patch)
        ro, rd = jax_row_rays(c2w, fov, (res, res), pp)
        np.testing.assert_array_equal(ro.numpy(), jro)
        np.testing.assert_array_equal(rd.numpy(), jrd)


@pytest.mark.parametrize('patch', [False, True], ids=['image', 'patch'])
@pytest.mark.parametrize('res', [64, 256])
def test_port_rays_are_within_2e_6_of_jax(res, patch):
    """The renderer's rays (`torch.linspace`'s rows, `torch.tan`) against
    jitted JAX's: a few float32 ulps apart (ROADMAP §3.1)."""
    (jro, jrd), (c2w, fov, pp) = _both(2, res, patch)
    ro, rd = rays.sample_rays(c2w, fov, (res, res), pp)
    np.testing.assert_array_equal(ro.numpy(), jro)
    np.testing.assert_allclose(rd.numpy(), jrd, rtol=0, atol=2e-6)


def test_tanf_matches_xla_on_the_fovs_and_its_derivative_is_jaxs():
    """`tanf` against `jnp.tan` under `jit` on 10,001 half-angles of fovs in
    [6, 46] degrees, bit for bit; the derivative of the rays' z with
    respect to the fov against JAX's gradient of the same function."""
    half = (np.linspace(6.0, 46.0, 10001).astype(np.float32) * np.float32(DEG_TO_RAD)
            * np.float32(0.5)).astype(np.float32)
    ref = np.asarray(jax.jit(jnp.tan)(jnp.asarray(half)))
    np.testing.assert_array_equal(Tanf.apply(torch.from_numpy(half)).numpy(), ref)
    fov = np.array([8.0, 17.5, 33.0], np.float32)

    def jz(f):
        return jnp.sum(-1.0 / jnp.tan(f / 360.0 * 2.0 * math.pi * 0.5))

    jgrad = np.asarray(jax.jit(jax.grad(jz))(jnp.asarray(fov)))
    t = torch.from_numpy(fov).requires_grad_(True)
    (-1.0 / Tanf.apply(t * DEG_TO_RAD * 0.5)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), jgrad, rtol=1e-6)
