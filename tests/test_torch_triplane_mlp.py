"""Kernel K4's plain version and the port's TriPlaneMLP: port (tdgp_torch) vs JAX package (tdgp).

`tdgp_torch.ops.triplane_mlp.triplane_mlp_plain` is held against the TPU
kernel `triplane_mlp_pallas` (Pallas interpret mode, as tests/test_pallas.py
runs it) at the flagship widths F = 32, HID = 64, OUT = 4, with rtol 1e-4 and
atol 1e-5 as tests/test_pallas.py:112 holds the TPU kernel. The port's
`TriPlaneMLP` without gradients (the path that runs K4 on the card and its
plain version here) is held against the JAX package's `TriPlaneMLP` with
the same weights, and against its own path with gradients (its
`FullyConnected` layers). The CUDA kernel itself runs only on the card,
where `chip_smoke.py` holds it against the plain version.
"""
import dataclasses

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp
from flax import traverse_util
from jax.experimental.pallas import tpu as pltpu

from tdgp.config import tiny_test_config as jax_tiny_test_config
from tdgp.models.epigraf import TriPlaneMLP as JaxTriPlaneMLP
from tdgp.ops.pallas_kernels import triplane_mlp_pallas

from tdgp_torch.config import tiny_test_config
from tdgp_torch.models.epigraf import TriPlaneMLP
from tdgp_torch.ops.triplane_mlp import (fold_fully_connected, triplane_mlp,
                                         triplane_mlp_plain)
from tdgp_torch.weights import load_flat

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope='module', autouse=True)
def _one_thread_per_worker():
    """One torch and one BLAS thread while this module runs: the test workers
    share the cores, and OpenBLAS's threads spin while the others hold them."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api='blas'):
        yield
    torch.set_num_threads(saved)


def _interpreted(fn, *args):
    if jax.devices()[0].platform != 'tpu':
        with pltpu.force_tpu_interpret_mode():
            return fn(*args)
    return fn(*args)


def _folded_weights(f, hid, out, seed):
    """Pre-folded weights as tests/test_pallas.py:98-105 draws them."""
    rng = np.random.RandomState(seed)
    return tuple(a.astype(np.float32) for a in (rng.randn(f, hid) / np.sqrt(f),
                                                rng.randn(hid) * 0.1,
                                                rng.randn(hid, out) / np.sqrt(hid),
                                                rng.randn(out) * 0.1))


@pytest.mark.parametrize('n,p', [(2, 256), (1, 2100)], ids=['one-tile', 'ragged-tile'])
def test_plain_matches_the_tpu_kernel_at_flagship_widths(n, p):
    f, hid, out = 32, 64, 4
    feats = np.random.RandomState(p).randn(n, p, f).astype(np.float32)
    weights = _folded_weights(f, hid, out, seed=n)
    ref_rgb, ref_sigma = _interpreted(triplane_mlp_pallas, jnp.asarray(feats),
                                      *map(jnp.asarray, weights))
    rgb, sigma = triplane_mlp(torch.from_numpy(feats), *map(torch.from_numpy, weights))
    assert rgb.shape == (n, p, out - 1) and sigma.shape == (n, p)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(ref_rgb), **TOL)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(ref_sigma), **TOL)


def _configs(feat_dim, hid_dim, n_layers=2):
    """Port and JAX generator configs with the given tri-plane MLP widths."""
    out = []
    for cfg in (tiny_test_config().generator, jax_tiny_test_config().generator):
        mlp = dataclasses.replace(cfg.tri_plane.mlp, hid_dim=hid_dim, n_layers=n_layers)
        tri = dataclasses.replace(cfg.tri_plane, feat_dim=feat_dim, mlp=mlp)
        out.append(dataclasses.replace(cfg, tri_plane=tri))
    return out


@pytest.fixture(scope='module')
def mlps():
    """(port TriPlaneMLP, JAX TriPlaneMLP, its variables) at F=32, HID=64, OUT=4."""
    port_cfg, jax_cfg = _configs(32, 64)
    jax_mlp = JaxTriPlaneMLP(jax_cfg, out_dim=3)
    x = jnp.zeros((1, 4, 32), jnp.float32)
    variables = jax_mlp.init(jax.random.PRNGKey(7), x)
    flat = {'/'.join(k): np.asarray(v)
            for k, v in traverse_util.flatten_dict(jax.device_get(variables)).items()}
    port = TriPlaneMLP(port_cfg, out_dim=3)
    load_flat(port, flat)
    return port.eval(), jax_mlp, variables


def test_mlp_without_gradients_matches_jax_and_its_gradient_path(mlps):
    port, jax_mlp, variables = mlps
    feats = np.random.RandomState(11).randn(2, 300, 32).astype(np.float32)
    ref_rgb, ref_sigma = jax_mlp.apply(variables, jnp.asarray(feats))
    before = triplane_mlp.launches
    with torch.no_grad():
        rgb, sigma = port(torch.from_numpy(feats))
    assert triplane_mlp.launches == before  # CPU tensors take the plain version
    np.testing.assert_allclose(rgb.numpy(), np.asarray(ref_rgb), **TOL)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(ref_sigma), **TOL)
    grad_rgb, grad_sigma = port(torch.from_numpy(feats))  # recorded: the FullyConnected layers
    assert grad_sigma.requires_grad
    np.testing.assert_allclose(rgb.numpy(), grad_rgb.detach().numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sigma.numpy(), grad_sigma.detach().numpy(), rtol=1e-5, atol=1e-6)


def test_folding_gives_the_layers_weights(mlps):
    port = mlps[0]
    w0, b0 = fold_fully_connected(port.fc0)
    x = torch.randn(5, 32)
    with torch.no_grad():
        np.testing.assert_allclose((x @ w0 + b0).numpy(),
                                   torch.nn.functional.linear(x, port.fc0.weight * port.fc0.weight_gain,
                                                              port.fc0.bias).numpy(),
                                   rtol=1e-6, atol=1e-6)
        rgb, sigma = triplane_mlp_plain(x[None], w0, b0, *fold_fully_connected(port.fc1))
    assert rgb.shape == (1, 5, 3) and sigma.shape == (1, 5)


def test_three_layers_run_as_layers_on_the_cpu_and_are_refused_off_it(monkeypatch):
    """Three layers run as their `FullyConnected` layers on any device, as
    the JAX package runs every depth, recorded or not: off the CPU too (the
    meta device stands in for the card), where K4, built for two layers, is
    not called and each layer's bias + activation goes to K5's wrapper
    (spied here: it would launch K5 on a CUDA tensor). (The name is older
    than the layers off the CPU.)"""
    from tdgp_torch.models import epigraf, layers
    from tdgp_torch.ops.bias_act import bias_act_plain
    cfg, _ = _configs(8, 16, n_layers=3)
    mlp = TriPlaneMLP(cfg, out_dim=3).eval()
    with torch.no_grad():
        rgb, sigma = mlp(torch.randn(1, 6, 8))
    assert rgb.shape == (1, 6, 3) and sigma.shape == (1, 6)

    def no_k4(*args):
        raise AssertionError('K4 called for three layers')

    k5_calls = []

    def k5(x, b=None, **kwargs):
        k5_calls.append(torch.is_grad_enabled() and x.requires_grad)
        return bias_act_plain(x, b, **kwargs)

    monkeypatch.setattr(epigraf, 'triplane_mlp', no_k4)
    monkeypatch.setattr(layers, 'bias_act', k5)
    mlp = mlp.to('meta')  # a device other than the CPU: the dispatch a CUDA tensor meets
    with torch.no_grad():
        rgb, sigma = mlp(torch.empty(1, 6, 8, device='meta'))
    assert rgb.shape == (1, 6, 3) and sigma.shape == (1, 6) and not sigma.requires_grad
    assert k5_calls == [False] * 3
    rgb, sigma = mlp(torch.empty(1, 6, 8, device='meta'))  # recorded: the layers
    assert sigma.requires_grad


def test_two_layers_off_the_cpu_go_to_the_kernel():
    cfg, _ = _configs(8, 16)
    mlp = TriPlaneMLP(cfg, out_dim=3).to('meta').eval()
    with torch.no_grad(), pytest.raises(ValueError, match='CUDA or CPU'):
        mlp(torch.empty(1, 6, 8, device='meta'))


def test_wrapper_refuses_mismatched_weights():
    w0, b0, w1, b1 = map(torch.from_numpy, _folded_weights(8, 16, 4, seed=0))
    with pytest.raises(ValueError, match='do not fit'):
        triplane_mlp(torch.zeros(1, 3, 9), w0, b0, w1, b1)


def _tf32(a):
    """float32 -> the nearest TF32 value (10-bit mantissa, ties away from
    zero), as `cvt.rna.tf32.f32` rounds."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def test_3xtf32_split_meets_the_card_limit_at_flagship_widths():
    """K4 on the card runs x @ w0 as three TF32 products: with hi = tf32(v)
    and lo = tf32(v - hi), x w0 = x_lo w_hi + x_hi w_lo + x_hi w_hi in
    float32. Emulated here, with the second layer in float32 as the kernel
    runs it, the split holds the plain version to the card's limit, 1e-5 x
    max |plain|, where a single TF32 product does not."""
    f, hid, out = 32, 64, 4
    feats = (np.random.RandomState(5).randn(4, 4096, f) * 3).astype(np.float32)
    w0, b0, w1, b1 = _folded_weights(f, hid, out, seed=3)
    x_hi, w_hi = _tf32(feats), _tf32(w0)
    x_lo, w_lo = _tf32(feats - x_hi), _tf32(w0 - w_hi)
    np.testing.assert_array_equal(_tf32(x_hi), x_hi)
    assert np.all(x_hi.view(np.uint32) & np.uint32(0x1FFF) == 0)

    def mlp(first):
        h = torch.nn.functional.leaky_relu(first + torch.from_numpy(b0), 0.2) * np.sqrt(2.0)
        y = h @ torch.from_numpy(w1) + torch.from_numpy(b1)
        return y[..., :-1], y[..., -1]

    t = torch.from_numpy
    three = t(x_lo) @ t(w_hi) + t(x_hi) @ t(w_lo) + t(x_hi) @ t(w_hi)
    one = t(x_hi) @ t(w_hi)
    ref = triplane_mlp_plain(t(feats), *map(t, (w0, b0, w1, b1)))
    for got, limit_met in ((mlp(three), True), (mlp(one), False)):
        rel = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, ref)]
        assert all(r <= 1e-5 for r in rel) == limit_met, rel
