"""The bf16 blocks' ops: port (tdgp_torch) vs JAX package (tdgp) in bfloat16.

Below float32 the JAX package computes every operation in x's dtype: the
bias and the weights are cast to bf16, weakly typed Python constants
(lrelu's alpha, the gain, the clamp) are rounded to it, elementwise
operations round their result to it, and convolutions accumulate in
float32 and round their output once. The port mirrors those cast points.
The JAX side runs op by op (each operation compiled alone), so that XLA's
excess precision (`xla_allow_excess_precision`, which drops a rounding
between two operations it fuses) does not enter the comparison.

Limits, measured first (the witnesses are in CHANGES.md):
  - `bias_act`, the nine activations: bit for bit (the activations that are
    a chain of operations in JAX run as that chain in the port);
  - convolutions, `conv2d_resample`, `upfirdn2d`, `modulated_conv2d`: the
    share of elements that differ at all <= MAX_SHARE, and the relative L2
    distance <= REL_OF_FLOOR x the op's bf16 floor (JAX in bf16 vs JAX in
    float32 on the same inputs). The float32 sums of oneDNN and XLA add in
    another order and can flip a rounding; where two convolutions follow
    each other (resampling), a flipped intermediate moves a few outputs by
    more than one ulp.
Each limit has a mutation witness that exceeds it: the constants left
unrounded, the pre-normalization skipped, the weight cast before the gain
in `Conv2dLayer`, the upsampling's other order (the float32 route).
"""
import importlib
import math

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from tdgp.models.layers import Conv2dLayer as JaxConv2dLayer
from tdgp.models.layers import FullyConnected as JaxFullyConnected
from tdgp.ops.bias_act import bias_act as jax_bias_act
from tdgp.ops.conv2d_resample import conv2d_resample as jax_conv2d_resample
from tdgp.ops.modulated_conv2d import modulated_conv2d as jax_modulated_conv2d

from tdgp_torch.models.layers import Conv2dLayer, FullyConnected
from tdgp_torch.ops import bias_act as K5
from tdgp_torch.ops import conv2d_resample as port_resample
from tdgp_torch.ops import modulated_conv2d as port_modconv
from tdgp_torch.ops import upfirdn2d as port_fir
from tdgp_torch.ops.bias_act import activation_funcs, bias_act, bias_act_plain, round_to
from tdgp_torch.weights import flatten_tree, load_flat

jax_fir = importlib.import_module('tdgp.ops.upfirdn2d')  # the package exports the function
BF = torch.bfloat16
MAX_SHARE = 2e-3     # share of elements that differ (one ulp or more)
REL_OF_FLOOR = 0.15  # relative L2 distance over the op's bf16 floor
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


def bf16_array(x):
    """numpy float32 -> (JAX bf16 array, port bf16 tensor) of the same values."""
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(BF)


def as_f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def ulps(port, ref):
    """Distance in bf16 ulps of each element (the bit patterns' order)."""
    def ordered(a):
        bits = np.asarray(jnp.asarray(as_f32(a), jnp.bfloat16)).view(np.int16).astype(np.int64)
        return np.where(bits < 0, -(bits & 0x7FFF), bits)
    return np.abs(ordered(port) - ordered(ref))


def rel_l2(a, b):
    a, b = as_f32(a).astype(np.float64), as_f32(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def within(port, ref, ref_f32):
    """(share of elements that differ, relative L2 over the floor)."""
    return float(np.mean(ulps(port, ref) > 0)), rel_l2(port, ref) / rel_l2(ref, ref_f32)


def check_within(port, ref, ref_f32):
    share, of_floor = within(port, ref, ref_f32)
    assert share <= MAX_SHARE and of_floor <= REL_OF_FLOOR, (share, of_floor)


# ------------------------------------------------------------------ bias_act

def _inputs(shape, c, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape, c).astype(np.float32) * 3.0, rng.randn(c).astype(np.float32))


@pytest.mark.parametrize('opts', OPTS, ids=['defaults', 'alpha-gain-clamp'])
@pytest.mark.parametrize('act', list(activation_funcs))
def test_bias_act_in_bf16_is_the_jax_packages_bit_for_bit(act, opts):
    """The bias cast to bf16, the constants rounded to it, every operation
    rounded to it: 0 of 65,536 elements differ, for all nine activations."""
    x, b = _inputs((16, 64), 64, seed=1)
    xj, xt = bf16_array(x)
    ref = jax_bias_act(xj, jnp.asarray(b), act=act, **opts)
    port = bias_act_plain(xt, torch.from_numpy(b), act=act, **opts)
    assert port.dtype == BF
    np.testing.assert_array_equal(ulps(port, ref), 0)


def test_bias_act_constants_left_unrounded_differ_from_the_jax_package():
    """Mutation witness: lrelu with alpha, gain and clamp in float32, as
    `F.leaky_relu(x, 0.2) * sqrt(2)` keeps them, moves 10 % of the
    elements here by an ulp."""
    x, b = _inputs((16, 64), 64, seed=1)
    xj, xt = bf16_array(x)
    ref = jax_bias_act(xj, jnp.asarray(b), act='lrelu', clamp=256.0)
    y = xt + torch.from_numpy(b).to(BF)
    unrounded = (torch.nn.functional.leaky_relu(y, 0.2) * math.sqrt(2)).clamp(-256.0, 256.0)
    assert float(np.mean(ulps(unrounded, ref) > 0)) > 0.05


def test_round_to_is_jax_weak_typing():
    assert round_to(0.2, BF) == 0.2001953125 and round_to(math.sqrt(2), BF) == 1.4140625
    assert round_to(0.2, torch.float32) == float(np.float32(0.2))
    x = torch.tensor([1.0, -3.0], dtype=BF)
    np.testing.assert_array_equal(
        as_f32(bias_act_plain(x, act='lrelu')),
        as_f32(jax_bias_act(jnp.asarray([1.0, -3.0], jnp.bfloat16), act='lrelu')))


def test_the_float32_path_is_unchanged_bit_for_bit():
    """At float32 every activation is the one PyTorch function, with the
    constants as they were (rounding them to float32 changes no bit)."""
    x, b = (torch.from_numpy(a) for a in _inputs((8, 32), 32, seed=2))
    for act, spec in activation_funcs.items():
        y = spec.func(x + b, spec.def_alpha)
        if spec.def_gain != 1.0:
            y = y * spec.def_gain
        assert torch.equal(bias_act_plain(x, b, act=act, clamp=1e9), y.clamp(-1e9, 1e9)), act


def test_kernel_takes_bf16_and_counts_it_apart():
    """The launch path takes float32 and bfloat16 and refuses other dtypes
    before it loads the library; the counts by dtype start at zero."""
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        K5._launch(torch.zeros(2, 8, dtype=torch.float16), None, 'linear', 0.0, 1.0, None)
    with pytest.raises(ValueError, match='dense'):
        K5._launch(torch.zeros(4, 16, dtype=BF)[:, :8], None, 'linear', 0.0, 1.0, None)
    saved = bias_act.launches, bias_act.launches_by_dtype
    try:
        K5.reset_launches()
        assert bias_act.launches == 0 and sum(bias_act.launches_by_dtype.values()) == 0
    finally:
        bias_act.launches, bias_act.launches_by_dtype = saved


def test_bf16_on_the_cpu_takes_the_plain_version():
    x, b = (torch.from_numpy(a) for a in _inputs((4, 8), 8, seed=3))
    before = bias_act.launches
    with torch.no_grad():
        y = bias_act(x.to(BF), b, act='lrelu', clamp=256.0)
    assert y.dtype == BF and torch.equal(y, bias_act_plain(x.to(BF), b, act='lrelu', clamp=256.0))
    assert bias_act.launches == before


# ------------------------------------------------------------------ convolutions

FILTER = [1, 3, 3, 1]


def _conv_case(k, seed=0, c=32, hw=16):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, hw, hw, c).astype(np.float32)
    w = (rng.randn(k, k, c, c) * 0.2).astype(np.float32)  # HWIO, the JAX layout
    return x, w, torch.from_numpy(w.transpose(3, 2, 0, 1).copy())


@pytest.mark.parametrize('k', [1, 3])
@pytest.mark.parametrize('up,down', [(1, 1), (2, 1), (1, 2)], ids=['plain', 'up', 'down'])
def test_conv2d_resample_in_bf16(up, down, k):
    x, w, wt = _conv_case(k, seed=k + up)
    xj, xt = bf16_array(x)
    f = jax_fir.setup_filter(FILTER)
    kw = dict(up=up, down=down, padding=k // 2, flip_weight=(up == 1))
    ref = jax_conv2d_resample(xj, jnp.asarray(w), f=f, **kw)
    ref32 = jax_conv2d_resample(jnp.asarray(x), jnp.asarray(w), f=f, **kw)
    port = port_resample.conv2d_resample(xt, wt, f=port_fir.setup_filter(FILTER), **kw)
    assert port.dtype == BF and port.shape == ref.shape
    check_within(port, ref, ref32)


def test_upsampling_in_the_float32_order_misses_the_limit():
    """Mutation witness: the transposed convolution, then the FIR filter
    (the float32 route), rounds at another point: about half the elements
    differ."""
    x, w, wt = _conv_case(3, seed=4)
    xj, xt = bf16_array(x)
    f = jax_fir.setup_filter(FILTER)
    kw = dict(up=2, padding=1, flip_weight=False)
    ref = jax_conv2d_resample(xj, jnp.asarray(w), f=f, **kw)
    ref32 = jax_conv2d_resample(jnp.asarray(x), jnp.asarray(w), f=f, **kw)
    fir = port_fir.upfirdn2d
    calls = []

    def rounded_fir(y, f_, **kwargs):  # the transposed convolution's output and the FIR's in bf16
        calls.append(y.dtype)
        return fir(y.to(BF), f_, **kwargs).to(BF)
    port_resample.upfirdn2d = rounded_fir
    try:  # float32 operands take the float32 route
        other = port_resample.conv2d_resample(xt.float(), wt.to(BF).float(),
                                              f=port_fir.setup_filter(FILTER), **kw)
    finally:
        port_resample.upfirdn2d = fir
    assert calls == [torch.float32]
    share, of_floor = within(other, ref, ref32)
    assert share > 10 * MAX_SHARE and of_floor > 5 * REL_OF_FLOOR, (share, of_floor)


@pytest.mark.parametrize('kind', ['up', 'down', 'filter'])
def test_upfirdn2d_in_bf16(kind):
    x, _, _ = _conv_case(1, seed=5)
    xj, xt = bf16_array(x)
    f, ft = jax_fir.setup_filter(FILTER), port_fir.setup_filter(FILTER)
    fn = {'up': (jax_fir.upsample2d, port_fir.upsample2d),
          'down': (jax_fir.downsample2d, port_fir.downsample2d),
          'filter': (jax_fir.filter2d, port_fir.filter2d)}[kind]
    ref, ref32, port = fn[0](xj, f), fn[0](jnp.asarray(x), f), fn[1](xt, ft)
    assert port.dtype == BF
    check_within(port, ref, ref32)


def _modconv_case(up, seed=6):
    x, w, wt = _conv_case(3, seed=seed)
    rng = np.random.RandomState(seed + 1)
    styles = (rng.randn(2, 32) + 1.0).astype(np.float32)
    noise = (rng.randn(2, 16 * up, 16 * up, 1) * 0.3).astype(np.float32)
    return x, w, wt, styles, noise


def _modconv(lib, x, w, styles, noise, up, demod):
    kw = dict(up=up, padding=1, demodulate=demod, flip_weight=(up == 1))
    if lib == 'jax':
        f = jax_fir.setup_filter(FILTER) if up > 1 else None
        return jax_modulated_conv2d(x, jnp.asarray(w), jnp.asarray(styles),
                                    noise=jnp.asarray(noise), resample_filter=f, **kw)
    f = port_fir.setup_filter(FILTER) if up > 1 else None
    return port_modconv.modulated_conv2d(x, w, torch.from_numpy(styles),
                                         noise=torch.from_numpy(noise), resample_filter=f, **kw)


@pytest.mark.parametrize('demod', [True, False])
@pytest.mark.parametrize('up', [1, 2])
def test_modulated_conv2d_in_bf16(up, demod):
    """The pre-normalization (with demodulation), the float32 demodulation
    coefficients from the pre-normalized weight and styles, and the casts of
    the styles, the weight, the coefficients and the noise."""
    x, w, wt, styles, noise = _modconv_case(up)
    xj, xt = bf16_array(x)
    ref = _modconv('jax', xj, w, styles, noise, up, demod)
    ref32 = _modconv('jax', jnp.asarray(x), w, styles, noise, up, demod)
    port = _modconv('port', xt, wt, styles, noise, up, demod)
    assert port.dtype == BF
    check_within(port, ref, ref32)


def test_modulated_conv2d_without_the_pre_normalization_misses_the_limit():
    """Mutation witness: the same function without the bf16 pre-normalization
    (the weight and styles unscaled: the same result in exact arithmetic)
    rounds other values."""
    x, w, wt, styles, noise = _modconv_case(1)
    xj, xt = bf16_array(x)
    ref = _modconv('jax', xj, w, styles, noise, 1, True)
    ref32 = _modconv('jax', jnp.asarray(x), w, styles, noise, 1, True)
    skipped = _modconv('port', xt.float(), wt, styles, noise, 1, True)  # float32 skips it ...
    w2 = wt.square().sum(dim=(2, 3))
    dcoefs = torch.rsqrt(torch.from_numpy(styles).square() @ w2.t() + 1e-8)
    x_mod = xt * torch.from_numpy(styles).to(BF)[:, None, None, :]
    y = port_resample.conv2d_resample(x_mod, wt, padding=1)
    y = y * dcoefs.to(BF)[:, None, None, :] + torch.from_numpy(noise).to(BF)  # ... bf16 without
    assert skipped.dtype == torch.float32
    share, of_floor = within(y, ref, ref32)
    assert share > 10 * MAX_SHARE and of_floor > 5 * REL_OF_FLOOR, (share, of_floor)


# ------------------------------------------------------------------ layers

def _load(module, variables):
    load_flat(module, flatten_tree(jax.device_get(variables)))
    return module


@pytest.mark.parametrize('hyper', [False, True])
@pytest.mark.parametrize('k,down,act', [(3, 1, 'lrelu'), (3, 2, 'lrelu'), (1, 2, 'linear')])
def test_conv2d_layer_in_bf16(k, down, act, hyper):
    """The weight scaled by its gain in float32, then cast (the JAX
    package's order); the hyper-modulation factor cast to bf16."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 16, 16, 32).astype(np.float32)
    c = rng.randn(2, 8).astype(np.float32) if hyper else None
    jl = JaxConv2dLayer(32, k, activation=act, down=down, conv_clamp=256.0,
                        use_bias=act != 'linear', hyper_mod=hyper)
    variables = jl.init(jax.random.PRNGKey(k + down), jnp.asarray(x),
                        None if c is None else jnp.asarray(c))
    variables = jax.tree.map(lambda a: a + 0.05 if a.ndim == 1 else a, variables)
    xj, xt = bf16_array(x)
    kw = dict(gain=math.sqrt(0.5))
    cj, ct = (None, None) if c is None else (jnp.asarray(c), torch.from_numpy(c))
    ref = jl.apply(variables, xj, cj, **kw)
    ref32 = jl.apply(variables, jnp.asarray(x), cj, **kw)
    layer = _load(Conv2dLayer(32, 32, k, activation=act, down=down, conv_clamp=256.0,
                              bias=act != 'linear', hyper_mod_dim=8 if hyper else 0), variables)
    with torch.no_grad():
        port = layer(xt, ct, **kw)
    assert port.dtype == BF
    check_within(port, ref, ref32)


def test_conv2d_layer_with_the_cast_before_the_gain_misses_the_limit():
    """Mutation witness: the weight cast to bf16 before the gain (the order
    of `FullyConnected`, not of `Conv2dLayer`) rounds every weight twice."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 16, 16, 32).astype(np.float32)
    jl = JaxConv2dLayer(32, 3, activation='lrelu', conv_clamp=256.0)
    variables = jl.init(jax.random.PRNGKey(3), jnp.asarray(x))
    xj, xt = bf16_array(x)
    ref, ref32 = jl.apply(variables, xj), jl.apply(variables, jnp.asarray(x))
    layer = _load(Conv2dLayer(32, 32, 3, activation='lrelu', conv_clamp=256.0), variables)
    with torch.no_grad():
        w = layer.weight.to(BF) * round_to(layer.weight_gain, BF)
        y = port_resample.conv2d_resample(xt, w, padding=1)
        port = bias_act_plain(y, layer.bias, act='lrelu', clamp=256.0)
    share, of_floor = within(port, ref, ref32)
    assert share > 10 * MAX_SHARE, (share, of_floor)


def test_fully_connected_in_bf16():
    """The weight cast to bf16 first, then scaled by the gain there (a
    weakly typed constant), the product accumulated in float32 and cast
    back: bit for bit here (a product over 64 terms)."""
    rng = np.random.RandomState(8)
    x = rng.randn(16, 64).astype(np.float32)
    jl = JaxFullyConnected(32, activation='lrelu', lr_multiplier=0.5, bias_init=0.3)
    variables = jl.init(jax.random.PRNGKey(0), jnp.asarray(x))
    xj, xt = bf16_array(x)
    ref = jl.apply(variables, xj)
    layer = _load(FullyConnected(64, 32, activation='lrelu', lr_multiplier=0.5, bias_init=0.3),
                  variables)
    with torch.no_grad():
        port = layer(xt)
    assert port.dtype == BF
    assert float(np.mean(ulps(port, ref) > 0)) <= MAX_SHARE
