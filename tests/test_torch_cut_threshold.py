"""The quantile threshold of K3's cut entry and K4's bf16 arithmetic, in the
order of their redesigned kernels, on the CPU.

- `quantile_radix_plain`, the select kernel's passes (`csrc/quantile.cu`)
  walked in PyTorch: order-preserving keys, three digit histograms summed
  over blocks, rank low's and rank high's prefixes. Held bit for bit
  against the sort (`quantile_plain`), a zero of either sign as a zero,
  and against `jnp.quantile` (where XLA:CPU contracts JAX's interpolation
  into an FMA, against that contraction of the same two order statistics):
  the cases of `test_quantile_as_jnp`, all values equal,
  ±0, every value in one top bin, relu's zeros, bf16 values, two sets of
  different sizes clamped as `cut_threshold` clamps them, and 2^22 values
  at q = 0.5.
- The keys: their order is the values' order, `key_values` inverts them.
- The routes: a cut render takes the coarse march's threshold through the
  renderer's `quantile` and both through the sort on CPU tensors, and never
  loads the library; off the CPU (meta tensors standing in for the card),
  the final march's threshold goes to the select with the raw densities and
  the march's clamp, the coarse march's with its clamped densities as they
  are, the result handed to the cut entry, and the sort is never called;
  the plain versions take the sort there and never the select.
- K4's bf16 MLP in the redesigned kernel's order
  (`plain_bf16_as_kernel`: the leaky ReLU as max(h, h alpha), w1 padded to
  8 columns as the kernel pads it in registers) bit for bit against
  `triplane_mlp_plain_bf16`,
  and against JAX's two bf16 `FullyConnected` layers at the limit of
  `test_torch_render_bf16.py`; the max form against `F.leaky_relu` on every
  bf16 value.
Inputs from np.random.RandomState.
"""
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from tdgp_torch.ops import cuda_build
from tdgp_torch.ops import ray_march as rm
from tdgp_torch.ops import triplane_mlp as tm
from tdgp_torch.ops.bias_act import round_to
from tdgp_torch.rendering import renderer

from test_torch_render_bf16 import BF, MLP_SHARE, T, bf16_ulps, mlps  # noqa: F401
from test_torch_ray_march_merged import _sets


def pad_w1_bf16(w1):
    """w1 [HID, OUT] with zero columns up to 8: the one n-tile of K4's bf16
    kernel's second product (its B fragments, built in registers there)."""
    return torch.cat([w1, w1.new_zeros(w1.shape[0], 8 - w1.shape[1])], 1)


def plain_bf16_as_kernel(feats, w0, b0, w1, b1):
    """`triplane_mlp_plain_bf16` in the order of K4's bf16 kernel: the
    first product rounded, the bias added, the leaky ReLU as max(h, h alpha)
    and the gain, each in bf16 (the kernel's bf16-pair instructions, each
    rounded once); the second product against `pad_w1_bf16(w1)`, its first
    OUT outputs rounded and b1 added."""
    alpha, gain = round_to(0.2, feats.dtype), round_to(math.sqrt(2.0), feats.dtype)
    h = (feats.float() @ w0.float()).to(feats.dtype) + b0
    h = torch.maximum(h, h * alpha) * gain
    y = (h.float() @ pad_w1_bf16(w1).float()).to(feats.dtype)[..., :w1.shape[1]] + b1
    return y[..., :-1], y[..., -1]


def _cases():
    rs = np.random.RandomState(7)
    return {'ties': np.round(rs.randn(4, 33, 20), 1), 'odd_size': rs.randn(3, 7, 13),
            'nan': np.where(rs.rand(40) < 0.1, np.nan, rs.randn(40)), 'one_element': rs.randn(1),
            'all_equal': np.full(257, 0.37), 'signed_zeros': np.where(rs.rand(99) < 0.5, 0.0, -0.0),
            'zeros_and_values': np.where(rs.rand(300) < 0.3, 0.0, rs.randn(300)) * np.where(
                rs.rand(300) < 0.5, 1.0, -1.0),
            'one_top_bin': 1.0 + rs.rand(500) * 1e-3,
            'relu_zeros': np.maximum(rs.randn(2000), 0.0),
            'infinities': np.concatenate([[np.inf, -np.inf, np.inf], rs.randn(20)])}


def _assert_same(got, ref):
    """One-element results equal as numbers (NaN as NaN; -0 == +0)."""
    got, ref = np.asarray(got, np.float32).reshape(-1), np.asarray(ref, np.float32).reshape(-1)
    np.testing.assert_array_equal(got, ref)


def _assert_as_jnp(got, x, q):
    """`got` against `jnp.quantile(x, q)`: the same number, or where XLA:CPU
    contracts JAX's lo w_low + hi w_high into an FMA (it does for some
    inputs; the port rounds both products, as JAX's jaxpr reads), the
    contraction of the same two order statistics, rounded once."""
    ref = float(jnp.quantile(jnp.asarray(x), q))
    value = float(np.asarray(got, np.float32).reshape(-1)[0])
    if value == ref or (np.isnan(value) and np.isnan(ref)):
        return
    ordered = np.sort(x.reshape(-1).astype(np.float32))
    pos = np.float32(q) * (np.float32(ordered.size) - np.float32(1))
    wh = np.float32(pos - np.floor(pos))
    lo, hi = (np.float64(ordered[int(i)]) for i in (np.floor(pos), np.ceil(pos)))
    contracted = {float(np.float32(a * np.float64(wa) + np.float64(np.float32(b * np.float64(wb)))))
                  for a, wa, b, wb in ((lo, np.float32(1) - wh, hi, wh),
                                       (hi, wh, lo, np.float32(1) - wh))}
    assert ref in contracted, (value, ref, contracted)


@pytest.mark.parametrize('case', list(_cases()))
@pytest.mark.parametrize('q', [0.0, 0.25, 0.5, 0.9, 1.0])
def test_radix_select_as_jnp_and_the_sort(case, q):
    x = _cases()[case].astype(np.float32)
    got = rm.quantile_radix_plain(torch.from_numpy(x), q)
    assert got.shape == (1,) and got.dtype == torch.float32
    _assert_same(got, rm.quantile_plain(torch.from_numpy(x), q))
    _assert_as_jnp(got, x, q)


@pytest.mark.parametrize('case', ['ties', 'nan', 'signed_zeros', 'one_top_bin', 'relu_zeros'])
@pytest.mark.parametrize('q', [0.25, 0.5, 1.0])
def test_radix_select_of_bf16_as_jnp_and_the_sort(case, q):
    x = jnp.asarray(_cases()[case].astype(np.float32)).astype(jnp.bfloat16)
    got = rm.quantile_radix_plain(T(x), q)
    assert got.dtype == BF
    assert torch.equal(got, rm.quantile_plain(T(x), q)) or bool(torch.isnan(got).all())
    _assert_same(got.float(), np.asarray(jnp.quantile(x, q).astype(jnp.float32)))


@pytest.mark.parametrize('blocks', [1, 3, 264])
@pytest.mark.parametrize('clamp_mode', ['softplus', 'relu'])
def test_radix_select_over_two_sets_as_cut_threshold(blocks, clamp_mode):
    rs = np.random.RandomState(5)
    x1 = torch.from_numpy((rs.randn(2, 16, 32) * 2).astype(np.float32))
    x2 = torch.from_numpy((rs.randn(2, 16, 7) * 2).astype(np.float32))
    clamped = torch.cat([rm.clamp_densities(x, clamp_mode).reshape(-1) for x in (x1, x2)])
    for q in (0.25, 0.5, 1.0):
        got = rm.quantile_radix_plain(clamped, q, blocks=blocks)
        _assert_same(got, rm.cut_threshold_plain(x1, x2, q, clamp_mode))
        _assert_same(got, rm.cut_threshold(x1, x2, q, clamp_mode))  # CPU tensors: the sort
        _assert_as_jnp(got, clamped.numpy(), q)


def test_radix_select_of_a_served_chunk_size():
    x = np.random.RandomState(2).randn(2 ** 22).astype(np.float32)
    got = rm.quantile_radix_plain(torch.from_numpy(x), 0.5)
    _assert_same(got, rm.quantile_plain(torch.from_numpy(x), 0.5))
    _assert_as_jnp(got, x, 0.5)


def test_keys_keep_the_order_and_come_back():
    rs = np.random.RandomState(9)
    x = np.concatenate([rs.randn(1000) * 10.0 ** rs.randint(-30, 30, 1000),
                        [0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45]]).astype(np.float32)
    keys = rm.quantile_keys(torch.from_numpy(x))
    assert int(keys.min()) >= 0 and int(keys.max()) < 2 ** 32
    order = np.lexsort((~np.signbit(x), x))  # -0 before +0: different keys
    assert (np.diff(keys.numpy()[order]) >= 0).all()
    back = rm.key_values(keys).numpy()
    assert np.array_equal(back.view(np.int32), x.view(np.int32))
    assert int(rm.quantile_keys(torch.tensor([-0.0]))) < int(rm.quantile_keys(torch.tensor([0.0])))


def test_a_cut_render_takes_both_thresholds_by_quantile(monkeypatch):
    """The coarse march's threshold by the renderer's `quantile` (the select
    on the card), the sort under it on CPU tensors; the final march's by the
    sort of its plain version."""
    calls, sorts = [], []
    real, real_sort = renderer.quantile, rm.quantile_plain

    def spy(x, q):
        calls.append((tuple(x.shape), q))
        return real(x, q)

    def sort_spy(x, q):
        sorts.append((tuple(x.shape), q))
        return real_sort(x, q)

    monkeypatch.setattr(renderer, 'quantile', spy)
    monkeypatch.setattr(rm, 'quantile_plain', sort_spy)
    monkeypatch.setattr(cuda_build, 'library', lambda *a: pytest.fail('kernel library loaded'))
    rs = np.random.RandomState(4)
    lin = torch.from_numpy(rs.randn(3, 4).astype(np.float32))

    def run_model(coords):
        out = coords @ lin
        return torch.sigmoid(out[..., :3]), out[..., 3] * 3

    origins = torch.zeros(2, 10, 3)
    dirs = F.normalize(torch.from_numpy(rs.randn(2, 10, 3).astype(np.float32)), dim=-1)
    opts = renderer.RenderOptions(num_proposal_steps=8, num_fine_steps=8, cut_quantile=0.5)
    with torch.no_grad():
        renderer.importance_render(run_model, origins, dirs, opts)
    assert calls == [((2, 10, 8), 0.5)]  # the coarse march
    assert sorts == [((2, 10, 8), 0.5), ((2, 10, 16), 0.5)]  # the coarse march, the final one
    calls.clear()
    sorts.clear()
    with torch.no_grad():
        renderer.importance_render(run_model, origins, dirs, renderer.RenderOptions(
            num_proposal_steps=8, num_fine_steps=8))
    assert calls == [] and sorts == []


def test_off_the_cpu_the_thresholds_go_to_the_select(monkeypatch):
    selects, launches = [], []

    def select(values, q, clamp_mode, sp_beta, out_dtype, keys_out=False):
        selects.append((values, q, clamp_mode, out_dtype))
        return torch.empty(1, dtype=out_dtype, device='meta')

    def launch(what, sets, threshold, *opts):
        launches.append((what, threshold))
        b, r = sets[0].shape[:2]
        return (torch.empty(b, r, sets[1].shape[3], device='meta'),
                *(torch.empty(b, r, device='meta') for _ in range(3)))

    monkeypatch.setattr(rm, '_select', select)
    monkeypatch.setattr(rm, '_launch_merged', launch)
    monkeypatch.setattr(rm, 'quantile_plain', lambda *a: pytest.fail('the sort was called'))
    monkeypatch.setattr(cuda_build, 'library', lambda *a: pytest.fail('kernel library loaded'))
    sets = [torch.from_numpy(a).to('meta') for a in _sets(1, 8, 8)]
    for bf16 in (False, True):
        s = [t.to(BF) if bf16 and i in (1, 2, 4, 5) else t for i, t in enumerate(sets)]
        selects.clear()
        launches.clear()
        rm.ray_march_merged_cut(*s, 0.25, 'relu')
        (values, q, clamp_mode, out_dtype), = selects
        assert values[0] is s[2] and values[1] is s[5]  # the raw densities, no copy
        assert (q, clamp_mode, out_dtype) == (0.25, 'relu', torch.float32)
        assert launches == [('ray_march_merged_cut_bf16' if bf16 else 'ray_march_merged_cut',
                             launches[0][1])] and launches[0][1].dtype == torch.float32
    for dtype in (torch.float32, BF):
        selects.clear()
        clamped = torch.empty(2, 16, 8, dtype=dtype, device='meta')
        out = rm.cut_below_quantile(clamped, 0.5, rm.quantile)
        (values, q, clamp_mode, out_dtype), = selects
        assert values[0] is clamped and clamp_mode is None and out_dtype == dtype
        assert out.shape == clamped.shape and out.dtype == dtype
        selects.clear()  # the renderer's coarse march hands `quantile` to the plain march
        colors, densities = (torch.empty(2, 16, 8, *c, dtype=dtype, device='meta')
                             for c in ((3,), ()))
        depths = torch.empty(2, 16, 8, device='meta')
        renderer.classical_ray_march(colors, densities, depths,
                                     renderer.RenderOptions(cut_quantile=0.5))
        (values, q, clamp_mode, out_dtype), = selects
        assert values[0].shape == densities.shape and clamp_mode is None and out_dtype == dtype
    monkeypatch.undo()
    with pytest.raises(ValueError, match='CUDA or CPU'):
        rm.quantile(torch.empty(5, device='meta'), 0.5)


@pytest.mark.parametrize('bf16', [False, True])
def test_plain_versions_take_the_sort_on_any_device(monkeypatch, bf16):
    """The plain versions of both marches never reach the select: off the
    CPU too (meta tensors standing in for the card), their thresholds are
    the sort's, so a card check that holds the kernels against them does not
    hold the select against itself."""
    sorts = []

    def sort(x, q):
        sorts.append(tuple(x.shape))
        return torch.empty(1, dtype=x.dtype, device=x.device)

    monkeypatch.setattr(rm, '_select', lambda *a, **k: pytest.fail('the select was called'))
    monkeypatch.setattr(rm, 'quantile_plain', sort)
    monkeypatch.setattr(cuda_build, 'library', lambda *a: pytest.fail('kernel library loaded'))
    sets = [torch.from_numpy(a).to('meta') for a in _sets(1, 8, 8)]
    sets = [t.to(BF) if bf16 and i in (1, 2, 4, 5) else t for i, t in enumerate(sets)]
    rm.ray_march_merged_cut_plain(*sets, 0.5)
    rm.cut_threshold_plain(sets[2], sets[5], 0.5)
    densities = sets[2]
    rm.classical_ray_march_plain(sets[1], densities, sets[0], cut_quantile=0.5)
    rm.cut_below_quantile(rm.clamp_densities(densities), 0.5)
    b, r, s1 = densities.shape
    merged, n = (b, r, s1 + sets[5].shape[-1]), densities.numel() + sets[5].numel()
    assert sorts == [merged, (n,), (b, r, s1), (b, r, s1)]


def test_mlp_bf16_in_the_kernels_order(mlps):
    port, x, ref = mlps
    w16 = (*tm.fold_fully_connected(port.fc0, BF), *tm.fold_fully_connected(port.fc1, BF))
    padded = pad_w1_bf16(w16[2])
    assert padded.shape == (64, 8) and torch.equal(padded[:, :4], w16[2])
    assert not padded[:, 4:].any()
    with torch.no_grad():
        got = plain_bf16_as_kernel(T(x), *w16)
        plain = tm.triplane_mlp_plain_bf16(T(x), *w16)
    for a, b in zip(got, plain):
        assert a.dtype == BF and torch.equal(a.view(torch.int16), b.view(torch.int16))
    ulps = np.concatenate([bf16_ulps(g, r).ravel() for g, r in zip(got, ref)])
    assert ulps.max() <= 1 and np.mean(ulps > 0) <= MLP_SHARE, (ulps.max(), np.mean(ulps > 0))


def test_leaky_relu_as_a_max_on_every_bf16_value():
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16)
    h = bits.view(BF)
    h = h[~torch.isnan(h)]
    alpha = round_to(0.2, BF)
    as_max = torch.maximum(h, h * alpha)
    for ref in (F.leaky_relu(h, alpha), torch.where(h >= 0, h, h * alpha)):
        assert torch.equal(as_max.view(torch.int16), ref.view(torch.int16))
