"""The bf16 render views' forward and the kernel entries they run: port
(tdgp_torch) vs JAX package (tdgp), under `generator.render_bf16`.

The JAX package renders from bf16 planes: the jnp gather (`grid_sample_2d`)
sums four bf16 corners in float32 and rounds once per plane, `jnp.mean`
averages the three planes in float32 and rounds once, the MLP runs as two
bf16 `FullyConnected` layers, the eval coarse march takes softplus in bf16,
and the merge promotes the bf16 colours and densities to float32 for the
final march. The port rounds at the same points; these tests hold each
entry's plain version (what the wrappers compute on CPU tensors, and what
`chip_smoke.py` holds the CUDA kernels against on the card) against the JAX
function on the same inputs:

  - K4's bf16 entry (`triplane_mlp_plain_bf16`, through `TriPlaneMLP`) vs
    JAX's `TriPlaneMLP` on bf16 input: at most one bf16 ulp, a share of
    MLP_SHARE one ulp apart (3.1e-5 measured: the float32 sums of the
    products in another order). Mutation witnesses: the hidden layer not
    rounded to bf16; the weight gain applied in float32 before the cast.
  - The gather on bf16 planes (`tri_plane_sample`) vs JAX's, eager and
    jitted: bit for bit eager, GATHER_SHARE one ulp apart jitted (1.25e-4).
  - K3's merged and cut entries with bf16 loads: their plain versions vs
    `unify_samples_sorted` + `classical_ray_march` and + `ray_march_pallas`
    interpreted, on bf16 colours and bf16 or float32 densities, <= 1e-5.
  - The bf16 softplus of the eval coarse march and the quantile of bf16
    values, bit for bit.
  - K1's bf16 entry (`triplane_sample_bwd_plain_bf16`) vs the TPU route
    `triplane_sample_fused(planes16, coords, scale, True, 'quad')`: the
    coordinate gradient <= 1e-5, the bf16 plane gradient at most one ulp
    and a share K1_SHARE apart (5e-6 measured). Beside it JAX's CPU jnp
    route, whose plane gradient's scatter-add sums in bf16: 0.71 of the
    bf16 floor from the TPU route (`test_jnp_route_gap`). Witness: the
    splat summed in bf16 misses. A render's two passes
    (`TriplaneSamplePair`) against the sum of JAX's Pallas splat of each
    pass, rounded once (`merged_splat`): at most one ulp apart; rounding
    each pass (two `triplane_sample` calls) misses.
  - The served image: the port's `Generator` with `render_bf16` (eval,
    const noise) vs JAX's, at the float32 blocks and at the tiny config's
    bf16 blocks, as a share of the floor (JAX with `render_bf16` vs JAX
    without, the blocks as they are). Witnesses: planes left float32; the
    coarse march's softplus in float32; the MLP's last bias add left
    unrounded (XLA rounds it here: the port without it reads 0.18 of the
    floor against 0.046 with it). And JAX's own loose bound against the
    float32 render (`tests/test_models.py:293`).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp
from flax import traverse_util
from jax.experimental.pallas import tpu as pltpu

from tdgp import serving as jax_serving
from tdgp.config import replace as jax_replace
from tdgp.config import tiny_test_config as jax_tiny
from tdgp.models.epigraf import Generator as JaxGenerator
from tdgp.models.epigraf import TriPlaneMLP as JaxTriPlaneMLP
from tdgp.models.epigraf import tri_plane_sample as jax_tri_plane_sample
from tdgp.ops.pallas_kernels import ray_march_pallas
from tdgp.ops.splat import triplane_sample_fused, triplane_splat as jax_triplane_splat
from tdgp.rendering import renderer as jax_renderer
from tdgp.utils.tensor_group import TensorGroup as JaxTensorGroup

from tdgp_torch import serving
from tdgp_torch.config import tiny_test_config
from tdgp_torch.models.epigraf import Generator, TriPlaneMLP
from tdgp_torch.ops import bias_act as port_bias_act
from tdgp_torch.ops import ray_march as rm
from tdgp_torch.ops import splat as sp
from tdgp_torch.ops import triplane_mlp as tm
from tdgp_torch.weights import load_flat

BF = torch.bfloat16
MLP_SHARE = 1e-3       # K4 bf16: share of outputs one ulp from JAX's
GATHER_SHARE = 1e-3    # the bf16 gather jitted: share one ulp from JAX's
K1_SHARE = 1e-4        # K1 bf16: share of plane-gradient texels one ulp from the TPU route's
IMAGE_OF_FLOOR = 0.07  # the served image, float32 blocks (witness 0.046)
IMAGE_BF16_BLOCKS_OF_FLOOR = 1.0  # with the bf16 blocks (witness 0.82: their flips)
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


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def T(a):
    """A JAX or numpy array -> torch, bf16 arrays as bf16 tensors."""
    a = jnp.asarray(a)
    t = torch.from_numpy(np.array(a.astype(jnp.float32)))
    return t.to(BF) if a.dtype == jnp.bfloat16 else t


def rel_l2(a, b):
    a, b = f32(a).astype(np.float64), f32(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def bf16_ulps(a, b):
    """Distance in bf16 ulps of each element of two arrays of bf16 values."""
    def ordered(x):
        bits = f32(x).view(np.uint32) >> 16
        return np.where(bits & 0x8000, -(bits & 0x7FFF).astype(np.int64), bits.astype(np.int64))
    return np.abs(ordered(a) - ordered(b))


# ------------------------------------------------------------------ K4's bf16 entry

@pytest.fixture(scope='module')
def mlps():
    """The JAX and port TriPlaneMLP under render_bf16 at the flagship widths
    (F 32, HID 64, OUT 4), biases moved off zero; bf16 features."""
    cfg = jax_tiny().generator
    tri = dataclasses.replace(cfg.tri_plane, feat_dim=32,
                              mlp=dataclasses.replace(cfg.tri_plane.mlp, hid_dim=64))
    jax_mlp = JaxTriPlaneMLP(jax_replace(cfg, tri_plane=tri, render_bf16=True), out_dim=3)
    variables = jax_mlp.init(jax.random.PRNGKey(7), jnp.zeros((1, 4, 32), jnp.bfloat16))
    rs = np.random.RandomState(3)
    variables = jax.tree.map(
        lambda a: a + 0.1 * rs.randn(*a.shape).astype(np.float32) if a.ndim == 1 else a,
        variables)
    pc = tiny_test_config().generator
    ptri = dataclasses.replace(pc.tri_plane, feat_dim=32,
                               mlp=dataclasses.replace(pc.tri_plane.mlp, hid_dim=64))
    port = TriPlaneMLP(dataclasses.replace(pc, tri_plane=ptri, render_bf16=True), out_dim=3)
    load_flat(port, {'/'.join(k): np.asarray(v) for k, v in
                     traverse_util.flatten_dict(jax.device_get(variables)).items()})
    x = jnp.asarray(np.random.RandomState(11).randn(4, 2000, 32).astype(np.float32))
    x = x.astype(jnp.bfloat16)
    ref = jax.jit(jax_mlp.apply)(variables, x)
    return port.eval(), x, ref


def _mlp_ulps(port, x, ref):
    before = tm.triplane_mlp_bf16.launches
    with torch.no_grad():
        got = port(T(x))
    assert tm.triplane_mlp_bf16.launches == before  # CPU tensors: the plain version
    assert all(t.dtype == BF for t in got)
    return np.concatenate([bf16_ulps(g, r).ravel() for g, r in zip(got, ref)])


def test_mlp_bf16_entry_matches_jax(mlps):
    port, x, ref = mlps
    ulps = _mlp_ulps(port, x, ref)
    assert ulps.max() <= 1 and np.mean(ulps > 0) <= MLP_SHARE, (ulps.max(), np.mean(ulps > 0))


def test_mlp_bf16_layers_match_the_entry(mlps):
    """Where autograd records, the same MLP runs as its bf16 FullyConnected
    layers: at most one ulp from K4's bf16 entry (their products summed in
    another order)."""
    port, x, ref = mlps
    with torch.no_grad():
        entry = port(T(x))
    layers = port(T(x).requires_grad_(True))
    for a, b in zip(entry, layers):
        assert b.requires_grad and b.dtype == BF
        assert bf16_ulps(a, b).max() <= 1


def _hidden_unrounded(feats, w0, b0, w1, b1):
    h = port_bias_act.bias_act_plain(feats.float() @ w0.float(), b0.float(), act='lrelu')
    y = (h @ w1.float()).to(feats.dtype) + b1
    return y[..., :-1], y[..., -1]


@pytest.mark.parametrize('mutant', ['hidden not rounded', 'gain in float32'])
def test_mlp_bf16_mutants_miss_the_limit(mlps, mutant, monkeypatch):
    port, x, ref = mlps
    if mutant == 'hidden not rounded':
        monkeypatch.setattr(tm, 'triplane_mlp_plain_bf16', _hidden_unrounded)
    else:
        from tdgp_torch.models import epigraf
        orig = tm.fold_fully_connected

        def fold(fc, dtype=torch.float32):
            if dtype == torch.float32:
                return orig(fc, dtype)
            return (fc.weight * fc.weight_gain).to(dtype).t(), (fc.bias * fc.lr_multiplier).to(dtype)
        monkeypatch.setattr(epigraf, 'fold_fully_connected', fold)
    ulps = _mlp_ulps(port, x, ref)
    assert np.mean(ulps > 0) > 10 * MLP_SHARE, np.mean(ulps > 0)


def test_mlp_wrapper_dispatches_bf16_and_refuses_off_the_cpu(mlps):
    port = mlps[0]
    w16 = (*tm.fold_fully_connected(port.fc0, BF), *tm.fold_fully_connected(port.fc1, BF))
    assert all(w.dtype == BF for w in w16)
    x = torch.randn(1, 5, 32).to(BF)
    for a, b in zip(tm.triplane_mlp(x, *w16), tm.triplane_mlp_plain_bf16(x, *w16)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match='CUDA or CPU'):
        tm.triplane_mlp(x.to('meta'), *(w.to('meta') for w in w16))


# ------------------------------------------------------------------ the gather

@pytest.fixture(scope='module')
def gather_inputs():
    rng = np.random.RandomState(1)
    planes = jnp.asarray(rng.randn(6, 16, 16, 8).astype(np.float32)).astype(jnp.bfloat16)
    coords = jnp.asarray(rng.uniform(-0.55, 0.55, (2, 500, 3)).astype(np.float32))
    return planes, coords


@pytest.mark.parametrize('jit', [False, True], ids=['eager', 'jit'])
def test_gather_on_bf16_planes_matches_jax(gather_inputs, jit):
    planes, coords = gather_inputs
    fn = lambda p, c: jax_tri_plane_sample(p, c, SCALE)  # noqa: E731
    ref = (jax.jit(fn) if jit else fn)(planes, coords)
    got = sp.tri_plane_sample(T(planes), T(coords), SCALE)
    assert ref.dtype == jnp.bfloat16 and got.dtype == BF
    ulps = bf16_ulps(got, ref)
    if jit:
        assert ulps.max() <= 1 and np.mean(ulps > 0) <= GATHER_SHARE, np.mean(ulps > 0)
    else:
        assert ulps.max() == 0
    widened = sp.tri_plane_sample(T(planes).float(), T(coords), SCALE, out_dtype=BF)
    assert torch.equal(widened, got)


# ------------------------------------------------------------------ K3, bf16 loads

def _sets(seed, b, r, s1, s2, c, densities_bf16=True):
    rng = np.random.RandomState(seed)
    t1 = np.sort(rng.uniform(0.75, 1.25, (b, r, s1)), -1).astype(np.float32)
    t2 = rng.uniform(0.75, 1.25, (b, r, s2)).astype(np.float32)
    tie = rng.rand(b, r, s2) < 0.25
    t2 = np.sort(np.where(tie, t1[..., :1].repeat(s2, -1), t2), -1).astype(np.float32)
    cols = [jnp.asarray(rng.randn(b, r, s, c).astype(np.float32)).astype(jnp.bfloat16)
            for s in (s1, s2)]
    dens = [jnp.asarray(rng.randn(b, r, s).astype(np.float32) * 2) for s in (s1, s2)]
    if densities_bf16:
        dens = [d.astype(jnp.bfloat16) for d in dens]
    return (jnp.asarray(t1), cols[0], dens[0], jnp.asarray(t2), cols[1], dens[1])


K3_CASES = [('softplus', True, False), ('softplus', False, True), ('relu', True, False)]


@pytest.mark.parametrize('densities_bf16', [True, False], ids=['bf16', 'float32-densities'])
@pytest.mark.parametrize('case', K3_CASES, ids=lambda c: '-'.join(map(str, c)))
def test_merged_bf16_loads_match_jax(densities_bf16, case):
    clamp_mode, inf_depth, last_back = case
    sets = _sets(3, 2, 37, 32, 32, 3, densities_bf16)
    depths, colors, densities = jax_renderer.unify_samples_sorted(*sets)
    assert colors.dtype == densities.dtype == jnp.float32  # JAX's merge promotes
    opts = jax_renderer.RenderOptions(clamp_mode=clamp_mode, use_inf_depth=inf_depth,
                                      last_back=last_back)
    rgb, depth, weights, ftrans = jax_renderer.classical_ray_march(colors, densities, depths,
                                                                    opts)
    classical = (rgb, depth, weights.sum(-1), ftrans)
    with pltpu.force_tpu_interpret_mode():  # on bf16 inputs, which it casts on entry
        pallas = ray_march_pallas(colors.astype(jnp.bfloat16),
                                  densities.astype(sets[2].dtype), depths,
                                  clamp_mode=clamp_mode, use_inf_depth=inf_depth,
                                  last_back=last_back)
    before = rm.ray_march_merged_bf16.launches
    got = rm.ray_march_merged(*map(T, sets), clamp_mode, 1.0, inf_depth, last_back)
    assert rm.ray_march_merged_bf16.launches == before
    for ref in (classical, pallas):
        for a, b in zip(got, ref):
            np.testing.assert_allclose(f32(a), f32(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('q', [0.25, 0.5])
def test_merged_cut_bf16_loads_match_jax(q):
    sets = _sets(4, 2, 37, 32, 32, 3)
    depths, colors, densities = jax_renderer.unify_samples_sorted(*sets)
    rgb, depth, weights, ftrans = jax_renderer.classical_ray_march(
        colors, densities, depths, jax_renderer.RenderOptions(cut_quantile=q))
    got = rm.ray_march_merged_cut(*map(T, sets), q)
    for a, b in zip(got, (rgb, depth, weights.sum(-1), ftrans)):
        np.testing.assert_allclose(f32(a), f32(b), rtol=1e-5, atol=1e-5)
    # the threshold over the widened clamped densities, as JAX's float32 march
    # takes it (within a float32 ulp: the two frameworks' float32 softplus)
    clamped = jax.nn.softplus(densities)
    np.testing.assert_allclose(float(rm.cut_threshold(T(sets[2]), T(sets[5]), q)),
                               float(jnp.quantile(clamped, q)), rtol=2 ** -23)


def test_merged_wrappers_take_bf16_and_refuse_mixed_dtypes():
    sets = tuple(map(T, _sets(5, 1, 4, 3, 3, 3)))
    with pytest.raises(TypeError, match='bf16 colours'):
        rm.ray_march_merged(sets[0], sets[1].float(), sets[2], *sets[3:])
    with pytest.raises(ValueError, match='CUDA or CPU'):
        rm.ray_march_merged(*(t.to('meta') for t in sets))
    merged = rm.unify_samples_sorted(*sets)
    assert all(t.dtype == torch.float32 for t in merged)


def test_bf16_softplus_and_quantile_round_as_jax():
    """The eval coarse march's clamp on bf16 densities (JAX's `softplus`, a
    chain of bf16 operations) and `jnp.quantile` of bf16 values (float32
    interpolation, one rounding): bit for bit."""
    x = jnp.asarray(np.random.RandomState(6).randn(4000).astype(np.float32) * 6)
    x = x.astype(jnp.bfloat16)
    ref = jax.jit(jax.nn.softplus)(x)
    got = rm.clamp_densities(T(x))
    assert got.dtype == BF and np.array_equal(f32(got), f32(ref))
    eager = jax.nn.softplus(x)
    assert np.array_equal(f32(got), f32(eager))
    for q in (0.1, 0.5, 0.73):
        assert float(rm.quantile(T(x), q)) == float(jnp.quantile(x, q))


# ------------------------------------------------------------------ K1's bf16 entry

@pytest.fixture(scope='module')
def splat_inputs():
    """bf16 planes [6, 32, 128, 8] (a width the Pallas splat's tiling takes),
    coords of two passes [2, 400, 3] and their bf16 cotangents."""
    rng = np.random.RandomState(7)
    planes = jnp.asarray(rng.randn(6, 32, 128, 8).astype(np.float32)).astype(jnp.bfloat16)
    coords = [jnp.asarray(rng.uniform(-0.55, 0.55, (2, 400, 3)).astype(np.float32))
              for _ in range(2)]
    cots = [jnp.asarray(rng.randn(2, 400, 8).astype(np.float32)).astype(jnp.bfloat16)
            for _ in range(2)]
    return planes, coords, cots


def _fused(planes, coords, cot):
    _, vjp = jax.vjp(lambda p, c: triplane_sample_fused(p, c, SCALE, True, 'quad'), planes,
                     coords)
    return vjp(cot)


def _jnp_route(planes, coords, cot):
    _, vjp = jax.vjp(lambda p, c: jax_tri_plane_sample(p, c, SCALE), planes, coords)
    return vjp(cot)


def _float32_truth(planes, coords, cot):
    return _jnp_route(planes.astype(jnp.float32), coords, cot.astype(jnp.float32))


def test_splat_bf16_matches_the_tpu_route(splat_inputs):
    planes, (coords, _), (cot, _) = splat_inputs
    gp_ref, gc_ref = _fused(planes, coords, cot)
    assert gp_ref.dtype == jnp.bfloat16
    before = sp.triplane_splat_bf16.launches
    gp, gc = sp.triplane_splat(T(planes), T(coords), T(cot), SCALE)
    assert sp.triplane_splat_bf16.launches == before
    assert gp.dtype == BF and gc.dtype == torch.float32
    ulps = bf16_ulps(gp, gp_ref)
    assert ulps.max() <= 1 and np.mean(ulps > 0) <= K1_SHARE, np.mean(ulps > 0)
    np.testing.assert_allclose(f32(gc), f32(gc_ref), rtol=1e-5,
                               atol=1e-5 * float(np.abs(f32(gc_ref)).max()))


def test_jnp_route_gap(splat_inputs):
    """JAX's CPU route (the transpose of its gather, a bf16 scatter-add) is
    0.71 of the bf16 floor (the TPU route against float32) from the TPU
    route in the plane gradient: the gap that the step-level holds inherit
    from JAX's CPU step. The port, which sums in float32 as the TPU route
    does, is 0.004 of it."""
    planes, (coords, _), (cot, _) = splat_inputs
    gp_tpu, _ = _fused(planes, coords, cot)
    gp_jnp, _ = _jnp_route(planes, coords, cot)
    floor = rel_l2(gp_tpu, _float32_truth(planes, coords, cot)[0])
    port, _ = sp.triplane_sample_bwd_plain_bf16(T(planes), T(coords), T(cot), SCALE)
    jnp_gap, port_gap = rel_l2(gp_jnp, gp_tpu) / floor, rel_l2(port, gp_tpu) / floor
    assert 0.5 < jnp_gap < 0.9 and port_gap < 0.05, (jnp_gap, port_gap)


def test_splat_summed_in_bf16_misses(splat_inputs, monkeypatch):
    """Mutation witness: the splat's sum taken in bf16 (each weighted row
    rounded, then added into a bf16 plane gradient, as JAX's jnp route
    does) is far from the TPU route."""
    planes, (coords, _), (cot, _) = splat_inputs
    gp_ref, _ = _fused(planes, coords, cot)

    def summed_in_bf16(g_pts, coords_, scale, n3, h, w):
        f = g_pts.shape[-1]
        y0, x0, tx, ty, masks = sp._corners(coords_, scale, h, w)
        weights = ((1 - tx) * (1 - ty), tx * (1 - ty), (1 - tx) * ty, tx * ty)
        flat = torch.zeros((n3 * h * w, f), dtype=BF)
        for idx, wt, m in zip(sp._corner_index(y0, x0, h, w), weights, masks):
            flat.index_add_(0, idx.reshape(-1), ((wt * m)[..., None] * g_pts).reshape(-1, f).to(BF))
        return flat.reshape(n3, h, w, f).float()

    monkeypatch.setattr(sp, 'triplane_splat_plain', summed_in_bf16)
    gp, _ = sp.triplane_sample_bwd_plain_bf16(T(planes), T(coords), T(cot), SCALE)
    assert np.mean(bf16_ulps(gp, gp_ref) > 0) > 100 * K1_SHARE


def _merged_reference(planes, coords, cots):
    """The TPU route's merged coarse + fine plane gradient: JAX's Pallas
    splat (interpreted) of each pass's rows g / 3 (rounded to bf16), summed
    in float32 and rounded once."""
    n3, h, w, f = planes.shape
    total = 0.0
    for c, g in zip(coords, cots):
        gp = jnp.broadcast_to((g / 3.0)[:, None], (2, 3, 400, f)).reshape(n3, 400, f)
        total = total + jax_triplane_splat(gp.astype(jnp.float32), c, SCALE, n3, h, w,
                                           interpret=True)
    return total.astype(jnp.bfloat16)


def _pair_grads(planes, coords, cots, paired):
    pl = T(planes).requires_grad_(True)
    cs = [T(c).requires_grad_(True) for c in coords]
    if paired:
        pair = sp.TriplaneSamplePair(SCALE, plain=True)
        outs = [pair(pl, c) for c in cs]
    else:
        outs = [sp.triplane_sample(pl, c, SCALE) for c in cs]
    torch.autograd.backward(outs, [T(g) for g in cots])
    return pl.grad, [c.grad for c in cs]


def test_two_passes_round_the_plane_gradient_once(splat_inputs):
    planes, coords, cots = splat_inputs
    ref = _merged_reference(planes, coords, cots)
    gp, gcs = _pair_grads(planes, coords, cots, paired=True)
    assert gp.dtype == BF
    ulps = bf16_ulps(gp, ref)
    assert ulps.max() <= 1 and np.mean(ulps > 0) <= K1_SHARE, np.mean(ulps > 0)
    for c, g, gc in zip(coords, cots, gcs):  # each pass's own coordinate gradient
        np.testing.assert_allclose(f32(gc), f32(_fused(planes, c, g)[1]), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(f32(gc)).max()))


def test_rounding_each_pass_misses(splat_inputs):
    """Mutation witness: two `triplane_sample` calls, each pass's gradient
    rounded to bf16 and the two added in bf16 by autograd."""
    planes, coords, cots = splat_inputs
    gp, _ = _pair_grads(planes, coords, cots, paired=False)
    assert np.mean(bf16_ulps(gp, _merged_reference(planes, coords, cots)) > 0) > 100 * K1_SHARE


# ------------------------------------------------------------------ the served image

def _request(seed, n, z_dim, c_dim):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, z_dim).astype(np.float32),
            np.eye(c_dim, dtype=np.float32)[np.arange(n) % c_dim],
            np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(1.3, 1.8, n),
                      np.zeros(n)], 1).astype(np.float32),
            rng.uniform(15, 30, n).astype(np.float32), np.ones(n, np.float32),
            np.stack([rng.uniform(-3, 3, n), rng.uniform(0, 3, n),
                      rng.uniform(0, 0.1, n)], 1).astype(np.float32)]


@functools.lru_cache(maxsize=None)
def _served(fp32_only):
    """(the port's Generators with and without render_bf16, the request, JAX's
    image with render_bf16, JAX's without), the decoder's blocks float32
    (`fp32_only`) or at the tiny config's bf16."""
    gc = jax_replace(jax_tiny().generator, fp32_only=fp32_only, ray_march_impl='fused')
    req = _request(0, 2, gc.z_dim, gc.c_dim)
    z, c, angles, fov, radius, look_at = map(jnp.asarray, req)
    cam = JaxTensorGroup(angles=angles, fov=fov, radius=radius, look_at=look_at)
    rngs = {k: jax.random.PRNGKey(i + 1)
            for i, k in enumerate(('params', 'noise', 'render', 'depth', 'dropout'))}

    def init_fwd(g):
        g.synthesis.apply_camera_adaptor(cam, z, c)
        return g(z, c, cam, camera_angles_cond=angles, resolution=8)

    g_vars = jax.jit(lambda r: JaxGenerator(gc).init(r, method=init_fwd))(rngs)
    g_vars = jax.tree_util.tree_map_with_path(  # noise strengths and biases off zero
        lambda path, a: jnp.full_like(a, 0.3) if 'noise_strength' in str(path[-1])
        else (a + 0.05 if 'bias' in str(path[-1]) else a), g_vars)
    with pltpu.force_tpu_interpret_mode():
        ref, ref32 = (np.asarray(jax.jit(jax_serving.make_serving_fn(
            JaxGenerator(jax_replace(gc, render_bf16=rb)), g_vars, truncation_psi=0.7))(
            *map(jnp.asarray, req))) for rb in (True, False))
    flat = {'/'.join(k): np.asarray(v)
            for k, v in traverse_util.flatten_dict(jax.device_get(g_vars)).items()}
    ports = []
    for render_bf16 in (True, False):
        port = Generator(dataclasses.replace(tiny_test_config().generator, fp32_only=fp32_only,
                                             render_bf16=render_bf16))
        load_flat(port, flat)
        ports.append(port.eval())
    return (*ports, req, ref, ref32)


def _ratio(port, req, ref, ref32):
    image = serving.make_serving_fn(port, truncation_psi=0.7)(*req)
    return rel_l2(image, ref) / rel_l2(ref, ref32), image


@pytest.mark.parametrize('fp32_only', [True, False], ids=['float32-blocks', 'bf16-blocks'])
def test_served_image_matches_jax(fp32_only):
    port, port32, req, ref, ref32 = _served(fp32_only)
    before = (tm.triplane_mlp.launches, tm.triplane_mlp_bf16.launches)
    ratio, image = _ratio(port, req, ref, ref32)
    assert (tm.triplane_mlp.launches, tm.triplane_mlp_bf16.launches) == before
    assert image.dtype == torch.float32 and image.shape == ref.shape == (2, 64, 64, 3)
    assert ratio <= (IMAGE_OF_FLOOR if fp32_only else IMAGE_BF16_BLOCKS_OF_FLOOR), ratio
    # JAX's own loose bound on a render_bf16 image against the float32 render
    diff = np.abs(f32(image) - f32(serving.make_serving_fn(port32, truncation_psi=0.7)(*req)))
    assert diff.mean() < 0.05 and diff.max() < 0.5, (diff.mean(), diff.max())


def _softplus_in_float32(monkeypatch):
    orig = rm.clamp_densities
    monkeypatch.setattr(rm, 'clamp_densities', lambda x, *a: orig(rm.widen(x), *a))


def _last_bias_unrounded(monkeypatch):
    def mlp(feats, w0, b0, w1, b1):
        h = port_bias_act.bias_act_plain((feats.float() @ w0.float()).to(BF), b0, act='lrelu')
        y = (h.float() @ w1.float()).to(BF).float() + b1.float()
        return y[..., :-1], y[..., -1]
    monkeypatch.setattr(tm, 'triplane_mlp_plain_bf16', mlp)


@pytest.mark.parametrize('mutant', [_softplus_in_float32, _last_bias_unrounded],
                         ids=['softplus-float32', 'last-bias-unrounded'])
def test_served_image_mutants_miss_the_limit(mutant, monkeypatch):
    """At the float32 blocks: the eval coarse march's softplus in float32
    (0.096 of the floor) and the MLP's last bias add unrounded (0.18) miss
    IMAGE_OF_FLOOR."""
    port, _, req, ref, ref32 = _served(True)
    mutant(monkeypatch)
    assert _ratio(port, req, ref, ref32)[0] > IMAGE_OF_FLOOR


@pytest.mark.parametrize('fp32_only', [True, False], ids=['float32-blocks', 'bf16-blocks'])
def test_served_image_with_float32_planes_misses_the_limit(fp32_only):
    """The planes left float32 (the render without `render_bf16`): 1.0 of
    the floor at the float32 blocks, 1.16 with the bf16 blocks, whose own
    flips take 0.82 of it."""
    _, port32, req, ref, ref32 = _served(fp32_only)
    ratio = _ratio(port32, req, ref, ref32)[0]
    assert ratio > (IMAGE_OF_FLOOR if fp32_only else IMAGE_BF16_BLOCKS_OF_FLOOR), ratio
