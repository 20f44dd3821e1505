"""Kernel K3's merged entry (tdgp_torch/ops/ray_march.py `ray_march_merged`)
and the renderer's route to it, vs the JAX package's sort-free merge and
marchers.

`ray_march_merged` takes the coarse and fine sample sets as the model
evaluated them and computes `unify_samples_sorted` followed by the reduced
march. Its CUDA kernel runs only on the card, where `chip_smoke.py` holds it
against `ray_march_merged_plain`. Here the plain version is held against
`tdgp.rendering.renderer.unify_samples_sorted` followed by
`classical_ray_march` with its weights summed, and followed by
`ray_march_pallas` in interpret mode (as tests/test_pallas.py runs it), at
rtol = atol = 1e-4, with about a quarter of the fine depths equal to coarse
ones (ties, which go to the coarse set first). The kernel's own way through
the merge (a merge-path search, then a walk) is emulated in Python and held
to the permutation of the JAX package's merge. Inputs from
np.random.RandomState.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tdgp.ops.pallas_kernels import ray_march_pallas
from tdgp.rendering.renderer import RenderOptions, classical_ray_march, unify_samples_sorted

from tdgp_torch.ops import cuda_build
from tdgp_torch.ops import ray_march as rm
from tdgp_torch.rendering import renderer

TOL = dict(rtol=1e-4, atol=1e-4)
SIZES = [(8, 8), (32, 32), (5, 11)]  # (S1, S2)
CASES = [  # (clamp_mode, use_inf_depth, last_back)
    ('softplus', True, False), ('softplus', False, True), ('relu', True, False),
    ('relu', False, True)]


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _sets(seed, s1, s2, b=2, r=16, c=3):
    """(t1, c1, x1, t2, c2, x2) as numpy float32, each set sorted per ray;
    about a quarter of t2 equal to values of t1."""
    rng = np.random.RandomState(seed)
    t1 = np.sort(rng.rand(b, r, s1), -1) * 0.5 + 0.75
    t2 = rng.rand(b, r, s2) * 0.5 + 0.75
    tie = rng.rand(b, r, s2) < 0.25
    t2 = np.where(tie, np.take_along_axis(t1, rng.randint(0, s1, (b, r, s2)), -1), t2)
    t2 = np.sort(t2, -1)
    return tuple(a.astype(np.float32) for a in (
        t1, rng.randn(b, r, s1, c), rng.randn(b, r, s1) * 2,
        t2, rng.randn(b, r, s2, c), rng.randn(b, r, s2) * 2))


def _port(sets, clamp_mode, use_inf_depth, last_back):
    out = rm.ray_march_merged_plain(*(torch.from_numpy(a) for a in sets), clamp_mode, 1.0,
                                    use_inf_depth, last_back)
    return [t.numpy() for t in out]


def _jax_merge(sets):
    depths, colors, densities = unify_samples_sorted(*(jnp.asarray(a) for a in sets))
    return colors, densities, depths


def test_sets_have_ties():
    t1, _, _, t2, _, _ = _sets(0, 32, 32)
    shared = np.mean([np.isin(t2[i, j], t1[i, j]).mean() for i in range(2) for j in range(16)])
    assert 0.15 < shared < 0.35


@pytest.mark.parametrize('s1,s2', SIZES)
@pytest.mark.parametrize('clamp_mode,use_inf_depth,last_back', CASES)
def test_plain_matches_merge_and_classical_ray_march(s1, s2, clamp_mode, use_inf_depth,
                                                     last_back):
    sets = _sets(s1 * 100 + s2, s1, s2)
    opts = RenderOptions(clamp_mode=clamp_mode, use_inf_depth=use_inf_depth,
                         last_back=last_back)
    rgb, depth, weights, ftrans = classical_ray_march(*_jax_merge(sets), opts)
    ref = [rgb, depth, jnp.sum(weights, -1), ftrans]
    for port, want in zip(_port(sets, clamp_mode, use_inf_depth, last_back), ref):
        np.testing.assert_allclose(port, np.asarray(want), **TOL)


@pytest.mark.parametrize('s1,s2', SIZES)
@pytest.mark.parametrize('clamp_mode,use_inf_depth,last_back', CASES)
def test_plain_matches_merge_and_pallas_kernel(s1, s2, clamp_mode, use_inf_depth, last_back):
    sets = _sets(s1 * 100 + s2 + 1, s1, s2)
    with pltpu.force_tpu_interpret_mode():
        ref = ray_march_pallas(*_jax_merge(sets), clamp_mode=clamp_mode,
                               use_inf_depth=use_inf_depth, last_back=last_back)
        ref = jax.device_get(ref)
    for port, want in zip(_port(sets, clamp_mode, use_inf_depth, last_back), ref):
        np.testing.assert_allclose(port, np.asarray(want), **TOL)


@pytest.mark.parametrize('clamp_mode,use_inf_depth,last_back', CASES)
def test_one_sample_per_ray_matches_pallas_kernel(clamp_mode, use_inf_depth, last_back):
    """The kernels take rays of one sample; so does the plain march, whose
    last delta is then the ray's only one."""
    rng = np.random.RandomState(8)
    colors, densities = rng.randn(2, 16, 1, 3), rng.randn(2, 16, 1) * 2
    depths = rng.rand(2, 16, 1) + 0.5
    x = [a.astype(np.float32) for a in (colors, densities, depths)]
    with pltpu.force_tpu_interpret_mode():
        ref = jax.device_get(ray_march_pallas(*(jnp.asarray(a) for a in x), clamp_mode=clamp_mode,
                                              use_inf_depth=use_inf_depth, last_back=last_back))
    port = rm.ray_march_reduced_plain(*(torch.from_numpy(a) for a in x), clamp_mode, 1.0,
                                      use_inf_depth, last_back)
    for p, want in zip(port, ref):
        np.testing.assert_allclose(p.numpy(), np.asarray(want), **TOL)


def _merge_path_order(t1, t2, k):
    """The order in which the merged kernel's lanes walk the merge of two
    sorted sets (`Merged` in csrc/ray_march.cu): the lane that starts at
    merged position d finds a, the number of set-1 samples before it, with a
    merge-path search of 7 fixed steps, then takes k steps of the merge, set
    1 first on ties. -> [(set, index)] in merged order."""
    n1, n2 = len(t1), len(t2)
    order = []
    for d in range(0, n1 + n2, k):
        lo, pos = max(0, d - n2), 0
        length = min(d, n1) - lo
        for step in (64, 32, 16, 8, 4, 2, 1):
            m = lo + pos + step - 1
            if pos + step <= length and t1[m] <= t2[d - 1 - m]:
                pos += step
        a = lo + pos
        b = d - a
        for _ in range(min(k, n1 + n2 - d)):
            if a < n1 and (b >= n2 or t1[a] <= t2[b]):
                order.append((0, a))
                a += 1
            else:
                order.append((1, b))
                b += 1
    return order


@pytest.mark.parametrize('s1,s2,k', [(32, 32, 8), (5, 11, 2), (1, 127, 8), (70, 58, 8),
                                     (3, 5, 1), (12, 20, 4)])
def test_merge_path_walk_is_the_merge_order(s1, s2, k):
    """The kernel's merge walk gives the permutation of the JAX package's
    `unify_samples_sorted` on sets with many equal depths (small integers)."""
    rng = np.random.RandomState(s1 * 1000 + s2)
    t1 = np.sort(rng.randint(0, 12, (1, 200, s1)), -1).astype(np.float32)
    t2 = np.sort(rng.randint(0, 12, (1, 200, s2)), -1).astype(np.float32)
    ids1 = np.broadcast_to(np.arange(s1, dtype=np.float32), t1.shape)
    ids2 = np.broadcast_to(1000 + np.arange(s2, dtype=np.float32), t2.shape)
    zeros = [np.zeros((1, 200, s, 1), np.float32) for s in (s1, s2)]
    _, _, ids = unify_samples_sorted(*(jnp.asarray(a) for a in (t1, zeros[0], ids1, t2,
                                                                zeros[1], ids2)))
    for ray, want in enumerate(np.asarray(ids)[0].astype(int).tolist()):
        want = [(0, i) if i < 1000 else (1, i - 1000) for i in want]
        assert _merge_path_order(t1[0, ray], t2[0, ray], k) == want


def test_wrapper_takes_plain_version_for_cpu_tensors_and_never_loads_the_kernels(monkeypatch):
    def no_library(name):
        raise AssertionError(f'the CUDA library {name!r} was loaded for CPU tensors')

    monkeypatch.setattr(cuda_build, 'library', no_library)
    rm._kernels.cache_clear()
    sets = [torch.from_numpy(a) for a in _sets(3, 5, 11)]
    before = rm.ray_march_merged.launches
    out = rm.ray_march_merged(*sets, 'softplus', 1.0, False, True)
    ref = rm.ray_march_merged_plain(*sets, 'softplus', 1.0, False, True)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    with torch.no_grad():
        renderer.march_merged(*sets, renderer.RenderOptions())
    assert rm.ray_march_merged.launches == before  # counts kernel launches only


@pytest.mark.parametrize('case', ['too_many_samples', 'channels', 'float64', 'not_contiguous',
                                  'shape', 'clamp_mode', 'device'])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    s2 = 100 if case == 'too_many_samples' else 11
    t1, c1, x1, t2, c2, x2 = (torch.from_numpy(a) for a in _sets(4, 29, s2))
    clamp_mode, error = 'softplus', ValueError
    if case == 'channels':
        c1, c2 = torch.zeros(*t1.shape, 5), torch.zeros(*t2.shape, 5)
    elif case == 'float64':
        x2, error = x2.double(), TypeError
    elif case == 'not_contiguous':
        c1 = c1.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == 'shape':
        x2 = x2[:, :, :-1]
    elif case == 'clamp_mode':
        clamp_mode, error = 'exp', NotImplementedError
    elif case == 'device':
        t1, c1, x1, t2, c2, x2 = (t.to('meta') for t in (t1, c1, x1, t2, c2, x2))
    with pytest.raises(error):
        rm.ray_march_merged(t1, c1, x1, t2, c2, x2, clamp_mode)


def test_sample_limit_is_the_sum_of_both_sets():
    sets = [torch.from_numpy(a) for a in _sets(5, 1, 127, b=1, r=3)]
    out = rm.ray_march_merged(*sets)
    ref = rm.ray_march_merged_plain(*sets)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_routes_of_the_final_march(monkeypatch):
    """Where autograd records, the render merges with unify_samples_sorted and
    marches with ray_march_reduced (their backward); elsewhere it calls the
    merged entry once and neither of them."""
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        monkeypatch.setattr(renderer, name, wrapped)

    for name in ('unify_samples_sorted', 'ray_march_reduced', 'ray_march_merged'):
        spy(name, getattr(renderer, name))
    sets = [torch.from_numpy(a) for a in _sets(6, 8, 8)]
    opts = renderer.RenderOptions()
    with torch.no_grad():
        merged = renderer.march_merged(*[t.requires_grad_(True) for t in sets], opts)
    assert calls == ['ray_march_merged']
    calls.clear()
    recorded = renderer.march_merged(*sets, opts)
    assert calls == ['unify_samples_sorted', 'ray_march_reduced']
    for a, b in zip(merged, recorded):
        assert torch.equal(a, b.detach())
    recorded[0].sum().backward()
    assert sets[1].grad is not None and sets[4].grad is not None


def test_plain_impl_is_refused_off_the_cpu_on_the_merged_route():
    sets = [torch.from_numpy(a) for a in _sets(7, 8, 8)]
    opts = renderer.RenderOptions(march_impl='jnp')
    cpu = renderer.march_merged(*sets, opts)
    for a, b in zip(cpu, rm.ray_march_merged_plain(*sets)):
        assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="'jnp'"):
        renderer.march_merged(*(t.to('meta') for t in sets), opts)
