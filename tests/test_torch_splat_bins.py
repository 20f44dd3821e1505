"""Kernel K1's binning (tdgp_torch/ops/splat.py `_bins`) and its algorithm
walked in plain PyTorch (`triplane_splat_binned_plain`) vs the scatter-add
plain version and the JAX package's `triplane_splat_ref`.

The CUDA kernel runs only on the card, where `chip_smoke.py` holds it against
`triplane_sample_bwd_plain`; here `triplane_splat_binned_plain` walks the
bins the wrapper hands the kernel, strip by strip as the kernel's warps do,
so the key, copy and halo arithmetic is held on the CPU, and
`triplane_splat_grouped_plain` walks them as the bf16 entry's group walk
does (F / 8 lanes an entry, its runs in rounds, one corner index at a
time), at F = 8, 16 and 32, in bf16 with the other pass's addend and in
float32. Cases: points on
strip edges (a footprint in two or four strips), on the last texel row or
column, outside the plane, all 32 samples of one ray on one texel, planes
with empty strips and with partial last strips; plane and coordinate
gradients. Tolerance as tests/test_torch_splat.py: rtol 1e-4 and atol
1e-4 x the largest magnitude of the reference.
"""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from tdgp.ops.splat import triplane_splat_ref

from tdgp_torch.ops.splat import (STRIP_H, STRIP_W, _bins, _plane_coords, _strip_origin, _strips,
                                  group_size, run_ranks, triplane_sample_bwd_plain,
                                  triplane_sample_bwd_plain_bf16, triplane_splat_binned_plain,
                                  triplane_splat_grouped_plain, triplane_splat_plain)

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


def _coord(pixel, size):
    """The world coordinate whose plane-pixel coordinate is `pixel` on an
    axis of `size` texels."""
    return (2.0 * pixel / (size - 1) - 1.0) * SCALE


def _case(name, rng, n=2, h=48, w=40, f=8, p=160):
    """planes [3n, h, w, f], coords [n, p, 3], cotangent [n, p, f] for one case.
    The x/y plane reads (x, y), x/z (x, z) and y/z (y, z)."""
    planes = rng.randn(3 * n, h, w, f).astype(np.float32)
    coords = rng.uniform(-0.55, 0.55, (n, p, 3)).astype(np.float32)
    if name == 'strip_edges':  # base corners on the last texel of a strip's row or column
        coords[:, :60, 0] = _coord(STRIP_W - 1 + rng.uniform(0.05, 0.95, (n, 60)), w)
        coords[:, 40:100, 1] = _coord(2 * STRIP_W - 1 + rng.uniform(0.05, 0.95, (n, 60)), h)
        coords[:, 80:120, 2] = _coord(STRIP_H * 7 - 1 + rng.uniform(0.05, 0.95, (n, 40)), h)
    elif name == 'last_row_and_column':
        coords[:, :50, 0] = SCALE           # gx = W-1 exactly
        coords[:, 50:100, 1] = SCALE        # gy = H-1 exactly
        coords[:, 100:130, 0] = _coord(w - 1 + 0.5, w)  # between the last column and outside
        coords[:, 100:130, 1] = _coord(-0.5, h)         # and above the first row
    elif name == 'outside':
        coords[:, :80] = rng.uniform(-1.2, 1.2, (n, 80, 3))
        coords[:, 80:90] = 0.9  # no corner in any plane
    elif name == 'one_ray_one_texel':  # 32 samples of a ray on one texel, 5 rays
        base = rng.uniform(-0.4, 0.4, (n, 5, 1, 3))
        coords[:, :160] = (base + rng.uniform(0, 1e-3, (n, 5, 32, 3))).reshape(n, 160, 3)
    elif name == 'empty_strips':  # points in one corner of the cube: most strips get none
        coords = rng.uniform(-0.5, -0.3, (n, p, 3)).astype(np.float32)
    elif name == 'partial_strips':  # H, W not multiples of the strip's sides
        return _case('uniform', rng, h=37, w=21, f=f)
    g = rng.randn(n, p, f).astype(np.float32)
    return planes, coords.astype(np.float32), g


CASES = ['uniform', 'strip_edges', 'last_row_and_column', 'outside', 'one_ray_one_texel',
         'empty_strips', 'partial_strips']


@pytest.fixture(scope='module', params=CASES)
def case(request):
    rng = np.random.RandomState(CASES.index(request.param) + 3)
    planes, coords, g = _case(request.param, rng)
    return request.param, planes, coords, g


def test_binned_walk_matches_the_plain_backward(case):
    name, planes, coords, g = case
    args = (torch.from_numpy(planes), torch.from_numpy(coords), torch.from_numpy(g), SCALE)
    ref_planes, ref_coords = triplane_sample_bwd_plain(*args)
    got_planes, got_coords = triplane_splat_binned_plain(*args)
    assert_close(got_planes.numpy(), ref_planes.numpy(), f'{name} g_planes')
    assert_close(got_coords.numpy(), ref_coords.numpy(), f'{name} g_coords')
    assert float(ref_planes.abs().max()) > 0


def test_binned_walk_matches_the_jax_scatter_reference(case):
    name, planes, coords, g = case
    n3, h, w, _ = planes.shape
    g_pts = np.repeat(g[:, None] / 3.0, 3, axis=1).reshape(n3, -1, g.shape[-1])
    ref = triplane_splat_ref(jnp.asarray(g_pts), jnp.asarray(coords), SCALE, n3, h, w)
    got, _ = triplane_splat_binned_plain(torch.from_numpy(planes), torch.from_numpy(coords),
                                         torch.from_numpy(g), SCALE, coords_grad=False)
    assert_close(got.numpy(), ref, name)
    assert_close(triplane_splat_plain(torch.from_numpy(g_pts), torch.from_numpy(coords), SCALE,
                                      n3, h, w).numpy(), ref, name)


def test_every_texel_belongs_to_exactly_one_strip():
    for h, w in ((48, 40), (37, 21), (512, 512), (16, 1)):
        owner = np.zeros((3, h, w), np.int64)
        strips_y, strips_x = _strips(h, w)
        for b in range(3 * strips_y * strips_x):
            plane, y_base, x_base = _strip_origin(b, h, w)
            owner[plane, y_base:y_base + STRIP_H, x_base:x_base + STRIP_W] += 1
        assert (owner == 1).all(), (h, w)


def _bin_contents(planes, coords):
    n3, h, w, _ = planes.shape
    p = coords.shape[1]
    gxy = _plane_coords(torch.from_numpy(coords), SCALE, h, w)
    entries, offsets = _bins(gxy, h, w)
    entries, offsets = entries.numpy(), offsets.numpy()
    assert entries.dtype == np.int32 and offsets.dtype == np.int32
    assert offsets[0] == 0 and offsets[-1] == len(entries) and (np.diff(offsets) >= 0).all()
    bins = {}
    for b in range(len(offsets) - 1):
        for e in entries[offsets[b]:offsets[b + 1]]:
            bins.setdefault(int(e), []).append(b)
    return gxy.reshape(n3 * p, 2).numpy(), bins


def test_each_entry_is_in_the_strips_its_corners_meet(case):
    """An entry sits in the bin of every strip that holds one of its in-plane
    corners, and in no other; entries with no corner in the plane in none."""
    name, planes, coords, _ = case
    n3, h, w, _ = planes.shape
    strips_y, strips_x = _strips(h, w)
    p = coords.shape[1]
    gxy, bins = _bin_contents(planes, coords)
    copies = 0
    for e in range(n3 * p):
        x0, y0 = int(np.floor(gxy[e, 0])), int(np.floor(gxy[e, 1]))
        want = sorted({((e // p) * strips_y + y // STRIP_H) * strips_x + x // STRIP_W
                       for y in (y0, y0 + 1) for x in (x0, x0 + 1)
                       if 0 <= y < h and 0 <= x < w})
        assert sorted(bins.get(e, [])) == want, (name, e)
        copies += max(len(want) - 1, 0)
    if name == 'strip_edges':
        assert copies >= 100  # the case reaches the copies
    if name == 'outside':
        assert len(bins) < n3 * p


def test_entries_keep_their_order_within_a_strip():
    """A bin is its home entries, then the copies from the strip on the left,
    above and above-left, each run in entry order: at most 3 descents."""
    rng = np.random.RandomState(0)
    planes, coords, _ = _case('strip_edges', rng)
    n3, h, w, _ = planes.shape
    entries, offsets = _bins(_plane_coords(torch.from_numpy(coords), SCALE, h, w), h, w)
    for b in range(len(offsets) - 1):
        run = entries[offsets[b]:offsets[b + 1]].numpy()
        assert (np.diff(run) < 0).sum() <= 3 and len(np.unique(run)) == len(run)


def test_contention_case_puts_a_ray_in_one_strip():
    rng = np.random.RandomState(1)
    planes, coords, g = _case('one_ray_one_texel', rng)
    n3, h, w, _ = planes.shape
    _, offsets = _bins(_plane_coords(torch.from_numpy(coords), SCALE, h, w), h, w)
    assert int(np.diff(offsets.numpy()).max()) >= 32


def test_coordinate_gradient_is_optional_and_reads_no_planes():
    rng = np.random.RandomState(2)
    planes, coords, g = _case('strip_edges', rng)
    nan_planes = torch.full(planes.shape, float('nan'))
    got, g_coords = triplane_splat_binned_plain(nan_planes, torch.from_numpy(coords),
                                                torch.from_numpy(g), SCALE, coords_grad=False)
    ref, _ = triplane_sample_bwd_plain(torch.from_numpy(planes), torch.from_numpy(coords),
                                       torch.from_numpy(g), SCALE, coords_grad=False)
    assert g_coords is None
    assert_close(got.numpy(), ref.numpy())


def test_capture_of_the_steps_splat_calls_on_a_tiny_trainer():
    """`profile_training.capture_splat_calls`, which `chip_smoke.py` uses to
    hold K1 on the training step's own points: one plain step gives one
    coarse and one fine call, in that order, with the step's arguments, and
    the launch counter keeps its count."""
    import dataclasses

    from tdgp_torch import profile_training
    from tdgp_torch.config import tiny_test_config
    from tdgp_torch.ops import splat
    from tdgp_torch.training.schedules import compute_schedules
    from tdgp_torch.training.train_step import Trainer
    from tdgp_torch.utils.draws import Draws

    cfg = tiny_test_config()
    cfg = dataclasses.replace(cfg, discriminator=dataclasses.replace(cfg.discriminator,
                                                                     fp32_only=True))
    trainer = Trainer(cfg, 'cpu')
    batch = profile_training.make_batch(cfg, 2, 0, 'cpu')
    before = splat.triplane_splat.launches
    calls = profile_training.capture_splat_calls(
        trainer, batch, compute_schedules(cfg, 300_000), Draws(torch.Generator().manual_seed(0)))
    assert [label for label, _ in calls] == ['coarse', 'fine']
    assert splat.triplane_splat.launches == before  # CPU tensors: no launch, and the name is back
    (planes, coords, g, scale, _), (planes_f, coords_f, _, _, _) = (args for _, args in calls)
    assert planes.shape[0] == 3 * coords.shape[0] and g.shape[:2] == coords.shape[:2]
    assert coords.shape == coords_f.shape and not torch.equal(coords, coords_f)
    assert scale == cfg.camera.cube_scale
    ref = triplane_sample_bwd_plain(planes, coords, g, scale)
    got = triplane_splat_binned_plain(planes, coords, g, scale)
    for a, b in zip(got, ref):
        assert_close(a.detach().numpy(), b.detach().numpy())


# ------------------------------------------------------------ the group walk

def _bf16_case(name, f):
    rng = np.random.RandomState(CASES.index(name) + 11)
    planes, coords, g = _case(name, rng, f=f)
    addend = rng.randn(*planes.shape).astype(np.float32)
    return (torch.from_numpy(planes).to(torch.bfloat16), torch.from_numpy(coords),
            torch.from_numpy(g).to(torch.bfloat16), torch.from_numpy(addend))


@pytest.mark.parametrize('f', [8, 16, 32])
@pytest.mark.parametrize('name', CASES)
def test_group_walk_matches_the_plain_bf16_backward(name, f):
    """The group walk's float32 sums (with the other pass's addend) and its
    coordinate gradient against `triplane_sample_bwd_plain_bf16` at the
    tolerance above; its stored bf16 gradient within one bf16 ulp of the
    texel plus 1e-5 x the largest, the limit `chip_smoke.py` holds the
    kernel to (the sums in another order may flip a rounding)."""
    planes, coords, g, addend = _bf16_case(name, f)
    sums, g_coords = triplane_splat_grouped_plain(planes, coords, g, SCALE, addend=addend,
                                                  round_out=False)
    ref_sums, ref_coords = triplane_sample_bwd_plain_bf16(planes, coords, g, SCALE,
                                                          addend=addend, round_out=False)
    assert sums.dtype == torch.float32
    assert_close(sums.numpy(), ref_sums.numpy(), f'{name} sums')
    assert_close(g_coords.numpy(), ref_coords.numpy(), f'{name} g_coords')
    stored, none = triplane_splat_grouped_plain(planes, coords, g, SCALE, coords_grad=False,
                                                addend=addend)
    ref, _ = triplane_sample_bwd_plain_bf16(planes, coords, g, SCALE, False, addend=addend)
    assert none is None and stored.dtype == torch.bfloat16
    limit = ref.float().abs() * 2.0 ** -7 + 1e-5 * float(ref.float().abs().max())
    assert bool(((stored.float() - ref.float()).abs() <= limit).all()), name


@pytest.mark.parametrize('f', [8, 32])
@pytest.mark.parametrize('name', CASES)
def test_group_walk_matches_the_jax_scatter_reference(name, f):
    """In float32 the group walk is the splat of `triplane_splat_ref`, and
    its coordinate gradient the plain backward's."""
    rng = np.random.RandomState(CASES.index(name) + 3)
    planes, coords, g = _case(name, rng, f=f)
    n3, h, w, _ = planes.shape
    g_pts = np.repeat(g[:, None] / 3.0, 3, axis=1).reshape(n3, -1, f)
    ref = triplane_splat_ref(jnp.asarray(g_pts), jnp.asarray(coords), SCALE, n3, h, w)
    args = (torch.from_numpy(planes), torch.from_numpy(coords), torch.from_numpy(g), SCALE)
    got, got_coords = triplane_splat_grouped_plain(*args)
    assert got.dtype == torch.float32
    assert_close(got.numpy(), ref, name)
    assert_close(got_coords.numpy(), triplane_sample_bwd_plain(*args)[1].numpy(), name)


def test_group_walk_takes_a_run_in_rounds_in_the_contention_case():
    """All samples of a ray on one texel: a group of the walk is one run,
    so its entries go in group_size(F) rounds, and the sum is still the
    plain backward's."""
    planes, coords, g, addend = _bf16_case('one_ray_one_texel', 32)
    n3, h, w, f = planes.shape
    gxy = _plane_coords(coords, SCALE, h, w).reshape(-1, 2)
    entries, offsets = _bins(gxy.reshape(n3, -1, 2), h, w)
    b = int(np.argmax(np.diff(offsets.numpy())))
    first = entries[int(offsets[b]):int(offsets[b]) + group_size(f)].long()
    ranks = run_ranks(torch.floor(gxy[first, 1]) * 64 + torch.floor(gxy[first, 0]))
    assert int(ranks.max()) == group_size(f) - 1
    assert run_ranks(torch.tensor([3, 5, 3, 3, 7, 5])).tolist() == [0, 0, 1, 2, 0, 1]
    sums, _ = triplane_splat_grouped_plain(planes, coords, g, SCALE, round_out=False)
    ref, _ = triplane_sample_bwd_plain_bf16(planes, coords, g, SCALE, round_out=False)
    assert_close(sums.numpy(), ref.numpy())


def test_capture_of_the_bf16_views_splat_calls_on_a_tiny_trainer():
    """`profile_training.capture_splat_bf16_calls`, which `chip_smoke.py` and
    `compare_kernels.py` use to time K1's bf16 entry on a
    `gmain_render_bf16` step's own points: the fine pass's call keeps its
    float32 sum, the coarse pass's adds it; the group walk on each call's
    arguments is the plain bf16 backward's."""
    import dataclasses

    from tdgp_torch import profile_training
    from tdgp_torch.config import apply_overrides, tiny_test_config
    from tdgp_torch.ops import splat
    from tdgp_torch.training.schedules import compute_schedules
    from tdgp_torch.training.train_step import Trainer
    from tdgp_torch.utils.draws import Draws

    cfg = apply_overrides(tiny_test_config(), ('training.gmain_render_bf16=true',))
    cfg = dataclasses.replace(cfg, discriminator=dataclasses.replace(cfg.discriminator,
                                                                     fp32_only=True))
    trainer = Trainer(cfg, 'cpu')
    batch = profile_training.make_batch(cfg, 2, 0, 'cpu')
    before = splat.triplane_splat_bf16.launches
    calls = profile_training.capture_splat_bf16_calls(
        trainer, batch, compute_schedules(cfg, 300_000), Draws(torch.Generator().manual_seed(0)))
    assert [label for label, _ in calls] == ['fine', 'coarse']
    assert splat.triplane_splat_bf16.launches == before
    fine, coarse = (args for _, args in calls)
    assert fine['addend'] is None and not fine['round_out'] and coarse['round_out']
    assert coarse['addend'].dtype == torch.float32 and fine['planes'].dtype == torch.bfloat16
    for args in (fine, coarse):
        args = {k: v.detach() if torch.is_tensor(v) else v for k, v in args.items()}
        got = triplane_splat_grouped_plain(**args)
        ref = triplane_sample_bwd_plain_bf16(**args)
        assert_close(got[0].float().numpy(), ref[0].float().numpy())
        if ref[1] is not None:
            assert_close(got[1].numpy(), ref[1].numpy())
