"""The non-flatness score of the port against the JAX package's, on the CPU.

- the quantile (`ops.ray_march.quantile`, a sort with JAX's float32
  interpolation) against `jnp.quantile`, with ties and a NaN, bit for bit;
- the quantile cut of the final march: K3's merged entry with a cut
  (`ray_march_merged_cut`, here its plain version, as on every CPU tensor)
  against `tdgp`'s `unify_samples_sorted` + `classical_ray_march` with
  `cut_quantile`, weights summed, at q = 0.25 and 0.5 with ties, 1e-5
  absolute; the samples each package zeroed are counted and printed
  (one-ulp softplus differences may move a sample across the threshold);
  the same march without the cut misses the limit (the witness);
- the cut in the coarse march (all the weights) against JAX's;
- the renderer's route to the cut entry, and its refusals;
- the depth sampler (`EvalContext.make_depth_sampler`) against JAX's at
  `tiny_test_config` on the same weights, also at `max_batch_res=16`, where
  the quantile pools over a chunk of 256 rays of each image: depth within
  1e-4 relative to the frustum's depth; the sampler without the cut misses;
- `nfs256` through both registries on those weights: the value within 1e-4.
"""
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from tdgp.config import tiny_test_config as jax_tiny_test_config
from tdgp.infra.experiment import apply_overrides as jax_apply_overrides
from tdgp.metrics import registry as jax_registry
from tdgp.models.epigraf import Generator as JaxGenerator
from tdgp.rendering.renderer import RenderOptions as JaxRenderOptions
from tdgp.rendering.renderer import classical_ray_march, unify_samples_sorted

from tdgp_torch.config import apply_overrides, tiny_test_config
from tdgp_torch.metrics import registry
from tdgp_torch.models.epigraf import Generator
from tdgp_torch.ops import cuda_build
from tdgp_torch.ops import ray_march as rm
from tdgp_torch.rendering import renderer
from tdgp_torch.weights import load_flat

from test_torch_inference import _jax_generator
from test_torch_ray_march_merged import _sets

CUT_TOL = 1e-5            # the march with the cut, port vs JAX: absolute
DEPTH_TOL = 1e-4          # depth maps: relative to the frustum's far end
NFS_TOL = 1e-4            # nfs256: relative


@pytest.fixture(scope='module', autouse=True)
def _one_thread_per_worker():
    """One torch and one BLAS thread while this module runs: the test workers
    share the cores, and OpenBLAS's threads spin while the others hold them."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api='blas'):
        yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize('case', ['ties', 'odd_size', 'q_one', 'nan', 'one_element'])
@pytest.mark.parametrize('q', [0.25, 0.5, 0.9])
def test_quantile_as_jnp(case, q):
    rs = np.random.RandomState(7)
    x = {'ties': np.round(rs.randn(4, 33, 20), 1), 'odd_size': rs.randn(3, 7, 13),
         'q_one': rs.randn(50), 'nan': np.where(rs.rand(40) < 0.1, np.nan, rs.randn(40)),
         'one_element': rs.randn(1)}[case].astype(np.float32)
    q = 1.0 if case == 'q_one' else q
    ref = np.asarray(jnp.quantile(jnp.asarray(x), q))
    got = rm.quantile(torch.from_numpy(x), q)
    assert got.shape == (1,) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy()[0], ref)


def _jax_cut_march(sets, q, clamp_mode='softplus', use_inf_depth=True, last_back=False):
    depths, colors, densities = unify_samples_sorted(*(jnp.asarray(a) for a in sets))
    opts = JaxRenderOptions(clamp_mode=clamp_mode, use_inf_depth=use_inf_depth,
                            last_back=last_back, cut_quantile=q)
    rgb, depth, weights, ftrans = classical_ray_march(colors, densities, depths, opts)
    return [np.asarray(a) for a in (rgb, depth, weights.sum(-1), ftrans)], np.asarray(densities)


def _cut_counts(densities, q):
    """(samples zeroed, threshold) of JAX's cut on merged raw densities."""
    clamped = np.asarray(jnp.logaddexp(jnp.asarray(densities), 0.0))
    thresh = np.asarray(jnp.quantile(jnp.asarray(clamped), q))
    return int((clamped < thresh).sum()), float(thresh)


@pytest.mark.parametrize('q', [0.25, 0.5])
@pytest.mark.parametrize('clamp_mode,use_inf_depth,last_back',
                         [('softplus', True, False), ('softplus', False, True),
                          ('relu', True, False)])
def test_merged_cut_as_jax(q, clamp_mode, use_inf_depth, last_back):
    sets = _sets(3, 32, 32, b=2, r=16)
    ref, merged_densities = _jax_cut_march(sets, q, clamp_mode, use_inf_depth, last_back)
    tensors = [torch.from_numpy(a) for a in sets]
    got = [t.numpy() for t in rm.ray_march_merged_cut(*tensors, q, clamp_mode, 1.0,
                                                      use_inf_depth, last_back)]
    port_clamped = rm.clamp_densities(torch.cat([tensors[2], tensors[5]], -1), clamp_mode)
    below = port_clamped < rm.quantile(port_clamped, q)
    port_cut = int(below.sum())
    if clamp_mode == 'softplus':
        jax_cut, thresh = _cut_counts(merged_densities, q)
        print(f'q={q}: threshold {thresh:.6g}, samples zeroed: JAX {jax_cut}, port {port_cut} '
              f'of {merged_densities.size}')
        assert abs(jax_cut - port_cut) <= 1
    errs = [float(np.abs(a - b).max()) for a, b in zip(got, ref)]
    assert max(errs) <= CUT_TOL, errs
    uncut = [t.numpy() for t in rm.ray_march_merged_plain(*tensors, clamp_mode, 1.0,
                                                          use_inf_depth, last_back)]
    witness = max(float(np.abs(a - b).max()) for a, b in zip(uncut, ref))
    if bool((below & (port_clamped > 0)).any()):  # relu's zeros may fill the quantile
        assert witness > CUT_TOL


@pytest.mark.parametrize('q', [0.25, 0.5])
def test_coarse_march_cut_as_jax(q):
    t1, c1, x1 = _sets(5, 32, 8, b=2, r=16)[:3]
    ref = classical_ray_march(jnp.asarray(c1), jnp.asarray(x1), jnp.asarray(t1),
                              JaxRenderOptions(cut_quantile=q))
    got = renderer.classical_ray_march(torch.from_numpy(c1), torch.from_numpy(x1),
                                       torch.from_numpy(t1), renderer.RenderOptions(cut_quantile=q))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=CUT_TOL)
    uncut = renderer.classical_ray_march(torch.from_numpy(c1), torch.from_numpy(x1),
                                         torch.from_numpy(t1), renderer.RenderOptions())
    assert float(np.abs(uncut[2].numpy() - np.asarray(ref[2])).max()) > CUT_TOL


def test_render_routes_the_cut_to_its_entry(monkeypatch):
    sets = [torch.from_numpy(a) for a in _sets(1, 8, 8)]
    calls = []
    real = renderer.ray_march_merged_cut

    def spy(*args):
        calls.append(args[6])
        return real(*args)

    monkeypatch.setattr(renderer, 'ray_march_merged_cut', spy)
    monkeypatch.setattr(cuda_build, 'library', lambda *a: pytest.fail('kernel library loaded'))
    opts = renderer.RenderOptions(cut_quantile=0.5)
    with torch.no_grad():
        renderer.march_merged(*sets, opts)
        renderer.march_merged(*sets, renderer.RenderOptions())
    assert calls == [0.5]
    sets[2].requires_grad_(True)
    with pytest.raises(NotImplementedError, match='without gradients'):
        renderer.march_merged(*sets, opts)
    with pytest.raises(ValueError, match='cut_quantile'):
        rm.ray_march_merged_cut(*[t.detach() for t in sets], 0.0)


# ------------------------------------------------------------- the depth sampler

@pytest.fixture(scope='module')
def generators():
    """(JAX config, G, variables; port config, G) at tiny_test_config, same weights."""
    jcfg = jax_tiny_test_config()
    G, g_vars, flat = _jax_generator(jcfg)
    cfg = tiny_test_config()
    port = Generator(cfg.generator)
    load_flat(port, flat)
    return jcfg, G, g_vars, cfg, port.eval()


def _contexts(generators, overrides=(), batch_size=4):
    jcfg, G, g_vars, cfg, port = generators
    jcfg, cfg = jax_apply_overrides(jcfg, list(overrides)), apply_overrides(cfg, list(overrides))
    if overrides:
        G = JaxGenerator(jcfg.generator)
        port = Generator(cfg.generator)
        port.load_state_dict(generators[4].state_dict())
        port.eval()
    return (jax_registry.EvalContext(cfg=jcfg, G=G, g_vars=g_vars, batch_size=batch_size),
            registry.EvalContext(cfg=cfg, G=port, batch_size=batch_size))


@pytest.mark.parametrize('overrides', [(), ('generator.max_batch_res=16',)],
                         ids=['one_chunk', 'chunks_of_256_rays'])
def test_depth_sampler_as_jax(generators, overrides):
    jctx, ctx = _contexts(generators, overrides)
    ref = np.asarray(jctx.make_depth_sampler(0.5)(4, 2))
    got = ctx.make_depth_sampler(0.5)(4, 2).numpy()
    far = ctx.cfg.camera.ray.end
    assert got.shape == ref.shape == (4, 64, 64, 1)
    err = float(np.abs(got - ref).max()) / far
    uncut = ctx.make_depth_sampler(0.0)(4, 2).numpy()
    print(f'{overrides}: depth max diff {err:.3g} of the far end; without the cut '
          f'{float(np.abs(uncut - ref).max()) / far:.3g}')
    assert err <= DEPTH_TOL
    assert float(np.abs(uncut - ref).max()) / far > DEPTH_TOL


def test_nfs256_as_jax(generators, monkeypatch):
    jctx, ctx = _contexts(generators, batch_size=64)
    ref = jax_registry.nfs256(jctx)['nfs256']
    got = registry.nfs256(ctx)['nfs256']
    print(f'nfs256 at tiny_test_config: port {got!r}, JAX {ref!r}')
    assert np.isfinite(got) and got >= 1.0
    np.testing.assert_allclose(got, ref, rtol=NFS_TOL)
