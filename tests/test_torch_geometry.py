"""Geometry: port (tdgp_torch.geometry) vs JAX package (tdgp.geometry) on the CPU.

At `tiny_test_config` widths, with the JAX generator's weights carried into
the port's: the voxel coordinates exactly; `compute_densities` and the
chunked density grid to 1e-4 of the grid's largest magnitude (XLA:CPU vs
PyTorch float32); marching tetrahedra on one shared grid, where the port's
numpy version equals the JAX package's exactly and the port's C++ copy
gives the same triangles (its edge interpolation runs in float32, the numpy
version's in float64: vertices agree to 2e-6 after both round to 6
decimals); the whole `extract_geometry` at 20^3; the mesh files; and a
failed C++ build, which raises.
"""
import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp
from flax import traverse_util

from tdgp import geometry as jax_geometry
from tdgp import inference as jax_inference
from tdgp.config import tiny_test_config as jax_tiny_test_config
from tdgp.models.epigraf import Generator as JaxGenerator

from tdgp_torch import geometry, native
from tdgp_torch.config import tiny_test_config
from tdgp_torch.models.epigraf import Generator
from tdgp_torch.weights import load_flat


@pytest.fixture(scope='module', autouse=True)
def _one_thread_per_worker():
    """One torch and one BLAS thread while this module runs: the test workers
    share the cores, and OpenBLAS's threads spin while the others hold them."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api='blas'):
        yield
    torch.set_num_threads(saved)


@pytest.fixture(scope='module')
def tiny():
    """(JAX generator, its variables, port generator, ws [2, num_ws, w_dim])."""
    jcfg = jax_tiny_test_config()
    G = JaxGenerator(jcfg.generator)
    z = jnp.zeros((2, jcfg.generator.z_dim))
    c = jnp.eye(jcfg.generator.c_dim)[:2]
    cam = jax_inference.canonical_cameras(jcfg, 2)
    rngs = {k: jax.random.PRNGKey(i + 1)
            for i, k in enumerate(('params', 'noise', 'render', 'depth', 'dropout'))}

    def init_fwd(g):
        g.synthesis.apply_camera_adaptor(cam, z, c)
        return g(z, c, cam, camera_angles_cond=cam.angles, resolution=8)

    g_vars = jax.jit(lambda r: G.init(r, method=init_fwd))(rngs)
    flat = {'/'.join(k): np.asarray(v)
            for k, v in traverse_util.flatten_dict(jax.device_get(g_vars)).items()}
    port = Generator(tiny_test_config().generator)
    load_flat(port, flat)
    ws = np.random.RandomState(6).randn(2, port.synthesis.num_ws,
                                        jcfg.generator.w_dim).astype(np.float32)
    return G, g_vars, port.eval(), ws


def _close_to_scale(got, ref, rel=1e-4):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


def test_voxel_coords_match_jax_exactly():
    for res, scale, batch in ((5, 0.5, 1), (8, 0.35, 2)):
        np.testing.assert_array_equal(geometry.create_voxel_coords(res, scale, batch).numpy(),
                                      np.asarray(jax_geometry.create_voxel_coords(res, scale,
                                                                                  batch)))


def test_compute_densities_matches_jax(tiny):
    G, g_vars, port, ws = tiny
    coords = (np.random.RandomState(2).rand(2, 500, 3).astype(np.float32) - 0.5) * 1.1
    ref = G.apply(g_vars, jnp.asarray(ws), jnp.asarray(coords),
                  method=lambda g, w, x: g.synthesis.compute_densities(w, x, noise_mode='const'))
    with torch.no_grad():
        got = port.synthesis.compute_densities(torch.from_numpy(ws), torch.from_numpy(coords))
    _close_to_scale(got.numpy(), ref)


@pytest.mark.parametrize('chunk', [1000, 32 ** 3], ids=['chunked', 'one-chunk'])
def test_density_grid_matches_jax(tiny, chunk):
    G, g_vars, port, ws = tiny
    ref = jax_geometry.extract_density_grid(G, g_vars, jnp.asarray(ws), resolution=14,
                                            cube_scale=0.5)
    got = geometry.extract_density_grid(port, torch.from_numpy(ws), resolution=14,
                                        cube_scale=0.5, chunk=chunk)
    assert got.shape == (14, 14, 14)
    _close_to_scale(got, ref)


def _grid(res=18, seed=0):
    """A smooth random field with a closed level set."""
    rng = np.random.RandomState(seed)
    side = np.linspace(-1, 1, res, dtype=np.float32)
    x, y, z = np.meshgrid(side, side, side, indexing='ij')
    field = 0.6 - np.sqrt(x ** 2 + 1.3 * y ** 2 + 0.8 * z ** 2)
    return (field + 0.05 * rng.randn(res, res, res)).astype(np.float32)


def _assert_same_triangles(verts, faces, ref_verts, ref_faces, atol):
    """The two meshes have the same triangles, vertex order included, in any
    order of the triangles: each triangle [9] is matched to its nearest in the
    other mesh, the matching is one to one, and every coordinate agrees to atol."""
    from scipy.spatial import cKDTree
    soup = np.asarray(verts)[np.asarray(faces)].reshape(-1, 9)
    ref = np.asarray(ref_verts)[np.asarray(ref_faces)].reshape(-1, 9)
    assert soup.shape == ref.shape
    _, match = cKDTree(ref).query(soup)
    assert len(np.unique(match)) == len(ref)
    np.testing.assert_allclose(soup, ref[match], rtol=0, atol=atol)


def test_numpy_marching_equals_the_jax_packages():
    vol = _grid()
    verts, faces = geometry._marching_tetrahedra_numpy(vol, 0.0)
    ref_verts, ref_faces = jax_geometry._marching_tetrahedra_numpy(vol, 0.0)
    assert len(faces) > 100
    np.testing.assert_array_equal(verts, ref_verts)
    np.testing.assert_array_equal(faces, ref_faces)


def test_native_marching_gives_the_numpy_triangles():
    vol = _grid(seed=1)
    verts, faces = native.marching_tetrahedra(vol, 0.05)
    ref_verts, ref_faces = jax_geometry._marching_tetrahedra_numpy(vol, 0.05)
    assert faces.shape == ref_faces.shape and int(faces.max()) < len(verts)
    _assert_same_triangles(verts, faces, ref_verts, ref_faces, atol=2e-6)
    # the dispatch of marching_cubes: native by default, numpy on request
    np.testing.assert_array_equal(geometry.marching_cubes(vol, 0.05)[1], faces)
    np.testing.assert_array_equal(geometry.marching_cubes(vol, 0.05, use_native=False)[1],
                                  ref_faces)


def test_native_copy_equals_the_jax_packages_native_build():
    from tdgp.native import _get_mc
    mc = _get_mc()
    if mc is None:
        pytest.skip("the JAX package's native build is unavailable (no g++)")
    vol = _grid(seed=2)
    verts, faces = native.marching_tetrahedra(vol, 0.0)
    ref_verts, ref_faces = mc.marching_tetrahedra(vol, 0.0)
    np.testing.assert_array_equal(verts, ref_verts)
    np.testing.assert_array_equal(faces, ref_faces)


def test_empty_level_set():
    verts, faces = native.marching_tetrahedra(np.zeros((4, 4, 4), np.float32), 1.0)
    assert len(verts) == 0 and len(faces) == 0


def test_extract_geometry_matches_jax(tiny):
    G, g_vars, port, ws = tiny
    ref_verts, ref_faces, ref_sigma = jax_geometry.extract_geometry(
        G, g_vars, jnp.asarray(ws), resolution=20, cube_scale=0.5)
    verts, faces, sigma = geometry.extract_geometry(port, torch.from_numpy(ws), resolution=20,
                                                    cube_scale=0.5)
    _close_to_scale(sigma, ref_sigma)
    assert len(faces) > 0 and int(faces.max()) < len(verts)
    assert np.abs(verts).max() <= 0.5 + 1e-6
    # on the JAX package's own grid and level, the port's marching gives its mesh
    level = float(np.percentile(np.asarray(ref_sigma), 90))
    same_verts, same_faces = geometry.marching_cubes(np.asarray(ref_sigma), level)
    same_verts = same_verts / 19 - 0.5
    _assert_same_triangles(same_verts, same_faces, ref_verts, ref_faces, atol=1e-6)


def test_a_failed_native_build_raises(tmp_path):
    broken = tmp_path / 'broken.cpp'
    broken.write_text('this is not C++\n')
    with pytest.raises(RuntimeError, match='g\\+\\+ failed'):
        native.build(str(broken), str(tmp_path / 'build'))
    assert not any(p.suffix == '.so' for p in (tmp_path / 'build').iterdir())


def test_mesh_files(tmp_path):
    verts, faces = geometry.marching_cubes(_grid(12), 0.0, use_native=False)
    geometry.save_obj(verts, faces, str(tmp_path / 'm.obj'))
    lines = (tmp_path / 'm.obj').read_text().splitlines()
    assert sum(l.startswith('v ') for l in lines) == len(verts)
    assert sum(l.startswith('f ') for l in lines) == len(faces)
    vol = _grid(10)
    geometry.save_mrc(vol, str(tmp_path / 'v.mrc'))
    jax_geometry.save_mrc(vol, str(tmp_path / 'ref.mrc'))
    assert (tmp_path / 'v.mrc').read_bytes() == (tmp_path / 'ref.mrc').read_bytes()
    assert os.path.getsize(tmp_path / 'v.mrc') == 1024 + vol.size * 4
