"""Host C++ code of the port, built with g++ and bound with ctypes.

The port's own copy of `tdgp/native/`: `marching_cubes.cpp` compiles into
`tdgp_torch/build/libmc-<hash>.so` at first use, keyed by a hash of the
source and the flags. A failed build raises with the compiler's output;
nothing falls back to the numpy version.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from typing import Tuple

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'marching_cubes.cpp')
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'build')
CXX_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')


def build(source: str = SOURCE, build_dir: str = BUILD_DIR) -> str:
    """Compile `source` unless it is built already -> the library's path."""
    with open(source, 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(CXX_FLAGS).encode()).hexdigest()[:16]
    path = os.path.join(build_dir, f'libmc-{digest}.so')
    if os.path.exists(path):
        return path
    os.makedirs(build_dir, exist_ok=True)
    tmp = f'{path}.{os.getpid()}.tmp'
    proc = subprocess.run(['g++', *CXX_FLAGS, source, '-o', tmp], capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f'g++ failed to build {source} (exit {proc.returncode}):\n'
                           f'{proc.stdout}{proc.stderr}')
    os.replace(tmp, path)
    return path


@functools.cache
def _library(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.mc_run.restype = ctypes.c_void_p
    lib.mc_run.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_float, ctypes.POINTER(ctypes.c_int64)]
    lib.mc_get_triangles.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    lib.mc_free.argtypes = [ctypes.c_void_p]
    return lib


def marching_tetrahedra(values: np.ndarray, level: float) -> Tuple[np.ndarray, np.ndarray]:
    """values [X, Y, Z] -> (verts [V, 3] in voxel coordinates, faces [F, 3]),
    vertices merged where they agree to 6 decimals."""
    values = np.ascontiguousarray(values, dtype=np.float32)
    if values.ndim != 3:
        raise ValueError(f'expected a 3-D grid, got shape {values.shape}')
    lib = _library(build())
    nx, ny, nz = values.shape
    n_tris = ctypes.c_int64(0)
    handle = lib.mc_run(values.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nx, ny, nz,
                        ctypes.c_float(level), ctypes.byref(n_tris))
    try:
        tris = np.empty((n_tris.value, 3, 3), dtype=np.float32)
        if n_tris.value > 0:
            lib.mc_get_triangles(handle, tris.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    finally:
        lib.mc_free(handle)
    verts, inverse = np.unique(tris.reshape(-1, 3).round(6), axis=0, return_inverse=True)
    return verts.astype(np.float64), inverse.reshape(-1, 3)
