"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `tdgp_torch/csrc/<name>.cu` has a plain C interface and compiles on
its own into `tdgp_torch/build/lib<name>-<hash>.so`, keyed by a hash of the
source and the flags, at first use. The kernels launch on PyTorch's current
stream and allocate nothing; their wrappers live in `tdgp_torch/ops/`.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import re
import shutil
import subprocess
from typing import Dict, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(_PKG_DIR, 'build')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC')


def sources() -> Dict[str, str]:
    """Every CUDA source of the port: name -> path."""
    return {os.path.splitext(os.path.basename(p))[0]: p
            for p in sorted(glob.glob(os.path.join(CSRC_DIR, '*.cu')))}


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    for root in (os.environ.get('CUDA_HOME'), os.environ.get('CUDA_PATH'), '/usr/local/cuda'):
        if root and os.path.exists(os.path.join(root, 'bin', 'nvcc')):
            return os.path.join(root, 'bin', 'nvcc')
    raise RuntimeError('nvcc not found: the CUDA kernels build only where the CUDA toolkit is')


def library_path(name: str) -> str:
    with open(sources()[name], 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f'lib{name}-{digest[:16]}.so')


def ptxas_summary(log: str) -> str:
    """One line from `nvcc -Xptxas -v` output: the kernels, their registers,
    spill stores and static shared memory."""
    regs = [int(r) for r in re.findall(r'Used (\d+) registers', log)]
    spills = sum(int(b) for b in re.findall(r'(\d+) bytes spill stores', log))
    smem = [int(b) for b in re.findall(r'(\d+) bytes smem', log)] or [0]
    return (f'{len(regs)} kernels, {min(regs, default=0)}-{max(regs, default=0)} registers, '
            f'{spills} bytes of spill stores, up to {max(smem)} bytes of static shared memory')


def build(names: Sequence[str], ptxas_info: bool = False) -> Dict[str, str]:
    """Compile every named source that is not built yet, one nvcc process
    for each, all started together. Returns name -> library path; raises
    with the compiler's output if any build fails. With `ptxas_info`, prints
    each build's `ptxas_summary` (the flag leaves the binary as it is)."""
    paths = {name: library_path(name) for name in names}
    todo = {name: path for name, path in paths.items() if not os.path.exists(path)}
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = f'{path}.{os.getpid()}.tmp'
        extra = ['-Xptxas', '-v'] if ptxas_info else []
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *extra, '-o', tmp, sources()[name]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, todo[name])
            if ptxas_info:
                print(f'{name}.cu: {ptxas_summary(log)}')
        else:
            if os.path.exists(tmp):
                os.remove(tmp)
            failures.append(f'{name}.cu: nvcc exited {proc.returncode}\n{log}')
    if failures:
        raise RuntimeError('CUDA build failed:\n' + '\n'.join(failures))
    return paths


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The built library of `csrc/<name>.cu`, built first if needed."""
    return ctypes.CDLL(build([name])[name])
