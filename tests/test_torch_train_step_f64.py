"""The blur-on G+D step of the port against the JAX package, in float64.

In the first 200 kimg of a run D sees its input through a Gaussian blur
(sigma 5 at 100 kimg: 31 taps on the 16^2 patches of `tiny_test_config`).
At float32 that step is so sensitive to rounding that D's gradients differ
between the two packages by up to ~1e-3 of their scale, above the 1e-4 that
tests/test_torch_train_step.py holds at 300 kimg. Run in float64, the same
step agrees to ~1e-15 of the scale on the losses, Gmain, Dmain and R1
gradients and the weights after the step: the packages compute the same
function, and the float32 gap is rounding that the step amplifies
(ROADMAP §3).

Both packages are copied with every float32 dtype in their source turned
into float64 (`F64_SUBS`; the repo's files are not touched), and one step
runs at 100 kimg through `run_step` of tests/test_torch_train_step.py in a
child process with JAX's float64 on: this file run as a script,

    PYTHONPATH=<float64 copies> python tests/test_torch_train_step_f64.py KIMG

which prints, as one JSON object, the largest |port - jax| of each gradient
phase ('g', 'd', 'r1') and each module after the step ('G', 'D', 'G_ema')
over the largest |jax| there, and for 'losses' the largest relative
difference of a loss. Every draw of the JAX step is replayed into the port,
as in tests/test_torch_train_step.py.

Tolerance: 1e-10 x the largest magnitude of each phase (relative for the
losses); the worst reading is ~1e-13 (the R1 gradient).
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KIMG = 100
TOL = 1e-10
F64_SUBS = (('np.float32', 'np.float64'), ('numpy.float32', 'numpy.float64'),
            ('torch.float32', 'torch.float64'), ("'float32'", "'float64'"),
            ('.float()', '.double()'))


def float64_copy(src, dst):
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns('__pycache__', 'build', '*.so'))
    for folder, _, files in os.walk(dst):
        for name in files:
            if name.endswith('.py'):
                path = os.path.join(folder, name)
                with open(path) as f:
                    text = f.read()
                for a, b in F64_SUBS:
                    text = text.replace(a, b)
                with open(path, 'w') as f:
                    f.write(text)


@pytest.fixture(scope='module')
def gaps(tmp_path_factory):
    root = tmp_path_factory.mktemp('float64')
    for package in ('tdgp', 'tdgp_torch'):
        float64_copy(os.path.join(ROOT, package), str(root / package))
    # one BLAS thread in the child, as in the port's other test modules
    env = dict(os.environ, PYTHONPATH=str(root), JAX_PLATFORMS='cpu', OPENBLAS_NUM_THREADS='1')
    run = subprocess.run([sys.executable, os.path.abspath(__file__), str(KIMG)], env=env,
                         capture_output=True, text=True, timeout=900)
    assert run.returncode == 0, run.stderr[-4000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert out['dtype'] == 'torch.float64' and out['draws_unused'] == []
    return out


@pytest.mark.parametrize('part', ['losses', 'g', 'd', 'r1', 'G', 'D', 'G_ema'])
def test_blur_on_step_in_float64(gaps, part):
    """Losses; the Gmain, Dmain and R1 gradients; G, D and the G EMA after the step."""
    assert gaps[part] <= TOL, f'{part}: {gaps[part]:.3g}'


# ---------------------------------------------------------- the child process


def _load_parity():
    """Turn on float64 in both frameworks, then load tests/test_torch_train_step.py."""
    import importlib.util

    import jax
    import torch

    jax.config.update('jax_enable_x64', True)
    torch.set_default_dtype(torch.float64)
    torch.set_num_threads(1)
    spec = importlib.util.spec_from_file_location(
        'train_step_parity', os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                          'test_torch_train_step.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def worst(pairs):
    """max |a - b| / max |b| over (port, jax) pairs of arrays."""
    scale = max(float(np.abs(b).max()) for _, b in pairs)
    return max(float(np.abs(a - b).max()) for a, b in pairs) / scale


def child_main(kimg):
    parity = _load_parity()
    stats, new_state, port_stats, trainer, draws = parity.run_step(int(kimg * 1000), np.float64)
    out = {'kimg': kimg, 'dtype': str(port_stats['_grads']['g'][next(iter(
        port_stats['_grads']['g']))].dtype), 'draws_unused': sorted(set(draws.values) - draws.used)}
    names = [k for k in stats if not k.startswith('_')]
    out['losses'] = max(abs(float(port_stats[k]) - float(stats[k])) / max(abs(float(stats[k])),
                                                                           1e-30) for k in names)
    for phase in ('g', 'd', 'r1'):
        flat = parity.flatten_tree({'params': stats['_debug'][f'{phase}_grads']})
        out[phase] = worst([(g.numpy(), parity._to_port_layout(name, flat[parity.flat_key(name)],
                                                                g.ndim))
                            for name, g in port_stats['_grads'][phase].items()])
    s = new_state
    trees = {'G': {'params': s.g_params, 'consts': s.g_consts, 'ema': s.g_ema_coll},
             'D': {'params': s.d_params},
             'G_ema': {'params': s.ema_params, 'consts': s.g_consts, 'ema': s.ema_ema_coll}}
    for module, tree in trees.items():
        flat = parity.flatten_tree(tree)
        out[module] = worst([(v.numpy(), parity._to_port_layout(name, flat[parity.flat_key(name)],
                                                                 v.ndim))
                             for name, v in getattr(trainer, module).state_dict().items()])
    print(json.dumps(out))


if __name__ == '__main__':
    child_main(float(sys.argv[1]))
