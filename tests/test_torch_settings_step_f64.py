"""Step B of the settings with `hybrid` cameras as well, in float64: the
port's step against the JAX package's `make_train_step(controlled=True)`.

At float32 this step (the mip marcher, a 3-layer tri-plane MLP,
`architecture: orig`, G's clip above the gradient's norm, Dmain on fresh
fakes, and `hybrid` origin angles) misses the 1e-4 limit of
tests/test_torch_settings_step.py on one parameter, D's Dmain gradient of
`b32.conv0.bias` (about 2x), while the fresh fakes agree to ~1e-5 and each
pair of step B's settings with `hybrid` holds at ~0.01 of the limits; so
the settings are held at float32 in two steps, `hybrid` in step A. Run in
float64 the combined step agrees on every part: the packages compute the
same function, and the float32 gap is rounding that the step amplifies.

Both packages are copied into float64 as tests/test_torch_train_step_f64.py
copies them (the repo's files are not touched), and the step runs in a
child process with JAX's float64 on: this file run as a script,

    PYTHONPATH=<float64 copies> python tests/test_torch_settings_step_f64.py

which prints, as one JSON object, the largest |port - jax| of each gradient
phase, each module after the step and G's Adam moments over the largest
|jax| there, and for 'losses' the largest relative difference of a loss.

Tolerance: 1e-10 x the largest magnitude of each part (relative for the
losses), as in tests/test_torch_train_step_f64.py; the worst reading is
~5e-14 (the R1 gradient).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_train_step_f64 import ROOT, TOL, float64_copy, readings, worst


@pytest.fixture(scope='module')
def gaps(tmp_path_factory):
    root = tmp_path_factory.mktemp('float64')
    for package in ('tdgp', 'tdgp_torch'):
        float64_copy(os.path.join(ROOT, package), str(root / package))
    env = dict(os.environ, PYTHONPATH=str(root), JAX_PLATFORMS='cpu', OPENBLAS_NUM_THREADS='1')
    run = subprocess.run([sys.executable, os.path.abspath(__file__)], env=env,
                         capture_output=True, text=True, timeout=900)
    assert run.returncode == 0, run.stderr[-4000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert out['dtype'] == 'torch.float64' and out['draws_unused'] == []
    return out


@pytest.mark.parametrize('part', ['losses', 'g', 'd', 'r1', 'G', 'D', 'G_ema', 'g_adam'])
def test_step_b_with_hybrid_in_float64(gaps, part):
    """Losses; the Gmain, Dmain and R1 gradients; G, D and the G EMA after
    the step; G's Adam moments."""
    assert gaps[part] <= TOL, f'{part}: {gaps[part]:.3g}'


# ---------------------------------------------------------- the child process


def child_main():
    import jax
    import torch

    jax.config.update('jax_enable_x64', True)
    torch.set_default_dtype(torch.float64)
    torch.set_num_threads(1)
    import test_torch_settings_step as settings
    from test_torch_settings_step_fresh import STEP_B

    steps = settings.run(STEP_B + settings.HYBRID, np.float64)
    out = readings(settings, steps)
    after, trainer = steps[1], steps[3]
    adam = settings.adam_state(after.g_opt)
    pairs = {}
    for moment, key in ((adam.mu, 'exp_avg'), (adam.nu, 'exp_avg_sq')):
        flat = settings.flatten_tree({'params': moment})
        pairs[key] = [(trainer.g_opt.state[p][key].numpy(),
                       settings._to_port_layout(name, flat[settings.flat_key(name)], p.ndim))
                      for name, p in trainer.G.named_parameters()]
    out['g_adam'] = max(worst(p) for p in pairs.values())
    print(json.dumps(out))


if __name__ == '__main__':
    child_main()
