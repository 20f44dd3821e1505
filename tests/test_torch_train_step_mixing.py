"""Style mixing on the 3DGP model: one G+D step of `tiny_test_config` (D at
float32) with `loss.style_mixing_prob=0.5`, the port's `Trainer.step` against
the JAX package's `make_train_step(controlled=True)`, as
tests/test_torch_train_step.py holds the step without it (the 3DGP
counterpart of tests/test_train_extras.py's step with ADA and PL, without
PL, which the port refuses on the 3DGP model).

Every draw of the JAX step is replayed (`step_draws`), and the style-mixing
draws of each G forward ('gmain/<i>/mix/cutoff', 'mix/p', 'mix/z2') are
recomputed from its key as `tdgp.training.losses.g_forward` splits it. The
step's key (10) mixes in Gmain (p 0.255 < 0.5). Held at the one-step limits:
every draw, the losses, each phase's gradients and the modules after the
step. Mutation witness: one cutoff per sample misses Gmain's gradient.
"""
import dataclasses

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax

from tdgp.models.stylegan2 import sg2_num_ws

from tdgp_torch.training import losses
from tdgp_torch.utils.draws import Replay

from test_torch_stylegan2 import T, per_sample_mix
from test_torch_train_step import (CUR_NIMG, N, PARTS, check_gradients, check_part, port_step,
                                   run_setup, setup_step, step_draws)

MIX = ('loss.style_mixing_prob=0.5',)
KEY = 10


@pytest.fixture(scope='module', autouse=True)
def _one_thread_per_worker():
    """One torch and one BLAS thread while this module runs: the test workers
    share the cores, and OpenBLAS's threads spin while the others hold them."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api='blas'):
        yield
    torch.set_num_threads(saved)


def mixing_draws(cfg, rng):
    """The style-mixing draws of the step's Gmain forward ('gmain/0/mix/...'),
    from its key as `g_forward` splits it (its sixth key)."""
    kf = jax.random.fold_in(jax.random.split(rng, 8)[2], 0)
    k_cut, k_p, k_z2 = jax.random.split(jax.random.split(kf, 6)[5], 3)
    num_ws = sg2_num_ws(0, cfg.generator.tri_plane.res)  # the tri-plane decoder's
    return {'gmain/0/mix/cutoff': T(jax.random.randint(k_cut, (), 1, num_ws)),
            'gmain/0/mix/p': T(jax.random.uniform(k_p, ())),
            'gmain/0/mix/z2': T(jax.random.normal(k_z2, (N, cfg.generator.z_dim)))}


@pytest.fixture(scope='module')
def mix_setup():
    return dataclasses.replace(setup_step(CUR_NIMG, overrides=MIX), rng=jax.random.PRNGKey(KEY))


def replay_with_mixing(s):
    return Replay({**step_draws(s.jcfg, s.rng, s.jsched), **mixing_draws(s.jcfg, s.rng)})


@pytest.fixture(scope='module')
def mix_steps(mix_setup):
    from unittest import mock
    import test_torch_train_step
    with mock.patch.object(test_torch_train_step, 'replay',
                           lambda jcfg, rng, jsched: replay_with_mixing(mix_setup)):
        return run_setup(mix_setup)


@pytest.mark.parametrize('part', PARTS)
def test_style_mixing_step(mix_steps, part):
    if part == 'draws':
        draws = mix_steps[4]
        assert float(draws.values['gmain/0/mix/p']) < 0.5, 'the step does not mix'
    check_part(mix_steps, part)


def test_per_sample_cutoff_misses(mix_setup, mix_steps, monkeypatch):
    """Mutation witness: one style-mixing cutoff per sample misses Gmain's
    gradient."""
    from unittest import mock
    import test_torch_train_step
    monkeypatch.setattr(losses, 'mix_styles', per_sample_mix)
    with mock.patch.object(test_torch_train_step, 'replay',
                           lambda jcfg, rng, jsched: replay_with_mixing(mix_setup)):
        mutated = mix_steps[:2] + port_step(mix_setup)
    check_gradients(mix_steps, 'g')
    with pytest.raises(AssertionError):
        check_gradients(mutated, 'g')
    assert np.isfinite(float(mutated[2]['Loss/G/loss']))
