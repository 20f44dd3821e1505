"""Step B of tests/test_torch_settings_step.py: one G+D step with R1 and the
mip marcher, a 3-layer tri-plane MLP, `architecture: orig`, G's gradient
clip at a norm above the gradient's (no clip) and Dmain on fresh fakes
(their render without gradients: the mip march, merged by
`unify_samples_sorted`, and the 3-layer MLP as its layers), against the JAX
package's `make_train_step(controlled=True)` at the one-step limits, G's
Adam moments included.
"""
import pytest
import torch
from threadpoolctl import threadpool_limits

from test_torch_settings_step import check_g_adam, run
from test_torch_train_step import PARTS, check_part

STEP_B = ('generator.ray_marcher_type=mip', 'generator.tri_plane.mlp.n_layers=3',
          'generator.architecture=orig', 'training.g_optim.grad_clip=1000.0',
          'training.dmain_reuse_fakes=false')


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
def step_b():
    return run(STEP_B)


@pytest.mark.parametrize('part', PARTS + ['g_adam'])
def test_step_b_mip_three_layers_orig_fresh(step_b, part):
    if part == 'g_adam':
        check_g_adam(step_b)
    else:
        check_part(step_b, part)


def test_the_clip_leaves_step_b_alone(step_b):
    """Below the threshold the clip's factor is 1 and the update is Adam's
    on the scrubbed gradient."""
    (factor,) = step_b[2]['_g_clip']
    assert float(factor) == 1.0


def test_the_settings_reach_step_b(step_b):
    _, _, _, trainer, _ = step_b
    assert trainer.G.synthesis.tri_plane_mlp.n_layers == 3
    assert trainer.G.synthesis.tri_plane_mlp.mip
    assert trainer.G_fake is trainer.G and not trainer.cfg.training.dmain_reuse_fakes
