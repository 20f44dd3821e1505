"""Path-length regularization of the 3DGP model with Dmain's fresh fakes, the
mip marcher and a 3-layer tri-plane MLP together: JAX's R1 + PL step
against the port's, held as tests/test_torch_pl3d.py holds the default
step (its machinery; a file of its own so that the two compiled JAX steps
run in different test workers). No new kernel runs here: the mip march and
the layers are PyTorch ops, the fresh fakes' render records nothing. About
100 s alone with the tier-1 command's flags (ROADMAP).
"""
import pytest
import torch
from threadpoolctl import threadpool_limits

from test_torch_pl3d import PL, PL_PARTS, check_pl_part, run_pl

MIXED = PL + ('training.dmain_reuse_fakes=false', 'generator.ray_marcher_type=mip',
              'generator.tri_plane.mlp.n_layers=3')


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
def mixed_step():
    return run_pl(MIXED)


@pytest.mark.parametrize('part', PL_PARTS)
def test_r1_and_pl_step_fresh_fakes_mip_three_layers(mixed_step, part):
    """Every draw replayed, the losses, the gradients of Gmain, PL, Dmain and
    R1, `pl_mean`, and the modules after the step, at 1e-4."""
    check_pl_part(mixed_step, part)
