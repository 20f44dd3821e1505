"""One G+D step with the augment pipe on: the port's `Trainer.step` against
the JAX package's `make_train_step(controlled=True)` on `tiny_test_config`,
with `training.augment.mode=fixed` at p = 0.5 and the default group weights
(every geometric and colour group). The pipe runs in all three D passes
(Gmain, Dmain on the fakes and on the reals, R1), and its draws are the JAX
step's own, replayed (tests/test_torch_train_step.py `step_draws`). Held at
the step test's limits: losses rtol = atol = 1e-4, gradients and parameters
rtol = 1e-4 and atol = 1e-4 x the largest of the phase or module.
"""
import pytest
import torch
from threadpoolctl import threadpool_limits

from test_torch_train_step import CUR_NIMG, PARTS, check_part, run_step


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
def ada_steps():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return run_step(CUR_NIMG, overrides=('training.augment.mode=fixed',), ada_p=0.5)
    finally:
        torch.set_num_threads(saved)


@pytest.mark.parametrize('part', PARTS)
def test_step_with_ada(ada_steps, part):
    check_part(ada_steps, part)
