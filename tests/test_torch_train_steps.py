"""Several consecutive G+D steps: the port's `Trainer.step` against the JAX
package's `make_train_step(controlled=True)`, K = 4 steps of
`tiny_test_config` (D at float32, as in tests/test_torch_train_step.py)
with `loss.r1_interval=2`, so that steps 0 and 2 take R1 (the loop's
cadence, `batch_idx % r1_interval == 0`) and D's Adam has the lazy
regularization ratio 2/3 folded in; with reused and with fresh Dmain fakes
(`training.dmain_reuse_fakes=false`). A slow variant takes 10 steps.

Both start from the same weights (`load_train_state`); each step gets a
new batch and new controlled generator inputs from numpy seed k + 1, the
schedules at 300 kimg + k x N images, a new key 1000 + k, and the port
every draw of the JAX step from that key (`step_draws`). Both cut the real
patches with their own `extract_patches`: the port places the sample
positions as XLA does in JAX's jitted step (`utils.xla_float`: its
`linspace_row` and one rounding of (row + 1) x scale - 1) and sums the
bilinear corners as XLA contracts them, so its patches are JAX's bit for
bit. With `torch.linspace`'s positions, up
to three float32 ulps from JAX's, a pixel moves by ~1.5e-5 and, once
`scalar_enc` has trained, D's gradient by ~7.5e-4
(`test_own_patches_miss_the_step_limit`).

Two holds:
- each step alone, the port started from JAX's state before it (weights
  and Adam's moments), at the one-step limits (1e-4; a mutation witness:
  `torch.linspace`'s patch positions miss it at step 1);
- the K steps run freely in both packages: after every step the losses, G,
  D and G_ema are compared. A module's distance is the L2 norm of port -
  JAX over all its parameters and buffers, over the L2 norm of how far JAX
  moved them since the start (a share of the training motion). The limit
  is SPREAD_MULTIPLE x the one-ulp spread measured here: each package run
  again from weights each moved by one float32 ulp (`np.nextafter` toward
  +inf), its distance to its own unmoved run after step k, the larger of
  the two packages'. From step 2 on the port's own spread is ~4x JAX's:
  a lrelu input within ~3e-5 of zero changes side between the two runs
  (a few of ~1e5 per layer), and the gradient with it; JAX's trajectory
  happens to pass fewer such points. Mutation witness: the port with D's
  lazy-regularization ratio left out of its Adam misses the limit.
"""
import functools
from unittest import mock

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax

from tdgp.config import tiny_test_config as jax_tiny
from tdgp.infra.experiment import apply_overrides as jax_apply_overrides
from tdgp.training import train_step as jts
from tdgp.training.schedules import compute_schedules as jax_schedules
from tdgp_torch.config import apply_overrides, tiny_test_config
from tdgp_torch.training import patch as port_patch
from tdgp_torch.training.schedules import compute_schedules
from tdgp_torch.training.train_step import make_optimizers
from tdgp_torch.weights import _to_port_layout, flat_from_module, flat_key, flatten_tree

from test_torch_train_step import (CUR_NIMG, N, PARTS, check_part, fp32_d, jax_state,
                                   make_inputs, port_trainer, replay)

OVERRIDES = ('loss.r1_interval=2',)
FRESH = ('training.dmain_reuse_fakes=false',)
K, K_LONG = 4, 10  # steps of the hold (R1 at 0 and 2), and of its slow variant
SPREAD_MULTIPLE = 3  # the port's distance to JAX over the one-ulp spread
MODULES = ('G', 'D', 'G_ema')


@pytest.fixture(scope='module', autouse=True)
def _one_thread_per_worker():
    """One torch and one BLAS thread while this module runs: the test workers
    share the cores, and OpenBLAS's threads spin while the others hold them."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api='blas'):
        yield
    torch.set_num_threads(saved)


def module_trees(state):
    """The JAX state's G, D and G_ema as flat {'col/a/b': array}."""
    return {'G': flatten_tree({'params': state.g_params, 'consts': state.g_consts,
                               'ema': state.g_ema_coll}),
            'D': flatten_tree({'params': state.d_params}),
            'G_ema': flatten_tree({'params': state.ema_params, 'consts': state.g_consts,
                                   'ema': state.ema_ema_coll})}


def port_trees(trainer):
    """Copies of the port's G, D and G_ema in the JAX layout."""
    return {name: flat_from_module(getattr(trainer, name)) for name in MODULES}


def distance(a, b, start):
    """||a - b|| over ||b - start|| across every array of a module."""
    keys = sorted(b)
    diff = np.sqrt(sum(np.sum((np.asarray(a[k], np.float64) - b[k]) ** 2) for k in keys))
    moved = np.sqrt(sum(np.sum((np.asarray(b[k], np.float64) - start[k]) ** 2) for k in keys))
    return float(diff / moved)


def one_ulp(state):
    """Every float32 weight of the state moved by one ulp toward +inf (the
    optimizer's moments stay at zero)."""
    up = lambda t: jax.tree.map(lambda a: np.nextafter(a, np.float32(np.inf)), t)  # noqa: E731
    return state.replace(g_params=up(state.g_params), d_params=up(state.d_params),
                         ema_params=up(state.ema_params))


def torch_linspace_row(resolution, device=None):
    """Mutation: the patch row of `torch.linspace`, the port's before it
    placed JAX's positions."""
    return torch.linspace(-1.0, 1.0, resolution, device=device)


def load_adam(opt, module, adam_state):
    """The moments and count of an optax Adam state into a torch Adam over
    `module`'s parameters."""
    adam = adam_state[0]
    moments = [flatten_tree({'params': jax.device_get(m)}) for m in (adam.mu, adam.nu)]

    def port(name, flat, ndim):
        return torch.from_numpy(np.array(_to_port_layout(name, flat[flat_key(name)], ndim)))

    for name, p in module.named_parameters():
        opt.state[p] = {'step': torch.tensor(float(adam.count)),
                        'exp_avg': port(name, moments[0], p.ndim),
                        'exp_avg_sq': port(name, moments[1], p.ndim)}


class Run:
    """The configs, starting state, jitted steps and per-step inputs of a hold."""

    def __init__(self, overrides, steps):
        self.jcfg = jax_apply_overrides(fp32_d(jax_tiny()), overrides)
        self.cfg = apply_overrides(fp32_d(tiny_test_config()), overrides)
        self.state, G, D = jax_state(self.jcfg)
        self.state = jax.device_get(self.state)
        self.jax_steps = {r1: jax.jit(functools.partial(
            jts.make_train_step(self.jcfg, G, D, controlled=True), do_r1=r1))
            for r1 in (False, True)}
        self.inputs = []
        for k in range(steps):
            cur_nimg = CUR_NIMG + k * N
            jsched = jax_schedules(self.jcfg, cur_nimg)
            jb, pb = make_inputs(self.jcfg, jsched, seed=k + 1)
            self.inputs.append((jsched, compute_schedules(self.cfg, cur_nimg), jb, pb,
                                jax.random.PRNGKey(1000 + k),
                                k % self.cfg.loss.r1_interval == 0))

    def jax(self, state):
        """-> [(losses, module trees, the state before the step, the step's
        stats, the state after it)] per step."""
        out = []
        for jsched, _, jb, _, rng, do_r1 in self.inputs:
            new, stats = jax.device_get(self.jax_steps[do_r1](state, jb, rng, jsched))
            out.append(({k: float(v) for k, v in stats.items() if not k.startswith('_')},
                        module_trees(new), state, stats, new))
            state = new
        return out

    def port(self, state, mutate=None):
        """-> [(losses, module trees)] after each step of the port from
        `state`, and the draws left unused; `mutate(trainer)` changes the
        trainer before the first step."""
        trainer = port_trainer(self.cfg, state)
        if mutate is not None:
            mutate(trainer)
        out, unused = [], set()
        for jsched, sched, _, pb, rng, do_r1 in self.inputs:
            draws = replay(self.jcfg, rng, jsched)
            stats = trainer.step(pb, sched, do_r1, draws)
            unused |= set(draws.values) - draws.used
            out.append(({k: float(v) for k, v in stats.items()}, port_trees(trainer)))
        return out, unused

    def port_from_jax(self, k, ref, torch_linspace=False):
        """Step k of the port from JAX's state before it, Adam's moments
        included, with `torch.linspace`'s patch positions if `torch_linspace`
        -> `run_step`'s tuple (JAX stats, JAX new state, port stats, port
        trainer, draws)."""
        jsched, sched, _, pb, rng, do_r1 = self.inputs[k]
        _, _, before, stats, new = ref[k]
        trainer = port_trainer(self.cfg, before)
        load_adam(trainer.g_opt, trainer.G, before.g_opt)
        load_adam(trainer.d_opt, trainer.D, before.d_opt)
        draws = replay(self.jcfg, rng, jsched)
        with mock.patch.object(port_patch, 'linspace_row',
                               torch_linspace_row if torch_linspace else port_patch.linspace_row):
            port_stats = trainer.step(pb, sched, do_r1, draws, return_grads=True)
        return stats, new, port_stats, trainer, draws


def distances(run, got, ref):
    """Per step: {module: distance, 'losses': the largest |got - ref| of a loss}."""
    start = module_trees(run.state)
    rows = []
    for (g_loss, g_trees), (r_loss, r_trees) in zip(got, [r[:2] for r in ref]):
        assert set(g_loss) == set(r_loss)
        row = {m: distance(g_trees[m], r_trees[m], start[m]) for m in MODULES}
        row['losses'] = max(abs(g_loss[k] - r_loss[k]) for k in r_loss)
        rows.append(row)
    return rows


def distance_or_loss(a, b, key, run):
    """`distances`' reading `key` of the port run `a` against the port run `b`."""
    if key == 'losses':
        return max(abs(a[0][k] - b[0][k]) for k in b[0])
    return distance(a[1][key], b[1][key], module_trees(run.state)[key])


@functools.lru_cache(maxsize=None)
def hold(fresh, steps=K):
    """-> (the run, JAX's steps, and per step the distances to JAX of the
    port, of the one-ulp spread and of the mutation; the draws the port
    left unused)."""
    run = Run(OVERRIDES + (FRESH if fresh else ()), steps)
    ref = run.jax(run.state)
    port, unused = run.port(run.state)
    moved = one_ulp(run.state)
    jax_spread = distances(run, [r[:2] for r in run.jax(moved)], ref)
    port_moved, _ = run.port(moved)
    port_spread = [{k: distance_or_loss(a, b, k, run) for k in ('G', 'D', 'G_ema', 'losses')}
                   for a, b in zip(port_moved, port)]
    spread = [{k: max(j[k], p[k]) for k in j} for j, p in zip(jax_spread, port_spread)]

    def no_lazy_ratio(trainer):  # D's Adam without r1_interval / (r1_interval + 1)
        cfg = apply_overrides(run.cfg, ['loss.r1_gamma=0'])
        trainer.d_opt = make_optimizers(cfg, trainer.G, trainer.D)[1]

    mutation, _ = run.port(run.state, no_lazy_ratio)
    return (run, ref, distances(run, port, ref), spread, distances(run, mutation, ref),
            unused, jax_spread, port_spread)


@functools.lru_cache(maxsize=None)
def step_from_jax(fresh, k):
    """Step k of the port from JAX's state before it (`Run.port_from_jax`),
    run once for every part held on it."""
    run, ref = hold(fresh)[:2]
    return run.port_from_jax(k, ref)


def over_limit(got, spread):
    """The largest share of its limit that a step's reading takes."""
    return max(g[k] / (SPREAD_MULTIPLE * w[k]) for g, w in zip(got, spread) for k in g)


def report(port, spread, jax_spread, port_spread):
    for k, (p, w, j, q) in enumerate(zip(port, spread, jax_spread, port_spread)):
        print(f'step {k}: ' + ', '.join(f'{m} {p[m]:.3g} (spread {w[m]:.3g}: JAX {j[m]:.3g}, '
                                        f'port {q[m]:.3g})' for m in p))


@pytest.mark.parametrize('fresh', [False, True], ids=['reused_fakes', 'fresh_fakes'])
def test_steps_hold_within_the_one_ulp_spread(fresh):
    _, _, port, spread, _, unused, jax_spread, port_spread = hold(fresh)
    report(port, spread, jax_spread, port_spread)
    assert not unused
    assert over_limit(port, spread) <= 1.0


@pytest.mark.parametrize('fresh', [False, True], ids=['reused_fakes', 'fresh_fakes'])
def test_steps_without_the_lazy_ratio_miss_the_limit(fresh):
    _, _, _, spread, mutation, _, _, _ = hold(fresh)
    print('mutation over its limit per step:',
          [f'{over_limit([m], [w]):.3g}' for m, w in zip(mutation, spread)])
    assert over_limit(mutation, spread) > 1.0


@pytest.mark.parametrize('part', PARTS)
@pytest.mark.parametrize('fresh', [False, True], ids=['reused_fakes', 'fresh_fakes'])
def test_each_step_from_the_jax_state(fresh, part):
    """Each of the K steps, the port started from JAX's state before it
    (weights and Adam's moments), held at the one-step limits of
    tests/test_torch_train_step.py: every draw, the losses, each phase's
    gradients (R1's on its steps) and the modules after the step."""
    run = hold(fresh)[0]
    for k in range(K):
        if part != 'r1' or run.inputs[k][-1]:
            check_part(step_from_jax(fresh, k), part)


def test_own_patches_miss_the_step_limit():
    """Mutation witness of the patch positions: with `torch.linspace`'s
    row, up to three ulps from JAX's, step 1's Dmain gradient misses the
    one-step limit that the port's own positions hold."""
    run, ref = hold(False)[:2]
    check_part(step_from_jax(False, 1), 'd')
    with pytest.raises(AssertionError):
        check_part(run.port_from_jax(1, ref, torch_linspace=True), 'd')


@pytest.mark.slow
@pytest.mark.parametrize('fresh', [False, True], ids=['reused_fakes', 'fresh_fakes'])
def test_long_hold_within_the_one_ulp_spread(fresh):
    _, _, port, spread, mutation, unused, jax_spread, port_spread = hold(fresh, K_LONG)
    report(port, spread, jax_spread, port_spread)
    assert not unused
    assert over_limit(port, spread) <= 1.0 < over_limit(mutation, spread)
