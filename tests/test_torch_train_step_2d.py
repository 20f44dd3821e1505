"""The 2D StyleGAN2 baseline's G+D step: the port's `Trainer.step` against the
JAX package's `make_train_step(controlled=True)` on `tiny_2d_config`
(tests/test_torch_stylegan2.py; batch 4, 16^2 patches of 32^2 images, style
mixing p 0.5, path-length weight 2, R1 gamma 0.1), float32 first:

- step 0, a plain step, both packages from the same weights
  (`load_train_state`, `pl_mean` 0, Adam at zero); step 1, R1 + PL, the port
  started from JAX's state after step 0 (weights, `pl_mean` and Adam's
  moments and count, as tests/test_torch_train_steps.py loads them);
- every draw of the JAX step recomputed from its key and replayed into the
  port: the generator inputs, Gmain's and Dmain's fresh fakes ('gmain/0/...',
  'dmain/0/...': patches, noise, the style-mixing cutoff, p and z2), and PL's
  ('pl/patch', 'pl/noise/...', 'pl/pl_noise', from one key as JAX draws
  them). The key of step 1 mixes styles in Gmain (p < 0.5).

Held at the one-step limits of tests/test_torch_train_step.py: the losses at
rtol = atol = 1e-4; each phase's gradients (Gmain 'g', PL 'pl', Dmain 'd',
R1 'r1') at rtol 1e-4 and atol 1e-4 x the phase's largest; G, D and G_ema
after the step, `pl_mean`, and both Adams' moments and counts after the
step (G's count moves twice on a PL step: JAX's `g_tx.update` runs twice).
JAX's PL gradient is read where the step hands it to G's Adam (a
`jax.debug.callback` in a wrapped `make_optimizers`). Mutation witnesses on
step 1, each missing its limit: the PL phase without its second Adam update
(G's Adam moments and count; G's own limit, 1e-4 x its largest weight, a
mapping weight of ~100, cannot see one Adam step of 0.0025), Dmain on
Gmain's reused fakes (Dmain's gradient; JAX never reuses 2D fakes), and
style mixing with a per-sample cutoff (Gmain's gradient).

At the model's own precision (G's blocks 8-32 and D's 16 and 8 in bf16) an
R1 + PL step is held as tests/test_torch_train_step.py holds the 3DGP step,
each limit a share of the bf16 floor (JAX's step in bf16 against JAX's in
float32), with both learning rates 0, so that every phase sees the starting
weights in both packages (a factor on JAX's Adam updates that its compiled
step takes as an input, so that the floor's float32 end runs on the float32
hold's compiled step). With them on, Adam's first step moves each weight
by +-lr whatever its gradient's size, so a gradient element near zero that
rounds to the other sign moves a weight by 2 lr and the later phases start
apart: D's and R1's conv weights then read 1.5-4.3 of the floor, and JAX
against itself with its convolutions taken as the port's CPU route 1.3-6.4.
The float32 port against JAX's bf16 step is the mutation witness. Gmain and
R1 in the step are held within JAX's own spread when its convolutions are
taken as the port's CPU route takes them, Gmain also given JAX's fakes.
"""
import dataclasses
import re
from unittest import mock

import numpy as np
import optax
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

import tdgp.config as jc
from tdgp.config import asdict
from tdgp.rendering.camera import sample_camera_params as jax_sample_camera
from tdgp.training import train_step as jts
from tdgp.training.patch import sample_patch_params as jax_patch_params
from tdgp.training.schedules import compute_schedules as jax_schedules

from tdgp_torch.training import losses
from tdgp_torch.training import train_step
from tdgp_torch.training.schedules import compute_schedules
from tdgp_torch.training.train_step import Trainer
from tdgp_torch.utils.draws import Replay
from tdgp_torch.weights import _to_port_layout, flat_key, flatten_tree, load_train_state

from test_torch_stylegan2 import (T, forward_2d_draws, noise_draws, per_sample_mix,
                                  tiny_2d_config)
from test_torch_train_step import _f32_conv, _rel, port_cam
from test_torch_train_steps import load_adam

N = 4
CUR_NIMG = 300_000
KEYS = (6, 5)  # the keys of steps 0 (plain) and 1 (R1 + PL); key 5 mixes in Gmain


@pytest.fixture(scope='module', autouse=True)
def _one_thread_per_worker():
    """One torch and one BLAS thread while this module runs: the test workers
    share the cores, and OpenBLAS's threads spin while the others hold them."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api='blas'):
        yield
    torch.set_num_threads(saved)


def make_inputs(jcfg, jsched, seed):
    """A batch of N with the controlled generator inputs and the real
    patches' parameters -> (the JAX batch, the port's: no depth, no labels)."""
    rs = np.random.RandomState(seed)
    gc = jcfg.generator
    batch = dict(img=rs.uniform(-1, 1, (N, 32, 32, 3)).astype(np.float32),
                 c=np.zeros((N, 0), np.float32),
                 camera_angles=np.concatenate([rs.uniform(0.5, 1.5, (N, 2)),
                                               np.zeros((N, 1))], 1).astype(np.float32),
                 embs=rs.randn(N, 8).astype(np.float32),
                 gen_z_g=rs.randn(N, gc.z_dim).astype(np.float32),
                 gen_z_d=rs.randn(N, gc.z_dim).astype(np.float32))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb['depth'] = jnp.zeros((N, 32, 32, 1))  # the JAX step reads it, and drops it
    jb['sample_idx'] = jnp.arange(N, dtype=jnp.int32)
    ks = jax.random.split(jax.random.PRNGKey(42 + seed), 3)
    jb['gen_cam_g'] = jax_sample_camera(ks[0], asdict(jcfg.camera), N)
    jb['gen_cam_d'] = jax_sample_camera(ks[1], asdict(jcfg.camera), N)
    pp = jax_patch_params(ks[2], N, gc.patch, min_scale=jsched.patch_min_scale,
                          beta=jsched.patch_beta)
    jb['real_pp_scales'], jb['real_pp_offsets'] = pp['scales'], pp['offsets']
    pb = {k: T(v) for k, v in batch.items()}
    pb.update(gen_cam_g=port_cam(jb['gen_cam_g']), gen_cam_d=port_cam(jb['gen_cam_d']),
              real_pp_scales=T(pp['scales']), real_pp_offsets=T(pp['offsets']))
    return jb, pb


def step_draws(cfg, rng, sched, do_r1):
    """Every draw of the JAX 2D step from `rng`, under the port's names."""
    k_gen_g, k_gen_d, k_gfwd, k_dfwd, _, _, _, k_pl = jax.random.split(rng, 8)
    values = {'gen_g/spoof': T(jax.random.uniform(jax.random.split(k_gen_g, 4)[3], (N,))),
              'gen_d/spoof': T(jax.random.uniform(jax.random.split(k_gen_d, 4)[3], (N,)))}
    values.update(forward_2d_draws(cfg, jax.random.fold_in(k_gfwd, 0), N, sched, 'gmain/0/'))
    k_dg = jax.random.split(k_dfwd, 3)[0]
    values.update(forward_2d_draws(cfg, jax.random.fold_in(k_dg, 0), N, sched, 'dmain/0/'))
    if do_r1 and cfg.loss.pl_weight > 0:
        gc = cfg.generator
        n_pl = N // cfg.loss.pl_batch_shrink
        k_pl_fwd, k_pl_noise = jax.random.split(k_pl)
        pp = jax_patch_params(k_pl_fwd, n_pl, gc.patch, min_scale=sched.patch_min_scale,
                              beta=sched.patch_beta)
        values['pl/patch'] = {k: T(v) for k, v in pp.items()}
        values.update(noise_draws(k_pl_fwd, n_pl, gc.img_resolution, 'pl/'))
        res = gc.patch.resolution
        values['pl/pl_noise'] = T(jax.random.normal(k_pl_noise, (n_pl, res, res, 3)))
    return values


def recorded_and_scaled(record, lr_scale):
    """`jts.make_optimizers` whose G transform hands every gradient it
    updates with to `record` (Gmain's, then PL's), and whose two
    transforms multiply their updates by the traced `lr_scale` (1, or 0 for
    learning rates 0), so that one compiled step serves both."""
    real = jts.make_optimizers

    def scaled(tx, record=None):
        def update(grads, state, params=None):
            if record is not None:
                jax.debug.callback(record, grads, ordered=True)
            updates, state = tx.update(grads, state, params)
            return jax.tree_util.tree_map(lambda u: u * lr_scale, updates), state

        return optax.GradientTransformation(tx.init, update)

    def make(cfg):
        g_tx, d_tx = real(cfg)
        return scaled(g_tx, record), scaled(d_tx)

    return make


@dataclasses.dataclass
class Step:
    """One step of both packages: JAX's stats (with '_debug' and the
    recorded G gradients under 'g_updates'), its state before and after,
    the port's stats, trainer and draws."""
    stats: dict
    before: object
    after: object
    port: dict
    trainer: object
    draws: object


def port_step(cfg, jcfg, state, pb, rng, jsched, sched, do_r1, adam=False, mutate=None):
    trainer = Trainer(cfg, 'cpu')
    s = jax.device_get(state)
    load_train_state(trainer, s.g_params, s.g_consts, s.g_ema_coll, s.d_params, s.ema_params,
                     s.ema_ema_coll, s.pl_mean)
    if adam:
        load_adam(trainer.g_opt, trainer.G, s.g_opt)
        load_adam(trainer.d_opt, trainer.D, s.d_opt)
    if mutate is not None:
        mutate(trainer)
    draws = Replay(step_draws(jcfg, rng, jsched, do_r1))
    return trainer.step(pb, sched, do_r1, draws, return_grads=True), trainer, draws


class Hold:
    """The configs, JAX models, starting state, per-step inputs and JAX's
    compiled steps (one with R1 + PL, one without)."""

    def __init__(self, fp32=True):
        self.jcfg, self.cfg = tiny_2d_config(jc, fp32), tiny_2d_config(fp32=fp32)
        self.state, self.G, self.D = jts.create_train_state(self.jcfg, seed=0, local_batch=N)
        self.state = jax.device_get(self.state)
        self.jsched = jax_schedules(self.jcfg, CUR_NIMG)
        self.sched = compute_schedules(self.cfg, CUR_NIMG)
        self.inputs = [make_inputs(self.jcfg, self.jsched, k) for k in (1, 2)]
        self.compiled, self.seen = {}, []

    def jax_step(self, state, jb, rng, do_r1, lr_scale):
        if do_r1 not in self.compiled:
            def step(st, b, r, sc, scale):
                with mock.patch.object(jts, 'make_optimizers',
                                       recorded_and_scaled(self.seen.append, scale)):
                    return jts.make_train_step(self.jcfg, self.G, self.D, controlled=True)(
                        st, b, r, sc, do_r1=do_r1)
            self.compiled[do_r1] = jax.jit(step)
        self.seen.clear()
        new, stats = jax.device_get(self.compiled[do_r1](state, jb, rng, self.jsched,
                                                         np.float32(lr_scale)))
        jax.effects_barrier()
        stats['g_updates'] = list(self.seen)
        return new, stats

    def run(self, k, state, do_r1, adam=False, mutate=None, jax_out=None, lr_zero=False):
        """Step `k` of both packages from `state`; `lr_zero`: both learning
        rates 0, so that every phase sees `state`'s weights."""
        jb, pb = self.inputs[k]
        rng = jax.random.PRNGKey(KEYS[k])
        new, stats = jax_out or self.jax_step(state, jb, rng, do_r1, 0.0 if lr_zero else 1.0)
        cfg = with_lr(self.cfg, 0.0) if lr_zero else self.cfg
        port = port_step(cfg, self.jcfg, state, pb, rng, self.jsched, self.sched, do_r1,
                         adam, mutate)
        return Step(stats, state, new, *port)


def with_lr(cfg, lr):
    """`cfg` with both optimizers' learning rate `lr`."""
    t = cfg.training
    return dataclasses.replace(cfg, training=dataclasses.replace(
        t, g_optim=dataclasses.replace(t.g_optim, lr=lr),
        d_optim=dataclasses.replace(t.d_optim, lr=lr)))


@pytest.fixture(scope='module')
def hold():
    return Hold()


@pytest.fixture(scope='module')
def steps(hold):
    """Step 0 (plain) from the start, step 1 (R1 + PL) from JAX's state after it."""
    first = hold.run(0, hold.state, False)
    return first, hold.run(1, first.after, True, adam=True)


def jax_grads(step, phase):
    if phase == 'pl':
        return flatten_tree({'params': step.stats['g_updates'][1]})
    return flatten_tree({'params': step.stats['_debug'][f'{phase}_grads']})


def check_gradients(step, phase):
    flat = jax_grads(step, phase)
    scale = max(float(np.abs(v).max()) for v in flat.values())
    port = step.port['_grads'][phase]
    assert len(port) == len(flat)
    for name, g in port.items():
        ref = _to_port_layout(name, flat[flat_key(name)], g.ndim)
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4, atol=1e-4 * scale, err_msg=name)


def module_tree(state, module):
    return flatten_tree({
        'G': {'params': state.g_params, 'consts': state.g_consts, 'ema': state.g_ema_coll},
        'D': {'params': state.d_params},
        'G_ema': {'params': state.ema_params, 'consts': state.g_consts,
                  'ema': state.ema_ema_coll}}[module])


def check_module(step, module):
    flat = module_tree(step.after, module)
    scale = max(float(np.abs(v).max()) for v in flat.values())
    state = getattr(step.trainer, module).state_dict()
    assert {flat_key(k) for k in state} == set(flat)
    for name, value in state.items():
        ref = _to_port_layout(name, flat[flat_key(name)], value.ndim)
        np.testing.assert_allclose(value.numpy(), ref, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)


def check_adam(step, which):
    """Adam's first and second moments at the one-step limits, and its count."""
    opt, module = {'g': (step.trainer.g_opt, step.trainer.G),
                   'd': (step.trainer.d_opt, step.trainer.D)}[which]
    adam = getattr(step.after, f'{which}_opt')[0]
    for moment, key in ((adam.mu, 'exp_avg'), (adam.nu, 'exp_avg_sq')):
        flat = flatten_tree({'params': moment})
        scale = max(float(np.abs(v).max()) for v in flat.values())
        for name, p in module.named_parameters():
            ref = _to_port_layout(name, flat[flat_key(name)], p.ndim)
            np.testing.assert_allclose(opt.state[p][key].numpy(), ref, rtol=1e-4,
                                       atol=1e-4 * scale, err_msg=f'{key} {name}')
    assert {float(opt.state[p]['step']) for p in module.parameters()} == {float(adam.count)}


def check_part(step, part):
    if part == 'draws':
        assert step.draws.used == set(step.draws.values)
    elif part == 'losses':
        names = {k for k in step.stats if not k.startswith('_') and k != 'g_updates'}
        assert names == {k for k in step.port if not k.startswith('_')}
        for k in names:
            np.testing.assert_allclose(float(step.port[k]), float(step.stats[k]), rtol=1e-4,
                                       atol=1e-4, err_msg=k)
    elif part in ('g', 'pl', 'd', 'r1'):
        check_gradients(step, part)
    elif part == 'pl_mean':
        np.testing.assert_allclose(float(step.trainer.pl_mean), float(step.after.pl_mean),
                                   rtol=1e-4, atol=1e-7)
    elif part.startswith('adam_'):
        check_adam(step, part[-1])
    else:
        check_module(step, part)


PARTS = ['draws', 'losses', 'g', 'pl', 'd', 'r1', 'G', 'D', 'G_ema', 'pl_mean', 'adam_g',
         'adam_d']


@pytest.mark.parametrize('part', [p for p in PARTS if p not in ('pl', 'r1')])
def test_plain_step(steps, part):
    """Step 0, no R1 and no PL, from the start."""
    step = steps[0]
    assert 'pl' not in step.port['_grads'] and 'Loss/pl_penalty' not in step.port
    check_part(step, part)


@pytest.mark.parametrize('part', PARTS)
def test_r1_and_pl_step(steps, part):
    """Step 1 from JAX's state after step 0: Gmain with style mixing, PL and
    its second Adam update, Dmain on fresh fakes, R1; every part at the
    one-step limits."""
    step = steps[1]
    if part == 'draws':
        assert float(step.draws.values['gmain/0/mix/p']) < 0.5, 'step 1 does not mix'
        assert 'pl/pl_noise' in step.draws.values
    check_part(step, part)


def test_pl_without_its_second_adam_update_misses(hold, steps):
    """Mutation witness: the PL gradient computed but not applied leaves
    G's Adam (its moments and count) off JAX's after the step."""
    def mutate(trainer):
        pl, apply = trainer._pl, trainer._apply
        skip = []

        def pl_only(*args):
            pl(*args)
            skip.append(True)

        def apply_unless_pl(opt, module, keep):
            if skip:
                skip.clear()
                train_step._scrub(module.parameters())
                grads = {n: p.grad.detach().clone() for n, p in module.named_parameters()}
                opt.zero_grad(set_to_none=True)
                return grads
            return apply(opt, module, keep)

        trainer._pl, trainer._apply = pl_only, apply_unless_pl

    mutated = hold.run(1, steps[0].after, True, adam=True, mutate=mutate,
                       jax_out=(steps[1].after, steps[1].stats))
    check_part(steps[1], 'adam_g')
    with pytest.raises(AssertionError):
        check_part(mutated, 'adam_g')


def test_dmain_on_reused_2d_fakes_misses(hold, steps):
    """Mutation witness: Dmain scoring Gmain's detached fakes (what
    `dmain_reuse_fakes` would do) misses Dmain's gradient."""
    def mutate(trainer):
        gmain = trainer._gmain

        def reuse(batch, sched, draws, n_micro, accumulate):
            forward, made = trainer._g_forward, []

            def record(*args):
                out, pp = forward(*args)
                made.append((out.img.detach(), pp))
                return out, pp

            trainer._g_forward = record
            gen, _ = gmain(batch, sched, draws, n_micro, accumulate)
            trainer._g_forward = forward
            return gen, made

        trainer._gmain = reuse

    mutated = hold.run(1, steps[0].after, True, adam=True, mutate=mutate,
                       jax_out=(steps[1].after, steps[1].stats))
    with pytest.raises(AssertionError):
        check_part(mutated, 'd')


def test_per_sample_style_mixing_cutoff_misses(hold, steps, monkeypatch):
    """Mutation witness: one style-mixing cutoff per sample in place of one
    per call misses Gmain's gradient."""
    monkeypatch.setattr(losses, 'mix_styles', per_sample_mix)
    mutated = hold.run(1, steps[0].after, True, adam=True,
                       jax_out=(steps[1].after, steps[1].stats))
    with pytest.raises(AssertionError):
        check_part(mutated, 'g')


def test_the_2d_step_runs_no_camera_regularizer_and_no_reuse(steps):
    """Dmain renders fresh fakes although `dmain_reuse_fakes` is on (its
    default); the camera regularizers and the depth channel are off."""
    step = steps[1]
    assert step.trainer.cfg.training.dmain_reuse_fakes
    assert any(k.startswith('dmain/0/noise/') for k in step.draws.used)
    assert not any(k.startswith('reg/') for k in step.draws.values)
    assert not any('camera_dist' in k for k in step.port)


# ------------------------------------------------------------------ the bf16 blocks

# G's blocks 8-32 and D's 16 and 8 run in bf16
G_BF16_CONVS = re.compile(r'synthesis\.b(8|16|32)\.(conv0|conv1|torgb)\.weight$')
D_BF16_CONVS = re.compile(r'b(16|8)\.(conv0|conv1|skip)\.weight$')
LOSS_OF_FLOOR = 0.6         # each loss over the step's largest loss floor
GRAD_OF_FLOOR = 0.9         # a phase's gradients, concatenated, over the floor
G_CONV_MEDIAN_OF_FLOOR = 0.5  # G's bf16 conv weights (PL): median of their ratios
D_CONV_OF_FLOOR = 0.9       # each of D's bf16 conv weights (Dmain); a float32 D reads 1.0


@pytest.fixture(scope='module')
def bf16_hold():
    """The tiny config at its own precision."""
    return Hold(fp32=False)


@pytest.fixture(scope='module')
def bf16_steps(hold, bf16_hold):
    """Step 1's inputs and key from the start with learning rates 0, at the
    tiny config's own precision and at float32 (the floor's other end, on
    the float32 hold's compiled step)."""
    return tuple(h.run(1, h.state, True, lr_zero=True) for h in (bf16_hold, hold))


def floor_ratios(bf16, f32, phase, port_grads):
    """(whole phase, {bf16 conv weight: ratio}) of `port_grads` against
    JAX's bf16 step, over JAX's bf16 step against its float32 one."""
    ref, ref32 = jax_grads(bf16, phase), jax_grads(f32, phase)
    convs_re = G_BF16_CONVS if phase in ('g', 'pl') else D_BF16_CONVS
    got, want, want32, convs = [], [], [], {}
    for name, g in port_grads.items():
        r = _to_port_layout(name, ref[flat_key(name)], g.ndim)
        r32 = _to_port_layout(name, ref32[flat_key(name)], g.ndim)
        got.append(g.numpy().ravel()), want.append(r.ravel()), want32.append(r32.ravel())
        if convs_re.match(name):
            convs[name] = _rel(g.numpy(), r) / _rel(r, r32)
    whole = _rel(np.concatenate(got), np.concatenate(want)) / _rel(np.concatenate(want),
                                                                     np.concatenate(want32))
    return whole, convs


def loss_ratio(bf16, f32, port):
    names = [k for k in bf16.stats if not k.startswith('_') and k != 'g_updates']
    floor = max(abs(float(bf16.stats[k]) - float(f32.stats[k])) for k in names)
    return max(abs(float(port[k]) - float(bf16.stats[k])) for k in names) / floor


def test_bf16_step_losses_and_state(bf16_steps):
    """Every draw replayed, state in float32, each loss within
    LOSS_OF_FLOOR x the step's loss floor (witness 0.11; the float32 port
    1.0)."""
    bf16, f32 = bf16_steps
    assert bf16.draws.used == set(bf16.draws.values)
    assert bf16.trainer.G.synthesis.b32.dtype == torch.bfloat16
    assert bf16.trainer.G.synthesis.b4.dtype is None
    assert bf16.trainer.D.b16.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in bf16.trainer.G.parameters())
    assert loss_ratio(bf16, f32, bf16.port) <= LOSS_OF_FLOOR
    assert loss_ratio(bf16, f32, f32.port) > LOSS_OF_FLOOR


@pytest.mark.parametrize('phase', ['pl', 'd'])
def test_bf16_step_gradients(bf16_steps, phase):
    """PL's and Dmain's gradients through the bf16 blocks against JAX's step
    at the same precision: the phase within GRAD_OF_FLOOR of its floor
    (witness 0.24 / 0.71), G's bf16 conv weights' median within
    G_CONV_MEDIAN_OF_FLOOR (PL: 0.15) and each of D's within D_CONV_OF_FLOOR
    (Dmain: largest 0.73). Gmain and R1 are held below."""
    bf16, f32 = bf16_steps
    whole, convs = floor_ratios(bf16, f32, phase, bf16.port['_grads'][phase])
    assert len(convs) == (9 if phase == 'pl' else 6), sorted(convs)
    assert whole <= GRAD_OF_FLOOR, whole
    if phase == 'pl':
        assert float(np.median(list(convs.values()))) <= G_CONV_MEDIAN_OF_FLOOR, convs
    else:
        assert max(convs.values()) <= D_CONV_OF_FLOOR, convs


@pytest.mark.parametrize('phase', ['pl', 'd'])
def test_bf16_step_at_float32_misses_the_limit(bf16_steps, phase):
    """Mutation witness: the port's float32 step against JAX's bf16 step
    misses the phase's limit (1.01 / 1.01), for PL G's conv weights' median
    limit (1.02) and for Dmain D's conv weights' (largest 1.02)."""
    bf16, f32 = bf16_steps
    whole, convs = floor_ratios(bf16, f32, phase, f32.port['_grads'][phase])
    assert whole > GRAD_OF_FLOOR, whole
    if phase == 'pl':
        assert float(np.median(list(convs.values()))) > G_CONV_MEDIAN_OF_FLOOR, convs
    else:
        assert max(convs.values()) > D_CONV_OF_FLOOR, convs


# Gmain and R1 at bf16, in the step (learning rates 0). Gmain's gradient
# turns on the bf16 flips that G's fakes meet at D's bf16 input cast: JAX's
# own D on the fakes of JAX's G with its convolutions taken as the port's CPU
# route takes them (float32 on bf16 operands, rounded once) moves Gmain's
# gradient by 2.8-8.5 of its floor, and the port's step reads 2.7-8.1. So
# Gmain in the step is held within that spread, and, given JAX's own fakes,
# to a share of the floor that the float32 port misses. R1's gradient of a
# gradient on the step's real patches is held within JAX's own spread with
# D's convolutions taken as the port's route.

GMAIN_OF_FLOOR = 0.5    # Gmain given JAX's fakes: each of G's bf16 conv weights
OF_SPREAD = 2.0         # Gmain and R1 in the step: each bf16 conv weight over JAX's spread


def gmain_key():
    """The key of step 1's Gmain forward (microbatch 0)."""
    return jax.random.fold_in(jax.random.split(jax.random.PRNGKey(KEYS[1]), 8)[2], 0)


@pytest.fixture(scope='module')
def jax_spread(bf16_hold):
    """From step 1's start and inputs at bf16, in one compiled call: JAX's
    Gmain fakes, Gmain's gradient of G with G's convolutions taken as the
    port's CPU route (D's as JAX's own), and R1's penalty on the real patches
    differentiated twice through D with its convolutions as JAX's own and as
    the port's route -> (fakes, {G weight: gradient}, two {D weight: gradient})."""
    from tdgp.training import losses as jax_losses
    from tdgp.training.patch import extract_patches as jax_extract
    h, key = bf16_hold, gmain_key()
    jb, s = h.inputs[1][0], h.state
    pp = {'scales': jb['real_pp_scales'], 'offsets': jb['real_pp_offsets']}

    def route():
        return mock.patch.object(jax.lax, 'conv_general_dilated',
                                 _f32_conv(jax.lax.conv_general_dilated))

    def fakes(g_params):
        return jax_losses.g_forward_2d(
            h.G, {'params': g_params, 'consts': s.g_consts, 'ema': s.g_ema_coll},
            jb['gen_z_g'], jb['c'], h.jsched, key, h.jcfg)

    def gmain(g_params):
        with route():
            out, pp_g, _ = fakes(g_params)
        logits, _ = jax_losses.d_forward(h.D, {'params': s.d_params}, out.img, jb['c'],
                                         h.jsched, h.jcfg, patch_params=pp_g)
        return jnp.mean(jax_losses.adv_loss_g(logits, 'non_saturating'))

    def r1(d_params, real):
        g = jax.grad(lambda x: jnp.sum(h.D.apply({'params': d_params}, x, None,
                                                 patch_params=pp)[0]))(real)
        return jnp.sum(jnp.square(g))

    def r1_route(d_params, real):
        with route():
            return r1(d_params, real)

    def spread(g_params, d_params):
        real = jax_extract(jb['img'], pp, 16)
        return (fakes(g_params)[0].img, jax.grad(gmain)(g_params),
                jax.grad(r1)(d_params, real), jax.grad(r1_route)(d_params, real), real)

    fake, g, r1_own, r1_spread, real = jax.device_get(jax.jit(spread)(s.g_params, s.d_params))
    return (np.array(fake), flatten_tree({'params': g}), flatten_tree({'params': r1_own}),
            flatten_tree({'params': r1_spread}), np.array(real), pp)


def _gmain_port(h, fake, fp32):
    """The port's Gmain at step 1's start with D given `fake`'s values (G's
    gradient flows through its own fakes) -> {G bf16 conv weight: gradient}."""
    cfg = dataclasses.replace(h.cfg, generator=dataclasses.replace(h.cfg.generator,
                                                                   fp32_only=fp32),
                              discriminator=dataclasses.replace(h.cfg.discriminator,
                                                                fp32_only=fp32))
    trainer = Trainer(cfg, 'cpu')
    s, pb = h.state, h.inputs[1][1]
    load_train_state(trainer, s.g_params, s.g_consts, s.g_ema_coll, s.d_params, s.ema_params,
                     s.ema_ema_coll)
    train_step._set_requires_grad(trainer.D, False)
    draws = Replay(forward_2d_draws(h.jcfg, gmain_key(), N, h.jsched))
    out, pp = losses.g_forward_2d(trainer.G, pb['gen_z_g'], pb['c'], h.sched, cfg, draws)
    img = out.img + (torch.from_numpy(fake) - out.img).detach()
    logits, _ = losses.d_forward(trainer.D, img, pb['c'], h.sched, cfg, patch_params=pp)
    losses.adv_loss_g(logits, 'non_saturating').mean().backward()
    return {n: p.grad for n, p in trainer.G.named_parameters() if G_BF16_CONVS.match(n)}


def over(port, ref, a, b):
    """{weight: rel(port, ref) / rel(a, b)}, relative L2 distances: the
    port's gradients in its layout, `ref`, `a` and `b` flat JAX trees."""
    return {n: _rel(g.numpy(), _to_port_layout(n, ref[flat_key(n)], g.ndim))
            / _rel(a[flat_key(n)], b[flat_key(n)]) for n, g in port.items()}


@pytest.mark.parametrize('route', ['port', 'mutant-float32'])
def test_bf16_gmain_given_jaxs_fakes(bf16_hold, bf16_steps, jax_spread, route):
    """Gmain at bf16 with D given JAX's bf16 fakes: each of G's bf16 conv
    weights within GMAIN_OF_FLOOR of its floor (0.13-0.42); the port at
    float32 misses it."""
    bf16, f32 = bf16_steps
    grads = _gmain_port(bf16_hold, jax_spread[0], route != 'port')
    ref = jax_grads(bf16, 'g')
    ratios = over(grads, ref, ref, jax_grads(f32, 'g'))
    assert len(ratios) == 9
    if route == 'port':
        assert max(ratios.values()) <= GMAIN_OF_FLOOR, ratios
    else:
        assert max(ratios.values()) > GMAIN_OF_FLOOR, ratios


def test_bf16_gmain_in_the_step_within_jax_self_spread(bf16_steps, jax_spread):
    """Gmain's gradient in the step at bf16: each of G's bf16 conv weights
    within OF_SPREAD x JAX's own distance when its G takes the port's
    convolution route (witness 0.92-1.01). The spread is wide enough to hold
    a float32 G as well (0.12-0.35): the test above tells bf16 from float32."""
    bf16, _ = bf16_steps
    port = {n: g for n, g in bf16.port['_grads']['g'].items() if G_BF16_CONVS.match(n)}
    ref = jax_grads(bf16, 'g')
    ratios = over(port, ref, jax_spread[1], ref)
    assert len(ratios) == 9
    assert max(ratios.values()) <= OF_SPREAD, ratios


def _r1_port_alone(h, real, pp, conv):
    """The port's R1 penalty at step 1's start on `real`, differentiated
    twice with `conv` as its CPU convolution -> {D bf16 conv weight: grad}."""
    from tdgp_torch.ops import conv2d_resample as resample
    from tdgp_torch.ops import upfirdn2d as fir
    trainer = Trainer(h.cfg, 'cpu')
    s = h.state
    load_train_state(trainer, s.g_params, s.g_consts, s.g_ema_coll, s.d_params, s.ema_params,
                     s.ema_ema_coll)
    with mock.patch.object(fir, 'conv2d', conv), mock.patch.object(resample, 'conv2d', conv):
        x = torch.from_numpy(real.copy()).requires_grad_(True)
        logits, _ = trainer.D(x, h.inputs[1][1]['c'], {k: T(v) for k, v in pp.items()})
        (g,) = torch.autograd.grad(logits.sum(), x, create_graph=True)
        g.square().sum().backward()
    return {n: p.grad for n, p in trainer.D.named_parameters() if D_BF16_CONVS.match(n)}


@pytest.mark.parametrize('route', ['port', 'mutant-torch-cpu-bf16-conv'])
def test_bf16_r1_within_jax_self_spread(bf16_hold, bf16_steps, jax_spread, route):
    """R1 at bf16 in the step: each of D's bf16 conv weights within
    OF_SPREAD x JAX's own distance under the port's convolution route
    (witness 1.09-1.58; a float32 D 0.25-0.46). The mutation, PyTorch's own
    CPU bf16 convolution (whose double backward accumulates in bf16), misses
    (3.9 on `b16.conv0`), on R1's penalty alone on the step's real patches."""
    import torch.nn.functional as F
    bf16, _ = bf16_steps
    _, _, own, spread, real, pp = jax_spread
    if route == 'port':
        port = {n: g for n, g in bf16.port['_grads']['r1'].items() if D_BF16_CONVS.match(n)}
        ratios = over(port, jax_grads(bf16, 'r1'), spread, own)
    else:
        ratios = over(_r1_port_alone(bf16_hold, real, pp, F.conv2d), own, spread, own)
    assert len(ratios) == 6
    if route == 'port':
        assert max(ratios.values()) <= OF_SPREAD, ratios
    else:
        assert max(ratios.values()) > OF_SPREAD, ratios
