"""The 2D StyleGAN2 baseline (`model_name='stylegan2'`) in the port against the
JAX package on the CPU, at the size of `tests/test_stylegan2_training.py`'s
`tiny_2d_config` (16-d z and w, cbase 512, cmax 32, 32^2 images, 16^2
patches), float32 (`fp32_only`) unless a test says otherwise:

- the configs: the port's `tiny_2d_config` and its presets are JAX's field
  by field;
- `StyleGAN2Generator`: the image with the const noise and with the JAX
  noise replayed, and the mapping's ws, at rtol = atol = 1e-4; the weights
  both ways through `tdgp_torch.weights` (the flat names are JAX's);
- `losses.g_forward_2d` against `tdgp.training.losses.g_forward_2d` from the
  same key, every draw replayed: the patches and ws with and without style
  mixing, at 1e-4; style mixing with a per-sample cutoff (a mutation) misses;
- the refusals and what replaces them: the 2D model, its path-length
  regularization and style mixing on both models train; PL on the 3DGP
  model builds a trainer, and is refused through `gmain_render_bf16` only;
- snapshots carry `pl_mean`; `fid2k_full` raises on a 2D G, naming the JAX
  package's gap; the camera-posterior panel is None;
- `scripts.train --preset stylegan2 --device cpu` shrunk to the tiny widths
  on a 32^2 folder: two ticks with R1 and PL, the failing fid2k_full
  contained, a resume that restores `pl_mean`, `load_run` and `export_ema`
  on its snapshot, and the export read by the JAX `StyleGAN2Generator`;
  without a card and without `--device cpu` it raises.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

import tdgp.config as jc
from tdgp.checkpoint import variables_from_flat
from tdgp.models.stylegan2 import StyleGAN2Generator as JaxStyleGAN2Generator
from tdgp.models.stylegan2 import sg2_block_resolutions
from tdgp.training import losses as jax_losses
from tdgp.training import train_step as jts
from tdgp.training.patch import sample_patch_params as jax_patch_params
from tdgp.training.schedules import compute_schedules as jax_schedules

import tdgp_torch.config as pc
from tdgp_torch import checkpoint as ckpt
from tdgp_torch.metrics.registry import EvalContext
from tdgp_torch.models.stylegan2 import StyleGAN2Generator
from tdgp_torch.scripts import export_ema
from tdgp_torch.scripts import inference as inference_script
from tdgp_torch.scripts import train as train_script
from tdgp_torch.training import losses
from tdgp_torch.training.schedules import compute_schedules
from tdgp_torch.training.telemetry import camera_posterior
from tdgp_torch.training.train_step import Trainer, build_models
from tdgp_torch.utils.draws import Draws, Replay
from tdgp_torch.weights import flat_from_module, flatten_tree, load_flat

from test_torch_train_step import flax_key

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
N, RES = 4, 32


@pytest.fixture(scope='module', autouse=True)
def _one_thread_per_worker():
    """One torch and one BLAS thread while this module runs: the test workers
    share the cores, and OpenBLAS's threads spin while the others hold them."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api='blas'):
        yield
    torch.set_num_threads(saved)


def T(x):
    return torch.from_numpy(np.array(x))


def tiny_2d_config(m=pc, fp32=True):
    """`tests/test_stylegan2_training.py:tiny_2d_config` built from the
    dataclasses of `m` (the port's `tdgp_torch.config` or `tdgp.config`);
    G and D at float32 when `fp32`, else at their own precision (G's blocks
    8-32 and D's in bf16)."""
    patch = m.PatchCfg(resolution=16, min_scale_trg=0.25, mbstd_group_size=2)
    gen = m.GeneratorConfig(z_dim=16, w_dim=16, c_dim=0, cbase=512, cmax=32,
                            img_resolution=RES, patch=patch, fp32_only=fp32,
                            depth_adaptor=m.DepthAdaptorCfg(enabled=False),
                            camera_adaptor=m.CameraAdaptorCfg(enabled=False, z_dim=16, c_dim=0))
    disc = m.DiscriminatorConfig(c_dim=0, cbase=512, cmax=32, input_resolution=16,
                                 img_channels=3, num_additional_start_blocks=1,
                                 mbstd_group_size=2, patch=patch, embedding_dim=8,
                                 fp32_only=fp32)
    return m.Config(
        model_name='stylegan2', generator=gen, discriminator=disc,
        loss=m.LossConfig(r1_gamma=0.1, pl_weight=2.0, style_mixing_prob=0.5,
                          kd=m.KDCfg(weight=0.0)),
        training=m.TrainingConfig(batch_size=N, use_depth=False, learn_camera_dist=False,
                                  metrics=()),
        dataset=m.DatasetConfig(resolution=RES, c_dim=0, embedding_dim=8,
                                use_embeddings=False))


def noise_draws(key, n, resolution, prefix):
    """The 2D synthesis' noise buffers, as its layers draw them from `key`
    with `make_rng('noise')`, under the port's names."""
    out = {}
    for res in sg2_block_resolutions(0, resolution):
        for name in (['conv1'] if res == 4 else ['conv0', 'conv1']):
            k = flax_key(key, 'synthesis', f'b{res}', name)
            out[f'{prefix}noise/b{res}/{name}'] = T(jax.random.normal(k, (n, res, res, 1)))
    return out


def forward_2d_draws(cfg, key, n, sched, prefix=''):
    """Every draw of `tdgp.training.losses.g_forward_2d` from `key`, under
    the port's names ('patch', 'noise/...', 'mix/cutoff|p|z2')."""
    gc = cfg.generator
    k_patch, k_noise, k_mix = jax.random.split(key, 3)
    values = noise_draws(k_noise, n, gc.img_resolution, prefix)
    if gc.patch.enabled:
        pp = jax_patch_params(k_patch, n, gc.patch, min_scale=sched.patch_min_scale,
                              beta=sched.patch_beta)
        values[f'{prefix}patch'] = {k: T(v) for k, v in pp.items()}
    if cfg.loss.style_mixing_prob > 0:
        k_cut, k_p, k_z2 = jax.random.split(k_mix, 3)
        num_ws = jts.build_models(cfg)[0].num_ws
        values[f'{prefix}mix/cutoff'] = T(jax.random.randint(k_cut, (), 1, num_ws))
        values[f'{prefix}mix/p'] = T(jax.random.uniform(k_p, ()))
        values[f'{prefix}mix/z2'] = T(jax.random.normal(k_z2, (n, gc.z_dim)))
    return values


@pytest.fixture(scope='module')
def pair():
    """The JAX `StyleGAN2Generator`'s variables (jitted init) and the port's
    generator holding them."""
    jcfg, cfg = tiny_2d_config(jc), tiny_2d_config()
    G = jts.build_models(jcfg)[0]
    z = jnp.zeros((N, 16))
    variables = jax.jit(lambda r: G.init(r, z, None, train=True))(jts.init_rngs(0))
    port = build_models(cfg)[0]
    load_flat(port, flatten_tree(jax.device_get(variables)))
    return G, variables, port.eval()


def test_configs_as_jax():
    assert dataclasses.asdict(tiny_2d_config()) == dataclasses.asdict(tiny_2d_config(jc))
    assert dataclasses.asdict(tiny_2d_config(fp32=False)) == dataclasses.asdict(
        tiny_2d_config(jc, fp32=False))
    assert pc.PRESETS['stylegan2']().model_name == 'stylegan2'


def test_weights_cross_both_ways(pair):
    """`load_flat` takes every array of the JAX tree (it raises on any it
    does not use), and `flat_from_module` gives them back bit for bit."""
    _, variables, port = pair
    assert isinstance(port, StyleGAN2Generator) and port.num_ws == 8
    flat = flatten_tree(jax.device_get(variables))
    back = flat_from_module(port)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize('noise', ['const', 'random'])
def test_generator_as_jax(pair, noise):
    """The image of z through the mapping and the synthesis, and the ws."""
    G, variables, port = pair
    z = np.random.RandomState(0).randn(N, 16).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = G.apply(variables, jnp.asarray(z), None, noise_mode=noise, rngs={'noise': key})
    ws_ref = G.apply(variables, jnp.asarray(z), None, method=lambda g, z, c: g.mapping(z, c))
    buffers = None
    if noise == 'random':
        buffers = port.synthesis.draw_noise(Replay(noise_draws(key, N, RES, '')).scope('noise'),
                                            N)
    with torch.no_grad():
        img = port(T(z), None, noise=buffers)
        ws = port.mapping(T(z), None)
    assert img.shape == (N, RES, RES, 3) and ws.shape == (N, 8, 16)
    np.testing.assert_allclose(img.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(ws.numpy(), np.asarray(ws_ref), **TOL)


def per_sample_mix(ws, z, prob, mapping, draws):
    """Mutation: style mixing with one cutoff per sample (the drawn cutoff
    for the first, the next ones for the others)."""
    num_ws = ws.shape[1]
    cutoff = draws.randint('cutoff', 1, num_ws, ())
    cutoff = torch.where(draws.uniform('p', ()) < prob, cutoff, torch.full_like(cutoff, num_ws))
    cutoffs = torch.where(cutoff < num_ws,
                          (cutoff - 1 + torch.arange(ws.shape[0])) % (num_ws - 1) + 1, cutoff)
    ws2 = mapping(draws.normal('z2', tuple(z.shape)))
    return torch.where(torch.arange(num_ws)[None, :, None] >= cutoffs[:, None, None], ws2, ws)


MIX_KEY = 11  # a key whose draw mixes (p < 0.5), checked below


@pytest.mark.parametrize('case', ['no_mixing', 'mixing', 'per_sample_mixing'])
def test_g_forward_2d_as_jax(pair, case, monkeypatch):
    """`losses.g_forward_2d` from one key in both packages, every draw
    replayed: the patches cropped from the image and the ws, at 1e-4;
    with a per-sample cutoff (the mutation) the ws miss."""
    G, variables, port = pair
    jcfg, cfg = tiny_2d_config(jc), tiny_2d_config()
    if case == 'no_mixing':
        jcfg = dataclasses.replace(jcfg, loss=dataclasses.replace(jcfg.loss,
                                                                  style_mixing_prob=0.0))
        cfg = dataclasses.replace(cfg, loss=dataclasses.replace(cfg.loss, style_mixing_prob=0.0))
    if case == 'per_sample_mixing':
        monkeypatch.setattr(losses, 'mix_styles', per_sample_mix)
    jsched, sched = jax_schedules(jcfg, 300_000), compute_schedules(cfg, 300_000)
    z = np.random.RandomState(1).randn(N, 16).astype(np.float32)
    key = jax.random.PRNGKey(MIX_KEY)
    ref, pp, _ = jax_losses.g_forward_2d(G, variables, jnp.asarray(z), jnp.zeros((N, 0)),
                                          jsched, key, jcfg)
    draws = Replay(forward_2d_draws(jcfg, key, N, jsched))
    with torch.no_grad():
        out, port_pp = losses.g_forward_2d(port, T(z), torch.zeros(N, 0), sched, cfg, draws)
    assert draws.used == set(draws.values)
    assert out.img.shape == (N, 16, 16, 3)
    np.testing.assert_array_equal(port_pp['scales'].numpy(), np.asarray(pp['scales']))
    if case == 'per_sample_mixing':
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(out.ws.numpy(), np.asarray(ref.ws), **TOL)
        return
    np.testing.assert_allclose(out.img.numpy(), np.asarray(ref.img), **TOL)
    np.testing.assert_allclose(out.ws.numpy(), np.asarray(ref.ws), **TOL)
    if case == 'mixing':
        assert float(draws.values['mix/p']) < 0.5
        ws = out.ws.numpy()
        assert not np.allclose(ws[:, 0], ws[:, -1]), 'the draw did not mix'


# ------------------------------------------------------------------ settings

def test_the_2d_model_pl_and_style_mixing_train():
    """What the refusals of `model_name`, `loss.pl_weight` and
    `loss.style_mixing_prob` gave way to: the 2D model with PL and style
    mixing, and style mixing on the 3DGP model, build a Trainer."""
    trainer = Trainer(tiny_2d_config(), 'cpu')
    assert isinstance(trainer.G, StyleGAN2Generator)
    assert float(trainer.pl_mean) == 0.0
    cfg = pc.apply_overrides(pc.tiny_test_config(), ['loss.style_mixing_prob=0.9',
                                                     'discriminator.fp32_only=true'])
    Trainer(cfg, 'cpu')


def test_pl_on_the_3dgp_model_builds_a_trainer_but_not_through_the_bf16_view():
    """PL on the 3DGP model trains (its step against JAX's is
    tests/test_torch_pl3d.py); through `training.gmain_render_bf16`, whose
    bf16 sampler has no second-order entry, it is refused."""
    cfg = pc.apply_overrides(pc.tiny_test_config(), ['loss.pl_weight=2.0'])
    assert float(Trainer(cfg, 'cpu').pl_mean) == 0.0
    cfg = pc.apply_overrides(cfg, ['training.gmain_render_bf16=true'])
    with pytest.raises(NotImplementedError, match='loss.pl_weight with training.gmain_render'):
        Trainer(cfg, 'cpu')


def test_snapshots_carry_pl_mean(tmp_path):
    trainer = Trainer(tiny_2d_config(), 'cpu')
    trainer.pl_mean = torch.tensor(0.375)
    gen = torch.Generator().manual_seed(0)
    path = ckpt.save_snapshot(str(tmp_path), trainer, gen, cur_nimg=4000)
    other = Trainer(tiny_2d_config(), 'cpu', seed=5)
    ckpt.load_snapshot(path, other, torch.Generator())
    assert float(other.pl_mean) == 0.375
    assert all(torch.equal(a, b) for a, b in zip(other.G_ema.state_dict().values(),
                                                 trainer.G_ema.state_dict().values()))


def test_no_metric_sampler_and_no_camera_panel_for_the_2d_model():
    """The JAX package has no 2D image sampler (its `fid2k_full` renders
    through a camera) and no camera-posterior panel for a 2D model."""
    cfg = tiny_2d_config()
    G = build_models(cfg)[0]
    ctx = EvalContext(cfg=cfg, G=G, dataset=None, detector=None)
    with pytest.raises(NotImplementedError, match='registry.py:94-99'):
        ctx.make_image_sampler()
    assert camera_posterior(G, cfg, Draws(torch.Generator())) is None


# ------------------------------------------------------------------ the CLI

TINY_2D = ['generator.z_dim=16', 'generator.w_dim=16', 'generator.cbase=512',
           'generator.cmax=32', 'discriminator.cbase=512', 'discriminator.cmax=32',
           'generator.patch.resolution=16', 'generator.patch.mbstd_group_size=2',
           'discriminator.mbstd_group_size=2', f'dataset.resolution={RES}',
           'training.batch_size=4', 'loss.r1_interval=2', 'training.tensorboard=false',
           'training.tick_kimg=0.008', 'training.snap=1', 'training.val_freq=2',
           'training.image_snap=2', 'training.metrics=[fid2k_full]']


@pytest.fixture(scope='module')
def folder(tmp_path_factory):
    out = str(tmp_path_factory.mktemp('data') / f'synth{RES}')
    subprocess.run([sys.executable, os.path.join(ROOT, 'data_scripts', 'make_synthetic_dataset.py'),
                    '--out', out, '--n', '16', '--res', str(RES)], check=True,
                   capture_output=True, timeout=120)
    return out


@pytest.fixture(scope='module')
def run_2d(folder, tmp_path_factory):
    """Two ticks of two steps (R1 and PL on steps 0 and 2), a snapshot at
    each, fid2k_full tried at the second; then one more tick resumed."""
    args = ['--preset', 'stylegan2', '--device', 'cpu', f'dataset.path={folder}'] + TINY_2D
    first = train_script.main(args + ['--run-root', str(tmp_path_factory.mktemp('runs')),
                                      '--max-kimg', '0.016'])
    saved = torch.load(os.path.join(ckpt.snapshot_path(first.run_dir, 0), ckpt.STATE_FILE),
                       weights_only=True)['pl_mean']
    again = train_script.main(args + ['--run-dir', first.run_dir, '--max-kimg', '0.024'])
    return first, again, saved


def test_train_script_runs_the_2d_baseline(run_2d):
    first, again, _ = run_2d
    assert isinstance(first.trainer.G, StyleGAN2Generator)
    assert (first.cur_nimg, first.batch_idx) == (16, 4)
    assert float(first.trainer.pl_mean) > 0
    with open(os.path.join(first.run_dir, 'stats.jsonl')) as f:
        lines = [__import__('json').loads(line) for line in f]
    assert 'Loss/pl_penalty' in lines[0] and 'Loss/D/r1_penalty' in lines[0]
    assert not os.path.exists(os.path.join(first.run_dir, 'metric-fid2k_full.jsonl'))
    assert os.path.exists(os.path.join(first.run_dir, 'fakes000000.png'))
    assert again.resumed_from.endswith('network-snapshot-000000')
    assert again.batch_idx == 6


def test_snapshot_and_resume_carry_pl_mean(run_2d):
    """The first run's snapshot holds its `pl_mean`; the resumed run's
    snapshot loads into a new trainer with the resumed run's."""
    first, again, saved = run_2d
    assert torch.equal(saved, first.trainer.pl_mean)
    other = Trainer(first.trainer.cfg, 'cpu', seed=9)
    ckpt.load_snapshot(ckpt.resolve_resume(first.run_dir, 'latest'), other, torch.Generator())
    assert torch.equal(other.pl_mean, again.trainer.pl_mean)
    assert not torch.equal(again.trainer.pl_mean, first.trainer.pl_mean)


def test_load_run_and_export_ema_on_a_2d_run(run_2d):
    """`load_run` builds the 2D G from the frozen config and reads G_ema
    from the snapshot; `export_ema`'s `.npz` loads back equal and into the
    JAX `StyleGAN2Generator`, which draws the same image at 1e-4 (both
    with every block at float32)."""
    _, first, _ = run_2d
    path = ckpt.snapshot_path(first.run_dir, 0)
    cfg, G = inference_script.load_run(first.run_dir, path, device='cpu')
    assert isinstance(G, StyleGAN2Generator) and not G.training
    for a, b in zip(G.state_dict().values(), first.trainer.G_ema.state_dict().values()):
        assert torch.equal(a, b)
    out = export_ema.main(['--run-dir', first.run_dir, '--snapshot', path])
    _, from_npz = inference_script.load_run(first.run_dir, os.path.basename(out), device='cpu')
    for a, b in zip(from_npz.state_dict().values(), G.state_dict().values()):
        assert torch.equal(a, b)
    gc = cfg.generator
    kw = dict(z_dim=gc.z_dim, c_dim=gc.c_dim, w_dim=gc.w_dim, img_resolution=gc.img_resolution,
              cbase=gc.cbase, cmax=gc.cmax, num_fp16_res=gc.num_fp16_res, fp32_only=True)
    G32 = StyleGAN2Generator(**kw)  # the same weights, every block at float32
    with np.load(out) as flat:
        load_flat(G32, flat)
        variables = variables_from_flat(dict(flat))
    z = np.random.RandomState(2).randn(2, gc.z_dim).astype(np.float32)
    ref = JaxStyleGAN2Generator(**kw).apply(variables, jnp.asarray(z), None, noise_mode='const')
    with torch.no_grad():
        img = G32(T(z), None)
    np.testing.assert_allclose(img.numpy(), np.asarray(ref), **TOL)


def test_train_script_needs_a_card_unless_given_the_cpu(folder, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_script.main(['--preset', 'stylegan2', f'dataset.path={folder}'] + TINY_2D)
