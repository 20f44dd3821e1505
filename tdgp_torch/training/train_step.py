"""The 3DGP G+D training step (port of `tdgp/training/train_step.py`).

`Trainer` holds G, D, the EMA copy of G and the two Adam optimizers; its
`step` runs one step of the JAX package's `make_train_step`:

  - Gmain: G renders patches of fakes from z, labels and prior cameras
    (the conditioning angles spoofed with probability `gpc_spoof_p`), D
    scores them, and G takes the non-saturating loss, plus the camera
    adaptor's EMD, force-mean and Lipschitz regularizers once per step;
  - Dmain: D scores fakes against patches of the real batch, with the KD
    loss on the real branch: Gmain's fakes, detached (`dmain_reuse_fakes`,
    the default), or fresh ones that the updated G renders per microbatch
    without gradients from Dmain's own z, labels and cameras, scored with
    those labels; before it, the mapping's `w_avg` moves toward that
    batch's mean w (the training render reads no `w_avg`: it takes no
    truncation);
  - R1 (`do_r1`): the gradient penalty on real patches, a gradient of a
    gradient through D (`torch.autograd.grad(create_graph=True)`);
  - the G EMA.

The 2D StyleGAN2 baseline (`model_name='stylegan2'`, `build_models`) takes
the same phases on its own forward (`losses.g_forward_2d`: the full image,
then patches cropped from it): no camera regularizers, the `w_avg` pass
without camera angles, real images without depth, and Dmain always on fresh
fakes, whatever `dmain_reuse_fakes` says, as in the JAX package. On R1
steps with `loss.pl_weight > 0` both models add the path-length phase (PL,
between Gmain and Dmain, `_pl`): the gradient of the image times a normal
draw with respect to ws, taken with `create_graph=True`, its lengths pulled
toward their running mean `pl_mean`, and a second Adam update of G. For
the 3DGP model the image is the patch that G renders from Gmain's prior
cameras after the camera adaptor, so the penalty's gradient runs back
through the backward of the render: K3's backward and K1, whose own
derivatives are CUDA kernels too (`ops/ray_march.py`, `ops/splat.py`). Style mixing
(`loss.style_mixing_prob`) runs in both models' G forwards
(`losses.mix_styles`).

Gradients are averaged over `batch_gpu` microbatches (`r1_batch_gpu` for
R1), scrubbed of NaN and Inf, and applied by Adam; D's Adam has the
lazy-regularization ratio r1_interval / (r1_interval + 1) folded into its
learning rate and betas. With `training.augment.mode` 'ada' or 'fixed', every
D input passes through the ADA pipe (`training/augment.py`) at the
schedules' `ada_p`, with draws of its own per phase and microbatch
('aug/gmain/<i>', 'aug/dmain_fake/<i>', 'aug/dmain_real/<i>', 'aug/r1/<i>').
Every random choice comes from the `Draws` given to `step`; the tests replay
the JAX package's draws through it. The bf16 render views are G's
`Generator.view`s over its own parameters, as the JAX step's are:
`training.gmain_render_bf16` renders Gmain through a `render_bf16` view
(the decoder at the config's precision), `training.dmain_fake_bf16` Dmain's
fresh fakes through a view with `render_bf16` and every decoder block from
8x8 up in bf16 (`config.render_bf16_view`). The step runs at the configuration's
precision, TF32 off: G's and D's bf16 blocks (`num_fp16_res`, unless
`fp32_only`) compute in bfloat16 with float32 parameters, and the gradients
come back to float32 through each cast; Adam, the EMA, `w_avg` and the
NaN/Inf scrub are float32.

With `training.g_optim.grad_clip`, G's gradient (Gmain's with the camera
regularizers', and PL's on its own) is scaled to that global norm before
G's Adam, by optax's `clip_by_global_norm` rule (`_clip`); D's `grad_clip`
is never read, as in the JAX package. With `discriminator.camera_cond` D
takes each image's camera angles: a fake's, its cameras after the camera
adaptor (Gmain's with their gradient); a real's, the batch's
'camera_angles'. With `loss.r1_remat` R1's D forward is recomputed in its
double backward (`torch.utils.checkpoint`, non-reentrant), the JAX
package's `jax.checkpoint`; the numbers are the same.

Not ported, and refused with a `NotImplementedError` naming the setting:
an augment mode other than 'noaug', 'ada' and 'fixed', path-length
regularization of the 3DGP model through `training.gmain_render_bf16` (its
bf16 sampler's backward has no second-order entry) and training over
several devices. With
reused fakes `dmain_fake_bf16` has no effect and a warning says so, as in
the JAX package.
"""
from __future__ import annotations

import copy
import dataclasses
import math
import warnings
from typing import Dict, Iterable, Optional, Union

import torch
from torch import nn
from torch.profiler import record_function

from tdgp_torch.config import Config, is_2d, render_bf16_view
from tdgp_torch.models.discriminator import Discriminator
from tdgp_torch.models.epigraf import Generator
from tdgp_torch.models.layers import init_weights
from tdgp_torch.models.stylegan2 import StyleGAN2Generator
from tdgp_torch.rendering.camera import sample_camera_params
from tdgp_torch.training import losses
from tdgp_torch.training.augment import AugmentPipe
from tdgp_torch.training.patch import extract_patches, sample_patch_params, sample_random_c
from tdgp_torch.training.schedules import Schedules
from tdgp_torch.utils.draws import Draws
from tdgp_torch.utils.misc import exact_fp32, nan_to_num, resolve_device
from tdgp_torch.utils.tensor_group import TensorGroup


# record_function ranges of a step, for torch.profiler (tdgp_torch/profile_training.py)
PHASES = ('gmain', 'camera_regs', 'pl', 'dmain', 'r1', 'ema')


def check_supported(cfg: Config) -> None:
    """Raise NotImplementedError for each setting the port does not train;
    warn that `dmain_fake_bf16` has no effect while Dmain reuses Gmain's
    fakes, as the JAX step does."""
    t, l = cfg.training, cfg.loss
    if t.dmain_fake_bf16 and t.dmain_reuse_fakes and not is_2d(cfg):
        warnings.warn('training.dmain_fake_bf16 has no effect while '
                      'training.dmain_reuse_fakes is enabled (the default): '
                      'Dmain renders no fresh fakes. Set '
                      'training.dmain_reuse_fakes=false to use it.', stacklevel=3)
    refused = {
        'training.augment.mode': t.augment.mode not in ('noaug', 'ada', 'fixed'),
        'loss.pl_weight with training.gmain_render_bf16 (path-length regularization through '
        "the bf16 render view: the second order of K1's bf16 entry is not ported)":
            l.pl_weight > 0 and not is_2d(cfg) and t.gmain_render_bf16,
        'num_devices': cfg.num_devices > 1,
    }
    names = [name for name, bad in refused.items() if bad]
    if names:
        raise NotImplementedError(f'not ported to the PyTorch train step: {", ".join(names)}')


def build_models(cfg: Config):
    """(G, D) with their parameters unset (`tdgp/training/train_step.py:63`):
    the 2D `StyleGAN2Generator` for `model_name='stylegan2'`, the tri-plane
    `Generator` otherwise. D has the KD head only with KD on, as JAX's
    `create_train_state` initialises it (`predict_feat=kd.weight > 0`)."""
    gc = cfg.generator
    if is_2d(cfg):
        G = StyleGAN2Generator(
            z_dim=gc.z_dim, c_dim=gc.c_dim, w_dim=gc.w_dim, img_resolution=gc.img_resolution,
            img_channels=gc.img_channels, map_depth=gc.map_depth, cbase=gc.cbase,
            cmax=gc.cmax, fmaps=gc.fmaps, num_fp16_res=gc.num_fp16_res,
            fp32_only=gc.fp32_only)
    else:
        G = Generator(gc)
    disc = cfg.discriminator
    if cfg.loss.kd.weight <= 0:
        disc = dataclasses.replace(disc, embedding_dim=0)
    return G, Discriminator(disc)


def make_optimizers(cfg: Config, G: nn.Module, D: nn.Module):
    """G: Adam. D: Adam with the lazy-regularization ratio folded in."""
    g = cfg.training.g_optim
    g_opt = torch.optim.Adam(G.parameters(), lr=g.lr, betas=(g.beta1, g.beta2), eps=g.eps)
    d = cfg.training.d_optim
    mb = cfg.loss.r1_interval / (cfg.loss.r1_interval + 1) if cfg.loss.r1_gamma > 0 else 1.0
    d_opt = torch.optim.Adam(D.parameters(), lr=d.lr * mb,
                             betas=(d.beta1 ** mb, d.beta2 ** mb), eps=d.eps)
    return g_opt, d_opt


def sample_gen_inputs(draws: Draws, n: int, cfg: Config, sched: Schedules,
                      gen_c: Optional[torch.Tensor] = None,
                      gen_angles: Optional[torch.Tensor] = None,
                      gen_z: Optional[torch.Tensor] = None,
                      gen_cam: Optional[TensorGroup] = None):
    """z, labels, prior cameras and the (spoofed) conditioning angles.
    Given values replace the draws 'z', 'c/...' and 'camera/...'."""
    gc = cfg.generator
    z = gen_z if gen_z is not None else draws.normal('z', (n, gc.z_dim))
    c = gen_c if gen_c is not None else sample_random_c(draws.scope('c'), n, gc.c_dim)
    cam = gen_cam if gen_cam is not None else sample_camera_params(
        draws.scope('camera'), cfg.camera, n, origin_angles=gen_angles)
    spoof = draws.uniform('spoof', (n,)) < sched.gpc_spoof_p
    cond = torch.where(spoof[:, None], torch.roll(cam.angles, 1, dims=0), cam.angles)
    return z, c, cam, cond


def _n_micro(n: int, micro: Optional[int], group: int, what: str) -> int:
    if not micro or micro >= n:
        return 1
    if n % micro or micro % group:
        raise ValueError(f'{what} {micro} must divide the batch {n} and be a multiple of '
                         f'the mbstd group {group}')
    return n // micro


def _set_requires_grad(module: nn.Module, flag: bool) -> None:
    for p in module.parameters():
        p.requires_grad_(flag)


def _clip(params: Iterable[nn.Parameter], max_norm: float) -> torch.Tensor:
    """optax's `clip_by_global_norm(max_norm)` on the parameters' gradients:
    below the threshold unchanged, else each g / norm x max_norm, with no
    epsilon (`torch.nn.utils.clip_grad_norm_` divides by norm + 1e-6).
    Returns the factor applied (1 below the threshold), a 0-d tensor."""
    grads = [p.grad for p in params]
    norm = torch.sqrt(sum(g.square().sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return torch.where(keep, torch.ones_like(norm), max_norm / norm)


def _scrub(params: Iterable[nn.Parameter]) -> None:
    """NaN/Inf scrub of the gradients; a parameter without one gets zeros,
    as JAX's gradient tree has them."""
    for p in params:
        p.grad = torch.zeros_like(p) if p.grad is None else nan_to_num(p.grad)


class Trainer:
    """G, D, G's EMA and their optimizers, on one device.

    Parameters are drawn from `seed` (G from `seed`, D from `seed + 1`, both
    on the CPU), or loaded afterwards from a JAX `TrainState` by
    `tdgp_torch.weights.load_train_state`. The device defaults to the card,
    and a Trainer raises without one unless given 'cpu'. `pl_mean` is the
    running mean of the path lengths (a 0-d float32 tensor on the device).
    """

    def __init__(self, cfg: Config, device: Union[str, torch.device] = 'cuda', seed: int = 0):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        G, D = build_models(cfg)
        init_weights(G, torch.Generator().manual_seed(seed))
        init_weights(D, torch.Generator().manual_seed(seed + 1))
        self.G, self.D = G.to(self.device), D.to(self.device)
        # the bf16 render views over G's parameters (G itself where off)
        self.G_main = self.G_fake = self.G
        if not is_2d(cfg):
            t = cfg.training
            if t.gmain_render_bf16:
                self.G_main = self.G.view(render_bf16_view(cfg.generator))
            if t.dmain_fake_bf16 and not t.dmain_reuse_fakes:
                self.G_fake = self.G.view(render_bf16_view(cfg.generator, all_blocks=True))
        self.pl_mean = torch.zeros((), device=self.device)
        self.g_clip_factors = []  # the clip's factor at each G update of the last step
        self.G_ema = copy.deepcopy(self.G).eval()
        _set_requires_grad(self.G_ema, False)
        self.g_opt, self.d_opt = make_optimizers(cfg, self.G, self.D)
        self.augment_pipe = None
        if cfg.training.augment.mode != 'noaug':
            self.augment_pipe = AugmentPipe(cfg.training.augment,
                                            num_color_channels=cfg.generator.img_channels,
                                            device=self.device)

    def _augment(self, draws: Draws, sched: Schedules, name: str):
        """The augment pipe at `sched.ada_p` with the draws 'aug/<name>/...',
        as the `augment_fn` of `losses.d_forward`; None without ADA."""
        if self.augment_pipe is None:
            return None
        scope = draws.scope(f'aug/{name}')
        return lambda img: self.augment_pipe(img, sched.ada_p, scope)

    def _apply(self, opt: torch.optim.Optimizer, module: nn.Module,
               keep: bool) -> Optional[Dict[str, torch.Tensor]]:
        """Scrub `module`'s gradients, clip G's (`g_optim.grad_clip`; the
        factor appended to `g_clip_factors`) and take the optimizer step;
        returns a copy of the scrubbed gradients, before the clip, when `keep`."""
        _scrub(module.parameters())
        grads = ({name: p.grad.detach().clone() for name, p in module.named_parameters()}
                 if keep else None)
        max_norm = self.cfg.training.g_optim.grad_clip
        if opt is self.g_opt and max_norm is not None:
            self.g_clip_factors.append(_clip(module.parameters(), max_norm).detach())
        opt.step()
        opt.zero_grad(set_to_none=True)
        return grads

    def step(self, batch: Dict[str, torch.Tensor], sched: Schedules, do_r1: bool,
             draws: Draws, return_grads: bool = False) -> Dict:
        """One G+D step on `batch`: 'img' [N,H,W,3] and 'depth' [N,H,W,1] in
        [-1, 1], 'c' [N, c_dim], 'embs' [N, embedding_dim]; optionally the
        generator inputs 'gen_z_g', 'gen_c_g', 'gen_cam_g', 'gen_*_d' and the
        real patch parameters 'real_pp_scales' / 'real_pp_offsets' (the JAX
        package's controlled-inputs mode). Returns the losses as 0-d tensors
        and, with `return_grads`, the scrubbed gradients of each phase ('g',
        'pl', 'd', 'r1') under '_grads'. The 2D model needs no 'depth'."""
        with exact_fp32():
            return self._step(batch, sched, do_r1, draws, return_grads)

    def _step(self, batch, sched, do_r1, draws, keep):
        cfg, G, D = self.cfg, self.G, self.D
        n_micro = _n_micro(batch['img'].shape[0], cfg.training.batch_gpu,
                           cfg.discriminator.mbstd_group_size, 'training.batch_gpu')
        stats: Dict = {}
        grads = {}
        self.g_clip_factors = []

        def accumulate(name, value):
            stats[name] = stats.get(name, 0.0) + value.detach() / n_micro

        with record_function('gmain'):
            gen_g, fakes = self._gmain(batch, sched, draws, n_micro, accumulate)
        with record_function('camera_regs'):
            self._camera_regs(sched, draws, stats)
        grads['g'] = self._apply(self.g_opt, G, keep)
        if do_r1 and cfg.loss.pl_weight > 0:
            with record_function('pl'):
                self._pl(gen_g, sched, draws, stats)
            grads['pl'] = self._apply(self.g_opt, G, keep)
        cg = gen_g[1]
        with record_function('dmain'):
            real, rpp, real_angles = self._dmain(batch, sched, draws, n_micro, accumulate, cg,
                                                 fakes, gen_g[4])
        grads['d'] = self._apply(self.d_opt, D, keep)
        if do_r1 and cfg.loss.r1_gamma > 0:
            with record_function('r1'):
                self._r1(batch, sched, draws, real, rpp, real_angles, n_micro, stats)
            grads['r1'] = self._apply(self.d_opt, D, keep)
        with record_function('ema'):
            self._ema(sched.ema_beta)
        if keep:
            stats['_grads'] = grads
        if self.g_clip_factors:
            stats['_g_clip'] = self.g_clip_factors
        return stats

    def _gmain(self, batch, sched, draws, n_micro, accumulate):
        """Gmain's gradients into G; returns its generator inputs (z, labels,
        cameras, conditioning angles, and the angles D took: the cameras'
        after the camera adaptor, detached) and, per microbatch, the
        detached fakes with their patch parameters for Dmain (None when
        Dmain renders fresh ones, always for the 2D model)."""
        cfg, G, D = self.cfg, self.G, self.D
        n = batch['img'].shape[0]
        m = n // n_micro
        zg, cg, camg, condg = sample_gen_inputs(
            draws.scope('gen_g'), n, cfg, sched, batch.get('gen_c_g'),
            batch.get('gen_camera_angles_g'), batch.get('gen_z_g'), batch.get('gen_cam_g'))
        _set_requires_grad(D, False)
        fakes = [] if cfg.training.dmain_reuse_fakes and not is_2d(cfg) else None
        d_angles = []
        for i in range(n_micro):
            sl = slice(i * m, (i + 1) * m)
            out, pp = self._g_forward(self.G_main, zg[sl], cg[sl], camg.select(sl), condg[sl],
                                      sched, draws.scope(f'gmain/{i}'))
            angles = camg.angles[sl] if is_2d(cfg) else out.angles
            logits, _ = losses.d_forward(D, out.img, cg[sl], sched, cfg, patch_params=pp,
                                         augment_fn=self._augment(draws, sched, f'gmain/{i}'),
                                         camera_angles=angles)
            loss = losses.adv_loss_g(logits, cfg.loss.adv_loss_type).mean()
            (loss / n_micro).backward()
            accumulate('Loss/G/loss', loss)
            accumulate('Loss/scores/fake', logits.mean())
            accumulate('Loss/signs/fake', torch.sign(logits).mean())
            d_angles.append(angles.detach())
            if fakes is not None:
                fakes.append((out.img.detach(), pp))
        _set_requires_grad(D, True)
        return (zg, cg, camg, condg, torch.cat(d_angles)), fakes

    def _g_forward(self, G, z, c, cam, cond, sched, draws):
        """The model's G forward through `G` (G or one of its views):
        `losses.g_forward_2d` for the 2D model (which takes no camera),
        `losses.g_forward` otherwise."""
        if is_2d(self.cfg):
            return losses.g_forward_2d(G, z, c, sched, self.cfg, draws)
        return losses.g_forward(G, z, c, cam, cond, sched, self.cfg, draws)

    def _camera_regs(self, sched, draws, stats):
        """The camera adaptor's regularizers, once per step; their gradients
        add to Gmain's."""
        cfg, G = self.cfg, self.G
        acfg = cfg.generator.camera_adaptor
        if not cfg.training.learn_camera_dist or is_2d(cfg):
            return
        reg_draws = draws.scope('reg')
        regs = []
        if acfg.emd.enabled:
            regs.append(losses.camera_emd_reg(G, sched, cfg, reg_draws.scope('emd')))
        if acfg.adjust.angles and acfg.force_mean_weight > 0:
            regs.append(losses.camera_force_mean_reg(G, cfg, reg_draws.scope('force_mean')))
        if acfg.lipschitz_weights.enabled:
            regs.append(losses.camera_lipschitz_reg(G, cfg, reg_draws.scope('lipschitz')))
        if regs:
            sum(r[0] for r in regs).backward()
            for _, reg_stats in regs:
                stats.update({k: v.detach() for k, v in reg_stats.items()})

    def _pl(self, gen_g, sched, draws, stats):
        """The path-length penalty (`tdgp/training/train_step.py:398-460`) on
        the first n // pl_batch_shrink of Gmain's z, labels, prior cameras
        and conditioning angles, in one batch, at G after Gmain's update: the
        gradient of sum(img x noise / sqrt(h w)) with respect to ws
        (`create_graph=True`), its per-sample length, `pl_mean` moved toward
        their mean by `pl_decay`, and (length - pl_mean)^2 x pl_weight x
        r1_interval, whose gradient goes into G. The 3DGP model renders a
        patch (`train=True`) from the cameras after the camera adaptor,
        applied outside the gradient's function so that its own gradient
        flows, with fresh patch parameters. Draws, all under 'pl/': 'patch',
        'noise/...', 'render/...' (the 3DGP render) and 'pl_noise'."""
        cfg, G = self.cfg, self.G_main
        l, patch = cfg.loss, cfg.generator.patch
        zg, cg, camg, condg = gen_g[:4]
        n_pl = max(zg.shape[0] // max(l.pl_batch_shrink, 1), 1)
        zp, cp = zg[:n_pl], cg[:n_pl]
        pl_draws = draws.scope('pl')

        def draw_patch():
            if not patch.enabled:
                return None
            return pl_draws.draw('patch', lambda d: sample_patch_params(
                d, n_pl, patch, min_scale=sched.patch_min_scale, beta=sched.patch_beta))

        if is_2d(cfg):
            ws = G.mapping(zp, cp)
            pp = draw_patch()
            img = G.synthesis(ws, G.synthesis.draw_noise(pl_draws.scope('noise'), n_pl))
            if pp is not None:
                img = extract_patches(img, pp, patch.resolution)
        else:
            ws = G.mapping(zp, cp, camera_angles=condg[:n_pl], draws=pl_draws.scope('mapping'))
            cam = camg.select(slice(0, n_pl))
            if cfg.training.learn_camera_dist:
                cam = G.synthesis.apply_camera_adaptor(cam, zp, cp)
            img = G.synthesis(ws, cam, draw_patch(), draws=pl_draws,
                              nerf_noise_std=sched.nerf_noise_std,
                              depth_progress=sched.depth_progress)
        noise = pl_draws.normal('pl_noise', tuple(img.shape)) / math.sqrt(img.shape[1]
                                                                         * img.shape[2])
        (pl_grads,) = torch.autograd.grad((img * noise).sum(), ws, create_graph=True)
        pl_lengths = pl_grads.square().sum(2).mean(1).sqrt()
        pl_mean = self.pl_mean + l.pl_decay * (pl_lengths.mean().detach() - self.pl_mean)
        penalty = (pl_lengths - pl_mean).square()
        loss = penalty.mean() * l.pl_weight * float(l.r1_interval)
        loss.backward()
        self.pl_mean = pl_mean
        stats['Loss/pl_penalty'] = penalty.mean().detach()
        stats['Loss/G/reg'] = loss.detach()

    def _dmain(self, batch, sched, draws, n_micro, accumulate, cg, fakes, gen_angles=None):
        """The w_avg update, then Dmain's gradients into D on the fakes and
        real patches; returns the real patches and their parameters. With
        `fakes` None each microbatch's fakes are rendered here by the
        updated G, without gradients, with the draws 'dmain/<i>/...'; reused
        fakes are scored with Gmain's labels `cg` and D's angles `gen_angles`.
        Returns the real patches, and functions of a batch slice that give
        their patch parameters and camera angles."""
        cfg, G, D = self.cfg, self.G, self.D
        adv, clamp = cfg.loss.adv_loss_type, cfg.discriminator.logits_clamp_val
        do_kd = cfg.loss.kd.weight > 0
        patch = cfg.generator.patch
        n = batch['img'].shape[0]
        m = n // n_micro
        zd, cd, camd, condd = sample_gen_inputs(
            draws.scope('gen_d'), n, cfg, sched, batch.get('gen_c_d'),
            batch.get('gen_camera_angles_d'), batch.get('gen_z_d'), batch.get('gen_cam_d'))
        with torch.no_grad():  # the w_avg EMA, from the updated G
            if is_2d(cfg):
                G.mapping(zd, cd, update_emas=True)
            else:
                G.mapping(zd, cd, camera_angles=condd, update_emas=True,
                          draws=draws.scope('ema_mapping'))
        real4 = losses.prepare_real_img(batch['img'], batch.get('depth'), cfg)
        real_pp = None
        if patch.enabled:
            if 'real_pp_scales' in batch:
                real_pp = {'scales': batch['real_pp_scales'], 'offsets': batch['real_pp_offsets']}
            else:
                real_pp = draws.draw('real_patch', lambda d: sample_patch_params(
                    d, n, patch, min_scale=sched.patch_min_scale, beta=sched.patch_beta))
            real = extract_patches(real4, real_pp, patch.resolution)
        else:
            real = real4

        def rpp(sl):
            return None if real_pp is None else {k: v[sl] for k, v in real_pp.items()}

        def real_angles(sl):
            return batch['camera_angles'][sl] if 'camera_angles' in batch else None

        for i in range(n_micro):
            sl = slice(i * m, (i + 1) * m)
            if fakes is None:
                with torch.no_grad():
                    out, fake_pp = self._g_forward(self.G_fake, zd[sl], cd[sl], camd.select(sl),
                                                   condd[sl], sched, draws.scope(f'dmain/{i}'))
                fake_img, fake_c = out.img.float(), cd[sl]
                fake_angles = camd.angles[sl] if is_2d(cfg) else out.angles
            else:
                (fake_img, fake_pp), fake_c = fakes[i], cg[sl]
                fake_angles = None if gen_angles is None else gen_angles[sl]
            fake_logits, _ = losses.d_forward(
                D, fake_img, fake_c, sched, cfg, patch_params=fake_pp,
                augment_fn=self._augment(draws, sched, f'dmain_fake/{i}'),
                camera_angles=fake_angles)
            real_logits, real_feats = losses.d_forward(
                D, real[sl], batch['c'][sl], sched, cfg, patch_params=rpp(sl),
                predict_feat=do_kd, augment_fn=self._augment(draws, sched, f'dmain_real/{i}'),
                camera_angles=real_angles(sl))
            loss_fake = losses.adv_loss_d_fake(fake_logits, adv, clamp).mean()
            loss_real = losses.adv_loss_d_real(real_logits, adv, clamp).mean()
            total = loss_fake + loss_real
            accumulate('Loss/D/loss', loss_fake + loss_real)
            accumulate('Loss/scores/real', real_logits.mean())
            accumulate('Loss/signs/real', torch.sign(real_logits).mean())
            if do_kd:
                dist = losses.kd_loss(real_feats, batch['embs'][sl], cfg.loss.kd.loss_type)
                dist = dist * losses.compute_sample_weights(rpp(sl))
                loss_kd = dist.mean() * sched.kd_weight
                total = total + loss_kd
                accumulate('Loss/kd/D_dist', dist.mean())
                accumulate('Loss/kd/D_loss', loss_kd)
            (total / n_micro).backward()
        return real, rpp, real_angles

    def _r1(self, batch, sched, draws, real, rpp, real_angles, n_micro, stats):
        """The R1 penalty on real patches: a gradient of D's gradient; with
        `loss.r1_remat` D's forward is recomputed in the double backward."""
        cfg, D = self.cfg, self.D
        n = real.shape[0]
        gain = float(cfg.loss.r1_interval)
        n_r1 = _n_micro(n, cfg.loss.r1_batch_gpu, cfg.discriminator.mbstd_group_size,
                        'loss.r1_batch_gpu') if cfg.loss.r1_batch_gpu else n_micro
        m_r1 = n // n_r1
        for i in range(n_r1):
            sl = slice(i * m_r1, (i + 1) * m_r1)
            img = real[sl].detach().requires_grad_(True)
            logits, _ = losses.d_forward(D, img, batch['c'][sl], sched, cfg, patch_params=rpp(sl),
                                         augment_fn=self._augment(draws, sched, f'r1/{i}'),
                                         camera_angles=real_angles(sl), remat=cfg.loss.r1_remat)
            (r1_grads,) = torch.autograd.grad(logits.sum(), img, create_graph=True)
            penalty = r1_grads.square().sum(dim=(1, 2, 3))
            loss = penalty.mean() * (cfg.loss.r1_gamma / 2) * gain
            (loss / n_r1).backward()
            stats['Loss/D/r1_penalty'] = stats.get('Loss/D/r1_penalty', 0.0) \
                + penalty.mean().detach() / n_r1
            stats['Loss/D/reg'] = stats.get('Loss/D/reg', 0.0) + loss.detach() / n_r1

    @torch.no_grad()
    def _ema(self, beta: float) -> None:
        for p_ema, p in zip(self.G_ema.parameters(), self.G.parameters()):
            p_ema.copy_(p + (p_ema - p) * beta)
        for b_ema, b in zip(self.G_ema.buffers(), self.G.buffers()):
            b_ema.copy_(b)
