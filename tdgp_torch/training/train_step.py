"""The 3DGP G+D training step (port of `tdgp/training/train_step.py`).

`Trainer` holds G, D, the EMA copy of G and the two Adam optimizers; its
`step` runs one step of the JAX package's `make_train_step`:

  - Gmain: G renders patches of fakes from z, labels and prior cameras
    (the conditioning angles spoofed with probability `gpc_spoof_p`), D
    scores them, and G takes the non-saturating loss, plus the camera
    adaptor's EMD, force-mean and Lipschitz regularizers once per step;
  - Dmain: D scores Gmain's fakes, detached (`dmain_reuse_fakes`), against
    patches of the real batch, with the KD loss on the real branch; before
    it, the mapping's `w_avg` moves toward a fresh batch's mean w;
  - R1 (`do_r1`): the gradient penalty on real patches, a gradient of a
    gradient through D (`torch.autograd.grad(create_graph=True)`);
  - the G EMA.

Gradients are averaged over `batch_gpu` microbatches (`r1_batch_gpu` for
R1), scrubbed of NaN and Inf, and applied by Adam; D's Adam has the
lazy-regularization ratio r1_interval / (r1_interval + 1) folded into its
learning rate and betas. With `training.augment.mode` 'ada' or 'fixed', every
D input passes through the ADA pipe (`training/augment.py`) at the
schedules' `ada_p`, with draws of its own per phase and microbatch
('aug/gmain/<i>', 'aug/dmain_fake/<i>', 'aug/dmain_real/<i>', 'aug/r1/<i>').
Every random choice comes from the `Draws` given to `step`; the tests replay
the JAX package's draws through it. The step runs at the configuration's
precision, TF32 off: G's and D's bf16 blocks (`num_fp16_res`, unless
`fp32_only`) compute in bfloat16 with float32 parameters, and the gradients
come back to float32 through each cast; Adam, the EMA, `w_avg` and the
NaN/Inf scrub are float32.

Not ported, and refused with a `NotImplementedError` naming the setting:
an augment mode other than 'noaug', 'ada' and 'fixed', path-length
regularization, style mixing, fresh Dmain fakes and the bf16 render views
(`dmain_fake_bf16`, `gmain_render_bf16`), the 2D StyleGAN2 model, R1
rematerialization, G's gradient clipping and training over several devices.
"""
from __future__ import annotations

import copy
from typing import Dict, Iterable, Optional, Union

import torch
from torch import nn
from torch.profiler import record_function

from tdgp_torch.config import Config
from tdgp_torch.models.discriminator import Discriminator
from tdgp_torch.models.epigraf import Generator
from tdgp_torch.models.layers import init_weights
from tdgp_torch.rendering.camera import sample_camera_params
from tdgp_torch.training import losses
from tdgp_torch.training.augment import AugmentPipe
from tdgp_torch.training.patch import extract_patches, sample_patch_params, sample_random_c
from tdgp_torch.training.schedules import Schedules
from tdgp_torch.utils.draws import Draws
from tdgp_torch.utils.misc import exact_fp32, nan_to_num, resolve_device
from tdgp_torch.utils.tensor_group import TensorGroup


# record_function ranges of a step, for torch.profiler (tdgp_torch/profile_training.py)
PHASES = ('gmain', 'camera_regs', 'dmain', 'r1', 'ema')


def check_supported(cfg: Config) -> None:
    """Raise NotImplementedError for each setting the port does not train."""
    t, l = cfg.training, cfg.loss
    refused = {
        'model_name': cfg.model_name == 'stylegan2',
        'training.augment.mode': t.augment.mode not in ('noaug', 'ada', 'fixed'),
        'loss.pl_weight': l.pl_weight > 0,
        'loss.style_mixing_prob': l.style_mixing_prob > 0,
        'loss.r1_remat': l.r1_remat,
        'training.dmain_reuse_fakes': not t.dmain_reuse_fakes,
        'training.dmain_fake_bf16': t.dmain_fake_bf16,
        'training.gmain_render_bf16': t.gmain_render_bf16,
        'num_devices': cfg.num_devices > 1,
        'training.g_optim.grad_clip': t.g_optim.grad_clip is not None,
    }
    names = [name for name, bad in refused.items() if bad]
    if names:
        raise NotImplementedError(f'not ported to the PyTorch train step: {", ".join(names)}')


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
    and a Trainer raises without one unless given 'cpu'.
    """

    def __init__(self, cfg: Config, device: Union[str, torch.device] = 'cuda', seed: int = 0):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        G = init_weights(Generator(cfg.generator), torch.Generator().manual_seed(seed))
        D = init_weights(Discriminator(cfg.discriminator),
                         torch.Generator().manual_seed(seed + 1))
        self.G, self.D = G.to(self.device), D.to(self.device)
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

    @staticmethod
    def _apply(opt: torch.optim.Optimizer, module: nn.Module,
               keep: bool) -> Optional[Dict[str, torch.Tensor]]:
        """Scrub `module`'s gradients and take the optimizer step; returns a
        copy of the gradients when `keep`."""
        _scrub(module.parameters())
        grads = ({name: p.grad.detach().clone() for name, p in module.named_parameters()}
                 if keep else None)
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
        and, with `return_grads`, the scrubbed gradients of each phase under
        '_grads'."""
        with exact_fp32():
            return self._step(batch, sched, do_r1, draws, return_grads)

    def _step(self, batch, sched, do_r1, draws, keep):
        cfg, G, D = self.cfg, self.G, self.D
        n_micro = _n_micro(batch['img'].shape[0], cfg.training.batch_gpu,
                           cfg.discriminator.mbstd_group_size, 'training.batch_gpu')
        stats: Dict = {}
        grads = {}

        def accumulate(name, value):
            stats[name] = stats.get(name, 0.0) + value.detach() / n_micro

        with record_function('gmain'):
            cg, fakes = self._gmain(batch, sched, draws, n_micro, accumulate)
        with record_function('camera_regs'):
            self._camera_regs(sched, draws, stats)
        grads['g'] = self._apply(self.g_opt, G, keep)
        with record_function('dmain'):
            real, rpp = self._dmain(batch, sched, draws, n_micro, accumulate, cg, fakes)
        grads['d'] = self._apply(self.d_opt, D, keep)
        if do_r1 and cfg.loss.r1_gamma > 0:
            with record_function('r1'):
                self._r1(batch, sched, draws, real, rpp, n_micro, stats)
            grads['r1'] = self._apply(self.d_opt, D, keep)
        with record_function('ema'):
            self._ema(sched.ema_beta)
        if keep:
            stats['_grads'] = grads
        return stats

    def _gmain(self, batch, sched, draws, n_micro, accumulate):
        """Gmain's gradients into G; returns the labels and, per microbatch,
        the detached fakes with their patch parameters for Dmain."""
        cfg, G, D = self.cfg, self.G, self.D
        n = batch['img'].shape[0]
        m = n // n_micro
        zg, cg, camg, condg = sample_gen_inputs(
            draws.scope('gen_g'), n, cfg, sched, batch.get('gen_c_g'),
            batch.get('gen_camera_angles_g'), batch.get('gen_z_g'), batch.get('gen_cam_g'))
        _set_requires_grad(D, False)
        fakes = []
        for i in range(n_micro):
            sl = slice(i * m, (i + 1) * m)
            out, pp = losses.g_forward(G, zg[sl], cg[sl], camg.select(sl), condg[sl], sched, cfg,
                                       draws.scope(f'gmain/{i}'))
            logits, _ = losses.d_forward(D, out.img, cg[sl], sched, cfg, patch_params=pp,
                                         augment_fn=self._augment(draws, sched, f'gmain/{i}'))
            loss = losses.adv_loss_g(logits, cfg.loss.adv_loss_type).mean()
            (loss / n_micro).backward()
            accumulate('Loss/G/loss', loss)
            accumulate('Loss/scores/fake', logits.mean())
            accumulate('Loss/signs/fake', torch.sign(logits).mean())
            fakes.append((out.img.detach(), pp))
        _set_requires_grad(D, True)
        return cg, fakes

    def _camera_regs(self, sched, draws, stats):
        """The camera adaptor's regularizers, once per step; their gradients
        add to Gmain's."""
        cfg, G = self.cfg, self.G
        acfg = cfg.generator.camera_adaptor
        if not cfg.training.learn_camera_dist:
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

    def _dmain(self, batch, sched, draws, n_micro, accumulate, cg, fakes):
        """The w_avg update, then Dmain's gradients into D on the reused fakes
        and real patches; returns the real patches and their parameters."""
        cfg, G, D = self.cfg, self.G, self.D
        adv, clamp = cfg.loss.adv_loss_type, cfg.discriminator.logits_clamp_val
        do_kd = cfg.loss.kd.weight > 0
        patch = cfg.generator.patch
        n = batch['img'].shape[0]
        m = n // n_micro
        zd, cd, _, condd = sample_gen_inputs(
            draws.scope('gen_d'), n, cfg, sched, batch.get('gen_c_d'),
            batch.get('gen_camera_angles_d'), batch.get('gen_z_d'), batch.get('gen_cam_d'))
        with torch.no_grad():  # the w_avg EMA, from the updated G
            G.mapping(zd, cd, camera_angles=condd, update_emas=True,
                      draws=draws.scope('ema_mapping'))
        real4 = losses.prepare_real_img(batch['img'], batch['depth'], cfg)
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

        for i in range(n_micro):
            sl = slice(i * m, (i + 1) * m)
            fake_img, fake_pp = fakes[i]
            fake_logits, _ = losses.d_forward(
                D, fake_img, cg[sl], sched, cfg, patch_params=fake_pp,
                augment_fn=self._augment(draws, sched, f'dmain_fake/{i}'))
            real_logits, real_feats = losses.d_forward(
                D, real[sl], batch['c'][sl], sched, cfg, patch_params=rpp(sl),
                predict_feat=do_kd, augment_fn=self._augment(draws, sched, f'dmain_real/{i}'))
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
        return real, rpp

    def _r1(self, batch, sched, draws, real, rpp, n_micro, stats):
        """The R1 penalty on real patches: a gradient of D's gradient."""
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
                                         augment_fn=self._augment(draws, sched, f'r1/{i}'))
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
