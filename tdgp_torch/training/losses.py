"""3DGP loss terms (port of `tdgp/training/losses.py`).

The camera-adaptor EMD regularizer takes the exact 1-D optimal transport in
closed form, as the JAX package does: for equal-weight samples the optimal
coupling is the sorted matching, so emd2 == mean((sort(x) - sort(y))^2).
The Lipschitz regularizer takes each scalar's derivative of the posterior
with respect to the same scalar of the prior by `torch.autograd.grad` with
`create_graph=True` (the samples are independent, so the batch sum's
gradient holds every sample's diagonal entry).

Style mixing (`loss.style_mixing_prob`) is one helper, `mix_styles`, that
both G forwards call: the 3DGP render (`g_forward`) and the 2D StyleGAN2
baseline's (`g_forward_2d`).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from tdgp_torch.config import Config
from tdgp_torch.models.camera_adaptor import roll_camera_params, unroll_camera_params
from tdgp_torch.models.discriminator import Discriminator
from tdgp_torch.models.epigraf import Generator
from tdgp_torch.models.stylegan2 import StyleGAN2Generator
from tdgp_torch.rendering.camera import get_mean_angles_values, sample_camera_params
from tdgp_torch.training.blur import blur_depth_channel, maybe_blur
from tdgp_torch.training.patch import extract_patches, sample_patch_params, sample_random_c
from tdgp_torch.training.schedules import Schedules
from tdgp_torch.utils.draws import Draws
from tdgp_torch.utils.tensor_group import TensorGroup


# --------------------------------------------------------------- G forward

def mix_styles(ws: torch.Tensor, z: torch.Tensor, prob: float,
               mapping: Callable[[torch.Tensor], torch.Tensor], draws: Draws) -> torch.Tensor:
    """Style mixing (`tdgp/training/losses.py:54-64`): with probability
    `prob`, ws[:, cutoff:] become the styles that `mapping` gives a second
    z. One cutoff for the whole batch, drawn from [1, num_ws). The second
    latent is mapped whatever the draw, as in the JAX package; `mapping`
    must not move `w_avg`. Draws: 'cutoff', 'p', 'z2'."""
    num_ws = ws.shape[1]
    cutoff = draws.randint('cutoff', 1, num_ws, ())
    cutoff = torch.where(draws.uniform('p', ()) < prob, cutoff, torch.full_like(cutoff, num_ws))
    ws2 = mapping(draws.normal('z2', tuple(z.shape)).to(z.dtype))
    idx = torch.arange(num_ws, device=ws.device)[None, :, None]
    return torch.where(idx >= cutoff, ws2, ws)


def g_forward(G: Generator, z: torch.Tensor, c: torch.Tensor, camera_params: TensorGroup,
              camera_angles_cond: torch.Tensor, sched: Schedules, cfg: Config, draws: Draws):
    """-> (TensorGroup(img, depth), patch params or None).

    Draws: 'patch' (composite), 'mix/...' (style mixing), and the
    generator's 'noise/...', 'render/...', 'depth/...'."""
    patch_params = None
    if cfg.generator.patch.enabled:
        patch_params = draws.draw('patch', lambda d: sample_patch_params(
            d, z.shape[0], cfg.generator.patch, min_scale=sched.patch_min_scale,
            beta=sched.patch_beta))
    ws = G.mapping(z, c, camera_angles=camera_angles_cond, draws=draws.scope('mapping'))
    if cfg.loss.style_mixing_prob > 0:
        ws = mix_styles(ws, z, cfg.loss.style_mixing_prob, lambda z2: G.mapping(
            z2, c, camera_angles=camera_angles_cond, draws=draws.scope('mix/mapping')),
            draws.scope('mix'))
    cam = camera_params
    if cfg.training.learn_camera_dist:
        cam = G.synthesis.apply_camera_adaptor(camera_params, z, c)
    out = G.synthesis(ws, cam, patch_params, draws=draws,
                      concat_depth=cfg.training.use_depth, return_depth=True,
                      nerf_noise_std=sched.nerf_noise_std, depth_progress=sched.depth_progress)
    return out, patch_params


def g_forward_2d(G: StyleGAN2Generator, z: torch.Tensor, c: torch.Tensor, sched: Schedules,
                 cfg: Config, draws: Draws):
    """The 2D StyleGAN2 baseline's forward (`tdgp/training/losses.py:89`):
    the full-resolution image with random noise, then, with patches on, the
    patch parameters drawn and the patches cropped from it
    -> (TensorGroup(img, ws), patch params or None).

    Draws: 'mix/...' (style mixing), 'noise/b<res>/conv0|conv1', 'patch'."""
    ws = G.mapping(z, c)
    if cfg.loss.style_mixing_prob > 0:
        ws = mix_styles(ws, z, cfg.loss.style_mixing_prob, lambda z2: G.mapping(z2, c),
                        draws.scope('mix'))
    img = G.synthesis(ws, G.synthesis.draw_noise(draws.scope('noise'), z.shape[0]))
    patch_params = None
    patch = cfg.generator.patch
    if patch.enabled:
        patch_params = draws.draw('patch', lambda d: sample_patch_params(
            d, z.shape[0], patch, min_scale=sched.patch_min_scale, beta=sched.patch_beta))
        img = extract_patches(img, patch_params, patch.resolution)
    return TensorGroup(img=img, ws=ws), patch_params


# --------------------------------------------------------------- D forward

def d_forward(D: Discriminator, img: torch.Tensor, c: torch.Tensor, sched: Schedules,
              cfg: Config, patch_params=None, predict_feat: bool = False,
              augment_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
    """The blur fade-in, the depth channel's own blur, the augment pipe
    (`augment_fn`, when given), then D."""
    max_blur = cfg.loss.blur_init_sigma
    img = maybe_blur(img, sched.blur_sigma, max_blur)
    if cfg.training.use_depth:
        if img.shape[-1] != 4:
            raise ValueError(f'RGB-D expected, got {tuple(img.shape)}')
        img = blur_depth_channel(img, sched.blur_sigma, max_blur)
    if augment_fn is not None:
        img = augment_fn(img)
    return D(img, c, patch_params=patch_params, predict_feat=predict_feat)


# ---------------------------------------------------------- camera regs

def _prior_batch(draws: Draws, n: int, cfg: Config):
    """z, labels and prior cameras for a camera regularizer."""
    gc = cfg.generator
    return (draws.normal('z', (n, gc.z_dim)), sample_random_c(draws.scope('c'), n, gc.c_dim),
            sample_camera_params(draws.scope('camera'), cfg.camera, n))


def camera_emd_reg(G: Generator, sched: Schedules, cfg: Config,
                   draws: Draws) -> Tuple[torch.Tensor, Dict]:
    """EMD between the prior's and the posterior's camera marginals."""
    acfg = cfg.generator.camera_adaptor
    z, c, prior = draws.draw('batch', lambda d: _prior_batch(d, acfg.emd.num_samples, cfg))
    posterior = G.synthesis.apply_camera_adaptor(prior, z, c)
    post_raw, prior_raw = unroll_camera_params(posterior), unroll_camera_params(prior)
    emds = (torch.sort(post_raw, dim=0).values - torch.sort(prior_raw, dim=0).values
            ).square().mean(0)                                            # [8]
    regs = roll_camera_params(emds[None, :])
    loss = sched.emd_multiplier * (
        regs.angles[:, :2].sum() * acfg.emd.origin + regs.radius.sum() * acfg.emd.radius
        + regs.fov.sum() * acfg.emd.fov + regs.look_at.sum() * acfg.emd.look_at)
    return loss, {'Loss/camera_dist/emd_loss': loss}


def camera_lipschitz_reg(G: Generator, cfg: Config, draws: Draws) -> Tuple[torch.Tensor, Dict]:
    """|d post_i / d prior_i| + 1 / (|.| + 1e-4), averaged over 256 samples."""
    acfg = cfg.generator.camera_adaptor
    z, c, prior = draws.draw('batch', lambda d: _prior_batch(d, 256, cfg))
    prior_raw = unroll_camera_params(prior).detach().requires_grad_(True)
    post_raw = unroll_camera_params(
        G.synthesis.apply_camera_adaptor(roll_camera_params(prior_raw), z, c))
    diag = [torch.autograd.grad(post_raw[:, i].sum(), prior_raw, create_graph=True)[0][:, i]
            for i in range(post_raw.shape[1])]
    norms = torch.stack(diag, dim=1).abs()                                # [n, 8]
    rr = roll_camera_params((norms + 1.0 / (norms + 1e-4)).mean(0)[None, :])
    lw = acfg.lipschitz_weights
    loss = (rr.angles[:, :2].sum() * lw.angles + rr.radius.sum() * lw.radius
            + rr.fov.sum() * lw.fov + rr.look_at.sum() * lw.look_at)
    return loss, {'Loss/camera_dist/lipschitz_loss': loss}


def camera_force_mean_reg(G: Generator, cfg: Config, draws: Draws) -> Tuple[torch.Tensor, Dict]:
    """Pull the posterior's mean angles to the prior's mean."""
    z, c, prior = draws.draw('batch', lambda d: _prior_batch(d, 256, cfg))
    posterior = G.synthesis.apply_camera_adaptor(prior, z, c)
    mean_angles = torch.tensor(get_mean_angles_values(cfg.camera.origin.angles),
                               device=z.device)
    raw = torch.sqrt((posterior.angles.mean(0) - mean_angles + 1e-8).square().sum())
    return cfg.generator.camera_adaptor.force_mean_weight * raw, \
        {'Loss/camera_dist/force_mean': raw}


# ---------------------------------------------------------------- adversarial

def adv_loss_g(logits: torch.Tensor, loss_type: str) -> torch.Tensor:
    if loss_type == 'non_saturating':
        return F.softplus(-logits)
    if loss_type == 'hinge':
        return -logits
    raise NotImplementedError(loss_type)


def adv_loss_d_fake(logits: torch.Tensor, loss_type: str, clamp: float) -> torch.Tensor:
    if loss_type == 'non_saturating':
        return F.softplus(torch.clamp(logits, min=-clamp))
    if loss_type == 'hinge':
        return F.relu(1.0 + logits)
    raise NotImplementedError(loss_type)


def adv_loss_d_real(logits: torch.Tensor, loss_type: str, clamp: float) -> torch.Tensor:
    if loss_type == 'non_saturating':
        return F.softplus(-torch.clamp(logits, max=clamp))
    if loss_type == 'hinge':
        return F.relu(1.0 - logits)
    raise NotImplementedError(loss_type)


def compute_sample_weights(patch_params: Optional[Dict[str, torch.Tensor]],
                           scale_pow: float = 1.0):
    """KD distances weighted by the patch scale."""
    if patch_params is None:
        return 1.0
    raw = patch_params['scales'].mean(dim=1) ** scale_pow
    return raw / (raw.mean() + 1e-8)


def kd_loss(real_feats: torch.Tensor, real_embs: torch.Tensor, loss_type: str) -> torch.Tensor:
    """Knowledge-distillation distance per sample."""
    if loss_type == 'l2':
        return torch.linalg.vector_norm(real_feats - real_embs, dim=1)
    if loss_type == 'kl':
        logp = F.log_softmax(real_feats, dim=1)
        q = F.softmax(real_embs, dim=1)
        return (q * (torch.log(q + 1e-12) - logp)).sum(1)
    raise NotImplementedError(loss_type)


def prepare_real_img(real_img: torch.Tensor, real_depth: Optional[torch.Tensor],
                     cfg: Config) -> torch.Tensor:
    """The real depth, blurred when configured, as the 4th channel; the
    image alone without `training.use_depth` (the 2D model)."""
    if not cfg.training.use_depth:
        return real_img
    sigma = cfg.training.blur_real_depth_sigma
    if sigma > 0:
        real_depth = maybe_blur(real_depth, sigma, sigma)
    return torch.cat([real_img, real_depth], dim=-1)
