"""RGB-D patch discriminator with hypernetwork modulation and a KD head
(port of `tdgp/models/discriminator.py`).

StyleGAN2 residual blocks over (RGB + adapted depth) patches, NHWC. The
patch parameters (scale, offset x, offset y) are encoded by Fourier
features and a learned table; the encoding conditions the projection head
and, through a hypernetwork, modulates conv1's input in every block. The
epilogue runs minibatch-std, a conv and two dense layers, and, on real
images with KD on, a head that predicts the image's ResNet-50 embedding.

Unless `fp32_only`, the blocks from `fp16_resolution(image resolution,
num_fp16_res)` up compute in bfloat16, as in the JAX package: such a block
casts its input and the image to bf16 on entry and its layers compute in
bf16 with float32 parameters (the casts are in `Conv2dLayer` and
`bias_act`); the residual sum stays in bf16, and the epilogue casts back to
float32 before the minibatch std. Gradients reach the float32 parameters
and the float32 image through the casts.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tdgp_torch.config import DiscriminatorConfig
from tdgp_torch.models.layers import Conv2dLayer, FullyConnected, MappingNetwork, ScalarEncoder1d
from tdgp_torch.models.stylegan2 import fp16_resolution, sg2_channel_dict
from tdgp_torch.utils.draws import Draws

HYPER_DIM = 512  # width of the hypernetwork's output


class DiscriminatorBlock(nn.Module):
    def __init__(self, in_channels: int, tmp_channels: int, out_channels: int,
                 img_channels: int, down: int = 2, conv_clamp: Optional[float] = 256.0,
                 hyper_mod: bool = False, dtype: Optional[torch.dtype] = None):
        """dtype: torch.bfloat16 for a bf16 block, None for one in the
        parameters' dtype (float32)."""
        super().__init__()
        self.in_channels, self.dtype = in_channels, dtype
        if in_channels == 0:
            self.fromrgb = Conv2dLayer(img_channels, tmp_channels, 1, activation='lrelu',
                                       conv_clamp=conv_clamp)
            in_channels = tmp_channels
        self.skip = Conv2dLayer(in_channels, out_channels, 1, bias=False, down=down)
        self.conv0 = Conv2dLayer(in_channels, tmp_channels, 3, activation='lrelu',
                                 conv_clamp=conv_clamp)
        self.conv1 = Conv2dLayer(tmp_channels, out_channels, 3, activation='lrelu', down=down,
                                 conv_clamp=conv_clamp,
                                 hyper_mod_dim=HYPER_DIM if hyper_mod else 0)

    def forward(self, x: Optional[torch.Tensor], img: Optional[torch.Tensor],
                c: Optional[torch.Tensor] = None) -> torch.Tensor:
        dtype = self.dtype or self.conv0.weight.dtype  # float32 blocks compute in float32
        x = None if x is None else x.to(dtype)
        if self.in_channels == 0:
            y = self.fromrgb(img.to(dtype))
            x = x + y if x is not None else y
        y = self.skip(x, gain=math.sqrt(0.5))
        x = self.conv0(x)
        x = self.conv1(x, c=c, gain=math.sqrt(0.5))
        return y + x


def minibatch_std(x: torch.Tensor, group_size: int, num_channels: int = 1) -> torch.Tensor:
    """Append the std over groups of samples: [N,H,W,C] -> [N,H,W,C+F].

    As in the JAX package, the statistics are taken over the strided groups
    {j, j + N/g, ...} and handed to consecutive samples (`jnp.repeat`), where
    the StyleGAN2 reference tiles them back to the strided groups."""
    n, h, w, ch = x.shape
    g = min(group_size, n)
    if n % g:
        raise ValueError(f'mbstd group {g} must divide the batch {n}')
    f = num_channels
    y = x.reshape(g, n // g, h, w, f, ch // f)
    y = y - y.mean(dim=0, keepdim=True)
    y = torch.sqrt(y.square().mean(dim=0) + 1e-8)
    y = y.mean(dim=(1, 2, 4))                       # [n//g, F]
    y = y.repeat_interleave(g, dim=0)               # [n, F]
    y = y[:, None, None, :].expand(n, h, w, f)
    return torch.cat([x, y], dim=-1)


class DiscriminatorEpilogue(nn.Module):
    def __init__(self, in_channels: int, cmap_dim: int, resolution: int = 4,
                 mbstd_group_size: int = 4, mbstd_num_channels: int = 1,
                 conv_clamp: Optional[float] = 256.0, feat_predict_dim: int = 0):
        super().__init__()
        self.cmap_dim, self.mbstd_group_size = cmap_dim, mbstd_group_size
        self.mbstd_num_channels = mbstd_num_channels
        self.conv = Conv2dLayer(in_channels + mbstd_num_channels, in_channels, 3,
                                activation='lrelu', conv_clamp=conv_clamp)
        flat = in_channels * resolution ** 2
        if feat_predict_dim > 0:
            self.feat_fc0 = FullyConnected(flat, in_channels, activation='lrelu')
            self.feat_fc1 = FullyConnected(in_channels, feat_predict_dim)
        else:
            self.feat_fc0 = self.feat_fc1 = None
        self.fc = FullyConnected(flat, in_channels, activation='lrelu')
        self.out = FullyConnected(in_channels, 1 if cmap_dim == 0 else cmap_dim)

    def forward(self, x: torch.Tensor, cmap: Optional[torch.Tensor],
                predict_feat: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        x = x.to(self.conv.weight.dtype)  # out of the bf16 blocks: float32
        if self.mbstd_num_channels > 0:
            x = minibatch_std(x, self.mbstd_group_size, self.mbstd_num_channels)
        x = self.conv(x).reshape(x.shape[0], -1)
        feats = None
        if predict_feat and self.feat_fc0 is not None:
            feats = self.feat_fc1(self.feat_fc0(x))
        x = self.out(self.fc(x))
        if self.cmap_dim > 0:
            x = (x * cmap).sum(dim=1, keepdim=True) / math.sqrt(self.cmap_dim)
        return x, feats


class Discriminator(nn.Module):
    def __init__(self, cfg: DiscriminatorConfig):
        super().__init__()
        self.cfg = cfg
        img_resolution = cfg.input_resolution * 2 ** cfg.num_additional_start_blocks
        res_log2 = int(np.log2(img_resolution))
        self.block_resolutions = [2 ** i for i in range(res_log2, 2, -1)]
        channels = sg2_channel_dict(cfg.cbase, cfg.cmax, cfg.fmaps, self.block_resolutions + [4])
        bf16_from = fp16_resolution(img_resolution, cfg.num_fp16_res)
        self.use_patch_cond = cfg.patch.patch_params_cond
        cond_dim = cfg.c_dim
        if self.use_patch_cond:
            self.scalar_enc = ScalarEncoder1d(3, 1000.0, 256)
            cond_dim += self.scalar_enc.out_dim
        cmap_dim = channels[4] if (cfg.c_dim > 0 or self.use_patch_cond or cfg.camera_cond) else 0
        if cfg.hyper_mod:
            if not self.use_patch_cond:
                raise ValueError('hyper_mod needs patch conditioning')
            self.hyper_mod_mapping = MappingNetwork(
                z_dim=0, c_dim=self.scalar_enc.out_dim, w_dim=HYPER_DIM, num_ws=None,
                w_avg_beta=None, num_layers=cfg.map_depth)
        for i, res in enumerate(self.block_resolutions):
            setattr(self, f'b{res}', DiscriminatorBlock(
                in_channels=channels[res] if res < img_resolution else 0,
                tmp_channels=channels[res], out_channels=channels[res // 2],
                img_channels=cfg.img_channels,
                down=1 if i < cfg.num_additional_start_blocks else 2,
                conv_clamp=cfg.conv_clamp, hyper_mod=cfg.hyper_mod,
                dtype=torch.bfloat16 if res >= bf16_from and not cfg.fp32_only else None))
        self.head_mapping = (MappingNetwork(z_dim=0, c_dim=cond_dim, w_dim=cmap_dim,
                                            num_ws=None, w_avg_beta=None,
                                            num_layers=cfg.map_depth,
                                            camera_cond=cfg.camera_cond,
                                            camera_cond_drop_p=cfg.camera_cond_drop_p)
                             if cmap_dim > 0 else None)
        self.b4 = DiscriminatorEpilogue(
            channels[4], cmap_dim=cmap_dim, mbstd_group_size=cfg.mbstd_group_size,
            mbstd_num_channels=cfg.mbstd_num_channels, conv_clamp=cfg.conv_clamp,
            feat_predict_dim=cfg.embedding_dim)

    def forward(self, img: torch.Tensor, c: Optional[torch.Tensor],
                patch_params: Optional[Dict[str, torch.Tensor]] = None,
                predict_feat: bool = False, camera_angles: Optional[torch.Tensor] = None,
                draws: Optional[Draws] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """img [N, H, W, C_img] patches in [-1, 1] -> (logits [N], KD features
        or None); `camera_angles` [N, 3] with `camera_cond`."""
        cfg = self.cfg
        if cfg.camera_cond and cfg.camera_cond_drop_p > 0 and draws is None:
            raise ValueError("discriminator.camera_cond_drop_p needs the draw 'cond_drop', "
                             'which the training step does not give D, as the JAX step '
                             'gives it no dropout key')
        hyper_c = None
        if self.use_patch_cond:
            if patch_params is None:
                raise ValueError('the discriminator is conditioned on patch parameters')
            pp = torch.cat([patch_params['scales'][:, :1], patch_params['offsets']], dim=1)
            patch_embs = self.scalar_enc(pp)
            c = patch_embs if (c is None or cfg.c_dim == 0) else torch.cat([c, patch_embs], 1)
            if cfg.hyper_mod:
                hyper_c = self.hyper_mod_mapping(None, patch_embs)
        x = None
        for i, res in enumerate(self.block_resolutions):
            x = getattr(self, f'b{res}')(x, img if i == 0 else None, c=hyper_c)
        cmap = (self.head_mapping(None, c, camera_angles=camera_angles, draws=draws)
                if self.head_mapping is not None else None)
        logits, feats = self.b4(x, cmap, predict_feat=predict_feat)
        return logits[:, 0], feats
