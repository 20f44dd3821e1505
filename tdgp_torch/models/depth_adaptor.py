"""Depth adaptor: rendered depth -> the depth channel D sees
(port of `tdgp/models/depth_adaptor.py`).

Normalizes the rendered depth with a learned near-plane offset, runs K conv
layers, and picks one of the K+1 depth maps per sample. In training the
pick is random, with selection probabilities annealed by `progress`; the
JAX package draws it with `jax.random.categorical`, here it is the argmax
of log-probabilities plus Gumbel noise from a `Draws` ('select'). At eval
it takes the last map.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tdgp_torch.config import DepthAdaptorCfg
from tdgp_torch.models.layers import Conv2dLayer
from tdgp_torch.utils.draws import Draws


def sample_categorical(draws: Draws, log_probs: torch.Tensor) -> torch.Tensor:
    """One index per row of log_probs [N, K], by the Gumbel-max trick."""
    u = draws.uniform('gumbel', log_probs.shape).clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(log_probs - torch.log(-torch.log(u)), dim=1)


class DepthAdaptor(nn.Module):
    def __init__(self, cfg: DepthAdaptorCfg, min_depth: float, max_depth: float):
        super().__init__()
        if cfg.out_strategy not in ('last', 'mean', 'random'):
            raise NotImplementedError(f'depth adaptor out_strategy {cfg.out_strategy!r}')
        self.cfg, self.min_depth, self.max_depth = cfg, min_depth, max_depth
        self.near_plane_offset_raw = nn.Parameter(torch.zeros(1))
        self.head = Conv2dLayer(cfg.hid_dim, 1, 1)  # shared by every layer's output
        in_ch = 1
        for i in range(cfg.num_hid_layers):
            setattr(self, f'layer{i}', Conv2dLayer(in_ch, cfg.hid_dim, cfg.kernel_size,
                                                   activation='lrelu'))
            in_ch = cfg.hid_dim

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.near_plane_offset_raw.fill_(self.cfg.near_plane_offset_bias)

    def forward(self, depth_map: torch.Tensor, progress: float = 1.0,
                draws: Optional[Draws] = None) -> torch.Tensor:
        """depth_map [N, H, W, 1] -> [N, H, W, 1]. `draws` given: training's
        random pick; None: eval."""
        cfg, n = self.cfg, depth_map.shape[0]
        depth_range = self.max_depth - self.min_depth
        off = torch.sigmoid(self.near_plane_offset_raw) * cfg.near_plane_offset_max_fraction \
            * depth_range
        near_shifted = (self.min_depth + off).expand(n).reshape(n, 1, 1, 1)
        mid = 0.5 * (self.max_depth + near_shifted)
        x = (depth_map - mid) / ((self.max_depth - near_shifted) + 1e-12) * 2.0
        outs = [x]
        for i in range(cfg.num_hid_layers):
            x = getattr(self, f'layer{i}')(x)
            outs.append(self.head(x))
        stacked = torch.stack(outs, dim=1)  # [N, K+1, H, W, 1]
        k = len(outs)
        if cfg.out_strategy == 'last':
            return stacked[:, -1]
        if cfg.out_strategy == 'mean':
            return stacked.mean(dim=1)
        if draws is None:
            sel = torch.full((n,), k - 1, dtype=torch.long, device=depth_map.device)
        else:
            start_p = (1.0 / k) * (1.0 - progress) + cfg.selection_start_p * progress
            slope = (1.0 - k * start_p) * 2.0 / (k * (k - 1))
            probs = torch.arange(k, dtype=torch.float32, device=depth_map.device) * slope \
                + start_p
            log_probs = torch.log(probs + 1e-12)[None].expand(n, k)
            sel = draws.draw('select', lambda d: sample_categorical(d, log_probs))
            sel = torch.as_tensor(sel, device=depth_map.device).long()
        onehot = torch.nn.functional.one_hot(sel, k).to(stacked.dtype)
        return torch.einsum('nk,nkhwc->nhwc', onehot, stacked)
