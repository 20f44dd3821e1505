"""The FID InceptionV3 in PyTorch (port of `tdgp/metrics/inception.py`).

torchvision's InceptionV3 topology (BasicConv2d = conv without bias -> batch
norm (eps 1e-3, running statistics) -> relu; the stem, Mixed_5b .. Mixed_7c,
a global average pool to the 2048 pool features, the fc logits), with the
module names of torchvision and pytorch-fid. Weights come from the `.npz`
that `scripts/convert_inception.py` writes for the JAX package (its flax
layout: 'params/<module>/conv/kernel' HWIO, 'params/<module>/bn/{scale,bias}',
'batch_stats/<module>/bn/{mean,var}', 'params/fc/{kernel,bias}', and the
'__meta__/fid_pool' marker). `fid_pool` selects pytorch-fid's branch pools
without the padding in their counts (`count_include_pad=False`), which its
pt_inception-2015-12-05 weights need. Preprocessing as pytorch-fid: uint8 ->
[0, 1] -> bilinear resize to 299^2 with half-pixel centres (antialiased
where it shrinks, as `jax.image.resize` does) -> [-1, 1].
"""
from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tdgp_torch.utils.misc import exact_fp32


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel_size, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avgpool3(x: torch.Tensor, fid_pool: bool) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=not fid_pool)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, fid_pool: bool = False):
        super().__init__()
        self.fid_pool = fid_pool
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avgpool3(x, self.fid_pool))
        return torch.cat([self.branch1x1(x), b5, bd, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int, fid_pool: bool = False):
        super().__init__()
        self.fid_pool = fid_pool
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f'branch7x7dbl_{i}')(bd)
        bp = self.branch_pool(_avgpool3(x, self.fid_pool))
        return torch.cat([self.branch1x1(x), b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f'branch7x7x3_{i}')(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, fid_pool: bool = False):
        super().__init__()
        self.fid_pool = fid_pool
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = self.branch_pool(_avgpool3(x, self.fid_pool))
        return torch.cat([self.branch1x1(x), b3, bd, bp], 1)


class InceptionV3FID(nn.Module):
    """images [N, 3, H, W] in [-1, 1] -> (pool features [N, 2048], logits
    [N, num_logits]); 75^2 is the smallest input it takes."""

    def __init__(self, num_logits: int = 1008, fid_pool: bool = False):
        super().__init__()
        fp = fid_pool
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, fp)
        self.Mixed_5c = InceptionA(256, 64, fp)
        self.Mixed_5d = InceptionA(288, 64, fp)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, fp)
        self.Mixed_6c = InceptionC(768, 160, fp)
        self.Mixed_6d = InceptionC(768, 160, fp)
        self.Mixed_6e = InceptionC(768, 192, fp)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, fp)
        self.Mixed_7c = InceptionE(2048, fp)
        self.fc = nn.Linear(2048, num_logits)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = F.max_pool2d(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)), 3, stride=2)
        for name in ('Mixed_5b', 'Mixed_5c', 'Mixed_5d', 'Mixed_6a', 'Mixed_6b', 'Mixed_6c',
                     'Mixed_6d', 'Mixed_6e', 'Mixed_7a', 'Mixed_7b', 'Mixed_7c'):
            x = getattr(self, name)(x)
        feats = x.mean(dim=(2, 3))
        return feats, self.fc(feats)


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """[N, C, H, W] -> [N, C, size, size] as `jax.image.resize(...,
    'bilinear')`: half-pixel centres, and a triangle filter widened by the
    scale where it shrinks (antialias)."""
    h, w = x.shape[-2:]
    if (h, w) == (size, size):
        return x
    return F.interpolate(x, size=(size, size), mode='bilinear', align_corners=False,
                         antialias=size < h or size < w)


def preprocess(images_uint8, size: int = 299, device=None) -> torch.Tensor:
    """uint8 NHWC -> float32 NCHW at size^2 in [-1, 1] (pytorch-fid's convention)."""
    x = torch.as_tensor(images_uint8, device=device).permute(0, 3, 1, 2).float() / 255.0
    return resize_bilinear(x, size) * 2.0 - 1.0


def load_weights(path: str) -> Dict[str, np.ndarray]:
    """The converted `.npz`: {'<collection>/<module>/.../<name>': array}, the
    '__meta__/...' entries left out (`npz_meta` reads them)."""
    with np.load(path) as flat:
        return {k: flat[k] for k in flat.files if not k.startswith('__meta__')}


def npz_meta(path: str) -> Dict[str, Any]:
    """The converter's metadata ('__meta__/<name>' scalar arrays)."""
    with np.load(path) as flat:
        return {k[len('__meta__/'):]: np.asarray(flat[k]).item()
                for k in flat.files if k.startswith('__meta__/')}


_BN = {'params/scale': 'weight', 'params/bias': 'bias', 'batch_stats/mean': 'running_mean',
       'batch_stats/var': 'running_var'}


def state_dict_from_flat(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The flax layout of the converted weights as a state dict of the
    torch modules (convolutions HWIO -> OIHW, dense [in, out] -> [out, in]).
    Serves InceptionV3 ('conv'/'bn' scopes) and VGG16 (biased convolutions)."""
    out = {}
    for key, value in flat.items():
        collection, *scope, leaf = key.split('/')
        t = torch.from_numpy(np.ascontiguousarray(value))
        if scope[-1] == 'bn':
            out['.'.join(scope + [_BN[f'{collection}/{leaf}']])] = t
        elif leaf == 'kernel':
            t = t.permute(3, 2, 0, 1) if t.ndim == 4 else t.t()
            out['.'.join(scope + ['weight'])] = t.contiguous()
        elif leaf == 'bias':
            out['.'.join(scope + ['bias'])] = t
        else:
            raise ValueError(f'unmapped weight {key}')
    return out


class Detector:
    """detector(images uint8 [N, H, W, 3]) -> features [N, D] of `model` on
    its device after `preprocess`, float32 throughout (TF32 off); with
    `return_logits` (InceptionV3) the softmax of the logits instead."""

    def __init__(self, model: nn.Module, preprocess_fn, return_logits: bool = False):
        self.model = model.eval()
        self.preprocess = preprocess_fn
        self.return_logits = return_logits
        self.device = next(model.parameters()).device

    @torch.no_grad()
    def __call__(self, images) -> torch.Tensor:
        with exact_fp32():
            feats, logits = self.model(self.preprocess(images, device=self.device))
        return torch.softmax(logits, dim=-1) if self.return_logits else feats


def make_detector(flat: Dict[str, np.ndarray], return_logits: bool = False,
                  fid_pool: bool = False, device: Union[str, torch.device] = 'cpu') -> Detector:
    """The InceptionV3 detector of converted weights (`load_weights`); the
    number of logits from the fc bias (1008 for pytorch-fid's, 1000 for
    torchvision's)."""
    num_logits = int(flat['params/fc/bias'].shape[0]) if 'params/fc/bias' in flat else 1008
    model = InceptionV3FID(num_logits=num_logits, fid_pool=fid_pool)
    model.load_state_dict(state_dict_from_flat(flat))
    return Detector(model.to(device), preprocess, return_logits)
