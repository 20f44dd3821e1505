"""VGG16 with its fc7 features, the perceptual detector of PPL (port of
`tdgp/metrics/vgg.py`).

torchvision's VGG16 (13 convolutions of 3x3 with relu, 5 max pools, fc6,
fc7, fc8); the feature is the 4096-wide fc7 activation. Weights come from
the `.npz` that `scripts/convert_vgg.py` writes for the JAX package ('params/
conv<i>/{kernel,bias}', 'params/fc<6-8>/{kernel,bias}', fc6's rows in the
(h, w, c) order of a channels-last flatten). Preprocessing: uint8 -> [0, 1]
-> bilinear resize to 224^2 as `jax.image.resize` (antialiased where it
shrinks) -> ImageNet's mean and std.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tdgp_torch.metrics.inception import (Detector, load_weights, resize_bilinear,
                                          state_dict_from_flat)

VGG16_PLAN = (64, 64, 'M', 128, 128, 'M', 256, 256, 256, 'M',
              512, 512, 512, 'M', 512, 512, 512, 'M')
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

__all__ = ['VGG16', 'load_weights', 'make_detector', 'preprocess']


class VGG16(nn.Module):
    """images [N, 3, H, W] -> (fc7 features [N, 4096], logits [N, num_classes]).
    `fc6_in` is 7 x 7 x 512 at 224^2 (H x W / 1024 x 512 elsewhere)."""

    def __init__(self, num_classes: int = 1000, fc6_in: int = 7 * 7 * 512):
        super().__init__()
        cin, i = 3, 0
        for spec in VGG16_PLAN:
            if spec != 'M':
                setattr(self, f'conv{i}', nn.Conv2d(cin, spec, 3, padding=1))
                cin, i = spec, i + 1
        self.fc6 = nn.Linear(fc6_in, 4096)
        self.fc7 = nn.Linear(4096, 4096)
        self.fc8 = nn.Linear(4096, num_classes)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        i = 0
        for spec in VGG16_PLAN:
            if spec == 'M':
                x = F.max_pool2d(x, 2, stride=2)
            else:
                x = F.relu(getattr(self, f'conv{i}')(x))
                i += 1
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flattened channels-last
        feats = F.relu(self.fc7(F.relu(self.fc6(x))))
        return feats, self.fc8(feats)


def preprocess(images_uint8, size: int = 224, device=None) -> torch.Tensor:
    x = torch.as_tensor(images_uint8, device=device).permute(0, 3, 1, 2).float() / 255.0
    x = resize_bilinear(x, size)
    mean = torch.tensor(IMAGENET_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


def make_detector(flat: Dict[str, np.ndarray], size: int = 224,
                  device: Union[str, torch.device] = 'cpu') -> Detector:
    """The fc7 detector of converted weights (`load_weights`), its input
    resized to size^2."""
    model = VGG16(num_classes=int(flat['params/fc8/bias'].shape[0]),
                  fc6_in=int(flat['params/fc6/kernel'].shape[0]))
    model.load_state_dict(state_dict_from_flat(flat))
    return Detector(model.to(device), lambda images, device: preprocess(images, size, device))
