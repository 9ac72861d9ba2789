"""DenseNet feature backbone (torchvision layout).

Counterpart of ``recurrent_fusion_network_tpu/data/feature_extraction/
densenet_jax.py``, the reference's torchvision-DenseNet-161 extractor: dense
layers (BN -> ReLU -> 1x1 -> BN -> ReLU -> 3x3, concatenated on channels),
transitions (BN -> ReLU -> 1x1, then a 2x2 stride-2 average pool), the final
BN + ReLU; then

  fc  = global spatial mean of the final map   (2208,) for -161
  att = the map, adaptive-average-pooled to (att_size, att_size)

Parameters are a flat dict keyed by torchvision's state-dict names
(``features.denseblock1.denselayer1.norm1.weight``, ...), so a torchvision
``densenet*.pth`` loads by picking its keys.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .resnet import bn, bn_shapes, conv, fc_att, init_params, max_pool, normalize_nchw, \
    pick_state_dict


@dataclasses.dataclass(frozen=True)
class DenseNetConfig:
    blocks: Tuple[int, ...] = (6, 12, 36, 24)  # densenet-161
    growth: int = 48
    init_features: int = 96
    bn_size: int = 4
    att_size: int = 7

    @classmethod
    def densenet121(cls):
        return cls(blocks=(6, 12, 24, 16), growth=32, init_features=64)

    @classmethod
    def densenet161(cls):
        return cls(blocks=(6, 12, 36, 24), growth=48, init_features=96)

    @property
    def out_features(self) -> int:
        c = self.init_features
        for i, n in enumerate(self.blocks):
            c += n * self.growth
            if i < len(self.blocks) - 1:
                c = c // 2
        return c


def param_shapes(config: DenseNetConfig = DenseNetConfig()) -> Dict[str, tuple]:
    """{torchvision name: shape} of every parameter the trunk reads."""
    c0 = config.init_features
    shapes = {"features.conv0.weight": (c0, 3, 7, 7), **bn_shapes("features.norm0", c0)}
    c, inter = c0, config.bn_size * config.growth
    for bi, n_layers in enumerate(config.blocks, start=1):
        for li in range(1, n_layers + 1):
            pre = f"features.denseblock{bi}.denselayer{li}"
            shapes.update({**bn_shapes(pre + ".norm1", c),
                           f"{pre}.conv1.weight": (inter, c, 1, 1),
                           **bn_shapes(pre + ".norm2", inter),
                           f"{pre}.conv2.weight": (config.growth, inter, 3, 3)})
            c += config.growth
        if bi < len(config.blocks):
            pre = f"features.transition{bi}"
            shapes.update({**bn_shapes(pre + ".norm", c),
                           f"{pre}.conv.weight": (c // 2, c, 1, 1)})
            c //= 2
    shapes.update(bn_shapes("features.norm5", c))
    return shapes


def densenet_init(generator: torch.Generator, config: DenseNetConfig = DenseNetConfig()
                  ) -> Dict[str, torch.Tensor]:
    return init_params(param_shapes(config), generator)


def densenet_features(params, images, config: DenseNetConfig = DenseNetConfig()):
    """images (B, H, W, 3) in [0, 1] -> (fc (B, C), att (B, S, S, C))."""
    p = params
    x = normalize_nchw(images)
    x = torch.relu(bn(conv(x, p["features.conv0.weight"], 2), p, "features.norm0"))
    x = max_pool(x)
    for bi, n_layers in enumerate(config.blocks, start=1):
        for li in range(1, n_layers + 1):
            pre = f"features.denseblock{bi}.denselayer{li}"
            h = conv(torch.relu(bn(x, p, pre + ".norm1")), p[pre + ".conv1.weight"])
            h = conv(torch.relu(bn(h, p, pre + ".norm2")), p[pre + ".conv2.weight"])
            x = torch.cat([x, h], dim=1)
        if bi < len(config.blocks):
            pre = f"features.transition{bi}"
            x = conv(torch.relu(bn(x, p, pre + ".norm")), p[pre + ".conv.weight"])
            x = F.avg_pool2d(x, 2, 2)
    x = torch.relu(bn(x, p, "features.norm5"))
    return fc_att(x, config.att_size)


def load_torch_state_dict(state_dict, config: DenseNetConfig = DenseNetConfig()
                          ) -> Dict[str, torch.Tensor]:
    """A torchvision DenseNet state dict (``features.*`` names) -> this
    module's parameters; the classifier and batch counters are left out."""
    return pick_state_dict(state_dict, param_shapes(config))
