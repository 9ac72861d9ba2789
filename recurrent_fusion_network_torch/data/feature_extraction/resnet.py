"""ResNet v1 feature backbone (torchvision layout).

Counterpart of ``recurrent_fusion_network_tpu/data/feature_extraction/
resnet_jax.py``, the reference's torchvision-ResNet extractor
(resnet_utils.py:28-50 myResnet): the conv stack, then

  fc  = global spatial mean of the last stage          (C,)
  att = the last stage, adaptive-average-pooled to (att_size, att_size)
        with torch's bins when it is not that size already  (S, S, C)

Parameters are a flat dict keyed by torchvision's state-dict names
(``conv1.weight``, ``layer1.0.bn1.running_var``, ...), conv weights OIHW, so
a torchvision ``resnet*.pth`` loads by picking its keys
(``load_torch_state_dict``). Inference-mode batch norm (eps 1e-5), convs
with torch's symmetric padding, the stride on each stage's first 3x3 conv.
Images come in NHWC in [0, 1]; the trunk runs NCHW and ``att`` goes back to
(B, S, S, C), so callers flatten its positions in (y, x) order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    blocks: Tuple[int, ...] = (3, 4, 23, 3)  # resnet-101
    width: int = 64
    att_size: int = 14

    @classmethod
    def resnet50(cls):
        return cls(blocks=(3, 4, 6, 3))

    @classmethod
    def resnet101(cls):
        return cls(blocks=(3, 4, 23, 3))

    @classmethod
    def resnet152(cls):
        return cls(blocks=(3, 8, 36, 3))


# ---------------------------------------------------------------- primitives

BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def bn_shapes(prefix: str, c: int) -> Dict[str, tuple]:
    return {f"{prefix}.{leaf}": (c,) for leaf in BN_LEAVES}


def init_params(shapes: Dict[str, tuple], generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """He-normal conv weights (std sqrt(2 / fan_in)) drawn in name order from
    ``generator`` (on the CPU, so every device gets the same weights);
    identity batch norm."""
    out = {}
    for name, shape in shapes.items():
        if len(shape) == 4:
            fan = shape[1] * shape[2] * shape[3]
            out[name] = torch.randn(shape, generator=generator) * math.sqrt(2.0 / fan)
        elif name.endswith(("weight", "running_var", "scale", "var")):
            out[name] = torch.ones(shape)
        else:
            out[name] = torch.zeros(shape)
    return out


def pick_state_dict(state_dict, shapes: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
    """The entries of ``shapes`` from a state dict (tensors or arrays), as f32
    tensors; a missing name raises KeyError, a wrong shape ValueError, extra
    entries (a classifier, ``num_batches_tracked``) are left out."""
    out = {}
    for name, shape in shapes.items():
        v = torch.as_tensor(state_dict[name]).to(torch.float32)
        if tuple(v.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(v.shape)}, expected {tuple(shape)}")
        out[name] = v
    return out


def conv(x, w, stride=1):
    """Conv with torch's symmetric padding (k-1)//2 on each side."""
    return F.conv2d(x, w, stride=stride, padding=((w.shape[2] - 1) // 2, (w.shape[3] - 1) // 2))


def bn(x, p, prefix, eps=1e-5):
    """Inference-mode batch norm on NCHW with a ``prefix``'s four leaves:
    (x - mean) / sqrt(var + eps) * weight + bias, one pass."""
    return F.batch_norm(x, p[prefix + ".running_mean"], p[prefix + ".running_var"],
                        p[prefix + ".weight"], p[prefix + ".bias"], training=False, eps=eps)


def max_pool(x):
    """torch MaxPool2d(3, 2, 1)."""
    return F.max_pool2d(x, 3, 2, 1)


def normalize_nchw(images):
    """(B, H, W, 3) in [0, 1] -> ImageNet-normalized (B, 3, H, W)."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=images.dtype, device=images.device)
    std = torch.tensor(IMAGENET_STD, dtype=images.dtype, device=images.device)
    return ((images - mean) / std).permute(0, 3, 1, 2)


def fc_att(x, att_size: int):
    """(B, C, H, W) final map -> (fc (B, C), att (B, S, S, C)): the spatial
    mean, and the map itself when it is S x S, else F.adaptive_avg_pool2d's
    bins (resnet_utils.py:13-25)."""
    fc = x.mean(dim=(2, 3))
    S = att_size
    att = x if x.shape[2] == S and x.shape[3] == S else F.adaptive_avg_pool2d(x, S)
    return fc, att.permute(0, 2, 3, 1)


# ------------------------------------------------------------------- builder


def stride_of(stage: int, block: int) -> int:
    return 2 if stage > 1 and block == 0 else 1


def param_shapes(config: ResNetConfig = ResNetConfig()) -> Dict[str, tuple]:
    """{torchvision name: shape} of every parameter the trunk reads."""
    w = config.width
    shapes = {"conv1.weight": (w, 3, 7, 7), **bn_shapes("bn1", w)}
    cin = w
    for stage, n_blocks in enumerate(config.blocks, start=1):
        planes = w * 2 ** (stage - 1)
        cout = planes * 4
        for b in range(n_blocks):
            pre = f"layer{stage}.{b}"
            shapes.update({f"{pre}.conv1.weight": (planes, cin, 1, 1),
                           **bn_shapes(pre + ".bn1", planes),
                           f"{pre}.conv2.weight": (planes, planes, 3, 3),
                           **bn_shapes(pre + ".bn2", planes),
                           f"{pre}.conv3.weight": (cout, planes, 1, 1),
                           **bn_shapes(pre + ".bn3", cout)})
            if b == 0 and (stride_of(stage, b) != 1 or cin != cout):
                shapes.update({f"{pre}.downsample.0.weight": (cout, cin, 1, 1),
                               **bn_shapes(pre + ".downsample.1", cout)})
            cin = cout
    return shapes


def resnet_init(generator: torch.Generator, config: ResNetConfig = ResNetConfig()
                ) -> Dict[str, torch.Tensor]:
    return init_params(param_shapes(config), generator)


def _bottleneck(x, p, pre, stride):
    out = torch.relu(bn(conv(x, p[pre + ".conv1.weight"]), p, pre + ".bn1"))
    out = torch.relu(bn(conv(out, p[pre + ".conv2.weight"], stride), p, pre + ".bn2"))
    out = bn(conv(out, p[pre + ".conv3.weight"]), p, pre + ".bn3")
    if pre + ".downsample.0.weight" in p:
        x = bn(conv(x, p[pre + ".downsample.0.weight"], stride), p, pre + ".downsample.1")
    return torch.relu(out + x)


def resnet_features(params, images, config: ResNetConfig = ResNetConfig()):
    """images: (B, H, W, 3) float in [0, 1] (448 -> an exact 14 x 14 grid).
    Returns (fc (B, C), att (B, S, S, C)) with C = width * 32."""
    x = normalize_nchw(images)
    x = torch.relu(bn(conv(x, params["conv1.weight"], 2), params, "bn1"))
    x = max_pool(x)
    for stage, n_blocks in enumerate(config.blocks, start=1):
        for b in range(n_blocks):
            x = _bottleneck(x, params, f"layer{stage}.{b}", stride_of(stage, b))
    return fc_att(x, config.att_size)


def load_torch_state_dict(state_dict, config: ResNetConfig = ResNetConfig()
                          ) -> Dict[str, torch.Tensor]:
    """A torchvision ResNet state dict -> this module's parameters (the same
    names; the classifier and the batch counters are left out)."""
    return pick_state_dict(state_dict, param_shapes(config))
