"""Offline CNN feature extraction.

Counterpart of ``recurrent_fusion_network_tpu/data/feature_extraction``:
the ResNet, DenseNet and Inception backbones (``backbones.build_backbone``),
the 10-variant augmentation (flip, 4 corner crops, flip-crops) as batched
tensor ops, and the extraction CLI (``extract``) writing packed or sharded
feature stores that the loader reads.

Pretrained weights load from a torchvision-format state dict
(``resnet.load_torch_state_dict``) or the JAX package's flat npz
(``inception.load_flat_npz``); none ship with the repository.
"""

from .augment import VARIANT_BOXES, make_variants  # noqa: F401
from .resnet import ResNetConfig, resnet_features, resnet_init  # noqa: F401
