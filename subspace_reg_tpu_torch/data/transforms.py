"""Transform registry — declarative augmentation specs.

The reference registers torchvision Compose pipelines 'A'/'A_test'/'D'/
'D_test' (dataset/transform_cfg.py:13-100).  Here each pipeline is a small
spec consumed by the batched tensor augmentation in ops/augment.py (a copy of
the JAX package's registry, so the two packages read identical specs).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

# dataset statistics (reference dataset/transform_cfg.py:8-9,50-51)
MINI_MEAN = (120.39586422 / 255.0, 115.59361427 / 255.0, 104.54012653 / 255.0)
MINI_STD = (70.68188272 / 255.0, 68.27635443 / 255.0, 72.54505529 / 255.0)
CIFAR_MEAN = (0.5071, 0.4867, 0.4408)
CIFAR_STD = (0.2675, 0.2565, 0.2761)


@dataclass(frozen=True)
class AugmentSpec:
    size: int
    padding: int
    random_crop: bool
    color_jitter: float      # 0.0 => off; reference uses 0.4
    hflip: bool
    mean: Tuple[float, float, float]
    std: Tuple[float, float, float]


def _train(size, pad, mean, std, jitter=0.4):
    return AugmentSpec(size, pad, True, jitter, True, mean, std)


def _test(size, mean, std):
    return AugmentSpec(size, 0, False, 0.0, False, mean, std)


# 'A': miniImageNet/tieredImageNet 84px (transform_cfg.py:13-30)
transform_A = (_train(84, 8, MINI_MEAN, MINI_STD),
               _test(84, MINI_MEAN, MINI_STD))
# 'A' eval-time: support transform drops ColorJitter (transform_cfg.py:32-47)
transform_A_test = (_train(84, 8, MINI_MEAN, MINI_STD, jitter=0.0),
                    _test(84, MINI_MEAN, MINI_STD))
# 'D': CIFAR 32px pad 4 (transform_cfg.py:53-69)
transform_D = (_train(32, 4, CIFAR_MEAN, CIFAR_STD),
               _test(32, CIFAR_MEAN, CIFAR_STD))
transform_D_test = (_train(32, 4, CIFAR_MEAN, CIFAR_STD, jitter=0.0),
                    _test(32, CIFAR_MEAN, CIFAR_STD))

transforms_list = ["A", "D"]
transforms_options = {"A": transform_A, "D": transform_D}
transforms_test_options = {"A": transform_A_test, "D": transform_D_test}
