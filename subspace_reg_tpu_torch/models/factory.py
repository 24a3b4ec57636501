"""Model factory (reference models/util.py:6-35 dispatch semantics).

``create_model`` returns the backbone ``nn.Module``; the classifier head is
a separate padded buffer (models/head.py), loaded from a checkpoint by
``weights.load_checkpoint``.
"""

from __future__ import annotations

from torch import nn

from .resnet import resnet_builder
from .vit import vit_b16

# factories mirror reference models/resnet_language.py:408-479
model_dict = {
    "resnet12": resnet_builder((1, 1, 1, 1)),
    "resnet18": resnet_builder((1, 1, 2, 2)),
    "resnet24": resnet_builder((2, 2, 2, 2)),
    "resnet50": resnet_builder((3, 4, 6, 3)),
    "resnet101": resnet_builder((3, 4, 23, 3)),
    "seresnet12": resnet_builder((1, 1, 1, 1), use_se=True),
    "seresnet18": resnet_builder((1, 1, 2, 2), use_se=True),
    "seresnet24": resnet_builder((2, 2, 2, 2), use_se=True),
    "seresnet50": resnet_builder((3, 4, 6, 3), use_se=True),
    "seresnet101": resnet_builder((3, 4, 23, 3), use_se=True),
    # the one transformer backbone (models/vit.py)
    "vit_b16": vit_b16,
}

# DropBlock's block size per dataset (reference models/util.py:16-18,27):
# 5 on the 84 px datasets, 2 on CIFAR's 32 px images
DROPBLOCK_SIZE = {"miniImageNet": 5, "tieredImageNet": 5, "CIFAR-FS": 2,
                  "FC100": 2}


def create_model(name: str, opt, dataset: str = "miniImageNet",
                 dtype=None) -> nn.Module:
    """avg_pool=True, drop_rate=0.1 and the dataset's DropBlock size.
    ``dtype=torch.bfloat16`` is the resnets' pretraining compute path
    (``vit_b16`` runs in f32 only)."""
    if dataset not in DROPBLOCK_SIZE:
        raise NotImplementedError(f"dataset not supported: {dataset}")
    if name not in model_dict:
        raise NotImplementedError(
            "model {} not supported in dataset {}".format(name, dataset))
    return model_dict[name](avg_pool=True, drop_rate=0.1,
                            dropblock_size=DROPBLOCK_SIZE[dataset],
                            no_dropblock=bool(getattr(opt, "no_dropblock",
                                                      False)),
                            dtype=dtype)
