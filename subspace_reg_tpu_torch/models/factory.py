"""Model factory (reference models/util.py:6-35 dispatch semantics).

``create_model`` returns the backbone ``nn.Module``; the classifier head is
a separate padded buffer (models/head.py), loaded from a checkpoint by
``weights.load_checkpoint``.
"""

from __future__ import annotations

from .resnet import ResNetRFS, model_dict


def create_model(name: str, opt, dataset: str = "miniImageNet",
                 dtype=None) -> ResNetRFS:
    """avg_pool=True, drop_rate=0.1, dropblock_size=5 for the 84 px
    datasets (reference models/util.py:16-18).  ``dtype=torch.bfloat16``
    is the pretraining compute path."""
    if dataset not in ("miniImageNet", "tieredImageNet"):
        raise NotImplementedError(
            f"dataset {dataset}: only the 84px datasets are ported")
    if name not in model_dict:
        raise NotImplementedError(
            "model {} not supported in dataset {}".format(name, dataset))
    return model_dict[name](avg_pool=True, drop_rate=0.1, dropblock_size=5,
                            no_dropblock=bool(getattr(opt, "no_dropblock",
                                                      False)),
                            dtype=dtype)
