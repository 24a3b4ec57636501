"""The benchmark's door into the program under test: the backbone as the
port's model factory builds it for a configuration.
"""

from __future__ import annotations


def build_backbone(cfg: dict, opt, dtype=None):
    """The configuration's backbone as the CLIs build it
    (``models.factory.create_model``: drop rate 0.1, the dataset's
    DropBlock size), at the configuration's widths."""
    from subspace_reg_tpu_torch.models.factory import (DROPBLOCK_SIZE,
                                                       create_model)
    from subspace_reg_tpu_torch.models.resnet import WIDTHS, model_dict
    if tuple(cfg["widths"]) == tuple(WIDTHS):
        return create_model(opt.model, opt, dataset=opt.dataset,
                            dtype=dtype)
    return model_dict[cfg["model"]](
        avg_pool=True, drop_rate=cfg["drop_rate"],
        dropblock_size=DROPBLOCK_SIZE[opt.dataset],
        no_dropblock=bool(cfg["no_dropblock"]), widths=cfg["widths"],
        dtype=dtype)
