"""The benchmark's door into the program under test: the backbone as the
port's model factory builds it for a configuration.
"""

from __future__ import annotations

import functools


def build_backbone(cfg: dict, opt, dtype=None, sizes=None):
    """Model ``cfg["model"]`` as the CLIs build it
    (``models.factory.create_model``: drop rate 0.1, the dataset's
    DropBlock size).  ``sizes``, the CPU tests' tiny sizes (the backbone
    reference's ``TINY``), go to the model's builder by name on top of
    the factory's arguments."""
    from subspace_reg_tpu_torch.models import factory
    name = cfg["model"]
    if not sizes:
        return factory.create_model(name, opt, dataset=opt.dataset,
                                    dtype=dtype)
    build = factory.model_dict[name]
    factory.model_dict[name] = functools.partial(build, **sizes)
    try:
        return factory.create_model(name, opt, dataset=opt.dataset,
                                    dtype=dtype)
    finally:
        factory.model_dict[name] = build
