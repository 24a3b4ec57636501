"""Distillation: criteria, projection heads, alias sampling and the NCE
memory banks (counterpart of ``subspace_reg_tpu/distill``)."""

from .alias import AliasSampler
from .criterion import (DistillKL, attention_loss, hint_loss, nce_loss,
                        nce_softmax_loss)
from .embed import Embed, LinearEmbed, MLPEmbed, l2_normalize
from .nce import NCEAverageState, init_nce_average, nce_forward

__all__ = ["AliasSampler", "DistillKL", "nce_loss", "nce_softmax_loss",
           "attention_loss", "hint_loss", "NCEAverageState",
           "init_nce_average", "nce_forward", "Embed", "LinearEmbed",
           "MLPEmbed", "l2_normalize"]
