"""Serving path: batch classification over the padded head.

Counterpart of the JAX package's ``engine/predict.py``.  The reference has
no inference entry point beyond ad-hoc ``validate`` loops; deployment of an
incrementally-trained classifier needs a stable predict API.
``make_predict_fn`` returns a function mapping raw uint8 images to
(labels, probabilities) through the deterministic test transform (the
preprocessing of the engine's query path), the eval-mode backbone and the
masked logits of the padded head; ``decode_labels`` resolves the labels
to human-readable names through a checkpoint's ``label2human``.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import numpy as np
import torch

from ..data.transforms import transforms_test_options
from ..models import head as head_lib
from ..ops import augment as aug_ops
from ..utils.device import resolve_device


def make_predict_fn(backbone: torch.nn.Module, head: head_lib.Head,
                    transform: str = "A", device="cuda"):
    """Returns ``predict(images_u8 (B, H, W, 3)) -> (labels (B,), probs
    (B, C))``, run under ``torch.inference_mode`` on ``device`` (``cuda``
    unless the caller asks for ``cpu``; a batch elsewhere is moved there).
    It serves an eval-mode copy of ``backbone`` taken now, so the caller's
    module keeps its device and mode.  The head's rows past ``n_active``
    get probability 0; a tie goes to the lowest row."""
    _, test_spec = transforms_test_options[transform]
    dev = resolve_device(device)
    model = copy.deepcopy(backbone).to(dev).eval()
    weight = head.weight.to(dev, torch.float32)
    bias = None if head.bias is None else head.bias.to(dev, torch.float32)

    @torch.inference_mode()
    def predict(images_u8):
        x = torch.as_tensor(images_u8).to(dev)
        x = aug_ops.normalize_batch(x, test_spec).permute(0, 3, 1, 2)
        feats = model(x.contiguous())
        logits = head_lib.masked_logits(feats, weight, bias, head.n_active)
        return logits.argmax(-1), torch.softmax(logits, -1)

    return predict


def decode_labels(labels, label2human: Sequence[str],
                  training_classes: Optional[dict] = None):
    """Map predicted row indices back to human-readable names.  Base rows
    (relabel via basec_map) and appended novel rows both resolve through
    the checkpoint's ``label2human`` metadata."""
    if torch.is_tensor(labels):
        labels = labels.cpu().numpy()
    rev = {}
    if training_classes:
        rev = {v: k for k, v in training_classes.items()}
    out = []
    for l in np.asarray(labels).tolist():
        orig = rev.get(l, l)
        name = (label2human[orig]
                if 0 <= orig < len(label2human) else str(orig))
        out.append(name if name else str(orig))
    return out
