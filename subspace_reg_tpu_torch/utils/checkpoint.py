"""The JAX package's ``.ckpt`` checkpoints, without JAX.

A ``.ckpt`` is a pickled ``{"msgpack": bytes, "meta": dict, "has_bias":
bool}`` whose ``msgpack`` blob holds the tree ``{"variables",
"head_weight", "head_bias", "head_n_active"[, "extra"]}`` (JAX
``utils/checkpoint.py:73-132``): ``variables`` is the JAX backbone's
``{"params", "batch_stats", "counters"}`` tree (HWIO kernels), the head
bias is ``zeros((0,))`` when there is none, and ``extra`` carries what a
resume needs (the optimizer state in optax's state-dict form and the
step).  The blob is packed by ``utils/msgpack_codec.py``, byte for byte as
flax packs it.

``load_any`` is what the CLIs call: a reference ``.pth`` goes to
``weights.load_pth``, a ``.ckpt`` is read here, its head padded on
the host, and both come back as (torch state dict, ``Head``, meta).
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models.head import Head
from . import msgpack_codec


def _numpy(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


def _tree_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tree_numpy(v) for k, v in tree.items()}
    return _numpy(tree)


def save_checkpoint(path: str, variables: Dict[str, Any], head: Head,
                    meta: Optional[Dict[str, Any]] = None,
                    extra: Optional[Dict[str, Any]] = None) -> None:
    """Write ``path`` as JAX ``save_checkpoint`` does.  ``variables``: the
    JAX-form backbone tree (``weights.to_jax_variables``); ``head``: its
    weight, optional bias and ``n_active``; ``extra``: a tree already in
    state-dict form (nested dicts of arrays)."""
    blob_tree = {
        "variables": _tree_numpy(variables),
        "head_weight": _numpy(head.weight),
        "head_bias": (_numpy(head.bias) if head.bias is not None
                      else np.zeros((0,), np.float32)),
        "head_n_active": np.asarray(int(head.n_active)),
    }
    if extra is not None:
        blob_tree["extra"] = _tree_numpy(extra)
    blob = msgpack_codec.msgpack_serialize(blob_tree)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"msgpack": blob, "meta": meta or {},
                     "has_bias": head.bias is not None}, f)


def load_checkpoint(path: str):
    """(variables, head, meta) with numpy leaves, as JAX
    ``load_checkpoint(path, device=False)`` returns them; the head's
    ``n_active`` is a Python int and ``meta["extra"]`` the saved
    ``extra`` tree, if any.  The outer dict is read with ``pickle``: its
    ``meta`` may hold numpy scalars, which ``torch.load`` refuses."""
    with open(path, "rb") as f:
        raw = pickle.load(f)
    tree = msgpack_codec.msgpack_restore(raw["msgpack"])
    head = Head(weight=tree["head_weight"],
                bias=tree["head_bias"] if raw["has_bias"] else None,
                n_active=int(tree["head_n_active"]))
    meta = dict(raw["meta"])
    if "extra" in tree:
        meta["extra"] = tree["extra"]
    return tree["variables"], head, meta


def _pad_head(head: Head, max_classes: Optional[int]) -> Head:
    """The head's active rows in a zero ``max_classes``-row buffer, on the
    host (JAX ``load_any``, utils/checkpoint.py:180-189)."""
    if max_classes is None or head.weight.shape[0] == max_classes:
        return head
    n = int(head.n_active)
    w = np.zeros((max_classes, head.weight.shape[1]), np.float32)
    w[:n] = np.asarray(head.weight)[:n]
    b = None
    if head.bias is not None:
        b = np.zeros((max_classes,), np.float32)
        b[:n] = np.asarray(head.bias)[:n]
    return Head(weight=w, bias=b, n_active=n)


def load_any(path: str, max_classes: Optional[int] = None):
    """A reference ``.pth`` or a ``.ckpt`` -> (backbone state dict, padded
    ``Head`` of torch tensors, meta with ``has_bias``)."""
    from ..weights import from_jax_variables, load_pth
    if path.endswith(".pth"):
        return load_pth(path, max_classes=max_classes)
    variables, head, meta = load_checkpoint(path)
    head = _pad_head(head, max_classes)
    meta["has_bias"] = head.bias is not None
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    return (from_jax_variables(variables),
            Head(weight=t(head.weight),
                 bias=None if head.bias is None else t(head.bias),
                 n_active=int(head.n_active)), meta)
