"""Weights in and out of the port.

``from_jax_variables`` is the inverse of the JAX package's
``utils/torch_import.py::import_backbone`` (:41-99): it maps a JAX variables
tree, as numpy arrays, onto a torch state dict with the reference's key
names, so one backbone can be held in both packages.  ``load_checkpoint``
reads a reference ``.pth`` (``{"model": state_dict, "training_classes":
..., "label2human": ...}``, train_supervised.py:180-202), whose state dict
loads through ``load_state_dict`` unchanged.

``save_checkpoint`` writes that same ``.pth`` layout from a trained
backbone and head, so the port's ``load_checkpoint`` and the JAX package's
``utils/torch_import.py::import_checkpoint`` both read what pretraining
saves.

Reading and writing the JAX package's own ``.ckpt`` format (flax msgpack,
utils/checkpoint.py:73-132) is still to be ported (ROADMAP.md queue A
item 4).  A ``.pth`` may carry the label->image LinearMap of the mapping
attractor (``mapping_linear_label2image``), which ``load_checkpoint`` puts
in ``meta``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .models.head import Head

_CONV_KEYS = {"conv1", "conv2", "conv3"}
_BN_KEYS = {"bn1", "bn2", "bn3"}


def _bn(prefix: str, params: Mapping, stats: Mapping) -> Dict[str, np.ndarray]:
    return {prefix + "weight": params["scale"], prefix + "bias": params["bias"],
            prefix + "running_mean": stats["mean"],
            prefix + "running_var": stats["var"]}


def from_jax_variables(variables: Mapping[str, Any],
                       head: Optional[Any] = None) -> Dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats", "counters"}`` tree (numpy leaves) ->
    torch state dict: HWIO -> OIHW, ``scale`` -> ``weight``, ``mean/var`` ->
    ``running_*``, ``ds_conv/ds_bn`` -> ``downsample.{0,1}``, ``se.fc1/fc2``
    -> ``se.fc.{0,2}``, the block counter -> ``num_batches_tracked``.  With
    a ``head`` (weight, bias, n_active), its active rows become
    ``classifier.*``."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    counters = variables.get("counters", {})
    sd: Dict[str, np.ndarray] = {}
    for blk, mods in params.items():
        prefix = blk.replace("_", ".") + "."          # layer1_0 -> layer1.0.
        for mod, p in mods.items():
            if mod in _CONV_KEYS:
                sd[prefix + mod + ".weight"] = np.transpose(
                    np.asarray(p["kernel"]), (3, 2, 0, 1))
            elif mod in _BN_KEYS:
                sd.update(_bn(prefix + mod + ".", p, stats[blk][mod]))
            elif mod == "ds_conv":
                sd[prefix + "downsample.0.weight"] = np.transpose(
                    np.asarray(p["kernel"]), (3, 2, 0, 1))
            elif mod == "ds_bn":
                sd.update(_bn(prefix + "downsample.1.", p,
                              stats[blk]["ds_bn"]))
            elif mod == "se":
                for fc, idx in (("fc1", 0), ("fc2", 2)):
                    sd[f"{prefix}se.fc.{idx}.weight"] = np.asarray(
                        p[fc]["kernel"]).T
                    sd[f"{prefix}se.fc.{idx}.bias"] = np.asarray(p[fc]["bias"])
            else:
                raise KeyError(f"unknown JAX module {blk}/{mod}")
        if blk in counters:
            sd[prefix + "num_batches_tracked"] = np.asarray(
                counters[blk]["num_batches_tracked"], np.int64)
    if head is not None:
        n = int(head.n_active)
        sd["classifier.weight"] = np.asarray(head.weight)[:n]
        if head.bias is not None:
            sd["classifier.bias"] = np.asarray(head.bias)[:n]
    out = {}
    for k, v in sd.items():
        v = np.ascontiguousarray(v)
        out[k] = torch.from_numpy(v.astype(np.int64 if v.dtype.kind == "i"
                                           else np.float32))
    return out


def load_checkpoint(path: str, max_classes: Optional[int] = None):
    """Reference ``.pth`` -> (backbone state dict, padded Head, meta)."""
    if not path.endswith(".pth"):
        raise NotImplementedError(
            f"{path}: only reference .pth checkpoints load in the port; the "
            "JAX .ckpt reader is a ROADMAP.md queue A item")
    # the reference format pickles its argparse namespace beside the
    # weights, so it needs the full unpickler
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["model"]
    # the backbone's layer* stages; vocabulary remnants are ignored, as the
    # JAX importer ignores them
    backbone = {k: v for k, v in sd.items() if k.startswith("layer")}
    w = sd["classifier.weight"].detach().to(torch.float32)
    b = sd.get("classifier.bias")
    n_cls, in_dim = w.shape
    max_classes = max_classes or n_cls
    weight = torch.zeros((max_classes, in_dim))
    weight[:n_cls] = w
    bias = None
    if b is not None:
        bias = torch.zeros((max_classes,))
        bias[:n_cls] = b.detach().to(torch.float32)
    head = Head(weight=weight, bias=bias, n_active=n_cls)
    meta = {
        "training_classes": ckpt.get("training_classes"),
        "label2human": ckpt.get("label2human"),
        "epoch": ckpt.get("epoch"),
        "has_bias": "classifier.bias" in sd,
    }
    if "mapping_linear_label2image" in ckpt:
        # the learned label->image LinearMap of the mapping attractor
        msd = ckpt["mapping_linear_label2image"]
        meta["mapping_linear_label2image"] = {
            k: np.array(msd[f"map.{k}"].detach().cpu().numpy())
            for k in ("weight", "bias")}
    return backbone, head, meta


def save_checkpoint(path: str, backbone: torch.nn.Module,
                    head_w: torch.Tensor,
                    head_b: Optional[torch.Tensor] = None,
                    training_classes: Optional[Dict[int, int]] = None,
                    label2human=None, epoch: Optional[int] = None) -> None:
    """Write ``{"model": state_dict, "training_classes", "label2human",
    "epoch"}`` (reference train_supervised.py:180-202): the backbone's keys
    plus ``classifier.weight`` (and ``classifier.bias``); the class metadata
    only when given, as the continual protocol gives it."""
    sd = {k: v.detach().cpu().clone() for k, v in
          backbone.state_dict().items()}
    sd["classifier.weight"] = head_w.detach().to(torch.float32).cpu().clone()
    if head_b is not None:
        sd["classifier.bias"] = head_b.detach().to(torch.float32).cpu().clone()
    ckpt: Dict[str, Any] = {"model": sd, "epoch": epoch}
    if training_classes is not None:
        ckpt["training_classes"] = training_classes
    if label2human is not None:
        ckpt["label2human"] = label2human
    torch.save(ckpt, path)
