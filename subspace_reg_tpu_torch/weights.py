"""Weights in and out of the port.

``from_jax_variables`` is the inverse of the JAX package's
``utils/torch_import.py::import_backbone`` (:41-99): it maps a JAX variables
tree, as numpy arrays, onto a torch state dict with the reference's key
names, so one backbone can be held in both packages; ``to_jax_variables``
maps it back.  ``optimizer_to_jax`` / ``optimizer_from_jax`` carry the
pretraining optimizer's state between ``torch.optim`` and the state-dict
form of the JAX package's optax chains (utils/optim.py:21-43).

``load_checkpoint`` reads a reference ``.pth`` (``{"model": state_dict,
"training_classes": ..., "label2human": ...}``, train_supervised.py:
180-202), whose state dict loads through ``load_state_dict`` unchanged, or
the JAX package's ``.ckpt`` (utils/checkpoint.py).  A ``.pth`` may carry
the label->image LinearMap of the mapping attractor
(``mapping_linear_label2image``), which ``load_pth`` puts in ``meta``.

``save_checkpoint`` writes the reference ``.pth`` layout from a trained
backbone (or its state dict) and head, with the mapping when given, so the
port's and the JAX package's ``.pth`` loaders both read it.  The
optimizer bridge also carries the contrastive embed heads' leaves.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .distill.embed import embed_to_jax
from .models.head import Head

_CONV_KEYS = {"conv1", "conv2", "conv3"}
_BN_KEYS = {"bn1", "bn2", "bn3"}


def _bn(prefix: str, params: Mapping,
        stats: Optional[Mapping]) -> Dict[str, np.ndarray]:
    out = {prefix + "weight": params["scale"], prefix + "bias": params["bias"]}
    if stats is not None:
        out.update({prefix + "running_mean": stats["mean"],
                    prefix + "running_var": stats["var"]})
    return out


def from_jax_variables(variables: Mapping[str, Any],
                       head: Optional[Any] = None) -> Dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats", "counters"}`` tree (numpy leaves) ->
    torch state dict: HWIO -> OIHW, ``scale`` -> ``weight``, ``mean/var`` ->
    ``running_*``, ``ds_conv/ds_bn`` -> ``downsample.{0,1}``, ``se.fc1/fc2``
    -> ``se.fc.{0,2}``, the block counter -> ``num_batches_tracked``.  With
    a ``head`` (weight, bias, n_active), its active rows become
    ``classifier.*``.  Without ``batch_stats`` (a tree of per-parameter
    optimizer state) only the parameters are mapped."""
    params = variables["params"]
    stats = variables.get("batch_stats")
    counters = variables.get("counters", {})
    sd: Dict[str, np.ndarray] = {}
    for blk, mods in params.items():
        prefix = blk.replace("_", ".") + "."          # layer1_0 -> layer1.0.
        for mod, p in mods.items():
            if mod in _CONV_KEYS:
                sd[prefix + mod + ".weight"] = np.transpose(
                    np.asarray(p["kernel"]), (3, 2, 0, 1))
            elif mod in _BN_KEYS:
                sd.update(_bn(prefix + mod + ".", p,
                              None if stats is None else stats[blk][mod]))
            elif mod == "ds_conv":
                sd[prefix + "downsample.0.weight"] = np.transpose(
                    np.asarray(p["kernel"]), (3, 2, 0, 1))
            elif mod == "ds_bn":
                sd.update(_bn(prefix + "downsample.1.", p,
                              None if stats is None else stats[blk]["ds_bn"]))
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


# the roots of a backbone's state-dict keys: the resnets' stages
# (``layer1.0.conv1.weight``) and the ViT's modules, named as timm names
# them (models/vit.py); everything else in a reference ``.pth`` is the
# classifier or a remnant of the vocabulary
_VIT_ROOTS = {"patch_embed", "cls_token", "pos_embed", "blocks", "norm"}


def _backbone_key(key: str) -> bool:
    return key.startswith("layer") or key.split(".", 1)[0] in _VIT_ROOTS


def load_checkpoint(path: str, max_classes: Optional[int] = None):
    """A reference ``.pth`` or a JAX ``.ckpt`` -> (backbone state dict,
    Head padded to ``max_classes`` rows, meta)."""
    from .utils.checkpoint import load_any
    return load_any(path, max_classes=max_classes)


def load_pth(path: str, max_classes: Optional[int] = None):
    """Reference ``.pth`` -> (backbone state dict, padded Head, meta)."""
    # the reference format pickles its argparse namespace beside the
    # weights, so it needs the full unpickler
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["model"]
    # the backbone's keys; the classifier and vocabulary remnants are
    # dropped, as the JAX importer drops them
    backbone = {k: v for k, v in sd.items() if _backbone_key(k)}
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


def save_checkpoint(path: str, backbone, head_w: torch.Tensor,
                    head_b: Optional[torch.Tensor] = None,
                    training_classes: Optional[Dict[int, int]] = None,
                    label2human=None, epoch: Optional[int] = None,
                    mapping: Optional[Mapping[str, Any]] = None) -> None:
    """Write ``{"model": state_dict, "training_classes", "label2human",
    "epoch"}`` (reference train_supervised.py:180-202): the keys of
    ``backbone`` (a module or its state dict) plus ``classifier.weight``
    (and ``classifier.bias``); the class metadata only when given, as the
    continual protocol gives it.  ``mapping`` (``{"weight": (out, in),
    "bias": (out,)}``) is stored as the reference's LinearMap state dict
    under ``mapping_linear_label2image`` (``map.weight``, ``map.bias``;
    reference learn_mapping.py:37-39)."""
    sd = backbone.state_dict() if isinstance(backbone, torch.nn.Module) \
        else backbone
    sd = {k: torch.as_tensor(v).detach().cpu().clone()
          for k, v in sd.items()}
    f32 = lambda t: torch.as_tensor(t).detach().to(  # noqa: E731
        torch.float32).cpu().clone()
    sd["classifier.weight"] = f32(head_w)
    if head_b is not None:
        sd["classifier.bias"] = f32(head_b)
    ckpt: Dict[str, Any] = {"model": sd, "epoch": epoch}
    if training_classes is not None:
        ckpt["training_classes"] = training_classes
    if label2human is not None:
        ckpt["label2human"] = label2human
    if mapping is not None:
        ckpt["mapping_linear_label2image"] = {
            f"map.{k}": f32(mapping[k]) for k in ("weight", "bias")}
    torch.save(ckpt, path)


def _jax_place(key: str) -> Optional[Tuple[str, List[str], Any]]:
    """Where a backbone state-dict entry lives in the JAX variables tree:
    (collection, path, transform), or None for what JAX does not keep
    (a BatchNorm's own ``num_batches_tracked``)."""
    parts = key.split(".")
    blk, rest = f"{parts[0]}_{parts[1]}", parts[2:]
    oihw = lambda a: np.transpose(a, (2, 3, 1, 0))     # noqa: E731
    same = lambda a: a                                  # noqa: E731
    if rest == ["num_batches_tracked"]:
        return ("counters", [blk, "num_batches_tracked"],
                lambda a: np.asarray(a, np.int32).reshape(()))
    if rest[0] in _CONV_KEYS:
        return "params", [blk, rest[0], "kernel"], oihw
    if rest[:2] == ["downsample", "0"]:
        return "params", [blk, "ds_conv", "kernel"], oihw
    if rest[0] == "se":
        fc = {"0": "fc1", "2": "fc2"}[rest[2]]
        if rest[3] == "weight":
            return "params", [blk, "se", fc, "kernel"], np.transpose
        return "params", [blk, "se", fc, "bias"], same
    if rest[0] in _BN_KEYS or rest[:2] == ["downsample", "1"]:
        mod = rest[0] if rest[0] in _BN_KEYS else "ds_bn"
        leaf = rest[-1]
        if leaf == "num_batches_tracked":
            return None
        coll, name = {"weight": ("params", "scale"),
                      "bias": ("params", "bias"),
                      "running_mean": ("batch_stats", "mean"),
                      "running_var": ("batch_stats", "var")}[leaf]
        return coll, [blk, mod, name], same
    raise KeyError(f"unknown backbone entry {key}")


def to_jax_variables(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Backbone state dict -> JAX ``{"params", "batch_stats", "counters"}``
    tree of numpy arrays, the inverse of ``from_jax_variables``: OIHW ->
    HWIO, ``weight/bias/running_*`` -> ``scale/bias/mean/var``,
    ``downsample.{0,1}`` -> ``ds_conv/ds_bn``, ``se.fc.{0,2}`` ->
    ``se.fc1/fc2``, the block counter -> ``counters`` (int32, as JAX keeps
    it).  Parameters in f32."""
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}, "counters": {}}
    for key, v in state_dict.items():
        place = _jax_place(key)
        if place is None:
            continue
        coll, path, fn = place
        a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)
        if coll != "counters":
            a = a.astype(np.float32)
        node = out[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.array(fn(a), order="C")
    return out


def _chain(optimizer: torch.optim.Optimizer) -> List[str]:
    """The parts of the JAX optax chain the optimizer corresponds to
    (utils/optim.py:21-43), in order: ``decay`` (add_decayed_weights)
    when there is weight decay, ``adam`` (scale_by_adam) or ``trace``
    (momentum) when there is momentum, then ``count`` (the learning-rate
    schedule's step count, as the JAX CLI schedules every step)."""
    g = optimizer.param_groups[0]
    parts = ["decay"] if g.get("weight_decay") else []
    if isinstance(optimizer, torch.optim.Adam):
        parts.append("adam")
    elif g.get("momentum"):
        parts.append("trace")
    return parts + ["count"]


def _param_tree(backbone: torch.nn.Module, head: Mapping[str, torch.Tensor],
                value, embeds: Optional[Mapping[str, torch.nn.Module]] = None
                ) -> Dict[str, Any]:
    """``{"backbone": JAX params tree, "head": {"w"[, "b"]}}`` of
    ``value(parameter)`` for each parameter (the JAX pretraining state's
    ``params`` layout), plus each contrastive embed head of ``embeds``
    (``{"embed_s": module, "embed_t": module}``) as its flax tree."""
    bb = {n: value(p) for n, p in backbone.named_parameters()}
    tree = {"backbone": to_jax_variables(bb)["params"],
            "head": {k: np.asarray(value(p), np.float32)
                     for k, p in head.items()}}
    for name, module in (embeds or {}).items():
        tree[name] = embed_to_jax(module, value)
    return tree


def optimizer_to_jax(optimizer: torch.optim.Optimizer,
                     backbone: torch.nn.Module,
                     head: Mapping[str, torch.Tensor],
                     step: int,
                     embeds: Optional[Mapping[str, torch.nn.Module]] = None
                     ) -> Dict[str, Any]:
    """``torch.optim.SGD``/``Adam`` state -> the optax chain's state dict
    (``flax.serialization.to_state_dict`` form): ``{"0": ..., "1": ...}``
    with ``{}`` for the decay, ``{"trace": params}`` for momentum,
    ``{"count", "mu", "nu"}`` for Adam and ``{"count"}`` for the
    schedule; a parameter without state yet (no step taken) gives zeros.
    ``embeds`` adds the contrastive embed heads' leaves."""
    def slot(name):
        def value(p):
            t = optimizer.state.get(p, {}).get(name)
            if t is None:
                return np.zeros(tuple(p.shape), np.float32)
            return t.detach().float().cpu().numpy()
        return value

    count = np.asarray(step, np.int32)
    out: Dict[str, Any] = {}
    for i, part in enumerate(_chain(optimizer)):
        if part == "decay":
            out[str(i)] = {}
        elif part == "trace":
            out[str(i)] = {"trace": _param_tree(
                backbone, head, slot("momentum_buffer"), embeds)}
        elif part == "adam":
            out[str(i)] = {"count": count,
                           "mu": _param_tree(backbone, head, slot("exp_avg"),
                                             embeds),
                           "nu": _param_tree(backbone, head,
                                             slot("exp_avg_sq"), embeds)}
        else:
            out[str(i)] = {"count": count}
    return out


def _named_state(backbone: torch.nn.Module, head: Mapping[str, torch.Tensor],
                 tree: Mapping[str, Any],
                 embeds: Optional[Mapping[str, torch.nn.Module]] = None):
    """(parameter, tensor value) pairs of a ``{"backbone", "head"}`` tree
    (and its embed heads' subtrees)."""
    sd = from_jax_variables({"params": tree["backbone"]})
    named = dict(backbone.named_parameters())
    missing = set(named) - set(sd)
    if missing:
        raise KeyError(f"optimizer state lacks {sorted(missing)[:3]}")
    pairs = [(named[n], sd[n]) for n in named]
    pairs += [(p, torch.from_numpy(np.array(tree["head"][k], np.float32)))
              for k, p in head.items()]
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    for name, module in (embeds or {}).items():
        for layer in module.layers:
            sub = tree[name][layer]
            pairs += [(getattr(module, layer).weight, t(sub["kernel"]).T),
                      (getattr(module, layer).bias, t(sub["bias"]))]
    return pairs


def optimizer_from_jax(optimizer: torch.optim.Optimizer,
                       backbone: torch.nn.Module,
                       head: Mapping[str, torch.Tensor],
                       tree: Mapping[str, Any],
                       embeds: Optional[Mapping[str, torch.nn.Module]] = None
                       ) -> int:
    """The inverse of ``optimizer_to_jax``: sets each parameter's
    ``momentum_buffer`` (SGD) or ``exp_avg``/``exp_avg_sq``/``step``
    (Adam) from the optax chain's state dict; returns the step count."""
    parts = _chain(optimizer)
    if sorted(tree) != [str(i) for i in range(len(parts))]:
        raise ValueError(f"an optimizer state of parts {sorted(tree)} does "
                         f"not fit this optimizer's chain {parts}")
    count = 0
    for i, part in enumerate(parts):
        sub = tree[str(i)]
        if part == "trace":
            for p, v in _named_state(backbone, head, sub["trace"], embeds):
                optimizer.state[p]["momentum_buffer"] = \
                    v.contiguous().to(p.device)
        elif part == "adam":
            n = float(np.asarray(sub["count"]))
            for (p, m), (_, v) in zip(
                    _named_state(backbone, head, sub["mu"], embeds),
                    _named_state(backbone, head, sub["nu"], embeds)):
                optimizer.state[p].update(
                    step=torch.tensor(n, dtype=torch.float32),
                    exp_avg=m.contiguous().to(p.device),
                    exp_avg_sq=v.contiguous().to(p.device))
        elif part == "count":
            count = int(np.asarray(sub["count"]))
    return count
