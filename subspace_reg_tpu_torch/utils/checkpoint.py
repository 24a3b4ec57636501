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

``save_orbax``/``load_orbax`` are the JAX package's orbax directory
checkpoints (JAX ``utils/checkpoint.py:135-172``), without orbax: the tree
``{"variables", "head_weight", "head_bias", "head_n_active"}`` as one zarr
v2 array per leaf (utils/zarr2.py) in an OCDBT store (utils/ocdbt.py),
beside orbax's ``_METADATA`` and ``_CHECKPOINT_METADATA`` and JAX's
``meta.pkl``.  orbax 0.11.32's ``StandardCheckpointer`` restores the
port's directories and the port reads orbax's.  As in JAX, ``load_any``
does not read them.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models.head import Head
from . import msgpack_codec, ocdbt, zarr2


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


# what orbax 0.11.32's StandardCheckpointer writes beside the arrays
ORBAX_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler"
                 ".StandardCheckpointHandler")
_LEAF_METADATA = {"value_type": "np.ndarray", "skip_deserialize": False}
_DICT_KEY = 2  # orbax's key_type of a dict key


def _flatten(tree, path=()):
    """(path, leaf) pairs of a nested dict, keys sorted as JAX's tree
    flattening sorts them."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _flatten(tree[k], path + (k,))]
    return [(path, tree)]


def _orbax_payload(variables, head: Head):
    return {
        "variables": _tree_numpy(variables),
        "head_weight": _numpy(head.weight),
        # orbax rejects 0-size arrays
        "head_bias": (_numpy(head.bias) if head.bias is not None
                      else np.zeros((1,), np.float32)),
        "head_n_active": np.asarray(int(head.n_active), np.int64),
    }


def save_orbax(dirpath: str, variables: Dict[str, Any], head: Head,
               meta: Optional[Dict[str, Any]] = None) -> None:
    """Write the directory ``dirpath`` as JAX ``save_orbax`` does (an
    existing one is replaced): ``variables`` the JAX-form backbone tree
    (``weights.to_jax_variables``), the head's leaves torch tensors on
    any device or numpy arrays.  The directory is written beside its
    final path and renamed into place, as orbax does."""
    path = os.path.abspath(dirpath)
    init = time.time_ns()
    leaves = _flatten(_orbax_payload(variables, head))
    items: Dict[bytes, bytes] = {}
    for p, leaf in leaves:
        items.update(zarr2.encode_array(".".join(p), leaf))
    tmp = f"{path}.orbax-checkpoint-tmp-{init}"
    os.makedirs(tmp)
    try:
        ocdbt.write_store(tmp, items)
        tree = {str(p): {"key_metadata": [{"key": k, "key_type": _DICT_KEY}
                                          for k in p],
                         "value_metadata": dict(_LEAF_METADATA)}
                for p, _ in leaves}
        with open(os.path.join(tmp, "_METADATA"), "w") as f:
            json.dump({"tree_metadata": tree, "use_ocdbt": True,
                       "use_zarr3": False,
                       "store_array_data_equal_to_fill_value": True,
                       "custom_metadata": None}, f)
        with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
            json.dump({"item_handlers": ORBAX_HANDLER, "metrics": {},
                       "performance_metrics": {},
                       "init_timestamp_nsecs": init,
                       "commit_timestamp_nsecs": time.time_ns(),
                       "custom_metadata": {}}, f)
        with open(os.path.join(tmp, "meta.pkl"), "wb") as f:
            pickle.dump({"meta": meta or {},
                         "has_bias": head.bias is not None}, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def load_orbax(dirpath: str):
    """(variables, head, meta) of an orbax directory (JAX ``save_orbax``'s
    or the port's), numpy leaves and a Python-int ``n_active``, as
    ``load_checkpoint`` returns them; callers map ``variables`` with
    ``weights.from_jax_variables`` and move them to their device."""
    path = os.path.abspath(dirpath)
    with open(os.path.join(path, "_METADATA")) as f:
        layout = json.load(f)
    if not layout.get("use_ocdbt") or layout.get("use_zarr3"):
        raise ValueError(f"{path}: only OCDBT stores of zarr v2 arrays are "
                         "read (orbax's defaults)")
    tree_meta = layout["tree_metadata"]
    with open(os.path.join(path, "meta.pkl"), "rb") as f:
        raw = pickle.load(f)
    items = ocdbt.read_store(path)
    payload: Dict[str, Any] = {}
    for entry in tree_meta.values():
        keys = entry["key_metadata"]
        if any(k["key_type"] != _DICT_KEY for k in keys):
            raise ValueError(f"{path}: only trees of dicts are read, not "
                             f"{keys}")
        p = [str(k["key"]) for k in keys]
        node = payload
        for k in p[:-1]:
            node = node.setdefault(k, {})
        node[p[-1]] = zarr2.read_array(items, ".".join(p))
    head = Head(weight=payload["head_weight"],
                bias=payload["head_bias"] if raw["has_bias"] else None,
                n_active=int(payload["head_n_active"]))
    return payload["variables"], head, raw["meta"]


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
