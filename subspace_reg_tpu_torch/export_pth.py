"""Export a checkpoint to the reference's ``.pth`` (JAX
``tools/export_pth.py``): the torch state dict with the reference's
``layerN.M.*`` keys, ``classifier.*``, the ``training_classes`` /
``label2human`` metadata (reference train_supervised.py:180-202) and the
mapping under ``mapping_linear_label2image`` (``map.weight``,
``map.bias``) when the checkpoint has one, so the reference and both
packages' ``.pth`` loaders read it:

  python -m subspace_reg_tpu_torch.export_pth --ckpt in.ckpt --out out.pth

The block counters keep their values under ``layerN.M.
num_batches_tracked``; the JAX writer instead writes 0 into every
BatchNorm's own ``num_batches_tracked`` and no block counter.
"""

from __future__ import annotations

import argparse

import numpy as np

from .utils.checkpoint import load_any
from .weights import save_checkpoint


def write_pth(state_dict, head, meta, out_path: str) -> None:
    """A backbone ``state_dict``, ``head`` (its active rows are written)
    and ``meta`` -> the reference ``.pth`` at ``out_path``
    (``weights.save_checkpoint``)."""
    n = int(head.n_active)
    bias = None if head.bias is None else np.asarray(head.bias)[:n]
    save_checkpoint(out_path, state_dict, np.asarray(head.weight)[:n], bias,
                    training_classes=meta.get("training_classes"),
                    label2human=meta.get("label2human"),
                    epoch=meta.get("epoch", 0),
                    mapping=meta.get("mapping_linear_label2image"))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    write_pth(*load_any(args.ckpt), args.out)
    print("exported", args.out)


if __name__ == "__main__":
    main()
