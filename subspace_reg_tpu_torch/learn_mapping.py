"""Label->image linear-mapping trainer of the port (reference
learn_mapping.py:41-76; JAX ``tools/learn_mapping.py``).

Regresses label embeddings (GloVe = the first 300 dimensions of the
500-d Vico pickle, unless ``--no-glove``) onto the pretrained classifier's
rows with full-batch MSE and SGD (lr 1.0, weight decay 5e-4 coupled into
the gradient, no momentum, 1000 epochs), then stores the map under
``mapping_linear_label2image`` in a ``.ckpt`` (the JAX package's format)
or a reference ``.pth`` (``map.weight``/``map.bias``), which the mapping
attractor of the evaluation reads.  Runs on ``cuda`` unless ``--device
cpu``:

  python -m subspace_reg_tpu_torch.learn_mapping --model_path ckpt.pth \\
      --save_path out.pth --word_embed_path word_embeds \\
      --dataset miniImageNet [--no-glove]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

import numpy as np
import torch

from .export_pth import write_pth
from .models.embeds import get_embeds
from .utils.checkpoint import load_any, save_checkpoint
from .utils.device import resolve_device
from .weights import to_jax_variables

LR = 1.0
WD = 5e-4
EPOCHS = 1000


def train_linear_map(label_embeds: np.ndarray, base_weight: np.ndarray,
                     lr: float = LR, wd: float = WD, epochs: int = EPOCHS,
                     seed: int = 0,
                     init: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                     device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """(weight (out, in) in torch.nn.Linear's layout, bias (out,)) of the
    map from ``label_embeds`` (n, in) to ``base_weight`` (n, out).  The
    start is ``init`` = (w, b), or nn.Linear's default U(+-1/sqrt(in))
    drawn from ``seed``.  Each epoch: the gradient of mean((x w^T + b -
    t)^2), then w -= lr * (grad + wd * w), b likewise, on ``device``."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(label_embeds, np.float32), device=dev)
    t = torch.as_tensor(np.asarray(base_weight, np.float32), device=dev)
    in_dim, out_dim = x.shape[1], t.shape[1]
    if init is None:
        g = torch.Generator().manual_seed(seed)
        k = 1.0 / in_dim ** 0.5
        w0 = torch.empty((out_dim, in_dim)).uniform_(-k, k, generator=g)
        b0 = torch.empty((out_dim,)).uniform_(-k, k, generator=g)
    else:
        w0, b0 = (torch.from_numpy(np.array(a, np.float32))
                  for a in init)
    w, b = w0.to(dev).clone(), b0.to(dev).clone()
    scale = 2.0 / (x.shape[0] * out_dim)        # d mean(r^2) / d r
    with torch.no_grad():
        for _ in range(epochs):
            r = x @ w.T + b - t
            gw = (r * scale).T @ x
            gb = (r * scale).sum(0)
            w = w - lr * (gw + wd * w)
            b = b - lr * (gb + wd * b)
    return w.cpu().numpy(), b.cpu().numpy()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model_path", required=True)
    p.add_argument("--save_path", required=True)
    p.add_argument("--word_embed_path", default="word_embeds")
    p.add_argument("--dataset", default="miniImageNet")
    p.add_argument("--word_embed_size", type=int, default=500)
    p.add_argument("--no-glove", dest="glove", action="store_false")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    sd, head, meta = load_any(args.model_path)
    base_labels = [n for n in meta["label2human"] if n != ""]
    pth = os.path.join(args.word_embed_path,
                       f"{args.dataset}_dim{args.word_embed_size}.pickle")
    embeds = np.asarray(get_embeds(pth, base_labels, args.word_embed_size),
                        np.float32)
    embeds = embeds[:, :300 if args.glove else args.word_embed_size]
    n = int(head.n_active)
    base_w = np.asarray(head.weight, np.float32)[:n]

    w, b = train_linear_map(embeds, base_w, device=args.device)
    final = float(np.mean((embeds @ w.T + b - base_w) ** 2))
    print(f"final MSE: {final:.6f}")

    meta = dict(meta)
    meta["mapping_linear_label2image"] = {"weight": w, "bias": b}
    if args.save_path.endswith(".pth"):
        write_pth(sd, head, meta, args.save_path)
    else:
        save_checkpoint(args.save_path, to_jax_variables(sd), head, meta)
    print("saved", args.save_path)


if __name__ == "__main__":
    main()
