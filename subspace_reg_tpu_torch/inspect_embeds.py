"""Embedding-asset inspector: the port's counterpart of the repo's
``tools/inspect_embeds.py`` (the reference's pool_embeds.ipynb
exploration as a script).  Loads a word- or description-embedding pickle
and prints its coverage and geometry, and with ``--vocab`` each label's
vector norm through the port's ``get_embeds``:

  python -m subspace_reg_tpu_torch.inspect_embeds \
      word_embeds/miniImageNet_dim500.pickle [--vocab "golden retriever" ...]
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np

from .models.embeds import get_embeds


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("path", help="embedding pickle ({word|class: vector})")
    p.add_argument("--vocab", nargs="*", default=None,
                   help="labels to resolve through get_embeds")
    p.add_argument("--dim", type=int, default=500)
    args = p.parse_args(argv)

    with open(args.path, "rb") as f:
        d = pickle.load(f)
    keys = list(d.keys())
    vecs = np.stack([np.asarray(d[k], np.float32).ravel()
                     for k in keys[:2000]])
    print(f"{len(keys)} entries; dim={vecs.shape[1]}")
    norms = np.linalg.norm(vecs, axis=1)
    print(f"norms: mean={norms.mean():.3f} std={norms.std():.3f} "
          f"min={norms.min():.3f} max={norms.max():.3f}")
    zeros = int((norms == 0).sum())
    if zeros:
        print(f"WARNING: {zeros} zero vectors")
    print("sample keys:", keys[:8])

    if args.vocab:
        e = get_embeds(args.path, args.vocab, args.dim)
        for lbl, v in zip(args.vocab, e):
            n = float(np.linalg.norm(v))
            flag = "  (OOV -> zero)" if n == 0 else ""
            print(f"  {lbl:30s} |v|={n:8.3f}{flag}")


if __name__ == "__main__":
    main()
