"""Write tests/fixtures/orbax_resnet/: an orbax directory checkpoint
written by the JAX package's ``save_orbax`` (orbax 0.11.32, so its zarr
chunks and b-tree nodes are zstd-compressed by the zstd library: Huffman
literals, FSE-coded sequences, frames of more than one block) and its
``.ckpt`` twin written by the JAX package's ``save_checkpoint``, of one
seeded state: a narrow resnet12 (widths 8-16-32-64, its largest leaf a
64x64x3x3 kernel of 147 KB) and a 100-row head with a bias, 60 rows
active and the rest zero, as a base session leaves it.

tests/test_torch_orbax.py and chip_smoke.py's phase 18 load the pair
with the port and hold the two against each other.  Run it from the
repo's root where JAX and orbax are installed:

    python tests/fixtures/make_orbax_fixture.py
"""

import os
import shutil
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from subspace_reg_tpu.models.head import Head  # noqa: E402
from subspace_reg_tpu.utils import checkpoint as jckpt  # noqa: E402
from subspace_reg_tpu_torch.models.resnet import ResNetRFS  # noqa: E402
from subspace_reg_tpu_torch.weights import to_jax_variables  # noqa: E402

OUT = os.path.join(ROOT, "tests", "fixtures", "orbax_resnet")
WIDTHS = (8, 16, 32, 64)
N_ACTIVE, MAX_CLASSES = 60, 100
META = {"epoch": 90, "training_classes": {c: i for i, c in
                                          enumerate(range(0, 120, 2))}}


def state():
    torch.manual_seed(0)
    model = ResNetRFS(n_blocks=(1, 1, 1, 1), drop_rate=0.0,
                      no_dropblock=True, avg_pool=True, widths=WIDTHS)
    variables = to_jax_variables(model.state_dict())
    r = np.random.RandomState(1)
    stats = variables["batch_stats"]

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else
                (v + 0.1 * r.rand(*v.shape)).astype(np.float32)
                for k, v in tree.items()}
    variables["batch_stats"] = walk(stats)
    w = np.zeros((MAX_CLASSES, WIDTHS[-1]), np.float32)
    b = np.zeros((MAX_CLASSES,), np.float32)
    w[:N_ACTIVE] = r.randn(N_ACTIVE, WIDTHS[-1]).astype(np.float32) * 0.1
    b[:N_ACTIVE] = r.randn(N_ACTIVE).astype(np.float32) * 0.01
    return variables, Head(weight=w, bias=b, n_active=N_ACTIVE)


def main():
    variables, head = state()
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    jckpt.save_orbax(os.path.join(OUT, "orbax"), variables, head, META)
    jckpt.save_checkpoint(os.path.join(OUT, "state.ckpt"), variables, head,
                          META)
    for dirpath, _, files in sorted(os.walk(OUT)):
        for f in sorted(files):
            p = os.path.join(dirpath, f)
            print(f"{os.path.relpath(p, OUT)}: {os.path.getsize(p)} bytes")


if __name__ == "__main__":
    main()
