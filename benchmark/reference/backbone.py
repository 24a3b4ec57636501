"""A configuration's backbone reference, found by the file that its
configuration names under ``reference`` (a path from the checkout's root,
or an absolute one).  The references of the jobs and ``flops.py`` reach
the backbone only through this module, so a backbone of another
architecture is a new reference file and a new configuration file.

A backbone reference file defines, in plain PyTorch, importing nothing of
the program:

  forward(params, buffers, x, config, train, gen=None, mask=None,
          dtype=None, operand_round=None)
                       (B, 3, H, W) normalized images -> (B, D) f32
                       features, from the backbone's parameters and
                       buffers by state-dict name; in train mode the
                       buffers move in place and ``gen`` draws the masks;
                       ``mask`` marks the rows a batch statistic covers;
                       ``dtype`` is a training precision below f32;
                       ``operand_round`` rounds the matrix products'
                       operands (the control)
  forward_flops(config)
                       the operations of one image's forward
  feature_dim(config)  D
  TINY                 the configuration's size keys with the values the
                       CPU tests shrink them to; the program's model
                       builder takes the same keys by name
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]


@functools.lru_cache(maxsize=None)
def _load(path: str):
    if not Path(path).exists():
        raise FileNotFoundError(f"backbone reference {path} not found")
    spec = importlib.util.spec_from_file_location(
        "bench_reference_" + "".join(c if c.isalnum() else "_"
                                     for c in Path(path).stem), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def of(config: dict):
    """The backbone reference module of ``config``."""
    return _load(str(ROOT / config["reference"]))


def in_chunks(fn, x: torch.Tensor, rows: int) -> torch.Tensor:
    """``fn`` over ``x`` in blocks of ``rows`` rows (eval mode only: a
    train-mode forward takes its batch's statistics and runs whole)."""
    return torch.cat([fn(x[i:i + rows]) for i in range(0, x.shape[0], rows)])
