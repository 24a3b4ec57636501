"""The benchmark's own counts of operations and bytes, from the
configuration's shapes alone.

A backbone's forward is counted by its reference file
(``reference/backbone.py``: ``forward_flops``, ``feature_dim``), found by
the name its configuration gives, from the primitives here.  A
convolution of a (Cin, H, W) map to Cout channels with a k x k kernel,
stride 1 and same padding is 2 * Cin * Cout * k^2 * H * W operations (a
multiply and an add per weight per output pixel).  A residual block of
three 3x3 convolutions at H x W (Cin -> Cout, Cout -> Cout twice) adds,
where the width changes, a 1x1 shortcut (Cin -> Cout).  Normalization,
activations, pooling and the element-wise work are not counted: the
peaks they are compared with are the matrix units'.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

from benchmark.reference import backbone


def conv_flops(cin: int, cout: int, k: int, h: int, w: int) -> int:
    return 2 * cin * cout * k * k * h * w


def block_flops(cin: int, cout: int, h: int, w: int,
                shortcut: bool) -> int:
    f = (conv_flops(cin, cout, 3, h, w)
         + 2 * conv_flops(cout, cout, 3, h, w))
    if shortcut:
        f += conv_flops(cin, cout, 1, h, w)
    return f


def blocks(config: dict) -> List[Dict[str, int]]:
    """The backbone's blocks with their sizes, as its reference lists
    them."""
    return backbone.of(config).blocks(config)


def forward_flops(config: dict) -> int:
    """Operations of one image's backbone forward."""
    return backbone.of(config).forward_flops(config)


def feature_dim(config: dict) -> int:
    """The width of the backbone's features."""
    return backbone.of(config).feature_dim(config)


def head_flops(rows: int, classes: int, dim: int) -> int:
    return 2 * rows * classes * dim


def train_step_flops(config: dict, batch: int, n_cls: int) -> int:
    """A training step: the forward, and a backward counted as twice the
    forward (the gradients of the inputs and of the weights), of the
    backbone and the head."""
    dim = feature_dim(config)
    return 3 * batch * (forward_flops(config) + head_flops(1, n_cls, dim))


# --------------------------------------------------------------------------
# K1, the head fine-tune loop (epochs 2..N of a session)
# --------------------------------------------------------------------------
def k1_epoch_flops(n_sup: int, mem_count: int, n_active: int, dim: int,
                   n_ways: int) -> int:
    """One epoch: logits and their gradient over the support and the
    valid replay rows (two products of rows x classes x dim), and the
    subspace pull of the session's rows (n_ways x dim x dim)."""
    return (2 * 2 * (n_sup + mem_count) * n_active * dim
            + 2 * n_ways * dim * dim)


def k1_bytes(n_sup: int, n_mem_rows: int, max_classes: int, dim: int,
             trace_rows: int) -> int:
    """Every operand read once and every output written once: features
    and labels of the support and the replay buffer, the head, its
    momentum, the base and reserved anchors, the pull operator, and the
    head, stats and trace written back."""
    f32 = 4
    reads = ((n_sup + n_mem_rows) * (dim * f32 + 4)
             + 4 * max_classes * dim * f32 + dim * dim * f32 + 18 * f32)
    writes = max_classes * dim * f32 + 8 * f32 + trace_rows * 3 * f32
    return reads + writes


def k1_bound_s(sessions: Iterable[dict], peak_flops: float,
               bytes_per_s: float) -> float:
    """The least time K1 could take for ``sessions`` (each: n_sup,
    mem_count, n_mem_rows, n_active, max_classes, dim, n_ways, epochs,
    trace_rows): per launch the larger of its operations, for the epochs
    it ran after the first, at the peak and its bytes at the memory
    rate."""
    tot = 0.0
    for s in sessions:
        epochs = max(int(s["epochs"]) - 1, 0)
        ops = epochs * k1_epoch_flops(s["n_sup"], s["mem_count"],
                                      s["n_active"], s["dim"], s["n_ways"])
        nbytes = k1_bytes(s["n_sup"], s["n_mem_rows"], s["max_classes"],
                          s["dim"], s["trace_rows"])
        tot += max(ops / peak_flops, nbytes / bytes_per_s)
    return tot


def eval_run_flops(config: dict, sessions: Sequence[dict],
                   base_eval_n: int) -> int:
    """Operations of one 8-session evaluation on the rows it really
    needs: the initial base-batch forward, then per session the
    train-mode forwards of the support and of the filled replay rows,
    the eval-mode forwards of the support, the filled replay rows, the
    queries so far and the base batch, the head's logits, and K1."""
    fwd = forward_flops(config)
    dim = feature_dim(config)
    tot = base_eval_n * fwd
    for s in sessions:
        rows_train = s["n_sup"] + s["mem_count"]
        rows_eval = s["n_sup"] + s["mem_count"] + s["n_query"] + base_eval_n
        tot += (rows_train + rows_eval) * fwd
        # epoch 1's logits and their gradient; the evaluation's logits
        tot += 3 * head_flops(rows_train, s["n_active"], dim)
        tot += head_flops(s["n_query"] + base_eval_n, s["n_active"], dim)
        tot += max(int(s["epochs"]) - 1, 0) * k1_epoch_flops(
            s["n_sup"], s["mem_count"], s["n_active"], dim, s["n_ways"])
    return tot
