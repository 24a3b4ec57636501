"""K1: the FSCIL head fine-tune loop (epochs 2..N) in one launch.

Counterpart of ``subspace_reg_tpu/ops/pallas/finetune.py::finetune_loop_pallas``.
``finetune_loop`` launches the hand-written CUDA kernel
(``csrc/finetune_loop.cu``) for CUDA tensors and runs ``finetune_loop_plain``,
the same arithmetic in plain torch with explicit gradients, for CPU tensors.
There is no fallback between the two: a CUDA call launches the kernel or
raises.

Each epoch computes, on features cached by the engine:
  * support CE, plus masked replay CE averaged over the valid rows;
  * the base anchor lmbd*||W[:base]-W0|| (UN-squared, zero subgradient at
    0) whose bias column is SQUARED, and the previous-novel anchor;
  * the subspace pull gamma*||cur @ M||^2 (M = I - QQ^T) or the semantic
    pull gamma*||cur - T||^2 (the pull never touches the bias column);
  * coupled weight decay, then SGD-momentum or Adam (b1^t by recurrence);
  * the stable-epoch / target-loss / max-epoch stop and a (loss, acc1,
    acc5) trace row.

Operands (no TPU padding: any row counts >= the valid counts):
  f_sup (Ns, D) f32, y_sup (Ns,) int32, f_mem (Nm, D) f32, y_mem (Nm,) int32;
  w, mom (Cp, D) f32; nu (Cp, D) for Adam; w0 (Cp, D) for the base anchor;
  reserved (Cp, D) with the previous novel rows at [orig_base,
  orig_base + n_reserved); pull_op (D, D) for the subspace pull; pull_tgt
  (Cp, D) with the targets at the current rows for the semantic pull;
  scalars (N_SCALARS,) f32 laid out as ``SCALARS``.  Unused operands may be
  None.  With a bias column, W is laid out as [W | b] and features carry a
  matching ones column.
Outputs: w (Cp, D); stats (8,) = loss, epoch, stable, acc1, acc5 of the last
epoch run; trace (trace_rows, 3) whose row e holds epoch e's pre-update
(loss, acc1, acc5) for e >= 2 (epoch 1 runs in the engine).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Union

import torch

NEG = -1e9

# scalars layout; the kernel's enum in csrc/finetune_loop.cu follows it
SCALARS = ("lr", "wd", "momentum", "lmbd_base", "lmbd_novel", "gamma", "eps",
           "target_loss", "min_epochs", "max_epochs", "stable_target",
           "adam_b1", "adam_b2", "adam_eps", "prev_loss0", "stable0",
           "acc1_0", "acc5_0")
N_SCALARS = len(SCALARS)
_IDX = {name: i for i, name in enumerate(SCALARS)}

# static-configuration flags; the kernel's F_* constants follow them
_F_MEMORY, _F_REGBASE, _F_REGNOVEL = 1, 2, 4
_F_PULL_SUB, _F_PULL_SEM, _F_STABLE, _F_ADAM = 8, 16, 32, 64

PULL_MODES = ("none", "subspace", "semantic")


@dataclass(frozen=True)
class LoopConfig:
    """Everything about one loop launch that is not a tensor."""
    n_sup: int              # valid support rows (CE mean denominator)
    mem_count: int          # valid replay rows
    n_active: int           # active classes
    n_reserved: int         # previous-novel rows under the novel anchor
    orig_base: int          # base classes under the base anchor
    n_ways: int             # current novel rows: [n_active-n_ways, n_active)
    memory_on: bool
    use_regbase: bool
    use_regnovel: bool
    pull_mode: str          # one of PULL_MODES
    stable_mode: bool
    trace_rows: int
    use_adam: bool = False
    bias_col: Optional[int] = None

    @property
    def flags(self) -> int:
        return ((_F_MEMORY if self.memory_on else 0)
                | (_F_REGBASE if self.use_regbase else 0)
                | (_F_REGNOVEL if self.use_regnovel else 0)
                | (_F_PULL_SUB if self.pull_mode == "subspace" else 0)
                | (_F_PULL_SEM if self.pull_mode == "semantic" else 0)
                | (_F_STABLE if self.stable_mode else 0)
                | (_F_ADAM if self.use_adam else 0))


def pack_scalars(device, **values: Union[float, torch.Tensor]) -> torch.Tensor:
    """(N_SCALARS,) f32 operand.  Values may be Python numbers or 0-d device
    tensors (epoch 1's loss and accuracies stay on the device: no host
    round trip before the launch).  Missing names are 0."""
    unknown = set(values) - set(_IDX)
    if unknown:
        raise ValueError(f"unknown scalars: {sorted(unknown)}")
    parts = [torch.as_tensor(values.get(name, 0.0), dtype=torch.float32,
                             device=device).reshape(())
             for name in SCALARS]
    return torch.stack(parts)


# --------------------------------------------------------------------------
# plain twin
# --------------------------------------------------------------------------
def _ce_part(f, y, count, w, n_active, scale, with_acc):
    """Masked softmax CE over the first ``count`` rows of ``f``: returns the
    loss term, the gradient dlog^T f, and (acc1, acc5) hit counts."""
    rows, cp = f.shape[0], w.shape[0]
    dev = f.device
    col = torch.arange(cp, device=dev)[None, :]
    valid = (torch.arange(rows, device=dev) < count)[:, None]
    rm = valid & (col < n_active)
    logits = f @ w.T
    logits = torch.where(rm, logits, torch.full_like(logits, NEG))
    m = logits.max(1, keepdim=True).values
    e = torch.exp(logits - m)
    s = e.sum(1, keepdim=True)
    p = e / s
    oh = ((col == y[:, None].long()) & rm).to(f.dtype)
    valid_row = oh.sum(1, keepdim=True)
    loss = -((oh * logits).sum() - (valid_row * (m + torch.log(s))).sum()) \
        * scale
    dlog = (p * rm.to(f.dtype) - oh) * scale
    g = dlog.T @ f
    hits = None
    if with_acc:
        logit_y = (oh * logits).sum(1, keepdim=True)
        beats = (logits > logit_y) | ((logits == logit_y)
                                      & (col < y[:, None].long()))
        rank = (beats & rm).sum(1, keepdim=True).to(f.dtype)
        hits = ((valid_row * (rank < 1)).sum(), (valid_row * (rank < 5)).sum())
    return loss, g, hits


def _safe_anchor(diff):
    """(||diff||, d||diff||/d diff) with a zero subgradient at 0."""
    sq = (diff * diff).sum()
    norm = torch.where(sq == 0, torch.zeros_like(sq),
                       torch.sqrt(torch.where(sq == 0, torch.ones_like(sq), sq)))
    inv = torch.where(norm == 0, torch.zeros_like(norm),
                      1.0 / torch.clamp_min(norm, 1e-30))
    return norm, diff * inv


def finetune_loop_plain(f_sup, y_sup, f_mem, y_mem, w, mom, nu, w0, reserved,
                        pull_op, pull_tgt, scalars, cfg: LoopConfig):
    """The loop in plain torch, epoch by epoch, with the stop decided on
    the host from f32 tensors (the kernel decides the same comparisons on
    the device)."""
    dev = w.device
    cp, d = w.shape
    sc = {name: scalars[i] for name, i in _IDX.items()}
    f32 = torch.float32
    rows = torch.arange(cp, device=dev)[:, None]
    base_m = (rows < cfg.orig_base).to(f32)
    novel_m = ((rows >= cfg.orig_base)
               & (rows < cfg.orig_base + cfg.n_reserved)).to(f32)
    cur_m = ((rows >= cfg.n_active - cfg.n_ways)
             & (rows < cfg.n_active)).to(f32)
    colw = torch.ones((1, d), dtype=f32, device=dev)
    colb = torch.zeros((1, d), dtype=f32, device=dev)
    if cfg.bias_col is not None:
        colw[0, cfg.bias_col] = 0.0
        colb[0, cfg.bias_col] = 1.0
    # scale constants rounded from double, as the JAX kernel's Python floats
    inv_nsup = torch.tensor(1.0 / cfg.n_sup, dtype=f32, device=dev)
    acc_scale = torch.tensor(100.0 / cfg.n_sup, dtype=f32, device=dev)
    inv_cnt = 1.0 / torch.clamp_min(
        torch.tensor(float(cfg.mem_count), dtype=f32, device=dev), 1.0)

    def loss_and_grad(w):
        loss, g, (h1, h5) = _ce_part(f_sup, y_sup, cfg.n_sup, w, cfg.n_active,
                                     inv_nsup, True)
        acc1, acc5 = h1 * acc_scale, h5 * acc_scale
        if cfg.memory_on:
            l2, g2, _ = _ce_part(f_mem, y_mem, cfg.mem_count, w, cfg.n_active,
                                 inv_cnt, False)
            loss, g = loss + l2, g + g2
        if cfg.use_regbase:
            diff = (w - w0) * base_m
            diff_b = diff * colb
            norm, dn = _safe_anchor(diff * colw)
            loss = loss + sc["lmbd_base"] * norm
            g = g + sc["lmbd_base"] * dn
            if cfg.bias_col is not None:
                # the bias term is SQUARED (resnet_language.py:232)
                loss = loss + sc["lmbd_base"] * (diff_b * diff_b).sum()
                g = g + 2.0 * sc["lmbd_base"] * diff_b
        if cfg.use_regnovel:
            norm, dn = _safe_anchor((w - reserved) * novel_m)
            loss = loss + sc["lmbd_novel"] * norm
            g = g + sc["lmbd_novel"] * dn
        if cfg.pull_mode == "subspace":
            v = (w * cur_m * colw) @ pull_op
            loss = loss + sc["gamma"] * (v * v).sum()
            g = g + 2.0 * sc["gamma"] * v * cur_m * colw
        elif cfg.pull_mode == "semantic":
            diff = (w - pull_tgt) * cur_m * colw
            loss = loss + sc["gamma"] * (diff * diff).sum()
            g = g + 2.0 * sc["gamma"] * diff
        return loss, g, acc1, acc5

    w = w.clone()
    mom = mom.clone()
    nu = nu.clone() if cfg.use_adam else None
    b1, b2 = sc["adam_b1"], sc["adam_b2"]
    p1, p2 = b1.clone(), b2.clone()
    trace = torch.zeros((cfg.trace_rows, 3), dtype=f32, device=dev)

    # epoch 1 ran in the engine: replay its stop decision
    prev_loss, stable = sc["prev_loss0"], sc["stable0"]
    acc1, acc5 = sc["acc1_0"], sc["acc5_0"]
    one = torch.tensor(1.0, dtype=f32, device=dev)
    stop = bool(one >= sc["max_epochs"]) or bool(
        (prev_loss <= sc["target_loss"]) & (one >= sc["min_epochs"] + 1.0))
    if cfg.stable_mode:
        stop = stop or bool(stable == sc["stable_target"])
    epoch = one
    while not stop:
        epoch = epoch + 1.0
        loss, g, acc1, acc5 = loss_and_grad(w)
        g = g + sc["wd"] * w
        if cfg.use_adam:
            p1, p2 = p1 * b1, p2 * b2
            mom = b1 * mom + (1.0 - b1) * g
            nu = b2 * nu + (1.0 - b2) * g * g
            w = w - sc["lr"] * (mom / (1.0 - p1)) / (
                torch.sqrt(nu / (1.0 - p2)) + sc["adam_eps"])
        else:
            mom = sc["momentum"] * mom + g
            w = w - sc["lr"] * mom
        if cfg.stable_mode:
            is_st = torch.abs(loss - prev_loss) < sc["eps"]
            stable = torch.where(is_st, stable + 1.0, torch.zeros_like(stable))
            stop = bool(stable == sc["stable_target"])
        stop = stop or bool(epoch >= sc["max_epochs"])
        stop = stop or bool((loss <= sc["target_loss"])
                            & (epoch >= sc["min_epochs"] + 1.0))
        row = int(epoch)
        if row < cfg.trace_rows:
            trace[row] = torch.stack([loss, acc1, acc5])
        prev_loss = loss
    stats = torch.zeros(8, dtype=f32, device=dev)
    stats[:5] = torch.stack([prev_loss, epoch, stable, acc1, acc5])
    return w, stats, trace


# --------------------------------------------------------------------------
# the kernel's launch plan
# --------------------------------------------------------------------------
# K1's tiling: csrc/finetune_loop.cu's constants of the same names, which
# its launcher checks the plan against
K1_THREADS = 256        # threads per block (8 warps)
K1_TR = 8               # logits rows per phase-A tile (a warp per row)
K1_PULL_COLS = 8        # subspace-pull columns per phase-A chunk
K1_VG = 8               # pull rows per pass
K1_TC, K1_TJ = 20, 32   # classes x feature columns per phase-B update tile
# partial sums per block: phase A's loss_sup, loss_mem, hits1, hits5,
# sum V^2, then two alternating sets of the anchor sums
K1_NQ = 5 + 2 * 4
K1_SMEM_MAX = 232448    # dynamic shared memory one block may use


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def k1_smem_bytes(d_pad: int, ldl: int, rows: int) -> int:
    """Shared memory of one K1 block: the phase-A region (a logits tile's F
    rows and logits, or a pull chunk's M columns, current rows and k-slice
    partials), then the phase-B region (the update tile's F columns over
    all rows, then dlog's columns, later the per-warp partials of G)."""
    a = max(K1_TR * (d_pad + ldl),
            (K1_PULL_COLS + K1_VG) * d_pad
            + (K1_THREADS // K1_PULL_COLS) * K1_VG * K1_PULL_COLS)
    b = rows * K1_TJ + max(rows * K1_TC, (K1_THREADS // 32) * K1_TC * K1_TJ)
    return 4 * (a + b)


@dataclass(frozen=True)
class K1Plan:
    """One K1 launch: ``blocks`` persistent blocks, each epoch in two
    phases.  Phase A deals its items round-robin (item i to block i %
    blocks): ``row_tiles`` logits tiles of K1_TR rows, then
    ``pull_chunks`` chunks of K1_PULL_COLS pull columns.  Phase B deals
    its ``class_tiles`` x ``col_tiles`` update tiles the same way (tile u =
    class tile u // col_tiles, column tile u % col_tiles); an update tile
    also sums the anchor terms of its elements."""
    blocks: int
    rows: int           # support rows then valid replay rows
    n_active: int
    c_pad: int
    d_pad: int          # feature width padded to a multiple of 4
    ldl: int            # row stride of the dlog scratch
    row_tiles: int
    pull_chunks: int
    class_tiles: int
    col_tiles: int
    slots: int          # floats of the partial-sum scratch
    smem: int           # dynamic shared memory per block, bytes

    @property
    def items(self) -> int:
        return self.row_tiles + self.pull_chunks

    @property
    def tiles(self) -> int:
        return self.class_tiles * self.col_tiles


def k1_plan(rows: int, n_active: int, c_pad: int, d: int, n_ways: int,
            blocks: int) -> K1Plan:
    """The launch plan for ``rows`` support + valid replay rows, ``n_active``
    of ``c_pad`` classes, ``d`` features and the subspace pull over
    ``n_ways`` rows (0: no subspace pull) on ``blocks`` blocks."""
    if blocks < 1 or rows < 1 or not 0 < n_active <= c_pad:
        raise ValueError(f"k1_plan: no plan for {rows} rows, {n_active} of "
                         f"{c_pad} classes on {blocks} blocks")
    d_pad = _cdiv(d, 4) * 4
    ldl = _cdiv(c_pad, K1_TC) * K1_TC
    smem = k1_smem_bytes(d_pad, ldl, rows)
    if smem > K1_SMEM_MAX:
        raise ValueError(f"finetune_loop: {rows} rows of {d} features do "
                         "not fit K1's shared memory")
    return K1Plan(blocks=blocks, rows=rows, n_active=n_active, c_pad=c_pad,
                  d_pad=d_pad, ldl=ldl, row_tiles=_cdiv(rows, K1_TR),
                  pull_chunks=_cdiv(d_pad, K1_PULL_COLS) if n_ways else 0,
                  class_tiles=_cdiv(c_pad, K1_TC),
                  col_tiles=_cdiv(d_pad, K1_TJ), slots=blocks * K1_NQ,
                  smem=smem)


def k1_work(plan: K1Plan, block: int) -> Dict[str, list]:
    """What block ``block`` owns in each epoch, as the kernel walks it:
    ``logits`` row ranges and ``pull`` column ranges (phase A), ``update``
    tiles (class lo, hi, column lo, hi, and whether the tile runs the
    product G = dlog^T F) (phase B), and its ``slots`` (the floats it
    writes: quantity q at q * blocks + block).  Ranges are clipped to the
    valid rows, the padded feature width and the head."""
    out = {"logits": [], "pull": [], "update": [],
           "slots": [q * plan.blocks + block for q in range(K1_NQ)]}
    for i in range(block, plan.items, plan.blocks):
        if i < plan.row_tiles:
            lo = i * K1_TR
            out["logits"].append((lo, min(plan.rows, lo + K1_TR)))
        else:
            lo = (i - plan.row_tiles) * K1_PULL_COLS
            out["pull"].append((lo, min(plan.d_pad, lo + K1_PULL_COLS)))
    for u in range(block, plan.tiles, plan.blocks):
        c0 = (u // plan.col_tiles) * K1_TC
        j0 = (u % plan.col_tiles) * K1_TJ
        out["update"].append((c0, min(plan.c_pad, c0 + K1_TC), j0,
                              min(plan.d_pad, j0 + K1_TJ),
                              c0 < plan.n_active))
    return out


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------
_PTR_ARGS = 22
_INT_ARGS = 18
_OPERANDS = ("f_sup", "y_sup", "f_mem", "y_mem", "w", "mom", "nu", "w0",
             "reserved", "pull_op", "pull_tgt", "scalars")


def _kernel_fn(symbol: str = "k1_finetune_loop", n_ptr: int = _PTR_ARGS,
               n_int: int = _INT_ARGS):
    from ..utils.cuda_build import load
    fn = getattr(load("finetune_loop"), symbol)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr
                       + [ctypes.c_int] * n_int + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def k1_blocks(device: torch.device) -> int:
    """K1's default grid on ``device``: one block per SM."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(name, t, shape: Sequence[int], dtype, device):
    if t is None:
        raise ValueError(f"finetune_loop: {name} is required by this "
                         "configuration")
    if t.device != device:
        raise ValueError(f"finetune_loop: {name} on {t.device}, expected "
                         f"{device}")
    if t.dtype != dtype:
        raise ValueError(f"finetune_loop: {name} is {t.dtype}, expected "
                         f"{dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"finetune_loop: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"finetune_loop: {name} must be contiguous")


def _validate(ops: Dict[str, Optional[torch.Tensor]], cfg: LoopConfig):
    w = ops["w"]
    cp, d = w.shape
    dev = w.device
    f32, i32 = torch.float32, torch.int32
    ns, nm = ops["f_sup"].shape[0], ops["f_mem"].shape[0]
    if cfg.pull_mode not in PULL_MODES:
        raise ValueError(f"finetune_loop: unknown pull_mode {cfg.pull_mode!r}")
    if not (0 < cfg.n_sup <= ns and 0 <= cfg.mem_count <= nm):
        raise ValueError("finetune_loop: row counts exceed the operands")
    if not (cfg.n_ways <= cfg.n_active <= cp
            and cfg.orig_base + cfg.n_reserved <= cp):
        raise ValueError("finetune_loop: class counts exceed the head")
    if cfg.bias_col is not None and not 0 <= cfg.bias_col < d:
        raise ValueError("finetune_loop: bias_col outside the feature axis")
    need = {"f_sup": (ns, d), "y_sup": (ns,), "f_mem": (nm, d),
            "y_mem": (nm,), "w": (cp, d), "mom": (cp, d),
            "scalars": (N_SCALARS,)}
    if cfg.use_adam:
        need["nu"] = (cp, d)
    if cfg.use_regbase:
        need["w0"] = (cp, d)
    if cfg.use_regnovel:
        need["reserved"] = (cp, d)
    if cfg.pull_mode == "subspace":
        need["pull_op"] = (d, d)
    if cfg.pull_mode == "semantic":
        need["pull_tgt"] = (cp, d)
    for name, shape in need.items():
        _check(name, ops[name], shape,
               i32 if name.startswith("y_") else f32, dev)
    if cfg.trace_rows < 2:
        raise ValueError("finetune_loop: trace_rows must be >= 2")


def _plan_for(cfg: LoopConfig, c_pad: int, d: int, blocks: int) -> K1Plan:
    rows = cfg.n_sup + (cfg.mem_count if cfg.memory_on else 0)
    return k1_plan(rows, cfg.n_active, c_pad, d,
                   cfg.n_ways if cfg.pull_mode == "subspace" else 0, blocks)


def kernel_operands(ops: Dict[str, Optional[torch.Tensor]],
                    d_pad: int) -> Dict[str, Optional[torch.Tensor]]:
    """The operands as the kernel reads them: each feature-wide tensor
    widened with zero columns to ``d_pad`` (``pull_op`` along both axes),
    every tensor starting on a 16-byte boundary.  Zero columns of F, W,
    mom, nu, W0, reserved, M and the target stay zero and add nothing to
    any sum, so the loop over the widened operands is the loop over the
    given ones."""
    out = {}
    for name, t in ops.items():
        if t is not None and name not in ("y_sup", "y_mem", "scalars"):
            extra = d_pad - t.shape[-1]
            if extra:
                pad = (0, extra, 0, extra) if name == "pull_op" else (0, extra)
                t = torch.nn.functional.pad(t, pad)
            elif t.data_ptr() % 16:
                t = t.clone()
        out[name] = t
    return out


def k1_scratch(plan: K1Plan, cfg: LoopConfig,
               device) -> Dict[str, Optional[torch.Tensor]]:
    """Every buffer a launch writes (the kernel allocates nothing): the
    outputs w, stats and trace, the optimizer state mom (and nu for Adam),
    dlog (rows x ldl), the pull's V (n_ways x d_pad), the partial-sum
    slots and the grid barrier's counter, zeroed."""
    f32 = torch.float32
    head = (plan.c_pad, plan.d_pad)
    return dict(
        w=torch.empty(head, dtype=f32, device=device),
        mom=torch.empty(head, dtype=f32, device=device),
        nu=torch.empty(head, dtype=f32, device=device) if cfg.use_adam
        else None,
        stats=torch.zeros(8, dtype=f32, device=device),
        trace=torch.empty((cfg.trace_rows, 3), dtype=f32, device=device),
        dlog=torch.empty((plan.rows, plan.ldl), dtype=f32, device=device),
        pullv=torch.empty((max(cfg.n_ways, 1), plan.d_pad), dtype=f32,
                          device=device),
        slots=torch.empty(plan.slots, dtype=f32, device=device),
        bar=torch.zeros(1, dtype=torch.int32, device=device))


# per-block clocks of a profiled launch (csrc/finetune_loop.cu::Clock):
# phase A after its product, barrier 1, phase B after its update, barrier
# 2, then phase A's product, phase B's slot reduction, its G product and
# its update epilogue
K1_PROF_SLOTS = 8


def _launch(ops, cfg: LoopConfig, blocks: Optional[int] = None,
            prof: Optional[torch.Tensor] = None):
    """Launch the kernel on ``blocks`` blocks (default: one per SM); a grid
    the card cannot hold resident at once is refused and raises.  With
    ``prof`` ((blocks, K1_PROF_SLOTS) int64), each block adds the
    nanoseconds of each part of its epochs (``K1_PROF_SLOTS``)."""
    w = ops["w"]
    cp, d = w.shape
    dev = w.device
    plan = _plan_for(cfg, cp, d, k1_blocks(dev) if blocks is None else blocks)
    kops = kernel_operands(ops, plan.d_pad)
    out = k1_scratch(plan, cfg, dev)
    if prof is not None:
        _check("prof", prof, (plan.blocks, K1_PROF_SLOTS), torch.int64,
               dev)
    err = _kernel_fn()(
        *(_ptr(kops[name]) for name in _OPERANDS),
        *(_ptr(out[name]) for name in ("w", "mom", "nu", "stats", "trace",
                                       "dlog", "pullv", "slots", "bar")),
        _ptr(prof),
        cp, plan.d_pad, cfg.n_sup, cfg.mem_count, cfg.n_active,
        cfg.n_reserved, cfg.orig_base, cfg.n_ways,
        -1 if cfg.bias_col is None else cfg.bias_col, cfg.flags,
        cfg.trace_rows, plan.blocks, plan.ldl, plan.row_tiles,
        plan.pull_chunks, plan.class_tiles, plan.col_tiles, plan.smem, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"finetune_loop kernel launch on {plan.blocks} "
                           f"blocks failed: cudaError {err}")
    finetune_loop.launches += 1
    w_out = out["w"] if plan.d_pad == d else out["w"][:, :d].contiguous()
    return w_out, out["stats"], out["trace"]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def finetune_loop(f_sup, y_sup, f_mem, y_mem, w, mom, nu, w0, reserved,
                  pull_op, pull_tgt, scalars, cfg: LoopConfig):
    """Run the loop: the CUDA kernel for CUDA tensors, the plain twin for
    CPU tensors.  Returns (w, stats, trace) as the module docstring says."""
    ops = dict(f_sup=f_sup, y_sup=y_sup, f_mem=f_mem, y_mem=y_mem, w=w,
               mom=mom, nu=nu, w0=w0, reserved=reserved, pull_op=pull_op,
               pull_tgt=pull_tgt, scalars=scalars)
    _validate(ops, cfg)
    if w.device.type == "cpu":
        return finetune_loop_plain(**ops, cfg=cfg)
    if w.device.type != "cuda":
        raise ValueError(f"finetune_loop: unsupported device {w.device}")
    return _launch(ops, cfg)


finetune_loop.launches = 0
