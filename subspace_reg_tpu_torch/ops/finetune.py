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
# the kernel
# --------------------------------------------------------------------------
_PTR_ARGS = 20
_INT_ARGS = 11
# the subspace pull keeps two output columns per thread of its 512
_MAX_PULL_D = 1024


def _kernel_fn():
    from ..utils.cuda_build import load
    lib = load("finetune_loop")
    fn = lib.k1_finetune_loop
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * _PTR_ARGS
                       + [ctypes.c_int] * _INT_ARGS + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


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
    if cfg.pull_mode == "subspace" and d > _MAX_PULL_D:
        raise ValueError(f"finetune_loop: the subspace pull takes at most "
                         f"{_MAX_PULL_D} features, got {d}")
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


def _launch(ops, cfg: LoopConfig):
    w = ops["w"]
    cp, d = w.shape
    ns, nm = ops["f_sup"].shape[0], ops["f_mem"].shape[0]
    dev = w.device
    out_w = torch.empty_like(w)
    out_mom = torch.empty_like(w)
    out_nu = torch.empty_like(w) if cfg.use_adam else None
    stats = torch.zeros(8, dtype=torch.float32, device=dev)
    trace = torch.empty((cfg.trace_rows, 3), dtype=torch.float32, device=dev)
    # scratch: logits of the support rows then the replay rows, the CE
    # gradient, and the n_ways rows of cur @ M
    logits = torch.empty((ns + nm, cp), dtype=torch.float32, device=dev)
    grad = torch.empty((cp, d), dtype=torch.float32, device=dev)
    pullv = torch.empty((max(cfg.n_ways, 1), d), dtype=torch.float32,
                        device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel_fn()(
        ptr(ops["f_sup"]), ptr(ops["y_sup"]), ptr(ops["f_mem"]),
        ptr(ops["y_mem"]), ptr(w), ptr(ops["mom"]), ptr(ops["nu"]),
        ptr(ops["w0"]), ptr(ops["reserved"]), ptr(ops["pull_op"]),
        ptr(ops["pull_tgt"]), ptr(ops["scalars"]),
        ptr(out_w), ptr(out_mom), ptr(out_nu), ptr(stats), ptr(trace),
        ptr(logits), ptr(grad), ptr(pullv),
        cp, d, cfg.n_sup, cfg.mem_count, cfg.n_active, cfg.n_reserved,
        cfg.orig_base, cfg.n_ways,
        -1 if cfg.bias_col is None else cfg.bias_col, cfg.flags,
        cfg.trace_rows, stream)
    if err != 0:
        raise RuntimeError(f"finetune_loop kernel launch failed: cudaError "
                           f"{err}")
    return out_w, stats, trace


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
    out = _launch(ops, cfg)
    finetune_loop.launches += 1
    return out


finetune_loop.launches = 0
