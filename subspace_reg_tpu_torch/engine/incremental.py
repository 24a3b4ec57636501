"""Incremental FSCIL engine — counterpart of
``subspace_reg_tpu/engine/incremental.py``, reference
eval/language_eval.py:71-454.

Each session on the default path (``freeze_backbone_at == 1``, untracked):

  epoch 1   train-mode backbone forwards of the support set, then of the
            padded replay memory with masked BN statistics (skipped while
            the memory is empty); CE (+ replay CE + the regularizers) on the
            head, gradient by autograd on the head only, one optimizer step.
            The reference leaves the net in eval mode after every epoch, so
            this is the only train-mode work of a session.
  cache     eval-mode features of support, memory, queries and base batch,
            constant for epochs 2..N.
  epochs 2+ K1 (ops/finetune.py): the whole head fine-tune loop in one
            launch on the card, or its plain twin on the CPU.
  evaluate  per-session novel query chunks and the fixed base batch, and
            the argmax predictions (kept on the device unless
            ``--save_preds_0`` dumps them).

The other modes, as in the JAX package:

  tracked   ``--track_weights``, ``--track_label_inspired_weights`` or
            ``vis=True``: epoch 1 and the caches as above, then one
            host-driven head epoch at a time (autograd gradient of the
            session loss on the cached features, the same update as K1),
            one device-to-host pull per epoch for the stop flag and what is
            recorded (JAX ``_run_tracked``, incremental.py:320-394).
  general   ``freeze_backbone_at = F != 1``: epoch 1 in train mode and
  freeze    epochs 2..F-1 in eval mode with gradients to the backbone and
            the head through one ``torch.optim`` optimizer, then the
            eval-mode caches and head epochs as on the tracked path; the
            trained backbone is carried into the next session (JAX
            ``_run_general_freeze``, incremental.py:397-478).

The host loop keeps the reference's global ``np.random`` stream contract
(episode sampling reseeds per item; the replay-memory index draw continues
the stream).  The engine's other random numbers come from a draw provider
(engine/draws.py).

Under ``torch.profiler`` a run shows its layers as ranges (utils/spans.py):
``srt.eval.setup`` (``SeedRun.__init__``, with ``srt.eval.upload``) and per
session ``srt.eval.session`` around ``srt.eval.begin``, ``.epoch1``,
``.caches``, ``.k1``, ``.evaluate`` and ``.finish``.
``SessionProgram.rows_forwarded`` and ``.rows_padded`` count the backbone's
rows, the padded replay rows among them.

The pull is the subspace projection (``distance2subspace``) or the
semantic / mapping attractors, which the host computes per session in
float64 (models/lang_puller.py) and K1 takes as a target.  The multi-seed
engine (engine/multiseed.py) drives one ``SeedRun`` per seed around one
seed-batched K1 launch per session.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import MAX_SESSIONS
from ..data.episodes import EpisodeSampler, get_vocabs
from ..data.transforms import transforms_test_options
from ..models import head as head_lib
from ..models import lang_puller as lp
from ..ops import augment as aug_ops
from ..ops import losses
from ..ops.finetune import LoopConfig, finetune_loop, pack_scalars
from ..utils import artifacts
from ..utils.device import resolve_device
from ..utils.optim import adam_torch, get_optim, sgd_torch
from ..utils.spans import span
from .draws import TorchDraws


# --------------------------------------------------------------------------
# static geometry
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class SessionGeometry:
    n_ways: int
    n_shots: int
    n_aug: int
    n_queries: int
    n_base_support: int          # 0 or n_base (1 exemplar per base class)
    orig_base: int               # 60 for miniImageNet continual
    max_sessions: int
    feat_dim: int
    img_size: int
    base_eval_n: int

    @property
    def n_novel_support(self) -> int:
        return self.n_ways * self.n_shots * self.n_aug

    @property
    def n_support(self) -> int:
        return self.n_novel_support + self.n_base_support

    @property
    def n_query_per_session(self) -> int:
        return self.n_ways * self.n_queries

    @property
    def max_queries(self) -> int:
        return self.max_sessions * self.n_query_per_session

    @property
    def max_novel(self) -> int:
        return self.max_sessions * self.n_ways

    @property
    def max_classes(self) -> int:
        return self.orig_base + self.max_novel

    @property
    def mem_add(self) -> int:
        # hardcoded 5-way/5-shot/5-aug index math (language_eval.py:354-358)
        return 25

    @property
    def max_memory(self) -> int:
        return self.mem_add * self.max_sessions


def session_count(opt) -> int:
    """Sessions to run (reference eval/language_eval.py:132-136):
    ``neval_episodes`` in general; 8 for miniImageNet continual, but never
    more than the caller's (possibly class-budget-clamped)
    ``neval_episodes``."""
    if opt.continual and opt.dataset == "miniImageNet":
        n = min(MAX_SESSIONS, opt.neval_episodes)
        if n < MAX_SESSIONS:
            print(f"WARNING: miniImageNet continual trace truncated to "
                  f"{n} sessions (neval_episodes={opt.neval_episodes}; "
                  f"the reference runs {MAX_SESSIONS}, "
                  "eval/language_eval.py:132-136)")
        return n
    return opt.neval_episodes


def build_geometry(opt, n_base: int, img_size: int, base_eval_n: int,
                   feat_dim: int = 640, max_sessions: int = None,
                   has_base_support: bool = True) -> SessionGeometry:
    """``has_base_support=False`` forces the no-exemplar geometry even when
    ``opt.n_base_support_samples > 0``, so the CE mean always runs over the
    real support batch."""
    return SessionGeometry(
        n_ways=opt.n_ways, n_shots=opt.n_shots,
        n_aug=opt.n_aug_support_samples, n_queries=opt.n_queries,
        n_base_support=(n_base if (opt.n_base_support_samples > 0
                                   and has_base_support) else 0),
        orig_base=n_base,
        max_sessions=(session_count(opt) if max_sessions is None
                      else max_sessions),
        feat_dim=feat_dim, img_size=img_size, base_eval_n=base_eval_n)


def _trace_rows(opt) -> int:
    """Rows of the per-epoch (loss, acc1, acc5) trace: one per possible
    epoch 1..max_novel_epochs, rounded up to 8 as in the JAX package."""
    return ((int(opt.max_novel_epochs) + 2 + 7) // 8) * 8


def _label_pull(opt):
    return (opt.label_pull
            if getattr(opt, "pulling", "regularize") == "regularize"
            else None)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


@torch.no_grad()
def _buffers(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Copies of ``module``'s running statistics and block counters."""
    return {k: b.clone() for k, b in module.named_buffers()}


@torch.no_grad()
def _load_buffers(module: torch.nn.Module, saved) -> None:
    for k, b in module.named_buffers():
        b.copy_(saved[k])


# --------------------------------------------------------------------------
# one session
# --------------------------------------------------------------------------
def head_logits(params: Dict[str, torch.Tensor], feats: torch.Tensor,
                n_active: int) -> torch.Tensor:
    return head_lib.masked_logits(feats, params["w"], params.get("b"),
                                  n_active)


def stop_update(opt, loss, prev_loss, stable_epochs, epoch):
    """Reference stop logic (language_eval.py:298-318) -> (stable, stop)."""
    stop = torch.zeros((), dtype=torch.bool, device=loss.device)
    if opt.target_train_loss == 0:
        is_stable = torch.abs(loss - prev_loss) < opt.convergence_epsilon
        stable_epochs = torch.where(is_stable, stable_epochs + 1,
                                    torch.zeros_like(stable_epochs))
        stop = stop | (stable_epochs == opt.stable_epochs)
    stop = stop | (epoch >= opt.max_novel_epochs)
    stop = stop | ((loss <= opt.target_train_loss)
                   & (epoch >= opt.min_novel_epochs + 1))
    return stable_epochs, stop


@dataclass
class SessionInputs:
    """What the host loop hands one session (all on the engine device)."""
    head_w: torch.Tensor            # (max_classes, feat)
    head_b: Optional[torch.Tensor]  # (max_classes,) or None
    n_active: int
    w0: torch.Tensor
    b0: Optional[torch.Tensor]
    reserved: torch.Tensor          # (max_novel, feat)
    n_reserved: int
    support_x: torch.Tensor         # (n_support, 3, H, W)
    support_y: torch.Tensor         # (n_support,) int64
    memory_x: torch.Tensor          # (max_memory, 3, H, W)
    memory_y: torch.Tensor          # (max_memory,) int64
    memory_count: int
    query_x: torch.Tensor           # (n_query_sessions * nq, 3, H, W)
    query_y: torch.Tensor
    base_x: torch.Tensor
    base_y: torch.Tensor
    generator: Optional[torch.Generator]
    # the semantic / mapping attractors of the session's novel rows
    # (n_ways, feat); None unless the semantic pull is on
    sem_pullers: Optional[torch.Tensor] = None
    # the orthonormal basis of w0's base rows (feat, orig_base); None
    # unless the subspace pull is on
    base_basis: Optional[torch.Tensor] = None


@dataclass
class Prepared:
    """A session up to K1: the head after epoch 1's step with its
    optimizer state, epoch 1's loss, accuracies, stable count and stop
    flag, and the eval-mode feature caches."""
    params: Dict[str, torch.Tensor]
    mom: Dict[str, torch.Tensor]
    nu: Optional[Dict[str, torch.Tensor]]
    l1: torch.Tensor
    a1: torch.Tensor
    a5: torch.Tensor
    stable: torch.Tensor
    stop: torch.Tensor
    f_sup: torch.Tensor
    f_mem: torch.Tensor
    f_query: torch.Tensor
    f_base: torch.Tensor


@dataclass
class EpochState:
    """A session's fine-tune state between two host-driven epochs (the
    tracked and general-freeze paths): the head, its optimizer state (SGD
    momentum or Adam m and v; ``optimizer`` instead while the backbone
    trains), the last epoch's loss, accuracies, stable count and stop
    flag, and that epoch's number."""
    params: Dict[str, torch.Tensor]
    mom: Optional[Dict[str, torch.Tensor]]
    nu: Optional[Dict[str, torch.Tensor]]
    loss: torch.Tensor
    a1: torch.Tensor
    a5: torch.Tensor
    stable: torch.Tensor
    stop: torch.Tensor
    epoch: int
    optimizer: Optional[torch.optim.Optimizer] = None


def semantic_pull(opt) -> bool:
    """Whether the pull targets the semantic / mapping attractors rather
    than the subspace projection (language_eval.py:216-228)."""
    return (_label_pull(opt) is not None
            and opt.attraction_override != "distance2subspace")


class SessionProgram:
    """The JAX package's ``session_fn`` (incremental.py:1071-1197) on the
    default path, in three steps around K1: ``prepare`` (epoch 1 and the
    feature caches), ``loop_operands`` (K1's operands) and ``complete``
    (the evaluation).  Mutates ``backbone``'s BN running statistics and
    block counters, as the reference does.

    ``rows_forwarded`` counts the rows that epoch 1's train-mode forwards,
    the caches and ``eval_base`` put through the backbone, every instance
    together; ``rows_padded`` the replay rows among them that lie past
    ``memory_count``."""

    rows_forwarded = 0
    rows_padded = 0

    def __init__(self, backbone, opt, geo: SessionGeometry, with_bias: bool):
        self.backbone = backbone
        self.opt = opt
        self.geo = geo
        self.with_bias = with_bias
        self.optim = get_optim(opt)
        self.memory_on = bool(opt.memory_replay)
        self.lmbd_base = opt.lmbd_reg_transform_w
        self.lmbd_novel = opt.lmbd_reg_novel
        self.label_pull = _label_pull(opt)
        self.semantic = semantic_pull(opt)
        self.stable_mode = opt.target_train_loss == 0

    # -- epoch 1 -----------------------------------------------------------
    @torch.no_grad()
    def epoch1_forwards(self, s: SessionInputs):
        """Train-mode forwards, reference order support -> memory
        (language_eval.py:252-258).  The memory forward is skipped while
        the buffer is empty, so it touches neither the running statistics
        nor the counters (incremental.py:902)."""
        bb = self.backbone.train()
        f_sup = bb(s.support_x, generator=s.generator)
        _count_rows(s.support_x.shape[0])
        f_mem = torch.zeros((s.memory_x.shape[0], self.geo.feat_dim),
                            device=f_sup.device)
        if self.memory_on and s.memory_count > 0:
            mask = self._memory_mask(s)
            f_mem = bb(s.memory_x, sample_mask=mask, generator=s.generator)
            _count_rows(s.memory_x.shape[0], s.memory_count)
        return f_sup, f_mem

    def _memory_mask(self, s: SessionInputs) -> torch.Tensor:
        rows = torch.arange(s.memory_x.shape[0], device=s.memory_x.device)
        return (rows < s.memory_count).to(torch.float32)

    def loss_fn(self, params, s: SessionInputs, f_sup, f_mem):
        """The session loss of make_loss_fn (incremental.py:816-849)."""
        geo = self.geo
        logits = head_logits(params, f_sup, s.n_active)
        loss = losses.cross_entropy(logits, s.support_y)
        if self.memory_on:
            mlogits = head_logits(params, f_mem, s.n_active)
            loss = loss + losses.cross_entropy(mlogits, s.memory_y,
                                               self._memory_mask(s))
        if self.lmbd_base is not None:
            loss = loss + losses.regloss(
                self.lmbd_base, params["w"], s.w0, geo.orig_base,
                params.get("b"), s.b0 if self.with_bias else None)
        if self.lmbd_novel is not None:
            loss = loss + losses.reglossnovel(
                self.lmbd_novel, params["w"], s.reserved, geo.orig_base,
                s.n_reserved)
        if self.label_pull is not None:
            cur = params["w"][s.n_active - geo.n_ways:s.n_active]
            if self.semantic:
                target = s.sem_pullers
            else:
                # recomputed from the current weights
                # (language_eval.py:281-283)
                target = lp.project(s.base_basis, cur)
            loss = loss + lp.pull_loss(self.label_pull, target, cur)
        acc1, acc5 = losses.accuracy_topk(logits, s.support_y)
        return loss, acc1.detach(), acc5.detach()

    def epoch1_step(self, s: SessionInputs, f_sup, f_mem):
        """Gradient by autograd on the head only, then the optimizer's first
        step written out (incremental.py:1097-1116), which exposes its state
        to the fused loop."""
        params = {"w": s.head_w.clone().requires_grad_(True)}
        if self.with_bias:
            params["b"] = s.head_b.clone().requires_grad_(True)
        loss, a1, a5 = self.loss_fn(params, s, f_sup, f_mem)
        names = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        params = {k: v.detach() for k, v in params.items()}
        new, mom, nu = self.optim.first_step(
            params, dict(zip(names, grads)))
        return new, mom, nu, loss.detach(), a1, a5

    def prepare(self, s: SessionInputs) -> Prepared:
        """Epoch 1 (train-mode forwards, one step) and the eval-mode
        feature caches, constant for epochs 2..N."""
        with span("srt.eval.epoch1"):
            f_sup_tr, f_mem_tr = self.epoch1_forwards(s)
            params, mom, nu, l1, a1, a5 = self.epoch1_step(s, f_sup_tr,
                                                           f_mem_tr)
            stable, stop = self._stop_epoch1(l1)
        f_sup, f_mem, f_query, f_base = self.caches(s)
        return Prepared(
            params=params, mom=mom, nu=nu, l1=l1, a1=a1, a5=a5,
            stable=stable, stop=stop, f_sup=f_sup, f_mem=f_mem,
            f_query=f_query, f_base=f_base)

    def _stop_epoch1(self, l1):
        one = torch.ones((), device=l1.device)
        return stop_update(self.opt, l1, 15.0 * one, 0.0 * one, one)

    # -- the tracked path: one host-driven head epoch ----------------------
    def epoch_state(self, p: Prepared) -> EpochState:
        return EpochState(params=p.params, mom=p.mom, nu=p.nu, loss=p.l1,
                          a1=p.a1, a5=p.a5, stable=p.stable, stop=p.stop,
                          epoch=1)

    def head_epoch(self, s: SessionInputs, f_sup, f_mem,
                   st: EpochState) -> EpochState:
        """One epoch of K1's loop on the host's call: the autograd gradient
        of ``loss_fn`` on the cached features, the same coupled-decay
        SGD-momentum or Adam update, the stop rule (JAX ``epoch_fn``,
        incremental.py:943-958).  Nothing leaves the device."""
        epoch = st.epoch + 1
        params = {k: v.detach().requires_grad_(True)
                  for k, v in st.params.items()}
        loss, a1, a5 = self.loss_fn(params, s, f_sup, f_mem)
        names = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        new, mom, nu = self.optim.step(
            {k: v.detach() for k, v in params.items()},
            dict(zip(names, grads)), st.mom, st.nu, epoch)
        loss = loss.detach()
        stable, stop = stop_update(self.opt, loss, st.loss, st.stable, epoch)
        return EpochState(params=new, mom=mom, nu=nu, loss=loss, a1=a1,
                          a5=a5, stable=stable, stop=stop, epoch=epoch)

    # -- the general-freeze path: epochs with the backbone -----------------
    def full_loss(self, head, s: SessionInputs, train: bool, dropout=None):
        """The session loss through the backbone (JAX ``_full_loss``,
        incremental.py:974-1009).  ``train``: train-mode forwards of the
        support set and the masked memory, each with its dropout source of
        ``dropout``; the running statistics and counters afterwards are
        the support forward's, since the memory forward starts from the
        state before it and its update is discarded.  While the memory is
        empty its forward is skipped (zero features, a replay CE of 0), as
        in the compiled session: the JAX path runs it and divides by a
        zero count.  Otherwise eval-mode forwards (running statistics, no
        dropout), which advance nothing."""
        bb = self.backbone.train(train)
        f_mem = torch.zeros((s.memory_x.shape[0], self.geo.feat_dim),
                            device=s.memory_x.device)
        if not train:
            f_sup = bb(s.support_x)
            if self.memory_on:
                f_mem = bb(s.memory_x)
            return self.loss_fn(head, s, f_sup, f_mem)
        before = _buffers(bb)
        f_sup = bb(s.support_x, generator=dropout[0])
        if self.memory_on and s.memory_count > 0:
            after = _buffers(bb)
            _load_buffers(bb, before)
            f_mem = bb(s.memory_x, sample_mask=self._memory_mask(s),
                       generator=dropout[1])
            _load_buffers(bb, after)
        return self.loss_fn(head, s, f_sup, f_mem)

    def prepare_full(self, s: SessionInputs, dropout) -> EpochState:
        """Epoch 1 with gradients to the backbone and the head, one step of
        one ``torch.optim`` optimizer over both (JAX ``prepare_full_fn``,
        incremental.py:1012-1037).  Trains ``self.backbone`` in place."""
        head = {"w": s.head_w.clone().requires_grad_(True)}
        if self.with_bias:
            head["b"] = s.head_b.clone().requires_grad_(True)
        hp = self.optim
        params = list(self.backbone.parameters()) + list(head.values())
        if hp.adam:
            optimizer = adam_torch(params, hp.lr, hp.weight_decay, hp.b1,
                                   hp.b2, hp.eps)
        else:
            optimizer = sgd_torch(params, hp.lr, hp.momentum,
                                  hp.weight_decay)
        loss, a1, a5 = self._full_step(optimizer, head, s, True, dropout)
        stable, stop = self._stop_epoch1(loss)
        return EpochState(params=head, mom=None, nu=None, loss=loss, a1=a1,
                          a5=a5, stable=stable, stop=stop, epoch=1,
                          optimizer=optimizer)

    def full_epoch(self, s: SessionInputs, st: EpochState) -> EpochState:
        """An epoch 2..F-1: eval-mode forwards that carry gradients to every
        parameter, one optimizer step (JAX ``full_epoch_fn``,
        incremental.py:1040-1060)."""
        epoch = st.epoch + 1
        loss, a1, a5 = self._full_step(st.optimizer, st.params, s, False)
        stable, stop = stop_update(self.opt, loss, st.loss, st.stable, epoch)
        return EpochState(params=st.params, mom=None, nu=None, loss=loss,
                          a1=a1, a5=a5, stable=stable, stop=stop,
                          epoch=epoch, optimizer=st.optimizer)

    def _full_step(self, optimizer, head, s, train, dropout=None):
        loss, a1, a5 = self.full_loss(head, s, train, dropout)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach(), a1, a5

    def freeze(self, st: EpochState) -> EpochState:
        """The backbone freezes: the head and its surviving optimizer state
        (JAX ``_subset_opt_state``, incremental.py:1205-1219; the backbone
        gets no gradient from here on, so torch's optimizer would skip
        it)."""
        state = st.optimizer.state
        params = {k: v.detach() for k, v in st.params.items()}
        if self.optim.adam:
            mom = {k: state[v]["exp_avg"] for k, v in st.params.items()}
            nu = {k: state[v]["exp_avg_sq"] for k, v in st.params.items()}
        else:
            # SGD without momentum keeps no buffer: the next step's
            # "momentum" is then its decayed gradient alone
            mom = {k: state[v].get("momentum_buffer") for k, v in
                   st.params.items()}
            mom = {k: torch.zeros_like(params[k]) if m is None else m
                   for k, m in mom.items()}
            nu = None
        return EpochState(params=params, mom=mom, nu=nu, loss=st.loss,
                          a1=st.a1, a5=st.a5, stable=st.stable, stop=st.stop,
                          epoch=st.epoch)

    def caches(self, s: SessionInputs):
        """Eval-mode features of support, memory, queries and base batch
        (JAX ``cache_feats_fn``, incremental.py:1063-1068)."""
        with span("srt.eval.caches"):
            if self.memory_on:
                f_mem = self.features(s.memory_x)
                _count_rows(s.memory_x.shape[0], s.memory_count)
            else:
                f_mem = torch.zeros((s.memory_x.shape[0], self.geo.feat_dim),
                                    device=s.memory_x.device)
            _count_rows(s.support_x.shape[0] + s.query_x.shape[0]
                        + s.base_x.shape[0])
            return (self.features(s.support_x), f_mem,
                    self.features(s.query_x), self.features(s.base_x))

    # -- epochs 2..N -------------------------------------------------------
    def loop_operands(self, s: SessionInputs, p: Prepared):
        """K1's operands and configuration (incremental.py:161-279).  Bias
        heads use the [W | b] layout: the bias is one more feature column
        and the features gain a matching ones column."""
        geo, opt = self.geo, self.opt
        dev = p.f_sup.device
        feat = geo.feat_dim
        cp = geo.max_classes
        d = feat + (1 if self.with_bias else 0)

        def wb(tree):
            if not self.with_bias:
                return tree["w"].contiguous()
            return torch.cat([tree["w"], tree["b"][:, None]], 1)

        def feats_aug(f):
            if not self.with_bias:
                return f.contiguous()
            return torch.cat([f, torch.ones((f.shape[0], 1), device=dev)], 1)

        w0 = reserved = pull_op = pull_tgt = None
        if self.lmbd_base is not None:
            w0 = wb({"w": s.w0, "b": s.b0})
        if self.lmbd_novel is not None:
            reserved = torch.zeros((cp, d), device=dev)
            reserved[geo.orig_base:geo.orig_base + geo.max_novel,
                     :feat] = s.reserved
        pull_mode = "none"
        if self.label_pull is not None and self.semantic:
            # the targets sit at the current novel rows
            # (incremental.py:236-242)
            pull_mode = "semantic"
            pull_tgt = torch.zeros((cp, d), device=dev)
            pull_tgt[s.n_active - geo.n_ways:s.n_active, :feat] = \
                s.sem_pullers
        elif self.label_pull is not None:
            pull_mode = "subspace"
            q = s.base_basis                                  # (feat, base)
            pull_op = torch.zeros((d, d), device=dev)
            pull_op[:feat, :feat] = (torch.eye(feat, device=dev)
                                     - q @ q.T)
        hp = self.optim
        scalars = pack_scalars(
            dev, lr=hp.lr, wd=hp.weight_decay, momentum=hp.momentum,
            lmbd_base=self.lmbd_base or 0.0,
            lmbd_novel=self.lmbd_novel or 0.0,
            gamma=self.label_pull or 0.0, eps=opt.convergence_epsilon,
            target_loss=opt.target_train_loss,
            min_epochs=opt.min_novel_epochs,
            max_epochs=opt.max_novel_epochs,
            stable_target=opt.stable_epochs, adam_b1=hp.b1, adam_b2=hp.b2,
            adam_eps=hp.eps, prev_loss0=p.l1, stable0=p.stable, acc1_0=p.a1,
            acc5_0=p.a5)
        cfg = LoopConfig(
            n_sup=geo.n_support, mem_count=s.memory_count,
            n_active=s.n_active, n_reserved=s.n_reserved,
            orig_base=geo.orig_base, n_ways=geo.n_ways,
            memory_on=self.memory_on,
            use_regbase=self.lmbd_base is not None,
            use_regnovel=self.lmbd_novel is not None, pull_mode=pull_mode,
            stable_mode=self.stable_mode, trace_rows=_trace_rows(opt),
            use_adam=hp.adam, bias_col=feat if self.with_bias else None)
        ops = dict(
            f_sup=feats_aug(p.f_sup),
            y_sup=s.support_y.to(torch.int32).contiguous(),
            f_mem=feats_aug(p.f_mem),
            y_mem=s.memory_y.to(torch.int32).contiguous(),
            w=wb(p.params), mom=wb(p.mom),
            nu=wb(p.nu) if p.nu is not None else None, w0=w0,
            reserved=reserved, pull_op=pull_op, pull_tgt=pull_tgt,
            scalars=scalars)
        return ops, cfg

    # -- evaluation --------------------------------------------------------
    @torch.no_grad()
    def features(self, x: torch.Tensor) -> torch.Tensor:
        return self.backbone.eval()(x)

    @torch.no_grad()
    def evaluate(self, params, f_query, query_y, f_base, base_y, n_active):
        """Novel query chunks of the sessions so far + the base batch
        (language_eval.py:18-69): (chunk accuracies, base accuracy, query
        predictions, base predictions)."""
        nq = self.geo.n_query_per_session
        logits_q = head_logits(params, f_query, n_active)
        chunk_accs = torch.stack([
            losses.accuracy_topk(logits_q[lo:lo + nq], query_y[lo:lo + nq])[0]
            for lo in range(0, f_query.shape[0], nq)])
        logits_b = head_logits(params, f_base, n_active)
        base_acc, _ = losses.accuracy_topk(logits_b, base_y)
        # argmax takes the first of tied rows, as jnp.argmax does
        return chunk_accs, base_acc, logits_q.argmax(1), logits_b.argmax(1)

    def complete(self, s: SessionInputs, p: Prepared, loop_out):
        """The head after K1's ``loop_out`` (w, stats, trace) and the
        session's metrics."""
        with span("srt.eval.evaluate"):
            w_out, stats, trace = loop_out
            feat = self.geo.feat_dim
            params = {"w": w_out[:, :feat]}
            if self.with_bias:
                params["b"] = w_out[:, feat]
            trace[1] = torch.stack([p.l1, p.a1, p.a5])
            metrics = self.metrics(params, s, p.f_query, p.f_base, stats[1])
            metrics["epoch_trace"] = trace
            return params, metrics

    def metrics(self, params, s: SessionInputs, f_query, f_base, epochs):
        chunk_accs, base_acc, q_preds, b_preds = self.evaluate(
            params, f_query, s.query_y, f_base, s.base_y, s.n_active)
        return {"chunk_accs": chunk_accs, "base_acc": base_acc,
                "epochs": epochs, "query_preds": q_preds,
                "base_preds": b_preds}

    def __call__(self, s: SessionInputs):
        p = self.prepare(s)
        with span("srt.eval.k1"):
            ops, cfg = self.loop_operands(s, p)
            out = finetune_loop(**ops, cfg=cfg)
        return self.complete(s, p, out)


def _count_rows(n: int, filled: Optional[int] = None) -> None:
    """``n`` rows forwarded through the backbone; with ``filled``, replay
    rows of which those past ``filled`` are padding."""
    SessionProgram.rows_forwarded += n
    if filled is not None:
        SessionProgram.rows_padded += n - filled


@torch.no_grad()
def eval_base(backbone, head_w, head_b, n_active: int, base_x, base_y):
    """Standalone base-batch accuracy (reference eval_base,
    language_eval.py:46-69) for the initial pre-session measurement."""
    feats = backbone.eval()(base_x)
    _count_rows(base_x.shape[0])
    params = {"w": head_w} if head_b is None else {"w": head_w, "b": head_b}
    acc1, _ = losses.accuracy_topk(head_logits(params, feats, n_active),
                                   base_y)
    return acc1


# --------------------------------------------------------------------------
# host orchestration
# --------------------------------------------------------------------------
@dataclass
class IncrementalResult:
    acc_novel_avg: float
    acc_base_avg: float
    weighted_avg_l: List[float]
    acc_novel_list: List[float]
    acc_base_list: List[float]
    novel_session_traces: List[List[float]]
    epochs_per_session: List[int]
    # each session's wall time, from its start to the device-to-host pull
    # of its metrics
    session_seconds: List[float] = field(default_factory=list)

    @property
    def acc_average(self) -> float:
        return (self.acc_novel_avg + self.acc_base_avg) / 2


class _Meter:
    """AverageMeter (reference eval/util.py:9-24)."""

    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def update(self, v, n=1):
        self.sum += v * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(self.count, 1)


# the columns of the vis frames (language_eval.py:81-83)
VIS_COLUMNS = ("idx", "class", "isbase", "predicted", "img")


def _print_epoch_line(prt, epoch, loss, a1, a5):
    """The reference's per-10-epoch fine-tune print
    (language_eval.py:310-315)."""
    prt("Novel Epoch {:4d}\t"
        "Train Loss {:10.4f}\t"
        "Acc@1 {:10.3f}\t"
        "Acc@5 {:10.3f}".format(epoch, float(loss), float(a1), float(a5)))


def check_options(opt, with_bias: bool, vis: bool = False) -> None:
    """What the JAX engine refuses too (incremental.py:1313-1331)."""
    if with_bias and opt.lmbd_reg_novel is not None:
        raise NotImplementedError(
            "reference reglossnovel bias branch crashes "
            "(models/resnet_language.py:239)")
    if vis and opt.freeze_backbone_at != 1:
        raise NotImplementedError(
            "vis frames require the per-epoch tracked engine, which serves "
            "freeze_backbone_at == 1 only; the general-freeze path records "
            "tracking CSVs but not vis frames")


def _pull(tensors) -> List[np.ndarray]:
    """``tensors`` on the host in one device-to-host copy, as float32
    arrays of their shapes (small integers and flags are exact)."""
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32)
                      for t in tensors]).cpu().numpy()
    out, lo = [], 0
    for t in tensors:
        out.append(flat[lo:lo + t.numel()].reshape(tuple(t.shape)))
        lo += t.numel()
    return out


class SeedRun:
    """One seed's host side of the multi-session protocol
    (language_eval.py:71-454): its episode sampler and ``np.random``
    stream, the base batch and exemplars, the growing head, the reserved
    rows, the replay memory, the query collection, the attractors and the
    printed trace.  ``begin(idx)`` composes session ``idx``'s inputs,
    ``finish`` takes the session program's head and metrics.  The
    single-seed engine drives one; the multi-seed engine drives one per
    seed around one seed-batched K1 launch per session.  ``backbone`` and
    ``head0`` are copied, never mutated."""

    def __init__(self, backbone, head0: head_lib.Head, meta, opt,
                 meta_sampler: EpisodeSampler, base_test_split,
                 base_support_sampler: Optional[EpisodeSampler],
                 base_split_for_vocab, dev: torch.device, draws, prt,
                 vis: bool = False):
        with span("srt.eval.setup"):
            self.opt, self.meta, self.dev, self.prt = opt, meta, dev, prt
            self.meta_sampler = meta_sampler
            self.base_test_split = base_test_split
            self.base_split_for_vocab = base_split_for_vocab
            self.with_bias = head0.bias is not None
            np.random.seed(opt.set_seed)
            self.draws = (draws if draws is not None
                          else TorchDraws(opt.set_seed, dev))
            self.train_spec, test_spec = transforms_test_options[
                opt.transform]
            img_size = base_test_split.imgs.shape[1]
            base_eval_n = opt.test_base_batch_size // 2
            geo = build_geometry(opt, n_base=int(head0.n_active),
                                 img_size=img_size, base_eval_n=base_eval_n,
                                 feat_dim=int(head0.in_dim),
                                 has_base_support=base_support_sampler
                                 is not None)
            self.geo = geo
            self.program = SessionProgram(copy.deepcopy(backbone).to(dev),
                                          opt, geo, self.with_bias)

            # fixed base evaluation batch: the first test_base_batch_size//2
            # samples of the base-test split (eval_incremental.py:53-57);
            # the novel split's images live on the device once, episodes
            # are row gathers
            with span("srt.eval.upload"):
                base_u8 = self._upload(base_test_split.imgs[:base_eval_n])
                self.novel_imgs = self._upload(meta_sampler.base.imgs)
            min_lbl = min(base_test_split.labels)
            self.base_x = _nchw(aug_ops.normalize_batch(base_u8, test_spec))
            self.base_y_host = np.asarray(
                [l - min_lbl for l in base_test_split.labels[:base_eval_n]],
                np.int64)
            self.base_y = self._upload(self.base_y_host)
            self.test_spec = test_spec

            # fixed base-class exemplars kept in every session's support
            # (language_eval.py:112-117)
            self.base_sup_x = self.base_sup_y = None
            if base_support_sampler is not None:
                ep = base_support_sampler.get(0)
                self.base_sup_x = _nchw(aug_ops.augment_batch(
                    self._upload(ep.support_x), self.train_spec,
                    self.draws.base_augment(len(ep.support_x),
                                            self.train_spec).to(dev)))
                self.base_sup_y = ep.support_y.astype(np.int64)

            head_w = head0.weight.to(dev, torch.float32)
            if head_w.shape[0] != geo.max_classes:
                raise ValueError(f"head must be padded to "
                                 f"{geo.max_classes} rows, got "
                                 f"{head_w.shape[0]}")
            self.head_w = head_w
            self.head_b = (head0.bias.to(dev, torch.float32)
                           if self.with_bias else None)
            self.n_active = int(head0.n_active)
            self.w0, self.b0 = self.head_w, self.head_b
            # the subspace pull's basis: w0 stays the session-0 head, so one
            # QR serves every session and epoch
            self.base_basis = None
            if (self.program.label_pull is not None
                    and not self.program.semantic):
                self.base_basis = lp.subspace_basis(self.w0[:geo.orig_base])
            self.reserved = torch.zeros((geo.max_novel, geo.feat_dim),
                                        device=dev)
            self.n_reserved = 0
            self.memory_x = torch.zeros(
                (geo.max_memory, 3, img_size, img_size), device=dev)
            self.memory_y = torch.zeros((geo.max_memory,), dtype=torch.int64,
                                        device=dev)
            self.memory_count = 0
            self.query_x = torch.zeros(
                (geo.max_queries, 3, img_size, img_size), device=dev)
            self.query_y = torch.zeros((geo.max_queries,), dtype=torch.int64,
                                       device=dev)
            self.query_y_host = np.zeros((geo.max_queries,), np.int64)
            self.lang_state = None

            self.acc_novel, self.acc_base = _Meter(), _Meter()
            self.weighted_avg_l: List[float] = []
            self.acc_novel_list: List[float] = []
            self.acc_base_list: List[float] = []
            self.traces: List[List[float]] = []
            self.epochs_l: List[int] = []
            self.secs: List[float] = []
            self.vocab_base = self.vocab_novel = None

            # the tracked path runs the head epochs one at a time for
            # per-epoch artifacts (incremental.py:1361-1363); it and the
            # general freeze print each session's header before its epochs
            # (:1395)
            self.live = (getattr(opt, "track_weights", False)
                         or getattr(opt, "track_label_inspired_weights",
                                    False)
                         or vis or opt.freeze_backbone_at != 1)
            # prediction dumps (language_eval.py:407-438)
            self.save_preds = bool(getattr(opt, "save_preds_0", False))
            self.preds_rows = artifacts.new_prediction_rows()
            self.id2orig: Dict[int, int] = {}
            self.basec_map_rev = {}
            if opt.continual and meta.get("training_classes"):
                self.basec_map_rev = {
                    v: k for k, v in meta["training_classes"].items()}
            # per-epoch artifacts (language_eval.py:328-349)
            self.track_weight_rows: List = []
            self.track_inspired_rows: List = []
            self.vis_rows = {c: [] for c in VIS_COLUMNS} if vis else None
            # this seed's np.random stream, which the episodes and the
            # replay index draws continue
            self.stream = np.random.get_state()
            # initial base accuracy (language_eval.py:128-129)
            self.weighted_avg_l.append(float(eval_base(
                self.program.backbone, self.head_w, self.head_b,
                self.n_active, self.base_x, self.base_y)))

    def _upload(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)

    def begin(self, idx: int) -> SessionInputs:
        """Session ``idx``'s inputs: the episode and, right after it on
        this seed's ``np.random`` stream, the replay-memory index draw;
        vocabularies, reserved rows, augmentation, the grown query
        collection, head growth and the attractors."""
        with span("srt.eval.begin"):
            geo, opt, dev = self.geo, self.opt, self.dev
            np.random.set_state(self.stream)
            ep = self.meta_sampler.get(idx)
            self.mem_inds = None
            if opt.memory_replay:
                if (geo.n_ways, geo.n_shots, geo.n_aug) != (5, 5, 5):
                    raise ValueError(
                        "memory_replay requires the 5-way/5-shot/5-aug "
                        "support layout: the reference's replay index math "
                        "is hardcoded to it (eval/language_eval.py:354-358); "
                        "got "
                        f"{geo.n_ways}-way/{geo.n_shots}-shot/{geo.n_aug}-aug")
                # language_eval.py:352-359
                inds = np.random.choice(opt.n_shots, opt.memory_replay)
                margin = 5 * np.arange(5)
                offset = np.arange(0, 125, 25)
                inds = (np.tile(margin + inds, (5, 1))
                        + (np.tile(offset, (5, 1))).T)
                self.mem_inds = inds.flatten()
            self.stream = np.random.get_state()

            # vocab bookkeeping (language_eval.py:155-167)
            prev_vocab_base = self.vocab_base
            prev_vocab_novel = self.vocab_novel
            vb, vocab_all, vocab_novel, orig2id = get_vocabs(
                self.base_split_for_vocab or self.base_test_split,
                self.meta_sampler.base, ep.query_y)
            self.vocab_base = (vb if idx == 0
                               else prev_vocab_base + prev_vocab_novel)
            self.vocab_novel = vocab_novel

            # reserve the previous session's novel rows
            # (language_eval.py:169-186)
            if idx >= 1:
                lo = geo.orig_base + geo.n_ways * (idx - 1)
                self.reserved[geo.n_ways * (idx - 1):geo.n_ways * idx] = \
                    self.head_w[lo:lo + geo.n_ways]
                self.n_reserved = geo.n_ways * idx

            self.novel_labels = np.sort(np.unique(ep.query_y))
            for k in list(orig2id.keys()):
                orig2id[k] = orig2id[k] + idx * opt.n_ways
            self.orig2id = orig2id
            query_ys_id = np.asarray([orig2id[int(y)] for y in ep.query_y],
                                     np.int64)
            support_ys_id = np.asarray([orig2id[int(y)] for y in ep.support_y],
                                       np.int64)

            # episode realization + augmentation on the device
            if ep.support_idx is not None:
                sup_u8 = self.novel_imgs[self._upload(
                    ep.support_idx.astype(np.int64))]
                qry_u8 = self.novel_imgs[self._upload(
                    ep.query_idx.astype(np.int64))]
            else:
                sup_u8, qry_u8 = self._upload(ep.support_x), self._upload(
                    ep.query_x)
            support_x = _nchw(aug_ops.augment_batch(
                sup_u8, self.train_spec,
                self.draws.support_augment(idx, sup_u8.shape[0],
                                           self.train_spec).to(dev)))
            # grow the query collection (language_eval.py:198-204)
            nq = geo.n_query_per_session
            self.query_x[idx * nq:(idx + 1) * nq] = _nchw(
                aug_ops.normalize_batch(qry_u8, self.test_spec))
            self.query_y[idx * nq:(idx + 1) * nq] = self._upload(query_ys_id)
            self.query_y_host[idx * nq:(idx + 1) * nq] = query_ys_id
            if self.vis_rows is not None and idx == 0:
                # the frames show the RAW uint8 queries: the reference hands
                # image_formatter its normalized tensors, whose max-scale and
                # uint8 cast wrap them (incremental.py:1558-1562)
                self.vis_imgs = [artifacts.image_formatter(im)
                                 for im in qry_u8.cpu().numpy()]
                self.vocab_all = vocab_all

            if self.base_sup_x is not None:
                support_x = torch.cat([support_x, self.base_sup_x], 0)
                support_ys_id = np.concatenate([support_ys_id,
                                                self.base_sup_y])
            self.support_x, self.support_ys_id = support_x, support_ys_id

            # classifier growth (language_eval.py:214): a fresh init block,
            # rolled so that its row j lands at n_active + j
            new_w, new_b = self.draws.head_growth(idx, geo.max_classes,
                                                  geo.feat_dim, self.with_bias)
            grown = head_lib.augment(
                head_lib.Head(weight=self.head_w, bias=self.head_b,
                              n_active=self.n_active),
                new_w.to(dev), None if new_b is None else new_b.to(dev),
                len(self.novel_labels))
            self.head_w, self.head_b = grown.weight, grown.bias
            self.n_active = grown.n_active

            return SessionInputs(
                head_w=self.head_w, head_b=self.head_b, n_active=self.n_active,
                w0=self.w0, b0=self.b0, reserved=self.reserved,
                n_reserved=self.n_reserved, support_x=support_x,
                support_y=self._upload(support_ys_id), memory_x=self.memory_x,
                memory_y=self.memory_y, memory_count=self.memory_count,
                query_x=self.query_x[:(idx + 1) * nq],
                query_y=self.query_y[:(idx + 1) * nq], base_x=self.base_x,
                base_y=self.base_y, generator=self.draws.dropout(idx),
                sem_pullers=self._attractors(idx, vocab_novel),
                base_basis=self.base_basis)

    def _attractors(self, idx: int, vocab_novel) -> Optional[torch.Tensor]:
        """The semantic / mapping attractors (language_eval.py:216-228),
        computed in float64 on the host and rounded once.  The embeddings
        are read only when the semantic pull uses them (the reference
        reads them for the subspace pull too, and overrides them)."""
        opt = self.opt
        if not semantic_pull(opt):
            return None
        if idx == 0:
            self.lang_state = lp.create_lang_puller(opt, self.vocab_base,
                                                    vocab_novel)
        else:
            self.lang_state = lp.update_novel_embeds(self.lang_state, opt,
                                                     vocab_novel)
        if opt.attraction_override == "mapping_linear_label2image":
            m = self.meta["mapping_linear_label2image"]
            self.lang_state = lp.with_mapping(self.lang_state, m["weight"],
                                              m["bias"])
        sem = lp.pullers_host_f64(
            self.lang_state, self.w0[:self.geo.orig_base].cpu().numpy())
        return self._upload(sem)

    # -- the live paths: tracked and general freeze ------------------------
    def run_session(self, idx: int) -> None:
        """Session ``idx`` of the single-seed engine on its mode's path."""
        with span("srt.eval.session"):
            if self.live:
                self.prt(f"\n**** Iteration {idx + 1}/"
                         f"{self.geo.max_sessions} ****\n")
            t0 = time.time()
            s = self.begin(idx)
            if self.opt.freeze_backbone_at != 1:
                params, metrics = self._general_freeze(idx, s)
            elif self.live:
                params, metrics = self._tracked(idx, s)
            else:
                params, metrics = self.program(s)
            # the novel weight of the weighted average: the classes seen
            # less the reference's constant 60 (incremental.py:1469)
            self.finish(idx, params, metrics, t0,
                        len(self.vocab_base) + len(self.vocab_novel) - 60)

    def _tracked(self, idx: int, s: SessionInputs):
        """Epoch 1 and the caches, then one head epoch at a time, recorded
        after each (JAX ``_run_tracked``, incremental.py:320-394)."""
        prog = self.program
        p = prog.prepare(s)
        watch = self._watch(idx, s, p.f_query)
        st = self._live_epochs(prog.epoch_state(p), watch, lambda st:
                               prog.head_epoch(s, p.f_sup, p.f_mem, st),
                               first=True)
        return st.params, prog.metrics(st.params, s, p.f_query, p.f_base,
                                       torch.tensor(st.epoch))

    def _general_freeze(self, idx: int, s: SessionInputs):
        """freeze_backbone_at = F != 1: epochs 1..F-1 train the backbone
        too, then the head alone on the trained backbone's features, with
        the surviving optimizer state (JAX ``_run_general_freeze``,
        incremental.py:397-478)."""
        prog, freeze_at = self.program, self.opt.freeze_backbone_at
        watch = self._watch(idx, s)
        st = prog.prepare_full(s, self.draws.dropout_full(idx))
        st = self._live_epochs(st, watch, lambda st: prog.full_epoch(s, st),
                               first=True,
                               more=lambda st: st.epoch + 1 < freeze_at)
        f_sup, f_mem, f_query, f_base = prog.caches(s)
        st = self._live_epochs(prog.freeze(st), watch, lambda st:
                               prog.head_epoch(s, f_sup, f_mem, st))
        return st.params, prog.metrics(st.params, s, f_query, f_base,
                                       torch.tensor(st.epoch))

    def _live_epochs(self, st: EpochState, watch, step, first=False,
                     more=lambda st: True) -> EpochState:
        """Epochs by ``step`` while the stop rule and ``more`` allow, each
        followed by one device-to-host pull of the stop flag, the printed
        values and what ``watch`` records.  ``first``: ``st`` is epoch 1's,
        not yet pulled.  ``st.stop`` comes back a host bool."""
        tensors, record = watch
        verbose = getattr(self.opt, "verbose", False)

        def sync(st):
            host = _pull([torch.stack([st.stop.to(torch.float32), st.loss,
                                       st.a1, st.a5])] + tensors(st.params))
            st.stop = bool(host[0][0])
            record(st.epoch, host[1:])
            if verbose and st.epoch % 10 == 0:
                _print_epoch_line(self.prt, st.epoch, *host[0][1:])
            return st

        if first:
            st = sync(st)
        while not st.stop and more(st):
            st = sync(step(st))
        return st

    def _watch(self, idx: int, s: SessionInputs, f_query=None):
        """(tensors(params), record(epoch, arrays)): what to pull after an
        epoch and how to record it — the tracked weights, the inspired
        weights (JAX ``_make_recorder``, incremental.py:282-308) and, at
        session 0 with ``vis``, the query predictions of the frame
        (:345-366)."""
        opt, geo = self.opt, self.geo
        want_w = getattr(opt, "track_weights", False)
        want_insp = getattr(opt, "track_label_inspired_weights", False)
        want_vis = (self.vis_rows is not None and idx == 0
                    and f_query is not None)
        vocab_base, vocab_novel = self.vocab_base, self.vocab_novel
        nq = geo.n_query_per_session

        def tensors(params):
            w = params["w"]
            out = [w] if want_w else []
            if want_insp:
                if opt.attraction_override == "distance2subspace":
                    # the reference's path crashes on an undefined variable
                    # (language_eval.py:329); the actual attractors
                    out.append(lp.project(
                        s.base_basis,
                        w[s.n_active - geo.n_ways:s.n_active].detach()))
                elif s.sem_pullers is not None:
                    out.append(s.sem_pullers)
                else:
                    out.append(torch.zeros((geo.n_ways, geo.feat_dim),
                                           device=w.device))
            if want_vis:
                out.append(head_logits(params, f_query[:nq],
                                       s.n_active).argmax(1))
            return out

        def record(epoch, arrays):
            it = iter(arrays)
            if want_w:
                w = next(it)
                for k, lbl in enumerate(vocab_base):
                    self.track_weight_rows.append(
                        [idx, "base", lbl, lbl, epoch, w[k].copy()])
                for k, lbl in enumerate(vocab_novel):
                    self.track_weight_rows.append(
                        [idx, "novel", lbl, lbl, epoch,
                         w[len(vocab_base) + k].copy()])
            if want_insp:
                insp = next(it)
                for k, lbl in enumerate(vocab_novel):
                    self.track_inspired_rows.append(
                        [idx, lbl, epoch, insp[k].copy()])
            if want_vis:
                preds = next(it)
                rows = self.vis_rows
                for i in range(nq):
                    rows["idx"].append(idx)
                    rows["class"].append(
                        self.vocab_all[int(self.query_y_host[i])])
                    rows["isbase"].append(False)
                    rows["predicted"].append(self.vocab_all[int(preds[i])])
                    rows["img"].append(self.vis_imgs[i])

        return tensors, record

    def write_tracking_csvs(self) -> None:
        """The tracking CSVs with the reference's names in the working
        directory (language_eval.py:441-446; JAX
        ``_write_tracking_csvs``, incremental.py:481-512)."""
        import csv
        opt = self.opt

        def fmt(v):
            if isinstance(v, np.ndarray):
                return " ".join(f"{x:.6g}" for x in v.ravel())
            return v

        suffix = (f"{opt.eval_mode}_pulling_{getattr(opt, 'pulling', None)}_"
                  f"{opt.label_pull}_target_loss_{opt.target_train_loss}_"
                  f"synonyms_{opt.use_synonyms}.csv")
        for flag, name, header, rows in (
                ("track_label_inspired_weights", "track_inspired",
                 ["episode", "label", "fine_tune_epoch", "inspired_weight"],
                 self.track_inspired_rows),
                ("track_weights", "track_weights",
                 ["episode", "type", "label", "class", "fine_tune_epoch",
                  "classifier_weight"], self.track_weight_rows)):
            if not getattr(opt, flag, False):
                continue
            path = f"{name}_{suffix}"
            with open(path, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(header)
                for row in rows:
                    w.writerow([fmt(v) for v in row])
            self.prt("saved", path)

    def finish(self, idx: int, params, metrics, t0: float,
               novel_weight: float) -> None:
        """Take the session's head, update the replay memory
        (language_eval.py:352-359) and record and print the session's
        metrics (language_eval.py:370-404); ``novel_weight`` is the
        weighted average's novel weight, which the caller's engine
        defines.  The session's seconds run from ``t0`` (``time.time()``
        at its start) to the pull of its metrics, which waits for the
        device.  The predictions leave the device only for
        ``--save_preds_0``."""
        with span("srt.eval.finish"):
            geo, opt, prt = self.geo, self.opt, self.prt
            self.head_w = params["w"]
            if self.with_bias:
                self.head_b = params["b"]
            if self.mem_inds is not None:
                inds = self.mem_inds
                n_new = len(inds)
                lo = self.memory_count
                self.memory_x[lo:lo + n_new] = self.support_x[
                    self._upload(inds)]
                self.memory_y[lo:lo + n_new] = self._upload(
                    self.support_ys_id[inds])
                self.memory_count += n_new

            keys = ["chunk_accs", "base_acc", "epochs"]
            if not self.live and getattr(opt, "verbose", False):
                keys.append("epoch_trace")
            if self.save_preds:
                keys += ["query_preds", "base_preds"]
            host = {k: metrics[k].cpu().numpy() for k in keys}
            self.secs.append(time.time() - t0)
            epochs_run = int(host["epochs"])
            if not self.live:
                prt(f"\n**** Iteration {idx + 1}/{geo.max_sessions} ****\n")
                if getattr(opt, "verbose", False):
                    tr = host["epoch_trace"]
                    for e in range(10, epochs_run + 1, 10):
                        _print_epoch_line(prt, e, tr[e, 0], tr[e, 1], tr[e, 2])
            # the reference reports the mean of per-session accs ROUNDED to two
            # decimals (language_eval.py:370-374)
            session_trace = [round(float(a), 2) for a in host["chunk_accs"]]
            prt("Novel session accuracies: ", session_trace)
            test_acc = float(np.array(session_trace).mean())
            acc_base_ = float(host["base_acc"])
            self.acc_base.update(acc_base_)
            self.acc_novel.update(test_acc)
            # reference: 60 for mini, 200 for tiered (language_eval.py:383)
            w1 = 200 if opt.dataset == "tieredImageNet" else 60
            w2 = novel_weight
            weighted_avg = (w1 * acc_base_ + w2 * test_acc) / (w1 + w2)
            self.weighted_avg_l.append(round(weighted_avg, 2))
            self.acc_novel_list.append(round(test_acc, 2))
            self.acc_base_list.append(round(acc_base_, 2))
            self.traces.append(session_trace)
            self.epochs_l.append(epochs_run)
            acc_base, acc_novel = self.acc_base, self.acc_novel
            prt(f"***Running weighted avg: {weighted_avg}")
            if self.save_preds:
                self._dump_predictions(idx, host["query_preds"],
                                       host["base_preds"])
            prt(f"{'Classes:':25} {self.novel_labels}\n"
                f"{'Labels:':25} {self.vocab_novel}\n"
                f"{'Fine-tuning epochs:':25} {epochs_run}\n"
                f"{'Novel acc:':25} {test_acc:.4f}\n"
                f"{'Base acc:':25} {acc_base_:.4f}\n"
                f"{'Average:':25} {(test_acc + acc_base_) / 2:.4f}\n"
                f"{'Runnning Base Avg:':25} {acc_base.avg:.4f}\n"
                f"{'Running Novel Avg:':25} {acc_novel.avg:.4f}\n"
                f"{'Running Average:':25} "
                f"{(acc_base.avg + acc_novel.avg) / 2:.4f}\n",
                flush=True)

    def _dump_predictions(self, idx: int, q_preds, b_preds) -> None:
        """Session ``idx``'s rows of the prediction dump (the session-0
        queries and the base batch), and at the last session the file
        (JAX incremental.py:1480-1499)."""
        import os
        for k, v in self.orig2id.items():
            self.id2orig[v] = k
        nq0 = self.geo.n_query_per_session
        artifacts.accumulate_prediction_rows(
            self.preds_rows, idx, q_preds[:nq0], self.query_y_host[:nq0],
            b_preds, self.base_y_host, self.id2orig, self.basec_map_rev)
        if idx == self.geo.max_sessions - 1:
            os.makedirs("csv_files_mem", exist_ok=True)
            fname = artifacts.predictions_csv_name(self.opt)
            artifacts.save_predictions_csv(
                fname, {k: np.asarray(v) for k, v in self.preds_rows.items()})
            self.prt("saved", fname)

    def result(self) -> IncrementalResult:
        self.prt("Overall continual accuracies: ", self.weighted_avg_l)
        self.prt("Novel only incremental: ", self.acc_novel_list)
        self.prt("Base only incremental: ", self.acc_base_list)
        return IncrementalResult(
            acc_novel_avg=self.acc_novel.avg, acc_base_avg=self.acc_base.avg,
            weighted_avg_l=self.weighted_avg_l,
            acc_novel_list=self.acc_novel_list,
            acc_base_list=self.acc_base_list,
            novel_session_traces=self.traces,
            epochs_per_session=self.epochs_l, session_seconds=self.secs)


def few_shot_finetune_incremental_test(
        backbone, head0: head_lib.Head, meta, opt,
        meta_sampler: EpisodeSampler, base_test_split,
        base_support_sampler: Optional[EpisodeSampler] = None,
        base_split_for_vocab=None, verbose: bool = True,
        device="cuda", draws=None, vis: bool = False):
    """Run the multi-session protocol (language_eval.py:71-454) on
    ``device``.  ``backbone`` and ``head0`` are copied, never mutated.
    ``draws`` defaults to ``TorchDraws(opt.set_seed, device)``.

    Returns an :class:`IncrementalResult`, or with ``vis=True`` the
    per-epoch session-0 prediction frames (reference
    language_eval.py:81-83, 345-349, 449-450; JAX incremental.py:1732-1737)
    as a dict of column lists ``idx, class, isbase, predicted, img`` (each
    ``img`` an ``<img>`` tag with a base64 PNG of the raw query), which
    ``pandas.DataFrame(...)`` takes as it is."""
    dev = resolve_device(device)
    prt = print if verbose else (lambda *a, **k: None)
    check_options(opt, head0.bias is not None, vis)
    run = SeedRun(backbone, head0, meta, opt, meta_sampler, base_test_split,
                  base_support_sampler, base_split_for_vocab, dev, draws,
                  prt, vis=vis)
    for idx in range(run.geo.max_sessions):
        run.run_session(idx)
    if run.live:
        run.write_tracking_csvs()
    if vis:
        return run.vis_rows
    return run.result()
