"""Supervised pretraining engine (reference train_supervised.py:38-268).

Counterpart of ``subspace_reg_tpu/engine/pretrain.py``.  One step:
augmentation on the device, the bf16 train-mode forward (the module path,
or with ``fused=True`` the fused stages 1-2 of models/fused_forward.py),
cross-entropy plus the optional label-pull penalty, backward, and a
``torch.optim`` SGD/Adam update whose learning rate follows the per-step
schedule.  Under ``torch.profiler`` these phases are the ranges
``srt.pretrain.augment``, ``.forward``, ``.backward`` and ``.optimizer``,
after ``srt.pretrain.gather`` in the device-data step (utils/spans.py).

On a CUDA card the module step without a mesh, a teacher or the label
pull replays its body, from the augmentation's application to
``optimizer.step()``, as one CUDA graph (``StepRunner``): the host then
draws and stages the step's inputs (``srt.pretrain.gather``,
``.augment``) and launches the graph (``srt.pretrain.replay``).

Where JAX and PyTorch differ in form:

* the JAX ``PretrainState`` is an immutable tree that each step returns
  anew; here the state holds the backbone module, the head parameters and
  the ``torch.optim`` optimizer, and a step updates them in place (the BN
  running statistics and block counters included);
* the JAX ``tx`` (an optax chain with the schedule inside) becomes the
  state's optimizer (``init_pretrain_state``) plus ``schedule`` here;
* the per-step random draws come from a draw provider (engine/draws.py)
  keyed by the step, as the JAX step folds the step into its key, so
  restoring the step restores them.

``checkpoint_parts`` and ``restore_pretrain_state`` carry the state through
the JAX package's ``.ckpt`` (utils/checkpoint.py) with its optimizer
state and step in ``extra``, as JAX ``train_supervised.py:112-136,325-355``
saves and resumes it.

Under a mesh (parallel/mesh.py, on ``torch.distributed``) each rank takes
its rows of the global batch and the step equals the single-device step
on the global batch: the augmentation and the dropout/DropBlock masks are
drawn for the global batch and sliced to the rank's rows, BatchNorm
and DropBlock reduce their batch statistics over the data ranks, the
classifier's rows are
split over the model ranks (logits gathered along the classes before the
loss), and the gradients are reduced to the global batch's mean.

The fused step under a mesh takes the global batch's statistics in its
fused blocks too: K2's epilogue sums are all-reduced over the data group
between the launches (ops/fused_block.py).

Distillation: ``make_train_step(teacher=...)`` adds the KD term
(``kd_alpha * CE + kd_beta * DistillKL``) on the module or the fused path,
the teacher running in eval mode without gradient on the rank's rows;
``init_nce_training`` and ``make_train_step_nce`` are the contrastive
(NCE/CRD) step with its two embed heads and memory banks (distill/nce.py).
Under a data mesh the contrastive step is the global batch's, as JAX's
GSPMD step is (JAX train_supervised.py:221-226): its draws are the global
batch's, Z is set from the global batch's mean, and every rank applies
the global batch's bank update, so the banks stay bit-identical across
the ranks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import weakref
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..data.transforms import AugmentSpec
from ..distill.criterion import DistillKL, nce_loss, nce_softmax_loss
from ..distill.embed import Embed, embed_from_jax, embed_to_jax
from ..distill.nce import (CONTRAST_MODES, NCEAverageState,
                           init_nce_average, nce_forward)
from ..models.fused_forward import can_fuse, fused_forward
from ..models.head import Head, torch_linear_init
from ..models.layers import TorchBatchNorm, cross_replica, uniform
from ..models.resnet import ResNetRFS
from ..ops import augment as aug_ops
from ..ops import conv_f32, losses
from ..ops.augment import AugmentDraws
from ..ops.bn_train import bn_train
from ..parallel import mesh as mesh_lib
from ..utils import optim
from ..utils.optim import Schedule, set_lr
from ..utils.spans import span
from ..weights import (from_jax_variables, optimizer_from_jax,
                       optimizer_to_jax, to_jax_variables)

Metrics = Dict[str, torch.Tensor]


@dataclass
class PretrainState:
    backbone: ResNetRFS
    head: Dict[str, torch.nn.Parameter]     # 'w' (n_cls, D), optional 'b'
    optimizer: torch.optim.Optimizer
    step: int = 0
    # the contrastive step's embed heads (init_nce_training)
    embed_s: Optional[Embed] = None
    embed_t: Optional[Embed] = None

    def embeds(self) -> Dict[str, Embed]:
        """``{"embed_s", "embed_t"}`` of a contrastive state, else {}."""
        if self.embed_s is None:
            return {}
        return {"embed_s": self.embed_s, "embed_t": self.embed_t}


def init_pretrain_state(backbone: ResNetRFS, n_cls: int,
                        tx: Callable[[list], torch.optim.Optimizer],
                        with_bias: bool,
                        generator: Optional[torch.Generator] = None,
                        device="cuda") -> PretrainState:
    """A ``torch.nn.Linear``-initialized head (drawn from ``generator``) on
    top of ``backbone``, moved to ``device``; ``tx(params)`` builds the
    optimizer over the backbone's parameters and the head's."""
    backbone.to(device)
    w, b = torch_linear_init(n_cls, backbone.feature_dim, with_bias,
                             generator, device="cpu")
    head = {"w": torch.nn.Parameter(w.to(device))}
    if with_bias:
        head["b"] = torch.nn.Parameter(b.to(device))
    optimizer = tx(list(backbone.parameters()) + list(head.values()))
    return PretrainState(backbone=backbone, head=head, optimizer=optimizer)


def checkpoint_parts(state: PretrainState,
                     nce_state: Optional[NCEAverageState] = None):
    """(variables, head, extra) of ``state`` for ``utils.checkpoint.
    save_checkpoint``: the JAX-form backbone tree, the head with every row
    active, and ``{"opt_state", "step"}`` in the JAX state's form; a
    contrastive run adds ``embed_s``, ``embed_t`` (flax trees) and
    ``nce`` (the banks' state dict), as JAX train_supervised.py:345-352
    saves them."""
    w = state.head["w"].detach()
    b = state.head.get("b")
    head = Head(weight=w, bias=None if b is None else b.detach(),
                n_active=w.shape[0])
    extra = {"opt_state": optimizer_to_jax(state.optimizer, state.backbone,
                                           state.head, state.step,
                                           state.embeds()),
             "step": np.asarray(state.step, np.int32)}
    if nce_state is not None:
        extra.update({k: embed_to_jax(m) for k, m in state.embeds().items()})
        extra["nce"] = nce_state.to_jax()
    return to_jax_variables(state.backbone.state_dict()), head, extra


def restore_pretrain_state(state: PretrainState, variables, head: Head,
                           meta, optimizer: bool = True) -> int:
    """Resume ``state`` in place from a loaded ``.ckpt`` (``utils.
    checkpoint.load_checkpoint``: numpy leaves) as JAX
    ``train_supervised.py:112-136`` does: parameters, BN statistics,
    counters (kept when the checkpoint has none), the head's first
    ``n_cls`` rows, and the optimizer state and step from
    ``meta["extra"]`` when present and ``optimizer`` (a contrastive run
    restores those with its embed heads: ``restore_contrastive``).
    Returns the epoch to start at, ``meta["epoch"] + 1``."""
    sd = dict(state.backbone.state_dict())
    sd.update(from_jax_variables(variables))
    state.backbone.load_state_dict(sd)
    with torch.no_grad():
        for k, t in (("w", head.weight), ("b", head.bias)):
            if k in state.head:
                p = state.head[k]
                p.copy_(torch.from_numpy(np.array(t[:p.shape[0]])))
    extra = meta.get("extra")
    if extra is not None and optimizer:
        _restore_optimizer(state, extra)
    return int(meta.get("epoch", 0)) + 1


def _restore_optimizer(state: PretrainState, extra) -> None:
    count = optimizer_from_jax(state.optimizer, state.backbone, state.head,
                               extra["opt_state"], state.embeds())
    state.step = int(np.asarray(extra["step"]))
    if count != state.step:
        raise ValueError(f"the optimizer state counts {count} steps, "
                         f"the checkpoint {state.step}")


def restore_contrastive(state: PretrainState, meta, device
                        ) -> Optional[NCEAverageState]:
    """The second-phase resume of a contrastive run (JAX
    train_supervised.py:193-220), after ``init_nce_training``: the
    optimizer state, step and embed heads in place, and the memory banks
    returned; None (nothing restored) when the checkpoint has no
    contrastive state."""
    extra = meta.get("extra") or {}
    if "nce" not in extra or "embed_s" not in extra:
        return None
    for name, module in state.embeds().items():
        embed_from_jax(module, extra[name])
    _restore_optimizer(state, extra)
    return NCEAverageState.from_jax(extra["nce"], device)


def make_schedule(opt, steps_per_epoch: int):
    """The learning-rate schedule of ``opt`` (train_supervised.py:95-101):
    cosine, or step decay at ``lr_decay_epochs_list``."""
    if opt.cosine:
        return optim.cosine_schedule(
            opt.learning_rate, opt.lr_decay_rate, opt.epochs,
            steps_per_epoch)
    return optim.step_decay_schedule(
        opt.learning_rate, opt.lr_decay_epochs_list, opt.lr_decay_rate,
        steps_per_epoch)


def make_tx(opt):
    """``params -> torch.optim`` optimizer of ``opt``
    (train_supervised.py:102-106): Adam with the JAX package's weight
    decay, or SGD with momentum."""
    if opt.adam:
        return functools.partial(optim.adam_torch,
                                 learning_rate=opt.learning_rate,
                                 weight_decay=optim.ADAM_WEIGHT_DECAY)
    return functools.partial(optim.sgd_torch,
                             learning_rate=opt.learning_rate,
                             momentum=opt.momentum,
                             weight_decay=opt.weight_decay)


def _logits(state: PretrainState, feats: torch.Tensor,
            with_bias: bool) -> torch.Tensor:
    logits = feats @ state.head["w"].T
    if with_bias:
        logits = logits + state.head["b"]
    return logits


def _rows_of_draws(d: AugmentDraws, rows: slice) -> AugmentDraws:
    return AugmentDraws(offsets=d.offsets[rows], flip=d.flip[rows],
                        jitter_factors=d.jitter_factors[rows],
                        jitter_order=d.jitter_order[rows])


def teacher_features(teacher, x: torch.Tensor) -> torch.Tensor:
    """The teacher's eval-mode features of ``x`` (NCHW), without
    gradient: its BN running statistics and block counters stay as they
    were (JAX ``apply(..., train=False)`` under ``stop_gradient``)."""
    module = teacher[0]
    module.eval()
    with torch.no_grad():
        return module(x)


def _global_draws(mesh, s, n_local, draw):
    """(augmentation, dropout generator, rest...) of step ``s`` for this
    rank's ``n_local`` rows: ``draw(s, n)``'s draws of the global batch
    sliced to the rank's rows under a data mesh (the dropout generator
    becomes a draw callable, ``mesh_lib.rows_of``; any further tensor is
    sliced along its rows)."""
    n_data = 1 if mesh is None else mesh.n_data
    if n_data == 1:
        return draw(s, n_local)
    n_global = n_local * n_data
    rows = mesh_lib.batch_sharding(mesh, n_global)
    aug, gen, *rest = draw(s, n_global)
    return (_rows_of_draws(aug, rows),
            mesh_lib.rows_of(gen, n_global, rows),
            *(t[rows] for t in rest))


def recording(generator, shapes: List[tuple]):
    """``generator`` (a dropout draw, ``models.layers.uniform``) in its
    callable form, the same numbers, noting each draw's shape in
    ``shapes``."""
    def draw(shape, device):
        shapes.append(tuple(shape))
        return uniform(shape, generator, device)
    return draw


class DrawnAhead:
    """A train-mode forward's dropout and DropBlock uniforms, drawn before
    the forward in its order and shapes into buffers that keep their
    addresses, and handed to it in turn through the callable form of a
    dropout draw (``models.layers.uniform``): the numbers the forward
    would draw from the same generator, bit for bit."""

    def __init__(self, shapes, device):
        self.buffers = [torch.empty(s, dtype=torch.float32, device=device)
                        for s in shapes]
        self._next = 0

    def draw(self, generator) -> "DrawnAhead":
        """Fill the buffers from ``generator`` (a ``torch.Generator``,
        None or a draw callable) as the forward draws from it."""
        for buf in self.buffers:
            if callable(generator):
                buf.copy_(generator(tuple(buf.shape), buf.device))
            else:
                torch.rand(buf.shape, generator=generator, out=buf)
        self._next = 0
        return self

    def __call__(self, shape, device) -> torch.Tensor:
        i = self._next
        if i == len(self.buffers) or tuple(shape) != self.buffers[i].shape:
            raise ValueError(f"draw {i} of the forward has shape "
                             f"{tuple(shape)}; drawn ahead: "
                             f"{[tuple(b.shape) for b in self.buffers]}")
        self._next += 1
        return self.buffers[i]

    def spent(self) -> bool:
        return self._next == len(self.buffers)


# the Python counters of the work a step's body launches: a replay of the
# step's CUDA graph adds what its capture counted
BODY_COUNTERS = ((bn_train, "launches"), (conv_f32.conv_f32, "launches"),
                 (TorchBatchNorm, "train_forwards"),
                 (TorchBatchNorm, "kernel_forwards"))

# one memory pool a card for the graphs of every runner on it (the lanes of
# the multi-seed step replay one at a time, so their activations share it),
# with the graphs that hold it: the allocator takes a pool again only while
# a graph holds it, so a card whose graphs are all gone gets a new one
_graph_pools: Dict[torch.device, tuple] = {}


def _graph_pool(dev) -> tuple:
    """(the pool's token, the set of the graphs that hold it) of ``dev``."""
    gc.collect()        # a graph in a cycle lets go of its pool here
    pool = _graph_pools.get(dev)
    if pool is None or not pool[1]:
        with torch.cuda.device(dev):
            pool = _graph_pools[dev] = (torch.cuda.graph_pool_handle(),
                                        weakref.WeakSet())
    return pool


def _tensors(draws: AugmentDraws) -> List[torch.Tensor]:
    return [getattr(draws, f.name) for f in dataclasses.fields(draws)]


@contextlib.contextmanager
def _side_stream(dev):
    """Work on a new stream of ``dev`` that starts after the current
    stream's work and that the current stream waits for."""
    side = torch.cuda.Stream(dev)
    current = torch.cuda.current_stream(dev)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        yield
    current.wait_stream(side)


class StepRunner:
    """Runs a pretraining step's body, from the augmentation's application
    to ``optimizer.step()``, each step: eagerly, or replayed as one CUDA
    graph where the step allows it.

    A step allows it (``capturable``, and ``engages`` at each step) where
    it is the module step without a mesh, a teacher or the label pull, its
    state is on a CUDA card and its optimizer is ``torch.optim.SGD``, whose
    step takes the learning rate as a number (DropBlock's gamma follows
    the blocks' counters on the device, which the graph advances).  There
    the host stages the step's inputs into buffers that keep their
    addresses: the batch and its labels, the augmentation's draws, and the
    dropout's and DropBlock's uniforms drawn ahead from the step's
    generator (``DrawnAhead``); then it replays the graph and returns a
    copy of its loss and accuracies, which the next replay overwrites.

    The first step on a set of parameters, buffers and input shapes runs
    eagerly, on a side stream: it creates the optimizer's state, builds K5
    and cuDNN's plans and notes the forward's draws.  The next step is
    captured (capture records the step and runs nothing) and replayed at
    once.  The graph bakes the learning rate and every other setting of
    the optimizer, as SGD's step does with a number, and the addresses of
    the parameters, buffers and optimizer state: a change in any of them
    captures anew, so a step-decay schedule captures once a decay, a
    cosine one once an epoch.  A capture that fails raises.  The graphs of
    one card share a memory pool.

    The Python counters of the body's work (``BODY_COUNTERS``) count what
    runs on the device: a capture takes back what its Python counted, and
    each replay adds it.  ``graph_steps`` counts every step of every
    runner, ``graph_replays`` the steps that ran as a replay (a captured
    step's among them)."""

    graph_steps = 0
    graph_replays = 0

    def __init__(self, body, backbone, capturable: bool):
        self.body = body
        self.capturable = capturable
        # the modules that hold the backbone's buffers
        self._owners = [m for m in backbone.modules() if m._buffers]
        self._warm = None     # what the last eager step ran on
        self._key = None      # what the graph was captured on
        self._graph = None
        self._shapes: List[tuple] = []
        self._counts = [0] * len(BODY_COUNTERS)   # a replay's

    def engages(self, state: PretrainState) -> bool:
        return (self.capturable and state.head["w"].is_cuda
                and isinstance(state.optimizer, torch.optim.SGD))

    def warm_key(self, state: PretrainState, inputs: tuple) -> tuple:
        """What a step's eager warm-up ran on: ``inputs`` (the shapes and
        types of the batch and its labels) and the addresses and shapes of
        the parameters and of the backbone's buffers."""
        tensors = ([p for g in state.optimizer.param_groups
                    for p in g["params"]]
                   + [b for m in self._owners for b in m._buffers.values()
                      if b is not None])
        return (inputs, tuple(map(torch.Tensor.data_ptr, tensors)),
                tuple(t.shape for t in tensors))

    @staticmethod
    def capture_key(state: PretrainState, warm: tuple) -> tuple:
        """What a graph bakes in: ``warm`` with the addresses of the
        optimizer's state and its settings, the learning rate among
        them."""
        opt = state.optimizer
        opt_state = tuple(map(torch.Tensor.data_ptr, [
            v for st in opt.state.values() for v in st.values()
            if isinstance(v, torch.Tensor)]))
        settings = tuple(tuple(sorted((k, v) for k, v in g.items()
                                      if k != "params"))
                         for g in opt.param_groups)
        return warm, opt_state, settings

    def __call__(self, state: PretrainState, x_u8: torch.Tensor,
                 y: torch.Tensor, draw) -> Metrics:
        """The step's metrics.  ``draw()`` sets the step's learning rate
        and returns its draws (augmentation, dropout generator)."""
        StepRunner.graph_steps += 1
        if not self.engages(state):
            return self.body(state, x_u8, y, draw)
        warm = self.warm_key(state, ((x_u8.shape, x_u8.dtype),
                                     (y.shape, y.dtype)))
        if warm != self._warm:
            self._graph = self._key = None
            m = self._eager(state, x_u8, y, draw)
            self._warm = warm
            return m
        with span("srt.pretrain.augment"):
            aug, gen = draw()
            key = self.capture_key(state, warm)
            if key != self._key:
                self._graph = None
                self._buffers(state, x_u8, y, aug)
            for dst, src in zip([self._x, self._y] + _tensors(self._aug),
                                [x_u8, y] + _tensors(aug)):
                dst.copy_(src)
            self._drawn.draw(gen)
        if self._graph is None:
            self._capture(state)
            self._key = key
        with span("srt.pretrain.replay"):
            self._graph.replay()
        StepRunner.graph_replays += 1
        for (owner, name), n in zip(BODY_COUNTERS, self._counts):
            setattr(owner, name, getattr(owner, name) + n)
        loss, acc1, acc5 = self._out.clone()
        return {"loss": loss, "acc1": acc1, "acc5": acc5}

    def _eager(self, state, x_u8, y, draw) -> Metrics:
        dev = state.head["w"].device
        shapes: List[tuple] = []

        def recorded():
            aug, gen = draw()
            return aug, recording(gen, shapes)

        with _side_stream(dev):
            m = self.body(state, x_u8, y, recorded)
        self._shapes = shapes
        return m

    def _buffers(self, state, x_u8, y, aug) -> None:
        dev = state.head["w"].device
        self._x, self._y = (torch.empty(t.shape, dtype=t.dtype, device=dev)
                            for t in (x_u8, y))
        self._aug = AugmentDraws(*(
            torch.empty(t.shape, dtype=t.dtype, device=dev)
            for t in _tensors(aug)))
        self._drawn = DrawnAhead(self._shapes, dev)

    def _capture(self, state) -> None:
        dev = state.head["w"].device
        graph = torch.cuda.CUDAGraph()
        before = [getattr(owner, name) for owner, name in BODY_COUNTERS]
        # a capture stream on the state's card (a lane of the multi-seed
        # step may be on another than the current one); other threads, as
        # the streamed loader's, keep their copies going meanwhile
        stream = torch.cuda.Stream(dev)
        pool, holders = _graph_pool(dev)
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            m = self.body(state, self._x, self._y,
                          lambda: (self._aug, self._drawn))
            self._out = torch.stack([m["loss"], m["acc1"], m["acc5"]])
        holders.add(graph)
        # the capture ran nothing: its replays count the body's work
        self._counts = []
        for (owner, name), n in zip(BODY_COUNTERS, before):
            self._counts.append(getattr(owner, name) - n)
            setattr(owner, name, n)
        if not self._drawn.spent():
            raise ValueError("the captured forward drew fewer uniforms "
                             "than the eager one")
        self._graph = graph


def make_train_step(backbone: ResNetRFS, schedule: Optional[Schedule],
                    spec: AugmentSpec, with_bias: bool, draws,
                    label_pull: Optional[float] = None,
                    pull_embeds: Optional[torch.Tensor] = None,
                    temperature: float = 1.0, mesh=None, teacher=None,
                    kd_temperature: float = 4.0, kd_alpha: float = 1.0,
                    kd_beta: float = 1.0,
                    fused: bool = False, fused_backend: str = "xla"):
    """One pretraining step: augment -> forward (train) -> CE (+ pull) ->
    backward -> optimizer step (reference hot loop
    train_supervised.py:216-244).

    ``train_step(state, x_u8, y)`` takes a (B, H, W, 3) uint8 batch and
    (B,) labels on the state's device and returns {"loss", "acc1", "acc5"}
    as 0-d device tensors.  ``schedule(step)`` sets the learning rate of
    each step.  ``draws`` provides ``pretrain_augment(step, n, spec)`` and
    ``pretrain_dropout(step)``.  ``fused=True`` runs stages 1-2 through the
    fused block with ``fused_backend``: ``"pallas"`` launches the
    hand-written CUDA kernels K2/K3 (their plain versions on CPU tensors),
    ``"xla"`` runs the same program as torch ops.  ``train_step.runner``
    (``StepRunner``) runs the body, as a CUDA graph where the step allows
    it.

    With ``mesh`` (parallel/mesh.py) ``x_u8`` and ``y`` are this rank's
    rows of the global batch (``mesh_lib.shard_batch``) and the metrics
    are the global batch's.

    ``teacher=(module, head_w, head_b)`` adds knowledge distillation:
    loss = kd_alpha * CE + kd_beta * DistillKL(student, teacher,
    kd_temperature), the teacher's logits from ``teacher_features`` on the
    same augmented batch (JAX engine/pretrain.py:106-115); the student
    takes the module or the fused path as without a teacher.  The teacher
    must have the student's class count.  Under a mesh the teacher runs on
    the rank's rows and the KD term, a mean over them, joins the CE's
    gradient all-reduce as it is."""
    n_data = 1 if mesh is None else mesh.n_data
    sync = None if mesh is None or mesh.n_data == 1 else mesh.data_group

    def body(state: PretrainState, x_u8: torch.Tensor, y: torch.Tensor,
             draw) -> Metrics:
        with span("srt.pretrain.augment"):
            aug, gen = draw()
            x = aug_ops.augment_batch(x_u8, spec, aug)
            # NHWC in memory is an NCHW tensor in channels_last
            x = x.permute(0, 3, 1, 2)
        with span("srt.pretrain.forward"):
            backbone.train()
            if fused and not can_fuse(backbone, x.shape[2], True):
                raise ValueError("fused=True needs a bf16 backbone with "
                                 "single-block stages 1/2, no SE and a size "
                                 "divisible by 4")
            with cross_replica(backbone, sync):
                feats = (fused_forward(backbone, x, gen, backend=fused_backend,
                                       group=sync) if fused
                         else backbone(x, generator=gen))
            n_model = 1 if mesh is None else mesh.n_model
            if n_model == 1:
                logits = _logits(state, feats, with_bias)
            else:
                n_cls = state.head["w"].shape[0]
                cls = mesh_lib.head_sharding(mesh, n_cls)
                local = feats @ state.head["w"][cls].T
                if with_bias:
                    local = local + state.head["b"][cls]
                logits = mesh_lib.gather_classes(mesh, local, n_cls)
            ce = losses.cross_entropy(logits, y)
            loss = ce
            if teacher is not None:
                _, t_w, t_b = teacher
                t_logits = teacher_features(teacher, x) @ t_w.T
                if t_b is not None:
                    t_logits = t_logits + t_b
                if t_logits.shape[1] != logits.shape[1]:
                    raise ValueError(
                        f"the KD teacher has {t_logits.shape[1]} classes, the "
                        f"student {logits.shape[1]}")
                loss = kd_alpha * ce + kd_beta * DistillKL(logits, t_logits,
                                                           kd_temperature)
            data_loss, penalty = loss, None
            if label_pull is not None:
                # pretraining pull penalty (train_supervised.py:231-235):
                # attractors computed from the classifier itself
                w = state.head["w"]
                scores = pull_embeds @ pull_embeds.T
                probs = torch.softmax(scores / temperature, dim=1)
                penalty = label_pull * torch.sum(torch.square(probs @ w - w))
                # every model rank adds it; the reduced gradient counts it once
                loss = loss + (penalty if n_model == 1 else penalty / n_model)
            acc1, acc5 = losses.accuracy_topk(logits.detach(), y)
        with span("srt.pretrain.backward"):
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if mesh is not None:
                mesh_lib.reduce_gradients(
                    mesh, [p for g in state.optimizer.param_groups
                           for p in g["params"]])
        with span("srt.pretrain.optimizer"):
            state.optimizer.step()
        if mesh is not None and n_data > 1:
            data_loss, acc1, acc5 = mesh_lib.mean_over_data(
                mesh, torch.stack([data_loss.detach(), acc1, acc5]))
            loss = data_loss if penalty is None else data_loss + penalty
        return {"loss": loss.detach(), "acc1": acc1, "acc5": acc5}

    runner = StepRunner(body, backbone, capturable=(
        mesh is None and not fused and teacher is None
        and label_pull is None))

    def train_step(state: PretrainState, x_u8: torch.Tensor,
                   y: torch.Tensor) -> Metrics:
        s = state.step

        def draw():
            if schedule is not None:
                set_lr(state.optimizer, schedule(s))
            # the global batch's draws, this rank's rows
            return _global_draws(
                mesh, s, x_u8.shape[0],
                lambda s, n: (draws.pretrain_augment(s, n, spec),
                              draws.pretrain_dropout(s)))

        m = runner(state, x_u8, y, draw)
        state.step += 1
        return m

    train_step.runner = runner
    return train_step


def make_train_step_device_data(backbone: ResNetRFS,
                                schedule: Optional[Schedule],
                                spec: AugmentSpec, with_bias: bool, draws,
                                mesh=None, **kw):
    """Device-resident dataset: the whole uint8 image store and the labels
    live on the card and each step gathers its batch there from an index
    vector, so no image crosses from the host per step.  Under ``mesh``
    every rank keeps the whole store and ``idxs`` is the global batch's
    index vector: each rank gathers only its shard of it."""
    base = make_train_step(backbone, schedule, spec, with_bias, draws,
                           mesh=mesh, **kw)

    def train_step(state: PretrainState, data_u8: torch.Tensor,
                   labels: torch.Tensor, idxs: torch.Tensor) -> Metrics:
        with span("srt.pretrain.gather"):
            if mesh is not None:
                idxs = mesh_lib.shard_batch(mesh, idxs)
            x_u8, y = data_u8[idxs], labels[idxs]
        return base(state, x_u8, y)

    return train_step


def init_nce_training(generator: Optional[torch.Generator],
                      state: PretrainState, tx, teacher_feat_dim: int,
                      student_feat_dim: int, feat_dim: int, n_data: int,
                      nce_k: int, nce_t: float, nce_m: float, device=None):
    """Extend ``state`` for contrastive (NCE/CRD) distillation (JAX
    engine/pretrain.py:172-195): two ``Embed(feat_dim)`` heads, student
    and teacher, drawn from ``generator``, join the state, and the
    optimizer ``tx(params)`` is rebuilt over the parameters in the JAX
    tree's order (backbone, embed_s, embed_t, head); the memory banks of
    ``n_data`` rows are drawn after them.  Returns (state, embed_s,
    embed_t, NCEAverageState)."""
    if device is None:
        device = state.head["w"].device
    # the heads are drawn on the host from a host generator
    embed_s = Embed(student_feat_dim, feat_dim, generator).to(device)
    embed_t = Embed(teacher_feat_dim, feat_dim, generator).to(device)
    params = (list(state.backbone.parameters())
              + list(embed_s.parameters()) + list(embed_t.parameters())
              + list(state.head.values()))
    state.embed_s, state.embed_t = embed_s, embed_t
    state.optimizer = tx(params)
    nce_state = init_nce_average(generator, n_data, feat_dim, nce_k,
                                 temperature=nce_t, momentum=nce_m,
                                 device=device)
    return state, embed_s, embed_t, nce_state


def build_negative_table(labels: np.ndarray, n_cls: int):
    """Class-sorted complement-sampling structure for the cls_negative
    contract (reference dataset/mini_imagenet.py:154-160; JAX
    engine/pretrain.py:328): uniform negatives from every other class in
    O(n_data) memory.  Returns int32 (order, class_off, class_cnt):
    ``order`` is the stable class-sorted permutation of dataset indices;
    a sample of class c draws a position in [0, n_data - cnt[c]), shifts
    it past the class block at ``off[c]`` and maps it through ``order``."""
    labels = np.asarray(labels)
    order = np.argsort(labels, kind="stable").astype(np.int32)
    cnt = np.bincount(labels, minlength=n_cls).astype(np.int32)
    off = np.concatenate([[0], np.cumsum(cnt)[:-1]]).astype(np.int32)
    return order, off, cnt


def draw_negatives(neg_table, y: torch.Tensor, u: torch.Tensor,
                   n_data: int) -> torch.Tensor:
    """(B, nce_k) dataset indices, each uniform over the other classes'
    items, from the (B, nce_k) uniforms ``u`` and the negative table
    (tensors on ``u``'s device) by the complement trick of JAX
    engine/pretrain.py:282-292."""
    order, class_off, class_cnt = neg_table
    cnt = class_cnt[y][:, None]
    off = class_off[y][:, None]
    pos = torch.minimum((u * (n_data - cnt)).to(torch.int32),
                        n_data - cnt - 1)
    pos = torch.where(pos >= off, pos + cnt, pos)
    return order[pos.long()]


def make_train_step_nce(backbone: ResNetRFS, schedule: Optional[Schedule],
                        spec: AugmentSpec, with_bias: bool, draws, teacher,
                        embed_s: Embed, embed_t: Embed, n_data: int,
                        nce_k: int, kd_alpha: float = 1.0,
                        kd_beta: float = 1.0, mode: str = "nce",
                        contrast_mode: str = "auto", mesh=None):
    """The contrastive-distillation step (JAX engine/pretrain.py:198-325):
    augment (the draw provider's ``pretrain_contrastive``: augmentation,
    dropout and the negatives' uniforms, the JAX step's three-way split)
    -> student forward (train) -> CE; teacher forward (eval, no
    gradient); ``embed_s``/``embed_t`` of the two features; negatives by
    the complement trick, ``idx[:, 0]`` the item itself; the contrast
    against both memory banks and their update; loss = kd_alpha * CE +
    kd_beta * (NCE_l + NCE_ab), or with ``mode="crd"`` the InfoNCE
    softmax criterion on log(out); backward; optimizer step.

    ``train_step(state, nce_state, x_u8, y, items, neg_table)`` takes a
    uint8 batch, its labels and dataset items and the negative table
    (``build_negative_table`` as tensors on the device); it updates
    ``state`` in place and returns (new NCEAverageState, metrics {"loss",
    "ce", "contrast", "acc1", "acc5"}).  ``train_step.device_data(state,
    nce_state, data_u8, labels, neg_table, idxs)`` gathers the batch
    from a device-resident store.  ``contrast_mode`` is the contrast's
    form, one of ``distill.nce.CONTRAST_MODES``.

    Under a data ``mesh`` (parallel/mesh.py; no class split) ``x_u8``,
    ``y`` and ``items`` are this rank's rows of the global batch (and
    ``device_data`` takes the global batch's index vector), the draws
    are the global batch's sliced to the rank's rows, BN takes the global
    batch's statistics, Z is set from the global batch's mean, the
    criteria are means over the rank's rows that the gradient all-reduce
    averages into the global batch's, and every rank applies the global
    batch's bank update (``nce_forward``'s ``group``); the metrics are
    the global batch's."""
    n_ranks = 1 if mesh is None else mesh.n_data
    sync = None if n_ranks == 1 else mesh.data_group
    if mesh is not None and mesh.n_model > 1:
        raise ValueError("the contrastive step splits no classifier: its "
                         "mesh has one model rank")
    if contrast_mode not in CONTRAST_MODES:
        raise ValueError(f"unknown NCE contrast mode {contrast_mode!r}; "
                         f"expected one of {CONTRAST_MODES}")

    def train_step(state: PretrainState, nce_state: NCEAverageState,
                   x_u8: torch.Tensor, y: torch.Tensor, items: torch.Tensor,
                   neg_table):
        s = state.step
        if schedule is not None:
            set_lr(state.optimizer, schedule(s))
        aug, gen, u = _global_draws(
            mesh, s, x_u8.shape[0],
            lambda s, n: draws.pretrain_contrastive(s, n, spec, nce_k))
        x = aug_ops.augment_batch(x_u8, spec, aug).permute(0, 3, 1, 2)
        backbone.train()
        with cross_replica(backbone, sync):
            feat_s = backbone(x, generator=gen)
        logits = _logits(state, feat_s, with_bias)
        ce = losses.cross_entropy(logits, y)
        feat_t = teacher_features(teacher, x)
        l = embed_s(feat_s.float())
        ab = embed_t(feat_t.float())
        items = items.long()
        idx = torch.cat([items[:, None],
                         draw_negatives(neg_table, y.long(), u, n_data)],
                        dim=1)
        out_l, out_ab, nce_state = nce_forward(nce_state, l, ab, items,
                                               idx=idx, mode=contrast_mode,
                                               group=sync)
        if mode == "crd":
            log = lambda o: torch.log(torch.clamp_min(o, 1e-20))  # noqa
            contrast = (nce_softmax_loss(log(out_l))
                        + nce_softmax_loss(log(out_ab)))
        else:
            contrast = nce_loss(out_l, n_data) + nce_loss(out_ab, n_data)
        loss = kd_alpha * ce + kd_beta * contrast
        acc1, acc5 = losses.accuracy_topk(logits.detach(), y)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is not None:
            mesh_lib.reduce_gradients(
                mesh, [p for g in state.optimizer.param_groups
                       for p in g["params"]])
        state.optimizer.step()
        state.step += 1
        ce, contrast = ce.detach(), contrast.detach()
        if n_ranks > 1:
            ce, contrast, acc1, acc5 = mesh_lib.mean_over_data(
                mesh, torch.stack([ce, contrast, acc1, acc5]))
        return nce_state, {"loss": kd_alpha * ce + kd_beta * contrast,
                           "ce": ce, "contrast": contrast, "acc1": acc1,
                           "acc5": acc5}

    def device_data(state, nce_state, data_u8, labels, neg_table, idxs):
        if mesh is not None:
            idxs = mesh_lib.shard_batch(mesh, idxs)
        return train_step(state, nce_state, data_u8[idxs], labels[idxs],
                          idxs, neg_table)

    train_step.device_data = device_data
    return train_step


def make_eval_step(backbone: ResNetRFS, spec: AugmentSpec, with_bias: bool,
                   truncate_classes: Optional[int] = None,
                   faithful_nbt: bool = False):
    """Validation step (reference eval/util.py:185-232).
    ``truncate_classes`` reproduces the tiered augment_pretrain_wtrainb
    slice (:206-208).  ``faithful_nbt`` replicates the reference's
    per-forward ``num_batches_tracked`` increment on eval forwards too
    (models/resnet_language.py:269), in place on the blocks."""

    @torch.no_grad()
    def eval_step(state: PretrainState, x_u8: torch.Tensor,
                  y: torch.Tensor) -> Metrics:
        x = aug_ops.normalize_batch(x_u8, spec).permute(0, 3, 1, 2)
        backbone.eval()
        feats = backbone(x)
        if faithful_nbt:
            for block in backbone.blocks():
                block.num_batches_tracked += 1
        logits = _logits(state, feats, with_bias)
        if truncate_classes is not None:
            logits = logits[:, :truncate_classes]
        loss = losses.cross_entropy(logits, y)
        acc1, acc5 = losses.accuracy_topk(logits, y)
        return {"loss": loss, "acc1": acc1, "acc5": acc5,
                "n": torch.tensor(float(y.shape[0]), device=loss.device)}

    eval_step.faithful_nbt = faithful_nbt
    return eval_step


def epoch_batches(rng: np.random.RandomState, n: int, batch_size: int,
                  drop_last: bool = True) -> Iterator[np.ndarray]:
    """Shuffled epoch batching (DataLoader shuffle=True, drop_last=True,
    train_supervised.py:50-51)."""
    order = rng.permutation(n)
    end = (n // batch_size) * batch_size if drop_last else n
    for i in range(0, end, batch_size):
        yield order[i:i + batch_size]


def run_validation(eval_step, state: PretrainState, imgs, labels,
                   batch_size: int, device=None):
    """Sample-weighted mean loss / acc1 / acc5 over ``imgs`` (uint8 NHWC,
    numpy or a device tensor) in batches; one host transfer at the end.
    With a ``faithful_nbt`` eval step, returns ``(metrics, state)`` as the
    JAX function does (the counters advance in place)."""
    if device is None:
        device = state.head["w"].device
    tot = torch.zeros(4, dtype=torch.float64, device=device)
    for i in range(0, len(labels), batch_size):
        x = torch.as_tensor(imgs[i:i + batch_size], device=device)
        y = torch.as_tensor(labels[i:i + batch_size], dtype=torch.int64,
                            device=device)
        m = eval_step(state, x, y)
        tot += torch.stack([m["loss"] * m["n"], m["acc1"] * m["n"],
                            m["acc5"] * m["n"], m["n"]]).to(torch.float64)
    loss, acc1, acc5, n = tot.tolist()
    n = max(n, 1.0)
    metrics = {"loss": loss / n, "acc1": acc1 / n, "acc5": acc5 / n}
    if getattr(eval_step, "faithful_nbt", False):
        return metrics, state
    return metrics
