"""The port's spans and row counters (subspace_reg_tpu_torch/utils/spans.py,
engine/incremental.py, engine/pretrain.py) on the CPU, at the engine tests'
tiny shapes (16 px, widths 8-16-24-80, 8 sessions, 20 epochs at most):

  * with no profiler ``span()`` is one shared no-op context, cheap to ask;
  * under ``torch.profiler`` an 8-session run, single-seed and multi-seed,
    shows the closed set of ``srt.eval.*`` and ``srt.data.sampler`` ranges
    with their documented nesting and order, and a pretraining step its
    phases once each, in order;
  * ``SessionProgram.rows_forwarded`` and ``rows_padded`` equal the closed
    form of the geometry, and ``session_seconds`` has one positive entry a
    session;
  * no range name holds a substring that a reader of device records
    matches on.
"""

import functools
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from subspace_reg_tpu_torch.data.episodes import EpisodeSampler
from subspace_reg_tpu_torch.data.mini_imagenet import SplitData
from subspace_reg_tpu_torch.data.transforms import transforms_options
from subspace_reg_tpu_torch.engine import pretrain as pt
from subspace_reg_tpu_torch.engine.draws import TorchDraws
from subspace_reg_tpu_torch.engine.incremental import (
    SessionProgram, few_shot_finetune_incremental_test)
from subspace_reg_tpu_torch.engine.multiseed import (
    few_shot_finetune_multiseed)
from subspace_reg_tpu_torch.models.head import Head
from subspace_reg_tpu_torch.models.resnet import ResNetRFS
from subspace_reg_tpu_torch.utils import optim
from subspace_reg_tpu_torch.utils.spans import span

WIDTHS = (8, 16, 24, 80)
IMG = 16
N_BASE, N_NOVEL, PER_NOVEL = 60, 40, 12
SESSIONS = 8
# what the benchmark's device readers match on (benchmark/metrics/*.py,
# benchmark/harness.py::Trace.kernels)
DEVICE_MARKS = ("conv", "xmma", "fft", "pointwise_mult_and_sum_complex",
                "region_transform", "finetune_loop", "Memcpy", "Memset")
SESSION_SPANS = ("srt.eval.begin", "srt.eval.epoch1", "srt.eval.caches",
                 "srt.eval.k1", "srt.eval.evaluate", "srt.eval.finish")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one CPU thread for this module: the tier-1 lane runs six
    test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Opt:
    model = "resnet12"
    dataset = "miniImageNet"
    transform = "A"
    continual = True
    set_seed = 3
    n_ways = 5
    n_shots = 5
    n_queries = 4
    n_test_runs = 10
    eval_mode = "few-shot-incremental-fine-tune"
    n_aug_support_samples = 5
    n_base_aug_support_samples = 0
    n_base_support_samples = 1
    test_base_batch_size = 200
    neval_episodes = SESSIONS
    memory_replay = 1
    lmbd_reg_transform_w = 0.2
    lmbd_reg_novel = 0.1
    label_pull = 1.0
    pulling = "regularize"
    attraction_override = "distance2subspace"
    target_train_loss = 0.0
    stable_epochs = 3
    convergence_epsilon = 1e-2
    min_novel_epochs = 5
    max_novel_epochs = 20
    learning_rate = 0.01
    weight_decay = 5e-3
    momentum = 0.9
    adam = False
    freeze_backbone_at = 1
    no_dropblock = True
    use_episodes = False
    verbose = False


def _opt(seed):
    opt = Opt()
    opt.set_seed = seed
    return opt


def _split(rng, labels, names):
    imgs = rng.randint(0, 256, (len(labels), IMG, IMG, 3), dtype=np.uint8)
    return SplitData(imgs=imgs, labels=[int(l) for l in labels],
                     cat2label={}, label2human=names)


@pytest.fixture(scope="module")
def splits():
    rng = np.random.RandomState(0)
    base_names = [f"base {i}" for i in range(N_BASE)]
    base_test = _split(rng, np.arange(400) % N_BASE, base_names)
    base_train = _split(rng, np.arange(3 * N_BASE) % N_BASE, base_names)
    novel = _split(rng, N_BASE + np.repeat(np.arange(N_NOVEL), PER_NOVEL),
                   [""] * N_BASE + [f"novel {i}" for i in range(N_NOVEL)])
    return base_test, base_train, novel


def _model(seed):
    torch.manual_seed(seed)
    bb = ResNetRFS(n_blocks=(1, 1, 1, 1), drop_rate=0.1, no_dropblock=True,
                   avg_pool=True, widths=WIDTHS)
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((N_BASE + N_NOVEL, WIDTHS[-1]), generator=g) * 0.1
    return bb, Head(weight=w, bias=None, n_active=N_BASE)


def _samplers(splits, opt):
    base_test, base_train, novel = splits
    return (EpisodeSampler(base_train, opt, split="train", phase="train"),
            EpisodeSampler(novel, opt, split="val", disjoint_classes=True))


def _ranges(prof):
    """(name, start, end) of every ``srt.*`` range the profile holds."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("srt."):
            a = e.start_ns()
            out.append((e.name(), a, a + e.duration_ns()))
    return sorted(out, key=lambda r: r[1])


def _named(ranges, name):
    return [r for r in ranges if r[0] == name]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _counted(fn):
    """``fn()``'s result and the rows it added to the counters."""
    f0, p0 = SessionProgram.rows_forwarded, SessionProgram.rows_padded
    out = fn()
    return (out, SessionProgram.rows_forwarded - f0,
            SessionProgram.rows_padded - p0)


@pytest.fixture(scope="module")
def single(splits):
    """One 8-session run, its samplers built, under the profiler."""
    opt = _opt(3)
    bb, head = _model(3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        base_sampler, meta_sampler = _samplers(splits, opt)
        res, fwd, pad = _counted(lambda: few_shot_finetune_incremental_test(
            bb, head, {}, opt, meta_sampler=meta_sampler,
            base_test_split=splits[0], base_support_sampler=base_sampler,
            device="cpu", verbose=False))
    return dict(res=res, ranges=_ranges(prof), rows=(fwd, pad))


@pytest.fixture(scope="module")
def multi(splits):
    """The same run for two seeds through the multi-seed engine."""
    opts = [_opt(3), _opt(4)]
    models = [_model(3), _model(4)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        samplers = [_samplers(splits, o) for o in opts]
        res, fwd, pad = _counted(lambda: few_shot_finetune_multiseed(
            [m[0] for m in models], [m[1] for m in models], [{}, {}], opts,
            [s[1] for s in samplers], [splits[0]] * 2,
            [s[0] for s in samplers], device="cpu"))
    return dict(res=res, ranges=_ranges(prof), rows=(fwd, pad))


def _closed_form_rows(opt, seeds=1):
    """(rows forwarded, replay rows padded) of one run per seed: the
    initial base batch, then per session epoch 1's support and (once the
    memory holds rows) the whole replay buffer, and the caches' support,
    replay buffer, queries so far and base batch."""
    n_sup = opt.n_ways * opt.n_shots * opt.n_aug_support_samples + N_BASE
    nq = opt.n_ways * opt.n_queries
    base = opt.test_base_batch_size // 2
    mem = 25 * SESSIONS
    fwd, pad = base, 0
    for s in range(SESSIONS):
        filled = 25 * s
        fwd += n_sup + (mem if filled else 0)
        pad += (mem - filled) if filled else 0
        fwd += n_sup + mem + nq * (s + 1) + base
        pad += mem - filled
    return seeds * fwd, seeds * pad


# --------------------------------------------------------------------------
def test_span_off_is_the_shared_no_op():
    assert not torch.autograd._profiler_enabled()
    a, b = span("srt.a"), span("srt.b")
    assert a is b
    with a:
        pass
    n = 20000
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            span("srt.eval.begin")
        best = min(best, (time.perf_counter() - t0) / n)
    assert best < 1e-6, f"span() off costs {best * 1e6:.3f} us"


def test_span_on_is_a_profiler_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("srt.test.on"):
            torch.ones(3).sum()
    assert [r[0] for r in _ranges(prof)] == ["srt.test.on"]


@pytest.mark.parametrize("engine,name,count", [
    ("single", "srt.eval.setup", 1), ("single", "srt.eval.upload", 1),
    ("single", "srt.data.sampler", 2), ("single", "srt.eval.session", 8)]
    + [("single", n, 8) for n in SESSION_SPANS]
    + [("multi", "srt.eval.setup", 2), ("multi", "srt.eval.upload", 2),
       ("multi", "srt.data.sampler", 4), ("multi", "srt.eval.session", 8),
       ("multi", "srt.eval.k1", 8)]
    + [("multi", n, 16) for n in SESSION_SPANS if n != "srt.eval.k1"])
def test_eval_span_counts(request, engine, name, count):
    assert len(_named(request.getfixturevalue(engine)["ranges"], name)) \
        == count


@pytest.mark.parametrize("engine", ["single", "multi"])
def test_eval_spans_nest_in_order(request, engine):
    ranges = request.getfixturevalue(engine)["ranges"]
    names = {r[0] for r in ranges}
    assert names == {"srt.eval.setup", "srt.eval.upload",
                     "srt.data.sampler", "srt.eval.session",
                     *SESSION_SPANS}
    sessions = _named(ranges, "srt.eval.session")
    for up in _named(ranges, "srt.eval.upload"):
        assert any(_inside(up, s) for s in _named(ranges, "srt.eval.setup"))
    for sess in sessions:
        inner = [r for r in ranges if r[0] in SESSION_SPANS
                 and _inside(r, sess)]
        firsts = list(dict.fromkeys(r[0] for r in inner))
        assert firsts == list(SESSION_SPANS), firsts
        # each child starts after the previous kind has ended; the
        # multi-seed engine runs begin, epoch 1 and the caches seed by seed
        strict = SESSION_SPANS if engine == "single" else SESSION_SPANS[2:]
        for a, b in zip(strict, strict[1:]):
            assert max(r[2] for r in inner if r[0] == a) <= min(
                r[1] for r in inner if r[0] == b)
    for r in ranges:
        if r[0] in SESSION_SPANS:
            assert sum(_inside(r, s) for s in sessions) == 1, r
    # setup and the samplers lie outside every session
    for r in ranges:
        if r[0] in ("srt.eval.setup", "srt.data.sampler"):
            assert not any(_inside(r, s) for s in sessions)


@pytest.mark.parametrize("engine,seeds", [("single", 1), ("multi", 2)])
def test_row_counters_closed_form(request, engine, seeds):
    fwd, pad = request.getfixturevalue(engine)["rows"]
    assert (fwd, pad) == _closed_form_rows(Opt(), seeds)
    # the benchmark's miniImageNet geometry: 1,600 of 19,460 rows
    big = Opt()
    big.n_queries, big.test_base_batch_size = 25, 2000
    f, p = _closed_form_rows(big)
    assert (f, p) == (19460, 1600)


@pytest.mark.parametrize("engine", ["single", "multi"])
def test_session_seconds_one_positive_entry_a_session(request, engine):
    res = request.getfixturevalue(engine)["res"]
    runs = [res] if engine == "single" else res.per_seed
    for r in runs:
        assert len(r.session_seconds) == SESSIONS
        assert all(s > 0 for s in r.session_seconds)


def _pretrain_step(device_data: bool):
    bb = ResNetRFS(n_blocks=(1, 1, 1, 1), drop_rate=0.1, no_dropblock=True,
                   avg_pool=True, widths=WIDTHS)
    n_cls = 6
    state = pt.init_pretrain_state(bb, n_cls, functools.partial(
        optim.sgd_torch, learning_rate=0.05, momentum=0.9,
        weight_decay=5e-4), False, device="cpu")
    spec, _ = transforms_options["A"]
    kw = dict(with_bias=False, draws=TorchDraws(5, "cpu"))
    g = torch.Generator().manual_seed(0)
    data = torch.randint(0, 256, (32, IMG, IMG, 3), dtype=torch.uint8,
                         generator=g)
    labels = torch.arange(32) % n_cls
    idxs = torch.randperm(32, generator=g)[:8]
    if device_data:
        step = pt.make_train_step_device_data(bb, None, spec, **kw)
        return lambda: step(state, data, labels, idxs)
    step = pt.make_train_step(bb, None, spec, **kw)
    return lambda: step(state, data[idxs], labels[idxs])


PHASES = ("srt.pretrain.augment", "srt.pretrain.forward",
          "srt.pretrain.backward", "srt.pretrain.optimizer")


@pytest.mark.parametrize("device_data,order", [
    (True, ("srt.pretrain.gather",) + PHASES), (False, PHASES)])
def test_pretrain_step_phases_once_in_order(device_data, order):
    step = _pretrain_step(device_data)
    step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        m = step()
    assert torch.isfinite(m["loss"])
    ranges = _ranges(prof)
    assert tuple(r[0] for r in ranges) == order
    for a, b in zip(ranges, ranges[1:]):
        assert a[2] <= b[1]


def test_no_span_name_meets_a_device_reader(single):
    step = _pretrain_step(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    names = {r[0] for r in single["ranges"] + _ranges(prof)}
    assert len(names) == 15
    for name in names:
        assert name.startswith("srt.")
        assert not any(m in name for m in DEVICE_MARKS), name
