"""The port's other engine modes against the JAX engine's, on the synthetic
miniImageNet fixture of tests/test_torch_engine.py (16 px, a narrow
backbone whose last stage, 80 wide, is above the 60 base classes), with
the JAX draws injected:

  * the tracked path (``--track_weights``, ``--track_label_inspired_weights``):
    against the port's own untracked run (epochs exact, accuracies within
    1e-4, the printed ``Novel Epoch`` lines equal, the iteration header
    before them) and against the JAX tracked run (the CSVs' headers and
    (episode, type, label, class, epoch) keys identical, the vectors within
    1e-4, epochs exact, accuracies within 0.5);
  * the general-freeze path (``freeze_backbone_at=3``): the whole run
    against JAX's without memory (epochs exact, accuracies and weighted
    averages within 0.5), and epoch 1 and epoch 2 against the JAX
    package's ``prepare_full`` and ``full_epoch`` at a replay memory of 25
    rows with dropout on (rtol 1e-4 / atol 1e-5 on the loss, accuracies,
    head, running statistics and counters; the backbone's update within
    10% of its size, see ``UPDATE_SHARE``);
  * the departure: with the memory on and empty, JAX's epoch 1 returns a
    NaN head and the port's equals its run with the memory forward
    skipped;
  * ``--save_preds_0``, single- and multi-seed, against the JAX dump;
  * ``vis=True`` against the JAX frames.

Runs are cut to 3 sessions (the engines warn of the truncation) to keep
the module cheap; accuracies within 0.5 allow a logit near-tie, as in
tests/test_torch_engine.py."""

import copy
import csv
import glob
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from subspace_reg_tpu.data.episodes import EpisodeSampler as JaxSampler
from subspace_reg_tpu.data.mini_imagenet import load_mini_imagenet as jax_load
from subspace_reg_tpu.engine import incremental as jax_inc
from subspace_reg_tpu.models.resnet import ResNetRFS as JaxResNet

from subspace_reg_tpu_torch.data.episodes import EpisodeSampler
from subspace_reg_tpu_torch.data.mini_imagenet import load_mini_imagenet
from subspace_reg_tpu_torch.engine import incremental as inc
from subspace_reg_tpu_torch.engine.multiseed import (
    few_shot_finetune_multiseed)
from subspace_reg_tpu_torch.models import lang_puller as lp
from subspace_reg_tpu_torch.models.head import Head
from subspace_reg_tpu_torch.models.resnet import ResNetRFS
from subspace_reg_tpu_torch.weights import from_jax_variables

from test_torch_engine import (SEMANTIC, SUBSPACE, WIDTHS, JaxDraws,
                               _opt, _splits, env, one_torch_thread)

SESSIONS = 3
MODES = dict(neval_episodes=SESSIONS)


def _inputs(opt, port: bool):
    load = load_mini_imagenet if port else jax_load
    sampler = EpisodeSampler if port else JaxSampler
    base_test, base_train, novel = _splits(load, opt)
    return dict(meta_sampler=sampler(novel, opt, split="val",
                                     disjoint_classes=True),
                base_test_split=base_test,
                base_support_sampler=sampler(base_train, opt, split="train",
                                             phase="train"))


def heads(env, bias=False):
    """The fixture's (JAX, port) heads, padded for SESSIONS sessions."""
    rows = 60 + 5 * SESSIONS
    jh, th = env["heads"][bias]
    return (jh.replace(weight=jh.weight[:rows], bias=None if jh.bias is None
                       else jh.bias[:rows]),
            Head(weight=th.weight[:rows], bias=None if th.bias is None
                 else th.bias[:rows], n_active=th.n_active))


def run_jax(env, bias=False, meta=None, vis=False, **over):
    """The JAX engine; ``verbose`` in ``over`` turns its prints on too."""
    opt = _opt(env["root"], **dict(MODES, **over))
    return jax_inc.few_shot_finetune_incremental_test(
        env["jbb"], env["variables"], heads(env, bias)[0], meta or {}, opt,
        **_inputs(opt, port=False), verbose=opt.verbose, pallas_mode="off",
        vis=vis)


def run_port(env, bias=False, meta=None, vis=False, **over):
    opt = _opt(env["root"], **dict(MODES, **over))
    return inc.few_shot_finetune_incremental_test(
        env["tbb"], heads(env, bias)[1], meta or {}, opt,
        **_inputs(opt, port=True), verbose=opt.verbose, device="cpu",
        draws=JaxDraws(opt.set_seed), vis=vis)


def assert_traces_close(got, ref, atol):
    assert got.epochs_per_session == ref.epochs_per_session
    assert len(got.acc_novel_list) == SESSIONS
    for name in ("acc_novel_list", "acc_base_list", "weighted_avg_l"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   atol=atol, err_msg=name)


def read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


# --------------------------------------------------------------------------
# the tracked path
# --------------------------------------------------------------------------
def _epoch_lines(out):
    """The printed iteration headers and Novel Epoch lines, in order."""
    return [l for l in out.splitlines()
            if l.startswith("**** Iteration") or l.startswith("Novel Epoch")]


def test_tracked_matches_untracked(env, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    over = dict(SUBSPACE, verbose=True)
    ref = run_port(env, **over)
    fast = capsys.readouterr().out
    got = run_port(env, track_weights=True, **over)
    tracked = capsys.readouterr().out
    assert_traces_close(got, ref, 1e-4)
    lines = _epoch_lines(tracked)
    assert any(l.startswith("Novel Epoch") for l in lines)
    assert lines == _epoch_lines(fast)
    assert lines[0] == f"**** Iteration 1/{SESSIONS} ****"
    assert os.listdir(tmp_path) == [
        "track_weights_few-shot-incremental-fine-tune_pulling_regularize_"
        "1.0_target_loss_0.0_synonyms_False.csv"]


def _tracking_rows(path, n_key):
    """{key columns: vector} of a tracking CSV."""
    header, rows = read_csv(path)
    return header, {tuple(r[:n_key]): np.array(r[n_key].split(), np.float64)
                    for r in rows}


@pytest.mark.parametrize("over", [SUBSPACE, SEMANTIC],
                         ids=["subspace", "semantic"])
def test_tracked_csvs_match_jax(env, tmp_path, monkeypatch, over):
    flags = dict(over, track_weights=True, track_label_inspired_weights=True)
    results = {}
    for name, run in (("jax", run_jax), ("port", run_port)):
        os.makedirs(tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        results[name] = run(env, **flags)
    assert_traces_close(results["port"], results["jax"], 0.5)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == 2 and names == sorted(os.listdir(tmp_path / "port"))
    for fname in names:
        n_key = 5 if fname.startswith("track_weights") else 3
        h_ref, ref = _tracking_rows(tmp_path / "jax" / fname, n_key)
        h_got, got = _tracking_rows(tmp_path / "port" / fname, n_key)
        assert h_got == h_ref
        assert list(got) == list(ref)
        for key, vec in ref.items():
            np.testing.assert_allclose(got[key], vec, atol=1e-4,
                                       err_msg=f"{fname} {key}")


# --------------------------------------------------------------------------
# the general-freeze path
# --------------------------------------------------------------------------
@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
def test_general_freeze_matches_jax(env, bias):
    over = dict(SUBSPACE, freeze_backbone_at=3, memory_replay=0)
    if bias:
        over["lmbd_reg_novel"] = None   # refused with a bias in both
    ref = run_jax(env, bias=bias, **over)
    got = run_port(env, bias=bias, **over)
    assert_traces_close(got, ref, 0.5)


DROP = 0.1


@pytest.fixture(scope="module")
def step_env(env):
    return make_step_env(env["root"])


def make_step_env(root, drop=DROP):
    """One session's inputs for epoch 1 and 2 of the general-freeze path:
    a backbone with the golden drop rate 0.1 (dropout and DropBlock), a
    grown head, 125 support rows and a 200-row replay buffer, from seeds."""
    jbb = JaxResNet(n_blocks=(1, 1, 1, 1), drop_rate=drop, no_dropblock=True,
                    avg_pool=True, widths=WIDTHS)
    variables = jax.tree_util.tree_map(np.asarray, dict(jbb.init(
        jax.random.PRNGKey(5), jnp.zeros((2, 16, 16, 3)), train=False)))
    tbb = ResNetRFS(n_blocks=(1, 1, 1, 1), drop_rate=drop, no_dropblock=True,
                    avg_pool=True, widths=WIDTHS)
    tbb.load_state_dict(from_jax_variables(variables))
    opt = _opt(root, n_base_support_samples=0, **SUBSPACE)
    geo = inc.build_geometry(opt, n_base=60, img_size=16, base_eval_n=100,
                             feat_dim=WIDTHS[-1], has_base_support=False)
    r = np.random.RandomState(7)
    feat, cmax, n_active = WIDTHS[-1], geo.max_classes, 65
    head_w = np.zeros((cmax, feat), np.float32)
    head_w[:n_active] = 0.1 * r.randn(n_active, feat)
    w0 = head_w.copy()
    w0[60:] = 0.0
    return dict(
        jbb=jbb, variables=variables, tbb=tbb, opt=opt, geo=geo,
        n_active=n_active, head_w=head_w, w0=w0,
        support_x=r.randn(geo.n_support, 16, 16, 3).astype(np.float32),
        support_y=r.randint(60, 65, geo.n_support).astype(np.int64),
        memory_x=r.randn(geo.max_memory, 16, 16, 3).astype(np.float32),
        memory_y=r.randint(0, 60, geo.max_memory).astype(np.int64))


def _jax_prepare_full(e, memory_count):
    opt = e["opt"]
    geo = jax_inc.build_geometry(opt, n_base=60, img_size=16,
                                 base_eval_n=100, feat_dim=WIDTHS[-1],
                                 has_base_support=False)
    fns = jax_inc.make_session_fn(e["jbb"], opt, geo, False,
                                  pallas_mode="off")
    mem_x = e["memory_x"].copy()
    mem_x[memory_count:] = 0.0
    args = dict(
        head_w=jnp.asarray(e["head_w"]), head_b=jnp.zeros((geo.max_classes,)),
        n_active=jnp.int32(e["n_active"]), w0=jnp.asarray(e["w0"]),
        b0=jnp.zeros((geo.max_classes,)),
        reserved=jnp.zeros((geo.max_novel, geo.feat_dim)),
        n_reserved=jnp.int32(0), support_x=jnp.asarray(e["support_x"]),
        support_y=jnp.asarray(e["support_y"], jnp.int32),
        memory_x=jnp.asarray(mem_x),
        memory_y=jnp.asarray(e["memory_y"], jnp.int32),
        memory_count=jnp.int32(memory_count),
        sem_pullers=jnp.zeros((geo.n_ways, geo.feat_dim)))
    out = fns["prepare_full"](
        e["variables"], args["head_w"], args["head_b"], args["n_active"],
        args["w0"], args["b0"], args["reserved"], args["n_reserved"],
        args["support_x"], args["support_y"], args["memory_x"],
        args["memory_y"], args["memory_count"], args["sem_pullers"],
        jax.random.PRNGKey(e["opt"].set_seed * 31))
    return fns, args, out


def _port_prepare_full(e, memory_count, memory_on=True, dropout_idx=0):
    opt = copy.copy(e["opt"])
    opt.memory_replay = 1 if memory_on else 0
    prog = inc.SessionProgram(copy.deepcopy(e["tbb"]), opt, e["geo"], False)
    mem_x = e["memory_x"].copy()
    mem_x[memory_count:] = 0.0
    nchw = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
    geo = e["geo"]
    s = inc.SessionInputs(
        head_w=torch.from_numpy(e["head_w"]), head_b=None,
        n_active=e["n_active"], w0=torch.from_numpy(e["w0"]), b0=None,
        reserved=torch.zeros((geo.max_novel, geo.feat_dim)), n_reserved=0,
        support_x=nchw(e["support_x"]),
        support_y=torch.from_numpy(e["support_y"]), memory_x=nchw(mem_x),
        memory_y=torch.from_numpy(e["memory_y"]), memory_count=memory_count,
        query_x=nchw(e["support_x"][:20]),
        query_y=torch.from_numpy(e["support_y"][:20]),
        base_x=nchw(e["memory_x"][:10]),
        base_y=torch.from_numpy(e["memory_y"][:10]), generator=None,
        base_basis=lp.subspace_basis(torch.from_numpy(e["w0"][:60])))
    draws = JaxDraws(opt.set_seed, e["jbb"], 16)
    return prog, s, prog.prepare_full(s, draws.dropout_full(dropout_idx))


# the backbone's update within this share of each tensor's largest update:
# a pre-activation within f32 noise of LeakyReLU's kink takes the slope-1
# branch in one engine and the slope-0.1 branch in the other, and moves
# its channel's gradient; at this fixture one element of layer 4 does,
# which moves the lower layers' updates by up to ~4% (a float64 run sides
# with the JAX engine there).  A wrong dropout key, or the memory
# forward's running statistics left in place, moves them by far more
# (test_general_freeze_step_check_sees_planted_faults).
UPDATE_SHARE = 0.1


def _update_share(e, prog, full_params):
    """The largest |port - JAX| of the backbone's parameters, as a share
    of each tensor's largest JAX update."""
    want = from_jax_variables(jax.tree_util.tree_map(
        np.asarray, {"params": full_params["backbone"]}))
    start = from_jax_variables(e["variables"])
    got = prog.backbone.state_dict()
    share = 0.0
    for k, v in want.items():
        step = np.abs(v.numpy() - start[k].numpy().reshape(v.shape)).max()
        diff = np.abs(got[k].detach().numpy().reshape(v.shape)
                      - v.numpy()).max()
        share = max(share, float(diff / max(step, 1e-12)))
    return share


def _jax_full_epoch(fns, args, out):
    """JAX's epoch 2 after ``prepare_full``'s ``out``."""
    (full_params, opt_state, l1, a1, a5, stable, stop, bstats,
     counters) = out
    return fns["full_epoch"](
        full_params, opt_state, l1, stable, jnp.int32(1), bstats, counters,
        args["support_x"], args["support_y"], args["memory_x"],
        args["memory_y"], args["memory_count"], args["w0"], args["b0"],
        args["reserved"], args["n_reserved"], args["sem_pullers"],
        args["n_active"])


def _assert_state_close(e, prog, st, full_params, bstats, counters, loss,
                        a1, a5):
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(st.loss), float(loss), **tol)
    np.testing.assert_allclose([float(st.a1), float(st.a5)],
                               [float(a1), float(a5)], **tol)
    np.testing.assert_allclose(st.params["w"].detach().numpy(),
                               np.asarray(full_params["w"]), **tol)
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, {
        "params": full_params["backbone"], "batch_stats": bstats,
        "counters": counters}))
    start = from_jax_variables(e["variables"])
    got = prog.backbone.state_dict()
    params = dict(prog.backbone.named_parameters())
    assert set(want) == set(got)
    for k, v in want.items():
        g = got[k].detach().numpy().reshape(v.shape)
        if k not in params:     # running statistics and counters
            np.testing.assert_allclose(g, v.numpy(), err_msg=k, **tol)
            continue
        step = v.numpy() - start[k].numpy().reshape(v.shape)
        diff = np.abs(g - v.numpy()).max()
        assert diff <= UPDATE_SHARE * np.abs(step).max() + 1e-7, (
            k, diff, np.abs(step).max())


def test_general_freeze_epochs_1_and_2_match_jax(step_env):
    """Epoch 1 (train-mode forwards; the support and memory forwards share
    one dropout key; the running statistics and counters are the support
    forward's) and epoch 2 (eval-mode forwards with gradients, which
    advance nothing) against JAX's prepare_full and full_epoch, at a
    memory of 25 rows."""
    e = step_env
    fns, args, out = _jax_prepare_full(e, 25)
    (full_params, opt_state, l1, a1, a5, stable, stop, bstats,
     counters) = out
    prog, s, st = _port_prepare_full(e, 25)
    assert np.isfinite(float(l1))
    _assert_state_close(e, prog, st, full_params, bstats, counters, l1, a1,
                        a5)
    assert int(st.stable) == int(stable) and bool(st.stop) == bool(stop)

    (full_params, opt_state, l2, stable, epoch, stop, a1, a5) = \
        _jax_full_epoch(fns, args, out)
    st2 = prog.full_epoch(s, st)
    assert st2.epoch == int(epoch) == 2
    _assert_state_close(e, prog, st2, full_params, bstats, counters, l2, a1,
                        a5)


@pytest.mark.parametrize("fault", ["dropout_key", "memory_statistics"])
def test_general_freeze_step_check_sees_planted_faults(step_env, monkeypatch,
                                                       fault):
    """``UPDATE_SHARE`` is below what a fault of the general-freeze step
    moves the backbone's update by: the next session's dropout key in
    epoch 1, or the memory forward's running statistics left in place
    (their buffers not restored), which epoch 2's eval-mode forwards read.
    Each share is printed (``-s``)."""
    e = step_env
    fns, args, out = _jax_prepare_full(e, 25)
    if fault == "memory_statistics":
        monkeypatch.setattr(inc, "_load_buffers", lambda module, saved: None)
    prog, s, st = _port_prepare_full(
        e, 25, dropout_idx=1 if fault == "dropout_key" else 0)
    full_params = out[0]
    if fault == "memory_statistics":
        full_params = _jax_full_epoch(fns, args, out)[0]
        prog.full_epoch(s, st)
    share = _update_share(e, prog, full_params)
    print(f"planted {fault}: backbone update share {share:.4f} "
          f"(UPDATE_SHARE {UPDATE_SHARE})")
    assert share > UPDATE_SHARE


def test_general_freeze_with_empty_memory_departs_from_jax(step_env):
    """Session 0 of the general-freeze path with memory on: JAX runs the
    masked train-mode memory forward on 0 rows, whose gradient is NaN, so
    the head it returns is NaN (and every later loss); the port skips it,
    as the compiled session does, and equals its run with the memory off
    (a replay CE of exactly 0)."""
    e = step_env
    _, _, out = _jax_prepare_full(e, 0)
    assert not np.all(np.isfinite(np.asarray(out[0]["w"])))
    prog_on, _, on = _port_prepare_full(e, 0)
    prog_off, _, off = _port_prepare_full(e, 0, memory_on=False)
    assert np.isfinite(float(on.loss))
    assert float(on.loss) == float(off.loss)
    assert torch.equal(on.params["w"], off.params["w"])
    for (k, a), b in zip(prog_on.backbone.state_dict().items(),
                         prog_off.backbone.state_dict().values()):
        assert torch.equal(a, b), k


def test_general_freeze_with_memory_is_finite(env):
    """The whole run with memory on, where the JAX engine turns NaN: every
    session's numbers finite."""
    res = run_port(env, **SUBSPACE, freeze_backbone_at=3, max_novel_epochs=8)
    assert len(res.acc_novel_list) == SESSIONS
    for name in ("acc_novel_list", "acc_base_list", "weighted_avg_l"):
        assert np.all(np.isfinite(getattr(res, name)))
    assert all(3 <= e <= 8 for e in res.epochs_per_session)


# --------------------------------------------------------------------------
# prediction dumps
# --------------------------------------------------------------------------
def meta(env, seed=3):
    """A checkpoint's ``training_classes``, as pretraining on seed
    ``seed``'s continual base classes writes it: original label -> row."""
    opt = _opt(env["root"], set_seed=seed)
    return {"training_classes": _splits(load_mini_imagenet, opt)[0].basec_map}


class GapRecorder:
    """Wraps the port's ``SessionProgram.evaluate``: each session's top-two
    logit gaps of the session-0 queries and the base batch, in the dump's
    row order."""

    def __init__(self, monkeypatch):
        self.gaps = []
        orig = inc.SessionProgram.evaluate

        def evaluate(prog, params, f_query, query_y, f_base, base_y, n):
            nq = prog.geo.n_query_per_session
            logits = torch.cat([inc.head_logits(params, f_query[:nq], n),
                                inc.head_logits(params, f_base, n)])
            top = torch.topk(logits, 2, dim=1).values
            self.gaps.append((top[:, 0] - top[:, 1]).numpy())
            return orig(prog, params, f_query, query_y, f_base, base_y, n)

        monkeypatch.setattr(inc.SessionProgram, "evaluate", evaluate)


def assert_dumps_agree(got_path, ref_path, gaps):
    h_got, got = read_csv(got_path)
    h_ref, ref = read_csv(ref_path)
    assert h_got == h_ref == ["Episode", "Gold", "Prediction",
                              "Original_Gold", "Original_Prediction"]
    assert len(got) == len(ref) == len(gaps)
    got, ref = np.array(got), np.array(ref)
    for col in (0, 1, 3):
        assert (got[:, col] == ref[:, col]).all(), h_ref[col]
    sure = gaps > 1e-4
    assert sure.mean() > 0.9
    for col in (2, 4):
        assert (got[sure, col] == ref[sure, col]).all(), h_ref[col]
    assert (ref[:, 4] != "-1").any()


def test_prediction_dump_matches_jax(env, tmp_path, monkeypatch):
    rec = GapRecorder(monkeypatch)
    for name, run in (("jax", run_jax), ("port", run_port)):
        os.makedirs(tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        run(env, meta=meta(env), save_preds_0=True, **SUBSPACE)
    ref = glob.glob(str(tmp_path / "jax" / "csv_files_mem" / "*.csv"))
    assert len(ref) == 1
    name = os.path.basename(ref[0])
    assert name == ("seed_3_miniImageNet_5_1.0_distance2subspace_continual_"
                    "True_mem_1_predictions.csv")
    assert_dumps_agree(tmp_path / "port" / "csv_files_mem" / name, ref[0],
                       np.concatenate(rec.gaps))


def test_multiseed_prediction_dumps_match_jax(env, tmp_path, monkeypatch):
    """One dump per seed from the port's multi-seed engine, each against
    the JAX engine's dump of that seed (the JAX multi-seed engine writes
    the stand-alone engine's bytes, multiseed.py:18-20)."""
    seeds = (3, 4)
    monkeypatch.chdir(tmp_path)
    for seed in seeds:
        run_jax(env, meta=meta(env, seed), save_preds_0=True, set_seed=seed,
                **SUBSPACE)
    os.rename(tmp_path / "csv_files_mem", tmp_path / "jax")
    rec = GapRecorder(monkeypatch)
    opts = [_opt(env["root"], set_seed=s, save_preds_0=True,
                 **dict(MODES, **SUBSPACE)) for s in seeds]
    ins = [_inputs(o, port=True) for o in opts]
    few_shot_finetune_multiseed(
        [env["tbb"]] * 2, [heads(env)[1]] * 2, [meta(env, s) for s in seeds],
        opts,
        [i["meta_sampler"] for i in ins], [i["base_test_split"] for i in ins],
        [i["base_support_sampler"] for i in ins], device="cpu",
        draws=[JaxDraws(s) for s in seeds])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "csv_files_mem"))
    assert len(names) == 2
    for k, seed in enumerate(seeds):
        # the recorder sees the seeds' sessions interleaved
        gaps = np.concatenate(rec.gaps[k::2])
        name = [n for n in names if n.startswith(f"seed_{seed}_")][0]
        assert_dumps_agree(tmp_path / "csv_files_mem" / name,
                           tmp_path / "jax" / name, gaps)


# --------------------------------------------------------------------------
# vis frames
# --------------------------------------------------------------------------
def _pixels(tag):
    import base64
    import io
    from PIL import Image
    b64 = tag[len('<img src="data:image/jpeg;base64,'):-2]
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def test_vis_frames_match_jax(env, monkeypatch):
    over = dict(SUBSPACE, max_novel_epochs=6, min_novel_epochs=3)
    ref = run_jax(env, vis=True, **over)
    # the top-two logit gaps of the frames' predictions, one call per
    # recorded epoch (20 session-0 queries)
    gaps = []
    orig = inc.head_logits

    def head_logits(params, feats, n_active):
        out = orig(params, feats, n_active)
        if feats.shape[0] == 20 and len(gaps) < len(ref) // 20:
            top = torch.topk(out, 2, dim=1).values
            gaps.append((top[:, 0] - top[:, 1]).detach().numpy())
        return out

    monkeypatch.setattr(inc, "head_logits", head_logits)
    got = run_port(env, vis=True, **over)
    assert list(got) == list(ref.columns)
    assert all(len(v) == len(ref) for v in got.values())
    assert len(ref) % 20 == 0 and len(ref) >= 20 * 3
    sure = np.concatenate(gaps) > 1e-4
    assert sure.mean() > 0.9
    for col in ("idx", "class", "isbase"):
        assert list(got[col]) == list(ref[col]), col
    assert (np.array(got["predicted"])[sure]
            == ref["predicted"].to_numpy()[sure]).all()
    for a, b in zip(got["img"][:20], ref["img"][:20]):
        np.testing.assert_array_equal(_pixels(a), _pixels(b))
    assert got["img"][:20] == got["img"][20:40]
