"""Plain reference of the 8-session few-shot class-incremental evaluation
of "Subspace Regularizers for Few-Shot Class Incremental Learning"
(reference ``eval/language_eval.py``), on its default path: the linear
head fine-tuned on a frozen backbone with the base-weight and
previous-novel anchors, the subspace pull of the new rows, and a replay
memory of one shot a class.

It takes the same inputs as the program (the splits, the backbone's
weights, the head, the seed's draws and the ``np.random`` protocol of the
published samplers) and works every stage out again in plain PyTorch,
through the backbone reference that the configuration names
(``backbone.py``):

  session   the episode (5 classes, 5 shots x 5 augmented copies, 25
            queries a class) and the replay rows' draw; the previous
            session's new rows reserved; 5 fresh head rows;
  epoch 1   train-mode forwards of the support (with the 60 or 351 base
            exemplars) and of the filled replay rows (batch statistics
            over the valid rows only), the session loss, its gradient,
            one SGD step;
  epochs 2+ on eval-mode features, the same loss and step until the loss
            has moved less than ``convergence_epsilon`` for
            ``stable_epochs`` epochs, or ``max_novel_epochs``;
  evaluate  top-1 accuracy of each session's queries so far and of the
            fixed base batch;
  memory    one shot a new class, all its augmented copies, appended.

The session loss: mean CE over the support + masked mean CE over the
replay rows (classes beyond the active ones masked out) + 0.2 ||W[:base]
- W0|| + 0.1 ||W[novel so far] - reserved|| (both unsquared) + 1.0 ||W_new
- W_new Q Q^T||^2, Q an orthonormal basis of the base rows of W0.  SGD
adds the weight decay to the gradient and keeps momentum 0.9.

``tf32`` computes the whole reference with TF32 matrix products and
convolutions: the control, one precision below the configuration's f32.
The reference imports nothing of the program.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch

from .. import draws as D
from . import augment, backbone

NEG = -1e9


@contextlib.contextmanager
def _tf32(enabled: bool):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _classes(labels: np.ndarray):
    """Classes in insertion order over the split and each one's global
    indices (the published sampler's grouping)."""
    index: Dict[int, List[int]] = {}
    for i, lbl in enumerate(labels.tolist()):
        index.setdefault(lbl, []).append(i)
    return list(index), index


def _masked_logits(f, w, n_active):
    out = f @ w.T
    cols = torch.arange(w.shape[0], device=f.device)[None, :]
    return torch.where(cols < n_active, out, torch.full_like(out, NEG))


def _top1(logits, y):
    y = y.long()
    ly = logits.gather(1, y[:, None])
    cols = torch.arange(logits.shape[1], device=logits.device)[None, :]
    beats = (logits > ly) | ((logits == ly) & (cols < y[:, None]))
    return float((beats.sum(1) < 1).sum()) * 100.0 / y.shape[0]


class SessionLoss:
    """The session loss and its gradient in W, written out."""

    def __init__(self, h: dict, w0, reserved, n_reserved, n_active,
                 pull_m, f_sup, y_sup, f_mem, y_mem, mem_count):
        dev = w0.device
        rows = torch.arange(w0.shape[0], device=dev)[:, None]
        self.h = h
        self.w0 = w0
        self.base_m = (rows < h["n_base"]).float()
        lo = h["n_base"]
        self.res = torch.zeros_like(w0)
        self.res[lo:lo + reserved.shape[0]] = reserved
        self.res_m = ((rows >= lo) & (rows < lo + n_reserved)).float()
        self.cur_m = ((rows >= n_active - h["n_ways"])
                      & (rows < n_active)).float()
        self.pull_m = pull_m
        self.n_active = n_active
        self.sup = (f_sup, y_sup.long(), f_sup.shape[0])
        self.mem = (f_mem, y_mem.long(), mem_count)

    def _ce(self, f, y, count, w):
        rows = f.shape[0]
        if count == 0:
            return w.new_zeros(()), torch.zeros_like(w)
        valid = (torch.arange(rows, device=f.device) < count)[:, None]
        logits = _masked_logits(f, w, self.n_active)
        logp = torch.log_softmax(logits, 1)
        oh = torch.zeros_like(logits).scatter_(1, y[:, None], 1.0) * valid
        loss = -(oh * logp).sum() / count
        dlog = (torch.exp(logp) - oh) * valid / count
        return loss, dlog.T @ f

    def __call__(self, w):
        h = self.h
        loss, g = self._ce(*self.sup, w)
        l2, g2 = self._ce(*self.mem, w)
        loss, g = loss + l2, g + g2
        for lmbd, diff in ((h["lmbd_base"], (w - self.w0) * self.base_m),
                           (h["lmbd_novel"], (w - self.res) * self.res_m)):
            sq = (diff * diff).sum()
            norm = torch.sqrt(sq)
            safe = torch.where(sq > 0, norm, torch.ones_like(norm))
            loss = loss + lmbd * torch.where(sq > 0, norm,
                                             torch.zeros_like(norm))
            g = g + lmbd * torch.where(sq > 0, diff / safe,
                                       torch.zeros_like(diff))
        v = (w * self.cur_m) @ self.pull_m
        loss = loss + h["gamma"] * (v * v).sum()
        g = g + 2.0 * h["gamma"] * (v @ self.pull_m.T) * self.cur_m
        return loss, g


def _stop(stable, loss, epoch: int, h: dict):
    """The stop rule after ``epoch``: ``stable_epochs`` stable epochs in a
    row, the last epoch, or the target loss after the least epochs."""
    stop = stable == h["stable_target"]
    if epoch >= h["min_epochs"] + 1:
        stop = stop | (loss <= h["target_loss"])
    if epoch >= h["max_epochs"]:
        stop = torch.ones_like(stop)
    return stop


def finetune(loss_fn: SessionLoss, w, mom, l1, h: dict):
    """Epochs 2..N from the state after epoch 1; the stop rule of the
    published loop.  Runs on the device, looking at the stop flag every
    ``check`` epochs; a stopped loop keeps its head.  Returns (w, last
    epoch)."""
    dev = w.device
    prev = l1.clone()
    one = torch.ones((), device=dev)
    stable = torch.where((l1 - 15.0).abs() < h["eps"], one, 0 * one)
    done = _stop(stable, l1, 1, h)
    last = torch.ones((), device=dev)
    epoch, check = 1, 50
    while epoch < h["max_epochs"]:
        if epoch % check == 1 and bool(done):
            break
        epoch += 1
        loss, g = loss_fn(w)
        g = g + h["wd"] * w
        mom_n = h["momentum"] * mom + g
        w_n = w - h["lr"] * mom_n
        live = ~done
        w = torch.where(live, w_n, w)
        mom = torch.where(live, mom_n, mom)
        st = torch.where((loss - prev).abs() < h["eps"], stable + 1, 0 * one)
        stop = _stop(st, loss, epoch, h)
        stable = torch.where(live, st, stable)
        prev = torch.where(live, loss, prev)
        last = torch.where(live, torch.full_like(last, epoch), last)
        done = done | stop
    return w, int(last)


def evaluate(cfg: dict, opt: dict, weights: Dict[str, torch.Tensor],
             head0: torch.Tensor, n_base: int, base_test, base_train, novel,
             seed: int, device, tf32: bool = False,
             block_rows: int = 250) -> dict:
    """One seed's run.  ``opt``: the evaluation's flags by name;
    ``weights``: the backbone's parameters and buffers by state-dict
    name; ``head0``: the (max_classes, D) head with ``n_base`` active
    rows; splits as (uint8 images, labels).  Returns per session what
    the comparison reads."""
    with _tf32(tf32), torch.no_grad():
        return _evaluate(cfg, opt, weights, head0, n_base, base_test,
                         base_train, novel, seed, device, block_rows)


def _evaluate(cfg, opt, weights, head0, n_base, base_test, base_train,
              novel, seed, dev, block_rows):
    e = cfg["eval"]
    ways, shots, queries = opt["n_ways"], opt["n_shots"], opt["n_queries"]
    n_aug = opt["n_aug_support_samples"]
    sessions = int(e["sessions"])
    pad = int(e["augment"]["padding"])
    params = {k: v.to(dev) for k, v in weights.items()}
    buf = {k: v.clone() for k, v in params.items()
           if k.endswith(("running_mean", "running_var",
                          "num_batches_tracked"))}
    h = dict(n_base=n_base, n_ways=ways, lmbd_base=opt["lmbd_reg_transform_w"],
             lmbd_novel=opt["lmbd_reg_novel"], gamma=opt["label_pull"],
             lr=opt["learning_rate"], wd=opt["weight_decay"],
             momentum=opt["momentum"], eps=opt["convergence_epsilon"],
             stable_target=opt["stable_epochs"],
             max_epochs=opt["max_novel_epochs"],
             min_epochs=opt["min_novel_epochs"],
             target_loss=opt["target_train_loss"])

    forward = backbone.of(cfg).forward

    def feats(x, train=False, gen=None, mask=None):
        if train:
            return forward(params, buf, x, cfg, True, gen, mask)
        return backbone.in_chunks(
            lambda xb: forward(params, buf, xb, cfg, False), x, block_rows)

    # the samplers' class lists, each shuffled from the seed
    bt_imgs, bt_labels = base_test
    tr_imgs, tr_labels = base_train
    nv_imgs, nv_labels = novel
    base_classes, base_index = _classes(tr_labels)
    np.random.seed(opt["set_seed"])
    np.random.shuffle(base_classes)
    novel_classes, novel_index = _classes(nv_labels)
    np.random.seed(opt["set_seed"])
    np.random.shuffle(novel_classes)

    # the fixed base batch and the base exemplars
    base_n = opt["test_base_batch_size"] // 2
    base_x = augment.test_transform(
        torch.from_numpy(np.ascontiguousarray(bt_imgs[:base_n])).to(dev))
    base_y = torch.from_numpy(
        (bt_labels[:base_n] - bt_labels.min()).astype(np.int64)).to(dev)
    np.random.seed(opt["set_seed"])
    np.random.seed(0)
    sampled = np.random.choice(base_classes, len(base_classes), False)
    ex_gids, ex_y = [], []
    for cls in np.sort(sampled):
        ids = np.random.choice(range(len(base_index[cls])),
                               opt["n_base_support_samples"], False)
        ex_gids.append(np.asarray(base_index[cls])[ids])
        ex_y += [cls] * len(ids)
    ex_gids = np.concatenate(ex_gids)
    ex_u8 = torch.from_numpy(np.ascontiguousarray(tr_imgs[ex_gids])).to(dev)
    d = D.augment_draws(seed, D.BASE_AUGMENT, 0, len(ex_gids), pad, 0.0, dev)
    ex_x = augment.train_transform(ex_u8, d, pad, 0.0)
    ex_y = np.asarray(ex_y, np.int64)
    stream = np.random.get_state()

    w = head0.to(dev).clone()
    max_classes, dim = w.shape
    w0 = w.clone()
    q = np.linalg.qr(w0[:n_base].double().cpu().numpy().T)[0]
    pull_m = torch.from_numpy(np.eye(dim) - q @ q.T).float().to(dev)
    n_active = n_base
    max_novel = sessions * ways
    reserved = torch.zeros((max_novel, dim), device=dev)
    n_reserved = 0
    img = bt_imgs.shape[1]
    mem_rows = 25 * sessions
    mem_x = torch.zeros((mem_rows, 3, img, img), device=dev)
    mem_y = torch.zeros((mem_rows,), dtype=torch.int64, device=dev)
    mem_count = 0
    nq = ways * queries
    query_x = torch.zeros((sessions * nq, 3, img, img), device=dev)
    query_y = torch.zeros((sessions * nq,), dtype=torch.int64, device=dev)

    out = []
    for idx in range(sessions):
        # the episode, then the replay rows' draw
        np.random.set_state(stream)
        np.random.seed(idx)
        cls_sampled = novel_classes[:ways]
        novel_classes = novel_classes[ways:]
        s_gids, q_gids, s_lab, q_lab = [], [], [], []
        for cls in np.sort(cls_sampled):
            gids = np.asarray(novel_index[cls])
            sup = np.random.choice(range(len(gids)), shots, False)
            rest = np.setxor1d(np.arange(len(gids)), sup)
            qry = np.random.choice(rest, queries, False)
            s_gids.append(gids[sup])
            q_gids.append(gids[qry])
            s_lab += [cls] * shots
            q_lab += [cls] * queries
        s_gids = np.tile(np.concatenate(s_gids), n_aug)
        s_lab = np.tile(np.asarray(s_lab), n_aug)
        q_gids = np.concatenate(q_gids)
        pick = np.random.choice(shots, opt["memory_replay"])
        inds = (np.tile(5 * np.arange(5) + pick, (5, 1))
                + np.tile(np.arange(0, 125, 25), (5, 1)).T).flatten()
        stream = np.random.get_state()
        ids = {c: n_base + j + idx * ways
               for j, c in enumerate(np.sort(np.unique(q_lab)).tolist())}

        if idx >= 1:
            lo = n_base + ways * (idx - 1)
            reserved[ways * (idx - 1):ways * idx] = w[lo:lo + ways]
            n_reserved = ways * idx

        d = D.augment_draws(seed, D.SUPPORT_AUGMENT, idx, len(s_gids), pad,
                            0.0, dev)
        sup_x = augment.train_transform(
            torch.from_numpy(np.ascontiguousarray(nv_imgs[s_gids])).to(dev),
            d, pad, 0.0)
        query_x[idx * nq:(idx + 1) * nq] = augment.test_transform(
            torch.from_numpy(np.ascontiguousarray(nv_imgs[q_gids])).to(dev))
        query_y[idx * nq:(idx + 1) * nq] = torch.tensor(
            [ids[c] for c in q_lab], device=dev)
        sup_x = torch.cat([sup_x, ex_x], 0)
        sup_y = torch.from_numpy(np.concatenate(
            [np.asarray([ids[c] for c in s_lab]), ex_y])).to(dev)

        new_w, _ = D.linear_init(seed, idx, max_classes, dim, False, dev)
        w = w.clone()
        w[n_active:n_active + ways] = new_w[:ways]
        n_active += ways

        # epoch 1: train-mode forwards (support, then the filled replay
        # rows), one step
        gen = D.generator(seed, D.DROPOUT, idx, dev)
        f_sup_tr = feats(sup_x, True, gen)
        f_mem_tr = torch.zeros((mem_rows, dim), device=dev)
        if mem_count > 0:
            mask = (torch.arange(mem_rows, device=dev) < mem_count).float()
            f_mem_tr = feats(mem_x, True, gen, mask)
        loss1 = SessionLoss(h, w0, reserved, n_reserved, n_active, pull_m,
                            f_sup_tr, sup_y, f_mem_tr, mem_y, mem_count)
        l1, g = loss1(w)
        g = g + h["wd"] * w
        mom = g
        w1 = w - h["lr"] * mom

        # the eval-mode caches, then epochs 2..N
        f_sup, f_mem = feats(sup_x), feats(mem_x)
        f_query = feats(query_x[:(idx + 1) * nq])
        f_base = feats(base_x)
        loss_n = SessionLoss(h, w0, reserved, n_reserved, n_active, pull_m,
                             f_sup, sup_y, f_mem, mem_y, mem_count)
        w, last = finetune(loss_n, w1, mom, l1, h)

        # evaluation
        lq = _masked_logits(f_query, w, n_active)
        chunk = [_top1(lq[lo:lo + nq], query_y[lo:lo + nq])
                 for lo in range(0, lq.shape[0], nq)]
        base_acc = _top1(_masked_logits(f_base, w, n_active), base_y)
        lb = _masked_logits(f_base, w, n_active)
        rec = dict(w1=w1[:n_active], f_sup=f_sup, f_mem=f_mem[:mem_count],
                   f_query=f_query, f_base=f_base, w=w[:n_active],
                   epochs=last, chunk_accs=chunk, base_acc=base_acc,
                   query_logits=lq[:, :n_active], base_logits=lb[:, :n_active],
                   query_y=query_y[:(idx + 1) * nq].clone(), base_y=base_y,
                   chunk_size=nq)

        # the replay memory
        t = torch.from_numpy(inds).to(dev)
        mem_x[mem_count:mem_count + len(inds)] = sup_x[t]
        mem_y[mem_count:mem_count + len(inds)] = sup_y[t]
        mem_count += len(inds)
        rec.update(memory_y=mem_y[:mem_count].cpu().clone(),
                   memory_x=mem_x[:mem_count].clone())
        out.append(rec)
    return {"sessions": out, "epochs": [r["epochs"] for r in out]}
