"""Supervised backbone pretraining CLI of the port -- flag-compatible with
the repo's ``train_supervised.py`` (reference train_supervised.py:38-202),
plus ``--device`` (default ``cuda``; ``cpu`` runs the plain versions):

  python -m subspace_reg_tpu_torch.train_supervised --trial pretrain \
      --model_path save --tb_path tb --data_root data --classifier linear \
      --model resnet18 --save_freq 100 --continual --no_dropblock \
      --no_linear_bias --set_seed 1

miniImageNet (continual or not), tieredImageNet (``train_a``, with
``train_b`` pooled under ``--augment_pretrain_wtrainb``) and CIFAR-FS /
FC100 (continual, or the per-partition pickles).  A training split of at
most ``DEVICE_DATA_MAX_BYTES`` (default 2 GiB) lives on the device and
each step gathers its batch there (the device-data path); a larger one
(tieredImageNet at its real size) streams from the host through
``data.pipeline.PrefetchLoader``, batch for batch the same run.  The step
is the module path in bf16, as the JAX CLI builds it; the fused stages
1-2 (K2/K3) are reached through ``engine.pretrain.make_train_step(fused=
True)``.  Checkpoints are the JAX package's ``.ckpt`` (``<model>_last.ckpt``,
``ckpt_epoch_<e>.ckpt``) with the optimizer state and step, which the JAX
CLI's ``--reload_path`` and loaders read; ``--reload_path`` resumes from
either package's ``.ckpt`` and reproduces the uninterrupted run.

Under ``torchrun`` (one process a card) the CLI trains data-parallel on
a mesh of every rank (parallel/mesh.py; NCCL on cards, gloo with
``--device cpu``): ``--batch_size`` is the global batch, each rank steps
on its rows, rank 0 alone prints, logs and saves, and validation runs on
the replicated state:

  torchrun --nproc_per_node 8 -m subspace_reg_tpu_torch.train_supervised \
      <flags>

Distillation (JAX train_supervised.py:138-235): ``--distill kd`` adds the
KL term against a teacher loaded from ``--teacher_path`` (a reference
``.pth`` or either package's ``.ckpt``; ``--teacher_model`` defaults to
``--model``); ``--distill nce|crd`` trains two embed heads against two
memory banks of the training split's size, and its ``.ckpt`` carries the
heads and banks, so ``--reload_path`` resumes them.  A contrastive run on
a split above ``DEVICE_DATA_MAX_BYTES`` streams it through
``PrefetchLoader`` with each batch's items, the same run as on the device.
Under ``torchrun`` every rank loads the teacher and builds the embed
heads, banks and negative table (rank 0's are broadcast), each steps on
its rows of the global batch, and the contrastive step applies the global
batch's bank update on every rank (engine/pretrain.py).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import numpy as np
import torch

from .config import parse_option_supervised
from .data.cifar import load_cifar, load_cifar_continual
from .data.mini_imagenet import load_mini_imagenet
from .data.pipeline import PrefetchLoader
from .data.tiered_imagenet import load_tiered_imagenet
from .data.transforms import transforms_options
from .engine import pretrain as pt
from .engine.draws import TorchDraws
from .models.factory import create_model
from .parallel import mesh as mesh_lib
from .utils.checkpoint import load_any, load_checkpoint, save_checkpoint
from .utils.device import resolve_device
from .utils.logging import AverageMeter, MetricWriter


def device_data_max_bytes() -> int:
    """The largest training split staged on the device, from the
    ``DEVICE_DATA_MAX_BYTES`` environment variable (default 2 GiB), as the
    JAX CLI reads it (train_supervised.py:269-270).  A larger split
    streams from the host (``PrefetchLoader``)."""
    return int(os.environ.get("DEVICE_DATA_MAX_BYTES", 2 * 1024 ** 3))


def load_splits(opt, lazy: bool = False):
    """(train split, validation split, n_cls) per dataset, as the JAX CLI
    loads them (train_supervised.py:46-70).  ``lazy`` returns the
    continual splits' images as ``LazyRows`` views of the cached pickle
    (the multi-seed fan-out's one shared store)."""
    if opt.dataset == "miniImageNet":
        train = load_mini_imagenet(opt, split="train", phase="train",
                                   lazy=lazy)
        val = load_mini_imagenet(opt, split="train", phase="val",
                                 lazy=lazy)
        return train, val, 80 if opt.use_trainval else (
            60 if opt.continual else 64)
    if opt.dataset == "tieredImageNet":
        train = load_tiered_imagenet(opt, partition="train", phase="train")
        val = load_tiered_imagenet(opt, partition="train", phase="val")
        return train, val, 448 if opt.use_trainval else 351
    if opt.dataset in ("CIFAR-FS", "FC100"):
        if opt.continual:
            return (load_cifar_continual(opt, split="train", phase="train",
                                         lazy=lazy),
                    load_cifar_continual(opt, split="train", phase="val",
                                         lazy=lazy),
                    60)
        train = load_cifar(opt, partition="train")
        return train, load_cifar(opt, partition="val"), max(train.labels) + 1
    raise NotImplementedError(opt.dataset)


def load_teacher(opt, n_cls: int, device):
    """The distillation teacher ``(module, head_w, head_b)`` of
    ``--teacher_path`` (JAX train_supervised.py:138-173): a bf16
    ``--teacher_model`` (default ``--model``) in eval mode on ``device``,
    block counters 0 where the checkpoint has none, and the head's active
    rows.  ``--distill kd`` needs the run's class count."""
    if not opt.teacher_path:
        raise ValueError(f"--distill {opt.distill} requires --teacher_path")
    t_sd, t_head, _ = load_any(opt.teacher_path)
    t_name = opt.teacher_model or opt.model
    module = create_model(t_name, opt, dataset=opt.dataset,
                          dtype=torch.bfloat16)
    module.load_state_dict(t_sd)
    module.to(device).eval()
    n_t = int(t_head.n_active)
    t_w = t_head.weight[:n_t].to(device)
    t_b = None if t_head.bias is None else t_head.bias[:n_t].to(device)
    if opt.distill == "kd":
        if n_t != n_cls:
            raise ValueError(
                f"--distill kd needs a teacher trained on the same classes: "
                f"teacher head has {n_t}, this run trains {n_cls}")
        print(f"==> KD teacher: {t_name} ({n_t} classes), "
              f"T={opt.kd_T} alpha={opt.kd_alpha} beta={opt.kd_beta}")
    else:
        print(f"==> {opt.distill.upper()} teacher: {t_name}, "
              f"feat_dim={opt.feat_dim} K={opt.nce_k} T={opt.nce_t} "
              f"m={opt.nce_m} alpha={opt.kd_alpha} beta={opt.kd_beta}")
    return module, t_w, t_b


def main(argv=None):
    opt = parse_option_supervised(argv)
    device = resolve_device(opt.device)
    mesh = None
    own_group = False
    if mesh_lib.under_torchrun():
        # one process a card: a data-parallel mesh of every rank
        own_group = not torch.distributed.is_initialized()
        device = mesh_lib.init_distributed(device.type)
        mesh = mesh_lib.create_mesh(device=device)
    try:
        if mesh is not None and mesh.rank != 0:
            # rank 0 alone prints
            with open(os.devnull, "w") as sink, \
                    contextlib.redirect_stdout(sink):
                return _train(opt, device, mesh)
        return _train(opt, device, mesh)
    finally:
        if own_group:
            torch.distributed.destroy_process_group()


def _train(opt, device, mesh):
    rank0 = mesh is None or mesh.rank == 0
    print("************* Training arguments *************")
    for k, v in vars(opt).items():
        print(k, v)
    print("End of arguments.\n")
    if mesh is not None:
        print(f"==> mesh {mesh.n_data}x{mesh.n_model} over "
              f"{mesh.world_size} ranks ({torch.distributed.get_backend()})")
        if opt.batch_size % mesh.n_data:
            raise ValueError(f"--batch_size {opt.batch_size} does not split "
                             f"over {mesh.n_data} ranks")

    np.random.seed(opt.set_seed)

    # ---- data -----------------------------------------------------------
    train_split, val_split, n_cls = load_splits(opt)
    train_spec, test_spec = transforms_options[opt.transform]
    train_labels = np.asarray(train_split.labels, np.int64)
    val_labels = np.asarray(val_split.labels, np.int64)
    n_train = len(train_labels)
    steps_per_epoch = n_train // opt.batch_size

    # ---- label-pull embeddings (train_supervised.py:100-118) -----------
    pull_embeds = None
    if opt.label_pull is not None:
        from .models.embeds import get_embeds
        vocab = [n for n in train_split.label2human if n != ""]
        pth = os.path.join(opt.word_embed_path,
                           f"{opt.dataset}_dim{opt.word_embed_size}.pickle")
        e = np.asarray(get_embeds(pth, vocab, opt.word_embed_size),
                       np.float32)
        if opt.glove:
            e = e[:, :300]
        pull_embeds = torch.from_numpy(e).to(device)

    # ---- model / optimizer ---------------------------------------------
    torch.manual_seed(opt.set_seed)
    backbone = create_model(opt.model, opt, dataset=opt.dataset,
                            dtype=torch.bfloat16)
    sched = pt.make_schedule(opt, steps_per_epoch)
    state = pt.init_pretrain_state(
        backbone, n_cls, pt.make_tx(opt), with_bias=opt.linear_bias,
        generator=torch.Generator().manual_seed(opt.set_seed),
        device=device)
    # resume (JAX train_supervised.py:112-136): parameters, BN statistics,
    # counters, the optimizer state and the step, whose per-step draws
    # follow from it; a contrastive run restores the optimizer, step, embed
    # heads and banks after init_nce_training (:193-220)
    contrastive = opt.distill in ("nce", "crd")
    start_epoch = 1
    if opt.reload_path:
        reloaded = load_checkpoint(opt.reload_path)
        start_epoch = pt.restore_pretrain_state(state, *reloaded,
                                                optimizer=not contrastive)
        print(f"==> resumed from {opt.reload_path} at epoch {start_epoch}")

    # ---- distillation teacher and contrastive state (:138-220) ---------
    teacher = load_teacher(opt, n_cls, device) \
        if opt.distill != "none" else None
    nce_state = None
    if contrastive:
        state, embed_s, embed_t, nce_state = pt.init_nce_training(
            torch.Generator().manual_seed(opt.set_seed + 1), state,
            pt.make_tx(opt), teacher_feat_dim=teacher[0].feature_dim,
            student_feat_dim=backbone.feature_dim, feat_dim=opt.feat_dim,
            n_data=n_train, nce_k=opt.nce_k, nce_t=opt.nce_t,
            nce_m=opt.nce_m, device=device)
        neg_table = tuple(torch.from_numpy(a).to(device).long() for a in
                          pt.build_negative_table(train_labels, n_cls))
        if opt.reload_path:
            restored = pt.restore_contrastive(state, reloaded[2], device)
            if restored is not None:
                nce_state = restored
                print("==> resumed contrastive state "
                      "(optimizer + embed heads + NCE banks)")
            else:
                print("==> WARNING: checkpoint has no contrastive state; "
                      "optimizer/banks start fresh")
    if mesh is not None:
        # every rank starts from rank 0's state
        mesh_lib.replicate_tree(mesh, state.backbone)
        mesh_lib.replicate_tree(mesh, state.head)
        if contrastive:
            mesh_lib.replicate_tree(mesh, [state.embed_s, state.embed_t,
                                           *vars(nce_state).values()])
    eval_step = pt.make_eval_step(
        backbone, test_spec, with_bias=opt.linear_bias,
        truncate_classes=(200 if (opt.dataset == "tieredImageNet"
                                  and opt.augment_pretrain_wtrainb)
                          else None),
        faithful_nbt=opt.faithful_nbt)

    logger = MetricWriter(opt.tb_folder) if rank0 else None
    rng_np = np.random.RandomState(opt.set_seed)
    # the skipped epochs' shuffles, so a resumed run draws the batches of
    # the uninterrupted one (JAX train_supervised.py:258-262)
    for _ in range(start_epoch - 1):
        rng_np.permutation(n_train)

    step_kw = dict(with_bias=opt.linear_bias,
                   draws=TorchDraws(opt.set_seed, device), mesh=mesh)
    if contrastive:
        step_nce = pt.make_train_step_nce(
            backbone, sched, train_spec, teacher=teacher, embed_s=embed_s,
            embed_t=embed_t, n_data=n_train, nce_k=opt.nce_k,
            kd_alpha=opt.kd_alpha, kd_beta=opt.kd_beta, mode=opt.distill,
            **step_kw)

        def nce_step(st, run, *args):
            # the banks thread through the steps
            nonlocal nce_state
            nce_state, m = run(st, nce_state, *args)
            return m
    else:
        step_kw.update(label_pull=opt.label_pull, pull_embeds=pull_embeds,
                       teacher=teacher, kd_temperature=opt.kd_T,
                       kd_alpha=opt.kd_alpha, kd_beta=opt.kd_beta)
    if train_split.imgs.nbytes <= device_data_max_bytes():
        # the dataset on the device: each step sends only its index
        # vector (every rank of a mesh holds the whole store and gathers
        # its shard of the index vector)
        print(f"==> staging dataset on {device} "
              f"({train_split.imgs.nbytes / 1e6:.0f} MB)")
        data_dev = torch.from_numpy(
            np.ascontiguousarray(train_split.imgs)).to(device)
        labels_dev = torch.from_numpy(train_labels).to(device)
        val_imgs = torch.from_numpy(
            np.ascontiguousarray(val_split.imgs)).to(device)
        loader = None
        if not contrastive:
            step_dd = pt.make_train_step_device_data(backbone, sched,
                                                     train_spec, **step_kw)

        def batches():
            for idxs in pt.epoch_batches(rng_np, n_train, opt.batch_size):
                idxs_dev = torch.from_numpy(idxs).to(device)
                if contrastive:
                    yield len(idxs), nce_step, (
                        step_nce.device_data, data_dev, labels_dev,
                        neg_table, idxs_dev)
                else:
                    yield len(idxs), step_dd, (data_dev, labels_dev,
                                               idxs_dev)
    else:
        # host-streamed (JAX train_supervised.py:315-326): the loader
        # draws the same permutation per epoch from rng_np; a contrastive
        # step also takes each batch's items, the rows of its banks
        print(f"==> streaming dataset from the host "
              f"({train_split.imgs.nbytes / 1e6:.0f} MB)")
        loader = PrefetchLoader(
            train_split.imgs, train_labels, opt.batch_size, rng_np,
            device=device,
            shard=None if mesh is None else (mesh.data_index, mesh.n_data),
            with_indices=contrastive)
        val_imgs = val_split.imgs
        n_data = 1 if mesh is None else mesh.n_data
        if not contrastive:
            step_host = pt.make_train_step(backbone, sched, train_spec,
                                           **step_kw)

        def batches():
            for batch in loader.epoch():
                if contrastive:
                    yield len(batch[0]) * n_data, nce_step, (
                        step_nce, *batch, neg_table)
                else:
                    yield len(batch[0]) * n_data, step_host, batch

    def save(epoch, final=False):
        meta = {}
        if opt.continual:
            meta = dict(training_classes=train_split.basec_map,
                        label2human=train_split.label2human)
        meta["epoch"] = epoch
        name = (f"{opt.model}_last.ckpt" if final
                else f"ckpt_epoch_{epoch}.ckpt")
        variables, head, extra = pt.checkpoint_parts(state, nce_state)
        save_checkpoint(os.path.join(opt.save_folder, name), variables,
                        head, meta, extra=extra)
        print("==> Saved", name)

    def log_value(*args):
        if logger is not None:
            logger.log_value(*args)

    # ---- training loop (train_supervised.py:156-202) --------------------
    for epoch in range(start_epoch, opt.epochs + 1):
        if not opt.eval_only:
            print("==> training...")
            t0 = time.time()
            lm, a1m, a5m = AverageMeter(), AverageMeter(), AverageMeter()
            n_img = 0
            for bi, (bsz, step, args) in enumerate(batches()):
                m = step(state, *args)
                n_img += bsz
                if bi % opt.print_freq == 0:
                    lm.update(float(m["loss"]), bsz)
                    a1m.update(float(m["acc1"]), bsz)
                    a5m.update(float(m["acc5"]), bsz)
                    print(f"Epoch: [{epoch}][{bi}/{steps_per_epoch}]\t"
                          f"Loss {lm.val:.4f} ({lm.avg:.4f})\t"
                          f"Acc@1 {a1m.val:.3f} ({a1m.avg:.3f})\t"
                          f"Acc@5 {a5m.val:.3f} ({a5m.avg:.3f})")
                    sys.stdout.flush()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.time() - t0
            ips = n_img / dt
            print(f"epoch {epoch}, total time {dt:.2f}, "
                  f"images/sec {ips:.1f}")
            if loader is not None and loader.n_batches:
                print(f"loader: mean wait for a batch "
                      f"{1e3 * loader.wait_s / loader.n_batches:.3f} ms")
            print(f" * Acc@1 {a1m.avg:.3f} Acc@5 {a5m.avg:.3f}")
            log_value("train_acc", a1m.avg, epoch)
            log_value("train_loss", lm.avg, epoch)
            log_value("images_per_sec", ips, epoch)

        # every rank validates its replica, which keeps the replicas'
        # counters equal under --faithful_nbt
        vm = pt.run_validation(eval_step, state, val_imgs, val_labels,
                               opt.batch_size // 2)
        if opt.faithful_nbt:
            vm, state = vm
        print(f" * Val Acc@1 {vm['acc1']:.3f} Acc@5 {vm['acc5']:.3f}")
        log_value("test_acc", vm["acc1"], epoch)
        log_value("test_acc_top5", vm["acc5"], epoch)
        log_value("test_loss", vm["loss"], epoch)

        if epoch % opt.save_freq == 0 and rank0:
            save(epoch)

    if rank0:
        save(opt.epochs, final=True)
        logger.close()
    return state


if __name__ == "__main__":
    main()
