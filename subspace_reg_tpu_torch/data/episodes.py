"""Episode construction with the reference's exact np.random semantics.

This replaces the torch ``MetaImageNet``/``MetaTieredImageNet``/``MetaCIFAR100``
Dataset classes (reference dataset/mini_imagenet.py:182-429 etc.) with a
functional sampler that returns raw uint8 arrays; augmentation happens on
device (ops/augment.py).

Reproduced contracts:
  * per-episode determinism: ``np.random.seed(item)`` before sampling
    (mini_imagenet.py:311-312)
  * class list = insertion order of labels over the image array, then one
    seeded shuffle (mini_imagenet.py:266-276)
  * ``disjoint_classes`` mode consumes the class list 5 at a time — stateful
    mutation across calls (mini_imagenet.py:314-316)
  * base-exemplar mode samples n_base_support_samples per sorted class
    (mini_imagenet.py:281-307)
  * support tiling x n_aug_support_samples; each copy is independently
    augmented later (mini_imagenet.py:342-344)
  * labels stay global in 'few-shot-incremental-fine-tune' eval mode
    (mini_imagenet.py:327-330)
  * XtarNet exact-episode replay from episodes_{ways}_{shots}.txt
    (mini_imagenet.py:213-241,352-416)
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..utils.spans import span
from .mini_imagenet import SplitData


@dataclass
class Episode:
    support_x: np.ndarray   # (n_support, H, W, 3) uint8 — needs train transform
    support_y: np.ndarray   # (n_support,) int64
    query_x: np.ndarray     # (n_query, H, W, 3) uint8 — needs test transform
    query_y: np.ndarray     # (n_query,) int64
    # global indices into the split's image array (when available): lets the
    # engine gather episode images from a device-resident dataset instead of
    # uploading pixels per session
    support_idx: Optional[np.ndarray] = None
    query_idx: Optional[np.ndarray] = None


class EpisodeSampler:
    """Functional counterpart of MetaImageNet. ``get(item)`` is the
    counterpart of ``__getitem__`` under a batch_size-1 DataLoader +
    ``drop_a_dim`` (eval/util.py:131-138)."""

    def __init__(self, base: SplitData, opt, split: str,
                 phase: Optional[str] = None, fix_seed: bool = True,
                 use_episodes: bool = False, disjoint_classes: bool = False,
                 ref_meta_style: bool = False):
        # ref_meta_style=True reproduces MetaTieredImageNet/MetaCIFAR100
        # episode semantics EXACTLY (dataset/tiered_imagenet.py:126-198,
        # dataset/cifar.py:112-184), which differ from MetaImageNet in three
        # ways: no class-list shuffle at init (:274-275 is mini-only),
        # UNSORTED iteration over the sampled classes (tiered_imagenet.py:172
        # vs mini_imagenet.py:324's np.sort), and way-index labels always
        # (tiered/cifar have no eval_mode branch).  Byte-parity against the
        # reference classes: tests/test_reference_sampler_parity.py.
        self.ref_meta_style = ref_meta_style
        self.base = base
        self.opt = opt
        self.split = split
        self.phase = phase
        self.fix_seed = fix_seed
        self.use_episodes = use_episodes
        self.disjoint_classes = disjoint_classes
        self.n_ways = opt.n_ways
        self.n_shots = opt.n_shots
        self.n_queries = opt.n_queries
        self.n_test_runs = opt.n_test_runs
        self.eval_mode = opt.eval_mode
        self.n_aug_support_samples = opt.n_aug_support_samples
        self.n_base_aug_support_samples = getattr(
            opt, "n_base_aug_support_samples", 0)
        self.n_base_support_samples = getattr(opt, "n_base_support_samples", 0)
        self.label2human = base.label2human

        with span("srt.data.sampler"):
            # group images by label, preserving insertion order over the
            # array (mini_imagenet.py:266-271); global indices recorded in
            # parallel so episodes can be realized as device-side gathers
            self.data: Dict[int, List[np.ndarray]] = {}
            self.index: Dict[int, List[int]] = {}
            for idx in range(base.imgs.shape[0]):
                self.data.setdefault(base.labels[idx], []).append(
                    base.imgs[idx])
                self.index.setdefault(base.labels[idx], []).append(idx)
            self.classes = list(self.data.keys())

            if self.use_episodes:
                self._parse_episode_file()

            if self.fix_seed and not self.ref_meta_style:
                np.random.seed(opt.set_seed)
                np.random.shuffle(self.classes)

    # -- XtarNet exact-episode replay ------------------------------------
    def _parse_episode_file(self):
        self.episode_support_ids: List[List[int]] = []
        self.episode_query_ids: List[List[int]] = []
        path = os.path.join(
            self.opt.data_root,
            f"episodes_{self.n_ways}_{self.n_shots}.txt")
        with open(path, "r") as f:
            is_val = True
            for line in f.readlines():
                if line.startswith("TEST"):
                    is_val = False
                if ((self.split == "train" and self.phase == "val" and is_val)
                        or (self.split == "train" and self.phase == "test"
                            and not is_val)):
                    if line.startswith("Base Query"):
                        arr = re.split(": ", line)[1].rstrip()
                        arr = list(map(int, filter(
                            None, arr.lstrip("[").rstrip("]").split(" "))))
                        self.episode_query_ids.append(arr)
                if ((self.split == "val" and is_val)
                        or (self.split == "test" and not is_val)):
                    if line.startswith("Novel"):
                        arr = re.split(": ", line)[1].rstrip()
                        arr = list(map(int, filter(
                            None, arr.lstrip("[").rstrip("]").split(","))))
                        if line.startswith("Novel Support"):
                            self.episode_support_ids.append(arr)
                        else:
                            self.episode_query_ids.append(arr)

    # ---------------------------------------------------------------------
    def __len__(self):
        if self.split == "train" and self.phase == "train":
            if self.disjoint_classes:
                return 8
            return self.n_test_runs
        if self.use_episodes:
            return len(self.episode_query_ids)
        return self.n_test_runs

    def get(self, item: int) -> Episode:
        if not self.use_episodes:
            if (self.split == "train" and self.phase == "train"
                    and self.n_base_support_samples > 0):
                return self._base_exemplar_episode(item)
            return self._sampled_episode(item)
        return self._replayed_episode(item)

    # -- base-exemplar episodes (memory seeds) ----------------------------
    def _base_exemplar_episode(self, item: int) -> Episode:
        if self.fix_seed:
            np.random.seed(item)
        cls_sampled = np.random.choice(self.classes, len(self.classes), False)
        support_xs, support_ys, support_gids = [], [], []
        for cls in np.sort(cls_sampled):
            imgs = np.asarray(self.data[cls]).astype("uint8")
            ids = np.random.choice(range(imgs.shape[0]),
                                   self.n_base_support_samples, False)
            support_xs.append(imgs[ids])
            support_ys.append([cls] * self.n_base_support_samples)
            support_gids.append(np.asarray(self.index[cls])[ids])
        support_xs = np.array(support_xs)
        support_ys = np.array(support_ys)
        support_gids = np.concatenate(support_gids)
        h, w, c = support_xs.shape[-3:]
        support_xs = support_xs.reshape((-1, h, w, c))
        support_ys = support_ys.reshape((-1,))
        if self.n_base_aug_support_samples > 1:
            support_xs = np.tile(support_xs,
                                 (self.n_base_aug_support_samples, 1, 1, 1))
            support_ys = np.tile(support_ys,
                                 (self.n_base_aug_support_samples,))
            support_gids = np.tile(support_gids,
                                   (self.n_base_aug_support_samples,))
        return Episode(support_x=support_xs, support_y=support_ys,
                       query_x=support_xs, query_y=support_ys,  # dummy query
                       support_idx=support_gids, query_idx=support_gids)

    # -- regular / disjoint episodes ---------------------------------------
    def _sampled_episode(self, item: int) -> Episode:
        if self.fix_seed:
            np.random.seed(item)
        if self.disjoint_classes:
            cls_sampled = self.classes[: self.n_ways]
            self.classes = self.classes[self.n_ways:]
        else:
            cls_sampled = np.random.choice(self.classes, self.n_ways, False)
        support_xs, support_ys, query_xs, query_ys = [], [], [], []
        support_gids, query_gids = [], []
        # mini sorts the sampled classes (mini_imagenet.py:324); the
        # tiered/cifar meta classes iterate them in draw order
        # (tiered_imagenet.py:172, cifar.py:158)
        cls_iter = cls_sampled if self.ref_meta_style else np.sort(cls_sampled)
        for idx, cls in enumerate(cls_iter):
            imgs = np.asarray(self.data[cls]).astype("uint8")
            support_ids = np.random.choice(range(imgs.shape[0]),
                                           self.n_shots, False)
            support_xs.append(imgs[support_ids])
            support_gids.append(np.asarray(self.index[cls])[support_ids])
            lbl = idx
            if (not self.ref_meta_style
                    and self.eval_mode in ["few-shot-incremental-fine-tune"]):
                lbl = cls
            support_ys.append([lbl] * self.n_shots)
            query_ids = np.setxor1d(np.arange(imgs.shape[0]), support_ids)
            query_ids = np.random.choice(query_ids, self.n_queries, False)
            query_xs.append(imgs[query_ids])
            query_gids.append(np.asarray(self.index[cls])[query_ids])
            query_ys.append([lbl] * query_ids.shape[0])
        support_xs, support_ys = np.array(support_xs), np.array(support_ys)
        query_xs, query_ys = np.array(query_xs), np.array(query_ys)
        support_gids = np.concatenate(support_gids)
        query_gids = np.concatenate(query_gids)
        h, w, c = query_xs.shape[-3:]
        query_xs = query_xs.reshape((-1, h, w, c))
        query_ys = query_ys.reshape((-1,))
        support_xs = support_xs.reshape((-1, h, w, c))
        support_ys = support_ys.reshape((-1,))
        if self.n_aug_support_samples > 1:
            support_xs = np.tile(support_xs, (self.n_aug_support_samples, 1, 1, 1))
            support_ys = np.tile(support_ys, (self.n_aug_support_samples,))
            support_gids = np.tile(support_gids, (self.n_aug_support_samples,))
        return Episode(support_x=support_xs, support_y=support_ys,
                       query_x=query_xs, query_y=query_ys,
                       support_idx=support_gids, query_idx=query_gids)

    # -- exact-episode replay ----------------------------------------------
    def _replayed_episode(self, item: int) -> Episode:
        imgs = self.base.imgs
        labels = self.base.labels
        query_ids = self.episode_query_ids[item]
        query_xs = np.array(imgs[query_ids])
        query_ys = np.array([labels[i] for i in query_ids])
        h, w, c = query_xs.shape[-3:]
        query_xs = query_xs.reshape((-1, h, w, c))

        if self.split == "train" and self.phase in ("val", "test"):
            return Episode(support_x=query_xs, support_y=query_ys,
                           query_x=query_xs, query_y=query_ys,
                           support_idx=np.asarray(query_ids),
                           query_idx=np.asarray(query_ids))
        support_ids = self.episode_support_ids[item]
        support_xs = np.array(imgs[support_ids])
        support_ys = np.array([labels[i] for i in support_ids])
        assert len(np.unique(support_ys)) == self.n_ways
        support_xs = support_xs.reshape((-1, h, w, c))
        support_gids = np.asarray(support_ids)
        if self.n_aug_support_samples > 1:
            support_xs = np.tile(support_xs, (self.n_aug_support_samples, 1, 1, 1))
            support_ys = np.tile(support_ys.reshape((-1,)),
                                 (self.n_aug_support_samples,))
            support_gids = np.tile(support_gids, (self.n_aug_support_samples,))
        return Episode(support_x=support_xs, support_y=support_ys,
                       query_x=query_xs, query_y=query_ys,
                       support_idx=support_gids,
                       query_idx=np.asarray(query_ids))


def cycle_episodes(sampler: "EpisodeSampler"):
    """Endless episode iterator (reference get_batch_cycle /
    itertools.cycle over the DataLoader, eval/util.py:140-146,
    language_eval.py:110-111)."""
    item = 0
    n = max(len(sampler), 1)
    while True:
        yield sampler.get(item % n)
        item += 1


def get_vocabs(base_split: Optional[SplitData] = None,
               novel_split: Optional[SplitData] = None,
               query_ys: Optional[np.ndarray] = None):
    """Reference eval/util.py:112-129."""
    vocab_all: List[str] = []
    vocab_base = None
    if base_split is not None:
        vocab_base = [name for name in base_split.label2human if name != ""]
        vocab_all += vocab_base
    vocab_novel, orig2id = None, None
    if novel_split is not None:
        novel_ids = np.sort(np.unique(query_ys))
        label2human_novel = novel_split.label2human
        vocab_novel = [label2human_novel[i] for i in novel_ids]
        orig2id = dict(zip(novel_ids.tolist(),
                           (len(vocab_base) + np.arange(len(novel_ids))).tolist()))
        vocab_all += vocab_novel
    return vocab_base, vocab_all, vocab_novel, orig2id
