"""Host-streamed input pipeline with background prefetch.

Counterpart of the JAX package's ``data/pipeline.py``: for a training split
too large to stage on the device, the host shuffles, gathers each uint8
batch with the native gather (data/native.py) and copies it to the card
ahead of the training loop; augmentation stays on the device.

On a CUDA device a producer thread gathers each batch into one of
``depth + 1`` pinned host buffers, starts a ``non_blocking`` host-to-device
copy on a side stream and records an event; the consumer's stream waits on
that event before it uses the batch.  A pinned buffer is written again only
after its copy's event has completed.  On the CPU the batches are gathered
into fresh arrays (no pinned memory, no streams).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from . import native

# how long a blocked producer sleeps between checks of the stop flag, and
# how long closing an epoch waits for the producer to end
_POLL_S = 0.05
_JOIN_S = 30.0


class PrefetchLoader:
    """Iterates (x_u8, y) device batches of one epoch with ``depth``-deep
    prefetch: x (B, H, W, C) uint8, y (B,) int64; with ``with_indices``,
    (x_u8, y, items) with the batch's dataset items (B,) int64 (the
    contrastive step's memory-bank rows).

    ``rng`` is the ``np.random.RandomState`` the caller shuffles with: each
    ``epoch()`` draws one ``rng.permutation(n)``, as the device-data path
    does (engine/pretrain.py::epoch_batches), so the two paths see the same
    batches.  ``shard=(index, count)`` yields only rows
    ``[index * B / count, (index + 1) * B / count)`` of each batch of B
    (a data-parallel rank's rows, parallel/mesh.py)."""

    def __init__(self, imgs: np.ndarray, labels, batch_size: int,
                 rng: np.random.RandomState, drop_last: bool = True,
                 depth: int = 2, device="cuda",
                 shard: Optional[Tuple[int, int]] = None,
                 with_indices: bool = False):
        if not isinstance(imgs, np.ndarray):
            imgs = np.asarray(imgs)
        self.imgs = np.ascontiguousarray(imgs)
        self.labels = np.asarray(labels, np.int64)
        if len(self.labels) != len(self.imgs):
            raise ValueError(f"{len(self.imgs)} images, {len(self.labels)} "
                             "labels")
        self.batch_size = batch_size
        self.rng = rng
        self.drop_last = drop_last
        self.depth = max(1, int(depth))
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the producer thread sets this device as its current one
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.shard = shard
        self.with_indices = with_indices
        if shard is not None and batch_size % shard[1]:
            raise ValueError(f"batch {batch_size} does not split into "
                             f"{shard[1]} shards")
        # the consumer's seconds blocked waiting for a batch, and batches
        self.wait_s = 0.0
        self.n_batches = 0
        self._pinned = None

    def __len__(self):
        n = len(self.labels)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def _rows(self, idxs: np.ndarray) -> np.ndarray:
        if self.shard is None:
            return idxs
        index, count = self.shard
        per = len(idxs) // count
        return idxs[index * per:(index + 1) * per]

    def _pinned_buffers(self):
        """``depth + 1`` pinned (x, y, items) host buffers at the largest
        batch and the event of each one's last copy, made once per
        loader."""
        if self._pinned is None:
            rows = self.batch_size // (self.shard[1] if self.shard else 1)
            self._pinned = [
                ((torch.empty((rows,) + self.imgs.shape[1:],
                              dtype=torch.uint8, pin_memory=True),
                  torch.empty((rows,), dtype=torch.int64, pin_memory=True),
                  torch.empty((rows,), dtype=torch.int64, pin_memory=True)),
                 None)
                for _ in range(self.depth + 1)]
        return self._pinned

    def epoch(self) -> Iterator[Tuple[torch.Tensor, ...]]:
        n = len(self.labels)
        order = self.rng.permutation(n)
        end = (n // self.batch_size) * self.batch_size if self.drop_last \
            else n
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None
        slots = self._pinned_buffers() if cuda else None
        n_out = 3 if self.with_indices else 2

        def put(item) -> bool:
            # a blocked put wakes up to see the stop flag
            while not stop.is_set():
                try:
                    q.put(item, timeout=_POLL_S)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            for k, i in enumerate(range(0, end, self.batch_size)):
                if stop.is_set():
                    return
                idxs = self._rows(order[i:i + self.batch_size])
                if not cuda:
                    batch = (torch.from_numpy(native.gather_u8(self.imgs,
                                                               idxs)),
                             torch.from_numpy(self.labels[idxs]),
                             torch.from_numpy(idxs.astype(np.int64)))
                    item = (batch[:n_out], None)
                else:
                    s = k % len(slots)
                    host, done = slots[s]
                    if done is not None:
                        # the buffer's previous copy must have finished
                        done.synchronize()
                    hx, hy, hi = (h[:len(idxs)] for h in host)
                    native.gather_u8(self.imgs, idxs, out=hx.numpy())
                    hy.numpy()[:] = self.labels[idxs]
                    hi.numpy()[:] = idxs
                    with torch.cuda.stream(side):
                        batch = tuple(h.to(self.device, non_blocking=True)
                                      for h in (hx, hy, hi)[:n_out])
                        ev = torch.cuda.Event()
                        ev.record(side)
                    slots[s] = (host, ev)
                    item = (batch, ev)
                if not put(item):
                    return
            put(None)

        def producer():
            try:
                if cuda:
                    torch.cuda.set_device(self.device)
                produce()
            except Exception as e:  # raised by the consumer
                put(e)

        t = threading.Thread(target=producer, daemon=True,
                             name="PrefetchLoader")
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self.wait_s += time.perf_counter() - t0
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                batch, ev = item
                if ev is not None:
                    cur = torch.cuda.current_stream(self.device)
                    cur.wait_event(ev)
                    # the allocator must not hand the batch's tensors to
                    # the side stream again before the consumer's work on
                    # them is done
                    for tensor in batch:
                        tensor.record_stream(cur)
                self.n_batches += 1
                yield batch
        finally:
            stop.set()
            t.join(timeout=_JOIN_S)
            if t.is_alive():
                raise RuntimeError("the loader's producer thread did not "
                                   f"stop within {_JOIN_S} s")
