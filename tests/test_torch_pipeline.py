"""The port's host-streamed loader (subspace_reg_tpu_torch/data/pipeline.py
::PrefetchLoader) against the device-data path's batching
(engine/pretrain.py::epoch_batches) and the JAX package's PrefetchLoader,
from the same ``np.random.RandomState``: identical batches, exactly, epoch
after epoch, with and without ``drop_last``.  An early ``break`` stops and
joins the producer thread; a producer's error reaches the consumer.  On a
card (``gpu``, skipped here) the pinned buffers are reused only after their
copies completed: a slow consumer sees every batch intact."""

import threading
import time

import numpy as np
import pytest
import torch

from subspace_reg_tpu_torch.data.pipeline import PrefetchLoader
from subspace_reg_tpu_torch.engine import pretrain as pt


def _store(n=70, img=5, seed=0):
    r = np.random.RandomState(seed)
    return (r.randint(0, 256, size=(n, img, img, 3)).astype(np.uint8),
            r.randint(0, 10, size=(n,)))


def _alive():
    return [t for t in threading.enumerate()
            if t.name == "PrefetchLoader" and t.is_alive()]


@pytest.mark.parametrize("drop_last", [True, False])
def test_epochs_equal_device_data_batches_and_jax(drop_last):
    # imported here: the card's machine, which runs the gpu test below,
    # has no JAX
    from subspace_reg_tpu.data.pipeline import PrefetchLoader as JaxLoader
    imgs, labels = _store()
    loader = PrefetchLoader(imgs, labels, 16, np.random.RandomState(3),
                            drop_last=drop_last, device="cpu")
    jloader = JaxLoader(imgs, labels, 16, np.random.RandomState(3),
                        drop_last=drop_last)
    rng = np.random.RandomState(3)
    assert len(loader) == len(jloader) == (4 if drop_last else 5)
    for _ in range(2):
        ours = list(loader.epoch())
        ref = list(pt.epoch_batches(rng, len(labels), 16, drop_last))
        theirs = list(jloader.epoch())
        assert len(ours) == len(ref) == len(theirs) == len(loader)
        for (x, y), idx, (jx, jy) in zip(ours, ref, theirs):
            assert x.dtype == torch.uint8 and y.dtype == torch.int64
            np.testing.assert_array_equal(x.numpy(), imgs[idx])
            np.testing.assert_array_equal(y.numpy(), labels[idx])
            np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
            np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    assert loader.n_batches == 2 * len(loader) and loader.wait_s >= 0
    assert not _alive()


def test_with_indices_yields_each_batchs_items():
    """``with_indices`` adds each batch's dataset items, the rows that
    ``epoch_batches`` draws from the same ``RandomState``, with a shard's
    rows cut alike."""
    imgs, labels = _store()
    for shard in (None, (1, 2)):
        loader = PrefetchLoader(imgs, labels, 16, np.random.RandomState(4),
                                device="cpu", shard=shard,
                                with_indices=True)
        ref = pt.epoch_batches(np.random.RandomState(4), len(labels), 16)
        for (x, y, items), idx in zip(loader.epoch(), ref):
            if shard is not None:
                idx = idx[8:]
            assert items.dtype == torch.int64
            np.testing.assert_array_equal(items.numpy(), idx)
            np.testing.assert_array_equal(x.numpy(), imgs[idx])
            np.testing.assert_array_equal(y.numpy(), labels[idx])
    assert not _alive()


def test_shard_yields_a_ranks_rows():
    imgs, labels = _store()
    full = list(PrefetchLoader(imgs, labels, 16, np.random.RandomState(5),
                               device="cpu").epoch())
    half = list(PrefetchLoader(imgs, labels, 16, np.random.RandomState(5),
                               device="cpu", shard=(1, 2)).epoch())
    for (x, y), (hx, hy) in zip(full, half):
        assert torch.equal(hx, x[8:]) and torch.equal(hy, y[8:])
    with pytest.raises(ValueError, match="shards"):
        PrefetchLoader(imgs, labels, 16, np.random.RandomState(0),
                       device="cpu", shard=(0, 3))


def test_early_break_joins_the_producer():
    """Breaking off after one batch of a long epoch, with the producer
    blocked on a full queue (depth 1): closing the epoch stops and joins
    the producer within the time limit."""
    imgs, labels = _store(n=4000, img=8)
    loader = PrefetchLoader(imgs, labels, 8, np.random.RandomState(0),
                            depth=1, device="cpu")
    t0 = time.time()
    for i, _ in enumerate(loader.epoch()):
        if i == 0:
            time.sleep(0.2)         # the producer fills the queue
            break
    assert time.time() - t0 < 5.0
    assert not _alive()
    # a second epoch runs in full after the broken one
    assert sum(1 for _ in loader.epoch()) == len(loader)


def test_producer_error_reaches_the_consumer():
    imgs, labels = _store()
    loader = PrefetchLoader(imgs.astype(np.float32), labels, 16,
                            np.random.RandomState(0), device="cpu")
    with pytest.raises(TypeError, match="uint8"):
        list(loader.epoch())
    assert not _alive()


@pytest.mark.gpu
def test_pinned_buffers_survive_a_slow_consumer():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda")
    imgs, labels = _store(n=600, img=32)
    loader = PrefetchLoader(imgs, labels, 16, np.random.RandomState(1),
                            depth=1, device=dev, with_indices=True)
    ref = pt.epoch_batches(np.random.RandomState(1), len(labels), 16)
    for (x, y, items), idx in zip(loader.epoch(), ref):
        torch.cuda._sleep(2_000_000)   # the consumer's stream lags
        assert x.device.type == "cuda"
        assert torch.equal(x.cpu(), torch.from_numpy(imgs[idx]))
        assert torch.equal(y.cpu(), torch.from_numpy(labels[idx]))
        assert torch.equal(items.cpu(), torch.from_numpy(idx))
