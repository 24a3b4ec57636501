"""pretrain.bn_kernel_pct: the share of the train-mode BatchNorm forwards
that ran as K5, the hand-written train-mode BatchNorm + LeakyReLU kernel
pair (``ops/bn_train.py``), from the program's counters
``TorchBatchNorm.kernel_forwards`` and ``train_forwards``.  They count
every step of the process, the checked steps and the warm-up too, which
leaves the ratio as it is in a cell whose steps are all alike.  Nothing
to read where the program has no such counter."""


def read(rec):
    try:
        from subspace_reg_tpu_torch.models.layers import TorchBatchNorm
    except ImportError:
        return None
    total = getattr(TorchBatchNorm, "train_forwards", None)
    kernel = getattr(TorchBatchNorm, "kernel_forwards", None)
    if not total or kernel is None:
        return None
    return 100.0 * kernel / total
