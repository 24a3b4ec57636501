"""pretrain.loader_wait_ms: the streamed loader's own counters over the
window: the seconds the training loop waited for a batch
(``PrefetchLoader.wait_s``) over the batches it took (``n_batches``), in
ms.  Nothing to read where no loader runs."""


def read(rec):
    n = rec.get("loader_batches", 0)
    if not n:
        return None
    return 1e3 * rec["loader_wait_s"] / n
