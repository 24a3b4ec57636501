"""eval.padded_row_pct: the share of the rows the engine put through the
backbone (epoch 1's train-mode forwards, the caches, the initial base
evaluation) that were replay rows past the memory's fill, from the
program's counters ``SessionProgram.rows_padded`` and ``rows_forwarded``.
They count every run of the process, the warm-up too, which leaves the
ratio as it is.  Nothing to read where the program has no such counter."""


def read(rec):
    try:
        from subspace_reg_tpu_torch.engine.incremental import SessionProgram
    except ImportError:
        return None
    forwarded = getattr(SessionProgram, "rows_forwarded", None)
    padded = getattr(SessionProgram, "rows_padded", None)
    if not forwarded or padded is None:
        return None
    return 100.0 * padded / forwarded
