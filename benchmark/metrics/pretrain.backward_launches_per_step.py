"""pretrain.backward_launches_per_step: the kernel launches issued in a
step's backward (``srt.pretrain.backward``: ``zero_grad``, ``backward``),
over the steps traced with the host's operations.  Counted by time, from
any thread, since the autograd engine launches from its own.  Nothing to
read where the program opens no such range."""

from benchmark import spans


def read(rec):
    return spans.launches_per_step(rec, ("srt.pretrain.backward",))
