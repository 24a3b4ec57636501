"""pretrain.optimizer_launches_per_step: the kernel launches the host
issues in a step's ``optimizer.step()`` (``srt.pretrain.optimizer``),
over the steps traced with the host's operations.  Nothing to read where
the program opens no such range."""

from benchmark import spans


def read(rec):
    return spans.launches_per_step(rec, ("srt.pretrain.optimizer",))
