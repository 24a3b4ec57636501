"""pretrain.augment_launches_per_step: the kernel launches the host
issues for a step's input: the batch's row gather from the store on the
card (``srt.pretrain.gather``) and the augmentation
(``srt.pretrain.augment``: the schedule, the draws, ``augment_batch``,
the permute), over the steps traced with the host's operations.
Nothing to read where the program opens no such range."""

from benchmark import spans


def read(rec):
    return spans.launches_per_step(
        rec, ("srt.pretrain.augment", "srt.pretrain.gather"))
