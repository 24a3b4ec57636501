"""pretrain.graph_replay_pct: the share of the pretraining steps that ran
as a replay of the step's CUDA graph, from the program's counters
``StepRunner.graph_replays`` and ``graph_steps``
(``engine/pretrain.py``).  They count every step of the process, the
checked steps and the warm-up too: in a cell's run one eager step and the
captures stay out of the replays.  Nothing to read where the program has
no such counter or counted no step."""


def read(rec):
    try:
        from subspace_reg_tpu_torch.engine.pretrain import StepRunner
    except ImportError:
        return None
    steps = getattr(StepRunner, "graph_steps", None)
    replays = getattr(StepRunner, "graph_replays", None)
    if not steps or replays is None:
        return None
    return 100.0 * replays / steps
