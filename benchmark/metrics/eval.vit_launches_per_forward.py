"""eval.vit_launches_per_forward: the kernel launches the host issues
inside the program's ``srt.vit.forward`` ranges (one a backbone forward
of the ViT: embedding, blocks, final LayerNorm), over the number of those
ranges, in the traced runs.  Nothing to read where the program opens no
such range."""

from benchmark import spans

NAMES = ("srt.vit.forward",)


def read(rec):
    trace = next((t for t in rec.get("traces") or []
                  if t.host_window_s is None and t.device), None)
    if trace is None or rec.get("runs", 0) <= 0:
        return None
    forwards = len(spans.ranges(trace, NAMES))
    n = spans.launches_in(trace, NAMES)
    if not forwards or n is None:
        return None
    return n / forwards
