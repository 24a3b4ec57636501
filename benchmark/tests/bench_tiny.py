"""Tiny sizes of the cells for the CPU tests: the same jobs, references
and checks, at the sizes the configuration's backbone reference gives
(``TINY``; the resnet: widths 8-16-24-80 at 16 px)."""

import contextlib
import io
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark.reference import backbone  # noqa: E402

EVAL_ARGS = ["--n_queries", "4", "--test_base_batch_size", "200",
             "--max_novel_epochs", "30", "--min_novel_epochs", "5",
             "--stable_epochs", "3", "--convergence_epsilon", "1e-2",
             "--learning_rate", "0.01"]


def overrides(cell: str, root: Path = ROOT, spec=None) -> dict:
    spec = spec or harness.load_spec(root / "BENCHMARK.json")
    c = harness.find_cell(spec, cell, root)
    cfg = c.config
    tiny = backbone.of(cfg).TINY
    if c.workload["job"] == "eval":
        ev = dict(cfg["eval"], base_test_n=400, base_train_per_class=3,
                  novel_per_class=40, n_novel_classes=40, n_queries=4,
                  max_novel_epochs=30)
        if ev["n_base"] > 60:
            ev["n_base"] = 60
        return {"config": dict(tiny, eval=ev), "sizes": tiny,
                "workload": {"argv": c.workload["argv"] + EVAL_ARGS}}
    pre = dict(cfg["pretrain"], n_train=640, batch_size=16,
               n_cls=min(cfg["pretrain"]["n_cls"], 60))
    return {"config": dict(tiny, pretrain=pre), "sizes": tiny}


def run(cell: str, seed: int = 7, seconds: float = 0.3, trace=False,
        root: Path = ROOT, spec=None, **extra) -> dict:
    import torch
    torch.set_num_threads(2)
    ov = overrides(cell, root, spec)
    ov.update(extra)
    with contextlib.redirect_stdout(io.StringIO()):
        return harness.run_cell(cell, seed, seconds, trace, device="cpu",
                                spec=spec, overrides=ov,
                                t_started=time.time(), root=root)


def with_streamed_cell(spec: dict) -> dict:
    """``spec`` with the streamed pretraining cell that waits for a later
    PR (its workload file and its loader metric's reader are in place)."""
    import json
    new = json.loads(json.dumps(spec))
    cell = "pretrain-tiered84-streamed"
    new["workloads"].append({"name": cell, "config": "resnet18-tiered84",
                             "traffic": cell, "chips": 1, "why": "later"})
    for m in new["end_to_end"] + new["per_layer"]:
        if "pretrain-mini84" in m.get("workloads", []):
            m["workloads"].append(cell)
    new["per_layer"].append({
        "name": "pretrain.loader_wait_ms", "unit": "ms/batch",
        "better": "lower", "source": "program_counter",
        "layer": "data.pipeline", "moves": "pretrain_images_per_s",
        "workloads": [cell]})
    return new
