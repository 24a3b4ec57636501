"""The ±0.5%/session parity gate against recorded reference runs, on the
port: the counterpart of the repo's ``tools/parity_gate.py`` (its
``CONFIGS``, flags, trace parsers, comparison and report schema), running
the port's eval CLI in-process:

  python -m subspace_reg_tpu_torch.parity_gate \
      --data_root /path/with/miniImageNet \
      --backbones_dir /path/backbones/continual/resnet18 \
      --expected_dir /path/reference_outputs \
      [--configs subspace_reg semantic_subspace_reg fine_tune linear_mapping] \
      [--seeds 1 2 3] [--tolerance 0.5] [--out parity_report.json] \
      [--device cuda|cpu]

Layout (the reference's Slurm scripts): ``backbones_dir/<seed>/
resnet18_last.pth`` (a ``resnet18_last.ckpt`` of either package's
pretraining CLI serves too), ``expected_dir/<config>_seed_<seed>.out``
(the reference run's stdout with its ``Overall continual accuracies``,
``Novel only incremental`` and ``Base only incremental`` lines,
eval/language_eval.py:451-453) or ``.json`` files with keys {"overall":
[9], "novel": [8], "base": [8]}.  For each (config, seed) the gate runs
the golden hyperparameters (scripts/continual/*.sh), parses both traces
and reports the largest per-session deviation; without
``--expected_dir`` it only records.  Exit code 0 iff every deviation is
within tolerance.  ``linear_mapping`` trains and caches the
``mapping_linear_label2image`` backbone with the port's
``learn_mapping`` when it is missing.  The run is on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import sys

# golden hyperparameters, verbatim from scripts/continual/*.sh (which
# mirror the reference's slurm_*.sh)
_COMMON = [
    "--model", "resnet18", "--no_dropblock", "--n_shots", "5",
    "--classifier", "linear",
    "--eval_mode", "few-shot-incremental-fine-tune",
    "--min_novel_epochs", "20", "--freeze_backbone_at", "1",
    "--test_base_batch_size", "2000", "--continual", "--num_workers", "0",
    "--n_queries", "25", "--target_train_loss", "0.0",
    "--n_base_support_samples", "1", "--memory_replay", "1",
]

CONFIGS = {
    # slurm_fine_tune.sh:35-55 (wd 5e-3)
    "fine_tune": ["--learning_rate", "0.002", "--lmbd_reg_transform_w",
                  "0.2", "--lmbd_reg_novel", "0.1",
                  "--weight_decay", "5e-3"],
    # slurm_subspace_reg.sh:33-54
    "subspace_reg": ["--learning_rate", "0.002", "--lmbd_reg_transform_w",
                     "0.2", "--lmbd_reg_novel", "0.1", "--label_pull",
                     "1.0", "--attraction_override", "distance2subspace"],
    # slurm_semantic_subspace_reg.sh:36-59 (wd 5e-4)
    "semantic_subspace_reg": ["--learning_rate", "0.002",
                              "--lmbd_reg_transform_w", "0.2",
                              "--lmbd_reg_novel", "0.1", "--label_pull",
                              "0.2", "--glove", "--temperature", "3.0",
                              "--weight_decay", "5e-4"],
    # slurm_linear_mapping.sh:34-56 (--glove at :53: the mapping is
    # trained on the 300-d GloVe slice, so the evaluation slices to match)
    "linear_mapping": ["--learning_rate", "0.002",
                       "--lmbd_reg_transform_w", "0.2",
                       "--lmbd_reg_novel", "0.1", "--label_pull", "0.1",
                       "--glove", "--attraction_override",
                       "mapping_linear_label2image"],
}

TRACES = (("overall", "Overall continual accuracies"),
          ("novel", "Novel only incremental"),
          ("base", "Base only incremental"))


def parse_reference_out(text: str) -> dict:
    """The three printed traces of a reference run's stdout
    (eval/language_eval.py:451-453)."""
    out = {}
    for key, tag in TRACES:
        m = re.search(re.escape(tag) + r"\s*:\s*(\[[^\]]*\])", text)
        if not m:
            raise ValueError(f"trace '{tag}' not found in reference output")
        out[key] = [float(v) for v in ast.literal_eval(m.group(1))]
    return out


def load_expected(expected_dir: str, config: str, seed: int) -> dict:
    """The expected traces of (config, seed): ``.json`` first, then the
    ``.out``/``.txt``/``.log`` stdout."""
    stem = os.path.join(expected_dir, f"{config}_seed_{seed}")
    if os.path.exists(stem + ".json"):
        with open(stem + ".json") as f:
            d = json.load(f)
        return {k: [float(v) for v in d[k]] for k, _ in TRACES}
    for ext in (".out", ".txt", ".log"):
        if os.path.exists(stem + ext):
            with open(stem + ext) as f:
                return parse_reference_out(f.read())
    raise FileNotFoundError(f"no expected trace for {config} seed {seed} "
                            f"under {expected_dir} ({stem}.json/.out)")


def backbone_path(backbones_dir: str, seed: int, config: str,
                  word_embed_path=None, device: str = "cuda") -> str:
    """The backbone of (config, seed); ``linear_mapping`` trains its
    mapping into ``resnet18_last_with_mapping.pth`` when that is missing;
    a ``.ckpt`` of the pretraining CLI stands in for a missing ``.pth``."""
    name = ("resnet18_last_with_mapping.pth"
            if config == "linear_mapping" else "resnet18_last.pth")
    cand = os.path.join(backbones_dir, str(seed), name)
    if config == "linear_mapping" and not os.path.exists(cand):
        src = os.path.join(backbones_dir, str(seed), "resnet18_last.pth")
        if not os.path.exists(src):
            src = os.path.join(backbones_dir, str(seed),
                               "resnet18_last.ckpt")
        print(f"==> training linear mapping for seed {seed} "
              f"({src} -> {cand})")
        from .learn_mapping import main as learn_mapping_main
        argv = ["--model_path", src, "--save_path", cand,
                "--device", device]
        if word_embed_path:
            argv += ["--word_embed_path", word_embed_path]
        learn_mapping_main(argv)
    if not os.path.exists(cand):
        for alt in ("resnet18_last.ckpt", "resnet18_last"):
            p = os.path.join(backbones_dir, str(seed), alt)
            if os.path.exists(p):
                return p
    return cand


def run_config(config: str, seed: int, data_root: str, backbones_dir: str,
               word_embed_path, device: str = "cuda") -> dict:
    """The port's eval CLI on (config, seed) in this process; its traces."""
    from . import eval_incremental
    argv = list(_COMMON) + CONFIGS[config] + [
        "--model_path", backbone_path(backbones_dir, seed, config,
                                      word_embed_path, device),
        "--data_root", data_root, "--set_seed", str(seed),
        "--device", device]
    if word_embed_path:
        argv += ["--word_embed_path", word_embed_path]
    result = eval_incremental.main(argv)
    return {"overall": [float(v) for v in result.weighted_avg_l],
            "novel": [float(v) for v in result.acc_novel_list],
            "base": [float(v) for v in result.acc_base_list]}


def compare(ours: dict, ref: dict, tolerance: float):
    """(every trace within ``tolerance``, one report row a trace)."""
    rows = []
    ok = True
    for key, _ in TRACES:
        a, b = ours[key], ref[key]
        if len(a) != len(b):
            rows.append({"trace": key, "error":
                         f"length mismatch ours={len(a)} ref={len(b)}"})
            ok = False
            continue
        devs = [abs(x - y) for x, y in zip(a, b)]
        worst = max(devs) if devs else 0.0
        rows.append({"trace": key, "ours": a, "ref": b,
                     "max_abs_dev": worst, "within": worst <= tolerance})
        ok = ok and worst <= tolerance
    return ok, rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data_root", required=True)
    p.add_argument("--backbones_dir", required=True)
    p.add_argument("--expected_dir", default=None,
                   help="recorded reference outputs; omit to only run and "
                        "record our traces")
    p.add_argument("--word_embed_path", default=None)
    p.add_argument("--configs", nargs="+", default=list(CONFIGS),
                   choices=list(CONFIGS))
    p.add_argument("--seeds", nargs="+", type=int,
                   default=[1, 2, 3, 4, 5, 6, 7, 8, 9, 10])
    p.add_argument("--tolerance", type=float, default=0.5)
    p.add_argument("--out", default="parity_report.json")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    report = {"tolerance": args.tolerance, "runs": [], "all_within": True}
    for config in args.configs:
        for seed in args.seeds:
            print(f"\n===== {config} seed {seed} =====")
            ours = run_config(config, seed, args.data_root,
                              args.backbones_dir, args.word_embed_path,
                              args.device)
            entry = {"config": config, "seed": seed, "ours": ours}
            if args.expected_dir:
                ref = load_expected(args.expected_dir, config, seed)
                ok, rows = compare(ours, ref, args.tolerance)
                entry["comparison"] = rows
                entry["within_tolerance"] = ok
                report["all_within"] = report["all_within"] and ok
                print(f"  -> {'WITHIN' if ok else 'EXCEEDS'} "
                      f"±{args.tolerance}%")
            report["runs"].append(entry)

    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"\nreport: {args.out}")
    if args.expected_dir and not report["all_within"]:
        print("PARITY GATE FAILED")
        return 1
    print("PARITY GATE " + ("PASSED" if args.expected_dir
                            else "RECORDED (no expected_dir given)"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
