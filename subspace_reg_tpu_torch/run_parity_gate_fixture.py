"""Run the port's parity gate (``subspace_reg_tpu_torch.parity_gate``) end
to end on a synthesized fixture: the counterpart of the repo's
``tools/run_parity_gate_fixture.py`` with the port's pieces.

Without the real miniImageNet pickles and published backbones this drives
the gate's whole path (checkpoint discovery, the four golden
configurations, mapping training, trace parsing, the verdict) on assets
in the reference's own formats:

  1. synthesize miniImageNet (``all.pickle`` + ``class_labels.txt``, the
     full 500/50 continual geometry) and the word-embedding pickle
     (``data/synthetic.py``);
  2. pretrain a resnet18 with the port's CLI and export it to the
     reference's ``.pth`` (``export_pth``) under
     ``backbones/continual/resnet18/<seed>/`` (skipped where the ``.pth``
     is there already);
  3. run the gate in record mode and write its traces as reference-format
     stdout files (eval/language_eval.py:451-453);
  4. run the gate in compare mode against them: it passes iff the two
     runs agree within the tolerance on every session.

  python -m subspace_reg_tpu_torch.run_parity_gate_fixture \
      [--work_dir parity_fixture] [--img_size 84] [--epochs 2] \
      [--seeds 1] [--configs ...] [--out parity_report.json] \
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import time


def _fmt_trace(vals):
    return "[" + ", ".join(f"{v:.4f}" for v in vals) + "]"


def write_reference_out(path: str, ours: dict) -> None:
    """A recorded run's traces as the reference's stdout prints them."""
    with open(path, "w") as f:
        f.write("************* Training arguments *************\n"
                "... (recorded by run_parity_gate_fixture)\n"
                "Overall continual accuracies:  "
                f"{_fmt_trace(ours['overall'])}\n"
                "Novel only incremental:  "
                f"{_fmt_trace(ours['novel'])}\n"
                "Base only incremental:  "
                f"{_fmt_trace(ours['base'])}\n")


def _pretrain(args, data_root, backbones, seed):
    """Step 2 for ``seed``: the port's CLI, then ``.ckpt`` -> ``.pth``."""
    from . import export_pth, train_supervised
    pth = os.path.join(backbones, str(seed), "resnet18_last.pth")
    if os.path.exists(pth):
        return
    save = os.path.join(args.work_dir, f"pretrain_seed_{seed}")
    ckpts = glob.glob(os.path.join(save, "**", "resnet18_last.ckpt"),
                      recursive=True)
    if not ckpts:
        print(f"==> pretraining backbone seed {seed} ({args.epochs} "
              "epochs)")
        # DropBlock's geometry is the reference's at 84 px
        # (models/util.py:21-31); smaller sizes underflow it
        dropblock = [] if args.img_size >= 84 else ["--no_dropblock"]
        train_supervised.main([
            "--dataset", "miniImageNet", "--model", "resnet18",
            "--classifier", "linear", "--continual", "--no_linear_bias",
            *dropblock, "--data_root", data_root, "--model_path", save,
            "--tb_path", os.path.join(save, "tb"),
            "--epochs", str(args.epochs), "--batch_size", "64",
            "--set_seed", str(seed), "--num_workers", "0",
            "--device", args.device])
        ckpts = glob.glob(os.path.join(save, "**", "resnet18_last.ckpt"),
                          recursive=True)
    if not ckpts:
        raise RuntimeError(f"pretraining wrote no checkpoint under {save}")
    os.makedirs(os.path.dirname(pth), exist_ok=True)
    print(f"==> exporting {ckpts[0]} -> {pth}")
    export_pth.main(["--ckpt", ckpts[0], "--out", pth])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--work_dir", default="parity_fixture")
    p.add_argument("--img_size", type=int, default=84)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--seeds", nargs="+", type=int, default=[1])
    p.add_argument("--configs", nargs="+", default=None)
    p.add_argument("--tolerance", type=float, default=0.5)
    p.add_argument("--out", default="parity_report.json")
    p.add_argument("--fresh", action="store_true", help="wipe work_dir first")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from . import parity_gate
    from .data import synthetic

    if args.fresh and os.path.isdir(args.work_dir):
        shutil.rmtree(args.work_dir)
    os.makedirs(args.work_dir, exist_ok=True)
    data_root = os.path.join(args.work_dir, "data")
    embeds_dir = os.path.join(args.work_dir, "word_embeds")
    backbones = os.path.join(args.work_dir, "backbones", "continual",
                             "resnet18")
    expected = os.path.join(args.work_dir, "reference_outputs")
    configs = args.configs or list(parity_gate.CONFIGS)

    # ---- 1. assets in the reference's formats --------------------------
    mini_root = os.path.join(data_root, "miniImageNet")
    if not os.path.exists(os.path.join(mini_root, "all.pickle")):
        print("==> synthesizing miniImageNet "
              f"(100 cls x 560 @ {args.img_size}px, 500/50 continual split)")
        t0 = time.time()
        synthetic.make_mini_imagenet(mini_root, n_classes=100, per_class=560,
                                     img_size=args.img_size, seed=0)
        print(f"    {time.time() - t0:.1f}s")
    if not os.path.exists(os.path.join(embeds_dir,
                                       "miniImageNet_dim500.pickle")):
        synthetic.make_word_embeds(embeds_dir, n_classes=100)

    # ---- 2. backbones: pretrain + export to .pth -----------------------
    for seed in args.seeds:
        _pretrain(args, data_root, backbones, seed)

    gate = ["--data_root", data_root, "--backbones_dir", backbones,
            "--word_embed_path", embeds_dir, "--configs", *configs,
            "--seeds", *[str(s) for s in args.seeds],
            "--tolerance", str(args.tolerance), "--device", args.device]

    # ---- 3. record pass: the gate without expected_dir -----------------
    rec_out = os.path.join(args.work_dir, "parity_record.json")
    print("\n==> parity gate: RECORD pass")
    if parity_gate.main(gate + ["--out", rec_out]) != 0:
        raise RuntimeError("the record pass failed")
    os.makedirs(expected, exist_ok=True)
    with open(rec_out) as f:
        recorded = json.load(f)
    for run in recorded["runs"]:
        write_reference_out(os.path.join(
            expected, f"{run['config']}_seed_{run['seed']}.out"), run["ours"])

    # ---- 4. compare pass: the gate's verdict ---------------------------
    print("\n==> parity gate: COMPARE pass")
    rc = parity_gate.main(gate + ["--expected_dir", expected,
                                  "--out", args.out])

    with open(args.out) as f:
        report = json.load(f)
    import torch
    report["fixture"] = {
        "synthetic_miniImageNet": {"n_classes": 100, "per_class": 560,
                                   "img_size": args.img_size},
        "backbone": f"resnet18, {args.epochs} pretrain epochs, exported "
                    "via subspace_reg_tpu_torch.export_pth (.pth "
                    "interchange)",
        "expected_source": "reference-format stdout recorded from an "
                           "independent first execution (record pass)",
        "device": (torch.cuda.get_device_name(0) if args.device != "cpu"
                   else "cpu"),
    }
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"\nfixture report: {args.out} (rc={rc})")
    return rc


if __name__ == "__main__":
    sys.exit(main())
