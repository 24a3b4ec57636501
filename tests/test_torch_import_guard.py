"""The port stands alone: every module of subspace_reg_tpu_torch,
chip_smoke.py and the support module it shares with the tests
(tests/torch_support.py) import with JAX, flax, optax, msgpack, PIL,
pandas, orbax, tensorstore, zstandard, TensorBoard and protobuf (the card's
machine has none of them) and the JAX package blocked, and no source of
the port names one of them in an import."""

import ast
import os
import pkgutil
import subprocess
import sys

import subspace_reg_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(subspace_reg_tpu_torch.__file__)
BLOCKED = ("jax", "jaxlib", "flax", "optax", "msgpack", "PIL", "pandas",
           "orbax", "tensorstore", "zstandard", "tensorboard",
           "google.protobuf", "subspace_reg_tpu")


def _blocked(name: str) -> bool:
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG], prefix="subspace_reg_tpu_torch."))


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "subspace_reg_tpu_torch.engine.incremental" in mods
    assert "subspace_reg_tpu_torch.ops.finetune" in mods
    assert "subspace_reg_tpu_torch.engine.predict" in mods
    assert "subspace_reg_tpu_torch.utils.artifacts" in mods
    # the streamed loader (and csrc/staging.cpp's ctypes binding), the
    # mesh, the multi-seed trainer
    for name in ("data.native", "data.pipeline", "parallel.mesh",
                 "engine.multiseed_pretrain"):
        assert f"subspace_reg_tpu_torch.{name}" in mods, name
    # distillation, the mapping trainer and the .pth writer
    for name in ("distill", "distill.alias", "distill.criterion",
                 "distill.embed", "distill.nce", "learn_mapping",
                 "export_pth"):
        assert f"subspace_reg_tpu_torch.{name}" in mods, name
    # the parity gate and its fixture, the embedding tools
    for name in ("parity_gate", "run_parity_gate_fixture",
                 "utils.embed_tools", "inspect_embeds"):
        assert f"subspace_reg_tpu_torch.{name}" in mods, name
    # orbax directory checkpoints without orbax, the event files
    for name in ("utils.crc32c", "utils.zstd", "utils.ocdbt", "utils.zarr2",
                 "utils.checkpoint", "utils.logging"):
        assert f"subspace_reg_tpu_torch.{name}" in mods, name
    code = "\n".join(
        ["import sys, importlib"]
        + [f"sys.modules[{name!r}] = None" for name in BLOCKED]
        + [f"importlib.import_module({m!r})" for m in mods]
        + ["import chip_smoke",
           "import torch_support",
           "leaked = [m for m in sys.modules if sys.modules[m] is not None"
           f" and any(m == b or m.startswith(b + '.') for b in {BLOCKED!r})]",
           "assert not leaked, leaked",
           "print('ok', len(sys.modules))"])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_no_source_imports_the_jax_package():
    sources = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
               if f.endswith(".py")]
    sources += [os.path.join(REPO, "chip_smoke.py"),
                os.path.join(REPO, "tests", "torch_support.py")]
    bad = []
    for path in sources:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path}: {n}" for n in names if _blocked(n)]
    assert len(sources) > 20 and not bad, bad
