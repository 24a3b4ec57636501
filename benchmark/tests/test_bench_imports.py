"""Nothing the benchmark loads is JAX or the JAX package, and the
reference loads nothing of the program."""

import ast
import os
import subprocess
import sys

from bench_tiny import ROOT
from benchmark import harness

REFERENCE = ROOT / "benchmark" / "reference"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")


def test_reference_sources_import_nothing_of_the_program():
    for f in REFERENCE.glob("*.py"):
        for name in _imports(f):
            top = name.lstrip(".").split(".")[0]
            assert top not in ("subspace_reg_tpu_torch",) + harness.FORBIDDEN, \
                f"{f.name} imports {name}"
            if name.startswith(".."):
                # inside the benchmark: only its draws
                assert name in ("..", "..draws") or name.startswith(
                    "..draws"), f"{f.name} imports {name}"


def _fresh(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_the_reference_loads_nothing_of_the_program():
    last = _fresh(
        "import sys\n"
        "import benchmark.reference.fscil, benchmark.reference.pretrain\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert "subspace_reg_tpu_torch" not in last
    for bad in harness.FORBIDDEN:
        assert f"'{bad}'" not in last


def test_a_run_of_every_job_loads_no_jax():
    """Both jobs run end to end at tiny size in a fresh process, the
    readers and the calibration tool loaded too; then the top-level
    module names are compared whole."""
    last = _fresh(
        "import sys\n"
        "sys.path.insert(0, 'benchmark/tests')\n"
        "import bench_tiny\n"
        "from benchmark import calibrate, harness\n"
        "spec = harness.load_spec()\n"
        "for m in spec['per_layer']:\n"
        "    harness.metric_reader(m['name'])\n"
        "for w in ('eval-mini84', 'pretrain-mini84'):\n"
        "    assert bench_tiny.run(w, trace=True)['correct']\n"
        "print(harness.forbidden_modules())")
    assert last == "[]"


def test_the_check_compares_top_level_names_whole():
    sys.modules.setdefault("subspace_reg_tpu_torch_probe", sys)
    assert "subspace_reg_tpu" not in harness.forbidden_modules()
