"""The benchmark of the PyTorch/CUDA port on one card.

  python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

runs cell ``<cell>`` of ``BENCHMARK.json`` (its configuration, job and
traffic found by name under ``benchmark/``): set-up from the seed, a
window of ``<s>`` seconds, then the check of the window's output against
the plain reference in ``benchmark/reference/``.  It prints the run's
facts, then as the last line of standard output one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` a ``breakdown``, and ``checks``, each
number compared beside its limit.  The last lines of standard error
repeat the checks.  Without a CUDA card it exits with code 2 and prints
no result.
"""

import os
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]

# every cache the program or a library keeps goes inside the checkout, at
# a fixed path, so that only a cell's first run there builds anything
for _var, _dir in (("TRITON_CACHE_DIR", ".cache/triton"),
                   ("TORCH_EXTENSIONS_DIR", ".cache/torch_extensions")):
    os.environ.setdefault(_var, str(_ROOT / "benchmark" / _dir))
# a library that the port uses must not bring JAX in
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main())
