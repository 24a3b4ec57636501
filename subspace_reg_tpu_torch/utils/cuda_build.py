"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source has a plain ``extern "C"`` launcher and is built
with ``nvcc`` into a shared library under ``subspace_reg_tpu_torch/_build/``
(listed in ``.gitignore``) at first use, then loaded with ``ctypes``.  The
library name carries a hash of the source and the flags, so an edited source
is rebuilt.  Nothing here runs at import time, and a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# kernel name -> source file under csrc/
SOURCES = {"finetune_loop": "finetune_loop.cu",
           "conv3x3_fused": "conv3x3_fused.cu",
           "block_tail": "block_tail.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "csrc/ at first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC_DIR / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Build the named kernels (default: all), one ``nvcc`` per source, all
    started together.  Returns per kernel: ``path``, ``seconds`` (0 when
    the library was already built) and ``ptxas`` (nvcc's -Xptxas -v
    report).  Raises if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out: Dict[str, dict] = {}
    t0 = time.time()
    for name in names:
        target = library_path(name)
        if target.exists():
            out[name] = {"path": str(target), "seconds": 0.0, "ptxas": ""}
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, target)
        out[name] = {"path": str(target), "seconds": time.time() - t0,
                     "ptxas": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built first if needed."""
    if name not in _LIBS:
        path = build_all([name])[name]["path"]
        _LIBS[name] = ctypes.CDLL(path)
    return _LIBS[name]
