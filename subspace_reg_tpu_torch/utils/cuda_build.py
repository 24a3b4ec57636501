"""Build and load the port's native code: its hand-written CUDA kernels
and its host libraries.

Each ``csrc/*.cu`` source has a plain ``extern "C"`` launcher and is built
with ``nvcc`` into a shared library under ``subspace_reg_tpu_torch/_build/``
(listed in ``.gitignore``) at first use, then loaded with ``ctypes``.  The
host libraries ``csrc/staging.cpp`` (the streamed loader's batch gather)
and ``csrc/zstd_decode.cpp`` (the zstd decoder of orbax checkpoints) are
built the same way with ``g++``.  The library name carries a hash of the
source, the headers under ``csrc/`` and the flags, so an edited source or
header is rebuilt.  Nothing here runs at import time, and a failed build
raises.
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
           "block_tail": "block_tail.cu",
           "conv_f32": "conv_f32.cu",
           "bn_train": "bn_train.cu"}
# kernels that one path runs together, built together: the evaluation's
# K1 and K4
BUILT_WITH = {"finetune_loop": ("conv_f32",), "conv_f32": ("finetune_loop",)}
# host libraries (g++, no CUDA) -> source file under csrc/
HOST_SOURCES = {"staging": "staging.cpp",
                "zstd_decode": "zstd_decode.cpp"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")

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


def gxx_path() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found: the host libraries are built from "
                       "csrc/*.cpp at first use and need a C++ compiler")


def _source(name: str) -> Path:
    return CSRC_DIR / (HOST_SOURCES.get(name) or SOURCES[name])


def _command(name: str, out: Path):
    src = _source(name)
    if name in HOST_SOURCES:
        return [gxx_path(), *GXX_FLAGS, "-o", str(out), str(src),
                "-lpthread"]
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(src)]


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, every header
    under csrc/ (any source may include one) and the flags."""
    h = hashlib.sha256(_source(name).read_bytes())
    if name in HOST_SOURCES:
        h.update(" ".join(GXX_FLAGS).encode())
    else:
        for header in sorted(CSRC_DIR.glob("*.cuh")):
            h.update(header.name.encode() + header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Build the named libraries (default: every CUDA kernel), one
    compiler per source, all started together.  Returns per library:
    ``path``, ``seconds`` (0 when it was already built) and ``ptxas``
    (nvcc's -Xptxas -v report; g++'s output for a host library).  Raises
    if any build fails."""
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
        cmd = _command(name, tmp)
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: {os.path.basename(proc.args[0])} exited "
                          f"{proc.returncode}\n{log}")
            continue
        os.replace(tmp, target)
        out[name] = {"path": str(target), "seconds": time.time() - t0,
                     "ptxas": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The named library, built first if needed, together with the
    libraries its path also runs (``BUILT_WITH``)."""
    if name not in _LIBS:
        path = build_all([name, *BUILT_WITH.get(name, ())])[name]["path"]
        _LIBS[name] = ctypes.CDLL(path)
    return _LIBS[name]
