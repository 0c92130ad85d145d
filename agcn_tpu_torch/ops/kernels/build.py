"""Build and load the port's CUDA kernels.

Each source under `agcn_tpu_torch/ops/csrc/` is compiled by `nvcc` for
`sm_90a` into a shared library with a plain C interface, loaded with
`ctypes`. The build happens at first use, into `agcn_tpu_torch/build/`
(ignored by git), under a name that carries the hash of the source, so an
edited source is rebuilt and an unchanged one is not. `build_all` starts
one `nvcc` per source, all at once.

Nothing here runs at import: the CPU tests import every module, and this
machine's CPU-only PyTorch has no CUDA toolkit to call.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "ops" / "csrc"
BUILD_DIR = _PKG / "build"
# one shared library per source
SOURCES = {"gcn_fwd": "gcn_fwd.cu", "gcn_bwd": "gcn_bwd.cu",
           "logits": "logits.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass
class BuildResult:
    name: str
    path: Path
    seconds: float   # 0.0 when an up-to-date library was already there
    log: str         # nvcc's output (ptxas registers / shared memory)


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels build from source on the GPU machine")
    return found


def library_path(name: str) -> Path:
    src = CSRC_DIR / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=None) -> Dict[str, BuildResult]:
    """Compile every named source that has no up-to-date library, one
    `nvcc` per source started together. Raises on any compiler error."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results: Dict[str, BuildResult] = {}
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            results[name] = BuildResult(name, out, 0.0, "")
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
        results[name] = BuildResult(name, out, time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = build_all([name])[name].path
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    return lib
