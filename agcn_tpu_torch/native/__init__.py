"""Native host kernels of the port: ctypes bindings to `skelio.cpp` in this
package (port of agcn_tpu/native/__init__.py).

The library is built at first use by g++ with the JAX package's flags
(`GXX_FLAGS`), so the two packages' libraries give bit-equal results. It
goes into `agcn_tpu_torch/build/` (ignored by git) under a name that
carries a hash of the source, the flags and the host CPU's instruction
set (`-march=native` builds for the CPU it runs on): an edited source, or
a checkout copied to another machine, is rebuilt; an unchanged one is
not. It is written under a temporary name and renamed, so processes that
build at once never load a partial file. Nothing builds or loads at
import.

When it fails:
- no g++ on the PATH (and no library built before): `available()` is
  False, `pre_normalize` returns None, `parse_skeleton` parses in Python
  and `flatten_persons` runs the numpy loop of
  `data/sgn_collate.SegmentSampler`, so the callers take numpy, as in the
  JAX package;
- a compiler error, or a library that does not load, raises RuntimeError
  with g++'s output. It never quietly gives way to numpy.

`pre_normalize.calls`, `parse_skeleton.calls` and `flatten_persons.calls`
count the calls that ran the C function.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "skelio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
GXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared",
             "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_FLOAT_P = ctypes.POINTER(ctypes.c_float)


def _cpu_flags() -> bytes:
    """The host CPU's feature list (Linux), which `-march=native` follows."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith((b"flags", b"Features")):
                    return line
    except OSError:
        pass
    return platform.machine().encode()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(GXX_FLAGS).encode()
                            + _cpu_flags()).hexdigest()[:12]
    return BUILD_DIR / f"libskelio-{digest}.so"


def build() -> Optional[Path]:
    """The library's path, compiled first unless an up-to-date one is
    there; None when there is no g++. Raises on a compiler error."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ could not build {SOURCE} (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    return out


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None without g++."""
    global _lib
    if _lib is None:
        path = build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise RuntimeError(f"the native library {path} does not load: "
                               f"{e}") from e
        lib.parse_skeleton.restype = ctypes.c_int
        lib.parse_skeleton.argtypes = [ctypes.c_char_p, _FLOAT_P,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int]
        lib.pre_normalize.restype = None
        lib.pre_normalize.argtypes = [_FLOAT_P] + [ctypes.c_int] * 10
        lib.flatten_persons.restype = ctypes.c_int
        lib.flatten_persons.argtypes = [_FLOAT_P, ctypes.c_int,
                                        ctypes.c_int, _FLOAT_P, _FLOAT_P,
                                        ctypes.c_int]
        _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def parse_skeleton(path: str, max_body: int = 4, max_frames: int = 300,
                   num_joint: int = 25) -> Tuple[np.ndarray, int]:
    """Parse an NTU `.skeleton` file -> ((max_body, T, V, 3), num_frames).

    The C parser when the library is there; else, or when it reports a
    malformed file, agcn_tpu_torch.data.gen.ntu.read_skeleton.
    """
    lib = get_lib()
    if lib is not None:
        out = np.zeros((max_body, max_frames, num_joint, 3),
                       dtype=np.float32)
        frames = lib.parse_skeleton(os.fsencode(path),
                                    out.ctypes.data_as(_FLOAT_P),
                                    max_body, max_frames, num_joint)
        parse_skeleton.calls += 1
        if frames >= 0:
            return out, int(frames)
    from agcn_tpu_torch.data.gen.ntu import read_skeleton

    data, frames = read_skeleton(path)
    t = min(frames, max_frames)
    out = np.zeros((max_body, max_frames, num_joint, 3), dtype=np.float32)
    out[:, :t] = data[:max_body, :t]
    return out, t


parse_skeleton.calls = 0


def flatten_persons(seq: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(T, 2*half) -> the interleaved (T', half) frames and (T', 1)
    subject ids of the SGN collate (agcn_tpu/native/__init__.py:108-131).

    The C loop drops the all-zero frames itself; without the library the
    numpy loop of `SegmentSampler.flatten_persons` runs on the nonzero
    frames, as in the JAX package.
    """
    lib = get_lib()
    t, d = seq.shape
    half = d // 2
    if lib is not None:
        seq_c = np.ascontiguousarray(seq, dtype=np.float32)
        frames = np.empty((2 * t, half), dtype=np.float32)
        subjects = np.empty((2 * t,), dtype=np.float32)
        n = lib.flatten_persons(seq_c.ctypes.data_as(_FLOAT_P), t, half,
                                frames.ctypes.data_as(_FLOAT_P),
                                subjects.ctypes.data_as(_FLOAT_P), 2 * t)
        flatten_persons.calls += 1
        return frames[:n].copy(), subjects[:n, None].copy()
    from agcn_tpu_torch.data.sgn_collate import SegmentSampler

    nz = seq.any(axis=-1)
    return SegmentSampler().flatten_persons(seq[nz])


flatten_persons.calls = 0


def pre_normalize(data: np.ndarray,
                  zaxis=(0, 1), xaxis=(8, 4), pad: bool = True,
                  center: bool = True,
                  center_firstframe: bool = False) -> Optional[np.ndarray]:
    """The C pre_normalization over (N, C, T, V, M) float32 data.

    Returns the normalized copy, or None where the C function does not
    apply: no library (no g++), C != 3, or a joint index of `zaxis` or
    `xaxis` outside [0, V). The caller then takes the numpy version in
    agcn_tpu_torch.data.gen.preprocess.
    """
    lib = get_lib()
    if lib is None or data.shape[1] != 3:
        return None
    n, c, t, v, m = data.shape
    for pair in (zaxis, xaxis):
        # numpy wraps negative joint indices and raises on >= V; the C
        # sentinel for "skip" is -1, so route anything outside [0, V)
        # to the numpy path rather than silently diverge
        if pair is not None and any(j < 0 or j >= v for j in pair):
            return None
    s = np.ascontiguousarray(
        np.transpose(data, (0, 4, 2, 3, 1)), dtype=np.float32)
    z_from, z_to = (zaxis[0], zaxis[1]) if zaxis is not None else (-1, -1)
    # the x alignment swaps the pair (preprocess.py alignments table)
    x_from, x_to = (xaxis[1], xaxis[0]) if xaxis is not None else (-1, -1)
    center_mode = 1 if center else (2 if center_firstframe else 0)
    lib.pre_normalize(s.ctypes.data_as(_FLOAT_P), n, m, t, v, z_from, z_to,
                      x_from, x_to, 1 if pad else 0, center_mode)
    pre_normalize.calls += 1
    return np.transpose(s, (0, 4, 2, 3, 1))


pre_normalize.calls = 0
