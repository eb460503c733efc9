"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

Each source is compiled by `nvcc` for Hopper (`sm_90a`) into a shared
library with a plain C interface, at first use, and loaded with `ctypes`.
The library lands in `predictionio_tpu_torch/_build/` (git-ignored) under
a name carrying the hash of its source and flags, so an edited source is
rebuilt and a stale library is never loaded. Nothing is built when a
module is imported: the CPU tests import every module on a machine with
no `nvcc`.

`nvcc` is found through `$CUDA_HOME/bin`, then `PATH`, then the
toolkit's standard install location. `BUILDS` counts the `nvcc` builds
this process has run and their seconds (the bulk data plane reports the
builds that ran during its steady phase).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


@dataclass
class BuildCounts:
    """`nvcc` builds run by this process, and their wall seconds."""
    builds: int = 0
    seconds: float = 0.0


BUILDS = BuildCounts()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.access(default, os.X_OK):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def _target(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def _start(name: str):
    """Start `nvcc` for one source; returns (popen, tmp path, target) or
    None when the library is already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)   # atomic: a concurrent loader never sees half


def build_all(names: Iterable[str] = None) -> dict:
    """Build every named source (default: all of `csrc/*.cu`), one `nvcc`
    per source, all started together. Returns {name: seconds to build}
    (0.0 for a library that was already built)."""
    if names is None:
        names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    with _lock:
        jobs = {n: _start(n) for n in names}
        secs = {}
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)
            secs[n] = time.perf_counter() - t0 if job is not None else 0.0
        started = [n for n, job in jobs.items() if job is not None]
        BUILDS.builds += len(started)
        BUILDS.seconds += max((secs[n] for n in started), default=0.0)
    return secs


def library_path(name: str) -> Path:
    """Where the library built from `csrc/<name>.cu` by this tree lives."""
    return _target(name)


def build_log(name: str) -> str:
    """`nvcc`'s output (ptxas register/shared-memory/spill report) for the
    current build of `name`, or '' when it was not built by this tree."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
    return lib
