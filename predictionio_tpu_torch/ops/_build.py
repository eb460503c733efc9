"""Build and load the hand-written CUDA kernels (`csrc/*.cu`) and the
host C++ libraries (`csrc/*.cpp`).

Each kernel source is compiled by `nvcc` for Hopper (`sm_90a`) into a
shared library with a plain C interface, at first use, and loaded with
`ctypes`; a host source (the nativelog event store's `eventlog.cpp`,
no CUDA) is compiled by `g++` with `GXX_FLAGS` the same way. The
library lands in the salted build directory of `compile/cache.py`
(`predictionio_tpu_torch/_build/<salt>/`, git-ignored), whose salt
hashes every source, the flags and the host's toolchain, so an edited
source is rebuilt and a stale library, or one built on another machine,
is never loaded. Nothing is built when a module is imported: the CPU
tests import every module on a machine with no `nvcc`.

Many processes may ask for one library at once (the test workers, an
event server beside a trainer): a build holds an exclusive lock on
`<name>.so.lock`, compiles to a private name and renames the library
into place; the others wait on the lock and then load what it built. A
half-written library is never loaded. A failed build raises
`RuntimeError` carrying the compiler's output.

`nvcc` is found through `$CUDA_HOME/bin`, then `PATH`, then the
toolkit's standard install location. `BUILDS` counts the builds this
process has run and their seconds (the bulk data plane reports the
builds that ran during its steady phase); each build is also reported
to `obs/torchmon` as a compile, and the first use of each library in a
process as a build-directory hit (found built) or miss (built now).
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Set

from predictionio_tpu_torch.compile import cache
from predictionio_tpu_torch.obs import torchmon

PKG_DIR = cache.PKG_DIR
CSRC_DIR = cache.CSRC_DIR
BUILD_DIR = cache.DEFAULT_ROOT
NVCC_FLAGS = cache.NVCC_FLAGS
GXX_FLAGS = cache.GXX_FLAGS
nvcc_path = cache.nvcc_path

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# libraries whose build-directory hit or miss this process has counted
_counted: Set[str] = set()


@dataclass
class BuildCounts:
    """Builds run by this process, and their wall seconds."""
    builds: int = 0
    seconds: float = 0.0


BUILDS = BuildCounts()


def _target(name: str) -> Path:
    return cache.cache_dir() / f"{name}.so"


def _source(name: str) -> Path:
    """`csrc/<name>.cu` (a kernel, built by nvcc), else
    `csrc/<name>.cpp` (host C++, built by g++)."""
    cu = CSRC_DIR / f"{name}.cu"
    return cu if cu.exists() else CSRC_DIR / f"{name}.cpp"


def _command(src: Path, tmp: Path) -> list:
    if src.suffix == ".cu":
        return [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    return ["g++", *GXX_FLAGS, "-o", str(tmp), str(src)]


def _start(name: str):
    """Start the compiler for one source under the library's lock file;
    returns (popen, tmp path, target, lock) or None when the library is
    already built. The lock is held until `_finish`, so a process that
    asks meanwhile waits and then finds the library built."""
    out = _target(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    lock = open(out.with_suffix(".so.lock"), "w")
    try:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():              # another process built it
            lock.close()
            return None
        src = _source(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = _command(src, tmp)
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        except OSError as e:
            raise RuntimeError(f"{Path(cmd[0]).name} failed to start for "
                               f"{src.name}: {e}") from e
    except BaseException:
        lock.close()                  # closing the file drops the lock
        raise
    return proc, tmp, out, lock


def _finish(name: str, job) -> None:
    proc, tmp, out, lock = job
    try:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            src = _source(name)
            tool = "nvcc" if src.suffix == ".cu" else "g++"
            raise RuntimeError(f"{tool} failed to build {src.name} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)   # atomic: a concurrent loader never sees half
    finally:
        lock.close()


def build_all(names: Iterable[str] = None) -> dict:
    """Build every named source (default: all of `csrc/*.cu`), one
    compiler per source, all started together. Returns {name: seconds
    to build} (0.0 for a library that was already built)."""
    if names is None:
        names = [p.stem for p in CSRC_DIR.glob("*.cu")]
    t0 = time.perf_counter()
    with _lock:
        jobs = {}
        secs = {}
        try:
            # sorted: every process takes the lock files in one order
            for n in sorted(names):
                jobs[n] = _start(n)
            for n, job in jobs.items():
                if job is not None:
                    jobs[n] = None
                    _finish(n, job)
                    jobs[n] = job
                secs[n] = time.perf_counter() - t0 if job is not None \
                    else 0.0
        except BaseException:
            for n, job in jobs.items():
                if job is not None and n not in secs:   # still running
                    job[0].kill()
                    job[0].wait()
                    job[3].close()
            raise
        started = [n for n, job in jobs.items() if job is not None]
        BUILDS.builds += len(started)
        BUILDS.seconds += max((secs[n] for n in started), default=0.0)
        fresh = [n for n in jobs if n not in _counted]
        _counted.update(fresh)
    for n in started:
        torchmon.record_compile(secs[n])
    for n in fresh:
        torchmon.record_pcache(hit=jobs[n] is None)
    return secs


def library_path(name: str) -> Path:
    """Where the library built from `csrc/<name>` by this tree lives."""
    return _target(name)


def build_log(name: str) -> str:
    """The compiler's output (for a kernel, ptxas's register/shared-
    memory/spill report) for the current build of `name`, or '' when it
    was not built by this tree."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str, py_api: bool = False) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu` or `csrc/<name>.cpp`,
    built first if needed. `py_api` loads it as a `ctypes.PyDLL` (its
    calls keep the GIL)."""
    key = f"{name}:py" if py_api else name
    lib = _libs.get(key)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            lib = (ctypes.PyDLL if py_api else ctypes.CDLL)(
                str(_target(name)))
            _libs[key] = lib
    return lib
