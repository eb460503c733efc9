"""The salted build directory of the kernels.

The port's counterpart of `predictionio_tpu/compile/cache.py`, the
managed persistent XLA cache. What the port keeps across processes is
the `nvcc` build of each kernel (`ops/_build.py`): a shared library
that a later process loads instead of building again.

- **Location**: `<root>/<salt>/`, where root is `$PIO_BUILD_CACHE_DIR`
  or `predictionio_tpu_torch/_build/` (git-ignored).
- **Salt**: a 12-hex fingerprint of `csrc/*.cu`, `csrc/*.cpp` (the host
  C++ of the nativelog event store), `NVCC_FLAGS`, `GXX_FLAGS` and the
  host's toolchain (`toolchain_id`: the machine, the C library, and the
  versions of g++ and nvcc). An edited source or flag, or another
  machine's compilers, roll the directory, so a stale library or one
  built elsewhere (a checkout copied between hosts) is never loaded, and
  `clear_cache(all_salts=True)` removes the dead ones.
- **Counters**: a library found built is a hit and an `nvcc` run a miss
  (`pio_compile_pcache_{hits,misses}_total{executable}`, through
  `obs/torchmon.record_pcache`).

`cache_status()` and `clear_cache()` back the CLI's `cache status` and
`cache clear [--all]` and the engine server's `/stats.json` `buildCache`.
"""

from __future__ import annotations

import hashlib
import logging
import os
import platform
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

logger = logging.getLogger(__name__)

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
DEFAULT_ROOT = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")
#: the host libraries' flags (`csrc/*.cpp`, built by g++): the reference's
#: `native/Makefile` CXXFLAGS plus `-shared`
GXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")

_salt_memo: Optional[str] = None


def cache_root() -> Path:
    env = os.environ.get("PIO_BUILD_CACHE_DIR")
    return Path(env) if env else DEFAULT_ROOT


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


def _version(cmd) -> str:
    try:
        return subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.DEVNULL, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def toolchain_id() -> str:
    """What a built library depends on besides its source and flags: the
    machine, the C library, and `--version` of g++ and of nvcc ('' for a
    compiler that is not installed)."""
    try:
        nvcc = _version([nvcc_path(), "--version"])
    except RuntimeError:
        nvcc = ""
    return "\n".join([platform.machine(), " ".join(platform.libc_ver()),
                      _version(["g++", "--version"]), nvcc])


def kernel_sources():
    """The sources the salt covers (CUDA kernels and host C++), sorted."""
    return sorted([*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cpp")])


def cache_salt() -> str:
    """12-hex fingerprint of the sources, the nvcc and g++ flags and the
    toolchain. Memoized: none of them changes under a running process."""
    global _salt_memo
    if _salt_memo is not None:
        return _salt_memo
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(b"\0" + " ".join(GXX_FLAGS).encode())
    h.update(b"\0" + toolchain_id().encode() + b"\0")
    for path in kernel_sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    _salt_memo = h.hexdigest()[:12]
    return _salt_memo


def cache_dir() -> Path:
    """The active salted directory (not created here)."""
    return cache_root() / cache_salt()


def _dir_stats(path: Path):
    entries = 0
    nbytes = 0
    try:
        for p in path.iterdir():
            if p.is_file():
                entries += 1
                nbytes += p.stat().st_size
    except OSError:
        pass
    return entries, nbytes


def cache_status() -> Dict:
    """The operator's view (`cache status`, `/stats.json` `buildCache`):
    the salted directory, its libraries, and this process's hits and
    misses."""
    from predictionio_tpu_torch.obs import costmon
    active = cache_dir()
    root = cache_root()
    totals = costmon.pcache_totals()
    out = {
        "enabled": True,
        "dir": str(active),
        "root": str(root),
        "salt": cache_salt(),
        "entries": 0,
        "bytes": 0,
        "libraries": [],
        "hits": totals["hits"],
        "misses": totals["misses"],
    }
    if active.is_dir():
        out["entries"], out["bytes"] = _dir_stats(active)
        out["libraries"] = sorted(p.name for p in active.glob("*.so"))
    if root.is_dir():
        out["staleSalts"] = sorted(
            d.name for d in root.iterdir()
            if d.is_dir() and d.name != cache_salt())
    return out


def clear_cache(all_salts: bool = False) -> Dict:
    """Remove built libraries. Default scope is the active salt
    directory (a running process keeps the libraries it has loaded and
    rebuilds on its next first use); `all_salts` also removes the other
    directories under the root."""
    removed = 0
    nbytes = 0
    targets = []
    active = cache_dir()
    if active.is_dir():
        targets.append(active)
    root = cache_root()
    if all_salts and root.is_dir():
        for d in sorted(root.iterdir()):
            if d.is_dir() and d not in targets:
                targets.append(d)
    for t in targets:
        e, b = _dir_stats(t)
        removed += e
        nbytes += b
        try:
            shutil.rmtree(t)
        except OSError:
            logger.warning("cache clear: could not remove %s", t,
                           exc_info=True)
    return {"removed": removed, "bytes": nbytes,
            "dirs": [str(t) for t in targets]}
