"""The salted build directory of the kernels.

The port's counterpart of `predictionio_tpu/compile/cache.py`, the
managed persistent XLA cache. What the port keeps across processes is
the `nvcc` build of each kernel (`ops/_build.py`): a shared library
that a later process loads instead of building again.

- **Location**: `<root>/<salt>/`, where root is `$PIO_BUILD_CACHE_DIR`
  or `predictionio_tpu_torch/_build/` (git-ignored).
- **Salt**: a 12-hex fingerprint of `csrc/*.cu` and `NVCC_FLAGS`. An
  edited kernel or flag rolls the directory, so a stale library is never
  loaded, and `clear_cache(all_salts=True)` removes the dead ones.
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
import shutil
from pathlib import Path
from typing import Dict, Optional

logger = logging.getLogger(__name__)

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
DEFAULT_ROOT = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_salt_memo: Optional[str] = None


def cache_root() -> Path:
    env = os.environ.get("PIO_BUILD_CACHE_DIR")
    return Path(env) if env else DEFAULT_ROOT


def kernel_sources():
    """The kernel sources the salt covers, sorted."""
    return sorted(CSRC_DIR.glob("*.cu"))


def cache_salt() -> str:
    """12-hex fingerprint of the kernel sources and the nvcc flags.
    Memoized: the sources cannot change under a running process."""
    global _salt_memo
    if _salt_memo is not None:
        return _salt_memo
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
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
