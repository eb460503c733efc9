"""Sharded checkpoints of factor tables: one `.npy` file a shard.

The port's counterpart of `predictionio_tpu/utils/checkpoint.py`
(`checkpoint_dir`, `save_sharded`, `restore_sharded`). The reference
saves through orbax (each host writes its shards, a restore re-shards to
the reader's mesh) and falls back to one npz. The port adds no
dependency: a checkpoint directory holds one `.npy` file a shard of a
`ShardedTable` (`<name>.shard<j>.npy`: the shard's logical rows, its
bucket padding left out, written by the process that holds the shard),
one `.npy` file a whole array, and `manifest.json`, which
names every file with its table's logical and padded rows and shard
count. Every file is written to a temporary name and renamed into place,
the manifest last, so a crash leaves the previous checkpoint or an
unreadable one, never a torn table. A restore reads the files
memory-mapped and re-shards to the shard count the reader asks for,
reading only the rows of the shards it keeps.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np

MANIFEST = "manifest.json"


def checkpoint_dir(instance_id: str, base: Optional[str] = None) -> str:
    base = base or os.path.join(
        os.environ.get("PIO_FS_BASEDIR",
                       os.path.expanduser("~/.pio_store")),
        "sharded_models")
    return os.path.join(base, instance_id)


def _write_atomic(path: str, write) -> None:
    """`write(f)` into `path` through a temporary file and a rename."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _host(arr) -> np.ndarray:
    if hasattr(arr, "detach"):
        return arr.detach().to("cpu").numpy()
    return np.asarray(arr)


def save_sharded(path: str, arrays: Dict[str, Any]) -> bool:
    """Save a flat dict of tables: a `ShardedTable` as its held shards,
    anything else (numpy, a tensor) as one array. In a multi-process mesh
    each process writes the shards it holds and process 0 writes the
    manifest. Returns True."""
    from predictionio_tpu_torch.parallel.mesh import process_index
    from predictionio_tpu_torch.parallel.sharded_table import is_sharded
    os.makedirs(path, exist_ok=True)
    manifest: Dict[str, dict] = {}
    for name, arr in arrays.items():
        if is_sharded(arr):
            per = arr.padded_rows // arr.n_shards
            files = [f"{name}.shard{j}.npy" for j in range(arr.n_shards)]
            for off, shard in zip(arr.offsets, arr.shards):
                # the shard's logical rows only: its bucket padding is
                # zeros, which a restore puts back
                keep = min(per, max(arr.n_rows - off, 0))
                _write_atomic(os.path.join(path, files[off // per]),
                              lambda f, a=shard[:keep]: np.save(f, a))
            manifest[name] = {"kind": "sharded", "rows": arr.n_rows,
                              "paddedRows": arr.padded_rows,
                              "shards": arr.n_shards, "rank": arr.rank,
                              "dtype": str(arr.dtype), "files": files}
        else:
            host = _host(arr)
            fname = f"{name}.npy"
            _write_atomic(os.path.join(path, fname),
                          lambda f, a=host: np.save(f, a))
            manifest[name] = {"kind": "array", "shape": list(host.shape),
                              "dtype": str(host.dtype), "files": [fname]}
    if process_index() == 0:
        body = json.dumps(manifest, sort_keys=True).encode()
        _write_atomic(os.path.join(path, MANIFEST), lambda f: f.write(body))
    return True


def _sharded_rows(path: str, ent: dict, start: int, stop: int
                  ) -> np.ndarray:
    """Global rows [start, stop) of a saved sharded table, read from the
    memory-mapped shard files that hold them."""
    per = ent["paddedRows"] // ent["shards"]
    out = np.zeros((stop - start, ent["rank"]), dtype=np.float32)
    for j, fname in enumerate(ent["files"]):
        lo, hi = max(start, j * per), min(stop, (j + 1) * per)
        if lo >= hi:
            continue
        shard = np.load(os.path.join(path, fname), mmap_mode="r")
        # a file holds its shard's logical rows; the rest are zeros
        hi = min(hi, j * per + shard.shape[0])
        if lo < hi:
            out[lo - start:hi - start] = shard[lo - j * per:hi - j * per]
    return out


def restore_sharded(path: str, shardings: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
    """The saved tables. Without `shardings` each comes back whole, as
    host numpy ([rows, rank] for a sharded table). `shardings` maps a
    name to a shard count or a `MeshContext` (its model axis): that
    table comes back as a `ShardedTable` of that many shards at its
    sharded row bucket, holding the shards this process keeps (all of
    them in a single process)."""
    from predictionio_tpu_torch.compile.buckets import bucket_rows_sharded
    from predictionio_tpu_torch.parallel.sharded_table import ShardedTable
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    shardings = shardings or {}
    out: Dict[str, Any] = {}
    for name, ent in manifest.items():
        want = shardings.get(name)
        if ent["kind"] == "array":
            host = np.load(os.path.join(path, ent["files"][0]))
            if want is None:
                out[name] = host
                continue
            ent = {"rows": host.shape[0], "rank": host.shape[1],
                   "host": host}
        if want is None:
            out[name] = _sharded_rows(path, ent, 0, ent["rows"])
            continue
        n_shards = want if isinstance(want, int) else want.model_parallelism
        owned = (range(n_shards) if isinstance(want, int)
                 else want.owned_parts(want.MODEL_AXIS))
        padded = bucket_rows_sharded(ent["rows"], n_shards)
        per = padded // n_shards
        shards = []
        for j in owned:
            lo, hi = j * per, min((j + 1) * per, ent["rows"])
            block = np.zeros((per, ent["rank"]), dtype=np.float32)
            if hi > lo:
                block[:hi - lo] = (ent["host"][lo:hi] if "host" in ent
                                   else _sharded_rows(path, ent, lo, hi))
            shards.append(block)
        out[name] = ShardedTable(shards, [j * per for j in owned],
                                 ent["rows"], padded, n_shards)
    return out
