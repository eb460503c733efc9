"""Host-side handle to a factor table split by rows over the model axis.

The port's counterpart of `predictionio_tpu/parallel/sharded_table.py`
(`ShardedTable`, `is_sharded`, `table_rows`, `layout_of`,
`sharding_meta`; `gather_rows`, the rows of a table split over the
processes on every process, is the port's own). A published model
version carries one in place of a whole numpy table:

- **per-shard host slices** (`shards` + `offsets`): the durable mirror
  the registry serializes, the gates probe and a restarted server
  uploads from. A process of a multi-process mesh holds only its shards;
  a single process holds all of them.
- **a transient device handle** (`_dev`, a `parallel/mesh.DeviceShards`
  of this process's shards, each a tensor of its own): the resident fast
  path. A train or a fold tick attaches its final device shards here, so
  serving and the next tick reuse them without a host round trip. It is
  never pickled and is checked against the mesh and row bucket before
  reuse.

A fold tick updates the mirror copy-on-write per shard: only the shards
holding touched rows are copied and patched, and only the touched rows
cross the device-to-host link. Tables are immutable by convention: a
swap or rollback replaces the whole object.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def is_sharded(table) -> bool:
    """True for a `ShardedTable` (the layout every serve, fold and gate
    call site dispatches on)."""
    return isinstance(table, ShardedTable)


def table_rows(table, idx) -> np.ndarray:
    """Host gather of global rows from either layout."""
    if is_sharded(table):
        return table.rows(idx)
    return np.asarray(table)[np.asarray(idx, dtype=np.int64)]


def gather_rows(table, idx) -> np.ndarray:
    """Global rows of either layout, on every process: `table_rows` when
    this process holds them all; for a table split over the processes,
    each process's held rows summed over the group
    (`parallel/mesh.all_reduce`), a collective every process enters, as
    every process of a mesh runs the same query."""
    if not is_sharded(table) or table.fully_held:
        return table_rows(table, idx)
    import torch
    from predictionio_tpu_torch.parallel.mesh import all_reduce
    idx = np.asarray(idx, dtype=np.int64).ravel()
    offs = np.asarray(table.offsets, dtype=np.int64)
    ends = offs + np.asarray([s.shape[0] for s in table.shards],
                             dtype=np.int64)
    held = ((idx[:, None] >= offs[None, :])
            & (idx[:, None] < ends[None, :])).any(axis=1)
    out = np.zeros((idx.size, table.rank), dtype=np.float32)
    out[held] = table.rows(idx[held])
    return all_reduce(torch.from_numpy(out)).numpy()


def layout_of(table) -> str:
    """'model:<N>' for an N-way sharded table, else 'replicated': the
    layout token residency slots and caches key on."""
    if is_sharded(table):
        return f"model:{table.n_shards}"
    return "replicated"


class ShardedTable:
    """`n_shards` contiguous row ranges of a `[padded_rows, rank]` table;
    rows from `n_rows` on are bucket padding (zeros). Mutators return new
    tables that share the untouched shard arrays."""

    def __init__(self, shards: Sequence[np.ndarray],
                 offsets: Sequence[int], n_rows: int, padded_rows: int,
                 n_shards: int):
        self.shards: Tuple[np.ndarray, ...] = tuple(
            np.ascontiguousarray(s, dtype=np.float32) for s in shards)
        self.offsets: Tuple[int, ...] = tuple(int(o) for o in offsets)
        self.n_rows = int(n_rows)
        self.padded_rows = int(padded_rows)
        self.n_shards = int(n_shards)
        if not self.shards:
            raise ValueError("ShardedTable needs at least one shard")
        if padded_rows % self.n_shards:
            raise ValueError(
                f"padded rows {padded_rows} not divisible by "
                f"{self.n_shards} shards")
        self._dev = None          # transient device handle (never pickled)
        # one cold upload at a time: racing serve threads must not each
        # upload the table
        self._dev_lock = threading.Lock()

    # -- numpy-facing surface ------------------------------------------------
    @property
    def rank(self) -> int:
        return self.shards[0].shape[1]

    @property
    def shape(self) -> Tuple[int, int]:
        """The logical shape (bucket padding excluded)."""
        return (self.n_rows, self.rank)

    @property
    def ndim(self) -> int:
        return 2

    @property
    def dtype(self):
        return self.shards[0].dtype

    @property
    def size(self) -> int:
        return self.n_rows * self.rank

    @property
    def nbytes(self) -> int:
        """Logical table bytes (what a replicated copy would hold)."""
        return self.n_rows * self.rank * self.dtype.itemsize

    @property
    def per_shard_nbytes(self) -> int:
        """Padded bytes of one shard: what one logical device of the
        mesh holds, and what the per-device table budget is held to."""
        return (self.padded_rows // self.n_shards) * self.rank \
            * self.dtype.itemsize

    def __len__(self) -> int:
        return self.n_rows

    def __repr__(self) -> str:
        return (f"ShardedTable(rows={self.n_rows}/{self.padded_rows}, "
                f"rank={self.rank}, shards={self.n_shards}, "
                f"resident={self._dev is not None})")

    # -- constructors --------------------------------------------------------
    @staticmethod
    def from_host(arr: np.ndarray, n_shards: int,
                  padded_rows: Optional[int] = None) -> "ShardedTable":
        """Split one host table into `n_shards` equal row slices,
        zero-padded to `padded_rows` (default: the covering sharded row
        bucket)."""
        from predictionio_tpu_torch.compile.buckets import \
            bucket_rows_sharded
        arr = np.ascontiguousarray(arr, dtype=np.float32)
        n = arr.shape[0]
        target = padded_rows if padded_rows is not None \
            else bucket_rows_sharded(max(n, 1), n_shards)
        if target < n or target % n_shards:
            raise ValueError(
                f"padded_rows {target} must cover {n} rows and divide "
                f"by {n_shards}")
        per = target // n_shards
        shards = []
        for s in range(n_shards):
            lo, hi = s * per, (s + 1) * per
            block = np.zeros((per, arr.shape[1]), dtype=np.float32)
            got = arr[lo:min(hi, n)]
            block[:got.shape[0]] = got
            shards.append(block)
        return ShardedTable(shards, [s * per for s in range(n_shards)],
                            n, target, n_shards)

    # -- host row access -----------------------------------------------------
    def _which_shard(self, idx: np.ndarray) -> np.ndarray:
        """The held shard owning each global row; rows no held shard
        covers raise IndexError (never wrap into another shard)."""
        offs = np.asarray(self.offsets, dtype=np.int64)
        which = np.searchsorted(offs, idx, side="right") - 1
        if (which < 0).any():
            raise IndexError(
                f"rows {idx[which < 0]} precede this process's "
                f"shards (offsets {self.offsets})")
        ends = offs + np.asarray([s.shape[0] for s in self.shards],
                                 dtype=np.int64)
        past = idx >= ends[which]
        if past.any():
            raise IndexError(
                f"rows {idx[past]} fall outside this process's shards "
                f"(offsets {self.offsets})")
        return which

    @property
    def fully_held(self) -> bool:
        return self.offsets[0] == 0 and sum(
            s.shape[0] for s in self.shards) == self.padded_rows

    def _require_full_coverage(self, what: str):
        if not self.fully_held:
            raise ValueError(
                f"{what} needs every shard (single-process); this "
                f"process holds offsets {self.offsets} of "
                f"{self.padded_rows} rows")

    def rows(self, idx) -> np.ndarray:
        """Global rows from the host mirrors; rows outside the held
        shards raise IndexError."""
        idx = np.asarray(idx, dtype=np.int64).ravel()
        out = np.empty((idx.size, self.rank), dtype=np.float32)
        if idx.size == 0:
            return out
        if (idx < 0).any() or (idx >= self.padded_rows).any():
            raise IndexError(f"row index out of range 0..{self.padded_rows}")
        which = self._which_shard(idx)
        offs = np.asarray(self.offsets, dtype=np.int64)
        for s in np.unique(which):
            sel = which == s
            out[sel] = self.shards[s][idx[sel] - offs[s]]
        return out

    def to_numpy(self) -> np.ndarray:
        """The whole logical table on the host: an O(table) concat for
        parity tests and checkpoints, never on a serve or tick path."""
        self._require_full_coverage("to_numpy")
        return np.concatenate(self.shards, axis=0)[:self.n_rows]

    def all_finite(self) -> bool:
        return all(np.isfinite(self._logical_view(i)).all()
                   for i in range(len(self.shards)))

    def max_row_norm(self) -> float:
        mx = 0.0
        for i in range(len(self.shards)):
            t = self._logical_view(i)
            if t.size == 0:
                continue
            with np.errstate(over="ignore", invalid="ignore"):
                n = float(np.sqrt(np.max(np.einsum("ij,ij->i", t, t))))
            if np.isfinite(n):
                mx = max(mx, n)
        return mx

    def _logical_view(self, i: int) -> np.ndarray:
        """Shard `i` without its bucket-padding rows."""
        off = self.offsets[i]
        stop = max(min(self.n_rows - off, self.shards[i].shape[0]), 0)
        return self.shards[i][:stop]

    # -- mutation (copy-on-write) -------------------------------------------
    def with_rows(self, idx, values: np.ndarray,
                  n_rows: Optional[int] = None) -> "ShardedTable":
        """A new table with global rows `idx` replaced by `values`: only
        the shards holding touched rows are copied. `n_rows` grows the
        logical size inside the same bucket."""
        idx = np.asarray(idx, dtype=np.int64).ravel()
        values = np.asarray(values, dtype=np.float32)
        which = self._which_shard(idx)
        offs = np.asarray(self.offsets, dtype=np.int64)
        shards = list(self.shards)
        for s in np.unique(which):
            sel = which == s
            patched = shards[s].copy()
            patched[idx[sel] - offs[s]] = values[sel]
            shards[s] = patched
        return ShardedTable(shards, self.offsets,
                            self.n_rows if n_rows is None else n_rows,
                            self.padded_rows, self.n_shards)

    def grown(self, n_rows: int, padded_rows: int) -> "ShardedTable":
        """Re-partition for a bucket promotion (`padded_rows` grew): the
        shard boundaries move, so this is the one O(table) host
        reshuffle, once per 2x growth. Single-process only."""
        self._require_full_coverage("grown")
        full = np.concatenate(self.shards, axis=0)
        grown = np.zeros((padded_rows, self.rank), dtype=np.float32)
        grown[:full.shape[0]] = full
        out = ShardedTable.from_host(grown, self.n_shards,
                                     padded_rows=padded_rows)
        return ShardedTable(out.shards, out.offsets, n_rows,
                            padded_rows, self.n_shards)

    # -- device residency ----------------------------------------------------
    def device(self, mesh, target_rows: Optional[int] = None):
        """This process's shards on `mesh`'s device, as a
        `DeviceShards`: the attached handle when it is valid for `mesh`
        and the row bucket, else an upload of the held host shards (the
        cold path: a restart, an eviction, a mesh change), one tensor a
        shard. `target_rows` above `padded_rows` uploads at that larger
        bucket with the extra rows zero, without touching the mirrors
        (the serve path's cover for a table padded below its bucket).
        Each shard is checked against `PIO_TABLE_BUDGET_BYTES`."""
        target = max(int(target_rows or 0), self.padded_rows)
        if target % self.n_shards:
            raise ValueError(
                f"target_rows {target} not divisible by "
                f"{self.n_shards} shards")

        def _valid(dev):
            return (dev is not None and dev.shape[0] == target
                    and dev.mesh is mesh)

        dev = self._dev
        if _valid(dev):
            return dev
        with self._dev_lock:
            dev = self._dev        # a racing thread may have uploaded
            if _valid(dev):
                return dev
            import torch
            from predictionio_tpu_torch.obs import torchmon
            from predictionio_tpu_torch.parallel.mesh import DeviceShards
            from predictionio_tpu_torch.utils.device_cache import \
                check_table_budget
            if mesh.model_parallelism != self.n_shards:
                raise ValueError(
                    f"{self!r} needs a mesh with a {self.n_shards}-wide "
                    f"model axis, got {mesh.model_parallelism}")
            per = target // self.n_shards
            check_table_budget(per * self.rank * self.dtype.itemsize,
                               table=repr(self))
            owned = mesh.owned_parts(mesh.MODEL_AXIS)
            tensors = []
            for j in owned:
                host = self._host_rows(j * per, (j + 1) * per)
                torchmon.record_h2d(int(host.nbytes))
                tensors.append(torch.from_numpy(host).to(mesh.device,
                                                         copy=True))
            dev = DeviceShards(tensors, [j * per for j in owned],
                               (target, self.rank), self.n_shards, 0, mesh)
            self._dev = dev
            return dev

    def _host_rows(self, start: int, stop: int) -> np.ndarray:
        """Contiguous global rows from the held shards; rows past
        `padded_rows` (a larger bucket's tail) are zeros."""
        parts = []
        need = start
        for off, sh in zip(self.offsets, self.shards):
            lo, hi = max(start, off), min(stop, off + sh.shape[0])
            if lo < hi:
                if lo != need:
                    break
                parts.append(sh[lo - off:hi - off])
                need = hi
        if need < stop and need >= self.padded_rows:
            parts.append(np.zeros((stop - need, self.rank),
                                  dtype=np.float32))
            need = stop
        if need != stop:
            raise IndexError(
                f"rows [{start}, {stop}) not covered by this process's "
                f"shards (offsets {self.offsets})")
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def attach_device(self, dev) -> "ShardedTable":
        """Bind a train's or tick's final device shards as the resident
        handle (only the transient handle changes)."""
        self._dev = dev
        return self

    def drop_device(self) -> int:
        """Release the resident handle (a tenant's eviction): the host
        mirrors stay, and the next `device` call uploads again. Returns
        the bytes the handle held on this process's device."""
        with self._dev_lock:
            freed = self.device_nbytes()
            self._dev = None
        return freed

    def device_nbytes(self) -> int:
        """Bytes the resident handle holds on this process's device (0
        when not resident)."""
        dev = self._dev
        return 0 if dev is None else int(dev.nbytes)

    def device_tensors(self) -> list:
        """The resident handle's shard tensors (none when not resident):
        what the serving host's budget sizes."""
        dev = self._dev
        return [] if dev is None else list(dev.tensors)

    # -- pickling ------------------------------------------------------------
    def __getstate__(self):
        state = dict(self.__dict__)
        state["_dev"] = None       # device handles never serialize
        state.pop("_dev_lock", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._dev = None
        self._dev_lock = threading.Lock()


def sharding_meta(models) -> Optional[dict]:
    """`{"layout": "model", "shards": N}` when any model of the set
    carries sharded factor tables (the lineage tag the registry
    publishes), else None."""
    for m in models:
        for obj in (m, getattr(m, "als", None)):
            if obj is None:
                continue
            for attr in ("user_factors", "item_factors"):
                t = getattr(obj, attr, None)
                if is_sharded(t):
                    return {"layout": "model", "shards": t.n_shards}
    return None
