"""Host-array -> device-tensor upload cache, the fold-in's residency
slots, and the factor-table budget.

The port's counterpart of `predictionio_tpu/utils/device_cache.py`.

The upload cache (`cached_put`, `cached_put_padded`, `cached_put_rows`,
`cache_size`, `clear`): a served table lives in host numpy after it is
restored; `cached_put*` uploads it once per (array identity, padding,
device) and evicts the copy when the host array is garbage-collected (a
weak reference's callback), so a retired model pins no device memory.
`cached_put_rows` pads dim 0 with zeros to a shape bucket
(`compile/buckets.bucket_rows`): the serve path's tables, whose padding
rows the top-k masks. It also takes a tensor already on its device and
pads it there. Every upload counts its bytes in `obs/torchmon`.

The residency slots (`get_resident`, `put_resident`, `drop_resident`,
`resident_sizes`, which `obs/costmon`'s `pio_hbm_table_bytes` reads). A
fold tick starts from the
deployed factor tables and ends by publishing grown and updated ones;
the next tick starts from exactly those. A named slot keeps the tick's
final device tensors, keyed by weak references to the host arrays of the
model version it published: when the next tick presents the same host
arrays, it reuses the device tensors and uploads only its solve plans.
A slot dies with its key arrays (weakref callbacks), so a model that is
no longer served never pins device memory. One version per name.

`PIO_TABLE_BUDGET_BYTES` caps the bytes one factor table may take on the
device; unset, nothing is checked. The reference's tenant attribution
(`tenant_device_arrays`, `tenant_sizes`, `evict_tenant`) comes with
tenancy.
"""

from __future__ import annotations

import os
import threading
import weakref
from typing import Any, Dict, Optional, Tuple

import numpy as np

_lock = threading.Lock()
_cache: Dict[tuple, Tuple[Any, Any]] = {}
# cache key -> (weak ref to the host array, device tensor)
_resident: Dict[str, Tuple[tuple, dict, Any]] = {}
# name -> (weak refs to the key arrays, payload, layout token)


class TableBudgetExceeded(RuntimeError):
    """A factor-table upload would exceed `PIO_TABLE_BUDGET_BYTES`."""


def table_budget_bytes() -> Optional[int]:
    """The enforced per-device factor-table budget, or None (the
    default: no budget)."""
    raw = os.environ.get("PIO_TABLE_BUDGET_BYTES", "").strip()
    if not raw:
        return None
    try:
        b = int(float(raw))
    except ValueError:
        return None
    return b if b > 0 else None


def check_table_budget(per_device_bytes: int, table: str = "table") -> None:
    """Raise `TableBudgetExceeded` when `per_device_bytes` breaks the
    budget; a no-op without one."""
    budget = table_budget_bytes()
    if budget is not None and int(per_device_bytes) > budget:
        raise TableBudgetExceeded(
            f"{table}: {int(per_device_bytes)} bytes per device exceeds "
            f"the enforced table budget of {budget} bytes "
            "(PIO_TABLE_BUDGET_BYTES); raise the budget")


def get_resident(name: str, key_arrays, sharding: Any = None
                 ) -> Optional[dict]:
    """The slot's payload if it was stored against exactly these host
    arrays (identity, through the weak references) and the same layout
    token; None on any mismatch."""
    with _lock:
        entry = _resident.get(name)
    if entry is None:
        return None
    refs, payload, token = entry
    if token != sharding or len(refs) != len(key_arrays):
        return None
    if all(r() is a for r, a in zip(refs, key_arrays)):
        return payload
    return None


def put_resident(name: str, key_arrays, payload: dict,
                 sharding: Any = None) -> None:
    """Store `payload` (device tensors) under `name`, valid while every
    array of `key_arrays` (the published version's host tables) lives;
    replaces the slot's previous version."""
    refs: tuple = ()

    def evict(_ref):
        # runs from the garbage collector, maybe while this thread holds
        # the lock: a plain dict operation, and only if the slot is still
        # the one these references key (a newer version stays)
        entry = _resident.get(name)
        if entry is not None and entry[0] is refs:
            _resident.pop(name, None)

    try:
        refs = tuple(weakref.ref(a, evict) for a in key_arrays)
    except TypeError:
        return    # not weakref-able: no residency rather than a leak
    with _lock:
        _resident[name] = (refs, payload, sharding)



def _evict_cache_key(key):
    """Weak-reference callback body: lock-free (the garbage collector may
    run it while this thread holds `_lock`; a dict pop is atomic)."""
    _cache.pop(key, None)


def _device_key(device) -> str:
    import torch
    return str(torch.device(device if device is not None else "cuda"))


def _lookup(key, arr):
    with _lock:
        entry = _cache.get(key)
    if entry is not None and entry[0]() is arr:
        return entry[1]
    return None


def _store(key, arr, dev):
    try:
        ref = weakref.ref(arr, lambda r, k=key: _evict_cache_key(k))
    except TypeError:
        return dev      # not weakref-able: no caching
    with _lock:
        _cache[key] = (ref, dev)
    return dev


def _upload(host, device):
    """Host numpy -> `device`, counted in `obs/torchmon`. Always a copy:
    a CPU tensor sharing the array's memory would keep the array alive
    through the cache entry that is to die with it."""
    import torch
    from predictionio_tpu_torch.obs import torchmon
    host = np.ascontiguousarray(host)
    torchmon.record_h2d(int(host.nbytes))
    return torch.from_numpy(host).to(device, copy=True)


def _pad_rows(arr, target: int):
    """`arr` with dim 0 zero-padded to `target` rows (numpy or a tensor,
    padded where it lies)."""
    n = arr.shape[0]
    if target == n:
        return arr
    if isinstance(arr, np.ndarray):
        return np.concatenate(
            [arr, np.zeros((target - n,) + arr.shape[1:], arr.dtype)])
    import torch
    pad = torch.zeros((target - n,) + tuple(arr.shape[1:]),
                      dtype=arr.dtype, device=arr.device)
    return torch.cat([arr, pad])


def cached_put(arr, device=None):
    """`arr` on `device` (None = the card), uploaded once per (array
    identity, device) and evicted when `arr` is garbage-collected."""
    key = (id(arr), _device_key(device))
    dev = _lookup(key, arr)
    if dev is not None:
        return dev
    return _store(key, arr, _upload(arr, device or "cuda"))


def cached_put_padded(arr, device, row_multiple: int):
    """`cached_put` with dim 0 zero-padded up to a multiple of
    `row_multiple`, memoized on (array identity, device, multiple)."""
    key = (id(arr), _device_key(device), "pad", int(row_multiple))
    dev = _lookup(key, arr)
    if dev is not None:
        return dev
    n = arr.shape[0]
    target = ((n + row_multiple - 1) // row_multiple) * row_multiple
    return _store(key, arr, _upload(_pad_rows(arr, target),
                                    device or "cuda"))


def cached_put_rows(arr, target_rows: int, device=None):
    """`cached_put` with dim 0 zero-padded to `target_rows`: the
    shape-bucket upload of the serve path, so a table's rows grow inside
    their bucket without changing a shape the card sees. Memoized on
    (array identity, rows, device); a `target_rows` below the array's
    rows uploads it unpadded. A `torch.Tensor` is copied, padded, on its
    own device (no upload; `device` is ignored). The padded table is
    checked against `PIO_TABLE_BUDGET_BYTES`."""
    import torch
    target = max(int(target_rows), arr.shape[0])
    on_device = isinstance(arr, torch.Tensor)
    key = (id(arr), "rows", target,
           str(arr.device) if on_device else _device_key(device))
    dev = _lookup(key, arr)
    if dev is not None:
        return dev
    row_bytes = (int(np.prod(arr.shape[1:], dtype=np.int64))
                 * arr.element_size() if on_device
                 else int(np.prod(arr.shape[1:], dtype=np.int64))
                 * arr.dtype.itemsize)
    check_table_budget(target * row_bytes, table="cached_put_rows")
    if on_device:
        # always a distinct tensor: the cache keeps it while `arr` lives,
        # and what holds it (a captured graph) must not keep `arr` alive
        padded = _pad_rows(arr, target)
        padded = padded.clone() if padded is arr else padded
    else:
        padded = _upload(_pad_rows(arr, target), device or "cuda")
    return _store(key, arr, padded)


def cache_size() -> int:
    with _lock:
        return len(_cache)


def clear() -> None:
    """Drop every cached upload and residency slot."""
    with _lock:
        _cache.clear()
        _resident.clear()


def drop_resident(name: str) -> None:
    with _lock:
        _resident.pop(name, None)


def _device_nbytes(arr) -> int:
    """Bytes the device holds for `arr` (a tensor's storage in use, a
    host array's nbytes; anything else 0). The port has no sharded
    tables yet, so a table costs its whole size on its one device."""
    nbytes = getattr(arr, "nbytes", None)
    if nbytes is None and hasattr(arr, "element_size"):
        return int(arr.numel() * arr.element_size())
    return int(nbytes or 0)


def _payload_nbytes(obj) -> int:
    """Bytes held by a residency payload: dicts and sequences walked
    (fold payloads are flat dicts of tensors and (tensor, gram) pairs)."""
    if isinstance(obj, dict):
        return sum(_payload_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_payload_nbytes(v) for v in obj)
    return _device_nbytes(obj)


def resident_sizes() -> Dict[str, int]:
    """name -> device bytes of every live residency slot (the samples of
    `pio_hbm_table_bytes{table}`)."""
    with _lock:
        items = list(_resident.items())
    return {name: _payload_nbytes(payload)
            for name, (_refs, payload, _tok) in items}
