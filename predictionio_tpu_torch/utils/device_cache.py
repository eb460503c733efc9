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
pads it there, and with a `sharding` (`parallel/mesh.MeshContext.
model_sharded`) uploads a `DeviceShards` split by rows instead, held to
the budget one shard at a time (`_row_shards`). The layout is part of
every key (`_sharding_key`), so a whole and a split copy of one host
array never alias. Every upload counts its bytes in `obs/torchmon`.

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
device; unset, nothing is checked.

Tenant attribution (the serving host's HBM budget, `tenancy/budget.py`):
every upload stored in the cache and every residency slot is tagged with
the tenant of `obs/tenantctx.tenant_scope` active at put time; an upload
stored outside any scope is tagged by the first scope that reads it.
`tenant_device_arrays` lists the tensors held for each tenant,
`tenant_sizes` sums their bytes and `evict_tenant` drops one tenant's
entries and slots. The sums go by storage, not by object: two tensors
that view one storage (a padded copy's slice, a payload that shares a
cache entry's tensor) count the storage's bytes once, and what a tenant
holds is what its live storages hold. A dropped entry frees its memory
only once nothing else holds the storage: a captured CUDA graph does
(`compile/aot.py`), so the serving host's evictor drops the tenant's
graphs too.
"""

from __future__ import annotations

import os
import threading
import weakref
from typing import Any, Dict, Optional, Tuple

import numpy as np

from predictionio_tpu_torch.obs.tenantctx import (_tenant_var,  # noqa: F401
                                                  current_tenant,
                                                  tenant_scope)

_lock = threading.Lock()
_cache: Dict[tuple, Tuple[Any, Any]] = {}
# cache key -> (weak ref to the host array, device tensor)
_resident: Dict[str, Tuple[tuple, dict, Any]] = {}
# name -> (weak refs to the key arrays, payload, layout token)
_tenant_keys: Dict[tuple, str] = {}
# cache key -> the tenant whose scope stored it
_tenant_slots: Dict[str, str] = {}
# residency slot name -> the tenant whose scope stored it


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


def _sharding_key(sharding) -> Any:
    """The cache-key part of a layout (`parallel/mesh.Sharding`): None
    for a whole tensor, else the mesh's identity and the axis of each
    dim, so equal layouts share an entry and no two layouts alias."""
    if sharding is None:
        return None
    return (id(sharding.mesh), tuple(sharding.spec))


def _row_shards(sharding) -> int:
    """How many ways a layout splits dim 0 (1 for none): the divisor from
    a table's bytes to one shard's."""
    if sharding is None or not sharding.spec or sharding.spec[0] is None:
        return 1
    return sharding.mesh.axis_size(sharding.spec[0])


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
        # the one these references key (a newer version stays); at
        # interpreter exit the module's dicts may be gone already
        if _resident is None or _tenant_slots is None:
            return
        entry = _resident.get(name)
        if entry is not None and entry[0] is refs:
            _resident.pop(name, None)
            _tenant_slots.pop(name, None)

    try:
        refs = tuple(weakref.ref(a, evict) for a in key_arrays)
    except TypeError:
        return    # not weakref-able: no residency rather than a leak
    with _lock:
        _resident[name] = (refs, payload, sharding)
        t = _tenant_var.get()
        if t is not None:
            _tenant_slots[name] = t
        else:
            _tenant_slots.pop(name, None)


def _evict_cache_key(key):
    """Weak-reference callback body: lock-free (the garbage collector may
    run it while this thread holds `_lock`; a dict pop is atomic). At
    interpreter exit the module's dicts may be gone already."""
    if _cache is None or _tenant_keys is None:
        return
    _cache.pop(key, None)
    _tenant_keys.pop(key, None)


def _device_key(device) -> str:
    import torch
    return str(torch.device(device if device is not None else "cuda"))


def _lookup(key, arr):
    with _lock:
        entry = _cache.get(key)
        if entry is None or entry[0]() is not arr:
            return None
        t = _tenant_var.get()
        if t is not None and key not in _tenant_keys:
            # stored outside any scope (a model placed before its tenant
            # was admitted): the first tenant to read it holds it
            _tenant_keys[key] = t
    return entry[1]


def _store(key, arr, dev):
    try:
        ref = weakref.ref(arr, lambda r, k=key: _evict_cache_key(k))
    except TypeError:
        return dev      # not weakref-able: no caching
    with _lock:
        _cache[key] = (ref, dev)
        t = _tenant_var.get()
        if t is not None:
            _tenant_keys[key] = t
        else:
            _tenant_keys.pop(key, None)
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


def cached_put_rows(arr, target_rows: int, device=None, sharding=None):
    """`cached_put` with dim 0 zero-padded to `target_rows`: the
    shape-bucket upload of the serve path, so a table's rows grow inside
    their bucket without changing a shape the card sees. Memoized on
    (array identity, rows, device, layout); a `target_rows` below the
    array's rows uploads it unpadded. A `torch.Tensor` is copied, padded,
    on its own device (no upload; `device` is ignored). With a
    `sharding` (a host array only) the padded table uploads split as it
    says, on its mesh's device. The padded table, or one shard of it, is
    checked against `PIO_TABLE_BUDGET_BYTES`."""
    import torch
    target = max(int(target_rows), arr.shape[0])
    on_device = isinstance(arr, torch.Tensor)
    if sharding is not None:
        device = sharding.mesh.device
    key = (id(arr), "rows", target,
           str(arr.device) if on_device else _device_key(device))
    if sharding is not None:
        key = key + (_sharding_key(sharding),)
    dev = _lookup(key, arr)
    if dev is not None:
        return dev
    row_bytes = (int(np.prod(arr.shape[1:], dtype=np.int64))
                 * arr.element_size() if on_device
                 else int(np.prod(arr.shape[1:], dtype=np.int64))
                 * arr.dtype.itemsize)
    check_table_budget(target * row_bytes // _row_shards(sharding),
                       table="cached_put_rows")
    if sharding is not None:
        return _store(key, arr, sharding.mesh.put(_pad_rows(arr, target),
                                                  sharding))
    if on_device:
        # always a distinct tensor: the cache keeps it while `arr` lives,
        # and what holds it (a captured graph) must not keep `arr` alive
        padded = _pad_rows(arr, target)
        padded = padded.clone() if padded is arr else padded
    else:
        padded = _upload(_pad_rows(arr, target), device or "cuda")
    return _store(key, arr, padded)


def cached_table(arr, device=None):
    """`arr` on `device` as the first rows of its bucket-padded upload
    (`cached_put_rows` at `bucket_rows`): a view that shares the serve
    path's padded copy, the same object while that upload lives. The
    view is registered as already padded, so a ranking that pads it to
    its row bucket (`cached_put_rows(view, bucket_rows(n))`) reads the
    same storage and copies nothing."""
    from predictionio_tpu_torch.compile.buckets import bucket_rows
    n = arr.shape[0]
    target = max(bucket_rows(n), n)
    padded = cached_put_rows(arr, target, device)
    key = (id(arr), "table", _device_key(device))
    view = _lookup(key, arr)
    if view is not None:
        return view
    view = _store(key, arr, padded[:n])
    _store((id(view), "rows", target, str(view.device)), view, padded)
    return view


def adopt_rows(arr, table, device=None) -> None:
    """Hold the device tensor `table` as `arr`'s padded upload at
    `table`'s rows (`cached_put_rows(arr, len(table), device)` returns it
    from now on): a fold's resident tables serve the model it publishes
    without a second copy. `table` must hold `arr` in its first rows and
    must not be written in place afterwards."""
    key = (id(arr), "rows", int(table.shape[0]), _device_key(device))
    _store(key, arr, table)


def cache_size() -> int:
    with _lock:
        return len(_cache)


def clear() -> None:
    """Drop every cached upload and residency slot."""
    with _lock:
        _cache.clear()
        _resident.clear()
        _tenant_keys.clear()
        _tenant_slots.clear()


def drop_resident(name: str) -> None:
    with _lock:
        _resident.pop(name, None)
        _tenant_slots.pop(name, None)


def _device_nbytes(arr) -> int:
    """Bytes one device holds for `arr` (a tensor's storage in use, a
    host array's nbytes; anything else 0). A `DeviceShards` split by
    rows counts its largest shard: what one logical device of the mesh
    holds, so the table gauge reads 1/S of a sharded table, as the
    reference's does (on one card the card holds every shard)."""
    parts = getattr(arr, "tensors", None)
    if parts is not None and getattr(arr, "dim", 0) == 0:
        return max((int(t.numel() * t.element_size()) for t in parts),
                   default=0)
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


def _payload_arrays(obj):
    """The array-like leaves of a residency payload (the walk of
    `_payload_nbytes`)."""
    if isinstance(obj, dict):
        for v in obj.values():
            yield from _payload_arrays(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _payload_arrays(v)
    elif getattr(obj, "tensors", None) is not None:
        # a DeviceShards: its shard tensors, each a storage of its own
        yield from _payload_arrays(list(obj.tensors))
    elif obj is not None and _device_nbytes(obj):
        yield obj


def storage_of(arr) -> Tuple[Any, int]:
    """(identity, bytes) of the memory `arr` holds: a tensor's untyped
    storage (its device and address; the whole storage's bytes, views
    included), anything else by object identity and `nbytes`."""
    storage = getattr(arr, "untyped_storage", None)
    if storage is not None:
        st = storage()
        return ((str(arr.device), st.data_ptr()), int(st.nbytes()))
    return (("id", id(arr)), _device_nbytes(arr))


def storage_nbytes(arrays) -> int:
    """Bytes the distinct storages behind `arrays` hold (None skipped)."""
    seen = set()
    total = 0
    for a in arrays:
        if a is None:
            continue
        key, nbytes = storage_of(a)
        if key not in seen:
            seen.add(key)
            total += nbytes
    return total


def tenant_device_arrays() -> Dict[str, list]:
    """tenant -> the tensors this cache and the residency slots hold for
    it (cache entries and residency payload leaves)."""
    with _lock:
        devs = [(t, _cache[k][1]) for k, t in list(_tenant_keys.items())
                if k in _cache]
        payloads = [(t, _resident[n][1])
                    for n, t in list(_tenant_slots.items())
                    if n in _resident]
    out: Dict[str, list] = {}
    for t, dev in devs:
        out.setdefault(t, []).extend(_payload_arrays(dev))
    for t, payload in payloads:
        out.setdefault(t, []).extend(_payload_arrays(payload))
    return out


def tenant_sizes() -> Dict[str, int]:
    """tenant -> bytes of the distinct live storages this cache and the
    residency slots hold for it; a tenant holding nothing has no entry."""
    return {t: storage_nbytes(arrs)
            for t, arrs in tenant_device_arrays().items()}


def evict_tenant(tenant: str) -> Tuple[int, int]:
    """Drop every cache entry and residency slot attributed to `tenant`.
    Returns (entries dropped, bytes of the distinct storages they held).
    The host arrays stay: the next use re-uploads through `cached_put*`.
    A tensor a dispatched window still holds lives until the window ends;
    a graph holding one keeps it (the serving host drops those)."""
    tenant = str(tenant)
    dropped = 0
    held = []
    with _lock:
        for k in [k for k, t in list(_tenant_keys.items()) if t == tenant]:
            entry = _cache.pop(k, None)
            _tenant_keys.pop(k, None)
            if entry is not None:
                dropped += 1
                held.extend(_payload_arrays(entry[1]))
        for n in [n for n, t in list(_tenant_slots.items())
                  if t == tenant]:
            entry = _resident.pop(n, None)
            _tenant_slots.pop(n, None)
            if entry is not None:
                dropped += 1
                held.extend(_payload_arrays(entry[1]))
    return dropped, storage_nbytes(held)
