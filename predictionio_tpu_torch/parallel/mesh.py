"""The mesh: processes, logical devices and row shards on torch.distributed.

The port's counterpart of `predictionio_tpu/parallel/mesh.py`
(`init_distributed`, `MeshContext`, `host_fetch`, `host_fetch_sharded`,
`make_mesh`, `current_mesh`, `model_mesh`, `use_mesh`).

The reference's mesh is a `jax.sharding.Mesh` over TPU chips with two
named axes, `data` (batch rows) and `model` (factor-table rows), and
GSPMD puts the collectives in. The port's mesh is

- a `torch.distributed` process group of P processes, one device each
  (`init_distributed`, driven by `PIO_COORDINATOR` /
  `PIO_NUM_PROCESSES` / `PIO_PROCESS_ID` as the reference's is);
- a grid of logical devices, `data_parallelism` x `model_parallelism`
  (S), where S is a multiple of P when a table is split over the
  processes: process p holds the model shards [p S/P, (p+1) S/P), each a
  tensor of its own on the process's device. A row-split array is a
  `DeviceShards`: the shards this process holds, with their global row
  offsets.

On the one H100 the mesh has P = 1 and S = 2 or 4: the shards are
distinct tensors on the same card, so every per-shard code path (the
local top-k of each shard, the candidate merge, the per-shard uploads
and the copy-on-write of touched shards) runs on real hardware. Here, on
the CPU, P = 2 runs over gloo. NCCL takes no two ranks on one device, so
two processes that share one card (the card's two-process deploy) run
over gloo too; across cards the group is NCCL. The port's collectives
move small host-side payloads: a query window's broadcast, the k x S
candidates of a sharded top-k, and a sharded train's solved rows. They
run through `broadcast`, `all_gather` and `all_reduce` here, on a gloo
group (the process group itself, or a gloo group beside an NCCL one),
and each call is counted in `parallel/collective_stats.py`.

The reference's `configure_compilation_cache` has no counterpart: the
port's `compile/cache.py` is the salted `nvcc` build directory.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_local = threading.local()
_host_group = None

#: how long a rank waits for the coordinator (and a collective for its
#: peers) before raising
INIT_TIMEOUT_S = 60.0


def _dist():
    import torch.distributed as dist
    return dist


def world_size() -> int:
    """P: the processes of the mesh (1 when none was initialized)."""
    dist = _dist()
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_initialized() else 0


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device=None,
                     timeout_s: float = INIT_TIMEOUT_S) -> None:
    """Join the process group (`torch.distributed.init_process_group` at
    `tcp://<coordinator>`). A no-op without a coordinator, from the
    arguments or `PIO_COORDINATOR` ("host:port"); then
    `PIO_NUM_PROCESSES` and `PIO_PROCESS_ID` name the world size and this
    process's rank. The backend is gloo on the CPU, and when the
    processes outnumber the cards (several share one); NCCL otherwise,
    with a gloo group beside it for the host-side collectives. With more
    than one process and no reachable coordinator this raises after
    `timeout_s`; it never quietly runs single-process."""
    global _host_group
    import torch
    dist = _dist()
    coordinator = coordinator or os.environ.get("PIO_COORDINATOR")
    if coordinator is None:
        return
    if dist.is_initialized():
        return
    if num_processes is None:
        num_processes = int(os.environ["PIO_NUM_PROCESSES"])
    if process_id is None:
        process_id = int(os.environ["PIO_PROCESS_ID"])
    dev = torch.device("cuda" if device is None else device)
    on_card = dev.type == "cuda" and torch.cuda.is_available()
    shared_card = on_card and torch.cuda.device_count() < num_processes
    be = "nccl" if on_card and not shared_card else "gloo"
    if on_card and be == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        be, init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    _host_group = dist.new_group(backend="gloo") if be == "nccl" else None
    logger.info("torch.distributed initialized: process %d/%d via %s (%s)",
                process_id, num_processes, coordinator, be)


# -- the collectives (counted) ---------------------------------------------

def _host_side(t):
    """`t` where the host group's backend takes it: gloo takes CPU
    tensors."""
    return t.cpu() if t.device.type != "cpu" else t


def broadcast(t, src: int = 0):
    """`t` broadcast from rank `src` (in place on a CPU tensor); returns
    the broadcast tensor, on `t`'s device."""
    from predictionio_tpu_torch.parallel import collective_stats
    host = _host_side(t)
    _dist().broadcast(host, src=src, group=_host_group)
    collective_stats.record("broadcast",
                            host.numel() * host.element_size())
    if host is not t:
        t.copy_(host)
    return t


def all_gather(t) -> List:
    """Every rank's `t` (same shape on every rank), in rank order, on
    `t`'s device."""
    from predictionio_tpu_torch.parallel import collective_stats
    import torch
    host = _host_side(t).contiguous()
    out = [torch.empty_like(host) for _ in range(world_size())]
    _dist().all_gather(out, host, group=_host_group)
    collective_stats.record(
        "all-gather", len(out) * host.numel() * host.element_size())
    if t.device.type != "cpu":
        out = [o.to(t.device) for o in out]
    return out


def all_reduce(t):
    """The sum of every rank's `t`, written into `t` and returned."""
    from predictionio_tpu_torch.parallel import collective_stats
    host = _host_side(t)
    _dist().all_reduce(host, group=_host_group)
    collective_stats.record("all-reduce",
                            host.numel() * host.element_size())
    if host is not t:
        t.copy_(host)
    return t


# -- shardings and sharded arrays --------------------------------------------

@dataclass(frozen=True)
class Sharding:
    """The mesh axis (or None) each dim of an array is split over."""
    mesh: "MeshContext"
    spec: Tuple[Optional[str], ...]

    def split(self) -> Tuple[Optional[int], Optional[str]]:
        """(dim, axis) of the one split dim, or (None, None)."""
        for d, ax in enumerate(self.spec):
            if ax is not None:
                return d, ax
        return None, None


class DeviceShards:
    """An array split along `dim` into `n_parts` equal parts over a mesh
    axis: the parts this process holds, each a tensor of its own, with
    the global offset of each along `dim`. The port's counterpart of a
    sharded `jax.Array`."""

    def __init__(self, tensors: Sequence, offsets: Sequence[int],
                 shape: Tuple[int, ...], n_parts: int, dim: int = 0,
                 mesh: Optional["MeshContext"] = None):
        self.tensors = tuple(tensors)
        self.offsets = tuple(int(o) for o in offsets)
        self.shape = tuple(int(s) for s in shape)
        self.n_parts = int(n_parts)
        self.dim = int(dim)
        self.mesh = mesh
        if not self.tensors:
            raise ValueError("DeviceShards needs at least one part")

    @property
    def dtype(self):
        return self.tensors[0].dtype

    @property
    def device(self):
        return self.tensors[0].device

    @property
    def addressable_shards(self) -> List[Tuple[int, object]]:
        return list(zip(self.offsets, self.tensors))

    @property
    def is_fully_addressable(self) -> bool:
        return (sum(t.shape[self.dim] for t in self.tensors)
                == self.shape[self.dim])

    @property
    def nbytes(self) -> int:
        """Bytes this process holds."""
        return sum(t.numel() * t.element_size() for t in self.tensors)

    def full(self):
        """The whole array as one tensor on this process's device: the
        held parts concatenated (every part must be held), else gathered
        from the other processes (`all_gather`)."""
        import torch
        if self.is_fully_addressable:
            return torch.cat(self.tensors, dim=self.dim)
        local = torch.cat(self.tensors, dim=self.dim)
        return torch.cat(all_gather(local), dim=self.dim)

    def __repr__(self) -> str:
        return (f"DeviceShards(shape={self.shape}, parts={self.n_parts}, "
                f"held={len(self.tensors)}, dim={self.dim})")


class MeshContext:
    """A named-axis grid of logical devices over the process group, plus
    the sharding constructors."""

    DATA_AXIS = "data"
    MODEL_AXIS = "model"

    def __init__(self, n_devices: int, model_parallelism: int, device,
                 n_processes: int = 1, process: int = 0):
        self._n = int(n_devices)
        self._mp = int(model_parallelism)
        self.device = device
        self.n_processes = int(n_processes)
        self.process = int(process)

    # -- constructors -------------------------------------------------------
    @staticmethod
    def create(devices=None, model_parallelism: int = 1,
               device=None) -> "MeshContext":
        """`devices`: the logical device count, or a sequence of them
        (default: one a model shard, and at least one a process).
        `device`: this process's device (None = the card)."""
        from predictionio_tpu_torch.device import resolve_device
        dev = resolve_device(device)
        p, rank = world_size(), process_index()
        if devices is None:
            n = max(int(model_parallelism), p)
        elif isinstance(devices, int):
            n = devices
        else:
            n = len(list(devices))
        if model_parallelism < 1 or n % model_parallelism != 0:
            raise ValueError(
                f"model_parallelism {model_parallelism} does not divide "
                f"device count {n}")
        dp = n // model_parallelism
        for size, name in ((model_parallelism, "model"), (dp, "data")):
            if size >= p and size % p:
                raise ValueError(
                    f"the {name} axis ({size}) does not split evenly over "
                    f"{p} processes")
        return MeshContext(n, model_parallelism, dev, p, rank)

    # -- properties ---------------------------------------------------------
    @property
    def n_devices(self) -> int:
        return self._n

    @property
    def data_parallelism(self) -> int:
        return self._n // self._mp

    @property
    def model_parallelism(self) -> int:
        return self._mp

    @property
    def shape(self) -> dict:
        return {self.DATA_AXIS: self.data_parallelism,
                self.MODEL_AXIS: self.model_parallelism}

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def owned_parts(self, axis: str) -> range:
        """The parts of `axis` this process holds: a contiguous 1/P of
        them, or all of them when the axis is narrower than the group."""
        size = self.axis_size(axis)
        if size < self.n_processes:
            return range(size)
        per = size // self.n_processes
        return range(self.process * per, (self.process + 1) * per)

    # -- sharding constructors ---------------------------------------------
    def sharding(self, *axis_per_dim) -> Sharding:
        """The mesh axis (or None) per array dim."""
        return Sharding(self, tuple(axis_per_dim))

    def replicated(self) -> Sharding:
        return Sharding(self, ())

    def batch_sharded(self, ndim: int = 1) -> Sharding:
        """First dim split over the data axis, the rest whole."""
        return self.sharding(self.DATA_AXIS, *([None] * (ndim - 1)))

    def model_sharded(self, ndim: int = 1) -> Sharding:
        """First dim split over the model axis (factor-table rows)."""
        return self.sharding(self.MODEL_AXIS, *([None] * (ndim - 1)))

    # -- data movement ------------------------------------------------------
    def put(self, x, sharding: Sharding):
        """Host array -> this process's device: one tensor when nothing is
        split, else a `DeviceShards` of the parts this process holds,
        each copied into a tensor of its own."""
        import torch
        from predictionio_tpu_torch.obs import torchmon
        if isinstance(x, torch.Tensor):
            host = x
        else:
            arr = np.ascontiguousarray(np.asarray(x))
            host = torch.from_numpy(arr)
        dim, axis = sharding.split()
        if dim is None:
            torchmon.record_h2d(host.numel() * host.element_size())
            return host.to(self.device, copy=True)
        parts = self.axis_size(axis)
        if host.shape[dim] % parts:
            raise ValueError(
                f"dim {dim} of length {host.shape[dim]} does not divide "
                f"over the {parts}-way {axis} axis (pad_to_multiple)")
        per = host.shape[dim] // parts
        owned = self.owned_parts(axis)
        tensors = []
        for j in owned:
            part = host.narrow(dim, j * per, per)
            torchmon.record_h2d(part.numel() * part.element_size())
            tensors.append(part.to(self.device, copy=True).contiguous())
        return DeviceShards(tensors, [j * per for j in owned],
                            tuple(host.shape), parts, dim, self)

    def put_batch(self, x):
        """Dim 0 split over the data axis; it must divide
        `data_parallelism` (`pad_to_multiple`)."""
        return self.put(x, self.batch_sharded(np.ndim(x)))

    def put_replicated(self, x):
        return self.put(x, self.replicated())

    def put_stacked(self, x):
        """Dim 1 split over the data axis: stacked same-shape batch
        groups [N, B, ...], each group's batch split."""
        ndim = np.ndim(x)
        return self.put(x, self.sharding(None, self.DATA_AXIS,
                                         *([None] * (ndim - 2))))

    def put_model_sharded(self, x):
        """Rows split over the model axis (factor tables)."""
        return self.put(x, self.model_sharded(np.ndim(x)))

    def pad_to_multiple(self, x: np.ndarray, axis: int = 0,
                        multiple: Optional[int] = None,
                        fill=0) -> Tuple[np.ndarray, int]:
        """Pad so dim `axis` divides the data-axis size; returns (padded,
        original length)."""
        multiple = multiple or self.data_parallelism
        n = x.shape[axis]
        target = ((n + multiple - 1) // multiple) * multiple
        if target == n:
            return x, n
        pad_width = [(0, 0)] * x.ndim
        pad_width[axis] = (0, target - n)
        return np.pad(x, pad_width, constant_values=fill), n

    def __repr__(self) -> str:
        return (f"MeshContext(data={self.data_parallelism}, "
                f"model={self.model_parallelism}, "
                f"processes={self.n_processes}, device={self.device})")


def host_fetch(x) -> np.ndarray:
    """Device array -> host numpy. A `DeviceShards` must be held whole by
    this process; one split over processes raises, naming
    `host_fetch_sharded`."""
    if isinstance(x, DeviceShards):
        if not x.is_fully_addressable:
            raise ValueError(
                f"host_fetch needs a whole array; this process holds "
                f"{len(x.tensors)} of the {x.n_parts} parts of {x.shape} "
                f"— use host_fetch_sharded to fetch the per-shard slices "
                f"this process holds")
        return x.full().detach().to("cpu", copy=True).numpy()
    if hasattr(x, "detach"):
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)


def host_fetch_sharded(x):
    """A row-split array -> `(offsets, slices)`: the per-shard host
    slices this process holds, sorted by global row offset, with no
    gather across shards or processes. An array split on a later dim
    raises; an unsplit one is one slice at offset 0."""
    if not isinstance(x, DeviceShards):
        return [0], [host_fetch(x)]
    if x.dim != 0:
        raise ValueError(
            f"host_fetch_sharded needs an array split on dim 0 only; got "
            f"one split on dim {x.dim} of {x.shape}")
    order = sorted(range(len(x.offsets)), key=lambda j: x.offsets[j])
    return ([x.offsets[j] for j in order],
            [x.tensors[j].detach().to("cpu", copy=True).numpy()
             for j in order])


def make_mesh(devices=None, model_parallelism: int = 1,
              device=None) -> MeshContext:
    return MeshContext.create(devices, model_parallelism, device)


def active_mesh() -> Optional[MeshContext]:
    """The thread's active mesh (`use_mesh`), or None."""
    return getattr(_local, "mesh", None)


def current_mesh(device=None) -> MeshContext:
    """The thread's active mesh; without one, a new 1-wide model mesh on
    `device` (None = the card) becomes it."""
    ctx = getattr(_local, "mesh", None)
    if ctx is None:
        ctx = make_mesh(device=device)
        _local.mesh = ctx
    return ctx


_model_mesh_lock = threading.Lock()
_model_meshes: dict = {}


def _same_device(a, b) -> bool:
    import torch
    da, db = torch.device(a), torch.device(b)
    return da.type == db.type and (da.index or 0) == (db.index or 0)


def model_mesh(n_shards: int, device=None) -> MeshContext:
    """A mesh whose model axis is `n_shards` wide, on `device` (None =
    the card): the mesh a model-sharded table trains, serves and folds
    on. The thread's active mesh wins when its model axis (and device)
    match; otherwise one process-wide mesh per (shard count, device) is
    built and kept, so every server thread resolves the same mesh for
    the same layout."""
    ctx = getattr(_local, "mesh", None)
    if (ctx is not None and ctx.model_parallelism == n_shards
            and (device is None or _same_device(ctx.device, device))):
        return ctx
    from predictionio_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    key = (int(n_shards), str(dev), world_size())
    with _model_mesh_lock:
        ctx = _model_meshes.get(key)
        if ctx is None:
            ctx = make_mesh(model_parallelism=n_shards, device=dev)
            _model_meshes[key] = ctx
        return ctx


@contextlib.contextmanager
def use_mesh(ctx: MeshContext):
    prev = getattr(_local, "mesh", None)
    _local.mesh = ctx
    try:
        yield ctx
    finally:
        _local.mesh = prev
