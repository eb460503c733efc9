"""Host ingest: event streams -> arrays split over the mesh.

The port's counterpart of `predictionio_tpu/parallel/dataset.py`. Each
process reads its slice of the event store into numpy and keeps the
parts of the data axis it holds (`sharded_from_process_local`); no
process ever holds the others' rows.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np

from predictionio_tpu_torch.parallel.mesh import (DeviceShards, MeshContext,
                                                  current_mesh)


def sharded_from_host(x: np.ndarray, mesh: Optional[MeshContext] = None,
                      axis: int = 0):
    """Pad dim `axis` to the data-parallel degree and split it over the
    mesh's data axis. Returns (array, original length)."""
    mesh = mesh or current_mesh()
    padded, n = mesh.pad_to_multiple(np.asarray(x), axis=axis)
    return mesh.put_batch(padded), n


def sharded_from_process_local(local_shard: np.ndarray, global_rows: int,
                               mesh: Optional[MeshContext] = None):
    """Every process passes only its own rows (the data-axis parts it
    holds, in order); the result is the global array split over the data
    axis, each process holding its parts. A single process passes the
    whole array (`sharded_from_host`)."""
    mesh = mesh or current_mesh()
    if mesh.n_processes == 1:
        return sharded_from_host(local_shard, mesh)[0]
    import torch
    from predictionio_tpu_torch.obs import torchmon
    dp = mesh.data_parallelism
    if global_rows % dp:
        raise ValueError(f"{global_rows} rows do not split over the "
                         f"{dp}-way data axis")
    per = global_rows // dp
    owned = mesh.owned_parts(mesh.DATA_AXIS)
    local = np.ascontiguousarray(local_shard)
    if local.shape[0] != per * len(owned):
        raise ValueError(
            f"process {mesh.process} holds {len(owned)} parts of {per} "
            f"rows, got {local.shape[0]} rows")
    tensors = []
    for k, j in enumerate(owned):
        part = local[k * per:(k + 1) * per]
        torchmon.record_h2d(int(part.nbytes))
        tensors.append(torch.from_numpy(part).to(mesh.device, copy=True))
    return DeviceShards(tensors, [j * per for j in owned],
                        (global_rows,) + tuple(local.shape[1:]), dp, 0,
                        mesh)


def events_to_ratings_arrays(events: Iterable, rating_of=None
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                        np.ndarray]:
    """(entityId, targetEntityId, rating, time in ms) of an event
    iterator as flat arrays, ready for the id maps and `RatingsCOO`: the
    ingest half of every template's data source, for readers that split
    the event scan by entity."""
    from predictionio_tpu_torch.data.event import to_millis
    users, items, vals, ts = [], [], [], []
    for e in events:
        users.append(e.entity_id)
        items.append(e.target_entity_id)
        vals.append(rating_of(e) if rating_of else 1.0)
        ts.append(to_millis(e.event_time))
    return (np.array(users, dtype=object), np.array(items, dtype=object),
            np.array(vals, dtype=np.float32), np.array(ts, dtype=np.int64))
