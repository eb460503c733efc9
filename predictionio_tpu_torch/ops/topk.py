"""Two-phase top-k over a factor table split by rows over the model axis.

The port's counterpart of `predictionio_tpu/ops/topk.py`
(`sharded_top_k`, `sharded_k_split`, `make_batched_sharded_topk`,
`batched_sharded_top_k` and its `_begin` split). When the item table is
a `ShardedTable`, serving ranks across its shards in two phases: each
shard ranks its own rows (`torch.topk` over the shard's scores), the
(score, global index) candidates of every shard are gathered (k x S
values, not the score rows), and a last `torch.topk` picks the answer.
The shards a process holds are merged in the process; with P > 1
processes the candidates travel by `parallel/mesh.all_gather` (gloo,
counted in `collective_stats`). The reference's version is `lax.top_k`
inside `shard_map`, not a Pallas kernel, so `torch.topk` is its
counterpart.

On one process the batched program is a plain sequence of launches, so
the serve path dispatches it through the executable registry
(`compile/aot.py`) and replays it as a CUDA graph keyed on the shard
layout (the `s` dim). Across processes its gather is a host collective,
which no graph can hold: it runs eagerly, and no warm-up captures it.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.parallel.mesh import (MeshContext, all_gather,
                                                  current_mesh)


def sharded_k_split(k: int, padded_rows: int,
                    n_shards: int) -> Tuple[int, int]:
    """(k_local, k_final) of one sharded ranking: a shard gives at most
    its row count, and the answer at most `n_shards * k_local`
    candidates. Exact for any k, since the global top-k takes at most a
    shard's rows from any one shard; a function of the bucket dims
    only."""
    shard_rows = max(padded_rows // n_shards, 1)
    k_local = min(k, shard_rows)
    return k_local, min(k, n_shards * k_local)


def _merge(mesh: MeshContext, cand_s: Sequence[torch.Tensor],
           cand_i: Sequence[torch.Tensor], k_final: int):
    """The global top-k of the shards' candidates ([B, k_local] each, in
    shard order): this process's, then every process's in rank order."""
    all_s = torch.cat(list(cand_s), dim=1)
    all_i = torch.cat(list(cand_i), dim=1)
    if mesh.n_processes > 1:
        all_s = torch.cat(all_gather(all_s), dim=1)
        all_i = torch.cat(all_gather(all_i), dim=1)
    top_s, pos = torch.topk(all_s, k_final, dim=1)
    return top_s, torch.gather(all_i, 1, pos)


def sharded_top_k(item_factors_sharded, query_vec, k: int,
                  mesh: Optional[MeshContext] = None,
                  allowed_mask_sharded=None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """`item_factors_sharded`: a `DeviceShards` [I, R] over the model
    axis; `query_vec` [R] (host or device); `allowed_mask_sharded`: a
    `DeviceShards` [I] bool over the model axis, or None. Returns host
    (scores, global indices)."""
    mesh = mesh or item_factors_sharded.mesh or current_mesh()
    n_items = item_factors_sharded.shape[0]
    mp = mesh.model_parallelism
    k_local, k_final = sharded_k_split(k, n_items, mp)
    dev = item_factors_sharded.device
    q = torch.as_tensor(np.asarray(query_vec, dtype=np.float32)
                        if not isinstance(query_vec, torch.Tensor)
                        else query_vec).to(dev, item_factors_sharded.dtype)
    masks = (allowed_mask_sharded.tensors
             if allowed_mask_sharded is not None else None)
    cand_s, cand_i = [], []
    for j, (off, v) in enumerate(item_factors_sharded.addressable_shards):
        scores = torch.matmul(v, q)
        if masks is not None:
            scores = scores.masked_fill(~masks[j], float("-inf"))
        s, i = torch.topk(scores, k_local)
        cand_s.append(s[None, :])
        cand_i.append((i + off)[None, :])
    top_s, top_i = _merge(mesh, cand_s, cand_i, k_final)
    return (top_s[0].cpu().numpy()[:k_final],
            top_i[0].cpu().numpy()[:k_final])


def make_batched_sharded_topk(mesh: MeshContext, k_local: int,
                              k_final: int, has_mask: bool,
                              filter_positive: bool, pack: int = 0):
    """The batched two-phase top-k for one (mesh, statics) combination,
    one process-wide callable a key (`compile/aot.shared_jit`).

    `fn(q [B, R], v_shard DeviceShards [I, R], n_items, *mask)` ->
    `(scores [B, k_final], global indices [B, k_final])`, or with `pack`
    > 0 the one readback payload (`ops/readback.pack_device`) made after
    the merge. `mask`: the held shards' [B, I/S] bool parts, one tensor
    a shard. Rows at or past `n_items` (bucket padding) rank last
    (-inf), as do masked entries and, with `filter_positive`, scores
    <= 0; the callers drop -inf slots."""
    from predictionio_tpu_torch.compile.aot import get_aot
    from predictionio_tpu_torch.ops import readback

    def _kernel(q, v_shard, n_items: int, *mask):
        cand_s, cand_i = [], []
        for j, (base, v) in enumerate(v_shard.addressable_shards):
            scores = torch.matmul(q, v.T)
            allowed = None
            rows = v.shape[0]
            if base + rows > n_items:
                valid = torch.arange(rows, device=q.device) + base < n_items
                allowed = valid[None, :]
            if has_mask:
                allowed = (mask[j] if allowed is None
                           else allowed & mask[j])
            if filter_positive:
                pos = scores > 0
                allowed = pos if allowed is None else allowed & pos
            if allowed is not None:
                scores = scores.masked_fill(~allowed, float("-inf"))
            s, i = torch.topk(scores, k_local, dim=1)
            cand_s.append(s)
            cand_i.append(i + base)
        top_s, top_i = _merge(mesh, cand_s, cand_i, k_final)
        if pack:
            return readback.pack_device(top_s, top_i, pack)
        return top_s, top_i

    key = (f"topk.sharded_batched:{id(mesh)}:{mesh.model_parallelism}:"
           f"{k_local}:{k_final}:{int(has_mask)}:{int(filter_positive)}:"
           f"{int(pack)}")
    return get_aot().shared_jit(key, _kernel)


def batched_sharded_top_k(item_dev, query_vecs: np.ndarray, n_items: int,
                          k_bucket: int, mesh: MeshContext,
                          masks: Optional[np.ndarray] = None,
                          filter_positive: bool = False,
                          label: Optional[str] = None,
                          dims: Optional[dict] = None, bound: tuple = ()
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Rank `query_vecs` (padded to their batch bucket) against the
    resident model-sharded `item_dev`; `masks` (padded [B, I_bucket]
    bool, or None) upload split over the item dim. Dispatches through
    the executable registry when `label` and `dims` are given."""
    return batched_sharded_top_k_begin(
        item_dev, query_vecs, n_items, k_bucket, mesh, masks=masks,
        filter_positive=filter_positive, label=label, dims=dims,
        bound=bound)()


def batched_sharded_top_k_begin(item_dev, query_vecs: np.ndarray,
                                n_items: int, k_bucket: int,
                                mesh: MeshContext,
                                masks: Optional[np.ndarray] = None,
                                filter_positive: bool = False,
                                label: Optional[str] = None,
                                dims: Optional[dict] = None,
                                bound: tuple = ()):
    """`batched_sharded_top_k` in two stages: upload the queries (and
    masks), enqueue the ranking and the copy of its (packed) result now
    (`ops/readback.begin_fetch`), and return `finish() -> (scores,
    idx)`, which only waits for the copy, so the merge of one window
    overlaps the forming of the next. One process dispatches through the
    registry (`label`, `dims`, `bound`: a captured graph a bucket, shard
    layout and owner); several run the program eagerly, its candidate
    gather a collective every process enters in the same order."""
    from predictionio_tpu_torch.obs import torchmon
    from predictionio_tpu_torch.obs.costmon import device_timed
    from predictionio_tpu_torch.ops import readback

    padded_rows = int(item_dev.shape[0])
    k_local, k_final = sharded_k_split(k_bucket, padded_rows,
                                       mesh.model_parallelism)
    p = dims["p"] if dims and "p" in dims else readback.pack_flag()
    fn = make_batched_sharded_topk(mesh, k_local, k_final,
                                   masks is not None, filter_positive,
                                   pack=p)
    dev = item_dev.device
    q = np.ascontiguousarray(query_vecs, dtype=np.float32)
    torchmon.record_h2d(q.nbytes)
    args = [readback.to_device(q, dev).to(item_dev.dtype)]
    if masks is not None:
        mask_dev = mesh.put(np.ascontiguousarray(masks, dtype=bool),
                            mesh.sharding(None, mesh.MODEL_AXIS))
        args.extend(mask_dev.tensors)
    program = functools.partial(_bound_program, fn, item_dev, int(n_items))
    if label is not None and dims is not None and mesh.n_processes == 1:
        from predictionio_tpu_torch.compile.aot import get_aot
        out = get_aot().dispatch(label, dims, program, *args, bound=bound)
    else:
        out = device_timed(label or "sharded_topk", program, *args)
    if p:
        return readback.begin_fetch_packed(out, p)
    return readback.begin_fetch(*out)


def _bound_program(fn, item_dev, n_items: int, q, *mask):
    """`fn` with the table and item count bound: the registry's program,
    whose tensor arguments are the query batch and the mask parts."""
    return fn(q, item_dev, n_items, *mask)
