"""Cosine-similarity scoring with business-rule filters, top-k on the
model's device.

The port's counterpart of `predictionio_tpu/ops/similarity.py`
(`normalize_rows`, `cosine_top_k` computing `_cosine_topk`,
`build_filter_mask`, `masked_topk_dims`, `register_aot_specs`,
`masked_top_k_batch[_begin]` computing `_masked_topk_b`,
`unpack_top_k_rows`, and the DIMSUM template's
`item_cosine_similarities`). Score = sum over the
query items of cos(q, item); items not allowed by the host-built filter
mask, or with score <= 0, are excluded (`masked_top_k_batch` keeps scores
<= 0 when asked, for explicit-ALS dot scores). Plain PyTorch: one matmul
and `torch.topk` over the item table resident on the device. The batched
path pads the table's rows, its batch and its top-k to pow2 buckets
(`compile/buckets.py`), dispatches through the executable registry
(`compile/aot.py`: a captured CUDA graph, replayed) and returns its
result through the packed readback (`ops/readback.py`). An item table
split over the mesh's model axis (a `ShardedTable`) takes the sharded
route, `_masked_top_k_batch_sharded_begin`: its masks split by item over
the shards and the two-phase top-k of `ops/topk.py`.
"""

from __future__ import annotations

import functools
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device, synchronize
from predictionio_tpu_torch.ops import readback
from predictionio_tpu_torch.compile import buckets as B


def normalize_rows(factors: np.ndarray) -> np.ndarray:
    """Rows scaled to unit L2 norm (a zero row stays 0), float32."""
    norms = np.linalg.norm(factors, axis=-1, keepdims=True)
    return (factors / np.maximum(norms, 1e-12)).astype(np.float32)


def cosine_top_k(item_table: torch.Tensor, query_vecs: np.ndarray, k: int,
                 allowed_mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """item_table [I, R] (L2-normalized rows, on the device), query_vecs
    [Q, R], allowed_mask [I] bool. The query vectors are re-normalized
    (1e-12 clamp) and their cosines summed; items not allowed or with
    score <= 0 are excluded. Returns host (scores, item indices), length
    <= k, excluded (-inf) entries dropped."""
    dev = item_table.device
    n_items = item_table.shape[0]
    q = torch.as_tensor(np.asarray(query_vecs, dtype=np.float32),
                        device=dev)
    qn = q / q.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    scores = (qn @ item_table.T).sum(dim=0)
    allowed = torch.as_tensor(allowed_mask, device=dev) & (scores > 0)
    scores = torch.where(allowed, scores, float("-inf"))
    s, i = torch.topk(scores, min(k, n_items))
    s, i = s.cpu().numpy(), i.cpu().numpy()
    keep = np.isfinite(s)
    return s[keep], i[keep]


def build_filter_mask(n_items: int, exclude: Sequence[int] = (),
                      white_list: Optional[Sequence[int]] = None,
                      item_categories: Optional[
                          Sequence[Optional[set]]] = None,
                      categories: Optional[set] = None) -> np.ndarray:
    """Host-side candidate mask (isCandidateItem): the white list wins,
    black-listed and query items are excluded, and a category
    intersection is required when categories are given."""
    mask = np.ones(n_items, dtype=bool)
    if white_list is not None:
        mask[:] = False
        wl = np.asarray(list(white_list), dtype=np.int64)
        mask[wl[(wl >= 0) & (wl < n_items)]] = True
    ex = np.asarray(list(exclude), dtype=np.int64)
    mask[ex[(ex >= 0) & (ex < n_items)]] = False
    if categories is not None and item_categories is not None:
        mask &= np.array([bool(c and (c & categories))
                          for c in item_categories], dtype=bool)
    return mask


def masked_topk_dims(n_items: int, rank: int, batch: int, k: int,
                     filter_positive: bool = True) -> dict:
    """The shape-bucket dims of one masked top-k, shared by the serve
    dispatch and the deploy warm-up: batch bucket `b`, the table's row
    bucket `i`, the rank `r`, top-k bucket `k` (a pow2 from 16, at most
    `i`), the positive-score filter `fp` and the pack mode `p`."""
    i_b = B.bucket_rows(n_items)
    return {"b": B.bucket_batch(batch), "i": i_b, "r": int(rank),
            "k": min(B.bucket_batch(k, floor=B.K_FLOOR), i_b),
            "fp": int(bool(filter_positive)), "p": readback.pack_flag()}


def _masked_topk_impl(q: torch.Tensor, item_table: torch.Tensor,
                      allowed: torch.Tensor, k: int,
                      filter_positive: bool):
    """Score the batch against every item, mask, top-k."""
    scores = q @ item_table.T
    if filter_positive:
        allowed = allowed & (scores > 0)
    scores = torch.where(allowed, scores, float("-inf"))
    return torch.topk(scores, k, dim=1)


def _masked_topk_b(table: torch.Tensor, q: torch.Tensor,
                   allowed: torch.Tensor, k: int, filter_positive: bool,
                   p: int):
    """The masked serve program on a bucket-padded table (its padding
    rows are masked out); with a pack mode `p` the one output is the
    readback payload."""
    s, i = _masked_topk_impl(q, table, allowed, k, filter_positive)
    return readback.pack_device(s, i, p) if p else (s, i)


def _aot_masked_topk_builder(bound, b: int = 0, i: int = 0, r: int = 0,
                             k: int = 0, fp: int = 0, p: int = 0,
                             s: int = 0):
    """(program, example arguments) of one `batch_predict_masked` bucket
    over the item table `bound` names, padded to the row bucket `i` on
    its device; the query vectors and masks are the static inputs. `s` >
    0: a `ShardedTable`'s `s` shards on the mesh of its resident handle,
    the two-phase top-k, and the masks' per-shard parts."""
    from predictionio_tpu_torch.utils.device_cache import cached_put_rows
    (item_table,) = bound
    if s:
        from predictionio_tpu_torch.compile.aot import sharded_aval
        from predictionio_tpu_torch.ops.topk import (
            _bound_program, make_batched_sharded_topk, sharded_k_split)
        from predictionio_tpu_torch.parallel.mesh import model_mesh
        held = item_table._dev
        mesh = held.mesh if held is not None else model_mesh(s)
        k_local, k_final = sharded_k_split(k, i, s)
        fn = make_batched_sharded_topk(mesh, k_local, k_final, True,
                                       bool(fp), pack=p)
        V = item_table.device(mesh, target_rows=i)
        masks = sharded_aval((b, i), bool, None, mesh.MODEL_AXIS, mesh=mesh)
        return (functools.partial(_bound_program, fn, V, item_table.n_rows),
                (sharded_aval((b, r), np.float32, mesh=mesh),
                 *masks.tensors))
    table = cached_put_rows(item_table, i)
    fn = functools.partial(_masked_topk_b, table, k=k,
                           filter_positive=bool(fp), p=p)
    return fn, (torch.zeros((b, r), dtype=table.dtype, device=table.device),
                torch.zeros((b, i), dtype=torch.bool, device=table.device))


_aot_specs_registered = False


def register_aot_specs() -> None:
    """Register the masked top-k's executable spec with the compile
    plane (once)."""
    global _aot_specs_registered
    if _aot_specs_registered:
        return
    from predictionio_tpu_torch.compile.aot import get_aot
    from predictionio_tpu_torch.obs import costmon
    get_aot().register(costmon.BATCH_PREDICT_MASKED,
                       _aot_masked_topk_builder)
    _aot_specs_registered = True


def masked_top_k_batch(item_table, query_vecs: np.ndarray,
                       masks: np.ndarray, k: int,
                       filter_positive: bool = True, device=None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Batched masked dot top-k in one matmul for B queries.

    query_vecs [B, R] (already in the scoring space: raw user factors for
    dot scoring, summed normalized item vectors for cosine), masks [B, I]
    bool. Items not allowed score -inf; `filter_positive` also drops
    scores <= 0 (the cosine templates' rule; explicit-ALS callers pass
    False, since their scores can be negative). Returns host ([B, k'],
    [B, k']) with k' the bucketed k (at most the table's row bucket);
    callers drop the -inf slots and cut to their own num
    (`unpack_top_k_rows`). The scores are those `PIO_SERVE_PACK` sends
    (f16 by default). `device` places a `ShardedTable` item table (None
    = the card); a tensor table ranks on its own device."""
    return masked_top_k_batch_begin(item_table, query_vecs, masks, k,
                                    filter_positive=filter_positive,
                                    device=device)()


def masked_top_k_batch_begin(item_table, query_vecs: np.ndarray,
                             masks: np.ndarray, k: int,
                             filter_positive: bool = True, device=None):
    """`masked_top_k_batch` in two stages: upload the padded queries and
    masks, enqueue the ranking and the copy of its result now, and
    return `finish() -> (scores [B, k'], idx [B, k'])`, which waits for
    the copy (it may run on another thread). The item table (on its
    device) is padded to its row bucket once (`cached_put_rows`); the
    batch pads to its bucket, and padding rows and columns are masked
    out. The work dispatches through the executable registry
    (`compile/aot.py`), keyed on the item table; no next row bucket is
    captured ahead of growth, since a graph keyed on this table could
    never replay for a grown one (`ops/als.users_topk_serve_begin`)."""
    from predictionio_tpu_torch.compile.aot import get_aot
    from predictionio_tpu_torch.obs import costmon
    from predictionio_tpu_torch.parallel.sharded_table import is_sharded
    from predictionio_tpu_torch.utils.device_cache import cached_put_rows
    if is_sharded(item_table):
        return _masked_top_k_batch_sharded_begin(
            item_table, query_vecs, masks, k, filter_positive, device)
    register_aot_specs()
    dev = item_table.device
    n_items, rank = item_table.shape
    n = query_vecs.shape[0]
    dims = masked_topk_dims(n_items, rank, n, k, filter_positive)
    qp = np.zeros((dims["b"], rank), dtype=np.float32)
    qp[:n] = query_vecs
    mp = np.zeros((dims["b"], dims["i"]), dtype=bool)
    mp[:n, :n_items] = masks
    table = cached_put_rows(item_table, dims["i"])
    k_b, p = dims["k"], dims["p"]
    with costmon.executable(costmon.BATCH_PREDICT_MASKED,
                            defer_to_outer=True):
        out = get_aot().dispatch(
            costmon.BATCH_PREDICT_MASKED, dims,
            functools.partial(_masked_topk_b, table, k=k_b,
                              filter_positive=filter_positive, p=p),
            readback.to_device(qp, dev).to(table.dtype),
            readback.to_device(mp, dev), bound=(item_table,))
    fetch = (readback.begin_fetch_packed(out, p) if p
             else readback.begin_fetch(*out))

    def finish() -> Tuple[np.ndarray, np.ndarray]:
        s, i = fetch()
        return s[:n], i[:n]
    return finish


def _masked_top_k_batch_sharded_begin(item_table, query_vecs: np.ndarray,
                                      masks: np.ndarray, k: int,
                                      filter_positive: bool, device=None):
    """The sharded route of `masked_top_k_batch_begin`: the item table's
    resident shards (uploaded at its sharded row bucket), the padded
    [B, I] masks split by item over the shards, and the two-phase top-k
    (`ops/topk.batched_sharded_top_k_begin`) under the same
    `batch_predict_masked` label; the `s` dim keeps the sharded and
    replicated buckets apart. The executable is keyed on the table.
    Returns `finish() -> (scores, idx)`."""
    from predictionio_tpu_torch.obs import costmon
    from predictionio_tpu_torch.ops.topk import batched_sharded_top_k_begin
    from predictionio_tpu_torch.parallel.mesh import model_mesh
    mesh = model_mesh(item_table.n_shards, device)
    n_items = item_table.shape[0]
    n, rank = query_vecs.shape
    i_b = max(item_table.padded_rows,
              B.bucket_rows_sharded(n_items, item_table.n_shards))
    dims = {"b": B.bucket_batch(n), "i": i_b, "r": int(rank),
            "k": min(B.bucket_batch(k, floor=B.K_FLOOR), i_b),
            "fp": int(bool(filter_positive)), "s": item_table.n_shards,
            "p": readback.pack_flag()}
    qp = np.zeros((dims["b"], rank), dtype=np.float32)
    qp[:n] = query_vecs
    mp = np.zeros((dims["b"], i_b), dtype=bool)
    mp[:n, :n_items] = masks
    with costmon.executable(costmon.BATCH_PREDICT_MASKED,
                            defer_to_outer=True):
        fetch = batched_sharded_top_k_begin(
            item_table.device(mesh, target_rows=i_b), qp, n_items,
            dims["k"], mesh, masks=mp, filter_positive=filter_positive,
            label=costmon.BATCH_PREDICT_MASKED, dims=dims,
            bound=(item_table,))

    def finish() -> Tuple[np.ndarray, np.ndarray]:
        s, i = fetch()
        return s[:n], i[:n]
    return finish


def unpack_top_k_rows(scores_row: np.ndarray, idx_row: np.ndarray,
                      num: int) -> Tuple[np.ndarray, np.ndarray]:
    """One query's view of a masked_top_k_batch row: its own num, -inf
    (excluded) slots dropped."""
    scores_row = scores_row[:num]
    idx_row = idx_row[:num]
    keep = np.isfinite(scores_row)
    return scores_row[keep], idx_row[keep]


def item_cosine_similarities(user_ix: np.ndarray, item_ix: np.ndarray,
                             n_users: int, n_items: int,
                             threshold: float = 0.0,
                             chunk_users: int = 4096, device=None,
                             telemetry: Optional[dict] = None
                             ) -> np.ndarray:
    """Exact all-pairs item cosine similarity from binary (user, item)
    interactions: the dimsum variant's RowMatrix.columnSimilarities, as
    the reference computes it (exactly, not DIMSUM's sampling
    approximation).

    The co-occurrence Gram G = M^T M accumulates on `device` (default:
    the card) in user-row chunks of `chunk_users`, so the dense [users,
    items] matrix never exists; a duplicate (user, item) pair sets its
    entry once ("set, not add"). Then S = G / (d d^T) with d =
    sqrt(max(diag G, 1e-12)), a zero diagonal, and entries below
    `threshold` zeroed when it is > 0. The entries of G are counts, exact
    in float32 (TF32 is off, see device.py); the normalization is the
    reference's float32 arithmetic. Returns S [I, I] float32 on the host.
    `telemetry`, when a dict, receives `gram_s` (the accumulation's wall
    time, closed by a synchronize), `gram_device_ms` on a card (CUDA
    events) and `chunks`."""
    dev = resolve_device(device)
    tel = telemetry if telemetry is not None else {}
    order = np.argsort(user_ix, kind="stable")
    u = np.asarray(user_ix, dtype=np.int64)[order]
    i = np.asarray(item_ix, dtype=np.int64)[order]
    u_d, i_d = torch.from_numpy(u).to(dev), torch.from_numpy(i).to(dev)
    G = torch.zeros((n_items, n_items), dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    events = None
    if dev.type == "cuda":
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        events[0].record()
    chunks = 0
    for start in range(0, n_users, chunk_users):
        lo, hi = np.searchsorted(u, [start, start + chunk_users])
        chunk = torch.zeros((min(chunk_users, n_users - start), n_items),
                            dtype=torch.float32, device=dev)
        chunk[u_d[lo:hi] - start, i_d[lo:hi]] = 1.0
        G.addmm_(chunk.T, chunk)
        chunks += 1
    if events is not None:
        events[1].record()
    synchronize(dev)
    tel["gram_s"] = time.perf_counter() - t0
    if events is not None:
        tel["gram_device_ms"] = events[0].elapsed_time(events[1])
    tel["chunks"] = chunks
    del u_d, i_d
    d = G.diagonal().clamp(min=1e-12).sqrt()
    S = G.div_(d[:, None] * d[None, :])
    S.fill_diagonal_(0.0)
    if threshold > 0:
        S.masked_fill_(S < threshold, 0.0)
    return S.cpu().numpy()
