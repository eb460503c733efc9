"""Cosine-similarity scoring with business-rule filters, top-k on the
model's device.

The port's counterpart of `predictionio_tpu/ops/similarity.py`
(`normalize_rows`, `cosine_top_k` computing `_cosine_topk`,
`build_filter_mask`, `masked_topk_dims`, `masked_top_k_batch[_begin]`
computing `_masked_topk_impl`, `unpack_top_k_rows`, and the DIMSUM
template's `item_cosine_similarities`). Score = sum over the
query items of cos(q, item); items not allowed by the host-built filter
mask, or with score <= 0, are excluded (`masked_top_k_batch` keeps scores
<= 0 when asked, for explicit-ALS dot scores). Plain PyTorch: one matmul
and `torch.topk` over the item table resident on the device. The batched
path pads its batch and top-k to pow2 buckets (`utils/buckets.py`) and
returns its result through the packed readback (`ops/readback.py`); the
item table stays exact-size. The sharded route is a later slice
(ROADMAP.md, queue A).
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device, synchronize
from predictionio_tpu_torch.ops import readback
from predictionio_tpu_torch.utils import buckets as B


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


def masked_topk_dims(n_items: int, batch: int, k: int) -> dict:
    """The padded shape of one masked top-k: batch bucket `b`, top-k
    bucket `k` (a pow2 from 16, at most the item count) and the pack
    mode `p`."""
    return {"b": B.bucket_batch(batch),
            "k": min(B.bucket_batch(k, floor=B.K_FLOOR), int(n_items)),
            "p": readback.pack_flag()}


def _masked_topk_impl(q: torch.Tensor, item_table: torch.Tensor,
                      allowed: torch.Tensor, k: int,
                      filter_positive: bool):
    """Score the batch against every item, mask, top-k."""
    scores = q @ item_table.T
    if filter_positive:
        allowed = allowed & (scores > 0)
    scores = torch.where(allowed, scores, float("-inf"))
    return torch.topk(scores, k, dim=1)


def masked_top_k_batch(item_table: torch.Tensor, query_vecs: np.ndarray,
                       masks: np.ndarray, k: int,
                       filter_positive: bool = True
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Batched masked dot top-k in one matmul for B queries.

    query_vecs [B, R] (already in the scoring space: raw user factors for
    dot scoring, summed normalized item vectors for cosine), masks [B, I]
    bool. Items not allowed score -inf; `filter_positive` also drops
    scores <= 0 (the cosine templates' rule; explicit-ALS callers pass
    False, since their scores can be negative). Returns host ([B, k'],
    [B, k']) with k' = min(bucketed k, I); callers drop the -inf slots
    and cut to their own num (`unpack_top_k_rows`). The scores are those
    `PIO_SERVE_PACK` sends (f16 by default)."""
    return masked_top_k_batch_begin(item_table, query_vecs, masks, k,
                                    filter_positive=filter_positive)()


def masked_top_k_batch_begin(item_table: torch.Tensor,
                             query_vecs: np.ndarray, masks: np.ndarray,
                             k: int, filter_positive: bool = True):
    """`masked_top_k_batch` in two stages: upload the padded queries and
    masks, enqueue the ranking and the copy of its result now, and
    return `finish() -> (scores [B, k'], idx [B, k'])`, which waits for
    the copy (it may run on another thread). Padding rows are masked
    out entirely."""
    dev = item_table.device
    n = query_vecs.shape[0]
    dims = masked_topk_dims(item_table.shape[0], n, k)
    qp = np.zeros((dims["b"], query_vecs.shape[1]), dtype=np.float32)
    qp[:n] = query_vecs
    mp = np.zeros((dims["b"], item_table.shape[0]), dtype=bool)
    mp[:n] = masks
    scores, idx = _masked_topk_impl(
        readback.to_device(qp, dev), item_table, readback.to_device(mp, dev),
        dims["k"], filter_positive)
    if dims["p"]:
        fetch = readback.begin_fetch_packed(
            readback.pack_device(scores, idx, dims["p"]), dims["p"])
    else:
        fetch = readback.begin_fetch(scores, idx)

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
