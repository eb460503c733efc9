"""Cosine-similarity scoring with business-rule filters, top-k on the
model's device.

The port's counterpart of `predictionio_tpu/ops/similarity.py`
(`normalize_rows`, `cosine_top_k` computing `_cosine_topk`,
`build_filter_mask`, `masked_top_k_batch` computing `_masked_topk_impl`,
`unpack_top_k_rows`). Score = sum over the query items of cos(q, item);
items not allowed by the host-built filter mask, or with score <= 0, are
excluded (`masked_top_k_batch` keeps scores <= 0 when asked, for
explicit-ALS dot scores). Plain PyTorch: one matmul and `torch.topk` over
the item table resident on the device. The reference's shape buckets, AOT
registry, packed readback and sharded route are later slices (ROADMAP.md,
queue A).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


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
    [B, k']) with k' = min(k, I); callers drop the -inf slots
    (`unpack_top_k_rows`)."""
    dev = item_table.device
    q = torch.as_tensor(np.asarray(query_vecs, dtype=np.float32),
                        device=dev)
    scores = q @ item_table.T
    allowed = torch.as_tensor(masks, device=dev)
    if filter_positive:
        allowed = allowed & (scores > 0)
    scores = torch.where(allowed, scores, float("-inf"))
    s, i = torch.topk(scores, min(k, item_table.shape[0]), dim=1)
    return s.cpu().numpy(), i.cpu().numpy()


def unpack_top_k_rows(scores_row: np.ndarray, idx_row: np.ndarray,
                      num: int) -> Tuple[np.ndarray, np.ndarray]:
    """One query's view of a masked_top_k_batch row: its own num, -inf
    (excluded) slots dropped."""
    scores_row = scores_row[:num]
    idx_row = idx_row[:num]
    keep = np.isfinite(scores_row)
    return scores_row[keep], idx_row[keep]
