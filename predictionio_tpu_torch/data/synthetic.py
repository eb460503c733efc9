"""Synthetic ratings.

`synthetic_ml20m` is a copy of `bench.py:synthetic_ml20m` from the
reference repo: the same numpy RNG calls in the same order, so the same
seed gives the same arrays. `small_ratings` is a small heavy-tailed
sample on which both ALS routes (primal and dual) occur at rank 16, for
parity checks and rounding readings. `synthetic_item_categories` gives
each item 1-3 categories, a fixture for the similar-product filters.
"""

from __future__ import annotations

import numpy as np

#: The repo's headline configuration (MovieLens-20M shape).
ML20M_USERS = 138_493
ML20M_ITEMS = 26_744
ML20M_RATINGS = 20_000_000


def synthetic_ml20m(n_users, n_items, nnz, seed=0):
    """Power-law popularity + lognormal user activity, ML-20M shaped.
    Returns (user_idx int32, item_idx int32, rating float32)."""
    rng = np.random.default_rng(seed)
    # user activity: lognormal, scaled to sum ~ nnz
    raw = rng.lognormal(mean=0.0, sigma=1.1, size=n_users)
    counts = np.maximum(1, (raw / raw.sum() * nnz)).astype(np.int64)
    diff = nnz - counts.sum()
    counts[0] += max(diff, 1 - counts[0])
    user_idx = np.repeat(np.arange(n_users, dtype=np.int32),
                         counts).astype(np.int32)
    total = user_idx.shape[0]
    # item popularity: zipf-ish
    pop = 1.0 / np.arange(1, n_items + 1) ** 1.1
    pop /= pop.sum()
    item_idx = rng.choice(n_items, size=total, p=pop).astype(np.int32)
    rating = rng.integers(1, 6, size=total).astype(np.float32)
    return user_idx, item_idx, rating


def small_ratings(seed=5, n_users=90, n_items=150, nnz=1800):
    """Lognormal user activity, uniform items, distinct (user, item)
    pairs, ratings 1..5. Returns (user_idx int32, item_idx int32, rating
    float32, n_users, n_items)."""
    rng = np.random.default_rng(seed)
    w = rng.lognormal(0.0, 1.0, n_users)
    ui = rng.choice(n_users, nnz, p=w / w.sum())
    ii = rng.integers(0, n_items, nnz)
    pair = np.unique(ui * n_items + ii)
    ui = (pair // n_items).astype(np.int32)
    ii = (pair % n_items).astype(np.int32)
    vv = rng.integers(1, 6, ui.size).astype(np.float32)
    return ui, ii, vv, n_users, n_items


def synthetic_item_categories(n_items, n_categories=20, seed=0):
    """Each item gets 1-3 distinct categories out of `n_categories`
    ("c0", "c1", ...), numpy-seeded. Returns a list of tuples, by item
    index."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 4, n_items)
    return [tuple(f"c{c}" for c in sorted(rng.choice(n_categories, k,
                                                     replace=False)))
            for k in sizes]
