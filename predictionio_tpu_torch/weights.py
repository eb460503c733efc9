"""Carry a model trained by the JAX reference into the port.

`from_jax_model` takes the reference recommendation `ALSModel`'s host
numpy tables, the id lists of its vocabularies (`EntityIdIxMap._ids`,
in dense-index order) and its item properties, and builds the port's
`RecommendationModel` on `device`. `from_jax_similarproduct_model` does
the same for the similar-product `SimilarProductModel` (its tables, id
lists and item metadata). `from_jax_ecommerce_model`,
`from_jax_recommendeduser_model` and `from_jax_dimsum_model` do the same
for the e-commerce `ECommerceModel`, the recommended-user
`RecommendedUserModel` and the dimsum `DIMSUMModel` (whose table stays on
the host, as it serves there). `from_jax_nb_model` and
`from_jax_forest_model` carry the classification template's
`MultinomialNBModel` and `ForestModel`, which serve on the host. All take
plain arrays and dicts, so this module imports nothing of the reference
package.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from predictionio_tpu_torch.data.bimap import EntityIdIxMap
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.models.ecommerce import ECommerceModel
from predictionio_tpu_torch.models.recommendation import RecommendationModel
from predictionio_tpu_torch.models.recommendeduser import RecommendedUserModel
from predictionio_tpu_torch.models.similarproduct import (
    DIMSUMModel, Item, ItemMetadataModel, SimilarProductModel)
from predictionio_tpu_torch.ops.als import ALSModel
from predictionio_tpu_torch.ops.forest import ForestModel
from predictionio_tpu_torch.ops.naive_bayes import MultinomialNBModel


def from_jax_model(user_factors, item_factors, user_ids: Sequence[str],
                   item_ids: Sequence[str], rank: int, device=None,
                   item_properties: Optional[Sequence[Optional[dict]]] = None
                   ) -> RecommendationModel:
    """Row i of `user_factors` belongs to `user_ids[i]` (likewise for
    items). `item_properties` is the reference model's list of item
    property dicts by dense index (None where an item has none); the
    query filters' categories and years are derived from it as the
    reference derives them. The tables are uploaded to `device` (default:
    the card)."""
    U = np.ascontiguousarray(user_factors, dtype=np.float32)
    V = np.ascontiguousarray(item_factors, dtype=np.float32)
    if U.shape != (len(user_ids), rank) or V.shape != (len(item_ids), rank):
        raise ValueError(
            f"tables {U.shape}/{V.shape} do not match {len(user_ids)} users, "
            f"{len(item_ids)} items at rank {rank}")
    if item_properties is not None and len(item_properties) != len(item_ids):
        raise ValueError(f"{len(item_properties)} item property maps for "
                         f"{len(item_ids)} items")
    als = ALSModel(U, V, rank, resolve_device(device))
    als.tables()
    props = None if item_properties is None else list(item_properties)
    cats, years = RecommendationModel.derive_filters(props)
    return RecommendationModel(als, EntityIdIxMap.from_ids(user_ids),
                               EntityIdIxMap.from_ids(item_ids),
                               item_properties=props, item_categories=cats,
                               item_years=years)


def from_jax_similarproduct_model(
        item_factors_normalized, item_ids: Sequence[str],
        items: Dict[str, Item], item_factors_raw=None, user_factors=None,
        user_ids: Optional[Sequence[str]] = None,
        device=None) -> SimilarProductModel:
    """Row i of the item tables belongs to `item_ids[i]` (of the user
    table to `user_ids[i]`). `items` is the item metadata by id, as the
    port's `Item` (categories and the $set properties); categories and
    years are derived from it as the reference derives them. The
    normalized table is uploaded to `device` (default: the card)."""
    T = np.ascontiguousarray(item_factors_normalized, dtype=np.float32)
    if T.ndim != 2 or T.shape[0] != len(item_ids):
        raise ValueError(f"item table {T.shape} does not match "
                         f"{len(item_ids)} items")
    for name, table, ids in (("item_factors_raw", item_factors_raw,
                              item_ids),
                             ("user_factors", user_factors, user_ids)):
        if table is not None and (ids is None or np.shape(table) !=
                                  (len(ids), T.shape[1])):
            raise ValueError(f"{name} {np.shape(table)} does not match its "
                             f"ids at rank {T.shape[1]}")
    item_ix = EntityIdIxMap.from_ids(item_ids)
    model = SimilarProductModel(
        item_factors_normalized=T, device=resolve_device(device),
        item_factors_raw=(None if item_factors_raw is None else
                          np.asarray(item_factors_raw, dtype=np.float32)),
        user_factors=(None if user_factors is None else
                      np.asarray(user_factors, dtype=np.float32)),
        user_ix=(None if user_ids is None else
                 EntityIdIxMap.from_ids(user_ids)),
        **ItemMetadataModel.metadata_kwargs(items, item_ix))
    model.table()
    return model


def _table(name: str, table, n_rows: int, rank: Optional[int] = None
           ) -> np.ndarray:
    """A float32 table of `n_rows` rows (and `rank` columns), or
    ValueError."""
    T = np.ascontiguousarray(table, dtype=np.float32)
    if T.ndim != 2 or T.shape[0] != n_rows or (
            rank is not None and T.shape[1] != rank):
        raise ValueError(f"{name} {T.shape} does not match {n_rows} ids"
                         + (f" at rank {rank}" if rank is not None else ""))
    return T


def from_jax_ecommerce_model(user_factors, item_factors,
                             item_factors_normalized,
                             user_ids: Sequence[str],
                             item_ids: Sequence[str], items: Dict[str, Item],
                             rank: int, device=None) -> ECommerceModel:
    """Row i of the user table belongs to `user_ids[i]`, of the item
    tables to `item_ids[i]`; `items` is the item metadata by id (the
    port's `Item`), from which the category sets are derived as train
    derives them. The tables are uploaded to `device` (default: the
    card)."""
    item_ix = EntityIdIxMap.from_ids(item_ids)
    model = ECommerceModel(
        rank=rank,
        user_factors=_table("user_factors", user_factors, len(user_ids),
                            rank),
        item_factors=_table("item_factors", item_factors, len(item_ids),
                            rank),
        item_factors_normalized=_table("item_factors_normalized",
                                       item_factors_normalized,
                                       len(item_ids), rank),
        user_ix=EntityIdIxMap.from_ids(user_ids), item_ix=item_ix,
        items=dict(items),
        item_categories=ItemMetadataModel.derive_categories(items, item_ix),
        device=resolve_device(device))
    model.place()
    return model


def from_jax_recommendeduser_model(followed_factors_normalized,
                                   followed_ids: Sequence[str],
                                   device=None) -> RecommendedUserModel:
    """Row i of the normalized table belongs to `followed_ids[i]`; it is
    uploaded to `device` (default: the card)."""
    model = RecommendedUserModel(
        followed_factors_normalized=_table(
            "followed_factors_normalized", followed_factors_normalized,
            len(followed_ids)),
        followed_ix=EntityIdIxMap.from_ids(followed_ids),
        device=resolve_device(device))
    model.table()
    return model


def from_jax_dimsum_model(similarities, item_ids: Sequence[str],
                          items: Dict[str, Item]) -> DIMSUMModel:
    """Row and column i of `similarities` belong to `item_ids[i]`;
    `items` is the item metadata by id. The table serves on the host."""
    S = _table("similarities", similarities, len(item_ids), len(item_ids))
    return DIMSUMModel(similarities=S, **ItemMetadataModel.metadata_kwargs(
        items, EntityIdIxMap.from_ids(item_ids)))


def from_jax_nb_model(pi, theta, labels) -> MultinomialNBModel:
    """The reference `MultinomialNBModel`'s arrays: log priors [C], log
    likelihoods [C, D], label values [C]."""
    pi = np.array(pi, dtype=np.float64)
    theta = np.array(theta, dtype=np.float64)
    labels = np.array(labels, dtype=np.float64)
    if pi.ndim != 1 or theta.ndim != 2 or theta.shape[0] != pi.shape[0] \
            or labels.shape != pi.shape:
        raise ValueError(f"pi {pi.shape}, theta {theta.shape} and labels "
                         f"{labels.shape} do not describe one model")
    return MultinomialNBModel(pi=pi, theta=theta, labels=labels)


def from_jax_forest_model(feature, threshold, is_leaf, leaf_class,
                          num_classes: int, max_depth: int) -> ForestModel:
    """The reference `ForestModel`'s four [T, 2^(max_depth+1) - 1] heap
    arrays and its knobs."""
    arrays = (np.array(feature, dtype=np.int32),
              np.array(threshold, dtype=np.float32),
              np.array(is_leaf, dtype=bool),
              np.array(leaf_class, dtype=np.int32))
    shape = (arrays[0].shape[0], 2 ** (max_depth + 1) - 1)
    if any(a.shape != shape for a in arrays):
        raise ValueError(f"forest arrays {[a.shape for a in arrays]} are "
                         f"not [trees, {shape[1]}] heaps of depth "
                         f"{max_depth}")
    return ForestModel(*arrays, num_classes=int(num_classes),
                       max_depth=int(max_depth))
