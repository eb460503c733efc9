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
`MultinomialNBModel` and `ForestModel`, which serve on the host.
`from_jax_markov_model`, `from_jax_categorical_nb_model` and
`from_jax_binary_vectorizer` carry the e2 library's `MarkovChainModel`
(predicting on `device`), `CategoricalNBModel` and `BinaryVectorizer`.
All take plain arrays and dicts, so this module imports nothing of the
reference package.

The sharded layout: `from_jax_model` also takes the reference's
`ShardedTable`s (anything with its `shards`, `offsets`, `n_rows`,
`padded_rows` and `n_shards`: the per-shard host slices) and builds the
port's `ShardedTable`s from the same slices, or splits whole tables into
`n_shards`; `from_jax_sharded_checkpoint` reads the directory the
reference's `ShardedALSModelCheckpoint` wrote (its npz form,
`factors/arrays.npz` beside `vocab.npz`) into a sharded model.
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
from predictionio_tpu_torch.ops.markov import MarkovChainModel
from predictionio_tpu_torch.ops.naive_bayes import (CategoricalNBModel,
                                                    MultinomialNBModel)
from predictionio_tpu_torch.ops.vectorizer import BinaryVectorizer
from predictionio_tpu_torch.parallel.sharded_table import ShardedTable


def _sharded_of(table, n_shards: int):
    """The port's `ShardedTable` of a reference one (its slices as they
    are), or of a whole table split `n_shards` ways; None for a whole
    table when `n_shards` is 0."""
    if all(hasattr(table, a) for a in ("shards", "offsets", "n_rows",
                                       "padded_rows", "n_shards")):
        return ShardedTable([np.asarray(x) for x in table.shards],
                            table.offsets, table.n_rows, table.padded_rows,
                            table.n_shards)
    if n_shards:
        return ShardedTable.from_host(
            np.ascontiguousarray(table, dtype=np.float32), n_shards)
    return None


def from_jax_model(user_factors, item_factors, user_ids: Sequence[str],
                   item_ids: Sequence[str], rank: int, device=None,
                   item_properties: Optional[Sequence[Optional[dict]]] = None,
                   n_shards: int = 0) -> RecommendationModel:
    """Row i of `user_factors` belongs to `user_ids[i]` (likewise for
    items). `item_properties` is the reference model's list of item
    property dicts by dense index (None where an item has none); the
    query filters' categories and years are derived from it as the
    reference derives them. The tables are uploaded to `device` (default:
    the card). Reference `ShardedTable`s come over shard for shard, and
    `n_shards` > 0 splits whole tables so; a sharded model uploads its
    item table's shards (module docstring)."""
    U_sh = _sharded_of(user_factors, n_shards)
    V_sh = _sharded_of(item_factors, n_shards)
    if (U_sh is None) != (V_sh is None):
        raise ValueError("both tables must be sharded, or neither")
    U = (np.ascontiguousarray(user_factors, dtype=np.float32)
         if U_sh is None else U_sh)
    V = (np.ascontiguousarray(item_factors, dtype=np.float32)
         if V_sh is None else V_sh)
    if U.shape != (len(user_ids), rank) or V.shape != (len(item_ids), rank):
        raise ValueError(
            f"tables {U.shape}/{V.shape} do not match {len(user_ids)} users, "
            f"{len(item_ids)} items at rank {rank}")
    if item_properties is not None and len(item_properties) != len(item_ids):
        raise ValueError(f"{len(item_properties)} item property maps for "
                         f"{len(item_ids)} items")
    als = ALSModel(U, V, rank, resolve_device(device))
    if V_sh is None:
        als.tables()
    else:
        from predictionio_tpu_torch.parallel.mesh import model_mesh
        V_sh.device(model_mesh(V_sh.n_shards, als.device))
    props = None if item_properties is None else list(item_properties)
    cats, years = RecommendationModel.derive_filters(props)
    return RecommendationModel(als, EntityIdIxMap.from_ids(user_ids),
                               EntityIdIxMap.from_ids(item_ids),
                               item_properties=props, item_categories=cats,
                               item_years=years)


def from_jax_sharded_checkpoint(path: str, n_shards: int, device=None
                                ) -> RecommendationModel:
    """The model in a reference `ShardedALSModelCheckpoint` directory
    (`checkpoint_dir(instance_id)`): its `factors/arrays.npz` (the form
    the reference writes without orbax) and `vocab.npz`, split
    `n_shards` ways. An orbax checkpoint needs orbax to read: restore it
    with the reference and pass the arrays to `from_jax_model`."""
    import os
    npz = os.path.join(path, "factors", "arrays.npz")
    if not os.path.exists(npz):
        raise ValueError(
            f"{path} holds no factors/arrays.npz (an orbax checkpoint?); "
            f"restore it with the reference and use from_jax_model")
    with np.load(npz) as z:
        U, V = z["user_factors"], z["item_factors"]
    with np.load(os.path.join(path, "vocab.npz")) as z:
        users, items = [str(u) for u in z["users"]], \
            [str(i) for i in z["items"]]
    return from_jax_model(U, V, users, items, int(U.shape[1]),
                          device=device, n_shards=n_shards)


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


def from_jax_markov_model(indices, probs, n_states: int, top_n: int,
                          device=None) -> MarkovChainModel:
    """The reference `MarkovChainModel`'s [S, N] target indices (-1
    padding) and probabilities; it predicts on `device` (default: the
    card)."""
    indices = np.array(indices, dtype=np.int32)
    probs = np.array(probs, dtype=np.float32)
    shape = (int(n_states), int(top_n))
    if indices.shape != shape or probs.shape != shape:
        raise ValueError(f"indices {indices.shape} and probs {probs.shape} "
                         f"are not [{n_states}, {top_n}]")
    if indices.size and (indices.min() < -1 or indices.max() >= n_states):
        raise ValueError(f"a target index lies outside -1..{n_states - 1}")
    return MarkovChainModel(indices=indices, probs=probs,
                            n_states=shape[0], top_n=shape[1],
                            device=resolve_device(device))


def from_jax_categorical_nb_model(priors: Dict[str, float],
                                  likelihoods) -> CategoricalNBModel:
    """The reference `CategoricalNBModel`'s log priors by label and log
    likelihoods by label, position and value."""
    if set(priors) != set(likelihoods):
        raise ValueError(f"priors name labels {sorted(priors)}, "
                         f"likelihoods {sorted(likelihoods)}")
    return CategoricalNBModel(
        priors={str(k): float(v) for k, v in priors.items()},
        likelihoods={str(k): [{str(v): float(x) for v, x in m.items()}
                              for m in per_pos]
                     for k, per_pos in likelihoods.items()})


def from_jax_binary_vectorizer(property_map) -> BinaryVectorizer:
    """The reference `BinaryVectorizer`'s (property, value) -> column
    map; the columns must be 0..n-1."""
    pm = {(str(p), str(v)): int(i) for (p, v), i in property_map.items()}
    if sorted(pm.values()) != list(range(len(pm))):
        raise ValueError("the vectorizer's columns are not 0..n-1")
    return BinaryVectorizer(pm)
