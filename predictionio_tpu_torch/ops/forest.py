"""Random decision forest, grown level by level on the device.

The port's counterpart of `predictionio_tpu/ops/forest.py`
(`feature_subset_size`, `ForestModel`, `_impurity`, `_grow_forest`,
`forest_train`), the classification template's random forest. Features
are quantile-binned once into `max_bins` ordered bins; all trees grow in
lockstep, and at depth d the class histogram of every (tree, node,
feature, bin) cell is one one-hot product over the examples
(`_level_histogram`), so the split search is a dense cumulative
reduction; each node keeps the best gini or entropy gain over its random
feature subset, or freezes into a leaf. Trees are heap arrays (node i's
children are 2i+1 and 2i+2) and predict on the host.

The reference is plain `jnp` under `jit`, outside any Pallas kernel, so
this is torch ops. Its randomness is `jax.random`: a Poisson(1)
bootstrap weight per (tree, example) and a uniform feature score per
(tree, node, feature) at each level. The port cannot draw threefry
numbers, so `forest_train` takes both draws as optional arrays (given
the reference's draws, it grows the reference's trees); by default it
draws them from a CPU `torch.Generator` seeded by `seed`, the same on
every device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F_nn

from predictionio_tpu_torch.device import DeviceLike, resolve_device

_STRATEGIES = ("auto", "all", "sqrt", "log2", "onethird")


def feature_subset_size(strategy: str, num_features: int,
                        num_trees: int) -> int:
    """MLlib RandomForest.scala featureSubsetStrategy semantics: "auto" is
    sqrt for a forest, all features for a single tree."""
    s = strategy.lower()
    if s not in _STRATEGIES:
        raise ValueError(
            f"featureSubsetStrategy must be one of {_STRATEGIES}, got {s!r}")
    if s == "auto":
        s = "sqrt" if num_trees > 1 else "all"
    if s == "all":
        return num_features
    # ceil throughout, as in Spark's DecisionTreeMetadata.buildMetadata
    if s == "sqrt":
        return max(1, int(math.ceil(math.sqrt(num_features))))
    if s == "log2":
        return max(1, int(math.ceil(math.log2(max(2, num_features)))))
    return max(1, int(math.ceil(num_features / 3.0)))


@dataclass
class ForestModel:
    """Heap-layout forest. Node i: children 2i+1 / 2i+2; leaves carry the
    majority class of the training rows that reached them."""
    feature: np.ndarray      # [T, nodes] int32 split feature (internal)
    threshold: np.ndarray    # [T, nodes] float32; go right iff x[f] > thr
    is_leaf: np.ndarray      # [T, nodes] bool
    leaf_class: np.ndarray   # [T, nodes] int32
    num_classes: int
    max_depth: int

    @property
    def num_trees(self) -> int:
        return self.feature.shape[0]

    def predict(self, x: Sequence[float]) -> float:
        """One query's vote on the host."""
        votes = self.predict_batch(np.asarray(x, np.float32)[None, :])
        return float(votes[0])

    def predict_batch(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, np.float32)
        node = np.zeros((self.num_trees, X.shape[0]), np.int64)
        tree_ix = np.arange(self.num_trees)[:, None]
        for _ in range(self.max_depth):
            f = self.feature[tree_ix, node]
            go_right = X[np.arange(X.shape[0])[None, :], f] > \
                self.threshold[tree_ix, node]
            child = 2 * node + 1 + go_right
            node = np.where(self.is_leaf[tree_ix, node], node, child)
        cls = self.leaf_class[tree_ix, node]            # [T, q]
        votes = np.zeros((X.shape[0], self.num_classes), np.int64)
        for t in range(self.num_trees):
            votes[np.arange(X.shape[0]), cls[t]] += 1
        return np.argmax(votes, axis=1).astype(np.float64)


def _impurity(counts: torch.Tensor, kind: str) -> torch.Tensor:
    """counts [..., C] -> impurity [...]: gini or entropy (MLlib's two
    classification impurities)."""
    total = counts.sum(dim=-1, keepdim=True)
    p = counts / total.clamp(min=1e-9)
    if kind == "gini":
        return 1.0 - (p * p).sum(dim=-1)
    return -torch.where(p > 0, p * torch.log2(p.clamp(min=1e-12)),
                        torch.zeros_like(p)).sum(dim=-1)


def _level_histogram(node1h: torch.Tensor, bin1h: torch.Tensor,
                     cls1h: torch.Tensor) -> torch.Tensor:
    """hist[t, m, f, b, c] = sum_n node1h[t, n, m] bin1h[n, f, b]
    cls1h[n, c] (the reference's three-operand einsum) as one product:
    the (feature, bin, class) one-hot of each example first, [n, F*B*C],
    then the weighted node one-hots against it. Every term is a bootstrap
    weight, an integer, so the float32 sums are exact below 2^24."""
    n, F, B = bin1h.shape
    C = cls1h.shape[1]
    fbc = (bin1h[:, :, :, None] * cls1h[:, None, None, :]).reshape(n, -1)
    hist = torch.matmul(node1h.transpose(1, 2), fbc)   # [T, nd, F*B*C]
    return hist.reshape(node1h.shape[0], node1h.shape[2], F, B, C)


def _grow_forest(Xb: torch.Tensor, y: torch.Tensor, edges: torch.Tensor,
                 w: torch.Tensor, scores: Sequence[torch.Tensor], *,
                 num_classes: int, max_depth: int, max_bins: int,
                 impurity: str, subset_k: int):
    """Level-synchronous growth of all trees at once.

    Xb     [n, F] int64   bin index per example/feature
    y      [n]    int64   class index
    edges  [F, B-1] f32   bin upper edges: bin b <=> x <= edges[f, b]
    w      [T, n]  f32    bootstrap weight per (tree, example)
    scores [T, 2^d, F] f32 for each level d < max_depth: a node keeps the
                          `subset_k` features of smallest score
    """
    n, F = Xb.shape
    T, C, B, D = w.shape[0], num_classes, max_bins, max_depth
    num_nodes = 2 ** (D + 1) - 1
    dev = Xb.device

    bin1h = F_nn.one_hot(Xb, B).to(torch.float32)          # [n, F, B]
    cls1h = F_nn.one_hot(y, C).to(torch.float32)           # [n, C]

    feature = torch.zeros((T, num_nodes), dtype=torch.int32, device=dev)
    threshold = torch.full((T, num_nodes), math.inf, dtype=torch.float32,
                           device=dev)
    is_leaf = torch.zeros((T, num_nodes), dtype=torch.bool, device=dev)
    leaf_class = torch.zeros((T, num_nodes), dtype=torch.int32, device=dev)

    node = torch.zeros((T, n), dtype=torch.int64, device=dev)
    active = w > 0                       # the example still flows in tree
    rows = torch.arange(n, device=dev)[None, :]

    for d in range(D + 1):
        nd = 2 ** d
        sl = slice(nd - 1, 2 * nd - 1)   # this level's heap slots
        node1h = F_nn.one_hot(node, nd).to(torch.float32) \
            * (active * w)[:, :, None]                     # [T, n, nd]
        hist = _level_histogram(node1h, bin1h, cls1h)      # [T,nd,F,B,C]
        # the bins partition a node's rows: one feature's slice sums to
        # the node's class totals
        cls_tot = hist[:, :, 0, :, :].sum(dim=2)           # [T, nd, C]
        total = cls_tot.sum(dim=-1)                        # [T, nd]
        majority = torch.argmax(cls_tot, dim=-1).to(torch.int32)
        parent_imp = _impurity(cls_tot, impurity)          # [T, nd]

        if d == D:
            # the bottom level: everything still active is a leaf
            is_leaf[:, sl] = True
            leaf_class[:, sl] = majority
            break

        # candidate split "bin <= b goes left" for b in 0..B-2
        cum = torch.cumsum(hist, dim=3)                    # [T,nd,F,B,C]
        left = cum[:, :, :, :-1, :]                        # [T,nd,F,B-1,C]
        right = cls_tot[:, :, None, None, :] - left
        nl = left.sum(dim=-1)
        nr = right.sum(dim=-1)
        child_imp = (nl * _impurity(left, impurity)
                     + nr * _impurity(right, impurity)) \
            / (nl + nr).clamp(min=1e-9)
        gain = parent_imp[:, :, None, None] - child_imp    # [T,nd,F,B-1]
        # the node's random feature subset: the subset_k features of
        # smallest score (an exact-k mask, without replacement)
        sc = scores[d]
        kth = torch.sort(sc, dim=-1).values[..., subset_k - 1]
        fmask = sc <= kth[..., None]                       # [T, nd, F]
        valid = (nl > 0) & (nr > 0) & fmask[:, :, :, None]
        gain = torch.where(valid, gain,
                           torch.full_like(gain, -math.inf))

        flat = gain.reshape(T, nd, F * (B - 1))
        best = torch.argmax(flat, dim=-1)                  # [T, nd]
        best_gain = torch.gather(flat, 2, best[..., None])[..., 0]
        best_f = best // (B - 1)
        best_b = best % (B - 1)
        # a leaf iff nothing reached it, it is pure, or no split helps
        make_leaf = (total <= 1) | (parent_imp <= 1e-9) | \
            (best_gain <= 0) | ~torch.isfinite(best_gain)

        feature[:, sl] = best_f.to(torch.int32)
        threshold[:, sl] = edges[best_f, best_b]
        is_leaf[:, sl] = make_leaf
        leaf_class[:, sl] = majority

        # route: right iff the bin is above the node's split bin
        nf = torch.gather(best_f, 1, node)                 # [T, n]
        nb = torch.gather(best_b, 1, node)
        go_right = Xb[rows, nf] > nb
        froze = torch.gather(make_leaf, 1, node)
        active = active & ~froze
        node = 2 * node + go_right.to(torch.int64)

    return feature, threshold, is_leaf, leaf_class


def forest_train(X: np.ndarray, y: np.ndarray, *, num_classes: int,
                 num_trees: int = 10, feature_subset_strategy: str = "auto",
                 impurity: str = "gini", max_depth: int = 5,
                 max_bins: int = 32, seed: int = 42,
                 bootstrap: Optional[np.ndarray] = None,
                 feature_scores: Optional[Sequence[np.ndarray]] = None,
                 device: DeviceLike = None) -> ForestModel:
    """Train a classification forest on `device` (default: the card). `y`
    holds class indices 0..C-1 (MLlib labels are doubles with the same
    contract).

    `bootstrap` [num_trees, n] are the Poisson(1) example weights and
    `feature_scores` one [num_trees, 2^d, F] array of uniform scores for
    each level d < max_depth; either one not given is drawn from a CPU
    `torch.Generator` seeded by `seed` (the bootstrap first)."""
    if impurity not in ("gini", "entropy"):
        raise ValueError(f"impurity must be gini|entropy, got {impurity!r}")
    dev = resolve_device(device)
    X = np.asarray(X, np.float32)
    y_arr = np.asarray(y)
    if not np.all(np.equal(np.mod(y_arr, 1), 0)):
        raise ValueError("forest labels must be integer-valued class ids")
    y_ix = y_arr.astype(np.int64)
    if y_ix.size and (y_ix.min() < 0 or y_ix.max() >= num_classes):
        # MLlib's trainClassifier throws on labels outside [0, numClasses)
        raise ValueError(
            f"forest labels must be in [0, {num_classes}); got range "
            f"[{y_ix.min()}, {y_ix.max()}]")
    n, F = X.shape
    max_bins = max(2, min(max_bins, max(2, n)))
    # quantile bin edges; bin index = #(edges < x), so bin b <=> x <= edge[b]
    qs = np.linspace(0.0, 1.0, max_bins + 1)[1:-1]
    edges = np.quantile(X, qs, axis=0).T.astype(np.float32)  # [F, B-1]
    Xb = (X[:, :, None] > edges[None, :, :]).sum(axis=2).astype(np.int64)

    subset_k = feature_subset_size(feature_subset_strategy, F, num_trees)
    gen = torch.Generator().manual_seed(int(seed))
    if bootstrap is None:
        w = torch.poisson(torch.ones((num_trees, n)), generator=gen)
    else:
        w = torch.tensor(np.asarray(bootstrap, np.float32))
    if feature_scores is None:
        scores = [torch.rand((num_trees, 2 ** d, F), generator=gen)
                  for d in range(max_depth)]
    else:
        scores = [torch.tensor(np.asarray(s, np.float32))
                  for s in feature_scores]
    if tuple(w.shape) != (num_trees, n) or len(scores) < max_depth or any(
            tuple(scores[d].shape) != (num_trees, 2 ** d, F)
            for d in range(max_depth)):
        raise ValueError("bootstrap must be [num_trees, n] and "
                         "feature_scores one [num_trees, 2^d, F] array a "
                         "level below max_depth")
    feat, thr, leaf, leaf_cls = _grow_forest(
        torch.from_numpy(Xb).to(dev), torch.from_numpy(y_ix).to(dev),
        torch.from_numpy(edges).to(dev), w.to(dev),
        [s.to(dev) for s in scores[:max_depth]],
        num_classes=num_classes, max_depth=max_depth, max_bins=max_bins,
        impurity=impurity, subset_k=subset_k)
    return ForestModel(
        feature=feat.cpu().numpy(), threshold=thr.cpu().numpy(),
        is_leaf=leaf.cpu().numpy(), leaf_class=leaf_cls.cpu().numpy(),
        num_classes=num_classes, max_depth=max_depth)
