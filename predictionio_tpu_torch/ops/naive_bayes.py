"""Naive Bayes: multinomial (MLlib NaiveBayes.train parity) and
categorical (the e2 library's CategoricalNaiveBayes).

The port's counterpart of `predictionio_tpu/ops/naive_bayes.py`.
`multinomial_nb_train` is what the classification template trains: the
per-class document counts and feature sums are one one-hot product on
the device (`_nb_counts`), as the reference's `jnp` einsum is, and `pi`
and `theta` follow MLlib's formulas in float64 on the host. The reference
pads the batch to its mesh with rows that count nothing; one device needs
no padding.

`categorical_nb_train` (CategoricalNaiveBayes.scala) builds each
position's sorted vocabulary on the host and counts (label, position,
value) triples on the device. The reference counts them through an
[N, P, V] one-hot einsum, which does not fit at real sizes; the port
scatter-adds ones into the C*P*V flat bins (`categorical_counts`), which
gives the same float32 counts, exact up to 2^24 whatever the order of the
adds. The log priors and likelihoods follow in float64 on the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.device import DeviceLike, resolve_device


@dataclass
class MultinomialNBModel:
    pi: np.ndarray      # [C] log prior
    theta: np.ndarray   # [C, D] log likelihood
    labels: np.ndarray  # [C] the label values (float, as MLlib's)

    def predict(self, x: np.ndarray) -> float:
        scores = self.pi + self.theta @ np.asarray(x, dtype=np.float64)
        return float(self.labels[int(np.argmax(scores))])


def _nb_counts(features: torch.Tensor, label_ix: torch.Tensor,
               n_classes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class document counts [C] and feature sums [C, D] through one
    one-hot [n, C] matrix (float32 sums, as the reference's)."""
    onehot = (label_ix[:, None] == torch.arange(
        n_classes, device=label_ix.device)[None, :]).to(torch.float32)
    return onehot.sum(dim=0), onehot.T @ features


def multinomial_nb_train(features: np.ndarray, labels: np.ndarray,
                         lam: float = 1.0,
                         device: DeviceLike = None) -> MultinomialNBModel:
    """MLlib multinomial NaiveBayes on `device` (default: the card):
      pi_c     = log((N_c + lam) / (N + C*lam))
      theta_cd = log((sum_cd + lam) / (sum_c + D*lam))
    """
    dev = resolve_device(device)
    features = np.asarray(features, dtype=np.float32)
    classes, label_ix = np.unique(np.asarray(labels), return_inverse=True)
    n_classes, n_features = len(classes), features.shape[1]
    class_counts, feature_sums = _nb_counts(
        torch.from_numpy(features).to(dev),
        torch.from_numpy(label_ix.astype(np.int64)).to(dev), n_classes)
    class_counts = class_counts.cpu().numpy().astype(np.float64)
    feature_sums = feature_sums.cpu().numpy().astype(np.float64)
    total = class_counts.sum()
    pi = np.log(class_counts + lam) - math.log(total + n_classes * lam)
    denom = np.log(feature_sums.sum(axis=1, keepdims=True)
                   + n_features * lam)
    theta = np.log(feature_sums + lam) - denom
    return MultinomialNBModel(pi=pi, theta=theta,
                              labels=classes.astype(np.float64))


# ---------------------------------------------------------------------------
# Categorical naive Bayes (the e2 library)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LabeledPoint:
    """A label and its string features (e2/engine/LabeledPoint)."""
    label: str
    features: Tuple[str, ...]


@dataclass
class CategoricalNBModel:
    """priors[label] = log P(label); likelihoods[label][pos][value] =
    log P(value | label): exact counts, no smoothing, as
    CategoricalNaiveBayes.scala."""
    priors: Dict[str, float]
    likelihoods: Dict[str, List[Dict[str, float]]]

    def log_score(self, point: LabeledPoint,
                  default=None) -> Optional[float]:
        """(CategoricalNaiveBayes.scala logScore): None when the label is
        unknown, or a feature value is unseen and no `default` is given;
        `default` is fn(feature likelihood map) -> float."""
        if point.label not in self.priors:
            return None
        feat_l = self.likelihoods[point.label]
        total = self.priors[point.label]
        for pos, value in enumerate(point.features):
            m = feat_l[pos]
            if value in m:
                total += m[value]
            elif default is not None:
                total += default(m)
            else:
                return None
        return total

    def predict(self, features: Sequence[str],
                default=None) -> Optional[str]:
        best, best_score = None, -math.inf
        for label in self.priors:
            s = self.log_score(LabeledPoint(label, tuple(features)), default)
            if s is not None and s > best_score:
                best, best_score = label, s
        return best


def categorical_counts(label_ix: torch.Tensor, feat_ix: torch.Tensor,
                       n_classes: int, n_values: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """counts[c, p, v] = #points of label c with value v at position p,
    and the label counts [C], both float32 on the tensors' device: ones
    scatter-added into the flat (c, p, v) bins."""
    n, n_pos = feat_ix.shape
    dev = feat_ix.device
    pos = torch.arange(n_pos, device=dev)
    flat = ((label_ix.long()[:, None] * n_pos + pos[None, :]) * n_values
            + feat_ix.long()).reshape(-1)
    counts = torch.zeros(n_classes * n_pos * n_values, dtype=torch.float32,
                         device=dev)
    counts.index_add_(0, flat, torch.ones(flat.shape[0],
                                          dtype=torch.float32, device=dev))
    label_counts = torch.zeros(n_classes, dtype=torch.float32, device=dev)
    label_counts.index_add_(0, label_ix.long(), torch.ones(
        n, dtype=torch.float32, device=dev))
    return counts.reshape(n_classes, n_pos, n_values), label_counts


def categorical_nb_train(points: Sequence[LabeledPoint],
                         device: DeviceLike = None) -> CategoricalNBModel:
    """The sorted vocabularies on the host (the reference's sorted sets,
    as `np.unique` ranks), the counting on `device` (default: the card),
    the logs in float64 on the host."""
    dev = resolve_device(device)
    if not points:
        return CategoricalNBModel({}, {})
    n_pos = len(points[0].features)
    labels, lab = np.unique(np.array([p.label for p in points], dtype=str),
                            return_inverse=True)
    raw = np.array([p.features for p in points], dtype=str).reshape(
        len(points), n_pos)
    vocabs, feat = [], np.empty(raw.shape, dtype=np.int64)
    for pos in range(n_pos):
        vals, feat[:, pos] = np.unique(raw[:, pos], return_inverse=True)
        vocabs.append(vals.tolist())
    n, max_v = len(points), max(len(v) for v in vocabs)
    counts, label_counts = categorical_counts(
        torch.from_numpy(lab.astype(np.int64)).to(dev),
        torch.from_numpy(feat).to(dev), len(labels), max_v)
    counts = counts.cpu().numpy().astype(np.float64)
    label_counts = label_counts.cpu().numpy().astype(np.float64)
    priors = {l: math.log(label_counts[i] / n)
              for i, l in enumerate(labels.tolist())}
    likelihoods: Dict[str, List[Dict[str, float]]] = {}
    for i, l in enumerate(labels.tolist()):
        per_pos = []
        for pos in range(n_pos):
            m = {}
            for vi, v in enumerate(vocabs[pos]):
                cnt = counts[i, pos, vi]
                if cnt > 0:
                    m[v] = math.log(cnt / label_counts[i])
            per_pos.append(m)
        likelihoods[l] = per_pos
    return CategoricalNBModel(priors=priors, likelihoods=likelihoods)
