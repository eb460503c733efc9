"""Multinomial naive Bayes (MLlib NaiveBayes.train parity).

The port's counterpart of the multinomial part of
`predictionio_tpu/ops/naive_bayes.py` (`MultinomialNBModel`,
`multinomial_nb_train`), which the classification template trains. The
per-class document counts and feature sums are one one-hot product on
the device (`_nb_counts`), as the reference's `jnp` einsum is: no Pallas
kernel is involved. `pi` and `theta` follow MLlib's formulas in float64
on the host. The reference pads the batch to its mesh with rows that
count nothing; one device needs no padding. The categorical model (the
e2 library) is a later slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

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
