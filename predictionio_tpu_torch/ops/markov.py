"""Markov chain over a sparse transition-count matrix (the e2 library).

The port's counterpart of `predictionio_tpu/ops/markov.py` (the
reference's e2 `MarkovChain`, MarkovChain.scala): row-normalize the
counts, keep each row's top-N entries, and predict the next-state
distribution as state vector x matrix. The pruned matrix is a dense
[S, N] pair of (target index, probability) arrays; `mc_predict` is the
reference's `_mc_predict` as a plain torch function: the [S, N]
contribution scatter-added into `n_states + 1` bins, the -1 padding sent
to the extra bin. On the card the scatter-add runs with atomics, so the
order of each bin's float32 sum varies from run to run. Training is host
numpy, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.device import DeviceLike, resolve_device


def mc_predict(indices: torch.Tensor, probs: torch.Tensor,
               current: torch.Tensor, n_states: int) -> torch.Tensor:
    """next[j] = sum_s current[s] * P(j | s) over the pruned [S, N]
    tables (`indices` -1 where a row has fewer than N entries)."""
    contrib = probs * current[:, None]
    flat_idx = torch.where(indices >= 0, indices,
                           torch.full_like(indices, n_states))
    out = torch.zeros(n_states + 1, dtype=torch.float32,
                      device=probs.device)
    out.index_add_(0, flat_idx.reshape(-1).long(), contrib.reshape(-1))
    return out[:n_states]


@dataclass
class MarkovChainModel:
    """Top-N row-normalized transitions: indices[s, j] is a target state
    (or -1 padding), probs[s, j] = P(target | s). `predict` runs on
    `device`."""
    indices: np.ndarray  # [S, N] int32
    probs: np.ndarray    # [S, N] float32
    n_states: int
    top_n: int
    device: torch.device
    _tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = field(
        default=None, init=False, repr=False, compare=False)

    def tables(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The pruned tables on the device, uploaded once."""
        if self._tables is None:
            self._tables = (
                torch.from_numpy(np.ascontiguousarray(self.indices)).to(
                    self.device),
                torch.from_numpy(np.ascontiguousarray(self.probs)).to(
                    self.device))
        return self._tables

    def predict(self, current_state: np.ndarray) -> np.ndarray:
        """next[j] = sum_s current[s] * P(j | s) (MarkovChain.scala
        predict), as float32."""
        indices, probs = self.tables()
        current = torch.from_numpy(np.ascontiguousarray(
            current_state, dtype=np.float32)).to(self.device)
        return mc_predict(indices, probs, current,
                          self.n_states).cpu().numpy()


def markov_chain_train(row_idx: np.ndarray, col_idx: np.ndarray,
                       counts: np.ndarray, n_states: int, top_n: int,
                       device: DeviceLike = None) -> MarkovChainModel:
    """Build the pruned transition model from COO counts on the host;
    the model predicts on `device` (default: the card)."""
    dev = resolve_device(device)
    row_idx = np.asarray(row_idx, dtype=np.int64)
    col_idx = np.asarray(col_idx, dtype=np.int64)
    counts = np.asarray(counts, dtype=np.float64)
    indices = np.full((n_states, top_n), -1, dtype=np.int32)
    probs = np.zeros((n_states, top_n), dtype=np.float32)
    order = np.argsort(row_idx, kind="stable")
    r, c, v = row_idx[order], col_idx[order], counts[order]
    bounds = np.searchsorted(r, np.arange(n_states + 1))
    for s in range(n_states):
        lo, hi = bounds[s], bounds[s + 1]
        if lo == hi:
            continue
        total = v[lo:hi].sum()
        k = min(top_n, hi - lo)
        top = np.argsort(-v[lo:hi], kind="stable")[:k]
        sel_c = c[lo:hi][top]
        sel_p = v[lo:hi][top] / total
        # the reference keeps a row's entries sorted by column index
        colsort = np.argsort(sel_c)
        indices[s, :k] = sel_c[colsort]
        probs[s, :k] = sel_p[colsort]
    return MarkovChainModel(indices=indices, probs=probs,
                            n_states=n_states, top_n=top_n, device=dev)
