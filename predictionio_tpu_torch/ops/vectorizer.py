"""Binary one-hot vectorizer for (property, value) pairs (the e2
library).

The port's copy of `predictionio_tpu/ops/vectorizer.py` (the reference's
e2 `BinaryVectorizer`, BinaryVectorizer.scala), numpy only: `fit` maps
each observed (property, value) string pair to a column index in sorted
order, and `transform` emits a dense 0/1 float32 row (dense, not the
reference's SparseVector, as in the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Mapping, Sequence, Tuple

import numpy as np


@dataclass
class BinaryVectorizer:
    property_map: Dict[Tuple[str, str], int]

    @property
    def n_features(self) -> int:
        return len(self.property_map)

    @staticmethod
    def fit(maps: Iterable[Mapping[str, str]],
            properties: Sequence[str]) -> "BinaryVectorizer":
        pairs = sorted({(p, m[p]) for m in maps for p in properties
                        if p in m})
        return BinaryVectorizer({pv: i for i, pv in enumerate(pairs)})

    def transform(self, m: Mapping[str, str]) -> np.ndarray:
        out = np.zeros(self.n_features, dtype=np.float32)
        for p, v in m.items():
            ix = self.property_map.get((p, str(v)))
            if ix is not None:
                out[ix] = 1.0
        return out

    def transform_batch(self, maps: Sequence[Mapping[str, str]]
                        ) -> np.ndarray:
        return np.stack([self.transform(m) for m in maps]) if maps else \
            np.zeros((0, self.n_features), dtype=np.float32)
