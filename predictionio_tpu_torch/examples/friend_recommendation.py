"""Friend-recommendation engines.

The port's copy of `examples/friend_recommendation.py`, the reference's
experimental friend-recommendation examples as behavioral specs
(examples/experimental/scala-local-friend-recommendation/
KeywordSimilarityAlgorithm.scala: a sparse term-weight dot product
between a user's and an item's keyword maps, acceptance = weight * sim
>= threshold; and examples/experimental/
scala-parallel-friend-recommendation/SimRankAlgorithm.scala +
DeltaSimRankRDD.scala: SimRank vertex similarity over the social graph,
query (u1, u2) -> score).

  * Keyword maps become HASHED dense feature tables [n, 4096], kept on
    the card (`utils/device_cache.cached_put`): a user's row against
    every item is one matrix-vector product.
  * SimRank's per-edge message passing becomes the dense fixed point
    S <- decay * W^T S W with the diagonal pinned to 1 (the column-
    normalized adjacency W is the evidence factor): a loop of two
    matmuls and a diagonal mask on the card. The card is resolved with
    TF32 off (`device.resolve_device`), so these are true f32 products.

Usage:
    python -m predictionio_tpu_torch.examples.friend_recommendation \
        [keyword|simrank] [--device cuda|cpu]
"""

import argparse
import os
import tempfile
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from predictionio_tpu_torch.core import (DataSource, EngineParams,
                                         LAlgorithm, Params, SimpleEngine)

HASH_DIM = 1 << 12  # feature-hash buckets for keyword ids


# ---------------------------------------------------------------------------
# data files (KDD-Cup-2012-track-1-shaped, as the reference's data source)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FriendDataSourceParams(Params):
    item_file: str = ""          # "<id> <...> <kw;kw;kw>" per line
    user_keyword_file: str = ""  # "<id> <kw:w;kw:w>" per line
    user_action_file: str = ""   # "<src> <dst> <weight>" per line


@dataclass
class FriendTrainingData:
    user_ids: Dict[str, int]            # external -> dense row
    item_ids: Dict[str, int]
    user_kw: np.ndarray                 # [n_users, HASH_DIM] float32
    item_kw: np.ndarray                 # [n_items, HASH_DIM] float32
    edges: np.ndarray                   # [n_edges, 3] (src, dst, weight)


def _hash_into(row: np.ndarray, kw: int, weight: float):
    row[kw % HASH_DIM] += weight


class FriendDataSource(DataSource):
    PARAMS_CLASS = FriendDataSourceParams

    def read_training(self) -> FriendTrainingData:
        p = self.params
        item_ids: Dict[str, int] = {}
        item_rows = []
        with open(p.item_file) as f:
            for line in f:
                parts = line.split()
                item_ids[parts[0]] = len(item_rows)
                row = np.zeros(HASH_DIM, np.float32)
                for kw in parts[-1].split(";"):
                    _hash_into(row, int(kw), 1.0)
                item_rows.append(row)
        user_ids: Dict[str, int] = {}
        user_rows = []
        with open(p.user_keyword_file) as f:
            for line in f:
                uid, kws = line.split()
                user_ids[uid] = len(user_rows)
                row = np.zeros(HASH_DIM, np.float32)
                for pair in kws.split(";"):
                    kw, w = pair.split(":")
                    _hash_into(row, int(kw), float(w))
                user_rows.append(row)
        edges = []
        if p.user_action_file and os.path.exists(p.user_action_file):
            with open(p.user_action_file) as f:
                for line in f:
                    s, d, w = line.split()
                    if s in user_ids and d in user_ids:
                        edges.append((user_ids[s], user_ids[d], float(w)))
        return FriendTrainingData(
            user_ids, item_ids,
            np.stack(user_rows) if user_rows else
            np.zeros((0, HASH_DIM), np.float32),
            np.stack(item_rows) if item_rows else
            np.zeros((0, HASH_DIM), np.float32),
            np.array(edges, np.float32).reshape(-1, 3))


@dataclass(frozen=True)
class FriendQuery:
    user: str
    item: str

    @staticmethod
    def from_dict(d):
        return FriendQuery(user=str(d["user"]), item=str(d["item"]))


@dataclass(frozen=True)
class FriendPrediction:
    confidence: float
    acceptance: bool

    def to_dict(self):
        return {"confidence": self.confidence,
                "acceptance": self.acceptance}


# ---------------------------------------------------------------------------
# keyword similarity (KeywordSimilarityAlgorithm.scala)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class KeywordSimParams(Params):
    sim_weight: float = 1.0
    threshold: float = 1.0
    device: Optional[str] = None   # None = the card; "cpu" only if asked


@dataclass
class KeywordSimModel:
    user_ids: Dict[str, int]
    item_ids: Dict[str, int]
    user_kw: np.ndarray
    item_kw: np.ndarray
    sim_weight: float
    threshold: float
    device: Optional[str] = None


class KeywordSimilarityAlgorithm(LAlgorithm):
    """Hashed keyword dot product over device-cached tables: one row
    pair per query, and a user's row against every item for batch
    scoring."""
    PARAMS_CLASS = KeywordSimParams

    def __init__(self, params=None):
        super().__init__(params or KeywordSimParams())

    def train(self, td: FriendTrainingData) -> KeywordSimModel:
        p = self.params
        return KeywordSimModel(td.user_ids, td.item_ids, td.user_kw,
                               td.item_kw, p.sim_weight, p.threshold,
                               p.device)

    @staticmethod
    def _tables(model: KeywordSimModel):
        from predictionio_tpu_torch.device import resolve_device
        from predictionio_tpu_torch.utils.device_cache import cached_put
        dev = resolve_device(model.device)
        # uploaded once per table: per query only two indices cross
        return (cached_put(model.user_kw, dev),
                cached_put(model.item_kw, dev))

    def predict(self, model: KeywordSimModel,
                query: FriendQuery) -> FriendPrediction:
        uix = model.user_ids.get(query.user)
        iix = model.item_ids.get(query.item)
        if uix is None or iix is None:
            # unseen entity -> zero keyword overlap (reference behavior)
            conf = 0.0
        else:
            conf = float(_pair_dot(*self._tables(model), uix, iix))
        return FriendPrediction(
            confidence=conf,
            acceptance=conf * model.sim_weight >= model.threshold)

    def score_all_items(self, model: KeywordSimModel,
                        user: str) -> np.ndarray:
        """[n_items] similarity row: the user's row against every item
        in one product (the reference loops a HashMap per query)."""
        U, I = self._tables(model)
        return _user_items(U, I, model.user_ids[user]).cpu().numpy()


def _pair_dot(U, I, uix: int, iix: int):
    import torch
    return torch.dot(U[uix], I[iix])


def _user_items(U, I, uix):
    """I @ U[uix]: one user row (or, with an index tensor, a block of
    users as [len(uix), n_items]) against every item, f32."""
    return U[uix] @ I.T


# ---------------------------------------------------------------------------
# SimRank (SimRankAlgorithm.scala / DeltaSimRankRDD.scala)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SimRankParams(Params):
    num_iterations: int = 5
    decay: float = 0.8
    device: Optional[str] = None   # None = the card; "cpu" only if asked


@dataclass
class SimRankModel:
    user_ids: Dict[str, int]
    scores: np.ndarray      # [n, n] SimRank matrix


def adjacency(edges: np.ndarray, n: int, device=None, dtype=None):
    """The column-normalized adjacency W [n, n] on `device`: W[s, d]
    sums the weights of the edges s -> d, each column divided by its
    sum (an empty column stays zero)."""
    import torch
    from predictionio_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    dtype = dtype or torch.float32
    e = np.asarray(edges, np.float32).reshape(-1, 3)
    W = torch.zeros((n, n), dtype=dtype, device=dev)
    src = torch.as_tensor(e[:, 0].astype(np.int64), device=dev)
    dst = torch.as_tensor(e[:, 1].astype(np.int64), device=dev)
    W.index_put_((src, dst), torch.as_tensor(e[:, 2], device=dev,
                                             dtype=dtype), accumulate=True)
    col = W.sum(dim=0, keepdim=True)
    return torch.where(col > 0, W / torch.where(col > 0, col, 1), 0.0)


class SimRankAlgorithm(LAlgorithm):
    """Dense SimRank fixed point on the social graph: the reference's
    per-edge delta propagation becomes decay * W^T S W with the
    diagonal pinned to 1, two matmuls an iteration on the device."""
    PARAMS_CLASS = SimRankParams

    def __init__(self, params=None):
        super().__init__(params or SimRankParams())

    def train(self, td: FriendTrainingData) -> SimRankModel:
        p = self.params
        W = adjacency(td.edges, len(td.user_ids), p.device)
        scores = _simrank(W, p.num_iterations, p.decay)
        return SimRankModel(td.user_ids, scores.cpu().numpy())

    def predict(self, model: SimRankModel,
                query: FriendQuery) -> FriendPrediction:
        a = model.user_ids.get(query.user)
        b = model.user_ids.get(query.item)
        conf = float(model.scores[a, b]) if a is not None and b is not None \
            else 0.0
        return FriendPrediction(confidence=conf, acceptance=conf > 0)


def _simrank(W, iters: int, decay: float):
    """`iters` steps of S <- decay * W^T S W, diag(S) = 1, from S = I, on
    W's device and in W's dtype (a float64 W gives the float64 fixed
    point the f32 one is held to)."""
    import torch
    S = torch.eye(W.shape[0], dtype=W.dtype, device=W.device)
    Wt = W.T
    for _ in range(iters):
        S = decay * (Wt @ S @ W)
        S.fill_diagonal_(1.0)       # diag(S) = 1 by definition
    return S


# ---------------------------------------------------------------------------
# engines + demo
# ---------------------------------------------------------------------------

def keyword_engine():
    return SimpleEngine(FriendDataSource, KeywordSimilarityAlgorithm)


def simrank_engine():
    return SimpleEngine(FriendDataSource, SimRankAlgorithm)


def engine_params(dsp: FriendDataSourceParams,
                  algo_params=None) -> EngineParams:
    return EngineParams(data_source_params=("", dsp),
                        algorithm_params_list=[("", algo_params)])


def write_demo_files(base: str) -> FriendDataSourceParams:
    rng = np.random.default_rng(0)
    item_file = os.path.join(base, "item.txt")
    user_file = os.path.join(base, "user_keyword.txt")
    action_file = os.path.join(base, "user_action.txt")
    with open(item_file, "w") as f:
        for i in range(8):
            kws = ";".join(str(k) for k in
                           rng.choice(50, size=4, replace=False))
            f.write(f"i{i} 1 {kws}\n")
    with open(user_file, "w") as f:
        for u in range(12):
            pairs = ";".join(f"{k}:{rng.integers(1, 4)}"
                             for k in rng.choice(50, size=5, replace=False))
            f.write(f"u{u} {pairs}\n")
    with open(action_file, "w") as f:
        for _ in range(30):
            s, d = rng.choice(12, size=2, replace=False)
            f.write(f"u{s} u{d} {rng.integers(1, 5)}\n")
    return FriendDataSourceParams(item_file=item_file,
                                 user_keyword_file=user_file,
                                 user_action_file=action_file)


def main(which: str = "keyword", device=None):
    base = tempfile.mkdtemp(prefix="friendrec_")
    dsp = write_demo_files(base)
    if which == "simrank":
        engine = simrank_engine()
        q = FriendQuery(user="u1", item="u2")
        ap = SimRankParams(device=device)
    else:
        engine = keyword_engine()
        q = FriendQuery(user="u1", item="i3")
        ap = KeywordSimParams(device=device)
    trained = engine.train(engine_params(dsp, ap))
    algo, model = trained.algorithms[0], trained.models[0]
    pred = algo.predict(model, q)
    print(f"{which}: query={q} -> {pred.to_dict()}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("which", nargs="?", default="keyword",
                    choices=["keyword", "simrank"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    main(args.which, args.device)
