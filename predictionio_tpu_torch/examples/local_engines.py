"""The two classic local-engine examples.

The port's copy of `examples/local_engines.py`, the reference's
experimental local engines as behavioral specs of the L (single-process)
algorithm path:

  * helloworld: the average temperature per day from a CSV
    (examples/experimental/scala-local-helloworld/HelloWorld.scala:
    MyDataSource/MyAlgorithm/SimpleEngine);
  * regression: ordinary least squares with a drop-every-nth preparator
    and MSE evaluation over a params grid
    (examples/experimental/scala-local-regression/Run.scala:26-110).

Usage:
    python -m predictionio_tpu_torch.examples.local_engines \\
        [helloworld|regression] [--device cuda|cpu]

Both engines read local files (no event store), which is what an
LDataSource is for. The regression solve is `torch.linalg.lstsq` by
LAPACK's `gels` (QR: the only method CUDA has, and it assumes a
full-rank tall X, which the example's data is) in float32 on the
device the algorithm params name.
"""

import argparse
import os
import tempfile
from dataclasses import dataclass
from typing import Optional

import numpy as np

from predictionio_tpu_torch.core import (AverageMetric, DataSource, Engine,
                                         EngineParams, FirstServing,
                                         LAlgorithm, MetricEvaluator,
                                         Params, Preparator, SimpleEngine)


# ---------------------------------------------------------------------------
# helloworld: average temperature per day (HelloWorld.scala)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HWDataSourceParams(Params):
    filepath: str = ""


class HWDataSource(DataSource):
    PARAMS_CLASS = HWDataSourceParams

    def read_training(self):
        with open(self.params.filepath) as f:
            return [(day, float(temp)) for day, temp in
                    (line.strip().split(",") for line in f if line.strip())]


class HWAlgorithm(LAlgorithm):
    def train(self, temperatures):
        by_day = {}
        for day, temp in temperatures:
            by_day.setdefault(day, []).append(temp)
        return {day: sum(ts) / len(ts) for day, ts in by_day.items()}

    def predict(self, model, query):
        return {"temperature": model[query["day"]]}


def helloworld_engine():
    return SimpleEngine(HWDataSource, HWAlgorithm)


# ---------------------------------------------------------------------------
# regression: OLS + drop-every-nth preparator + MSE eval (Run.scala)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RegDataSourceParams(Params):
    filepath: str = ""


@dataclass
class RegTrainingData:
    x: np.ndarray  # [n, d]
    y: np.ndarray  # [n]


class RegDataSource(DataSource):
    """File rows are "y x1 x2 ..." (Run.scala:40-50); the single eval set
    reuses the training rows, as the reference's FIXME'd read() does."""
    PARAMS_CLASS = RegDataSourceParams

    def _read(self):
        with open(self.params.filepath) as f:
            rows = [line.split() for line in f if line.strip()]
        y = np.array([float(r[0]) for r in rows])
        x = np.array([[float(v) for v in r[1:]] for r in rows])
        return RegTrainingData(x=x, y=y)

    def read_training(self):
        return self._read()

    def read_eval(self):
        td = self._read()
        qas = [(list(map(float, xi)), float(yi))
               for xi, yi in zip(td.x, td.y)]
        return [(td, "The One", qas)]


@dataclass(frozen=True)
class RegPreparatorParams(Params):
    """n=0 keeps everything; n>0 drops rows where index % n == k
    (Run.scala:55-67), the reference's manual fold construction."""
    n: int = 0
    k: int = 0


class RegPreparator(Preparator):
    PARAMS_CLASS = RegPreparatorParams

    def __init__(self, params=None):
        super().__init__(params or RegPreparatorParams())

    def prepare(self, td: RegTrainingData) -> RegTrainingData:
        if self.params.n == 0:
            return td
        keep = np.arange(len(td.y)) % self.params.n != self.params.k
        return RegTrainingData(x=td.x[keep], y=td.y[keep])


@dataclass(frozen=True)
class RegAlgorithmParams(Params):
    device: Optional[str] = None   # None = the card; "cpu" only if asked


def lstsq(x: np.ndarray, y: np.ndarray, device=None) -> np.ndarray:
    """float32 least squares on `device` (QR through LAPACK's `gels`),
    returned as float64 coefficients."""
    import torch
    from predictionio_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    X = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    Y = torch.as_tensor(np.asarray(y, np.float32), device=dev)
    coef = torch.linalg.lstsq(X, Y[:, None], driver="gels").solution
    return coef[:, 0].cpu().numpy().astype(np.float64)


class RegAlgorithm(LAlgorithm):
    """OLS as one device solve (breeze/nak's LinearRegression.regress)."""
    PARAMS_CLASS = RegAlgorithmParams

    def __init__(self, params=None):
        super().__init__(params or RegAlgorithmParams())

    def train(self, td: RegTrainingData) -> np.ndarray:
        return lstsq(td.x, td.y, self.params.device)

    def predict(self, model: np.ndarray, query) -> float:
        return float(np.dot(model, np.asarray(query, np.float64)))


class MeanSquareError(AverageMetric):
    def calculate_one(self, query, predicted, actual) -> float:
        return (predicted - actual) ** 2

    # lower is better (the reference negates through its comparator)
    def compare(self, a: float, b: float) -> int:
        return (a < b) - (a > b)


def regression_engine():
    return Engine({"": RegDataSource}, {"": RegPreparator},
                  {"": RegAlgorithm}, {"": FirstServing})


#: the regression example's params grid: (n, k) of the drop-every-nth
#: preparator
GRID = ((0, 0), (3, 0), (3, 1), (3, 2))


def regression_grid(path: str, device=None):
    return [EngineParams(
        data_source_params=("", RegDataSourceParams(filepath=path)),
        preparator_params=("", RegPreparatorParams(n=n, k=k)),
        algorithm_params_list=[("", RegAlgorithmParams(device=device))])
        for n, k in GRID]


def _write_sample_data(path):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(80, 3))
    y = x @ np.array([2.0, -1.0, 0.5]) + rng.normal(scale=0.01, size=80)
    with open(path, "w") as f:
        for xi, yi in zip(x, y):
            f.write(f"{yi} {' '.join(str(v) for v in xi)}\n")


def main(which: str = "regression", device=None):
    tmp = tempfile.mkdtemp(prefix="pio-local-")
    if which == "helloworld":
        path = os.path.join(tmp, "data.csv")
        with open(path, "w") as f:
            f.write("Mon,75\nTue,80\nWed,70\nThu,65\nFri,60\n"
                    "Sat,55\nSun,50\nMon,65\n")
        engine = helloworld_engine()
        ep = EngineParams(
            data_source_params=("", HWDataSourceParams(filepath=path)),
            algorithm_params_list=[("", None)])
        trained = engine.train(ep)
        algo, model = trained.algorithms[0], trained.models[0]
        for day in ("Mon", "Tue", "Sun"):
            print(day, "->", algo.predict(model, {"day": day}))
        return

    path = os.path.join(tmp, "regression.txt")
    _write_sample_data(path)
    engine = regression_engine()
    grid = regression_grid(path, device)
    result = MetricEvaluator(MeanSquareError()).evaluate_base(engine, grid)
    print("best MSE:", result.best_score.score)
    trained = engine.train(grid[0])
    algo, model = trained.algorithms[0], trained.models[0]
    print("coefficients:", np.round(model, 3))
    print("predict [1,1,1] ->", algo.predict(model, [1.0, 1.0, 1.0]))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("which", nargs="?", default="regression",
                    choices=["helloworld", "regression"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    main(args.which, args.device)
