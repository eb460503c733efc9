"""k-fold cross-validation split helper.

The port's copy of `predictionio_tpu/core/cross_validation.py` (the
reference's CommonHelperFunctions.splitData, CrossValidation.scala): fold
membership by `index % k`, emitting (trainingData, evalInfo, [(query,
actual)]) per fold, the shape `DataSource.read_eval` returns.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple, TypeVar

D = TypeVar("D")
TD = TypeVar("TD")
EI = TypeVar("EI")
Q = TypeVar("Q")
A = TypeVar("A")


def split_data(eval_k: int, dataset: Sequence[D], evaluator_info: EI,
               training_data_creator: Callable[[List[D]], TD],
               query_creator: Callable[[D], Q],
               actual_creator: Callable[[D], A]
               ) -> List[Tuple[TD, EI, List[Tuple[Q, A]]]]:
    folds = []
    for fold in range(eval_k):
        training = [d for i, d in enumerate(dataset) if i % eval_k != fold]
        testing = [d for i, d in enumerate(dataset) if i % eval_k == fold]
        folds.append((
            training_data_creator(training),
            evaluator_info,
            [(query_creator(d), actual_creator(d)) for d in testing]))
    return folds
