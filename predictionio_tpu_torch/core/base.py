"""DASE base components: DataSource, Preparator, Algorithm, Serving.

The port's counterpart of `predictionio_tpu/core/base.py`, cut to what
the templates need to train, evaluate, persist and serve. An algorithm
decides how its model persists (`make_persistent_model`) and puts a
restored model on its device (`place_model`). `LAlgorithm` (model and
predict on the host), `P2LAlgorithm` (trained on the device) and
`PAlgorithm` (its tables split over the mesh, `parallel/`) name where a
model lives (`placement`), as in the reference.
"""

from __future__ import annotations

import abc
import inspect
from typing import Any, Iterable, List, Optional, Sequence, Tuple

# EmptyParams is re-exported for the templates
from predictionio_tpu_torch.core.params import (EmptyParams,  # noqa: F401
                                                Params)


def make_component(cls, params: Optional[Params] = None):
    """ctor(params) when the class takes a positional argument, else
    ctor() (decided by signature, so a TypeError raised inside a user's
    __init__ propagates)."""
    if params is None:
        return cls()
    try:
        sig = inspect.signature(cls)
        takes_params = any(
            p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD,
                       p.VAR_POSITIONAL)
            for p in sig.parameters.values())
    except (ValueError, TypeError):   # builtins without signatures
        takes_params = True
    return cls(params) if takes_params else cls()


class SanityCheck(abc.ABC):
    """Optional per-stage data check, run by Engine.train after each
    stage."""

    @abc.abstractmethod
    def sanity_check(self) -> None: ...


class DataSource(abc.ABC):
    def __init__(self, params: Optional[Params] = None):
        self.params = params

    @abc.abstractmethod
    def read_training(self) -> Any: ...

    def read_eval(self) -> List[Tuple[Any, Any, Iterable[Tuple[Any, Any]]]]:
        """Eval sets: (trainingData, evalInfo, [(query, actual)])."""
        return []


class Preparator(abc.ABC):
    def __init__(self, params: Optional[Params] = None):
        self.params = params

    @abc.abstractmethod
    def prepare(self, training_data) -> Any: ...


class IdentityPreparator(Preparator):
    """Hands the training data on as it is."""

    def prepare(self, training_data):
        return training_data


class Algorithm(abc.ABC):
    """One trainable + queryable model."""

    def __init__(self, params: Optional[Params] = None):
        self.params = params

    @abc.abstractmethod
    def train(self, prepared_data) -> Any: ...

    @abc.abstractmethod
    def predict(self, model, query) -> Any: ...

    def batch_predict(self, model, queries: Sequence[Tuple[int, Any]]
                      ) -> List[Tuple[int, Any]]:
        """Bulk predict; the default maps predict()."""
        return [(ix, self.predict(model, q)) for ix, q in queries]

    def make_persistent_model(self, model):
        """How a trained model persists: the model itself (pickled as
        host numpy), a PersistentModel (it saves itself and a manifest is
        stored), or RETRAIN (re-trained at deploy)."""
        return model

    def place_model(self, model):
        """Put a model restored from storage on this algorithm's device
        before it serves; the default serves it as it is."""
        return model

    @property
    def query_class(self):
        """Query type for JSON decode at serve time; None = raw dict."""
        return getattr(self, "QUERY_CLASS", None)


class LAlgorithm(Algorithm):
    """Model in host memory; predict runs on the host."""
    placement = "host"


class P2LAlgorithm(Algorithm):
    """Model trained and served on one device."""
    placement = "device"


class PAlgorithm(Algorithm):
    """Model split over the mesh (`parallel/`): its tables stay sharded
    from the train to the serve path."""
    placement = "mesh"

    def batch_predict(self, model, queries):
        raise NotImplementedError(
            "PAlgorithm does not support batch_predict by default; "
            "override it for evaluation.")


class Serving(abc.ABC):
    """Combines the predictions of all algorithms into one result."""

    def __init__(self, params: Optional[Params] = None):
        self.params = params

    def supplement(self, query):
        """Pre-process a query before the algorithms see it."""
        return query

    @abc.abstractmethod
    def serve(self, query, predictions: Sequence[Any]) -> Any: ...


class FirstServing(Serving):
    """Serve the first algorithm's prediction."""

    def serve(self, query, predictions):
        return predictions[0]


class AverageServing(Serving):
    """The mean of the algorithms' numeric predictions."""

    def serve(self, query, predictions):
        return sum(predictions) / len(predictions)


def run_sanity_check(obj: Any, enabled: bool) -> None:
    if enabled and isinstance(obj, SanityCheck):
        obj.sanity_check()
