"""The Engine: chains DASE components into the train pipeline, persists
what it trained and restores it for serving.

The port's counterpart of `predictionio_tpu/core/engine.py`:
`EngineParams`, `Engine.train` (read -> sanity check ->
prepare -> train every algorithm), the persistence steps
(`make_serializable_models`, `serialize_models`, `deserialize_models`,
`prepare_deploy`; Engine.scala:196-282) and the engine.json params
(`json_to_engine_params`, `engine_params_to_json`; Engine.scala:353),
and evaluation (`eval`, `batch_eval`; Engine.scala:726-816): each eval
set trains on its training split, batch-predicts every algorithm over
its queries (each passed through `Serving.supplement`), serves, and
joins the answers with the actuals.

A model blob holds host numpy only (`utils/arrays.to_host`), and it is
read back through a restricted unpickler that accepts only the classes
models are made of in this package, numpy's array rebuilders and plain
builtins, each by a plain name: a blob the JAX package wrote
names `predictionio_tpu.*` classes and is refused with a ValueError,
without importing that package.
"""

from __future__ import annotations

import io
import logging
import pickle
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type

from predictionio_tpu_torch.core.base import (Algorithm, DataSource,
                                              EmptyParams, Preparator,
                                              Serving, make_component,
                                              run_sanity_check)
from predictionio_tpu_torch.core.params import (Params, params_from_dict,
                                                params_to_dict)
from predictionio_tpu_torch.core.persistence import (
    REFERENCE_PACKAGE, RETRAIN, PersistentModel, PersistentModelManifest,
    load_persistent_model)
from predictionio_tpu_torch.utils.arrays import to_host

logger = logging.getLogger(__name__)

#: builtins a model blob may name (containers and scalars, nothing that
#: runs code)
_SAFE_BUILTINS = frozenset({
    "bool", "bytearray", "bytes", "complex", "dict", "float", "frozenset",
    "int", "list", "object", "range", "set", "slice", "str", "tuple"})
#: what numpy's arrays, scalars and dtypes pickle through
_SAFE_NUMPY = frozenset(
    [("numpy", "ndarray"), ("numpy", "dtype")]
    + [(f"numpy.{core}.{mod}", name)
       for core in ("core", "_core")
       for mod, name in (("multiarray", "_reconstruct"),
                         ("multiarray", "scalar"),
                         ("numeric", "_frombuffer"))])
#: the modules whose classes a model is made of; a class elsewhere in the
#: package (a server, a storage client, a build step) may not be named
_MODEL_MODULES = ("predictionio_tpu_torch.models.",
                  "predictionio_tpu_torch.ops.als.",
                  "predictionio_tpu_torch.ops.forest.",
                  "predictionio_tpu_torch.ops.naive_bayes.",
                  "predictionio_tpu_torch.ops.ratings.",
                  "predictionio_tpu_torch.parallel.sharded_table.",
                  "predictionio_tpu_torch.data.bimap.",
                  "predictionio_tpu_torch.data.datamap.",
                  "predictionio_tpu_torch.core.persistence.")


class StopAfterReadInterruption(Exception):
    """`Engine.train(stop_after_read=True)` stopped after the read."""


class StopAfterPrepareInterruption(Exception):
    """`Engine.train(stop_after_prepare=True)` stopped after the
    prepare."""


@dataclass
class WorkflowParams:
    """A workflow run's switches (the reference's WorkflowParams)."""
    batch: str = ""
    verbose: int = 10
    save_model: bool = True
    skip_sanity_check: bool = False
    stop_after_read: bool = False
    stop_after_prepare: bool = False


@dataclass(frozen=True)
class EngineParams:
    """Named params for each DASE slot."""
    data_source_params: Tuple[str, Any] = ("", EmptyParams())
    preparator_params: Tuple[str, Any] = ("", EmptyParams())
    algorithm_params_list: Sequence[Tuple[str, Any]] = field(
        default_factory=lambda: [("", EmptyParams())])
    serving_params: Tuple[str, Any] = ("", EmptyParams())


@dataclass
class TrainResult:
    models: List[Any]                # one per algorithm
    algorithms: List[Algorithm]      # the instances that trained them


def _build_params(cls, raw: Optional[dict]):
    pc: Optional[Type[Params]] = getattr(cls, "PARAMS_CLASS", None)
    if pc is not None:
        return params_from_dict(pc, raw)
    return raw if raw else EmptyParams()


class _ModelUnpickler(pickle.Unpickler):
    """Resolves only numpy's array and dtype rebuilders, safe builtins and
    the classes of this package that models are made of, each by a plain
    name in the module that defines it: a dotted name (protocol 4 looks
    those up attribute by attribute) is refused."""

    def __init__(self, blob: bytes, instance_id: str):
        super().__init__(io.BytesIO(blob))
        self.instance_id = instance_id

    def find_class(self, module: str, name: str):
        if module.split(".")[0] == REFERENCE_PACKAGE:
            raise ValueError(
                f"the model of engine instance {self.instance_id!r} was "
                f"written by the JAX package (it names {module}.{name}); "
                "predictionio_tpu_torch cannot load it: retrain with this "
                "package")
        if "." not in name:
            if ((module, name) in _SAFE_NUMPY
                    or (module == "builtins" and name in _SAFE_BUILTINS)):
                return super().find_class(module, name)
            if (module + ".").startswith(_MODEL_MODULES):
                try:
                    obj = super().find_class(module, name)
                except (ImportError, AttributeError):
                    obj = None
                if isinstance(obj, type) and obj.__module__ == module:
                    return obj
        raise ValueError(f"the model of engine instance "
                         f"{self.instance_id!r} names {module}.{name}, "
                         "which a model blob may not hold")


def restricted_loads(blob: bytes, instance_id: str = "") -> Any:
    """Unpickle model bytes this package wrote, through `_ModelUnpickler`
    (a manually persisted model's own files go through it too)."""
    return _ModelUnpickler(blob, instance_id).load()


class Engine:
    """Class maps for each DASE slot."""

    def __init__(self, data_source_class_map, preparator_class_map,
                 algorithm_class_map, serving_class_map):
        def as_map(x):
            return x if isinstance(x, dict) else {"": x}
        self.data_source_class_map: Dict[str, type] = as_map(
            data_source_class_map)
        self.preparator_class_map: Dict[str, type] = as_map(
            preparator_class_map)
        self.algorithm_class_map: Dict[str, type] = as_map(
            algorithm_class_map)
        self.serving_class_map: Dict[str, type] = as_map(serving_class_map)

    @staticmethod
    def _lookup(class_map: Dict[str, type], name: str, slot: str) -> type:
        if name not in class_map:
            raise KeyError(
                f"{slot} '{name}' not found; available: {sorted(class_map)}")
        return class_map[name]

    def make_data_source(self, ep: EngineParams) -> DataSource:
        name, params = ep.data_source_params
        return make_component(self._lookup(self.data_source_class_map, name,
                                           "datasource"), params)

    def make_preparator(self, ep: EngineParams) -> Preparator:
        name, params = ep.preparator_params
        return make_component(self._lookup(self.preparator_class_map, name,
                                           "preparator"), params)

    def make_algorithms(self, ep: EngineParams) -> List[Algorithm]:
        return [make_component(self._lookup(self.algorithm_class_map, name,
                                            "algorithm"), params)
                for name, params in ep.algorithm_params_list]

    def make_serving(self, ep: EngineParams) -> Serving:
        name, params = ep.serving_params
        return make_component(self._lookup(self.serving_class_map, name,
                                           "serving"), params)

    def train(self, engine_params: EngineParams, sanity_check: bool = True,
              telemetry: Optional[dict] = None,
              stop_after_read: bool = False,
              stop_after_prepare: bool = False) -> TrainResult:
        """`telemetry`, when a dict, receives the wall time of each stage:
        read_s, prepare_s and train_s (all algorithms). `stop_after_read`
        / `stop_after_prepare` raise `StopAfterReadInterruption` /
        `StopAfterPrepareInterruption` once that stage is done (the
        reference's WorkflowParams, Engine.scala:621-708)."""
        tel = telemetry if telemetry is not None else {}
        t0 = time.perf_counter()
        td = self.make_data_source(engine_params).read_training()
        run_sanity_check(td, sanity_check)
        tel["read_s"] = time.perf_counter() - t0
        if stop_after_read:
            raise StopAfterReadInterruption()
        t0 = time.perf_counter()
        pd = self.make_preparator(engine_params).prepare(td)
        run_sanity_check(pd, sanity_check)
        tel["prepare_s"] = time.perf_counter() - t0
        if stop_after_prepare:
            raise StopAfterPrepareInterruption()
        t0 = time.perf_counter()
        algorithms = self.make_algorithms(engine_params)
        models = []
        for i, algo in enumerate(algorithms):
            logger.info("Training algorithm %d/%d: %s",
                        i + 1, len(algorithms), type(algo).__name__)
            model = algo.train(pd)
            run_sanity_check(model, sanity_check)
            models.append(model)
        tel["train_s"] = time.perf_counter() - t0
        return TrainResult(models=models, algorithms=algorithms)

    # -- eval (Engine.scala:726-816) ---------------------------------------
    def eval(self, engine_params: EngineParams
             ) -> List[Tuple[Any, List[Tuple[Any, Any, Any]]]]:
        """Per eval set: train on its training split, batch-predict every
        algorithm over the queries, serve, and join with the actuals.
        Returns [(evalInfo, [(query, prediction, actual)])]."""
        data_source = self.make_data_source(engine_params)
        eval_sets = data_source.read_eval()
        serving = self.make_serving(engine_params)
        out = []
        for td, eval_info, qa in eval_sets:
            pd = self.make_preparator(engine_params).prepare(td)
            algorithms = self.make_algorithms(engine_params)
            models = [a.train(pd) for a in algorithms]
            qa_list = list(qa)
            indexed = [(ix, serving.supplement(q))
                       for ix, (q, _) in enumerate(qa_list)]
            per_algo = [dict(algo.batch_predict(model, indexed))
                        for algo, model in zip(algorithms, models)]
            qpa = [(q, serving.serve(q, [pa[ix] for pa in per_algo]), a)
                   for ix, (q, a) in enumerate(qa_list)]
            out.append((eval_info, qpa))
        return out

    def batch_eval(self, engine_params_list: Sequence[EngineParams]):
        """Evaluate each params setting (core/BaseEngine.scala:79)."""
        return [(ep, self.eval(ep))
                for ep in engine_params_list]

    # -- persistence (Engine.scala:282, :196-265) --------------------------
    def make_serializable_models(self, train_result: TrainResult,
                                 instance_id: str,
                                 engine_params: EngineParams) -> List[Any]:
        """Per algorithm: model | PersistentModelManifest | RETRAIN."""
        out = []
        for (_, params), algo, model in zip(
                engine_params.algorithm_params_list,
                train_result.algorithms, train_result.models):
            decision = algo.make_persistent_model(model)
            if (isinstance(decision, PersistentModel)
                    and decision.save(instance_id, params)):
                decision = PersistentModelManifest(
                    type(decision).loader_name())
            out.append(decision)
        return out

    def serialize_models(self, serializable_models: List[Any]) -> bytes:
        return pickle.dumps([to_host(m) for m in serializable_models],
                            protocol=pickle.HIGHEST_PROTOCOL)

    def deserialize_models(self, blob: bytes,
                           instance_id: str = "") -> List[Any]:
        """Unpickle a blob `serialize_models` wrote; `instance_id` names
        the instance in the error when the blob is refused."""
        return restricted_loads(blob, instance_id)

    def prepare_deploy(self, engine_params: EngineParams,
                       persisted_models: List[Any], instance_id: str,
                       sanity_check: bool = True) -> TrainResult:
        """Restore models for serving (Engine.scala:196-265): manifests
        are loaded through their loader, RETRAIN models re-run the train
        pipeline, and every model is put on its algorithm's device."""
        algorithms = self.make_algorithms(engine_params)
        retrained: Optional[TrainResult] = None
        if any(m is RETRAIN for m in persisted_models):
            logger.info("Some models request retrain-on-deploy; re-training")
            retrained = self.train(engine_params, sanity_check)
        models = []
        for i, (m, algo) in enumerate(zip(persisted_models, algorithms)):
            if m is RETRAIN:
                m = retrained.models[i]
            elif isinstance(m, PersistentModelManifest):
                m = load_persistent_model(
                    m, instance_id, engine_params.algorithm_params_list[i][1])
            models.append(algo.place_model(m))
        return TrainResult(models=models, algorithms=algorithms)

    # -- engine.json params (Engine.scala:353 jValueToEngineParams) --------
    def json_to_engine_params(self, variant: dict) -> EngineParams:
        def one(slot_key: str, class_map: Dict[str, type]):
            block = variant.get(slot_key) or {}
            name = block.get("name", "")
            cls = self._lookup(class_map, name, slot_key)
            return (name, _build_params(cls, block.get("params")))

        algo_blocks = variant.get("algorithms")
        if algo_blocks is None:
            algo_blocks = [{"name": "", "params": {}}]
        algos = []
        for block in algo_blocks:
            name = block.get("name", "")
            cls = self._lookup(self.algorithm_class_map, name, "algorithm")
            algos.append((name, _build_params(cls, block.get("params"))))
        return EngineParams(
            data_source_params=one("datasource", self.data_source_class_map),
            preparator_params=one("preparator", self.preparator_class_map),
            algorithm_params_list=algos,
            serving_params=one("serving", self.serving_class_map))

    def engine_params_to_json(self, ep: EngineParams) -> dict:
        def one(pair):
            name, params = pair
            return {"name": name, "params": params_to_dict(params)}
        return {
            "datasource": one(ep.data_source_params),
            "preparator": one(ep.preparator_params),
            "algorithms": [one(p) for p in ep.algorithm_params_list],
            "serving": one(ep.serving_params),
        }


class SimpleEngine(Engine):
    """A data source and one algorithm, with the identity preparator and
    the first-answer serving (EngineParams.scala:127)."""

    def __init__(self, data_source_class, algorithm_class,
                 serving_class=None):
        from predictionio_tpu_torch.core.base import (FirstServing,
                                                      IdentityPreparator)
        super().__init__(data_source_class, IdentityPreparator,
                         algorithm_class, serving_class or FirstServing)


class EngineFactory:
    """Engine + default params provider (EngineFactory.scala:28-33)."""

    @classmethod
    def apply(cls) -> Engine:
        raise NotImplementedError
