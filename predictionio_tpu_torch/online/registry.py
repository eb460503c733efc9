"""Model-version registry: each folded model is published as a version.

The port's counterpart of `predictionio_tpu/online/registry.py`
(`ModelVersionRegistry.publish`, `versions`, `online_versions`,
`ONLINE_BATCH_TAG`). A publish clones the serving engine instance into a
new row tagged as an online update (its lineage, JSON, in `batch`),
serializes the models through the engine's own path (host numpy only,
`utils/arrays.to_host`) and marks the row COMPLETED, which is what
`get_latest_completed`, and so a deploy or a `/reload`, picks up. A
failed serialization or write leaves the row ABORTED, never INIT.
Version history is engine-instance history. The last-good pins,
`demote_version` and `rollback_to` ride with the canary, a later slice.
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
from typing import Any, List, Optional, Sequence

from predictionio_tpu_torch.core.engine import TrainResult
from predictionio_tpu_torch.data.storage.base import EngineInstance, Model
from predictionio_tpu_torch.data.storage.registry import Storage

logger = logging.getLogger(__name__)

#: `batch` prefix of the instances the online path writes
ONLINE_BATCH_TAG = "online-fold-in"


def _now() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


class ModelVersionRegistry:
    """Publishes and lists model versions over the metadata DAOs.
    `gatekeeper` (`guard/gates.QualityGatekeeper`), when set, refuses a
    non-finite model before any row is written."""

    def __init__(self, instances=None, models=None, gatekeeper=None):
        self._instances = instances
        self._models = models
        self.gatekeeper = gatekeeper

    @property
    def instances(self):
        return self._instances or Storage.get_meta_data_engine_instances()

    @property
    def models(self):
        return self._models or Storage.get_model_data_models()

    def publish(self, engine, engine_params, base_instance: EngineInstance,
                models: Sequence[Any], meta: Optional[dict] = None) -> str:
        """Persist `models` as a new COMPLETED version derived from
        `base_instance`; returns its instance id."""
        if self.gatekeeper is not None:
            self.gatekeeper.check_publishable(models)
        now = _now()
        lineage = dict(meta or {})
        lineage["baseInstance"] = base_instance.id
        instance = base_instance.with_(
            id="", status="INIT", start_time=now, end_time=now,
            batch=f"{ONLINE_BATCH_TAG}:"
                  f"{json.dumps(lineage, sort_keys=True)}")
        instance_id = self.instances.insert(instance)
        instance = self.instances.get(instance_id)
        try:
            result = TrainResult(
                models=list(models),
                algorithms=engine.make_algorithms(engine_params))
            blob = engine.serialize_models(engine.make_serializable_models(
                result, instance_id, engine_params))
            self.models.insert(Model(instance_id, blob))
        except Exception:
            self.instances.update(instance.with_(status="ABORTED",
                                                 end_time=_now()))
            raise
        self.instances.update(instance.with_(status="COMPLETED",
                                             end_time=_now()))
        logger.info("Published online model version %s (base %s)",
                    instance_id, base_instance.id)
        return instance_id

    def versions(self, engine_id: str, engine_version: str,
                 engine_variant: str) -> List[EngineInstance]:
        """COMPLETED instances of one engine, newest first: trainings
        and online versions in publish order."""
        return self.instances.get_completed(engine_id, engine_version,
                                            engine_variant)

    def online_versions(self, engine_id: str, engine_version: str,
                        engine_variant: str) -> List[EngineInstance]:
        return [i for i in self.versions(engine_id, engine_version,
                                         engine_variant)
                if i.batch.startswith(ONLINE_BATCH_TAG)]
