"""Model-version registry: each folded model is published as a version.

The port's counterpart of `predictionio_tpu/online/registry.py`
(`ModelVersionRegistry.publish`, `versions`, `online_versions`,
`ONLINE_BATCH_TAG`). A publish clones the serving engine instance into a
new row tagged as an online update (its lineage, JSON, in `batch`),
serializes the models through the engine's own path (host numpy only,
`utils/arrays.to_host`) and marks the row COMPLETED, which is what
`get_latest_completed`, and so a deploy or a `/reload`, picks up. A
failed serialization or write leaves the row ABORTED, never INIT.
Version history is engine-instance history.

The last-good pin (`pin_last_good`, `last_good`) is a crash-atomic JSON
file at the reference's path, `{PIO_FS_BASEDIR}/guard/last_good_{key}.json`,
so a pin either package writes the other reads. The canary watchdog pins
each promoted version; `demote_version` marks a rolled-back one
`ROLLEDBACK`, and `rollback_to` (`pio rollback`) demotes every version
newer than its target, so `get_latest_completed`, and so a deploy or a
`/reload`, resolves the target again; a rollback is a
`registry_rollback` flight record and captures an incident bundle.
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
import os
import re
from typing import Any, Dict, List, Optional, Sequence

from predictionio_tpu_torch.core.engine import TrainResult
from predictionio_tpu_torch.data.storage.base import EngineInstance, Model
from predictionio_tpu_torch.data.storage.registry import Storage, base_dir

logger = logging.getLogger(__name__)

#: `batch` prefix of the instances the online path writes
ONLINE_BATCH_TAG = "online-fold-in"

#: the status of a version a rollback demoted: no longer COMPLETED, so
#: `get_latest_completed` (deploy, `/reload`) skips it
ROLLEDBACK_STATUS = "ROLLEDBACK"


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
        # a version with sharded factor tables records its layout, so a
        # reader tells the layouts apart without loading the models
        from predictionio_tpu_torch.parallel.sharded_table import \
            sharding_meta
        info = sharding_meta(models)
        if info is not None:
            lineage.setdefault("sharding", info)
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

    # -- the last-good pin and rollback ------------------------------------
    @staticmethod
    def _pin_path(engine_id: str, engine_version: str,
                  engine_variant: str) -> str:
        key = re.sub(r"[^A-Za-z0-9._-]", "_",
                     f"{engine_id}_{engine_version}_{engine_variant}")
        return os.path.join(base_dir(), "guard", f"last_good_{key}.json")

    def pin_last_good(self, engine_id: str, engine_version: str,
                      engine_variant: str, instance_id: str) -> None:
        """Record `instance_id` as the engine's last-good version: a temp
        file, fsync, then `os.replace`, so a crash leaves the old pin or
        the new one."""
        path = self._pin_path(engine_id, engine_version, engine_variant)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"instanceId": instance_id,
                       "pinnedAt": _now().isoformat()}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        logger.info("pinned last-known-good %s for %s %s %s",
                    instance_id, engine_id, engine_version, engine_variant)

    def last_good(self, engine_id: str, engine_version: str,
                  engine_variant: str) -> Optional[str]:
        try:
            with open(self._pin_path(engine_id, engine_version,
                                     engine_variant)) as f:
                return json.load(f).get("instanceId")
        except (FileNotFoundError, ValueError):
            return None

    def demote_version(self, instance_id: str) -> bool:
        """Mark one COMPLETED version ROLLEDBACK (the canary's verdict
        made durable). False when the instance is unknown or not
        COMPLETED."""
        inst = self.instances.get(instance_id)
        if inst is None or inst.status != "COMPLETED":
            return False
        self.instances.update(inst.with_(status=ROLLEDBACK_STATUS,
                                         end_time=_now()))
        logger.warning("demoted version %s to %s", instance_id,
                       ROLLEDBACK_STATUS)
        return True

    def rollback_to(self, engine_id: str, engine_version: str,
                    engine_variant: str,
                    target_id: Optional[str] = None) -> Dict[str, Any]:
        """Demote every COMPLETED version newer than the target (the
        last-good pin by default, else the previous COMPLETED version)
        and pin the target. Raises ValueError when there is nothing to
        roll back to or the target is not a COMPLETED version. Returns
        `{"target", "demoted"}`."""
        completed = self.versions(engine_id, engine_version, engine_variant)
        if not completed:
            raise ValueError(
                f"no COMPLETED versions for engine {engine_id} "
                f"{engine_version} {engine_variant}")
        target = target_id or self.last_good(engine_id, engine_version,
                                             engine_variant)
        if target is None:
            if len(completed) < 2:
                raise ValueError(
                    "no last-good pin and only one COMPLETED version — "
                    "nothing to roll back to")
            target = completed[1].id    # newest first: the previous one
        if target not in [i.id for i in completed]:
            raise ValueError(
                f"rollback target {target} is not a COMPLETED version "
                f"of engine {engine_id} {engine_version} {engine_variant}")
        demoted = []
        now = _now()
        for inst in completed:
            if inst.id == target:
                break
            self.instances.update(inst.with_(status=ROLLEDBACK_STATUS,
                                             end_time=now))
            demoted.append(inst.id)
        self.pin_last_good(engine_id, engine_version, engine_variant, target)
        logger.warning("rolled back to %s (demoted: %s)", target,
                       ", ".join(demoted) or "nothing")
        # an operator's rollback is a lifecycle record and an incident
        try:
            from predictionio_tpu_torch.obs import FLIGHT, get_incidents
            FLIGHT.record("registry_rollback", model_version=target,
                          demoted=demoted)
            get_incidents().capture(
                "registry_rollback",
                f"rolled back to {target} ({len(demoted)} version(s) "
                "demoted)",
                context={"target": target, "demoted": demoted,
                         "engineId": engine_id})
        except Exception:
            logger.debug("rollback forensics failed", exc_info=True)
        return {"target": target, "demoted": demoted}
