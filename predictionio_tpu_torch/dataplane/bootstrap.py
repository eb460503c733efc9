"""Snapshot bootstrap of a tenant: restore, streamed train, catch up, admit.

The port's counterpart of `predictionio_tpu/dataplane/bootstrap.py`
(`bootstrap_from_snapshot`, `BootstrapReport`). A new tenant is stood up
from a `snapshot` of its source app's nativelog shard files instead of
replaying its history through the write path:

1. **Restore** the snapshot into the tenant's app
   (`data/storage/snapshot.restore_snapshot`: checksummed, replacing the
   namespace). The manifest's `created` stamp is the cutover;
   `on_restored` is where live ingestion is pointed at the restored
   namespace (what it writes from then on is the tail).
2. **Train** from the restored store with `PIO_DATAPLANE_STREAM=1`, so a
   data source that streams (the recommendation template's) reads
   through the bulk data plane; its tables are bit-equal to a batch
   train's. On the card every solve is the CG kernel.
3. **Catch up**: a scheduler whose cursor is the cutover runs forced
   fold ticks (gates off: nothing is routed to the tenant yet, and the
   gates' baseline predates the tail) until the tail is drained; the
   gates are back on afterwards. A template the scheduler does not fold
   (no `fold_in`, such as the recommended-user one) counts the tail's
   events and drops them, as the reference's scheduler does.
4. **Admit** the loaded server on `host` (`ServingHost.admit_server`)
   only then, with the caught-up scheduler attached.

`python -m predictionio_tpu_torch bootstrap <tenant> --snapshot NAME
--uri URI` runs it, and with `--serve` serves the host in the
foreground. The report adds to the reference's `kernel_launches`: the
solver launches of the train and the catch-up (`ops/solve.COUNTS`), so a
run in another process can show that its solves were kernel launches.
"""

from __future__ import annotations

import datetime as _dt
import logging
import os
import time
from contextlib import contextmanager
from dataclasses import asdict, dataclass, field, replace
from typing import Optional

from predictionio_tpu_torch.data.event import parse_event_time

logger = logging.getLogger(__name__)

#: the switch of the streamed training read that data sources honour
STREAM_ENV = "PIO_DATAPLANE_STREAM"


@dataclass
class BootstrapReport:
    """What one snapshot bootstrap did, stage by stage."""
    tenant: str = ""
    snapshot: str = ""
    app_id: int = 0
    app_name: str = ""
    cutover: str = ""
    restored_files: int = 0
    restored_bytes: int = 0
    restore_s: float = 0.0
    engine_instance_id: str = ""
    train_s: float = 0.0
    #: the streamed load's stage stats (`dataplane.pipeline.last_stats`);
    #: None when the data source read in one batch
    load: Optional[object] = None
    catchup_events: int = 0
    catchup_folds: int = 0
    bootstrap_catchup_s: float = 0.0
    admitted: bool = False
    #: solver launches of the train and the catch-up, by counter
    kernel_launches: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        d = asdict(self)
        if self.load is not None:
            d["load"] = dict(d["load"])
        return d


@contextmanager
def _env(name: str, value: str):
    prev = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prev


def bootstrap_from_snapshot(
        tenant: str, uri: str, snapshot: str, engine, engine_params,
        app_name: Optional[str] = None,
        channel_name: Optional[str] = None,
        host=None,
        engine_id: Optional[str] = None,
        engine_version: str = "0",
        engine_variant: str = "bootstrap",
        engine_factory: str = "",
        force: bool = False,
        stream: bool = True,
        scheduler_config=None,
        start_scheduler: bool = False,
        max_catchup_folds: int = 100,
        priority: int = 0, pinned: bool = False,
        on_restored=None) -> BootstrapReport:
    """Bootstrap one tenant from a snapshot and return the report.

    `engine` and `engine_params` are what to train (as `run_train`
    takes them). `app_name` defaults to the data source params' app, and
    the snapshot is restored into that app (`force=True` replaces a
    namespace that holds events). With `host` the loaded server is
    admitted as tenant `tenant` after the catch-up; without it the
    report and the trained instance are the product."""
    from predictionio_tpu_torch.data.storage import snapshot as S
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.dataplane import pipeline as _pipeline
    from predictionio_tpu_torch.online.scheduler import (SchedulerConfig,
                                                         attach_scheduler)
    from predictionio_tpu_torch.ops.solve import COUNTS
    from predictionio_tpu_torch.serving.server import (EngineServer,
                                                       ServerConfig)
    from predictionio_tpu_torch.workflow.core_workflow import run_train

    report = BootstrapReport(tenant=str(tenant), snapshot=snapshot)
    if app_name is None:
        _, ds_params = engine_params.data_source_params
        app_name = getattr(ds_params, "app_name", None)
        if channel_name is None:
            channel_name = getattr(ds_params, "channel_name", None)
    if not app_name:
        raise ValueError("no app to bootstrap into: pass app_name or set "
                         "it in the engine's datasource params")
    app = Storage.get_meta_data_apps().get_by_name(app_name)
    if app is None:
        raise ValueError(f"app {app_name!r} does not exist; create it "
                         f"first (app new)")
    report.app_name = app_name
    report.app_id = app.id

    # 1. restore: the cutover is the snapshot's creation instant
    t0 = time.perf_counter()
    manifest = S.restore_snapshot(uri, snapshot, app_id=app.id, force=force)
    report.restore_s = time.perf_counter() - t0
    report.restored_files = len(manifest["files"])
    report.restored_bytes = sum(e["bytes"] for e in manifest["files"])
    cutover: _dt.datetime = parse_event_time(manifest["created"])
    report.cutover = manifest["created"]
    if on_restored is not None:
        # live ingestion into the restored namespace from here on: what
        # lands now is after the cutover, and the catch-up folds it
        on_restored(manifest)

    # 2. the streamed train over the restored store
    counts0 = COUNTS.snapshot()
    eid = engine_id or f"bootstrap-{tenant}"
    _pipeline.last_stats = None
    t0 = time.perf_counter()
    with _env(STREAM_ENV, "1" if stream else "0"):
        instance_id = run_train(
            engine, engine_params, engine_id=eid,
            engine_version=engine_version, engine_variant=engine_variant,
            engine_factory=engine_factory)
    report.train_s = time.perf_counter() - t0
    report.engine_instance_id = instance_id
    report.load = _pipeline.last_stats

    # 3. load into a tenant-tagged server and drain the tail from the
    # cutover before anything can route to it
    server = EngineServer(
        ServerConfig(ip="127.0.0.1", port=0, engine_id=eid,
                     engine_version=engine_version,
                     engine_variant=engine_variant, micro_batch=0),
        engine=engine, engine_params=engine_params, tenant=str(tenant),
        shared_result_cache=getattr(host, "result_cache", None))
    server.load()
    # gates off for the catch-up: no traffic reaches the tenant before
    # admission, and the gates' baseline predates the tail
    cfg = scheduler_config or SchedulerConfig(
        app_name=app_name, channel_name=channel_name, gates=False)
    sched = attach_scheduler(server, cfg, cursor=cutover, tenant=str(tenant))
    t0 = time.perf_counter()
    folds = 0
    while folds < max_catchup_folds:
        tick = sched.tick(force=True)
        if tick is None:      # drained: nothing pending after the poll
            break
        folds += 1
        report.catchup_events += tick.get("events", 0)
    report.catchup_folds = folds
    report.bootstrap_catchup_s = time.perf_counter() - t0
    report.kernel_launches = COUNTS.since(counts0)
    if scheduler_config is None:
        # the folds after admission face live traffic: gates back on
        sched.config = replace(cfg, gates=True)
    logger.info("bootstrap %s: caught up %d event(s) in %d fold(s), "
                "%.3fs", tenant, report.catchup_events, folds,
                report.bootstrap_catchup_s)

    # 4. admission: routable only now
    if host is not None:
        from predictionio_tpu_torch.tenancy import TenantSpec
        spec = TenantSpec(key=str(tenant), engine_id=eid,
                          engine_version=engine_version,
                          engine_variant=engine_variant,
                          engine_instance_id=instance_id,
                          priority=priority, pinned=pinned)
        slot = host.admit_server(spec, server)
        slot.scheduler = sched
        report.admitted = True
        if start_scheduler:
            sched.start()
    return report
