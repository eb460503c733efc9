"""The port's command line: `python -m predictionio_tpu_torch`.

The port's counterpart of `version`, `status`, `train`, `eval`, `deploy`,
`undeploy`, `update`, `rollback`, `eventserver`, `app`, `accesskey`,
`export`, `import`, `trim` and `cache` of `predictionio_tpu/tools/cli.py` (the
reference's Console, Console.scala:186-651), with the same flags and
messages. `train` runs
`create_workflow_main` in this process; `eval` runs the Evaluation class
and the params generator it is given by dotted path (`create_workflow`'s
evaluation run), records an evaluation instance and writes the best
params to `best.json` in `--output-path` (default: the working
directory, where the reference's Scala engine writes it); `deploy` undeploys a stale server
on the target port, restores and warms the latest trained instance
(`EngineServer.load`), binds, prints the address it serves on (`--port
0` binds any free port, and no stale server is looked for) and serves in
the foreground until `undeploy`, SIGTERM or SIGINT; `--canary-fraction`
stages each version swapped in as a canary for the watchdog to promote or
roll back (`--canary-window` seconds); `--feedback` posts every answer
to the event server at `--event-server-ip:--event-server-port` as a
`predict` event under `--accesskey`. `update` restores the
latest instance as deploy does (without serving it), folds the events
that arrived since into it (`online/scheduler.py`: one forced tick, or a
loop under `--follow`), publishes each folded model as a new version and
`POST`s `/reload` to the deployed server (`--engine-port 0`: publish
only); it prints each fold's report as one JSON line. `rollback` demotes
every version newer than the last-good pin (or `--to`) to ROLLEDBACK and
`POST`s `/reload` (`--engine-port 0`: the registry only). The device comes
from the engine.json's algorithm params (`device`; absent = the card,
which raises RuntimeError without CUDA; `"cpu"` only when named).

`eventserver` binds (`--port 0`: any free port), prints the address it
serves on and serves the REST event API (`data/api/event_server.py`) in
the foreground; `app` and `accesskey` manage apps, channels and access
keys (`tools/app_commands.py`); `export`, `import` and `trim` move events
between the store and JSON-lines or parquet files, or between apps
(`tools/export_import.py`); `status` checks the storage and lists the
CUDA devices, and exits 1 without one; `--telemetry` also prints the
running servers' counters, latency percentiles, compile plane and
slowest traces (`/stats.json`, `/traces.json`), `--slo` their SLO
verdicts and burn rates (`/health.json`), both from the local defaults
(`--engine-port`, `--event-server-port`) or one `--url`. `incidents
{list,show,export}` reads the incident bundles under
`<PIO_FS_BASEDIR>/incidents/` (or a server's over `--url`); `profile top`
prints a server's sampling-profiler stacks, `profile trace
{start,stop}` toggles its torch.profiler device trace. `fleet
{status,metrics,traces}` reads the fleet registry under
`<PIO_FS_BASEDIR>/fleet/` (liveness, the federated scrape, one trace
stitched across processes); `faults` validates a `PIO_FAULTS` spec and
previews its seeded decisions; `spill {status,peek,requeue}` inspects
the event server's spill WAL and retries its quarantined records.
`update --follow` registers as the fleet member `scheduler`. `template
{list,get}` lists the built-in template families and a gallery's
(`--gallery` or `PIO_TEMPLATE_GALLERY`, an `index.json` at a URI read
through `remotefs`) and scaffolds one into a directory
(`tools/templates.py`). `cache
status` prints the salted build directory of the kernels (`compile/cache.py`: its salt, the
libraries built there, stale salts) as JSON; `cache clear` removes the
active salt's libraries (the next first use rebuilds them) and `--all`
every salt's.

The other commands of `bin/pio` (build, unregister, dashboard,
adminserver, servers, snapshot, bootstrap and the rest) are not ported:
run them through the JAX package's `bin/pio` on a machine that has JAX,
against the same store.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import threading
import time
import urllib.error
import urllib.request
from typing import List, Optional

DESCRIPTION = (
    "predictionio_tpu_torch: the PyTorch/CUDA port of pio-tpu. Commands "
    "here: version, status, train, eval, deploy, undeploy, update, "
    "rollback, eventserver, app, accesskey, export, import, trim, cache, "
    "incidents, profile, fleet, faults, spill, template. "
    "Still only in the JAX package's bin/pio: build, dashboard "
    "and the other commands.")


def cmd_version(args) -> int:
    import predictionio_tpu_torch
    print(predictionio_tpu_torch.__version__)
    return 0


def cmd_status(args) -> int:
    """Check the storage backends and list the CUDA devices
    (Console.scala:1033); exits 1 without a card or with a failed
    backend. `--telemetry` and `--slo` poll the running servers, which
    are printed with or without a card here."""
    from predictionio_tpu_torch.data.storage.registry import Storage
    print("Inspecting storage backend connections...")
    results = Storage.verify_all_data_objects()
    summary = Storage.config_summary()
    for repo, ok in results.items():
        print(f"  {repo}: {'OK' if ok else 'FAILED'} "
              f"({summary.get(repo, '?')})")
    print("Inspecting CUDA devices...")
    import torch
    card = torch.cuda.is_available()
    if card:
        names = [f"cuda:{k} {torch.cuda.get_device_name(k)}"
                 for k in range(torch.cuda.device_count())]
        print(f"  {len(names)} device(s): {names}")
    else:
        print("  no CUDA device: the port's entry points need a card "
              "(or device=\"cpu\" by name).")
    if args.telemetry:
        _print_telemetry(args)
    if args.slo:
        _print_slo(args)
    if card and all(results.values()):
        print("Your system is all ready to go.")
        return 0
    return 1


def _status_targets(args):
    """(name, base url) pairs `status --telemetry/--slo` poll: `--url`
    names one server; the default is the local engine and event server
    pair."""
    if args.url:
        return [("member", args.url.rstrip("/"))]
    return [("engine", f"http://{args.ip}:{args.engine_port}"),
            ("events", f"http://{args.ip}:{args.event_server_port}")]


def _print_slo(args) -> None:
    """Each server's /health.json as a burn-rate table."""
    from predictionio_tpu_torch.utils.http import fetch_json
    for name, base in _status_targets(args):
        print(f"{name.capitalize()} server SLOs...")
        h = fetch_json(f"{base}/health.json")
        if "error" in h:
            print(f"  unreachable: {h['error']}")
            continue
        print(f"  overall: {h.get('status')}")
        for s in h.get("slo", ()):
            bits = [f"  {s.get('name', '?'):20s} {s.get('status'):8s}"]
            if s.get("burnFast") is not None:
                bits.append(f"burn fast/slow="
                            f"{s['burnFast']}/{s.get('burnSlow')}")
            if s.get("rateFast") is not None:
                bits.append(f"rate={s['rateFast']}/s "
                            f"(min {s.get('minRate')})")
            if s.get("value") is not None:
                bits.append(f"value={round(s['value'], 3)} "
                            f"(max {s.get('maxValue')})")
            if s.get("eventsFast") is not None:
                bits.append(f"events fast/slow={s['eventsFast']}/"
                            f"{s.get('eventsSlow')} "
                            f"(budget {s.get('budget')})")
            print(" ".join(bits))


def _print_hist(name: str, h) -> None:
    if not isinstance(h, dict) or not h.get("count"):
        return
    print(f"    {name}: n={h['count']} "
          f"p50={h.get('p50', 0) * 1000:.3f}ms "
          f"p95={h.get('p95', 0) * 1000:.3f}ms "
          f"p99={h.get('p99', 0) * 1000:.3f}ms")


def _print_telemetry(args) -> None:
    """The servers' counters, latency percentiles, compile plane and
    slowest recent traces."""
    from predictionio_tpu_torch.utils.http import fetch_json
    targets = dict(_status_targets(args))
    engine = targets.get("engine") or targets.get("member")
    events = targets.get("events") or targets.get("member")
    print("Engine server telemetry...")
    st = fetch_json(f"{engine}/stats.json")
    if "error" in st:
        print(f"  unreachable: {st['error']}")
    else:
        print(f"  requests={st.get('requests')} "
              f"avgServing={st.get('avgServingSec', 0):.6f}s "
              f"avgPredict={st.get('avgPredictSec', 0):.6f}s")
        print(f"  modelSwaps={st.get('modelSwaps')} "
              f"foldIns={st.get('foldIns')} "
              f"foldInEvents={st.get('foldInEvents')} "
              f"version={st.get('modelVersion')}")
        _print_hist("queryLatency", st.get("queryLatency"))
        _print_hist("batchWait", st.get("batchWait"))
        aot = st.get("aot") or {}
        if aot:
            print(f"  aot: resident={aot.get('executablesResident')} "
                  f"hitRate={aot.get('hitRate')} "
                  f"compiles={aot.get('compileCount')} "
                  f"({aot.get('compileSeconds')}s) "
                  f"sharedJits={len(aot.get('sharedJits', []))}")
            for label, bks in sorted(
                    (aot.get("bucketsCompiled") or {}).items()):
                print(f"    {label}: {len(bks)} bucket(s) "
                      f"[{', '.join(bks[:4])}"
                      f"{', ...' if len(bks) > 4 else ''}]")
        bc = st.get("buildCache") or {}
        if bc:
            print(f"  buildCache: entries={bc.get('entries')} "
                  f"hits={bc.get('hits')} misses={bc.get('misses')} "
                  f"salt={bc.get('salt')}")
        if st.get("swapToFirstQueryMs") is not None:
            print(f"  swapToFirstQuery={st['swapToFirstQueryMs']:.1f}ms")
    print("Event server telemetry...")
    ev = fetch_json(f"{events}/stats.json?accessKey={args.accesskey}")
    if "error" in ev:
        print(f"  unreachable or no --stats: {ev['error']}")
    else:
        cur = ev.get("currentWindow", {})
        print(f"  window events={cur.get('count')} "
              f"byEvent={cur.get('byEvent')}")
    print("Slowest recent traces (engine)...")
    traces = fetch_json(
        f"{engine}/traces.json?n=5&sort=slowest").get("traces")
    if not traces:
        print("  none")
        return
    for t in traces:
        spans = t.get("root", {}).get("children", [])
        stages = ",".join(sp.get("name", "?") for sp in spans[:6])
        print(f"  {t.get('kind'):14s} {t.get('durationMs', 0):>10}ms "
              f"links={len(t.get('links', []))} [{stages}] "
              f"{t.get('traceId')}")


def cmd_train(args) -> int:
    from predictionio_tpu_torch.core.engine import (
        StopAfterPrepareInterruption, StopAfterReadInterruption)
    from predictionio_tpu_torch.workflow import (WorkflowConfig,
                                                 create_workflow_main)
    config = WorkflowConfig(
        batch=args.batch or "",
        engine_variant=args.engine_json,
        engine_id=args.engine_id or "default",
        engine_version=args.engine_version or "0",
        engine_factory=args.engine_factory,
        skip_sanity_check=args.skip_sanity_check,
        stop_after_read=args.stop_after_read,
        stop_after_prepare=args.stop_after_prepare,
        verbose=args.verbose)
    try:
        instance_id = create_workflow_main(config)
    except (StopAfterReadInterruption, StopAfterPrepareInterruption) as e:
        print(f"Training interrupted by {type(e).__name__}.")
        return 0
    print(f"Training completed. Engine instance ID: {instance_id}")
    return 0


def cmd_eval(args) -> int:
    from predictionio_tpu_torch.workflow import (WorkflowConfig,
                                                 create_workflow_main)
    config = WorkflowConfig(
        batch=args.batch or "",
        engine_variant=args.engine_json,
        evaluation_class=args.evaluation_class,
        engine_params_generator_class=args.engine_params_generator_class,
        output_path=args.output_path)
    instance_id = create_workflow_main(config)
    print(f"Evaluation completed. Evaluation instance ID: {instance_id}")
    return 0


def _serve_foreground(server, label: str) -> int:
    """Serve a bound server on this thread until `/stop`, SIGTERM or
    SIGINT. A signal stops the server from a helper thread (stopping
    from inside the serve loop's own thread would deadlock) and
    hard-exits with status 1 if the teardown has not finished within
    15 s. Once the serve loop returns, this thread finishes the teardown
    (a second `stop` waits for one under way) and stops the process's
    background writers, so that no daemon thread is mid-call when the
    interpreter exits."""
    torn_down = threading.Event()

    def stopper():
        deadline = time.time() + 15
        while time.time() < deadline:
            server.stop()
            if torn_down.wait(0.5):
                return
        print(f"{label}: shutdown did not complete within 15s; "
              "hard-exiting with status 1.", flush=True)
        os._exit(1)

    def on_signal(signum, frame):
        print(f"{label}: received signal {signum}, shutting down.",
              flush=True)
        threading.Thread(target=stopper, daemon=True).start()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, on_signal)
    server.start(background=False)
    server.stop()
    from predictionio_tpu_torch.obs import FLIGHT, PROFILER
    PROFILER.stop()
    FLIGHT.flush()
    FLIGHT.close()
    torn_down.set()
    return 0


def _stop_stale_server(ip: str, port: int) -> None:
    """Undeploy a server holding the target port, as the reference's
    MasterActor does before it binds (CreateServer.scala:288-310)."""
    stop_ip = ip if ip != "0.0.0.0" else "127.0.0.1"
    try:
        req = urllib.request.Request(f"http://{stop_ip}:{port}/stop",
                                     method="POST", data=b"")
        urllib.request.urlopen(req, timeout=3).read()
    except OSError:
        return    # nothing listens there
    print(f"Undeployed a stale engine server on port {port}.", flush=True)
    time.sleep(1)


def cmd_deploy(args) -> int:
    from predictionio_tpu_torch.serving.server import (EngineServer,
                                                       ServerConfig)
    if args.port:
        _stop_stale_server(args.ip, args.port)
    config = ServerConfig(
        ip=args.ip, port=args.port,
        engine_instance_id=args.engine_instance_id,
        engine_id=args.engine_id or "default",
        engine_version=args.engine_version or "0",
        engine_variant=args.engine_json,
        feedback=args.feedback,
        event_server_ip=args.event_server_ip,
        event_server_port=args.event_server_port,
        accesskey=args.accesskey or "",
        canary_fraction=args.canary_fraction,
        canary_window_s=args.canary_window)
    server = EngineServer(config).load().bind()
    print(f"Engine is deployed and running. Engine API is live at "
          f"http://{config.ip}:{config.port}.", flush=True)
    return _serve_foreground(server, "engine server")


def cmd_undeploy(args) -> int:
    """POST /stop to the deployed server."""
    try:
        req = urllib.request.Request(f"http://{args.ip}:{args.port}/stop",
                                     method="POST", data=b"")
        with urllib.request.urlopen(req, timeout=10) as resp:
            resp.read()
    except OSError as e:
        print(f"Undeploy failed: {e}")
        return 1
    print(f"Undeployed engine server at {args.ip}:{args.port}.")
    return 0


def cmd_update(args) -> int:
    """Fold the fresh events into the deployed engine: one forced tick,
    or a tick every `--interval` seconds under `--follow` until SIGINT;
    each folded model is published and the deployed server reloaded."""
    from predictionio_tpu_torch.online import (DeltaTrainingScheduler,
                                               ModelVersionRegistry,
                                               SchedulerConfig)
    from predictionio_tpu_torch.serving.server import (EngineServer,
                                                       ServerConfig)
    # the latest model, restored as deploy restores it, served nowhere
    loader = EngineServer(ServerConfig(
        ip="127.0.0.1", port=0, engine_id=args.engine_id or "default",
        engine_version=args.engine_version or "0",
        engine_variant=args.engine_json, micro_batch=0))
    loader.load()
    _, ds_params = loader.engine_params.data_source_params
    app_name = args.app_name or getattr(ds_params, "app_name", None)
    if not app_name:
        print("No app name: pass --app-name or set it in the variant's "
              "datasource params.")
        return 1
    config = SchedulerConfig(
        app_name=app_name,
        channel_name=getattr(ds_params, "channel_name", None),
        max_deltas=args.max_deltas, max_staleness_s=args.max_staleness,
        drift_ratio=args.drift_ratio, poll_interval_s=args.interval)
    reload_url = (f"http://{args.engine_ip}:{args.engine_port}/reload"
                  if args.engine_port else None)
    sched = DeltaTrainingScheduler(
        engine=loader.engine, engine_params=loader.engine_params,
        instance=loader.engine_instance, algorithms=loader.algorithms,
        models=loader.models, config=config,
        registry=ModelVersionRegistry(), reload_url=reload_url)
    if not args.follow:
        report = sched.tick(force=True)
        print(json.dumps(report or {"message": "no fresh events"}),
              flush=True)
        return 0
    print(f"Following app {app_name!r} (fold at {config.max_deltas} "
          f"deltas or {config.max_staleness_s:g}s staleness; ^C stops).",
          flush=True)
    # a following scheduler is a fleet member (no port): its liveness
    # shows in `fleet status` and guards its flight files
    from predictionio_tpu_torch.obs import fleet
    fleet_id = fleet.register_member("scheduler")
    try:
        while True:
            try:
                report = sched.tick()
            except Exception:
                # the fold restored its deltas: keep following
                logging.getLogger(__name__).exception(
                    "update tick failed; retrying next interval")
                report = None
            if report:
                print(json.dumps(report), flush=True)
            if sched.retrain_requested:
                print("Drift bound exceeded — run `pio train` + "
                      "redeploy, then restart `pio update --follow`.")
                return 2
            time.sleep(config.poll_interval_s)
    except KeyboardInterrupt:
        print("Stopped.")
        print(json.dumps(sched.stats()))
        return 0
    finally:
        fleet.deregister_member(fleet_id)


def cmd_rollback(args) -> int:
    """Demote every COMPLETED version newer than the last-good pin (or
    `--to`) to ROLLEDBACK, so deploy and `/reload` resolve the good
    version again, then `POST /reload` to the deployed server: the
    durable counterpart of the canary's in-memory rollback."""
    from predictionio_tpu_torch.online import ModelVersionRegistry
    try:
        result = ModelVersionRegistry().rollback_to(
            args.engine_id or "default", args.engine_version or "0",
            args.engine_json, target_id=args.to)
    except ValueError as e:
        print(f"Rollback failed: {e}")
        return 1
    print(f"Rolled back to instance {result['target']}.")
    for iid in result["demoted"]:
        print(f"  demoted {iid} -> ROLLEDBACK")
    if not args.engine_port:
        print("No engine server to reload (--engine-port 0).")
        return 0
    url = f"http://{args.engine_ip}:{args.engine_port}/reload"
    try:
        req = urllib.request.Request(url, method="POST", data=b"")
        urllib.request.urlopen(req, timeout=120).read()
    except OSError as e:
        print(f"Reload failed ({e}); the server keeps its current "
              "model until it restarts or /reload succeeds.")
        return 1
    print(f"Reloaded engine server at {url}.")
    return 0


def cmd_eventserver(args) -> int:
    from predictionio_tpu_torch.data.api.event_server import (
        EventServer, EventServerConfig)
    server = EventServer(EventServerConfig(
        ip=args.ip, port=args.port, stats=args.stats,
        max_batch=args.max_batch)).bind()
    print(f"Event Server is listening on http://{args.ip}:"
          f"{server.config.port}", flush=True)
    return _serve_foreground(server, "event server")


def _confirm(question: str) -> bool:
    answer = input(f"{question} (Y/n) ")
    return answer in ("", "y", "Y")


def cmd_app(args) -> int:
    from predictionio_tpu_torch.tools import app_commands as ac

    def show(desc):
        print(f"    App Name: {desc.app.name}")
        print(f"      App ID: {desc.app.id}")
        print(f" Description: {desc.app.description or ''}")
        for k in desc.access_keys:
            events = ",".join(k.events) if k.events else "(all)"
            print(f"  Access Key: {k.key} | {events}")
        for c in desc.channels:
            print(f"     Channel: {c.name} (id {c.id})")

    try:
        if args.app_command == "new":
            desc = ac.app_new(args.name, app_id=args.id or 0,
                              description=args.description,
                              access_key=args.access_key or "")
            print("Created a new app:")
            show(desc)
        elif args.app_command == "list":
            for desc in ac.app_list():
                keys = ", ".join(k.key for k in desc.access_keys)
                print(f"{desc.app.id:4d} | {desc.app.name} | {keys}")
        elif args.app_command == "show":
            show(ac.app_show(args.name))
        elif args.app_command == "delete":
            if not args.force and not _confirm(
                    f"Delete app {args.name} and all its data?"):
                return 1
            ac.app_delete(args.name)
            print(f"Deleted app {args.name}.")
        elif args.app_command == "data-delete":
            if not args.force and not _confirm(
                    f"Delete data of app {args.name}?"):
                return 1
            ac.app_data_delete(args.name, channel=args.channel,
                               delete_all=args.all)
            print(f"Deleted data of app {args.name}.")
        elif args.app_command == "channel-new":
            c = ac.channel_new(args.name, args.channel)
            print(f"Created channel {c.name} (id {c.id}) for app "
                  f"{args.name}.")
        elif args.app_command == "channel-delete":
            if not args.force and not _confirm(
                    f"Delete channel {args.channel} of app {args.name}?"):
                return 1
            ac.channel_delete(args.name, args.channel)
            print(f"Deleted channel {args.channel}.")
        return 0
    except ac.AppCommandError as e:
        print(str(e))
        return 1


def cmd_accesskey(args) -> int:
    from predictionio_tpu_torch.tools import app_commands as ac
    try:
        if args.accesskey_command == "new":
            k = ac.accesskey_new(args.app_name, key=args.key or "",
                                 events=args.event or [])
            print(f"Created new access key: {k.key}")
        elif args.accesskey_command == "list":
            for k in ac.accesskey_list(args.app_name):
                events = ",".join(k.events) if k.events else "(all)"
                print(f"{k.key} | app {k.appid} | {events}")
        elif args.accesskey_command == "delete":
            ac.accesskey_delete(args.key)
            print(f"Deleted access key {args.key}.")
        return 0
    except ac.AppCommandError as e:
        print(str(e))
        return 1


def cmd_template(args) -> int:
    """The template gallery: the built-ins and an optional URI-addressed
    index (Template.scala:130-416; `--gallery` or `PIO_TEMPLATE_GALLERY`
    names the root of `index.json`)."""
    from predictionio_tpu_torch.data.storage.registry import StorageError
    from predictionio_tpu_torch.tools.templates import (GalleryError,
                                                        get_template,
                                                        list_templates)
    try:
        if args.template_command == "list":
            for name, desc in list_templates(gallery=args.gallery):
                print(f"  {name:28s} {desc}")
            return 0
        return get_template(args.name, args.directory,
                            gallery=args.gallery)
    except (GalleryError, StorageError) as e:
        # StorageError: a URI scheme with no registered adapter
        print(f"Template gallery error: {e}")
        return 1


def cmd_export(args) -> int:
    from predictionio_tpu_torch.tools.export_import import (
        export_events, export_events_parquet)
    export = (export_events_parquet if args.format == "parquet"
              else export_events)
    n = export(args.appid, args.output, channel_id=args.channelid)
    print(f"Exported {n} events to {args.output}.")
    return 0


def cmd_import(args) -> int:
    from predictionio_tpu_torch.tools.export_import import (
        import_events, import_events_parquet, import_movielens)
    load = {"movielens": import_movielens,
            "parquet": import_events_parquet}.get(args.format,
                                                  import_events)
    n = load(args.appid, args.input, channel_id=args.channelid)
    print(f"Imported {n} events.")
    return 0


def cmd_trim(args) -> int:
    """Copy a time window of events into a fresh app."""
    from predictionio_tpu_torch.data.event import parse_event_time
    from predictionio_tpu_torch.tools.export_import import trim_events
    try:
        n = trim_events(
            args.src_appid, args.dst_appid,
            start_time=(parse_event_time(args.start)
                        if args.start else None),
            until_time=(parse_event_time(args.until)
                        if args.until else None),
            src_channel_id=args.src_channelid,
            dst_channel_id=args.dst_channelid)
    except ValueError as e:
        print(f"Error: {e}")
        return 1
    print(f"Trimmed {n} events from app {args.src_appid} into app "
          f"{args.dst_appid}.")
    return 0


def cmd_cache(args) -> int:
    """`cache {status,clear [--all]}`: the salted build directory."""
    from predictionio_tpu_torch.compile.cache import (cache_status,
                                                      clear_cache)
    if args.cache_cmd == "status":
        print(json.dumps(cache_status(), indent=2, default=str))
        return 0
    print(json.dumps(clear_cache(all_salts=args.all)))
    return 0


def cmd_incidents(args) -> int:
    """`incidents {list,show,export}`: the incident bundles under
    `<PIO_FS_BASEDIR>/incidents/` (`--dir`), or a server's over `--url`:
    list them, replay one (its providers' states, its flight records in
    order, its traces) or export one as a tar.gz."""
    from predictionio_tpu_torch.obs.incidents import IncidentManager
    from predictionio_tpu_torch.utils.http import fetch_json
    mgr = IncidentManager(incidents_dir=args.dir)
    url = (getattr(args, "url", None) or "").rstrip("/")
    sub = args.incidents_command
    if sub == "list":
        if url:
            body = fetch_json(f"{url}/incidents.json")
            if not isinstance(body, dict) or "incidents" not in body:
                print(f"Cannot list incidents at {url}: "
                      f"{body.get('error') or body.get('message')}")
                return 1
            rows = body["incidents"]
            where = f"{url} ({body.get('incidentsDir')})"
        else:
            rows = mgr.list_incidents()
            where = mgr.incidents_dir()
        if not rows:
            print(f"No incidents under {where}.")
            return 0
        for r in rows:
            print(f"{r['id']:40s} {r.get('kind', '?'):18s} "
                  f"{(r.get('tenant') or '-'):12s} "
                  f"{r.get('capturedAt', '')}  {r.get('reason', '')}")
        return 0
    if sub == "show":
        if url:
            bundle = fetch_json(f"{url}/incidents/{args.id}.json")
            if not isinstance(bundle, dict) or "id" not in bundle:
                print(f"Cannot load incident {args.id} from {url}: "
                      f"{bundle.get('error') or bundle.get('message')}")
                return 1
        else:
            try:
                bundle = mgr.load(args.id)
            except (OSError, ValueError) as e:
                print(f"Cannot load incident {args.id}: {e}")
                return 1
        print(f"Incident {bundle['id']}: {bundle['kind']} — "
              f"{bundle['reason']}")
        print(f"  captured: {bundle.get('capturedAt')}")
        if bundle.get("tenant"):
            print(f"  tenant: {bundle['tenant']}")
        for name, state in (bundle.get("providers") or {}).items():
            print(f"  [{name}] {json.dumps(state, default=str)}")
        flight = bundle.get("flight") or []
        print(f"  flight records ({len(flight)}, oldest first):")
        for rec in flight:
            extra = {k: v for k, v in rec.items()
                     if k not in ("seq", "t", "kind", "traceId",
                                  "modelVersion", "metrics")}
            print(f"    #{rec.get('seq'):>6} {rec.get('kind', '?'):20s}"
                  f" trace={rec.get('traceId', '-'):16s}"
                  f" version={rec.get('modelVersion', '-')} "
                  f"{json.dumps(extra, default=str) if extra else ''}")
        traces = bundle.get("traceDetail") or []
        if traces:
            print(f"  traces ({len(traces)}):")
            for t in traces:
                print(f"    {t.get('kind', '?'):14s} "
                      f"{t.get('traceId')} links={t.get('links')}")
        members = bundle.get("fleet") or []
        if members:
            print(f"  fleet at capture ({len(members)} member(s)):")
            for m in members:
                print(f"    {m.get('memberId', '?'):28s} "
                      f"{'ALIVE' if m.get('alive') else 'DEAD':6s}"
                      f" port={m.get('port') or '-'}"
                      + (f" [{m.get('error') or m.get('metricsError')}]"
                         if m.get("error") or m.get("metricsError")
                         else ""))
        return 0
    if url:
        print("export needs the server's filesystem; run it on that "
              "host (list/show work over --url).")
        return 1
    try:
        out = mgr.export(args.id, args.out)
    except OSError as e:
        print(f"Export failed: {e}")
        return 1
    print(f"Exported incident {args.id} to {out}.")
    return 0


def cmd_profile(args) -> int:
    """`profile top`: a running server's sampling profiler as a
    folded-stack table; `profile trace {start,stop}` toggles its
    torch.profiler device trace (`--device cpu` for a CPU-only
    server)."""
    from predictionio_tpu_torch.utils.http import fetch_json
    base = f"http://{args.ip}:{args.port}"
    if args.profile_command == "top":
        out = fetch_json(f"{base}/profile.json?action=report&top={args.n}")
        if "error" in out:
            print(f"unreachable: {out['error']}")
            return 1
        print(f"Sampling profiler at {base} "
              f"(hz={out.get('hz')}, samples={out.get('samples')}, "
              f"wall={out.get('wallS')}s, "
              f"overhead={out.get('overheadPct')}%)")
        stacks = out.get("topStacks") or []
        if not stacks:
            print("  no samples yet (PIO_PROFILER=off, or the server "
                  "just started)")
            return 0
        for st in stacks:
            print(f"  {st['pct']:6.2f}%  {st['count']:6d}  {st['stack']}")
        return 0
    body = {"action": args.trace_action}
    if args.trace_action == "start":
        if args.dir:
            body["dir"] = args.dir
        if args.device:
            body["device"] = args.device
    req = urllib.request.Request(
        f"{base}/profile.json", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            print(json.dumps(json.loads(resp.read()), indent=2))
        return 0
    except urllib.error.HTTPError as e:
        print(json.dumps(json.loads(e.read() or b"{}"), indent=2))
        return 1
    except Exception as e:
        print(f"unreachable: {e}")
        return 1


def _add_variant_arg(sp) -> None:
    """The engine-variant file flag; --variant/-v are the reference's
    spellings (Console.scala:161)."""
    sp.add_argument("--engine-json", "--variant", "-v",
                    dest="engine_json", default="engine.json",
                    help="engine variant JSON (reference: --variant/-v)")


def cmd_fleet(args) -> int:
    """`fleet {status,metrics,traces}`: the member registry under
    `<PIO_FS_BASEDIR>/fleet/` with liveness, one federated
    {role,pid}-labelled metrics scrape, and one trace id stitched across
    every member's process."""
    from predictionio_tpu_torch.obs import fleet as F
    reg = F.FleetRegistry(fleet_dir=args.dir) if args.dir else F.get_fleet()
    sub = args.fleet_command
    if sub == "status":
        st = F.fleet_status(reg.members(), registry=reg)
        print(f"Fleet under {st['fleetDir']} "
              f"(heartbeat {st['heartbeatS']:g}s, liveness window "
              f"{st['livenessWindowS']:g}s):")
        if not st["members"]:
            print("  no members registered (are the servers running "
                  "with this PIO_FS_BASEDIR?)")
            return 1
        for m in st["members"]:
            url = m.get("url") or (F.member_url(m) or "-")
            print(f"  {m.get('memberId', '?'):28s} "
                  f"{'UP' if m.get('alive') else 'DEAD':5s} "
                  f"pid={m.get('pid')} "
                  f"url={url:<28} "
                  f"beat {m.get('ageS', 0):.1f}s ago"
                  + (f" tenants={','.join(sorted(m['tenants']))}"
                     if m.get("tenants") else ""))
        print(f"  {st['alive']} alive, {st['dead']} dead")
        return 0 if st["dead"] == 0 else 1
    if sub == "metrics":
        print(F.federate_metrics(reg.live_members()).rstrip("\n"))
        return 0
    out = F.fleet_traces(args.id, members=reg.live_members(), limit=args.n)
    for q in out["members"]:
        if not q.get("ok"):
            print(f"# {q.get('memberId')}: {q.get('error')}")
    if not out["traces"]:
        print(f"No member holds trace {args.id} (rings rotate; capture "
              "an incident to freeze one).")
        return 1
    print(f"Trace {args.id}: {len(out['traces'])} process-local "
          f"trace(s) across pids {out['pids']}")

    def walk(span, depth):
        print(f"    {'  ' * depth}{span.get('name', '?'):24s} "
              f"{span.get('durationMs', '?')}ms"
              + (f" {span['attrs']}" if span.get("attrs") else ""))
        for c in span.get("children", ()):
            walk(c, depth + 1)

    for t in out["traces"]:
        m = t.get("member") or {}
        tag = (" <- THE trace" if t.get("traceId") == args.id
               else f" (links {t.get('links')})")
        print(f"  [{m.get('role', '?')}:{t.get('pid', '?')}] "
              f"{t.get('kind'):16s} {t.get('durationMs')}ms "
              f"{t.get('traceId')}{tag}")
        walk(t.get("root") or {}, 1)
    return 0


def cmd_faults(args) -> int:
    """`faults`: parse and validate a `PIO_FAULTS` spec, say whether one
    is active, and preview its seeded decision stream, the dry run
    before chaos is pointed at a live stack."""
    from predictionio_tpu_torch.resilience.faults import (ENV_VAR,
                                                          FaultInjector,
                                                          FaultSpec,
                                                          InjectedFault)
    spec_s = args.spec or os.environ.get(ENV_VAR, "")
    if not spec_s.strip():
        print(f"No fault spec: set {ENV_VAR} or pass --spec.")
        print("Syntax: target:key=value[,key=value][;target:...]")
        print("  e.g. 'storage.write:error=0.3,seed=42'")
        return 0
    try:
        spec = FaultSpec.parse(spec_s)
    except ValueError as e:
        print(f"Invalid fault spec: {e}")
        return 1
    print(f"Fault spec OK (seed={spec.seed if spec.seed is not None else 0}):")
    for target, rule in sorted(spec.rules.items()):
        bits = []
        if rule.error:
            bits.append(f"error={rule.error:g}")
        if rule.partition:
            bits.append(f"partition={rule.partition:g}")
        if rule.latency_ms:
            rate = 1.0 if rule.latency_rate is None else rule.latency_rate
            bits.append(f"latency={rule.latency_ms:g}ms@{rate:g}")
        if rule.corrupt:
            bits.append(f"corrupt={rule.corrupt:g}")
        print(f"  {target:16s} {', '.join(bits) or '(no-op)'}")
    if args.preview:
        inj = FaultInjector(spec, sleep=lambda s: None)
        print(f"First {args.preview} seeded decisions for {args.target!r}:")
        for i in range(args.preview):
            try:
                inj.before(args.target)
                print(f"  {i:3d}  ok")
            except InjectedFault:
                print(f"  {i:3d}  ERROR (injected)")
            except ConnectionError:
                print(f"  {i:3d}  PARTITION (injected)")
    active = os.environ.get(ENV_VAR, "").strip()
    print(f"{ENV_VAR} is "
          + (f"ACTIVE in this environment: {active}" if active
             else "not set (pass it to the server process to arm)"))
    return 0


def cmd_spill(args) -> int:
    """`spill {status,peek,requeue}`: the ingest spill WAL and its
    quarantine sidecar: pending counts, the oldest records, and a retry
    of the quarantined ones once their cause is fixed."""
    from predictionio_tpu_torch.resilience.spill import (iter_pending,
                                                         read_quarantine,
                                                         requeue_quarantined,
                                                         scan_wal)
    path = args.wal
    if not path:
        from predictionio_tpu_torch.data.storage.registry import base_dir
        path = os.path.join(base_dir(), "ingest_spill", "events.wal")
    if args.spill_command == "status":
        s = scan_wal(path)
        if not s["exists"]:
            print(f"No spill WAL at {path} (nothing ever spilled).")
            return 0
        print(f"Spill WAL {path}:")
        print(f"  records total/pending: {s['totalRecords']} / "
              f"{s['pendingRecords']}")
        print(f"  bytes valid/pending:   {s['validBytes']} / "
              f"{s['pendingBytes']}")
        if s["tornBytes"]:
            print(f"  torn tail: {s['tornBytes']} byte(s) (repaired on "
                  "the owning server's next open)")
        print(f"  drain cursor: {s['cursor']}")
        print(f"  quarantined:  {s['quarantined']} record(s)"
              + (f" in {path}.quarantine" if s["quarantined"] else ""))
        return 0
    if args.spill_command == "peek":
        shown = 0
        if args.quarantine:
            for rec in read_quarantine(path)[:args.n]:
                print("QUARANTINED " + json.dumps(rec, sort_keys=True))
                shown += 1
        else:
            for rec in iter_pending(path, limit=args.n):
                print(json.dumps(rec, sort_keys=True))
                shown += 1
        if shown == 0:
            print("No pending spill records." if not args.quarantine
                  else "Quarantine is empty.")
        return 0
    q = read_quarantine(path)
    if not q:
        print("Quarantine is empty; nothing to requeue.")
        return 0
    if not args.force and not _confirm(
            f"Retry {len(q)} quarantined record(s) against the primary "
            "event store?"):
        return 1
    done, kept = requeue_quarantined(path)
    print(f"Requeued {done} record(s) directly into the event store "
          "(id-deduped)."
          + (f" {kept} still-rejected record(s) remain quarantined in "
             f"{path}.quarantine." if kept else " Quarantine cleared."))
    return 0 if not kept else 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m predictionio_tpu_torch",
                                description=DESCRIPTION)
    p.add_argument("--verbose", action="store_true",
                   help="log at DEBUG; train also logs its engine params")
    sub = p.add_subparsers(dest="command", required=True)

    sub.add_parser("version", help="print the port's version"
                   ).set_defaults(func=cmd_version)
    st = sub.add_parser("status", help="check the storage and the CUDA "
                        "devices")
    st.add_argument("--telemetry", action="store_true",
                    help="also poll the running servers' /stats.json and "
                         "/traces.json and print the operator view "
                         "(counters, latency percentiles, fold activity, "
                         "slowest traces)")
    st.add_argument("--slo", action="store_true",
                    help="also poll the running servers' /health.json and "
                         "print each SLO's status and burn rates")
    st.add_argument("--ip", default="127.0.0.1")
    st.add_argument("--engine-port", type=int, default=8000)
    st.add_argument("--event-server-port", type=int, default=7070)
    st.add_argument("--accesskey", default="",
                    help="event-server access key for its /stats.json")
    st.add_argument("--url", help="point --telemetry/--slo at one server "
                    "(http://host:port) instead of the local defaults")
    st.set_defaults(func=cmd_status)

    t = sub.add_parser("train", help="train the engine variant and "
                       "persist an engine instance")
    _add_variant_arg(t)
    t.add_argument("--engine-id")
    t.add_argument("--engine-version")
    t.add_argument("--engine-factory")
    t.add_argument("--batch")
    t.add_argument("--skip-sanity-check", action="store_true")
    t.add_argument("--stop-after-read", action="store_true")
    t.add_argument("--stop-after-prepare", action="store_true")
    t.set_defaults(func=cmd_train)

    e = sub.add_parser("eval", help="evaluate a params sweep and record "
                       "an evaluation instance")
    e.add_argument("evaluation_class")
    e.add_argument("engine_params_generator_class", nargs="?")
    _add_variant_arg(e)
    e.add_argument("--batch")
    e.add_argument("--output-path", default=".",
                   help="directory best.json is written to")
    e.set_defaults(func=cmd_eval)

    d = sub.add_parser("deploy", help="serve the latest trained instance "
                       "in the foreground")
    d.add_argument("--ip", default="0.0.0.0")
    d.add_argument("--port", type=int, default=8000,
                   help="0 binds any free port (printed once bound)")
    _add_variant_arg(d)
    d.add_argument("--engine-id")
    d.add_argument("--engine-version")
    d.add_argument("--engine-instance-id")
    d.add_argument("--feedback", action="store_true",
                   help="post every answer as a predict event to the "
                        "event server")
    d.add_argument("--event-server-ip", default="0.0.0.0")
    d.add_argument("--event-server-port", type=int, default=7070)
    d.add_argument("--accesskey",
                   help="the access key the feedback events are posted "
                        "with")
    d.add_argument("--canary-fraction", type=float, default=0.0,
                   help="guarded deploys: serve each hot-swapped version "
                        "to this traffic share first and roll it back "
                        "on a watchdog breach (0 = swap at once)")
    d.add_argument("--canary-window", type=float, default=30.0,
                   help="the watchdog's decision window, seconds")
    d.set_defaults(func=cmd_deploy)

    u = sub.add_parser("undeploy", help="stop a deployed engine server")
    u.add_argument("--ip", default="127.0.0.1")
    u.add_argument("--port", type=int, default=8000)
    u.set_defaults(func=cmd_undeploy)

    upd = sub.add_parser(
        "update", help="online model updates: fold the fresh events into "
        "the deployed model, publish a version and /reload the server")
    _add_variant_arg(upd)
    upd.add_argument("--engine-id")
    upd.add_argument("--engine-version")
    upd.add_argument("--app-name",
                     help="event app (default: the variant's datasource "
                          "app_name)")
    upd.add_argument("--engine-ip", default="127.0.0.1",
                     help="deployed engine server to POST /reload to")
    upd.add_argument("--engine-port", type=int, default=8000,
                     help="deployed engine server port (0 = publish "
                          "only, no reload)")
    upd.add_argument("--follow", action="store_true",
                     help="keep tailing until ^C (default: one forced "
                          "fold-in tick)")
    upd.add_argument("--interval", type=float, default=2.0,
                     help="--follow poll cadence seconds")
    upd.add_argument("--max-deltas", type=int, default=256,
                     help="fold in after this many fresh events")
    upd.add_argument("--max-staleness", type=float, default=30.0,
                     help="... or once the oldest delta is this old (s)")
    upd.add_argument("--drift-ratio", type=float, default=1.5,
                     help="fold loss / anchor loss bound that escalates "
                          "to a full retrain")
    upd.set_defaults(func=cmd_update)

    rb = sub.add_parser(
        "rollback", help="guarded deploys: demote the versions newer than "
        "the last-known-good pin and /reload the deployed server")
    _add_variant_arg(rb)
    rb.add_argument("--engine-id")
    rb.add_argument("--engine-version")
    rb.add_argument("--to", metavar="INSTANCE_ID",
                    help="the rollback target (default: the last-good "
                         "pin, else the previous COMPLETED version)")
    rb.add_argument("--engine-ip", default="127.0.0.1")
    rb.add_argument("--engine-port", type=int, default=8000,
                    help="deployed engine server to POST /reload to "
                         "(0 = the registry only, no reload)")
    rb.set_defaults(func=cmd_rollback)

    ev = sub.add_parser("eventserver", help="serve the REST event API in "
                        "the foreground")
    ev.add_argument("--ip", default="0.0.0.0")
    ev.add_argument("--port", type=int, default=7070,
                    help="0 binds any free port (printed once bound)")
    ev.add_argument("--stats", action="store_true")
    ev.add_argument("--max-batch", type=int, default=50,
                    help="/batch/events.json size cap (default 50, the "
                         "reference's limit); the columnar write route "
                         "has its own, much larger bound")
    ev.set_defaults(func=cmd_eventserver)

    a = sub.add_parser("app", help="manage apps and their channels")
    asub = a.add_subparsers(dest="app_command", required=True)
    an = asub.add_parser("new")
    an.add_argument("name")
    an.add_argument("--id", type=int)
    an.add_argument("--description")
    an.add_argument("--access-key")
    asub.add_parser("list")
    ash = asub.add_parser("show")
    ash.add_argument("name")
    ad = asub.add_parser("delete")
    ad.add_argument("name")
    ad.add_argument("-f", "--force", action="store_true")
    add_ = asub.add_parser("data-delete")
    add_.add_argument("name")
    add_.add_argument("--channel")
    add_.add_argument("--all", action="store_true")
    add_.add_argument("-f", "--force", action="store_true")
    acn = asub.add_parser("channel-new")
    acn.add_argument("name")
    acn.add_argument("channel")
    acd = asub.add_parser("channel-delete")
    acd.add_argument("name")
    acd.add_argument("channel")
    acd.add_argument("-f", "--force", action="store_true")
    a.set_defaults(func=cmd_app)

    k = sub.add_parser("accesskey", help="manage access keys")
    ksub = k.add_subparsers(dest="accesskey_command", required=True)
    kn = ksub.add_parser("new")
    kn.add_argument("app_name")
    kn.add_argument("--key")
    kn.add_argument("--event", action="append")
    kl = ksub.add_parser("list")
    kl.add_argument("app_name", nargs="?")
    kd = ksub.add_parser("delete")
    kd.add_argument("key")
    k.set_defaults(func=cmd_accesskey)

    tp = sub.add_parser("template", help="list the engine templates or "
                        "scaffold one into a directory")
    tsub = tp.add_subparsers(dest="template_command", required=True)
    tl = tsub.add_parser("list")
    tl.add_argument("--gallery", help="template index URI "
                    "(default: $PIO_TEMPLATE_GALLERY)")
    tg = tsub.add_parser("get")
    tg.add_argument("name")
    tg.add_argument("directory")
    tg.add_argument("--gallery", help="template index URI "
                    "(default: $PIO_TEMPLATE_GALLERY)")
    tp.set_defaults(func=cmd_template)

    ex = sub.add_parser("export", help="write an app's events to a file")
    ex.add_argument("--appid", type=int, required=True)
    ex.add_argument("--output", required=True)
    ex.add_argument("--channelid", type=int)
    ex.add_argument("--format", choices=["json", "parquet"],
                    default="json",
                    help="json = one wire-format event per line; "
                         "parquet = columnar (needs pyarrow)")
    ex.set_defaults(func=cmd_export)

    im = sub.add_parser("import", help="load events from a file into an "
                        "app")
    im.add_argument("--appid", type=int, required=True)
    im.add_argument("--input", required=True)
    im.add_argument("--channelid", type=int)
    im.add_argument("--format",
                    choices=["events", "parquet", "movielens"],
                    default="events",
                    help="events = JSON lines (export's output); parquet "
                         "= export --format parquet's output (needs "
                         "pyarrow); movielens = an ML-100K u.data or "
                         "ML-20M ratings.csv file, directory or .zip")
    im.set_defaults(func=cmd_import)

    tr = sub.add_parser("trim", help="copy a time window of an app's "
                        "events into an empty app")
    tr.add_argument("--src-appid", type=int, required=True)
    tr.add_argument("--dst-appid", type=int, required=True)
    tr.add_argument("--start", help="ISO8601; keep events at/after this")
    tr.add_argument("--until", help="ISO8601; keep events before this")
    tr.add_argument("--src-channelid", type=int)
    tr.add_argument("--dst-channelid", type=int)
    tr.set_defaults(func=cmd_trim)

    ca = sub.add_parser("cache", help="the salted build directory of the "
                        "kernels (the nvcc builds a later process loads)")
    casub = ca.add_subparsers(dest="cache_cmd", required=True)
    casub.add_parser("status")
    cacl = casub.add_parser("clear")
    cacl.add_argument("--all", action="store_true",
                      help="also remove the other salts' directories")
    ca.set_defaults(func=cmd_cache)

    inc = sub.add_parser("incidents", help="browse the incident bundles "
                         "(canary rollbacks, sentinel breaches, gate "
                         "rejections, rollbacks, SLO breaches)")
    incsub = inc.add_subparsers(dest="incidents_command", required=True)
    for name in ("list", "show", "export"):
        sp = incsub.add_parser(name)
        if name != "list":
            sp.add_argument("id")
        sp.add_argument("--dir", help="incidents dir (default: "
                        "<PIO_FS_BASEDIR>/incidents)")
        sp.add_argument("--url", help="a server's bundles over HTTP "
                        "(http://host:port); export refuses it")
        if name == "export":
            sp.add_argument("--out",
                            help="output path (default ./<id>.tar.gz)")
    inc.set_defaults(func=cmd_incidents)

    pf = sub.add_parser("profile", help="read a running server's sampling "
                        "profiler, or toggle its device trace")
    pfsub = pf.add_subparsers(dest="profile_command", required=True)
    pft = pfsub.add_parser("top")
    pft.add_argument("-n", type=int, default=20,
                     help="stacks to show (default 20)")
    pftr = pfsub.add_parser("trace")
    pftr.add_argument("trace_action", choices=("start", "stop"))
    pftr.add_argument("--dir", help="trace output dir (start only)")
    pftr.add_argument("--device", help="\"cpu\" for a CPU-only trace "
                      "(start only; default: the server's device)")
    for sp in (pft, pftr):
        sp.add_argument("--ip", default="127.0.0.1")
        sp.add_argument("--port", type=int, default=8000,
                        help="the server (the event server serves the "
                             "same route under --stats)")
    pf.set_defaults(func=cmd_profile)

    fl = sub.add_parser("fleet", help="the fleet: member liveness, the "
                        "federated {role,pid}-labelled metrics scrape, "
                        "one trace stitched across processes")
    flsub = fl.add_subparsers(dest="fleet_command", required=True)
    flsub.add_parser("status")
    flsub.add_parser("metrics")
    flt = flsub.add_parser("traces")
    flt.add_argument("id", help="the trace id to stitch across the fleet "
                     "(e.g. the traceId an event POST returned)")
    flt.add_argument("-n", type=int, default=50,
                     help="per-member neighborhood cap")
    for sp in flsub.choices.values():
        sp.add_argument("--dir", help="fleet registry dir (default: "
                        "<PIO_FS_BASEDIR>/fleet)")
    fl.set_defaults(func=cmd_fleet)

    fa = sub.add_parser("faults", help="validate a PIO_FAULTS spec and "
                        "preview its seeded decisions")
    fa.add_argument("--spec", help="fault spec (default: $PIO_FAULTS)")
    fa.add_argument("--preview", type=int, default=0, metavar="N",
                    help="print the first N seeded decisions")
    fa.add_argument("--target", default="storage.write",
                    help="target for --preview (default storage.write)")
    fa.set_defaults(func=cmd_faults)

    spl = sub.add_parser("spill", help="inspect the ingest spill WAL and "
                         "its quarantine sidecar")
    spsub = spl.add_subparsers(dest="spill_command", required=True)
    spsub.add_parser("status")
    spp = spsub.add_parser("peek")
    spp.add_argument("n", type=int, nargs="?", default=10,
                     help="records to show (default 10)")
    spp.add_argument("--quarantine", action="store_true",
                     help="the quarantine sidecar instead of the pending "
                          "WAL records")
    spr = spsub.add_parser("requeue")
    spr.add_argument("-f", "--force", action="store_true")
    for sp in spsub.choices.values():
        sp.add_argument("--wal", help="WAL path (default: "
                        "<PIO_FS_BASEDIR>/ingest_spill/events.wal)")
    spl.set_defaults(func=cmd_spill)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="[%(levelname)s] [%(name)s] %(message)s")
    return args.func(args)
