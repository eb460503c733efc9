"""Dashboard server: lists evaluation instances + results.

The port's copy of `predictionio_tpu/tools/dashboard.py`. It rebuilds the
reference's Dashboard
(reference: tools/src/main/scala/io/prediction/tools/dashboard/Dashboard.scala:76-138
and the twirl index page): an HTML index of completed evaluation instances
with per-instance result pages in txt/html/json.

``/telemetry`` is a compact live view of the stack — the
engine and event servers' ``/stats.json`` (fetched over HTTP, so the
dashboard works from its own process) plus this process's own registry
snapshot and recent traces — and ``/metrics`` for the dashboard process
itself; its registry carries the port's `obs/torchmon` families where
the reference's carries the JAX runtime's. ``/traces.json``,
``/flight.json`` and ``/fleet/*`` serve this process's rings and the fleet
registry, as both servers do.
"""

from __future__ import annotations

import html as _html
from dataclasses import dataclass

from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.obs import get_registry
from predictionio_tpu_torch.utils.http import (HttpServer, Request, Response,
                                               Router)


@dataclass
class DashboardConfig:
    ip: str = "127.0.0.1"
    port: int = 9000
    # the stack servers the /telemetry view polls
    engine_url: str = "http://127.0.0.1:8000"
    event_server_url: str = "http://127.0.0.1:7070"


class Dashboard:
    def __init__(self, config: DashboardConfig = DashboardConfig()):
        self.config = config
        from predictionio_tpu_torch.obs import torchmon
        torchmon.install()   # /metrics carries the torch runtime families
        self.router = self._build_router()
        self.server = None
        self._fleet_id = None   # set by start()'s on_bound

    def _index(self, req: Request) -> Response:
        instances = Storage.get_meta_data_evaluation_instances() \
            .get_completed()
        rows = []
        for i in instances:
            rows.append(
                f"<tr><td>{i.id}</td>"
                f"<td>{_html.escape(i.evaluation_class)}</td>"
                f"<td>{_html.escape(i.engine_params_generator_class)}</td>"
                f"<td>{i.start_time}</td><td>{i.end_time}</td>"
                f"<td><a href='/engine_instances/{i.id}/evaluator_results."
                f"txt'>txt</a> "
                f"<a href='/engine_instances/{i.id}/evaluator_results."
                f"html'>HTML</a> "
                f"<a href='/engine_instances/{i.id}/evaluator_results."
                f"json'>JSON</a></td></tr>")
        page = ("<html><head><title>PredictionIO Dashboard</title></head>"
                "<body><h1>Completed Evaluations</h1><table border=1>"
                "<tr><th>ID</th><th>Evaluation</th><th>Generator</th>"
                "<th>Start</th><th>End</th><th>Results</th></tr>"
                + "".join(rows) + "</table></body></html>")
        return Response(200, page, content_type="text/html; charset=UTF-8")

    def _result(self, req: Request) -> Response:
        instance_id, fmt = req.path_args
        i = Storage.get_meta_data_evaluation_instances().get(instance_id)
        if i is None or i.status != "EVALCOMPLETED":
            return Response(404, {"message": "Not Found"})
        if fmt == "txt":
            return Response(200, i.evaluator_results,
                            content_type="text/plain; charset=UTF-8")
        if fmt == "html":
            return Response(200, i.evaluator_results_html,
                            content_type="text/html; charset=UTF-8")
        return Response(200, i.evaluator_results_json)

    # -- the compact live telemetry view -----------------------------------
    @staticmethod
    def _fetch_json(url: str):
        from predictionio_tpu_torch.utils.http import fetch_json
        return fetch_json(url)

    @staticmethod
    def _kv_rows(d: dict, keys) -> str:
        rows = []
        for k in keys:
            if k in d:
                v = d[k]
                if isinstance(v, float):
                    v = f"{v:.6g}"
                rows.append(f"<tr><td>{_html.escape(str(k))}</td>"
                            f"<td>{_html.escape(str(v))}</td></tr>")
        return "".join(rows)

    @staticmethod
    def _hist_row(name: str, h: dict) -> str:
        if not isinstance(h, dict) or "count" not in h:
            return ""
        cells = "".join(
            f"<td>{h.get(k, 0.0) * 1000:.3f}</td>"
            for k in ("p50", "p95", "p99"))
        return (f"<tr><td>{_html.escape(name)}</td>"
                f"<td>{h['count']}</td>{cells}</tr>")

    def _telemetry(self, req: Request) -> Response:
        """GET /telemetry — one page: per-server counters and latency
        percentiles, slowest recent traces, this process's registry."""
        cfg = self.config
        engine = self._fetch_json(f"{cfg.engine_url}/stats.json")
        events = self._fetch_json(f"{cfg.event_server_url}/stats.json")
        traces = self._fetch_json(
            f"{cfg.engine_url}/traces.json?n=10&sort=slowest"
        ).get("traces", [])

        eng_rows = self._kv_rows(engine, (
            "error", "requestCount", "avgServingSec", "avgPredictSec",
            "modelSwaps", "foldIns", "foldInEvents", "modelVersion"))
        hist_rows = "".join(
            self._hist_row(name, engine.get(name, {}))
            for name in ("queryLatency", "batchWait"))
        ev_rows = self._kv_rows(events, ("error",))
        cur = events.get("currentWindow")
        if isinstance(cur, dict):
            ev_rows += self._kv_rows(cur, ("count",))
            for k, v in sorted(cur.get("byEvent", {}).items()):
                ev_rows += (f"<tr><td>event {_html.escape(k)}</td>"
                            f"<td>{v}</td></tr>")
        trace_rows = "".join(
            f"<tr><td>{_html.escape(t.get('kind', '?'))}</td>"
            f"<td>{_html.escape(t.get('traceId', ''))}</td>"
            f"<td>{t.get('durationMs')}</td>"
            f"<td>{len(t.get('links', []))}</td></tr>"
            for t in traces if isinstance(t, dict))
        # slow-query waterfalls: the engine server's ring,
        # each row a stage breakdown whose trace id is replayable via
        # /traces.json?trace_id=
        slow = self._fetch_json(
            f"{cfg.engine_url}/slow.json?n=10").get("slow", [])
        slow_rows = ""
        for e in slow:
            if not isinstance(e, dict):
                continue
            waterfall = " → ".join(
                "{} {}ms".format(st.get("stage"), st.get("ms"))
                for st in e.get("stages", ()))
            slow_rows += (
                f"<tr><td>{_html.escape(str(e.get('traceId', '')))}"
                f"</td><td>{_html.escape(str(e.get('tenant') or '-'))}"
                f"</td><td>{e.get('totalMs')}</td>"
                f"<td>{_html.escape(waterfall)}</td></tr>")
        reg_rows = ""
        for name, val in sorted(get_registry().snapshot().items()):
            if isinstance(val, dict) and "count" in val:
                reg_rows += self._hist_row(name, val)
            elif isinstance(val, (int, float)):
                reg_rows += (f"<tr><td>{_html.escape(name)}</td>"
                             f"<td>{val:g}</td></tr>")
        page = f"""<html><head><title>pio-tpu telemetry</title>
<meta http-equiv="refresh" content="5"></head><body>
<h1>Telemetry</h1>
<h2>Engine server ({_html.escape(cfg.engine_url)})</h2>
<table border=1>{eng_rows}</table>
<table border=1><tr><th>histogram</th><th>count</th><th>p50 ms</th>
<th>p95 ms</th><th>p99 ms</th></tr>{hist_rows}</table>
<h2>Event server ({_html.escape(cfg.event_server_url)})</h2>
<table border=1>{ev_rows}</table>
<h2>Slowest recent traces</h2>
<table border=1><tr><th>kind</th><th>trace</th><th>ms</th>
<th>links</th></tr>{trace_rows}</table>
<h2>Slow-query waterfalls</h2>
<table border=1><tr><th>trace</th><th>tenant</th><th>total ms</th>
<th>stages</th></tr>{slow_rows}</table>
<h2>This process's registry</h2>
<table border=1>{reg_rows}</table>
</body></html>"""
        return Response(200, page, content_type="text/html; charset=UTF-8")

    def _metrics(self, req: Request) -> Response:
        from predictionio_tpu_torch.utils.prometheus import CONTENT_TYPE
        return Response(200, get_registry().render(),
                        content_type=CONTENT_TYPE)

    def _traces(self, req: Request) -> Response:
        from predictionio_tpu_torch.obs import traces_response
        return Response(200, traces_response(req.params))

    def _flight(self, req: Request) -> Response:
        """GET /flight.json — the dashboard process's flight ring;
        per-server rings live on the servers themselves."""
        from predictionio_tpu_torch.obs import flight_response
        return Response(200, flight_response(req.params))

    # -- fleet federation: the dashboard is a full fleet
    # citizen — it registers a member record and serves the same
    # /fleet/* federation surface as both servers, so an operator can
    # point Prometheus or `pio fleet` at whichever process is exposed.
    def _fleet_status(self, req: Request) -> Response:
        from predictionio_tpu_torch.obs import fleet
        return Response(200, fleet.fleet_status_response(req.params))

    def _fleet_health(self, req: Request) -> Response:
        from predictionio_tpu_torch.obs import fleet
        return Response(200, fleet.fleet_health_response(req.params))

    def _fleet_metrics(self, req: Request) -> Response:
        from predictionio_tpu_torch.obs import fleet
        from predictionio_tpu_torch.utils.prometheus import CONTENT_TYPE
        return Response(200, fleet.fleet_metrics_response(req.params),
                        content_type=CONTENT_TYPE)

    def _fleet_traces(self, req: Request) -> Response:
        from predictionio_tpu_torch.obs import fleet
        return Response(200, fleet.fleet_traces_response(req.params))

    def _build_router(self) -> Router:
        r = Router()
        r.add("GET", "/", self._index)
        r.add("GET", "/telemetry", self._telemetry)
        r.add("GET", "/metrics", self._metrics)
        r.add("GET", "/traces.json", self._traces)
        r.add("GET", "/flight.json", self._flight)
        r.add("GET", "/fleet/status.json", self._fleet_status)
        r.add("GET", "/fleet/health.json", self._fleet_health)
        r.add("GET", "/fleet/metrics", self._fleet_metrics)
        r.add("GET", "/fleet/traces.json", self._fleet_traces)
        r.add("GET", "/engine_instances/<id>/evaluator_results.<fmt>",
              self._result)
        return r

    def start(self, background: bool = True) -> "Dashboard":
        from predictionio_tpu_torch.obs import fleet
        srv = HttpServer(self.router, self.config.ip, self.config.port)
        self.server = srv

        def _bound(s):
            # post-bind / pre-serve (the foreground path never returns)
            self.config.port = s.port
            self._fleet_id = fleet.register_member(
                "dashboard", port=s.port, host=self.config.ip)

        srv.on_bound = _bound
        srv.start(background=background)
        return self

    def stop(self):
        from predictionio_tpu_torch.obs import fleet
        fleet.deregister_member(getattr(self, "_fleet_id", None))
        self._fleet_id = None
        if self.server:
            self.server.stop()
            self.server = None
