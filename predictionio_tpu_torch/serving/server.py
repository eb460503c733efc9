"""A small engine server: `POST /queries.json`, `GET /`, `/reload` and
`/stop`.

The port's counterpart of the query and deploy paths of
`predictionio_tpu/serving/server.py`. Deploy (`EngineServer.load`, what
`pio deploy` calls): the engine instance the config names, or the latest
COMPLETED one of its engine id/version/variant -> its engine factory ->
the model blob -> the engine params from the instance's JSON -> the
engine's `prepare_deploy`, which puts each model on its algorithm's
device before the first query. `/reload` restores the latest instance
again and swaps it in (a hot swap: a query answers from the old or the
new models, never a mix); `/stop` shuts the server down. A server may
also be handed a trained engine (`TrainResult`) directly.

A query: decode the JSON body with the first algorithm's query class ->
supplement -> predict with every algorithm -> serve -> `to_dict`. A
malformed body (bad JSON, not an object, a missing or mistyped field)
answers 400 with a message, as the reference does. Built on the standard
library's `ThreadingHTTPServer`; the micro-batcher, result cache,
telemetry and the other routes are later slices.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from predictionio_tpu_torch.core.engine import (Engine, EngineParams,
                                                TrainResult)
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.models import get_engine_factory

logger = logging.getLogger(__name__)


@dataclass
class ServerConfig:
    """(CreateServer.scala:80-98)"""
    ip: str = "127.0.0.1"
    port: int = 8000          # 0 = any free port; `start` records it
    engine_instance_id: Optional[str] = None
    engine_id: Optional[str] = None
    engine_version: Optional[str] = None
    engine_variant: str = "engine.json"


class EngineServer:
    """Serves an engine over HTTP: a `TrainResult` handed in, or the
    engine instance `load()` restores from storage."""

    def __init__(self, config: ServerConfig, engine: Optional[Engine] = None,
                 engine_params: Optional[EngineParams] = None,
                 trained: Optional[TrainResult] = None):
        self.config = config
        self.engine = engine
        self.engine_params = engine_params
        self.engine_instance = None
        self.algorithms: List = []
        self.models: List = []
        self.serving = None
        if trained is not None:
            self.algorithms = trained.algorithms
            self.models = trained.models
            self.serving = engine.make_serving(engine_params)
        self.request_count = 0
        self.serving_seconds = 0.0
        self._lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- model loading (createServerActorWithEngine, :206-265) -------------
    def load_engine_instance(self):
        instances = Storage.get_meta_data_engine_instances()
        cfg = self.config
        if cfg.engine_instance_id:
            instance = instances.get(cfg.engine_instance_id)
            if instance is None:
                raise ValueError(
                    f"Invalid engine instance id {cfg.engine_instance_id}")
            return instance
        instance = instances.get_latest_completed(
            cfg.engine_id or "default", cfg.engine_version or "0",
            cfg.engine_variant)
        if instance is None:
            raise ValueError(
                f"No valid engine instance found for engine {cfg.engine_id} "
                f"{cfg.engine_version} {cfg.engine_variant}. Try running "
                "`pio train` first.")
        return instance

    def load(self) -> "EngineServer":
        """Restore the engine instance and swap it in (the deploy path).
        The models are restored and placed on their devices before the
        swap, so a query in flight keeps answering from the old ones."""
        instance = self.load_engine_instance()
        engine = self.engine
        if engine is None:
            engine = get_engine_factory(instance.engine_factory).apply()
        model = Storage.get_model_data_models().get(instance.id)
        if model is None:
            raise ValueError(
                f"No model found for engine instance {instance.id}")
        persisted = engine.deserialize_models(model.models, instance.id)
        engine_params = self.engine_params
        if engine_params is None:
            engine_params = engine.json_to_engine_params({
                "datasource": json.loads(instance.data_source_params
                                         or "{}"),
                "preparator": json.loads(instance.preparator_params or "{}"),
                "algorithms": json.loads(instance.algorithms_params or "[]"),
                "serving": json.loads(instance.serving_params or "{}"),
            })
        result = engine.prepare_deploy(engine_params, persisted, instance.id)
        serving = engine.make_serving(engine_params)
        with self._lock:
            self.engine = engine
            self.engine_params = engine_params
            self.engine_instance = instance
            self.algorithms = result.algorithms
            self.models = result.models
            self.serving = serving
        logger.info("Engine instance %s loaded (%d algorithm(s))",
                    instance.id, len(result.algorithms))
        return self

    def reload(self) -> None:
        """Hot-swap to the latest COMPLETED instance of the loaded one's
        engine (:337-358); an instance id named in the config stays."""
        cfg = self.config
        if cfg.engine_instance_id is None and self.engine_instance:
            cfg.engine_id = self.engine_instance.engine_id
            cfg.engine_version = self.engine_instance.engine_version
            cfg.engine_variant = self.engine_instance.engine_variant
        self.engine_params = None  # re-derive from the new instance
        self.load()

    # -- queries -----------------------------------------------------------
    def handle_query(self, query_dict: dict) -> dict:
        t0 = time.perf_counter()
        if not isinstance(query_dict, dict):
            raise ValueError("query must be a JSON object")
        with self._lock:
            algorithms, models, serving = (self.algorithms, self.models,
                                           self.serving)
        if not algorithms:
            raise RuntimeError("no engine is loaded")
        qc = algorithms[0].query_class
        query = qc.from_dict(query_dict) if qc is not None else query_dict
        supplemented = serving.supplement(query)
        predictions: List = [algo.predict(model, supplemented)
                             for algo, model in zip(algorithms, models)]
        prediction = serving.serve(query, predictions)
        out = (prediction.to_dict() if hasattr(prediction, "to_dict")
               else prediction)
        if not isinstance(out, dict):
            out = {"result": out}
        with self._lock:
            self.request_count += 1
            self.serving_seconds += time.perf_counter() - t0
        return out

    def status(self) -> dict:
        with self._lock:
            n, secs = self.request_count, self.serving_seconds
            inst = self.engine_instance
            algorithms = self.algorithms
        return {"status": "alive",
                "engineInstanceId": inst.id if inst else None,
                "engineFactory": inst.engine_factory if inst else None,
                "algorithms": [type(a).__name__ for a in algorithms],
                "requests": n,
                "avgServingSec": secs / n if n else 0.0}

    def _handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _send(self, status: int, body: dict):
                data = json.dumps(body).encode("utf-8")
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _control(self, path: str) -> bool:
                """/reload and /stop, on GET or POST (:1433-1441)."""
                if path == "/reload":
                    try:
                        server.reload()
                    except Exception as e:   # keep serving the old models
                        logger.exception("reload failed")
                        self._send(500, {"message": str(e)})
                    else:
                        self._send(200, {"message": "Reloaded"})
                    return True
                if path == "/stop":
                    self._send(200, {"message": "Shutting down."})
                    threading.Thread(target=server.stop,
                                     daemon=True).start()
                    return True
                return False

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    self._send(200, server.status())
                elif not self._control(path):
                    self._send(404, {"message": f"no route {self.path}"})

            def do_POST(self):
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length) if length else b""
                path = self.path.split("?")[0]
                if self._control(path):
                    return
                if path != "/queries.json":
                    self._send(404, {"message": f"no route {self.path}"})
                    return
                try:
                    out = server.handle_query(json.loads(raw or b"null"))
                except KeyError as e:
                    self._send(400, {"message": f"missing field {e}"})
                except (ValueError, TypeError) as e:
                    # json.JSONDecodeError is a ValueError
                    self._send(400, {"message": str(e)})
                except Exception as e:   # keep serving; report the fault
                    logger.exception("query failed")
                    self._send(500, {"message": str(e)})
                else:
                    self._send(200, out)

            def log_message(self, fmt, *args):
                logger.debug("%s " + fmt, self.address_string(), *args)

        return Handler

    def start(self, background: bool = True) -> "EngineServer":
        self._httpd = ThreadingHTTPServer((self.config.ip, self.config.port),
                                          self._handler())
        self._httpd.daemon_threads = True
        self.config.port = self._httpd.server_address[1]
        logger.info("Engine server started on %s:%d", self.config.ip,
                    self.config.port)
        if background:
            self._thread = threading.Thread(target=self._httpd.serve_forever,
                                            name="engine-server",
                                            daemon=True)
            self._thread.start()
        else:
            self._httpd.serve_forever()
        return self

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        thread, self._thread = self._thread, None
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=10)
