"""Admin REST API (experimental, parity with the reference's AdminAPI).

The port's copy of `predictionio_tpu/tools/admin.py`, over the port's
`tools/app_commands.py`.

Rebuilds the reference's admin server
(reference: tools/src/main/scala/io/prediction/tools/admin/AdminAPI.scala:66-105
and CommandClient.scala:58+): app management over REST —
  GET    /                    -> status
  GET    /cmd/app             -> list apps
  POST   /cmd/app             -> create app {name, id?, description?}
  DELETE /cmd/app/<name>      -> delete app
  DELETE /cmd/app/<name>/data -> delete app data
"""

from __future__ import annotations

from dataclasses import dataclass

from predictionio_tpu_torch.tools import app_commands as ac
from predictionio_tpu_torch.utils.http import (HttpServer, Request, Response,
                                               Router)


@dataclass
class AdminServerConfig:
    ip: str = "127.0.0.1"
    port: int = 7071


class AdminServer:
    def __init__(self, config: AdminServerConfig = AdminServerConfig()):
        self.config = config
        self.router = self._build_router()
        self.server = None

    def _status(self, req: Request) -> Response:
        return Response(200, {"status": "alive"})

    def _list_apps(self, req: Request) -> Response:
        apps = [{"name": d.app.name, "id": d.app.id,
                 "description": d.app.description,
                 "accessKeys": [k.key for k in d.access_keys],
                 "channels": [c.name for c in d.channels]}
                for d in ac.app_list()]
        return Response(200, {"status": 1, "apps": apps})

    def _new_app(self, req: Request) -> Response:
        d = req.json() or {}
        if "name" not in d:
            return Response(400, {"message": "isEmpty appName"})
        try:
            desc = ac.app_new(d["name"], app_id=int(d.get("id") or 0),
                              description=d.get("description"))
            return Response(200, {
                "status": 1, "message": "App created successfully.",
                "id": desc.app.id, "name": desc.app.name,
                "key": desc.access_keys[0].key})
        except ac.AppCommandError as e:
            return Response(409, {"message": str(e)})

    def _delete_app(self, req: Request) -> Response:
        try:
            ac.app_delete(req.path_args[0])
            return Response(200, {
                "status": 1,
                "message": f"App {req.path_args[0]} was deleted."})
        except ac.AppCommandError as e:
            return Response(404, {"message": str(e)})

    def _delete_data(self, req: Request) -> Response:
        try:
            ac.app_data_delete(req.path_args[0])
            return Response(200, {
                "status": 1,
                "message": f"Data of app {req.path_args[0]} was deleted."})
        except ac.AppCommandError as e:
            return Response(404, {"message": str(e)})

    def _build_router(self) -> Router:
        r = Router()
        r.add("GET", "/", self._status)
        r.add("GET", "/cmd/app", self._list_apps)
        r.add("POST", "/cmd/app", self._new_app)
        r.add("DELETE", "/cmd/app/<name>", self._delete_app)
        r.add("DELETE", "/cmd/app/<name>/data", self._delete_data)
        return r

    def start(self, background: bool = True) -> "AdminServer":
        srv = HttpServer(self.router, self.config.ip, self.config.port)
        self.server = srv
        srv.start(background=background)
        # read the port from the local: a concurrent stop() (signal
        # handler) may null self.server the instant serve_forever returns
        self.config.port = srv.port
        return self

    def stop(self):
        if self.server:
            self.server.stop()
            self.server = None
