"""A small threaded HTTP server and router on the standard library.

The port's copy of `predictionio_tpu/utils/http.py` (the role of the
reference's Spray/Akka HTTP layer, EventServer.scala): a
`ThreadingHTTPServer` dispatching to route handlers, request-level
concurrency from its threads. Both the event server and the engine
server (`serving/server.py`) serve through it.

A handler's `ValueError` answers 400 `{"message": str(e)}`, a `KeyError`
400 `missing field ...`, an exception with an `http_status` attribute
that status (its `retry_after_s` becomes `Retry-After`), anything else
500, as the reference's; a client that accepts gzip gets a body of 1 KB
or more gzipped. Kept differences:
the listen backlog is 128 (the standard library's is 5), as the port's
engine server's, so a burst of concurrent clients is not refused at
connect; `bind()` resolves port 0 before `start()` serves, so a caller
can print the bound port first.
"""

from __future__ import annotations

import gzip
import json
import logging
import re
import threading
import time
import urllib.parse
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)


class Headers(dict):
    """Case-insensitive header lookup (RFC 9110 §5.1): keys are stored
    lower-cased and `get` folds its key."""

    def __init__(self, items=()):
        super().__init__((k.lower(), v) for k, v in items)

    def get(self, key, default=None):
        return super().get(key.lower(), default)


@dataclass
class Request:
    method: str
    path: str
    params: Dict[str, str]
    headers: Dict[str, str]
    body: bytes
    path_args: Tuple[str, ...] = ()

    def json(self) -> Any:
        if not self.body:
            return None
        return json.loads(self.body.decode("utf-8"))

    def form(self) -> Dict[str, str]:
        parsed = urllib.parse.parse_qs(self.body.decode("utf-8"),
                                       keep_blank_values=True)
        return {k: v[0] for k, v in parsed.items()}


@dataclass
class Response:
    status: int = 200
    body: Any = None           # JSON-able; bytes and str sent as they are
    headers: Optional[Dict[str, str]] = None   # extra response headers
    content_type: str = "application/json; charset=UTF-8"

    def payload(self) -> bytes:
        if self.body is None:
            return b""
        if isinstance(self.body, (bytes, bytearray)):
            return bytes(self.body)
        if isinstance(self.body, str):
            return self.body.encode("utf-8")
        return json.dumps(self.body).encode("utf-8")


Handler = Callable[[Request], Response]


def fetch_json(url: str, timeout: float = 3.0) -> Any:
    """GET a JSON endpoint, mapping any failure to {"error": str}: an
    unreachable server is a row in a status report, not an exception
    (`status --telemetry`, `incidents list --url`)."""
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return json.loads(resp.read())
    except Exception as e:
        return {"error": str(e)}


def fetch_text(url: str, timeout: float = 3.0) -> Optional[str]:
    """GET a text endpoint (a /metrics scrape); None on any failure or a
    status other than 200, which the fleet federation reports as a down
    member (`obs/fleet.py`)."""
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            if resp.status != 200:
                return None
            return resp.read().decode("utf-8", "replace")
    except Exception:
        return None


def _accepts_gzip(value: str) -> bool:
    """True when an Accept-Encoding value allows gzip (a token match:
    `gzip;q=0` refuses it)."""
    for part in value.split(","):
        bits = part.strip().split(";")
        if bits[0].strip().lower() != "gzip":
            continue
        for b in bits[1:]:
            b = b.strip().lower()
            if b.startswith("q="):
                try:
                    if float(b[2:]) == 0.0:
                        return False
                except ValueError:
                    pass
        return True
    return False


class Router:
    """Method + path-regex routing. Patterns use <name> wildcards that
    match one path segment and arrive as positional `path_args`."""

    def __init__(self):
        self.routes: List[Tuple[str, re.Pattern, Handler]] = []

    def add(self, method: str, pattern: str, handler: Handler):
        regex = re.compile(
            "^" + re.sub(r"<[^>]+>", r"([^/]+)", pattern) + "$")
        self.routes.append((method.upper(), regex, handler))

    def dispatch(self, req: Request) -> Response:
        matched_path = False
        for method, regex, handler in self.routes:
            m = regex.match(req.path)
            if m:
                matched_path = True
                if method == req.method:
                    req.path_args = m.groups()
                    return handler(req)
        if matched_path:
            return Response(405, {"message": "method not allowed"})
        return Response(404, {"message": "not found"})


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    request_queue_size = 128


def _response_of(router: Router, req: Request) -> Response:
    try:
        return router.dispatch(req)
    except ValueError as e:
        return Response(400, {"message": str(e)})
    except KeyError as e:
        return Response(400, {"message": f"missing field {e}"})
    except Exception as e:   # keep serving; report the fault
        status = getattr(e, "http_status", None)
        if not status:
            logger.exception("handler error")
            return Response(500, {"message": str(e)})
        logger.error("handler error (%d): %s", status, e)
        retry = getattr(e, "retry_after_s", None)
        return Response(int(status), {"message": str(e)},
                        None if retry is None else
                        {"Retry-After": str(max(1, int(float(retry) + 0.5)))})


class HttpServer:
    def __init__(self, router: Router, host: str = "0.0.0.0",
                 port: int = 8000, name: str = "http-server"):
        self.router = router
        self.host = host
        self.port = port
        self.name = name
        self._httpd: Optional[_HTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # called with this server once the socket is bound and before
        # it serves: the one window where a foreground server can
        # publish its port (the fleet member record). Must not raise.
        self.on_bound: Optional[Callable[["HttpServer"], None]] = None

    def _make_handler(self):
        router = self.router

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # one buffered write, no Nagle: a header/body write split
            # would otherwise wait on delayed ACKs
            wbufsize = 1 << 16
            disable_nagle_algorithm = True

            def _handle(self):
                parsed = urllib.parse.urlsplit(self.path)
                # keep_blank_values: `targetEntityType=` (empty) means
                # "target absent" to the event API
                params = {k: v[0] for k, v in urllib.parse.parse_qs(
                    parsed.query, keep_blank_values=True).items()}
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                resp = _response_of(router, Request(
                    method=self.command, path=parsed.path, params=params,
                    headers=Headers(self.headers.items()), body=body))
                payload = resp.payload()
                self.send_response(resp.status)
                self.send_header("Content-Type", resp.content_type)
                for k, v in (resp.headers or {}).items():
                    self.send_header(k, v)
                accept = self.headers.get("Accept-Encoding") or ""
                if _accepts_gzip(accept) and len(payload) >= 1024:
                    payload = gzip.compress(payload, compresslevel=1)
                    self.send_header("Content-Encoding", "gzip")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            do_GET = do_POST = do_DELETE = do_PUT = _handle

            def log_message(self, fmt, *args):
                logger.debug("%s %s", self.address_string(), fmt % args)

        return _Handler

    def bind(self, bind_retries: int = 3,
             retry_delay_s: float = 1.0) -> "HttpServer":
        """Bind the listening socket (retrying, as the reference's
        MasterActor, CreateServer.scala:363-373) and record the bound
        port (port 0 = any free port)."""
        for attempt in range(bind_retries):
            try:
                self._httpd = _HTTPServer((self.host, self.port),
                                          self._make_handler())
                break
            except OSError as e:
                if attempt + 1 == bind_retries:
                    raise
                logger.warning("bind %s:%d failed (%s), retry %d/%d",
                               self.host, self.port, e, attempt + 1,
                               bind_retries)
                time.sleep(retry_delay_s)
        self.port = self._httpd.server_address[1]
        return self

    def start(self, background: bool = True) -> "HttpServer":
        """Serve, binding first unless `bind` has; `background=False`
        serves on the calling thread until `stop()`."""
        if self._httpd is None:
            self.bind()
        httpd = self._httpd
        if self.on_bound is not None:
            try:
                self.on_bound(self)
            except Exception:
                logger.exception("on_bound hook failed")
        if background:
            self._thread = threading.Thread(target=httpd.serve_forever,
                                            name=self.name, daemon=True)
            self._thread.start()
        else:
            httpd.serve_forever()
        return self

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        thread, self._thread = self._thread, None
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=10)
