"""The live exporter: a stdlib HTTP thread over the telemetry state.

The port's counterpart of ``modin_tpu/observability/watch/httpd.py``.  One
``http.server.ThreadingHTTPServer`` bound to ``127.0.0.1`` on
``MODIN_TPU_TORCH_WATCH_PORT`` (0: an ephemeral port, read back with
``watch.httpd_port()``), serving:

- ``GET /metrics``: the meter registry as Prometheus text
  (``observability/exposition.py``; ``parse_prometheus`` reads it back);
- ``GET /statusz``: a one-page status: uptime, the sampler's health, the
  mesh, the ledgers, the gate's pressure, windowed rates and quantiles off
  the rings, the tenants with their SLO burn, the fleet, the recent trips;
- ``GET /debug/queries``: the open ``query_stats()`` scopes of every thread
  as JSON, wall so far included;
- ``GET /``: an index of the above.

Every request emits ``watch.scrape``.  A handler never raises into the
socket loop and never writes to stderr; a renderer that fails answers 500
with the error's name.
"""

from __future__ import annotations

import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

_INDEX = (
    "modin_tpu_torch watch exporter\n"
    "  /metrics        Prometheus text exposition of the meter registry\n"
    "  /statusz        human-readable service status\n"
    "  /debug/queries  live query_stats scopes (JSON)\n"
)


class _WatchHandler(BaseHTTPRequestHandler):
    server_version = "modin-tpu-torch-watch"

    def log_message(self, fmt: str, *args) -> None:  # noqa: D102
        pass  # telemetry never writes to the host application's stderr

    def _respond(self, status: int, content_type: str, body: str) -> None:
        payload = body.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self) -> None:  # noqa: N802 - BaseHTTPRequestHandler's name
        try:
            from modin_tpu_torch.logging.metrics import emit_metric

            emit_metric("watch.scrape", 1)
        except Exception:
            pass
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                from modin_tpu_torch.observability import exposition, meters

                self._respond(200, "text/plain; version=0.0.4; charset=utf-8",
                              exposition.to_prometheus(meters.snapshot()))
            elif path == "/statusz":
                service = self.server.watch_service  # type: ignore[attr-defined]
                self._respond(200, "text/plain; charset=utf-8", service.statusz_text())
            elif path == "/debug/queries":
                self._respond(200, "application/json; charset=utf-8", json.dumps(_debug_queries(), sort_keys=True))
            elif path == "/":
                self._respond(200, "text/plain; charset=utf-8", _INDEX)
            else:
                self._respond(404, "text/plain; charset=utf-8", f"unknown path {path}\n")
        except BrokenPipeError:
            pass  # the scraper hung up
        except Exception as err:
            try:
                self._respond(500, "text/plain; charset=utf-8", f"renderer failed: {type(err).__name__}: {err}\n")
            except Exception:
                pass


def _debug_queries() -> dict:
    from modin_tpu_torch.observability import meters

    queries = []
    for qs in meters.live_scopes():
        entry = qs.as_dict()
        entry["wall_so_far_s"] = round(qs.elapsed_s(), 6)
        entry["open"] = not qs._closed
        queries.append(entry)
    return {"open_scopes": len(queries), "queries": queries}


class Exporter:
    """The exporter's server and its serving thread."""

    THREAD_NAME = "modin-tpu-torch-watch-httpd"

    def __init__(self, service) -> None:
        self._service = service
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> Optional[int]:
        server = self._server
        return server.server_address[1] if server is not None else None

    def start(self, port: int) -> bool:
        """Bind 127.0.0.1:port (0: ephemeral) and serve on a daemon thread.
        False (the service runs on without HTTP) when the bind fails: a
        taken port never takes queries down."""
        if self._server is not None:
            return True
        try:
            server = ThreadingHTTPServer(("127.0.0.1", max(port, 0)), _WatchHandler)
        except Exception as err:
            print(f"modin_tpu_torch watch: exporter bind failed on port {port}: {err}; "
                  "rings/SLO/tripwires keep running without HTTP", file=sys.stderr)
            return False
        server.daemon_threads = True
        server.watch_service = self._service  # type: ignore[attr-defined]
        self._server = server
        self._thread = threading.Thread(
            target=server.serve_forever, name=self.THREAD_NAME, daemon=True, kwargs={"poll_interval": 0.1},
        )
        self._thread.start()
        return True

    def stop(self, timeout: float = 5.0) -> None:
        server = self._server
        if server is None:
            return
        self._server = None
        try:
            server.shutdown()
            server.server_close()
        except Exception:
            pass
        thread = self._thread
        self._thread = None
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout)

    def is_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()
