"""Stdlib-only HTTP exporter: Prometheus `/metrics` + JSON `/healthz`.

Counterpart of mxnet_tpu/telemetry/exporter.py:

    from mxnet_tpu_torch import telemetry
    srv = telemetry.start_server(9100)      # or MXNET_TELEMETRY_PORT=9100
    ...
    srv.close()

One ThreadingHTTPServer on a daemon thread; every GET snapshots the
registry at request time (scrapes see live values — no push, no device
syncs, no background sampling loop). Port 0 binds an ephemeral port
(`srv.port` has the real one; the tests scrape themselves that way).
`start_server` is idempotent per process: a second call returns the
running server.
"""
from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .registry import get_registry

__all__ = ["TelemetryServer", "start_server", "stop_server", "get_server"]

CONTENT_TYPE_METRICS = "text/plain; version=0.0.4; charset=utf-8"


class _Handler(BaseHTTPRequestHandler):
    server_version = "mxnet-tpu-torch-telemetry/1.0"

    def do_GET(self):                               # noqa: N802 (stdlib api)
        path = self.path.split("?", 1)[0]
        if path in ("/metrics", "/"):
            try:
                body = get_registry().render_prometheus().encode()
            except Exception as e:   # a broken hook must not 500 forever
                self._reply(500, "text/plain",
                            f"render error: {type(e).__name__}: {e}"
                            .encode())
                return
            self._reply(200, CONTENT_TYPE_METRICS, body)
        elif path == "/healthz":
            reg = get_registry()
            body = json.dumps({
                "status": "ok",
                "pid": os.getpid(),
                "uptime_s": round(time.monotonic()
                                  - self.server._t0, 3),
                "subsystems": [],          # no profiler hooks yet
                "metrics": len(reg.own_metrics()),
            }).encode()
            self._reply(200, "application/json", body)
        else:
            self._reply(404, "text/plain", b"not found: try /metrics "
                                           b"or /healthz")

    def _reply(self, code, ctype, body):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):
        """Scrapes are high-frequency background traffic — keep them off
        stderr (opt back in with MXNET_TELEMETRY_HTTP_LOG=1)."""
        if os.environ.get("MXNET_TELEMETRY_HTTP_LOG"):
            BaseHTTPRequestHandler.log_message(self, fmt, *args)


class TelemetryServer:
    """The exporter: ThreadingHTTPServer + serve_forever daemon thread."""

    def __init__(self, port=0, host="0.0.0.0"):
        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self._httpd._t0 = time.monotonic()
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.25},
            name="telemetry-exporter", daemon=True)
        self._thread.start()

    @property
    def url(self):
        host = "127.0.0.1" if self.host in ("0.0.0.0", "::") else self.host
        return f"http://{host}:{self.port}"

    def close(self):
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:               # pragma: no cover
            pass
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


_lock = threading.Lock()
_server = [None]


def start_server(port=None, host="0.0.0.0"):
    """Start (or return) the process-wide exporter. `port=None` reads
    MXNET_TELEMETRY_PORT; 0 binds an ephemeral port. Returns the
    TelemetryServer (``.port``, ``.url``, ``.close()``)."""
    with _lock:
        if _server[0] is not None:
            return _server[0]
        if port is None:
            from .. import config
            raw = config.get("MXNET_TELEMETRY_PORT")
            port = int(raw) if raw not in (None, "") else 0
        _server[0] = TelemetryServer(port=port, host=host)
        return _server[0]


def get_server():
    """The running exporter, or None."""
    return _server[0]


def stop_server():
    with _lock:
        srv, _server[0] = _server[0], None
    if srv is not None:
        srv.close()
