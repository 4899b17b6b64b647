"""Live observability endpoint — the stack's first real network surface.

Every obs artifact so far is pull-by-function-call: ``prometheus_text()``,
``TimeSeriesStore.export()``, ``chrome_trace()``, ``DecisionLog.records``.
:class:`ObsServer` puts them behind one stdlib
:class:`~http.server.ThreadingHTTPServer` on a real TCP socket, so a
running fleet can be inspected with ``curl`` while it serves — and so the
repo grows its first listening socket on the path toward the ROADMAP's
multi-process socket Transport.

Endpoints (GET, all read-only):

=====================  ====================================================
``/metrics``           Prometheus text exposition (``prometheus_text()``)
``/timeseries``        :meth:`TimeSeriesStore.export` JSON
``/alerts``            :meth:`SLOMonitor.alerts_json` JSON
``/traces``            Chrome ``chrome://tracing`` JSON flush
``/debug/decisions``   DecisionLog records as JSON; ``?kind=`` filters,
                       ``?n=`` keeps only the most recent n
=====================  ====================================================

Handlers read shared in-process state without locking: every exported
structure is either rebuilt per request from bounded deques (append-only
from the pump thread, safe to iterate-copy) or plain text rendered from
counters — the same one-writer/many-reader discipline the tracer already
relies on.  Serving is threaded so a slow scraper never blocks the pump.

Construction never binds; :meth:`start` does (``port=0`` asks the OS for
a free port — the test/CI default), :meth:`stop` tears down.  Missing
collaborators 404 their endpoint rather than failing construction, so a
minimal server (registry only) is one line.

This is the PyTorch port's copy of ``repro.obs.server``: host-side
Python and numpy, the same logic; only the imports differ.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from .replay import json_default, record_to_json


class ObsServer:
    """Serve a registry / time-series store / SLO monitor / tracer /
    decision log over HTTP.  All collaborators optional."""

    def __init__(self, *, registry=None, timeseries=None, slo=None,
                 tracer=None, decisions=None,
                 host: str = "127.0.0.1", port: int = 0):
        self.registry = registry
        self.timeseries = timeseries
        self.slo = slo
        self.tracer = tracer
        self.decisions = decisions
        self.host = host
        self.port = port             # requested; real port set by start()
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ObsServer":
        """Bind, start the serving thread, and record the real port.
        Returns self so ``server = ObsServer(...).start()`` reads well."""
        if self._httpd is not None:
            raise RuntimeError("already started")
        obs = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # keep test output quiet
                pass

            def do_GET(self):
                obs._handle(self)

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-server", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._httpd = None
        self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def __enter__(self) -> "ObsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- dispatch ----------------------------------------------------------
    def _handle(self, h: BaseHTTPRequestHandler) -> None:
        parsed = urlparse(h.path)
        path, query = parsed.path.rstrip("/") or "/", parse_qs(parsed.query)
        if path == "/metrics" and self.registry is not None:
            self._send(h, self.registry.prometheus_text(),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/timeseries" and self.timeseries is not None:
            self._send_json(h, self.timeseries.export())
        elif path == "/alerts" and self.slo is not None:
            self._send_json(h, self.slo.alerts_json())
        elif path == "/traces" and self.tracer is not None:
            self._send_json(h, self.tracer.chrome_trace())
        elif path == "/debug/decisions" and self.decisions is not None:
            self._send_json(h, self._decisions_body(query))
        elif path == "/":
            self._send_json(h, {"endpoints": self._endpoints()})
        else:
            body = json.dumps({"error": f"no endpoint {path!r}",
                               "endpoints": self._endpoints()}).encode()
            h.send_response(404)
            h.send_header("Content-Type", "application/json")
            h.send_header("Content-Length", str(len(body)))
            h.end_headers()
            h.wfile.write(body)

    def _endpoints(self) -> list[str]:
        out = []
        if self.registry is not None:
            out.append("/metrics")
        if self.timeseries is not None:
            out.append("/timeseries")
        if self.slo is not None:
            out.append("/alerts")
        if self.tracer is not None:
            out.append("/traces")
        if self.decisions is not None:
            out.append("/debug/decisions")
        return out

    def _decisions_body(self, query: dict) -> dict:
        recs = list(self.decisions.records)
        kinds = query.get("kind")
        if kinds:
            recs = [r for r in recs if r.kind in kinds]
        n = query.get("n")
        if n:
            recs = recs[-int(n[0]):]
        return {"count": len(recs),
                "records": [record_to_json(r) for r in recs]}

    # -- response helpers --------------------------------------------------
    @staticmethod
    def _send(h: BaseHTTPRequestHandler, text: str, ctype: str) -> None:
        body = text.encode()
        h.send_response(200)
        h.send_header("Content-Type", ctype)
        h.send_header("Content-Length", str(len(body)))
        h.end_headers()
        h.wfile.write(body)

    @classmethod
    def _send_json(cls, h: BaseHTTPRequestHandler, obj) -> None:
        cls._send(h, json.dumps(obj, sort_keys=True, default=json_default),
                  "application/json")
