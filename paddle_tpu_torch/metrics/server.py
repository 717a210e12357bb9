"""Stdlib-only metrics endpoint: ``GET /metrics`` on a background thread.

The scrape-able half of the registry — a ``ThreadingHTTPServer`` serving

- ``/metrics``       Prometheus text exposition (0.0.4)
- ``/metrics.json``  ``registry.snapshot()`` as JSON
- ``/healthz``       liveness probe: 200 ``ok`` — or, with a
  ``health_cb`` wired (e.g. ``ServingEngine.health`` or
  ``Router.health``), 503 while the callback reports degraded (the
  watchdog's state machine), so a load balancer
  drains a wedged engine. ``/healthz?engine=<id>`` forwards the engine
  id to a callback that accepts an ``engine=`` keyword (``Router.health``
  does: per-engine probing behind one fleet endpoint); callbacks without
  the keyword ignore the query.

No framework dependency: the serving stack must stay importable and
operable on a bare jax+numpy container, so this is ``http.server``, not
an ASGI app. One scrape is one registry walk (no per-sample locking
between scrapes); ``port=0`` picks a free port (``server.port`` reports
it), which is what the tests use.
"""
from __future__ import annotations

import inspect
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs

from .registry import MetricsRegistry, get_registry

__all__ = ["MetricsServer"]

_PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    """Background-thread scrape endpoint over one registry (defaults to
    the process-wide one). ``start()`` returns self so
    ``MetricsServer(port=9100).start()`` is one line; ``stop()`` joins
    the thread. Also usable as a context manager."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 health_cb=None):
        self.registry = registry if registry is not None else get_registry()
        self.host = host
        self._requested_port = int(port)
        # health_cb() drives /healthz: return truthy/falsy, or a dict
        # whose "status" key must equal "ok" (a dict is echoed as the
        # JSON body — ServingEngine.health fits directly). None keeps
        # the bare liveness behavior (always 200 ok).
        self.health_cb = health_cb
        # probe-cache lock: /healthz scrapes run on ThreadingHTTPServer
        # worker threads, so the (callback, takes_engine) cache write
        # below must not race a concurrent probe's
        self._probe_lock = threading.Lock()
        self._cb_engine_probe = None  # (callback, takes_engine) cache
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def _cb_takes_engine(self) -> bool:
        """True when health_cb can accept an ``engine=`` keyword (an
        explicit parameter or **kwargs) — probed once per CALLBACK, so
        reassigning the public ``health_cb`` attribute (engine.health ->
        router.health on a fleet upgrade) re-probes instead of serving a
        stale capability decision."""
        cached = self._cb_engine_probe
        if cached is not None and cached[0] is self.health_cb:
            return cached[1]
        ok = False
        try:
            for p in inspect.signature(self.health_cb).parameters.values():
                if (p.name == "engine"
                        or p.kind is inspect.Parameter.VAR_KEYWORD):
                    ok = True
                    break
        except (TypeError, ValueError):  # builtins/partials: be safe
            ok = False
        with self._probe_lock:
            self._cb_engine_probe = (self.health_cb, ok)
        return ok

    def _health(self, query: str = ""):
        """(http_status, content_type, body) for /healthz. ``query`` is the
        raw query string; an ``engine=<id>`` param is forwarded to a
        callback that declares the keyword (Router.health) and ignored
        otherwise (ServingEngine.health)."""
        if self.health_cb is None:
            return 200, "text/plain", b"ok\n"
        engine = parse_qs(query).get("engine", [None])[0] if query else None
        try:
            if engine is not None and self._cb_takes_engine():
                h = self.health_cb(engine=engine)
            else:
                h = self.health_cb()
        except Exception as e:  # a broken probe reads as unhealthy
            return 503, "text/plain", f"health_cb error: {e!r}\n".encode()
        if isinstance(h, dict):
            ok = h.get("status", "ok") == "ok"
            return (200 if ok else 503, "application/json",
                    (json.dumps(h) + "\n").encode())
        return ((200, "text/plain", b"ok\n") if h
                else (503, "text/plain", b"degraded\n"))

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "MetricsServer":
        if self._httpd is not None:
            return self
        registry = self.registry
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                path, _, query = self.path.partition("?")
                code = 200
                if path == "/metrics":
                    body = registry.expose_prometheus().encode()
                    ctype = _PROM_CONTENT_TYPE
                elif path == "/metrics.json":
                    body = json.dumps(registry.snapshot()).encode()
                    ctype = "application/json"
                elif path == "/healthz":
                    code, ctype, body = server._health(query)
                else:
                    self.send_error(404)
                    return
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes must not spam stderr
                pass

        self._httpd = ThreadingHTTPServer((self.host, self._requested_port),
                                          Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="paddle-tpu-metrics",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._httpd = None
        self._thread = None

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- introspection ----------------------------------------------------
    @property
    def port(self) -> int:
        if self._httpd is None:
            return self._requested_port
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"
