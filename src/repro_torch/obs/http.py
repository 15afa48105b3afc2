"""Stdlib HTTP exposition: /metrics, /healthz, /trace, /attrib, /roofline.

`ObsServer` runs a ``ThreadingHTTPServer`` on a daemon thread and serves
the observability plane of one serving process:

* ``GET /metrics``  — the engine's ``Metrics.render()`` text page
  (Prometheus-style ``name value`` lines).
* ``GET /healthz``  — liveness probe, always ``200 ok`` while the
  thread is up (a k8s-style readiness hook point).
* ``GET /trace``    — the last-N finished spans as JSON (``?n=500``
  caps the tail; default 256, clamped to the ring size; non-integer or
  negative ``n`` is a ``400``).
* ``GET /attrib``   — the live per-stage Amdahl report folded from the
  tracer's ring buffer (`repro_torch.obs.attrib`).
* ``GET /roofline`` — the per-kernel roofline table from an attached
  `RooflineManager` (`repro_torch.obs.roofline`): analytic ops and
  bytes, the DC kernels' measured device time, intensity, %-of-roof
  per ``(backend, bucket_cap)`` site.  ``?measure=0`` skips the lazy
  profiled kernel run.  That run, once per site (its result is cached),
  pauses serving: the engine holds its next flush until the profiler
  has the card's measured kernels alone (seconds on a card).

Construct with ``port=0`` for an ephemeral port (tests); ``.port``
reports the bound port either way.  ``close()`` shuts the thread down.
Copied from `repro.obs.http`.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from .attrib import build_ledger
from .trace import Tracer


class ObsServer:
    """Daemon-thread HTTP endpoint over a `Metrics` registry + `Tracer`."""

    def __init__(self, *, metrics=None, tracer: Tracer | None = None,
                 roofline=None, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        obs = self

        class Handler(BaseHTTPRequestHandler):
            """Routes the five GET endpoints over the enclosing ObsServer."""

            def log_message(self, *args):
                """Silence the default per-request stderr logging."""

            def _send(self, code: int, body: str,
                      ctype: str = "text/plain; charset=utf-8") -> None:
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
                """Serve /healthz, /metrics, /trace, /attrib (404 else)."""
                url = urlparse(self.path)
                try:
                    if url.path == "/healthz":
                        self._send(200, "ok\n")
                    elif url.path == "/metrics":
                        if obs.metrics is None:
                            self._send(404, "no metrics registry attached\n")
                        else:
                            self._send(200, obs.metrics.render())
                    elif url.path == "/trace":
                        if obs.tracer is None:
                            self._send(404, "no tracer attached\n")
                        else:
                            q = parse_qs(url.query, keep_blank_values=True)
                            raw = q.get("n", ["256"])[0]
                            try:
                                n = int(raw)
                            except ValueError:
                                n = -1
                            if n < 0:
                                self._send(400, f"bad n={raw!r}: must be a "
                                                "non-negative integer\n")
                            else:
                                n = min(n, obs.tracer.log.max_spans)
                                self._send(
                                    200,
                                    json.dumps(
                                        {"spans": obs.tracer.log.last(n),
                                         "dropped": obs.tracer.log.dropped}),
                                    "application/json")
                    elif url.path == "/attrib":
                        if obs.tracer is None:
                            self._send(404, "no tracer attached\n")
                        else:
                            rep = build_ledger(obs.tracer.log).report()
                            self._send(200, json.dumps(rep.to_dict()),
                                       "application/json")
                    elif url.path == "/roofline":
                        if obs.roofline is None:
                            self._send(404, "no roofline manager attached\n")
                        else:
                            q = parse_qs(url.query)
                            measure = q.get("measure", ["1"])[0] not in (
                                "0", "false", "no")
                            self._send(
                                200,
                                json.dumps(
                                    obs.roofline.report(measure=measure)),
                                "application/json")
                    else:
                        self._send(404, "unknown path; try /metrics, "
                                        "/healthz, /trace, /attrib, "
                                        "/roofline\n")
                except BrokenPipeError:  # client went away mid-write
                    pass

        self.metrics = metrics
        self.tracer = tracer
        self.roofline = roofline
        self._srv = ThreadingHTTPServer((host, port), Handler)
        self._srv.daemon_threads = True
        self.host, self.port = self._srv.server_address[:2]
        self._thread = threading.Thread(
            target=self._srv.serve_forever, name="obs-http", daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        """Base URL of the bound endpoint (ephemeral port resolved)."""
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        """Stop serving and join the endpoint thread (idempotent)."""
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
