"""Stdlib HTTP front end for the port's ModelServer.

Counterpart of ``mxnet_tpu/serving/http.py``: a ``ThreadingHTTPServer``
whose per-connection threads block on serving futures (the batcher, not
the HTTP layer, is the concurrency control). Endpoints:

* ``POST /v1/inference`` (alias ``/invocations``) — body
  ``{"instances": [sample, ...]}`` (a multi-input model takes
  ``[[in0, in1, ...], ...]``) or ``{"data": sample}``, optional
  ``"deadline_ms"``; replies ``{"predictions": [...]}``. Overload ->
  **429** with the shed payload and ``Retry-After``; malformed input ->
  400; a degraded server -> 503; a model fault -> 500. A W3C
  ``traceparent`` header is continued: the request's spans join the
  caller's trace, and the reply carries the context back.
* ``GET /metrics`` — Prometheus text of :mod:`mxnet_tpu_torch.metrics`.
* ``GET /healthz`` (alias ``/readyz``) — readiness: 200 while the server
  should take new traffic, 503 ``draining`` or ``degraded``.
* ``GET /livez`` — liveness: 200 while the process answers, draining or
  degraded included.
* ``GET /v1/traces`` — the span ring as Chrome/Perfetto trace events.
* ``GET /v1/model`` — the server's ``describe()``.

``POST /v1/generate`` answers 404, as the JAX package does when it hosts
no generation server: the generation engine is ROADMAP Queue A 5, and
``make_http_server`` refuses a ``generation_server``.
"""
from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, List, Optional, Tuple

import numpy as _np

from .. import metrics as _metrics
from .. import tracing as _tracing
from ..base import MXNetError
from .batching import OverloadError
from .server import DegradedError, ModelServer

__all__ = ["make_http_server"]

_MAX_BODY = 64 * 1024 * 1024


def _decode_samples(server: ModelServer, payload: Any
                    ) -> Tuple[List[Tuple[_np.ndarray, ...]],
                               Optional[float]]:
    if not isinstance(payload, dict):
        raise ValueError("body must be a JSON object")
    deadline_ms = payload.get("deadline_ms")
    if deadline_ms is not None and not isinstance(deadline_ms,
                                                  (int, float)):
        raise ValueError("deadline_ms must be a number")
    if "instances" in payload:
        raw = payload["instances"]
        if not isinstance(raw, list) or not raw:
            raise ValueError("'instances' must be a non-empty list")
    elif "data" in payload:
        raw = [payload["data"]]
    else:
        raise ValueError("body needs 'instances' or 'data'")
    sig = server.model.input_signature
    samples = []
    for inst in raw:
        parts = inst if len(sig) > 1 else [inst]
        if len(parts) != len(sig):
            raise ValueError(
                f"each instance must carry {len(sig)} inputs")
        samples.append(tuple(
            _np.asarray(p, dtype=d) for p, (_, d) in zip(parts, sig)))
    return samples, deadline_ms


class _Handler(BaseHTTPRequestHandler):
    server_version = "mxnet-tpu-torch-serving/0.1"
    protocol_version = "HTTP/1.1"

    # the ModelServer rides on the HTTP server object (make_http_server)
    @property
    def _ms(self) -> ModelServer:
        return self.server.model_server     # type: ignore[attr-defined]

    def log_message(self, fmt: str, *args: Any) -> None:
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def _reply(self, code: int, body: Any,
               content_type: str = "application/json",
               headers: Optional[dict] = None) -> None:
        data = body if isinstance(body, bytes) else \
            json.dumps(body).encode()
        self.send_response(code)
        tp = _tracing.traceparent()
        if tp is not None:
            # echo the request's trace context so the caller can join
            # its client-side span to what GET /v1/traces will show
            self.send_header("traceparent", tp)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    # -- GET ---------------------------------------------------------------
    def do_GET(self) -> None:   # noqa: N802 - http.server API
        try:
            self._get()
        except Exception as e:   # noqa: BLE001 - handler must answer
            self._reply(500, {"error": "internal", "detail": str(e)})

    def _get(self) -> None:
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            self._reply(200, _metrics.render_text().encode(),
                        content_type="text/plain; version=0.0.4")
        elif path in ("/healthz", "/readyz"):
            d = self._ms.describe()
            body = {"queue": d["queue"], "exec_cache": d["exec_cache"],
                    "resilience": d["resilience"]}
            if self._ms.draining:
                # readiness drops out of rotation first; resident work
                # is still finishing and liveness (/livez) stays 200
                body.pop("exec_cache")
                self._reply(503, dict(body, status="draining",
                                      detail="draining: admissions "
                                      "shed; resident work finishing"))
            elif not self._ms.healthy():
                # no serving capacity: tell the load balancer to stop
                # sending traffic
                body.pop("exec_cache")
                self._reply(503, dict(body, status="degraded",
                                      detail="serving worker replicas are "
                                      "not serving; reset the breaker or "
                                      "restart the server"))
            else:
                self._reply(200, dict(body, status="ok"))
        elif path == "/livez":
            # liveness: the process answers, even degraded or draining
            self._reply(200, {"status": "alive",
                              "draining": self._ms.draining,
                              "degraded": self._ms.degraded})
        elif path == "/v1/traces":
            # the span ring buffer as Chrome/Perfetto trace-event JSON
            self._reply(200, _tracing.export_trace_events())
        elif path == "/v1/model":
            self._reply(200, self._ms.describe())
        else:
            self._reply(404, {"error": "not_found", "path": path})

    # -- POST --------------------------------------------------------------
    def do_POST(self) -> None:  # noqa: N802 - http.server API
        try:
            # trace context: continue the caller's trace when the
            # request carries a W3C traceparent header, else start a
            # fresh (head-sampled) one. The batcher's queue wait
            # parents under this span.
            rctx = _tracing.parse_traceparent(
                self.headers.get("traceparent"))
            with _tracing.attach(rctx):
                with _tracing.span(
                        "http.request", method="POST",
                        path=self.path.split("?", 1)[0]):
                    self._post()
        except Exception as e:   # noqa: BLE001 - handler must answer
            self._reply(500, {"error": "internal", "detail": str(e)})

    def _post(self) -> None:
        path = self.path.split("?", 1)[0]
        if path == "/v1/generate":
            # the JAX package's answer when no generation engine is hosted
            self._reply(404, {"error": "not_found",
                              "path": "/v1/generate",
                              "detail": "no generation engine is "
                                        "hosted (serve a decoder LM "
                                        "with --generate)"})
            return
        if path not in ("/v1/inference", "/invocations"):
            self._reply(404, {"error": "not_found", "path": path})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0 or length > _MAX_BODY:
                raise ValueError(f"bad Content-Length {length}")
            payload = json.loads(self.rfile.read(length))
            samples, deadline_ms = _decode_samples(self._ms, payload)
        except (TypeError, ValueError, json.JSONDecodeError) as e:
            # TypeError covers valid-JSON-wrong-structure payloads
            # (null data, scalar instances, ...): still the caller's bug
            self._reply(400, {"error": "bad_request", "detail": str(e)})
            return
        futs: List[Any] = []

        def _abandon() -> None:
            # a partial failure abandons the sibling instances: cancel
            # them so the worker skips the wasted compute
            for f in futs:
                f.cancel()

        # submit phase: errors here are the CALLER's (shape/arity/
        # over-long length -> 400) or backpressure (-> 429)
        try:
            for s in samples:
                futs.append(self._ms.infer_async(
                    *s, deadline_ms=deadline_ms))
        except OverloadError as e:
            _abandon()
            self._reply(429, e.to_json(), headers={
                "Retry-After": str(max(1, int(e.retry_after_ms / 1e3)))})
            return
        except DegradedError as e:
            # server-side incapacity (dead worker / stopped), NOT the
            # caller's bug: 503 tells the balancer to fail over
            _abandon()
            self._reply(503, {"error": "degraded", "detail": str(e)},
                        headers={"Retry-After": "1"})
            return
        except MXNetError as e:
            _abandon()
            self._reply(400, {"error": "bad_request", "detail": str(e)})
            return
        # gather phase: deadline sheds are still 429; anything else is a
        # server-side fault (500)
        try:
            preds = []
            for f in futs:
                out = f.result(timeout=60.0)
                outs = out if isinstance(out, list) else [out]
                vals = [o.tolist() for o in outs]
                preds.append(vals[0] if len(vals) == 1 else vals)
        except OverloadError as e:
            _abandon()
            self._reply(429, e.to_json(), headers={
                "Retry-After": str(max(1, int(e.retry_after_ms / 1e3)))})
            return
        except Exception as e:   # noqa: BLE001 - request-scoped fault
            _abandon()
            self._reply(500, {"error": "inference_failed",
                              "detail": str(e)})
            return
        self._reply(200, {"predictions": preds})


class _QuietThreadingHTTPServer(ThreadingHTTPServer):
    """Client hangups (reset / broken pipe mid-request) are routine under
    chaos or drain: swallow them instead of printing a traceback per
    abandoned connection; everything else still reports."""

    def handle_error(self, request: Any, client_address: Any) -> None:
        import sys as _sys
        exc = _sys.exc_info()[1]
        if isinstance(exc, (ConnectionResetError, BrokenPipeError,
                            ConnectionAbortedError, TimeoutError)):
            return
        super().handle_error(request, client_address)


def make_http_server(model_server: ModelServer,
                     host: str = "127.0.0.1",
                     port: int = 8080,
                     verbose: bool = False,
                     generation_server: Any = None
                     ) -> ThreadingHTTPServer:
    """Bind the HTTP front end over ``model_server`` (``port=0`` picks a
    free port; the bound address is ``httpd.server_address``). Run with
    ``serve_forever()``; the caller owns the server's ``start()`` /
    ``stop()``. ``generation_server`` is ROADMAP Queue A 5: anything but
    None raises."""
    if generation_server is not None:
        raise MXNetError("make_http_server: a GenerationServer is not "
                         "ported yet (ROADMAP Queue A 5, GPT and "
                         "generation); /v1/generate answers 404")
    if model_server is None:
        raise MXNetError("make_http_server needs a ModelServer")
    httpd = _QuietThreadingHTTPServer((host, port), _Handler)
    httpd.daemon_threads = True
    httpd.model_server = model_server       # type: ignore[attr-defined]
    httpd.verbose = verbose                 # type: ignore[attr-defined]
    return httpd
