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

* ``POST /v1/generate`` — body ``{"tokens": [id, ...]}`` (``"prompt"`` is
  an alias) + optional ``"max_new_tokens"``, ``"eos_token"``,
  ``"deadline_ms"``, ``"stream"``, ``"speculative"`` and the sampling
  controls ``"method"``, ``"temperature"``, ``"top_k"``, ``"top_p"``,
  ``"seed"``; out-of-range values -> 400. Streaming (the default,
  ``MXNET_GEN_STREAM``) answers chunked NDJSON, one
  ``{"token": id, "index": i}`` line per token as the decode iteration
  produces it, then a ``{"done": true, ...}`` trailer; ``"stream": false``
  answers one JSON object when the sequence finishes. No slot within the
  deadline / queue full -> 429 with the shed payload; a degraded server ->
  503. Without a generation server the path answers 404, as the JAX
  package's does (``_post_generate`` and ``_stream_tokens``,
  ``http.py:302-539``).

``make_http_server`` takes a ModelServer, a GenerationServer or both.
"""
from __future__ import annotations

import json
import socket
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, List, Optional, Tuple

import numpy as _np

from .. import metrics as _metrics
from .. import tracing as _tracing
from ..base import MXNetError
from .batching import OverloadError
from .generation import StreamTimeout
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

    # the ModelServer / GenerationServer ride on the HTTP server object
    # (set in make_http_server); either may be absent
    @property
    def _ms(self) -> Optional[ModelServer]:
        return self.server.model_server     # type: ignore[attr-defined]

    @property
    def _gs(self) -> Any:
        return getattr(self.server, "generation_server", None)

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
            draining = any(
                s is not None and getattr(s, "draining", False)
                for s in (self._ms, self._gs))
            degraded = []
            if self._ms is not None and not self._ms.healthy():
                degraded.append(
                    "serving worker replicas are not serving")
            if self._gs is not None and not self._gs.healthy():
                degraded.append(
                    "generation worker replicas are not serving")
            body: dict = {}
            if self._ms is not None:
                d = self._ms.describe()
                body["queue"] = d["queue"]
                body["exec_cache"] = d["exec_cache"]
                body["resilience"] = d["resilience"]
            if self._gs is not None:
                g = self._gs.describe()
                body["generation"] = {"slots": g["slots"],
                                      "queue": g["queue"],
                                      "resilience": g["resilience"]}
            if draining:
                # readiness drops out of rotation FIRST; resident work
                # is still finishing and liveness (/livez) stays 200
                body.pop("exec_cache", None)
                self._reply(503, dict(body, status="draining",
                                      detail="draining: admissions "
                                      "shed; resident work finishing"))
            elif degraded:
                # no serving capacity: requests would queue forever —
                # tell the load balancer to stop sending traffic
                body.pop("exec_cache", None)
                self._reply(503, dict(body, status="degraded",
                                      detail="; ".join(degraded)
                                      + "; reset the breaker or "
                                      "restart the server"))
            else:
                self._reply(200, dict(body, status="ok"))
        elif path == "/livez":
            # liveness: the process answers — even degraded or draining
            # (the orchestrator must NOT kill a draining pod)
            self._reply(200, {
                "status": "alive",
                "draining": any(
                    s is not None and getattr(s, "draining", False)
                    for s in (self._ms, self._gs)),
                "degraded": any(
                    s is not None and getattr(s, "degraded", False)
                    for s in (self._ms, self._gs)),
            })
        elif path == "/v1/traces":
            # the span ring buffer as Chrome/Perfetto trace-event JSON
            # (same shape the profiler dumps — one chrome://tracing
            # load shows both)
            self._reply(200, _tracing.export_trace_events())
        elif path == "/v1/model":
            out = (self._ms.describe() if self._ms is not None else {})
            if self._gs is not None:
                out["generation"] = self._gs.describe()
            self._reply(200, out)
        else:
            self._reply(404, {"error": "not_found", "path": path})

    # -- POST --------------------------------------------------------------
    def do_POST(self) -> None:  # noqa: N802 - http.server API
        try:
            # trace context: continue the caller's trace when the
            # request carries a W3C traceparent header, else start a
            # fresh (head-sampled) one.  Everything downstream —
            # batcher queue wait, prefill, token stream — parents
            # under this span.
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
            self._post_generate()
            return
        if path not in ("/v1/inference", "/invocations"):
            self._reply(404, {"error": "not_found", "path": path})
            return
        if self._ms is None:
            self._reply(404, {"error": "not_found", "path": path,
                              "detail": "this server hosts only "
                                        "/v1/generate"})
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

    # -- generation (continuous batching, per-token streaming) -------------
    def _post_generate(self) -> None:
        from ..base import getenv
        gs = self._gs
        if gs is None:
            # the JAX package's answer when no generation engine is hosted
            self._reply(404, {"error": "not_found",
                              "path": "/v1/generate",
                              "detail": "no generation engine is "
                                        "hosted (serve a decoder LM "
                                        "with --generate)"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0 or length > _MAX_BODY:
                raise ValueError(f"bad Content-Length {length}")
            payload = json.loads(self.rfile.read(length))
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
            toks = payload.get("tokens", payload.get("prompt"))
            if not isinstance(toks, list) or not toks or \
                    not all(isinstance(t, int) for t in toks):
                raise ValueError(
                    "'tokens' (or 'prompt') must be a non-empty list "
                    "of token ids")
            max_new = int(payload.get("max_new_tokens", 64))
            eos = payload.get("eos_token")
            if eos is not None:
                eos = int(eos)
            deadline_ms = payload.get("deadline_ms")
            if deadline_ms is not None and not isinstance(
                    deadline_ms, (int, float)):
                raise ValueError("deadline_ms must be a number")
            # sampling parameters: type errors are caught HERE (400);
            # range errors (top_k < 1, top_p outside (0,1], bad
            # method, temperature <= 0) raise MXNetError from the
            # engine's zoo-rule validation below — also 400, on both
            # the stream and collect paths (validation precedes any
            # token)
            method = payload.get("method")
            if method is not None and not isinstance(method, str):
                raise ValueError("method must be a string (greedy / "
                                 "sample / top_k / top_p)")
            temperature = payload.get("temperature")
            if temperature is not None and not isinstance(
                    temperature, (int, float)):
                raise ValueError("temperature must be a number")
            top_k = payload.get("top_k")
            if top_k is not None and not isinstance(top_k, int):
                raise ValueError("top_k must be an integer")
            top_p = payload.get("top_p")
            if top_p is not None and not isinstance(top_p,
                                                    (int, float)):
                raise ValueError("top_p must be a number")
            seed = payload.get("seed")
            if seed is not None and not isinstance(seed, int):
                raise ValueError("seed must be an integer")
            speculative = payload.get("speculative")
            if speculative is not None and not isinstance(
                    speculative, bool):
                raise ValueError("speculative must be a boolean")
            stream_mode = bool(payload.get(
                "stream", int(getenv("MXNET_GEN_STREAM", 1))))
        except (TypeError, ValueError, json.JSONDecodeError) as e:
            self._reply(400, {"error": "bad_request", "detail": str(e)})
            return
        # submit: backpressure -> 429, dead worker -> 503, a budget
        # that cannot fit the KV ceiling (or out-of-range sampling
        # params) -> 400 (the caller's bug)
        try:
            stream = gs.generate(toks, max_new_tokens=max_new,
                                 eos_token=eos,
                                 deadline_ms=deadline_ms,
                                 method=method, temperature=temperature,
                                 top_k=top_k, top_p=top_p, seed=seed,
                                 speculative=speculative)
        except OverloadError as e:
            self._reply(429, e.to_json(), headers={
                "Retry-After": str(max(1, int(e.retry_after_ms / 1e3)))})
            return
        except DegradedError as e:
            self._reply(503, {"error": "degraded", "detail": str(e)},
                        headers={"Retry-After": "1"})
            return
        except MXNetError as e:
            self._reply(400, {"error": "bad_request", "detail": str(e)})
            return
        if not stream_mode:
            try:
                tokens = stream.result(timeout=300.0)
            except OverloadError as e:
                # no slot freed within the deadline: still a shed
                self._reply(429, e.to_json(), headers={
                    "Retry-After": str(max(1, int(e.retry_after_ms
                                                  / 1e3)))})
                return
            except Exception as e:   # noqa: BLE001 - request-scoped
                self._reply(500, {"error": "generation_failed",
                                  "detail": str(e)})
                return
            self._reply(200, {"tokens": tokens,
                              "finish_reason": stream.finish_reason})
            return
        self._stream_tokens(stream)

    def _client_gone(self) -> bool:
        """Peek the connection without consuming: a readable socket
        that yields EOF means the client hung up while its request was
        still queued."""
        import select
        try:
            r, _, _ = select.select([self.connection], [], [], 0)
            if r:
                return self.connection.recv(1, socket.MSG_PEEK) == b""
        except (OSError, ValueError):
            return True
        return False

    def _stream_tokens(self, stream: Any) -> None:
        """Chunked NDJSON: one line per token AS the decode loop emits
        it, then a done trailer.  The status line is DEFERRED until the
        first token exists: every shed (queue_full at submit, deadline
        at the admission boundary) happens strictly before any token is
        produced, so waiting for token #1 preserves the documented
        429/500 contract for streaming requests.  A failure after that
        becomes an error line on the already-committed 200 (the nature
        of streaming); a client disconnect cancels the sequence so its
        slot frees at the next iteration.

        The first-token wait POLLS for disconnects: a client that hangs
        up while its request is still in the prefill queue is evicted
        immediately (the queue budget frees NOW), so a flood of
        abandoned requests cannot hold queue_full sheds high."""
        deadline = time.monotonic() + 300.0
        with _tracing.child_span("stream.first_token"):
            while True:
                try:
                    first = stream.next_token(timeout=0.25)
                    break
                except StreamTimeout:
                    if self._client_gone():
                        stream.cancel()  # evicts a queued request NOW
                        return
                    if time.monotonic() >= deadline:
                        self._reply(500, {
                            "error": "generation_failed",
                            "detail": "timed out waiting for the "
                                      "first token"})
                        return
                except OverloadError as e:
                    # no slot freed within the deadline — still a 429
                    self._reply(429, e.to_json(), headers={
                        "Retry-After": str(max(
                            1, int(e.retry_after_ms / 1e3)))})
                    return
                except Exception as e:  # noqa: BLE001 - request-scoped
                    self._reply(500, {"error": "generation_failed",
                                      "detail": str(e)})
                    return
        if first is None:        # closed with zero tokens (shutdown)
            self._reply(500, {"error": "generation_failed",
                              "detail": "sequence closed before its "
                                        "first token"})
            return
        self.send_response(200)
        tp = _tracing.traceparent()
        if tp is not None:
            self.send_header("traceparent", tp)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("Cache-Control", "no-store")
        self.end_headers()

        def flush(lines: List[Any]) -> None:
            # ONE chunk may carry many NDJSON lines: a speculative
            # iteration lands its whole accepted run in one
            # TokenStream wakeup, and it leaves the socket as one
            # write too — per-token writes would hand the speculation
            # win straight back to syscall overhead
            if not lines:
                return
            data = b"".join((json.dumps(o) + "\n").encode()
                            for o in lines)
            self.wfile.write(f"{len(data):X}\r\n".encode() + data
                             + b"\r\n")
            self.wfile.flush()

        i = 0
        with _tracing.child_span("stream.completion") as csp:
            try:
                try:
                    pend = [{"token": int(first), "index": i}]
                    i += 1
                    done = False
                    while not done:
                        # batch everything already buffered behind the
                        # token in hand, flush once, then block for
                        # the next iteration's output
                        try:
                            while True:
                                tok = stream.next_token(timeout=0.0)
                                if tok is None:
                                    done = True
                                    break
                                pend.append({"token": int(tok),
                                             "index": i})
                                i += 1
                        except StreamTimeout:
                            pass             # drained; stream still live
                        flush(pend)
                        pend = []
                        if done:
                            break
                        tok = stream.next_token()
                        if tok is None:
                            done = True
                        else:
                            pend.append({"token": int(tok), "index": i})
                            i += 1
                except MXNetError as e:
                    flush([{"error": "generation_failed",
                            "detail": str(e), "done": True}])
                    self.wfile.write(b"0\r\n\r\n")
                    return
                flush([{"done": True, "n_tokens": i,
                        "finish_reason": stream.finish_reason}])
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                stream.cancel()
            finally:
                csp.set_attr(n_tokens=i,
                             finish_reason=stream.finish_reason)


class _QuietThreadingHTTPServer(ThreadingHTTPServer):
    """Client hangups (reset/broken pipe mid-request) are ROUTINE for
    a streaming server under chaos or drain — swallow them instead of
    printing a traceback per abandoned connection; everything else
    still reports."""

    def handle_error(self, request: Any, client_address: Any) -> None:
        import sys as _sys
        exc = _sys.exc_info()[1]
        if isinstance(exc, (ConnectionResetError, BrokenPipeError,
                            ConnectionAbortedError, TimeoutError)):
            return
        super().handle_error(request, client_address)


def make_http_server(model_server: Optional[ModelServer],
                     host: str = "127.0.0.1",
                     port: int = 8080,
                     verbose: bool = False,
                     generation_server: Any = None
                     ) -> ThreadingHTTPServer:
    """Bind the HTTP front end (``port=0`` picks a free port; the bound
    address is ``httpd.server_address``). Run with ``serve_forever()``;
    the caller owns the model / generation servers' ``start()`` /
    ``stop()``. Either server may be omitted; its endpoints then answer
    404. A ``generation_server`` must be a GenerationServer (something
    with ``generate`` and ``describe``)."""
    if model_server is None and generation_server is None:
        raise MXNetError("make_http_server needs a ModelServer and/or "
                         "a GenerationServer")
    if generation_server is not None and not all(
            callable(getattr(generation_server, n, None))
            for n in ("generate", "describe", "healthy")):
        raise MXNetError(
            f"make_http_server: generation_server must be a "
            f"GenerationServer, got {type(generation_server).__name__}")
    httpd = _QuietThreadingHTTPServer((host, port), _Handler)
    httpd.daemon_threads = True
    httpd.model_server = model_server       # type: ignore[attr-defined]
    httpd.generation_server = generation_server  # type: ignore[attr-defined]
    httpd.verbose = verbose                 # type: ignore[attr-defined]
    return httpd
