"""The port's HTTP front end (``mxnet_tpu_torch.serving.http``) against the
JAX package's, both in this process on port 0, serving the same 2-layer,
64-unit BERT with the same weights (``convert.load_jax_params``).

The same requests get the same status codes and the same JSON keys from
both; predictions agree within rtol=1e-5, atol=1e-5 in f32 (the same
formulas, summed in another order). Covered: ``instances`` and ``data``
bodies, malformed bodies (400), unknown paths and ``/v1/generate`` without
a generation server (404),
a drain (429 and a 503 readiness, liveness 200), a tripped breaker (503)
and ``reset_breaker`` (200), ``/metrics`` after requests sent one at a
time, ``/v1/model``'s keys, and ``traceparent`` continuation into
``/v1/traces``. Every socket call times out after a few seconds and every
server is stopped in a ``finally``.
"""
import contextlib
import http.client
import json
import threading

import numpy as onp
import jax  # noqa: F401  (JAX on the CPU before the JAX package loads)
import pytest

import mxnet_tpu as mx
from mxnet_tpu import faults as jfaults
from mxnet_tpu import metrics as jmetrics
from mxnet_tpu import serving as jserving
from mxnet_tpu.gluon import HybridBlock as JHybridBlock
from mxnet_tpu_torch import faults as tfaults
from mxnet_tpu_torch import metrics as tmetrics
from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import HybridBlock
from torch_port_util import bert_pair

SIG = [((16,), onp.int32), ((), onp.int32)]
TOL = dict(rtol=1e-5, atol=1e-5)
TIMEOUT = 10.0


class _JEncode(JHybridBlock):
    def __init__(self, bert):
        super().__init__()
        self.bert = bert

    def forward(self, tokens, valid_length):
        return self.bert(tokens, None, valid_length)


class _TEncode(HybridBlock):
    def __init__(self, bert):
        super().__init__()
        self.bert = bert

    def forward(self, tokens, valid_length):
        return self.bert(tokens, None, valid_length)


@pytest.fixture(scope="module")
def models():
    """(JAX ServedModel, port ServedModel) over the same weights."""
    jnet, tnet, _ = bert_pair(seed=1)
    return (jserving.ServedModel.from_block(_JEncode(jnet), SIG),
            tserving.ServedModel.from_block(_TEncode(tnet), SIG,
                                            device="cpu"))


def _policy(pkg):
    return pkg.BucketPolicy(batch_buckets=(1, 2), pad_axis=0,
                            length_buckets=(16,))


@contextlib.contextmanager
def _fronts(models, **kw):
    """Both packages' ModelServer behind their make_http_server on
    127.0.0.1:0: yields [(server, port)] for the JAX package, the port."""
    started = []
    try:
        for pkg, model in zip((jserving, tserving), models):
            srv = pkg.ModelServer(model, _policy(pkg), timeout_ms=1, **kw)
            srv.start()
            httpd = pkg.make_http_server(srv, host="127.0.0.1", port=0)
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            started.append((srv, httpd))
        yield [(srv, httpd.server_address[1]) for srv, httpd in started]
    finally:
        for srv, httpd in started:
            httpd.shutdown()
            httpd.server_close()
            srv.stop(timeout=TIMEOUT)


def _call(port, method, path, body=None, headers=None, raw=None):
    """(status, headers, parsed JSON or text) of one request."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        data = raw if raw is not None else (
            None if body is None else json.dumps(body).encode())
        conn.request(method, path, body=data, headers=headers or {})
        resp = conn.getresponse()
        out = resp.read()
        kind = resp.getheader("Content-Type", "")
        return (resp.status, dict(resp.getheaders()),
                json.loads(out) if kind.startswith("application/json")
                else out.decode())
    finally:
        conn.close()


def _both(fronts, method, path, body=None, headers=None, raw=None):
    return [_call(port, method, path, body, headers, raw)
            for _, port in fronts]


def _sample(L, seed=0):
    tok = onp.random.RandomState(seed).randint(0, 100, L).tolist()
    return [tok, L]


def _keys(x):
    """The key structure of a JSON value: dicts by their sorted keys."""
    if isinstance(x, dict):
        return {k: _keys(v) for k, v in sorted(x.items())}
    return type(x).__name__


@pytest.mark.parametrize("path", ["/v1/inference", "/invocations"])
@pytest.mark.parametrize("body", [
    {"instances": [_sample(5, 1)]},
    {"instances": [_sample(16, 2), _sample(3, 3), _sample(9, 4)]},
    {"data": _sample(12, 5)},
    {"data": _sample(1, 6), "deadline_ms": 30000},
], ids=["one", "three", "data", "deadline"])
def test_inference_matches_jax(models, path, body):
    with _fronts(models) as fronts:
        (js, _, jb), (ts, _, tb) = _both(fronts, "POST", path, body)
    assert js == ts == 200
    assert _keys(jb) == _keys(tb) == {"predictions": "list"}
    assert len(jb["predictions"]) == len(tb["predictions"])
    for jp, tp in zip(jb["predictions"], tb["predictions"]):
        for ja, ta in zip(jp, tp):
            onp.testing.assert_allclose(onp.asarray(ta, "float32"),
                                        onp.asarray(ja, "float32"), **TOL)


@pytest.mark.parametrize("raw", [
    b"not json", b"[1, 2]", b"{}", b'{"instances": []}',
    b'{"instances": "x"}', b'{"data": null}',
    b'{"data": [[1, 2], 2], "deadline_ms": "soon"}',
    b'{"instances": [[[1, 2, 3]]]}',
    json.dumps({"data": _sample(17)}).encode(),
    json.dumps({"data": [[[1, 2]], 2]}).encode(),
], ids=["text", "list", "empty", "no_instances", "str_instances",
        "null_data", "bad_deadline", "arity", "too_long", "bad_rank"])
def test_malformed_bodies_answer_400(models, raw):
    with _fronts(models) as fronts:
        (js, _, jb), (ts, _, tb) = _both(
            fronts, "POST", "/v1/inference", raw=raw,
            headers={"Content-Type": "application/json"})
    assert js == ts == 400
    assert jb["error"] == tb["error"] == "bad_request"
    assert sorted(jb) == sorted(tb)


def test_empty_body_answers_400(models):
    with _fronts(models) as fronts:
        (js, _, jb), (ts, _, tb) = _both(fronts, "POST", "/v1/inference",
                                         raw=b"")
    assert js == ts == 400 and sorted(jb) == sorted(tb)


@pytest.mark.parametrize("method,path", [
    ("GET", "/nope"), ("POST", "/nope"), ("GET", "/v1/inference"),
    ("POST", "/v1/generate")])
def test_unknown_paths_and_generate_answer_404(models, method, path):
    body = {"tokens": [1, 2]} if method == "POST" else None
    with _fronts(models) as fronts:
        (js, _, jb), (ts, _, tb) = _both(fronts, method, path, body)
    assert js == ts == 404
    assert jb == tb


def test_health_liveness_and_model(models):
    with _fronts(models) as fronts:
        (js, _, jh), (ts, _, th) = _both(fronts, "GET", "/healthz")
        assert js == ts == 200 and jh["status"] == th["status"] == "ok"
        assert sorted(jh) == sorted(th)
        assert sorted(jh["resilience"]) == sorted(th["resilience"])
        assert _both(fronts, "GET", "/readyz")[1][0] == 200
        (js, _, jl), (ts, _, tl) = _both(fronts, "GET", "/livez")
        assert js == ts == 200 and jl == tl == {
            "status": "alive", "draining": False, "degraded": False}
        (js, _, jm), (ts, _, tm) = _both(fronts, "GET", "/v1/model")
    assert js == ts == 200
    # the port has no persistent compile cache, and counts its batches
    assert set(tm) == set(jm) - {"compile_cache"} | {"stats"}
    for k in ("model", "policy", "queue", "resilience"):
        assert sorted(tm[k]) == sorted(jm[k]), k
    assert {"size", "hits", "misses"} <= set(jm["exec_cache"])
    assert set(tm["exec_cache"]) == {"size", "hits", "misses"}


def test_drain_sheds_429_and_readiness_503(models):
    with _fronts(models) as fronts:
        for srv, _ in fronts:
            srv.start_drain()
        (js, jhdr, jb), (ts, thdr, tb) = _both(
            fronts, "POST", "/v1/inference", {"data": _sample(4)})
        assert js == ts == 429
        assert jb["reason"] == tb["reason"] == "draining"
        assert jb == tb
        assert jhdr["Retry-After"] == thdr["Retry-After"] == "1"
        (js, _, jh), (ts, _, th) = _both(fronts, "GET", "/healthz")
        assert js == ts == 503
        assert jh["status"] == th["status"] == "draining"
        assert sorted(jh) == sorted(th)
        (js, _, jl), (ts, _, tl) = _both(fronts, "GET", "/livez")
        assert js == ts == 200 and jl == tl
        assert tl["draining"] is True
        assert all(srv.await_drained(timeout=TIMEOUT) for srv, _ in fronts)


def test_tripped_breaker_503_and_reset_200(models):
    with _fronts(models, max_restarts=0) as fronts:
        codes = []
        for (srv, port), faults in zip(fronts, (jfaults, tfaults)):
            with faults.fault_plan("serving.worker:times=1"):
                codes.append(_call(port, "POST", "/v1/inference",
                                   {"data": _sample(4)})[0])
        assert codes[0] == codes[1]
        for srv, _ in fronts:
            assert srv.degraded and not srv.healthy()
        (js, _, jh), (ts, _, th) = _both(fronts, "GET", "/healthz")
        assert js == ts == 503
        assert jh["status"] == th["status"] == "degraded"
        (js, _, jb), (ts, _, tb) = _both(fronts, "POST", "/v1/inference",
                                         {"data": _sample(4)})
        assert js == ts == 503 and jb["error"] == tb["error"] == "degraded"
        for srv, _ in fronts:
            srv.reset_breaker()
        (js, _, _), (ts, _, _) = _both(fronts, "GET", "/healthz")
        assert js == ts == 200
        (js, _, jb), (ts, _, tb) = _both(fronts, "POST", "/v1/inference",
                                         {"data": _sample(4)})
        assert js == ts == 200
        onp.testing.assert_allclose(onp.asarray(tb["predictions"][0][0]),
                                    onp.asarray(jb["predictions"][0][0]),
                                    **TOL)


def _series(text, name):
    for line in text.splitlines():
        if line.startswith(name + " ") or line.startswith(name + "{"):
            yield line.rsplit(" ", 1)


def test_metrics_count_requests_sent_one_at_a_time(models):
    n = 5
    with _fronts(models) as fronts:
        jmetrics.reset()
        tmetrics.reset()
        for i in range(n):
            for status, _, _ in _both(fronts, "POST", "/v1/inference",
                                      {"data": _sample(3 + i, i)}):
                assert status == 200
        (js, jhdr, jt), (ts, thdr, tt) = _both(fronts, "GET", "/metrics")
    assert js == ts == 200
    assert jhdr["Content-Type"] == thdr["Content-Type"]
    for name in ('mxnet_serving_requests_total{status="ok"}',
                 "mxnet_serving_batch_size_count",
                 "mxnet_serving_batch_size_sum",
                 "mxnet_serving_queue_wait_seconds_count",
                 "mxnet_serving_inference_seconds_count",
                 'mxnet_serving_batch_size_bucket{le="1"}',
                 "mxnet_serving_queue_depth"):
        want = dict(_series(jt, name.split("{")[0]))
        got = dict(_series(tt, name.split("{")[0]))
        assert got[name] == want[name], name
    assert dict(_series(tt, "mxnet_serving_requests_total"))[
        'mxnet_serving_requests_total{status="ok"}'] == str(n)


def test_traceparent_is_continued_into_v1_traces(models):
    trace_id = "4bf92f3577b34da6a3ce929d0e0e4736"
    header = {"traceparent": f"00-{trace_id}-00f067aa0ba902b7-01"}
    with _fronts(models) as fronts:
        replies = _both(fronts, "POST", "/v1/inference",
                        {"data": _sample(6)}, headers=header)
        traces = _both(fronts, "GET", "/v1/traces")
    for status, hdr, _ in replies:
        assert status == 200
        assert hdr["traceparent"].split("-")[1] == trace_id
    names = []
    for status, _, body in traces:
        assert status == 200
        spans = [e for e in body["traceEvents"]
                 if e.get("args", {}).get("trace_id") == trace_id]
        names.append(sorted({e["name"] for e in spans}))
        assert sorted(spans[0]) == sorted(body["traceEvents"][-1])
    assert names[0] == names[1] == ["http.request", "queue.wait"]


def test_a_generation_server_is_refused(models):
    # what is not a GenerationServer is refused as one; a real one is
    # served (tests/test_torch_generation.py)
    with pytest.raises(MXNetError, match="must be a GenerationServer"):
        tserving.make_http_server(object(), port=0,
                                  generation_server=object())
    with pytest.raises(MXNetError):
        tserving.make_http_server(None, port=0)
    assert mx.MXNetError is not MXNetError   # two packages, two errors
