"""The port's metrics registry (``mxnet_tpu_torch.metrics``) against the
JAX package's on the CPU.

- The same sequence of counter, gauge and histogram operations on a fresh
  ``MetricsRegistry`` of each package renders the same Prometheus text and
  the same JSON (an exemplar's wall-clock ``ts`` aside), with the same
  cardinality bound and the same errors.
- Every family the JAX package declares in ``metrics.py``,
  ``serving/batching.py`` and ``serving/replica.py``, and the fault
  counter, exists in the port with the same type, labels and bucket bounds
  (and, for ``metrics.py``'s, the same doc).
- The helpers: ``value``, ``hist_stats``, ``reset``, ``record_step``,
  ``inc_op`` (fed by the port's ``invoke``), ``exponential_buckets``, the
  logger, and ``record_device_highwater`` doing nothing without CUDA.
"""
import time

import numpy as onp
import jax  # noqa: F401  (JAX on the CPU before the JAX package loads)
import pytest

import mxnet_tpu as mx
import mxnet_tpu.faults as jfaults
import mxnet_tpu.metrics as jm
import mxnet_tpu.serving.batching as jbatching
import mxnet_tpu.serving.replica as jreplica
import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.faults as tfaults
import mxnet_tpu_torch.metrics as tm
import mxnet_tpu_torch.serving.batching as tbatching
import mxnet_tpu_torch.serving.replica as treplica


def _counters(reg):
    c = reg.counter("app_requests_total", "Requests by code.",
                    labels=("code", "path"))
    c.labels("200", "/a").inc()
    c.labels(code="500", path="/b").inc(3)
    c.labels("200", "/a").inc(0.5)
    reg.counter("app_plain_total", "No labels.").inc(7)


def _gauges(reg):
    g = reg.gauge("app_depth", "A gauge.")
    g.set(4)
    g.inc(2.5)
    g.dec(1)
    lg = reg.gauge("app_temp", "Labeled.", labels=("zone",))
    lg.labels(zone='a"b\\c\nd').set(-3)


def _histograms(reg):
    h = reg.histogram("app_latency_seconds", "Default buckets.")
    for v in (0.0, 1e-4, 2.5e-4, 0.3, 7.0, 1e3):
        h.observe(v)
    hb = reg.histogram("app_batch", "Custom buckets.", labels=("m",),
                       buckets=jm.exponential_buckets(1, 2, 5))
    for v in (1, 2, 3, 17, 16, 0.5):
        hb.labels(m="x").observe(v)
    hm = reg.histogram("app_accept", "Min exemplar.", buckets=(1, 2, 4),
                       exemplar_pref="min")
    for v, ex in ((3, "t1"), (1, "t2"), (2, "t3")):
        hm.observe(v, exemplar=ex)
    hx = reg.histogram("app_slow", "Max exemplar.", buckets=(1, 2))
    for v, ex in ((1, "a"), (5, "b"), (2, None), (3, "c")):
        hx.observe(v, exemplar=ex)


def _mixed(reg):
    _counters(reg)
    _gauges(reg)
    _histograms(reg)
    reg.counter("app_requests_total", "Requests by code.",
                labels=("code", "path")).labels("404", "/c").inc()


def _capped(reg):
    c = reg.counter("app_ops_total", "Capped.", labels=("op",))
    for i in range(6):
        c.labels(op=f"op{i}").inc(i + 1)


def _strip_ts(js):
    for fam in js.values():
        for s in fam["series"]:
            if "exemplar" in s:
                s["exemplar"].pop("ts")
    return js


@pytest.mark.parametrize("ops", [_counters, _gauges, _histograms, _mixed,
                                 _capped])
def test_same_operations_same_exposition(ops, monkeypatch):
    monkeypatch.setenv("MXNET_METRICS_MAX_SERIES", "4")
    regs = [jm.MetricsRegistry(), tm.MetricsRegistry()]
    for reg in regs:
        ops(reg)
    j, t = regs
    assert t.render_text() == j.render_text()
    assert _strip_ts(t.dump_json()) == _strip_ts(j.dump_json())
    for reg in regs:
        reg.reset()
    assert t.render_text() == j.render_text()
    assert t.dump_json() == j.dump_json()


@pytest.mark.parametrize("bad", [
    lambda m, r: r.counter("c_total", "").inc(-1),
    lambda m, r: r.counter("1bad", ""),
    lambda m, r: r.counter("l_total", "", labels=("a",)).inc(),
    lambda m, r: r.counter("l2_total", "", labels=("a",)).labels("x", "y"),
    lambda m, r: r.counter("l3_total", "", labels=("a",)).labels(b="x"),
    lambda m, r: (r.counter("dup", ""), r.gauge("dup", "")),
    lambda m, r: r.histogram("h", "", buckets=()),
    lambda m, r: r.histogram("h2", "", exemplar_pref="mid"),
    lambda m, r: m.exponential_buckets(0, 2, 3),
], ids=["negative_inc", "bad_name", "unbound_labels", "label_count",
        "label_names", "kind_clash", "no_buckets", "bad_pref",
        "bad_exponential"])
def test_same_errors(bad):
    for mod, err in ((jm, mx.MXNetError), (tm, tmx.MXNetError)):
        with pytest.raises(err):
            bad(mod, mod.MetricsRegistry())


def _families(mod):
    return {f.name: f for f in vars(mod).values()
            if isinstance(f, (jm.Counter, jm.Gauge, jm.Histogram))}


JAX_FAMILIES = sorted(
    [(n, "metrics") for n in _families(jm)]
    + [(n, "batching") for n in _families(jbatching)]
    + [(n, "replica") for n in _families(jreplica)]
    + [(n, "faults") for n in _families(jfaults)])


@pytest.mark.parametrize("name,where", JAX_FAMILIES,
                         ids=[n for n, _ in JAX_FAMILIES])
def test_every_jax_family_is_declared_alike(name, where):
    jmod = {"metrics": jm, "batching": jbatching, "replica": jreplica,
            "faults": jfaults}[where]
    want = _families(jmod)[name]
    got = tm.REGISTRY.get(name)
    assert got is not None, f"{name} ({where}) is not declared in the port"
    assert got.kind == want.kind
    assert got.label_names == want.label_names
    if want.kind == "histogram":
        assert got.bounds == want.bounds
        assert got.exemplar_pref == want.exemplar_pref
    if where in ("metrics", "batching"):
        assert got.doc == want.doc


def test_port_modules_hold_the_jax_module_families():
    for jmod, tmod in ((jm, tm), (jbatching, tbatching),
                       (jreplica, treplica), (jfaults, tfaults)):
        assert sorted(
            k for k, v in vars(jmod).items()
            if isinstance(v, (jm.Counter, jm.Gauge, jm.Histogram))) == \
            sorted(k for k, v in vars(tmod).items()
                   if isinstance(v, (tm.Counter, tm.Gauge, tm.Histogram)))


def test_value_hist_stats_and_reset_match():
    for m in (jm, tm):
        m.reset()
        m.record_step(0.25, data=0.05, dispatch=0.1, sync=0.1, count=2)
        m.record_step(0.5)
        m.inc_op("probe_op")
        m.inc_op("probe_op")
    for name, labels in (("mxnet_steps_total", {}),
                         ("mxnet_steps_per_second", {}),
                         ("mxnet_ops_dispatched_total", {"op": "probe_op"}),
                         ("mxnet_ops_dispatched_total", {"op": "never"}),
                         ("mxnet_ops_dispatched_total", {}),
                         ("mxnet_step_seconds", {}), ("no_such", {})):
        assert tm.value(name, **labels) == jm.value(name, **labels)
    for name in ("mxnet_step_seconds", "mxnet_step_sync_seconds",
                 "mxnet_steps_total", "no_such"):
        assert tm.hist_stats(name) == jm.hist_stats(name)
    for m in (jm, tm):
        m.reset()
    assert tm.value("mxnet_ops_dispatched_total", op="probe_op") == 0.0
    assert tm.hist_stats("mxnet_step_seconds") == (0.0, 0)


def test_invoke_counts_dispatched_ops():
    tm.reset()
    a = tmx.nd.array(onp.ones((2, 3), "float32"), ctx=tmx.cpu())
    (a + a) * a
    assert tm.value("mxnet_ops_dispatched_total", op="add") == 1.0
    assert tm.value("mxnet_ops_dispatched_total", op="multiply") == 1.0


def test_device_highwater_is_a_no_op_without_cuda(monkeypatch):
    monkeypatch.setattr(tm, "_HIGHWATER_LAST", [0.0])
    tm.DEVICE_MEM_HIGHWATER.set(0)
    tm.record_device_highwater()
    assert tm.value("mxnet_device_mem_highwater_bytes") == 0.0


def test_logger_starts_and_stops():
    assert tm.start_logger(0) is False
    try:
        assert tm.start_logger(0.01) is True
        assert tm.start_logger(0.01) is True      # idempotent
        tm.counter("app_logged_total", "Logged.").inc()
        time.sleep(0.1)
    finally:
        tm.stop_logger()
    assert tm._LOGGER_STATE["thread"] is None
    assert tm._nonzero_summary()["app_logged_total"] == [
        {"labels": {}, "value": 1.0}]
