"""Runtime metrics — process-wide counters, gauges, and histograms.

Counterpart of ``mxnet_tpu/metrics.py``, an own copy: the families
(``Counter``, ``Gauge``, ``Histogram`` with exemplars), the registry and
its exposition (:func:`render_text` in the Prometheus text format,
:func:`dump_json`), :func:`value`, :func:`hist_stats`, :func:`reset`, the
per-family cardinality bound (``MXNET_METRICS_MAX_SERIES``), the helpers
(:func:`record_step`, :func:`inc_op`, :func:`record_device_highwater`) and
the background logger (``MXNET_METRICS_LOG_INTERVAL``). Every family the
JAX package declares here is declared eagerly with the same name, doc,
labels and bucket bounds, so ``GET /metrics`` shows the same surface.

Where the port feeds them:

* ``mxnet_ops_dispatched_total`` — ``ndarray/register.py:invoke`` and
  ``invoke_with_custom_vjp``, per op;
* ``mxnet_trainer_step_seconds`` — ``gluon.Trainer.step``;
* ``mxnet_device_mem_highwater_bytes`` — :func:`record_device_highwater`,
  from ``torch.cuda.max_memory_allocated`` on the card (nothing on the
  CPU, as the JAX package does where ``memory_stats()`` is None);
* the serving families — ``serving/batching.py``, ``serving/model.py``,
  ``serving/server.py`` and ``serving/replica.py``;
* ``mxnet_faults_injected_total`` — :mod:`mxnet_tpu_torch.faults`.

The JAX package fills ``mxnet_compile_misses_total`` and
``mxnet_compile_seconds`` from a ``jax.monitoring`` listener, which the
port has no counterpart of: they stay at 0, as do
``mxnet_compile_hits_total`` and ``mxnet_exec_cache_size`` (the port has
no per-op executable cache), the engine, collective, bulking, generation
and prefetch families (their modules are ROADMAP Queue A 5, 11, 13 and
14), and ``mxnet_monitor_stat``. A served bucket's first CUDA-graph
capture is counted by ``mxnet_serving_bucket_compiles_total``.
"""
from __future__ import annotations

import bisect
import json
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .base import MXNetError, getenv, register_env

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "counter", "gauge", "histogram", "dump_json", "render_text",
    "reset", "value", "start_logger", "stop_logger",
    "DEFAULT_BUCKETS", "exponential_buckets",
]

register_env("MXNET_METRICS_LOG_INTERVAL", 0,
             "Seconds between background dumps of the runtime metrics "
             "registry to the 'mxnet_tpu.metrics' logger (JSON, non-zero "
             "series only). 0 (default) disables the logger thread.")
register_env("MXNET_METRICS_MAX_SERIES", 512,
             "Per-family label-cardinality bound for the runtime metrics "
             "registry: past this many distinct label combinations, new "
             "ones collapse into a single '_other_' series (guards "
             "against unbounded registry growth from generated names).")

# Fixed exponential buckets: 100us .. ~52s, factor 2 — wide enough for
# everything from a single eager dispatch to a cold-compile train step.
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(
    1e-4 * (2.0 ** i) for i in range(20))


def exponential_buckets(start: float, factor: float,
                        count: int) -> Tuple[float, ...]:
    """``count`` bucket bounds ``start, start*factor, ...`` — the
    prometheus-client helper, for histograms whose domain is not the
    DEFAULT_BUCKETS seconds range (e.g. serving batch sizes)."""
    if start <= 0 or factor <= 1 or count < 1:
        raise MXNetError(
            f"exponential_buckets needs start>0, factor>1, count>=1; "
            f"got ({start}, {factor}, {count})")
    return tuple(start * (factor ** i) for i in range(count))


def _validate_name(name: str) -> None:
    import re
    if not re.match(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$", name):
        raise MXNetError(f"invalid metric name {name!r}")


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class _Family:
    """Base: a named metric with a fixed label-key tuple and one child
    per observed label-value combination."""

    kind = "untyped"

    def __init__(self, name: str, doc: str,
                 labels: Sequence[str] = ()) -> None:
        _validate_name(name)
        self.name = name
        self.doc = " ".join(doc.split())
        self.label_names = tuple(labels)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], Any] = {}
        if not self.label_names:
            self._children[()] = self._new_child()

    # -- child management --------------------------------------------------
    def _new_child(self) -> Any:
        raise NotImplementedError

    def labels(self, *values: Any, **kv: Any) -> "_Family":
        """Return a bound single-series view (prometheus-client style)."""
        if kv:
            if values:
                raise MXNetError("pass label values positionally OR by "
                                 "keyword, not both")
            if set(kv) != set(self.label_names):
                raise MXNetError(
                    f"metric {self.name!r} expects labels "
                    f"{self.label_names}, got {sorted(kv)}")
            values = tuple(kv[k] for k in self.label_names)
        vals = tuple(str(v) for v in values)
        if len(vals) != len(self.label_names):
            raise MXNetError(
                f"metric {self.name!r} expects {len(self.label_names)} "
                f"label values {self.label_names}, got {len(vals)}")
        return _Bound(self, self._child(vals))

    def _child(self, vals: Tuple[str, ...]) -> Any:
        child = self._children.get(vals)
        if child is None:
            with self._lock:
                child = self._children.get(vals)
                if child is None:
                    cap = int(getenv("MXNET_METRICS_MAX_SERIES", 512))
                    if len(self._children) >= cap:
                        # cardinality guard: collapse the overflow into
                        # one sentinel series instead of growing forever
                        vals = ("_other_",) * len(self.label_names)
                        child = self._children.get(vals)
                        if child is not None:
                            return child
                    child = self._children[vals] = self._new_child()
        return child

    def _default(self) -> Any:
        if self.label_names:
            raise MXNetError(
                f"metric {self.name!r} has labels {self.label_names}; "
                "bind them with .labels(...) first")
        return self._children[()]

    def reset(self) -> None:
        with self._lock:
            if self.label_names:
                self._children.clear()
            else:
                self._children = {(): self._new_child()}

    # -- exposition --------------------------------------------------------
    def _series(self) -> List[Tuple[Tuple[str, ...], Any]]:
        with self._lock:
            return sorted(self._children.items())

    def to_json(self) -> Dict[str, Any]:
        out = {"type": self.kind, "doc": self.doc,
               "labels": list(self.label_names), "series": []}
        for vals, child in self._series():
            out["series"].append(
                {"labels": dict(zip(self.label_names, vals)),
                 **child.to_json()})
        return out

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.doc}",
                 f"# TYPE {self.name} {self.kind}"]
        for vals, child in self._series():
            lines.extend(child.render(self.name, self.label_names, vals))
        return lines


def _label_str(names: Sequence[str], vals: Sequence[str],
               extra: str = "") -> str:
    parts = [f'{k}="{_escape_label(v)}"' for k, v in zip(names, vals)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Bound:
    """One series of a family, with the value methods of its kind."""

    __slots__ = ("_family", "_child")

    def __init__(self, family: _Family, child: Any) -> None:
        self._family = family
        self._child = child

    def inc(self, amount: float = 1.0) -> None:
        self._child.inc(self._family._lock, amount)

    def dec(self, amount: float = 1.0) -> None:
        self._child.inc(self._family._lock, -amount)

    def set(self, v: float) -> None:
        self._child.set(self._family._lock, v)

    def observe(self, v: float, exemplar: Optional[str] = None) -> None:
        self._child.observe(self._family._lock, v, exemplar)

    @property
    def value(self) -> float:
        return self._child.value


class _CounterChild:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, lock: threading.Lock, amount: float) -> None:
        if amount < 0:
            raise MXNetError("counters only go up; use a gauge")
        with lock:
            self.value += amount

    def to_json(self) -> Dict[str, Any]:
        return {"value": self.value}

    def render(self, name, label_names, vals) -> List[str]:
        return [f"{name}{_label_str(label_names, vals)} "
                f"{_format_value(self.value)}"]


class _GaugeChild(_CounterChild):
    def inc(self, lock: threading.Lock, amount: float) -> None:
        with lock:
            self.value += amount

    def set(self, lock: threading.Lock, v: float) -> None:
        with lock:
            self.value = float(v)


#: an exemplar older than this is replaced by the next offered one even
#: when slower observations were seen since — "most recent slow", not
#: "all-time max", so a bad p99 points at a trace that still exists
_EXEMPLAR_TTL_S = 60.0


class _HistogramChild:
    __slots__ = ("bounds", "counts", "sum", "count", "exemplar", "pref")

    def __init__(self, bounds: Tuple[float, ...],
                 pref: str = "max") -> None:
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0
        # (trace_id, value, unix time) of the most-extreme recent
        # observation that carried a trace id (tracing exemplar
        # linkage).  ``pref`` picks the direction: "max" keeps the
        # slowest/largest recent value (latency histograms), "min" the
        # smallest (e.g. the worst-accepting speculative step, where
        # LOW is the pathology worth a trace)
        self.exemplar: Optional[Tuple[str, float, float]] = None
        self.pref = pref

    def observe(self, lock: threading.Lock, v: float,
                exemplar: Optional[str] = None) -> None:
        v = float(v)
        idx = bisect.bisect_left(self.bounds, v)
        with lock:
            self.counts[idx] += 1
            self.sum += v
            self.count += 1
            if exemplar is not None:
                ex = self.exemplar
                now = time.time()
                extreme = ex is not None and (
                    v <= ex[1] if self.pref == "min" else v >= ex[1])
                if ex is None or extreme \
                        or now - ex[2] > _EXEMPLAR_TTL_S:
                    self.exemplar = (str(exemplar), v, now)

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "buckets": [[b, c] for b, c in
                        zip(list(self.bounds) + ["+Inf"],
                            _cumulative(self.counts))],
            "sum": self.sum, "count": self.count}
        ex = self.exemplar
        if ex is not None:
            out["exemplar"] = {"trace_id": ex[0], "value": ex[1],
                               "ts": ex[2]}
        return out

    def render(self, name, label_names, vals) -> List[str]:
        lines = []
        for b, c in zip(list(self.bounds) + ["+Inf"],
                        _cumulative(self.counts)):
            le = b if isinstance(b, str) else _format_value(b)
            le_pair = 'le="%s"' % le
            lines.append(
                f"{name}_bucket"
                f"{_label_str(label_names, vals, le_pair)} {c}")
        lines.append(f"{name}_sum{_label_str(label_names, vals)} "
                     f"{_format_value(self.sum)}")
        lines.append(f"{name}_count{_label_str(label_names, vals)} "
                     f"{self.count}")
        return lines


def _cumulative(counts: Sequence[int]) -> List[int]:
    out, acc = [], 0
    for c in counts:
        acc += c
        out.append(acc)
    return out


def _format_value(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class Counter(_Family):
    kind = "counter"

    def _new_child(self) -> _CounterChild:
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(self._lock, amount)

    @property
    def value(self) -> float:
        return self._default().value


class Gauge(_Family):
    kind = "gauge"

    def _new_child(self) -> _GaugeChild:
        return _GaugeChild()

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(self._lock, amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().inc(self._lock, -amount)

    def set(self, v: float) -> None:
        self._default().set(self._lock, v)

    @property
    def value(self) -> float:
        return self._default().value


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name: str, doc: str, labels: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None,
                 exemplar_pref: str = "max") -> None:
        bounds = tuple(sorted(float(b) for b in
                              (buckets if buckets is not None
                               else DEFAULT_BUCKETS)))
        if not bounds:
            raise MXNetError("histogram needs at least one bucket bound")
        if exemplar_pref not in ("max", "min"):
            raise MXNetError(
                f"exemplar_pref must be 'max' or 'min', got "
                f"{exemplar_pref!r}")
        self.bounds = bounds
        self.exemplar_pref = exemplar_pref
        super().__init__(name, doc, labels)

    def _new_child(self) -> _HistogramChild:
        return _HistogramChild(self.bounds, self.exemplar_pref)

    def observe(self, v: float, exemplar: Optional[str] = None) -> None:
        self._default().observe(self._lock, v, exemplar)

    @property
    def sum(self) -> float:
        return self._default().sum

    @property
    def count(self) -> int:
        return self._default().count


# Hot-path cache for the per-op dispatch counter: one dict lookup per
# dispatch (see inc_op).  reset() must drop it — its bound children
# point at pre-reset series objects.
_OP_CHILDREN: Dict[str, _Bound] = {}


class MetricsRegistry:
    """Process-wide named family registry with exposition."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: "Dict[str, _Family]" = {}

    def _register(self, cls, name: str, doc: str, labels=(),
                  **kw) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) or \
                        fam.label_names != tuple(labels):
                    raise MXNetError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind} with labels {fam.label_names}")
                return fam
            fam = cls(name, doc, labels, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, doc: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, doc, labels)

    def gauge(self, name: str, doc: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, doc, labels)

    def histogram(self, name: str, doc: str = "",
                  labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None,
                  exemplar_pref: str = "max") -> Histogram:
        return self._register(Histogram, name, doc, labels,
                              buckets=buckets,
                              exemplar_pref=exemplar_pref)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def reset(self) -> None:
        """Zero every series (registrations survive) — test isolation."""
        with self._lock:
            fams = list(self._families.values())
        for f in fams:
            f.reset()
        _OP_CHILDREN.clear()

    def dump_json(self) -> Dict[str, Any]:
        with self._lock:
            fams = sorted(self._families.items())
        return {name: fam.to_json() for name, fam in fams}

    def render_text(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        with self._lock:
            fams = sorted(self._families.items())
        lines: List[str] = []
        for _, fam in fams:
            lines.extend(fam.render())
        return "\n".join(lines) + "\n"


REGISTRY = MetricsRegistry()


def counter(name: str, doc: str = "",
            labels: Sequence[str] = ()) -> Counter:
    """Get-or-create a counter family on the global registry."""
    return REGISTRY.counter(name, doc, labels)


def gauge(name: str, doc: str = "", labels: Sequence[str] = ()) -> Gauge:
    """Get-or-create a gauge family on the global registry."""
    return REGISTRY.gauge(name, doc, labels)


def histogram(name: str, doc: str = "", labels: Sequence[str] = (),
              buckets: Optional[Sequence[float]] = None,
              exemplar_pref: str = "max") -> Histogram:
    """Get-or-create a histogram family on the global registry."""
    return REGISTRY.histogram(name, doc, labels, buckets, exemplar_pref)


def dump_json() -> Dict[str, Any]:
    return REGISTRY.dump_json()


def render_text() -> str:
    return REGISTRY.render_text()


def reset() -> None:
    REGISTRY.reset()


def _peek(fam: _Family, labels: Dict[str, Any]) -> Any:
    """Read-only series lookup: unlike fam.labels(...), never
    instantiates a child, so probing a never-observed combination does
    not pollute the exposition or consume a cardinality slot."""
    if labels:
        if set(labels) != set(fam.label_names):
            return None
        vals = tuple(str(labels[k]) for k in fam.label_names)
    else:
        if fam.label_names:
            return None
        vals = ()
    with fam._lock:
        return fam._children.get(vals)


def value(name: str, /, **labels: Any) -> float:
    """Current value of a counter/gauge series (0.0 if never touched,
    or if the name is a histogram — use :func:`hist_stats` there) — the
    delta-reading helper tools build breakdowns from."""
    fam = REGISTRY.get(name)
    if fam is None or isinstance(fam, Histogram):
        return 0.0
    child = _peek(fam, labels)
    return float(child.value) if child is not None else 0.0


def hist_stats(name: str, /, **labels: Any) -> Tuple[float, int]:
    """(sum, count) of a histogram series (zeros if never observed)."""
    fam = REGISTRY.get(name)
    if fam is None or not isinstance(fam, Histogram):
        return 0.0, 0
    child = _peek(fam, labels)
    if child is None:
        return 0.0, 0
    return float(child.sum), int(child.count)


# ---------------------------------------------------------------------------
# Core instrumentation families (created eagerly so exposition shows the
# full surface even before first use)
# ---------------------------------------------------------------------------

OPS_DISPATCHED = counter(
    "mxnet_ops_dispatched_total",
    "Imperative op dispatches through ndarray.register.invoke, by op "
    "name.", labels=("op",))
COMPILE_MISSES = counter(
    "mxnet_compile_misses_total",
    "XLA backend compilations (jax.monitoring backend_compile events): "
    "every one is a traced program that missed all compile caches.")
COMPILE_HITS = counter(
    "mxnet_compile_hits_total",
    "Per-op executable-cache hits on the eager dispatch path (the call "
    "reused a compiled executable instead of tracing).")
COMPILE_SECONDS = histogram(
    "mxnet_compile_seconds",
    "Wall time of XLA backend compilations (jax.monitoring).")
EXEC_CACHE_SIZE = gauge(
    "mxnet_exec_cache_size",
    "Entries in the per-op executable cache (ndarray.register).")

ENGINE_WAITALL = counter(
    "mxnet_engine_waitall_total",
    "waitall() barriers on outstanding device work.")
ENGINE_WAITALL_SECONDS = histogram(
    "mxnet_engine_waitall_seconds",
    "Wall time blocked inside waitall() barriers.")
ENGINE_LIVE_BUFFERS = gauge(
    "mxnet_engine_live_buffers",
    "Device arrays in the engine's live weak registry.")
ENGINE_SWEEPS = counter(
    "mxnet_engine_sweeps_total",
    "Dead-entry sweeps of the engine's weak registries.")
ENGINE_SYNC_ERRORS = counter(
    "mxnet_engine_sync_errors_total",
    "Async device errors translated to MXNetError at sync points.")

COLLECTIVE_CALLS = counter(
    "mxnet_collective_calls_total",
    "Collective operations by kind. Eager collectives (kvstore) count "
    "per execution; traced ones (ring attention) count per trace, "
    "marked traced=\"1\".", labels=("collective", "traced"))
COLLECTIVE_BYTES = counter(
    "mxnet_collective_bytes_total",
    "Payload bytes this process contributed to collectives, by kind.",
    labels=("collective", "traced"))
COLLECTIVE_SECONDS = histogram(
    "mxnet_collective_seconds",
    "Wall time of eager collective operations, by kind.",
    labels=("collective",))
KVSTORE_PUSHES = counter(
    "mxnet_kvstore_pushes_total",
    "KVStore push() calls (gradient reductions entering the store).")

STEP_SECONDS = histogram(
    "mxnet_step_seconds",
    "Training-step wall time at the trainer boundary (dispatch side: "
    "data placement + program dispatch; device sync is the separate "
    "mxnet_step_sync_seconds component).")
STEP_DATA_SECONDS = histogram(
    "mxnet_step_data_seconds",
    "Per-step time waiting on input data (loader wait + host->device "
    "placement).")
STEP_DISPATCH_SECONDS = histogram(
    "mxnet_step_dispatch_seconds",
    "Per-step time dispatching the training computation (returns before "
    "the device finishes).")
STEP_SYNC_SECONDS = histogram(
    "mxnet_step_sync_seconds",
    "Per-step time blocked on device results (loss fetch / metric "
    "update).")
TRAINER_STEP_SECONDS = histogram(
    "mxnet_trainer_step_seconds",
    "gluon.Trainer.step wall time (gradient reduction + optimizer "
    "update dispatch). The estimator/SPMD loop-level view is "
    "mxnet_step_seconds.")
STEPS_TOTAL = counter(
    "mxnet_steps_total", "Optimizer steps taken.")
STEPS_PER_SECOND = gauge(
    "mxnet_steps_per_second",
    "Inverse wall time of the most recent training step.")
DEVICE_MEM_HIGHWATER = gauge(
    "mxnet_device_mem_highwater_bytes",
    "Device memory high-watermark (peak_bytes_in_use) where the "
    "backend exposes memory_stats; 0 elsewhere.")

MONITOR_STAT = gauge(
    "mxnet_monitor_stat",
    "Latest scalar statistic per op output collected by mx.monitor."
    "Monitor (set at toc()).", labels=("name",))

BULK_SEGMENTS = counter(
    "mxnet_bulk_segments_total",
    "Pending eager-op segments flushed by the lazy bulking engine "
    "(mxnet_tpu/bulk.py), by flush reason: host_read (asnumpy/item/"
    "direct buffer access), max_ops (MXNET_BULK_MAX_OPS reached), "
    "unjittable (an op that cannot trace arrived), mutation (in-place "
    "write to a promised buffer), waitall (engine barrier), autograd "
    "(backward boundary / record-scope transition), cross_thread "
    "(another thread read a promised buffer), param_boundary (per-"
    "layer backward segmentation closed the recorded segment at a "
    "parameter boundary — MXNET_BULK_BACKWARD_SEGMENTS=param).",
    labels=("reason",))
BULK_CACHE_HITS = counter(
    "mxnet_bulk_seg_cache_hits_total",
    "Segment flushes that reused a compiled fused executable (segment-"
    "signature cache hit).")
BULK_CACHE_MISSES = counter(
    "mxnet_bulk_seg_cache_misses_total",
    "Segment flushes that traced + compiled a new fused executable. "
    "Steady-state training should report 0 new misses after warmup.")
BULK_CACHE_SIZE = gauge(
    "mxnet_bulk_seg_cache_size",
    "Compiled fused segment executables held by the bulking engine's "
    "signature cache (LRU-bounded).")
BULK_OPS_PER_SEGMENT = histogram(
    "mxnet_bulk_ops_per_segment",
    "Ops per flushed bulking segment (1 means the flush trigger arrived "
    "before a second op could join).",
    buckets=exponential_buckets(1.0, 2.0, 8))
BULK_BACKWARD_SEGMENTS = counter(
    "mxnet_bulk_backward_segments_total",
    "Per-layer backward-segmentation events under "
    "MXNET_BULK_BACKWARD_SEGMENTS=param (bulk.py), by reason: "
    "param_boundary (a recorded segment was cut because the op stream "
    "crossed a fresh attach_grad leaf with the coalescing floor met — "
    "its gradients will stream during backward; moves in lockstep "
    "with mxnet_bulk_segments_total{reason=param_boundary}, which "
    "counts the same cuts as flushes), coalesced (a parameter "
    "boundary was crossed but the segment's captured parameter bytes "
    "were still under the MXNET_KV_BUCKET_BYTES floor, so the layers "
    "share a segment — the decision the flush counter cannot see).",
    labels=("reason",))

# -- continuous-batching generation engine (serving/generation.py) ----------
GEN_SLOTS_ACTIVE = gauge(
    "mxnet_gen_slots_active",
    "Decode slots currently occupied by an in-flight generation "
    "sequence (<= MXNET_GEN_MAX_SLOTS).")
GEN_QUEUE_DEPTH = gauge(
    "mxnet_gen_queue_depth",
    "Generation requests waiting in the prefill admission queue (the "
    "decode 'queue' is the slot table itself — see "
    "mxnet_gen_slots_active).")
GEN_TOKENS_TOTAL = counter(
    "mxnet_gen_tokens_total",
    "Tokens produced by the generation engine, by phase: 'prefill' "
    "(the first token of each sequence, emitted by the prompt pass) "
    "and 'decode' (every token from the resident decode step).",
    labels=("phase",))
GEN_STEP_SECONDS = histogram(
    "mxnet_gen_step_seconds",
    "Wall time of one generation-engine model execution, by phase "
    "(prefill = one prompt admitted; decode = one iteration over ALL "
    "active slots) — the prefill/decode split of engine time.",
    labels=("phase",),
    buckets=exponential_buckets(0.0005, 2.0, 14))
GEN_TTFT_SECONDS = histogram(
    "mxnet_gen_ttft_seconds",
    "Time-to-first-token per generation request: submit to the first "
    "streamed token (queue wait + prefill).",
    buckets=exponential_buckets(0.001, 2.0, 14))
GEN_ITERATIONS_TOTAL = counter(
    "mxnet_gen_iterations_total",
    "Decode-loop iterations executed (each runs the resident decode "
    "step once over every active slot).")
GEN_ADMISSIONS_TOTAL = counter(
    "mxnet_gen_admissions_total",
    "Generation requests admitted into a decode slot (prefill ran).")
GEN_RETIREMENTS_TOTAL = counter(
    "mxnet_gen_retirements_total",
    "Generation sequences retired from their slot, by reason: eos / "
    "length (max-tokens) / error / cancelled.", labels=("reason",))
GEN_TOKENS_PER_SECOND = gauge(
    "mxnet_gen_tokens_per_second",
    "Aggregate decode throughput over the engine's most recent "
    "iteration window (streamed tokens across all slots).")
GEN_KV_BUCKET_LEN = gauge(
    "mxnet_gen_kv_bucket_len",
    "Current KV-cache capacity bucket (padded sequence length every "
    "slot's cache is allocated at).")
GEN_KV_MIGRATIONS_TOTAL = counter(
    "mxnet_gen_kv_migrations_total",
    "KV-cache capacity-bucket migrations (cache grew to the next "
    "power-of-two length bucket; each switches the engine to that "
    "bucket's pre-compiled decode step).")
GEN_SAMPLED_TOKENS_TOTAL = counter(
    "mxnet_gen_sampled_tokens_total",
    "Tokens emitted by the generation engine, by decode method "
    "(greedy / sample / top_k / top_p) — the on-device sampler keeps "
    "every method inside the compiled step, so the split is free to "
    "observe.", labels=("method",))
GEN_PREFIX_HITS_TOTAL = counter(
    "mxnet_gen_prefix_cache_hits_total",
    "Generation admissions that reused a resident shared-prefix KV "
    "entry (rows copied into the slot instead of re-running prefill "
    "over the prefix).")
GEN_PREFIX_MISSES_TOTAL = counter(
    "mxnet_gen_prefix_cache_misses_total",
    "Generation admissions that found no resident prefix for a "
    "cacheable prompt and ran a full cold prefill (the prefix rows "
    "are inserted for the next request).")
GEN_PREFIX_EVICTIONS_TOTAL = counter(
    "mxnet_gen_prefix_cache_evictions_total",
    "Shared-prefix KV entries evicted (LRU among unreferenced entries "
    "once the cache exceeds MXNET_GEN_PREFIX_CACHE_SLOTS).")
GEN_PREFIX_ROWS = gauge(
    "mxnet_gen_prefix_cache_rows",
    "KV positions (padded prefix rows, summed over resident entries) "
    "currently held in the shared-prefix cache — the device-memory "
    "footprint is rows x layers x heads x head_dim x 2 (K and V).")
GEN_SPEC_PROPOSED_TOKENS_TOTAL = counter(
    "mxnet_gen_spec_proposed_tokens_total",
    "Draft tokens proposed by the speculative-decoding subsystem "
    "(serving/speculation.py): k per speculative slot per iteration, "
    "before the target model's verify pass accepts or rejects them.")
GEN_SPEC_ACCEPTED_TOKENS_TOTAL = counter(
    "mxnet_gen_spec_accepted_tokens_total",
    "Draft tokens ACCEPTED by the verify pass: the draft token equaled "
    "the target's own sampled token at that position under the "
    "request's counter-PRNG key (greedy requests compare against the "
    "argmax). The accept rule makes speculative output byte-identical "
    "to non-speculative output at the same seed.")
GEN_SPEC_REJECTED_TOKENS_TOTAL = counter(
    "mxnet_gen_spec_rejected_tokens_total",
    "Draft tokens rejected by the verify pass (everything proposed "
    "after the first mismatch is discarded and the KV rows it wrote "
    "roll back — see mxnet_gen_kv_rollbacks_total).")
GEN_SPEC_ACCEPT_RATE = gauge(
    "mxnet_gen_spec_accept_rate",
    "Fraction of proposed draft tokens accepted over the engine's "
    "lifetime (accepted / proposed; 0 until the first speculative "
    "iteration). The economics dial of speculative decoding: uplift "
    "~ (1 + k * accept_rate) tokens per target step minus draft cost.")
GEN_SPEC_ACCEPTED_PER_STEP = histogram(
    "mxnet_gen_spec_accepted_per_step",
    "Tokens emitted per speculative slot-step (1 bonus token + the "
    "accepted draft prefix; 1 means every draft was rejected). The "
    "exemplar carries the trace id of the WORST-accepting recent step "
    "(lowest value), so a sagging accept rate points at a concrete "
    "iteration trace.",
    buckets=exponential_buckets(1.0, 2.0, 6), exemplar_pref="min")
GEN_KV_ROLLBACKS_TOTAL = counter(
    "mxnet_gen_kv_rollbacks_total",
    "PagedKVCache.truncate() rollbacks: slot positions rewound after "
    "the verify pass rejected draft tokens (their speculatively "
    "written KV rows become invisible to the position mask and are "
    "overwritten by the next accepted token).")

# -- async device-prefetch input pipeline (io/prefetch.py) ------------------
PREFETCH_QUEUE_DEPTH = gauge(
    "mxnet_prefetch_queue_depth",
    "Device-resident batches currently queued ahead of the training "
    "step by the DevicePrefetcher (<= MXNET_PREFETCH_DEPTH). Pinned at "
    "0 while the consumer outruns the loader — pair with "
    "mxnet_prefetch_stall_seconds to tell which side is the "
    "bottleneck.")
PREFETCH_H2D_SECONDS = histogram(
    "mxnet_prefetch_h2d_seconds",
    "Per-batch host->device placement time inside the prefetch thread "
    "(sharded device_put / commit of the already-fetched batch). This "
    "work overlaps the in-flight step; it only costs wall-clock when "
    "it exceeds the step time.",
    buckets=exponential_buckets(0.0005, 2.0, 14))
PREFETCH_STALL_SECONDS = histogram(
    "mxnet_prefetch_stall_seconds",
    "Per-step time the TRAINING LOOP spent blocked waiting for the "
    "prefetcher to produce its batch — the key input-pipeline number: "
    "~0 means input is fully hidden behind device compute; a majority "
    "share of mxnet_step_seconds means the loader (or H2D) is the "
    "bottleneck.",
    buckets=exponential_buckets(0.0005, 2.0, 14))
PREFETCH_BATCHES_TOTAL = counter(
    "mxnet_prefetch_batches_total",
    "Batches fetched, placed on device, and queued by the "
    "DevicePrefetcher background thread.")
PREFETCH_INVALIDATED = counter(
    "mxnet_prefetch_invalidated_total",
    "Prefetched-batch invalidations (the queue is flushed and the "
    "producer reseeks), by reason: 'seek' (non-consecutive step "
    "request — checkpoint restore / resume), 'salt' (HealthGuard "
    "rewind perturbed the replay salt), 'close' (pipeline shutdown).",
    labels=("reason",))

# -- serving resilience (serving/server.py + serving/replica.py) ------------
SERVING_RECOVERIES_TOTAL = counter(
    "mxnet_serving_recoveries_total",
    "Generation sequences resurrected after a fault, by recovery site: "
    "'decode' (a decode-step fault — the sequence re-prefills "
    "prompt+emitted on a healthy replica and resumes), 'worker' (a "
    "slot-resident sequence evacuated from a dead worker replica), "
    "'queue' (a not-yet-admitted request requeued from a dead "
    "replica's admission queue).", labels=("site",))
SERVING_RECOVERED_TOKENS = counter(
    "mxnet_serving_recovered_tokens_total",
    "Tokens already emitted by sequences at the moment they were "
    "resurrected (the re-prefill work recovery pays; the TokenStream "
    "index dedupe guarantees clients never see them twice).")
SERVING_RECOVERY_SECONDS = histogram(
    "mxnet_serving_recovery_seconds",
    "Per-sequence recovery latency: fault observed to the resurrected "
    "sequence's next streamed token (re-queue wait + re-prefill).",
    buckets=exponential_buckets(0.001, 2.0, 14))
SERVING_STREAM_DUPES_DROPPED = counter(
    "mxnet_serving_stream_dupes_dropped_total",
    "Duplicate tokens dropped at the TokenStream index boundary (a "
    "recovered producer re-emitted an index the consumer already has). "
    "Nonzero means the dedupe guard did real work; clients still see "
    "each index exactly once.")
SERVING_DRAINING = gauge(
    "mxnet_serving_draining",
    "1 while the serving process is draining (SIGTERM received: "
    "admissions shed with 429, resident work finishing, readiness "
    "503 / liveness 200).")


def record_step(total: float, data: float = 0.0, dispatch: float = 0.0,
                sync: Optional[float] = None, count: int = 1) -> None:
    """Observe one training step's phase breakdown (seconds).  Called by
    the loop owners (SPMDTrainer.step, the estimator fit loop); tools
    read the sums back with :func:`hist_stats`.  ``count`` > 1 marks a
    fused multi-step program (one observation, N optimizer steps)."""
    STEP_SECONDS.observe(total)
    STEP_DATA_SECONDS.observe(data)
    STEP_DISPATCH_SECONDS.observe(dispatch)
    if sync is not None:
        STEP_SYNC_SECONDS.observe(sync)
    STEPS_TOTAL.inc(count)
    if total > 0:
        STEPS_PER_SECOND.set(count / total)


_HIGHWATER_LAST = [0.0]      # monotonic seconds of the last real query
_HIGHWATER_MIN_INTERVAL_S = 1.0


def record_device_highwater() -> None:
    """Update the device-memory high-watermark gauge from
    ``torch.cuda.max_memory_allocated`` on the current card; nothing
    without CUDA (the JAX package's behaviour where ``memory_stats()`` is
    None). Sampled at most once per second, as the JAX package does."""
    now = time.monotonic()
    if now - _HIGHWATER_LAST[0] < _HIGHWATER_MIN_INTERVAL_S:
        return
    _HIGHWATER_LAST[0] = now
    import torch
    if not torch.cuda.is_available():
        return
    peak = torch.cuda.max_memory_allocated()
    if peak:
        DEVICE_MEM_HIGHWATER.set(float(peak))


def inc_op(name: str) -> None:
    """Count one op dispatch (called from ndarray.register.invoke)."""
    b = _OP_CHILDREN.get(name)
    if b is None:
        b = _OP_CHILDREN[name] = OPS_DISPATCHED.labels(op=name)
    b.inc()


# ---------------------------------------------------------------------------
# Periodic logger thread (MXNET_METRICS_LOG_INTERVAL)
# ---------------------------------------------------------------------------

_LOGGER_STATE: Dict[str, Any] = {"thread": None, "stop": None}


def _nonzero_summary() -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, fam in dump_json().items():
        series = []
        for s in fam["series"]:
            if fam["type"] == "histogram":
                if s.get("count"):
                    series.append({"labels": s["labels"],
                                   "sum": round(s["sum"], 6),
                                   "count": s["count"]})
            elif s.get("value"):
                series.append({"labels": s["labels"],
                               "value": s["value"]})
        if series:
            out[name] = series
    return out


def start_logger(interval: Optional[float] = None) -> bool:
    """Start the background metrics logger (idempotent). Returns True if
    a thread is running after the call."""
    if interval is None:
        interval = float(getenv("MXNET_METRICS_LOG_INTERVAL", 0))
    if interval <= 0:
        return False
    if _LOGGER_STATE["thread"] is not None and \
            _LOGGER_STATE["thread"].is_alive():
        return True
    import logging
    log = logging.getLogger("mxnet_tpu_torch.metrics")
    stop = threading.Event()

    def _run() -> None:
        while not stop.wait(interval):
            try:
                log.info("metrics %s", json.dumps(_nonzero_summary()))
            except Exception:   # noqa: BLE001 - never kill the app
                pass

    th = threading.Thread(target=_run, name="mxnet-metrics-logger",
                          daemon=True)
    _LOGGER_STATE["thread"], _LOGGER_STATE["stop"] = th, stop
    th.start()
    return True


def stop_logger() -> None:
    stop = _LOGGER_STATE["stop"]
    if stop is not None:
        stop.set()
    th = _LOGGER_STATE["thread"]
    if th is not None:
        th.join(timeout=2.0)
    _LOGGER_STATE["thread"] = _LOGGER_STATE["stop"] = None


if float(getenv("MXNET_METRICS_LOG_INTERVAL", 0)) > 0:
    start_logger()
