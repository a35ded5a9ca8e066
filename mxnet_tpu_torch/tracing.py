"""Distributed tracing — sampled spans with cross-wire propagation.

Counterpart of ``mxnet_tpu/tracing.py``, an own copy of the whole module:

* :func:`span` (context manager and decorator; the first span on a thread
  with no active trace starts one, head-sampled by ``MXNET_TRACE_SAMPLE``;
  nested spans parent through a :mod:`contextvars` context),
  :func:`child_span` (never starts a trace), :func:`record_span` (an
  interval measured elsewhere, such as a queue wait);
* finished spans in a ring buffer of ``MXNET_TRACE_BUFFER_SPANS``, with
  tail retention: a trace that lost the coin flip keeps its spans pending
  and is upgraded into the ring if any span errors or runs past
  ``MXNET_TRACE_SLOW_MS``;
* propagation: :func:`capture` where work is submitted, :func:`attach`
  where it runs, and the W3C ``traceparent`` form
  (``00-<32 hex trace>-<16 hex span>-<2 hex flags>``,
  :func:`traceparent` / :func:`parse_traceparent`) across the HTTP front
  end;
* export: :func:`spans`, :func:`export_trace_events` (Chrome/Perfetto
  trace-event JSON, served at ``GET /v1/traces``) and
  :func:`active_spans_tree`.

Two parts differ from the JAX package, whose profiler
(``mxnet_tpu/profiler.py``) the port lacks (ROADMAP Queue A 14): finished
spans are not mirrored into a running profiler's event list, and
:func:`export_trace_events` counts time from the port's own epoch (this
module's import) instead of the profiler's.

With ``MXNET_TRACE_SAMPLE=0`` tracing is off: :func:`span` returns a
shared no-op after one flag read and nothing is recorded.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import itertools
import os
import random
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

from .base import getenv, register_env

__all__ = ["span", "child_span", "capture", "attach", "current_context",
           "current_trace_id", "traceparent", "parse_traceparent",
           "record_span", "spans", "export_trace_events",
           "active_spans_tree", "configure", "reset", "SpanContext"]

register_env(
    "MXNET_TRACE_SAMPLE", 1.0,
    "Head-sampling probability per trace for the distributed-tracing "
    "span runtime (mxnet_tpu_torch.tracing). 1.0 records every trace, 0 "
    "disables tracing entirely (spans become no-ops and nothing is "
    "recorded); in between, each new trace keeps its spans with this "
    "probability — except traces containing an error or a span slower "
    "than MXNET_TRACE_SLOW_MS, which are tail-upgraded and kept "
    "regardless.")
register_env(
    "MXNET_TRACE_BUFFER_SPANS", 4096,
    "Capacity of the in-process finished-span ring buffer. Oldest "
    "spans are overwritten; GET /v1/traces, tools/trace_dump.py and "
    "tracing.export_trace_events() export whatever is resident.")
register_env(
    "MXNET_TRACE_SLOW_MS", 100.0,
    "Tail-retention threshold for the span runtime: a span that runs "
    "at least this many milliseconds (or exits with an exception) "
    "upgrades its whole trace into the ring buffer even when the "
    "trace lost the MXNET_TRACE_SAMPLE coin flip, so slow/failed "
    "traces survive low sample rates.")

# spans a not-yet-upgraded trace may hold in its pending list before the
# oldest are dropped (bounds memory for long-lived unsampled traces)
_PENDING_CAP = 256

_CTX: contextvars.ContextVar[Optional["SpanContext"]] = \
    contextvars.ContextVar("mxnet_trace_ctx", default=None)


class _Runtime:
    """Tracing configuration + the ring buffer (rebuilt by configure())."""

    __slots__ = ("sample", "cap", "slow_s", "buf", "seq", "rng")

    def __init__(self, sample: Optional[float] = None,
                 buffer_spans: Optional[int] = None,
                 slow_ms: Optional[float] = None) -> None:
        if sample is None:
            sample = float(getenv("MXNET_TRACE_SAMPLE", 1.0))
        if buffer_spans is None:
            buffer_spans = int(getenv("MXNET_TRACE_BUFFER_SPANS", 4096))
        if slow_ms is None:
            slow_ms = float(getenv("MXNET_TRACE_SLOW_MS", 100.0))
        self.sample = max(0.0, min(1.0, float(sample)))
        self.cap = max(1, int(buffer_spans))
        self.slow_s = max(0.0, float(slow_ms)) / 1e3
        self.buf: List[Optional[Dict[str, Any]]] = [None] * self.cap
        # one atomic fetch per finished span; the slot store is a plain
        # list item assignment — the append path takes no lock
        self.seq = itertools.count()
        self.rng = random.Random(os.urandom(8))


_RT = _Runtime()

# the clock origin of export_trace_events (perf_counter seconds)
_EPOCH = time.perf_counter()

# currently-open spans, span_id -> _Span (watchdog dumps walk this)
_OPEN: Dict[str, "_Span"] = {}


def configure(sample: Optional[float] = None,
              buffer_spans: Optional[int] = None,
              slow_ms: Optional[float] = None) -> None:
    """(Re)configure the runtime; unset arguments re-read their env
    vars.  Discards recorded spans (fresh ring buffer)."""
    global _RT
    _RT = _Runtime(sample, buffer_spans, slow_ms)


def reset() -> None:
    """Drop every recorded span (keeps the current configuration)."""
    rt = _RT
    rt.buf = [None] * rt.cap
    rt.seq = itertools.count()


class _TraceState:
    """Mutable per-trace retention state shared by the trace's spans."""

    __slots__ = ("trace_id", "sampled", "upgraded", "dead", "pending",
                 "lock")

    def __init__(self, trace_id: str, sampled: bool) -> None:
        self.trace_id = trace_id
        self.sampled = sampled
        self.upgraded = False
        self.dead = False          # local root ended without retention
        self.pending: List[Dict[str, Any]] = []
        self.lock = threading.Lock()

    @property
    def recording(self) -> bool:
        return self.sampled or self.upgraded


class SpanContext:
    """Immutable propagation handle: (trace_id, span_id, shared state).

    ``capture()`` one where work is submitted; ``attach()`` it where the
    work runs (another thread, a queue consumer); ``traceparent`` is its
    W3C wire form.
    """

    __slots__ = ("trace_id", "span_id", "state")

    def __init__(self, trace_id: str, span_id: str,
                 state: _TraceState) -> None:
        self.trace_id = trace_id
        self.span_id = span_id
        self.state = state

    @property
    def sampled(self) -> bool:
        return self.state.recording

    @property
    def traceparent(self) -> str:
        flags = "01" if self.state.recording else "00"
        return f"00-{self.trace_id}-{self.span_id}-{flags}"

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"SpanContext(trace={self.trace_id[:8]}…, "
                f"span={self.span_id}, sampled={self.sampled})")


def _emit(rec: Dict[str, Any]) -> None:
    """Commit one finished-span record to the ring."""
    rt = _RT
    i = next(rt.seq)
    rec["seq"] = i
    rt.buf[i % rt.cap] = rec


def _upgrade(st: _TraceState) -> None:
    """Tail-based retention: flush the trace's pending spans into the
    ring buffer and record everything that follows directly."""
    with st.lock:
        if st.upgraded:
            return
        st.upgraded = True
        st.dead = False
        pending, st.pending = st.pending, []
    for rec in pending:
        _emit(rec)


def _gen_id(nibbles: int) -> str:
    return f"{_RT.rng.getrandbits(nibbles * 4):0{nibbles}x}"


class _NoopSpan:
    """Shared do-nothing span (tracing off, or child-only miss)."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def __call__(self, fn: Callable) -> Callable:
        return fn

    def add_link(self, trace_id: Optional[str]) -> None:
        pass

    def set_attr(self, **attrs: Any) -> None:
        pass

    trace_id = None
    span_id = None


_NOOP = _NoopSpan()


class _Span:
    """One live span: context manager and decorator."""

    __slots__ = ("name", "attrs", "links", "trace_id", "span_id",
                 "parent_id", "state", "t_begin", "error", "_token",
                 "_root", "_thread")

    def __init__(self, name: str, attrs: Dict[str, Any]) -> None:
        self.name = name
        self.attrs = attrs
        self.links: List[str] = []
        self.error: Optional[str] = None

    # -- decorator form ------------------------------------------------
    def __call__(self, fn: Callable) -> Callable:
        name, attrs = self.name, self.attrs

        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            with span(name, **attrs):
                return fn(*args, **kwargs)
        return wrapper

    # -- context-manager form --------------------------------------------
    def __enter__(self) -> "_Span":
        parent = _CTX.get()
        if parent is None:
            rt = _RT
            st = _TraceState(_gen_id(32), rt.rng.random() < rt.sample)
            self.parent_id = ""
            self._root = True
        else:
            st = parent.state
            self.parent_id = parent.span_id
            self._root = False
        self.state = st
        self.trace_id = st.trace_id
        self.span_id = _gen_id(16)
        self._thread = threading.current_thread().name
        self._token = _CTX.set(
            SpanContext(self.trace_id, self.span_id, st))
        self.t_begin = time.perf_counter()
        if not st.dead:
            _OPEN[self.span_id] = self
        return self

    def __exit__(self, et: Any, ev: Any, tb: Any) -> bool:
        t_end = time.perf_counter()
        _CTX.reset(self._token)
        _OPEN.pop(self.span_id, None)
        st = self.state
        if et is not None and self.error is None:
            self.error = f"{getattr(et, '__name__', et)}: {ev}"
        if not st.dead or st.recording:
            rec = self._record(t_end)
            if st.recording:
                _emit(rec)
            elif not st.dead:
                with st.lock:
                    st.pending.append(rec)
                    if len(st.pending) > _PENDING_CAP:
                        del st.pending[0]
                if self.error is not None \
                        or (t_end - self.t_begin) >= _RT.slow_s:
                    _upgrade(st)
        if self._root and not st.recording:
            # trace ended neither sampled nor upgraded: drop it
            st.dead = True
            with st.lock:
                st.pending = []
        return False

    def _record(self, t_end: float) -> Dict[str, Any]:
        rec: Dict[str, Any] = {
            "name": self.name, "trace_id": self.trace_id,
            "span_id": self.span_id, "parent_id": self.parent_id,
            "t_begin": self.t_begin, "t_end": t_end,
            "tid": threading.get_ident() % 100000,
            "thread": self._thread, "attrs": self.attrs,
        }
        if self.links:
            rec["links"] = list(self.links)
        if self.error is not None:
            rec["status"] = "error"
            rec["error"] = self.error
        else:
            rec["status"] = "ok"
        return rec

    # -- span-local mutation -----------------------------------------------
    def add_link(self, trace_id: Optional[str]) -> None:
        """Link another trace (engine iteration -> resident requests)."""
        if trace_id:
            self.links.append(trace_id)

    def set_attr(self, **attrs: Any) -> None:
        self.attrs.update(attrs)


def span(name: str, **attrs: Any):
    """Open a span: ``with span("prefill", req=rid): ...`` or
    ``@span("checkpoint.save")``.  With no active trace this starts a
    new head-sampled one; nested calls parent automatically."""
    if _RT.sample <= 0.0:
        return _NOOP
    return _Span(name, attrs)


def child_span(name: str, **attrs: Any):
    """Like :func:`span` but never *starts* a trace: a no-op unless a
    trace is already active.  For hot internal sites (bulk flushes, kv
    wire ops) that should appear inside request/step traces without
    minting a trace of their own per call."""
    if _RT.sample <= 0.0 or _CTX.get() is None:
        return _NOOP
    return _Span(name, attrs)


def record_span(name: str, begin: float, end: float,
                ctx: Optional[SpanContext] = None,
                **attrs: Any) -> None:
    """Emit a span for an interval measured elsewhere (queue waits:
    begin/end are ``time.perf_counter()`` values).  ``ctx`` parents it;
    with ``ctx=None`` the currently-attached context is used, and with
    no trace active at all it is dropped."""
    if _RT.sample <= 0.0:
        return
    if ctx is None:
        ctx = _CTX.get()
    if ctx is None:
        return
    st = ctx.state
    if st.dead and not st.recording:
        return
    rec: Dict[str, Any] = {
        "name": name, "trace_id": ctx.trace_id,
        "span_id": _gen_id(16), "parent_id": ctx.span_id,
        "t_begin": begin, "t_end": end,
        "tid": threading.get_ident() % 100000,
        "thread": threading.current_thread().name,
        "attrs": attrs, "status": "ok",
    }
    if st.recording:
        _emit(rec)
    else:
        with st.lock:
            st.pending.append(rec)
            if len(st.pending) > _PENDING_CAP:
                del st.pending[0]
        if (end - begin) >= _RT.slow_s:
            _upgrade(st)


# ---------------------------------------------------------------------------
# context propagation
# ---------------------------------------------------------------------------

def current_context() -> Optional[SpanContext]:
    """The active span's context (None when untraced)."""
    return _CTX.get()


def current_trace_id() -> Optional[str]:
    """Trace id of the active trace — metric exemplars pass this."""
    ctx = _CTX.get()
    return ctx.trace_id if ctx is not None else None


def capture() -> Optional[SpanContext]:
    """Snapshot the active context for an explicit hand-off (store it
    on the queue item / request object at submit time)."""
    return _CTX.get()


@contextlib.contextmanager
def attach(ctx: Optional[SpanContext]) -> Iterator[None]:
    """Run the body under ``ctx`` (a :func:`capture` snapshot or a
    :func:`parse_traceparent` result).  ``attach(None)`` is a no-op, so
    call sites need no conditional."""
    if ctx is None:
        yield
        return
    token = _CTX.set(ctx)
    try:
        yield
    finally:
        _CTX.reset(token)


def traceparent() -> Optional[str]:
    """W3C ``traceparent`` header for the active context, or None."""
    ctx = _CTX.get()
    return ctx.traceparent if ctx is not None else None


def parse_traceparent(header: Optional[str]) -> Optional[SpanContext]:
    """Parse a ``00-<trace>-<span>-<flags>`` header into an attachable
    remote context (spans opened under it become remote children).
    Malformed input — or tracing off — returns None."""
    if not header or _RT.sample <= 0.0:
        return None
    parts = header.strip().lower().split("-")
    if len(parts) != 4:
        return None
    ver, tid, sid, flags = parts
    if len(ver) != 2 or len(tid) != 32 or len(sid) != 16 \
            or len(flags) != 2:
        return None
    try:
        int(tid, 16), int(sid, 16), int(flags, 16)
    except ValueError:
        return None
    if int(tid, 16) == 0 or int(sid, 16) == 0:
        return None
    st = _TraceState(tid, bool(int(flags, 16) & 1))
    return SpanContext(tid, sid, st)


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def spans(trace_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """Recorded spans, oldest first (optionally one trace's)."""
    rt = _RT
    out = [r for r in list(rt.buf) if r is not None]
    if trace_id is not None:
        out = [r for r in out if r["trace_id"] == trace_id]
    out.sort(key=lambda r: r["seq"])
    return out


def export_trace_events() -> Dict[str, Any]:
    """Chrome/Perfetto trace-event JSON in the JAX package's shape, in
    microseconds from the port's epoch (:data:`_EPOCH`)."""
    t0 = _EPOCH
    events: List[Dict[str, Any]] = [
        {"name": "process_name", "ph": "M", "pid": 0,
         "args": {"name": "mxnet_tpu_torch"}},
    ]
    for rec in spans():
        args: Dict[str, Any] = {
            "trace_id": rec["trace_id"], "span_id": rec["span_id"],
            "parent_id": rec["parent_id"], "status": rec["status"],
            "thread": rec["thread"],
        }
        if rec.get("error"):
            args["error"] = rec["error"]
        if rec.get("links"):
            args["links"] = rec["links"]
        for k, v in rec["attrs"].items():
            args.setdefault(k, v if isinstance(
                v, (int, float, bool, str, type(None))) else str(v))
        events.append({
            "name": rec["name"], "cat": "trace", "ph": "X",
            "ts": (rec["t_begin"] - t0) * 1e6,
            "dur": max(0.0, (rec["t_end"] - rec["t_begin"]) * 1e6),
            "pid": 0, "tid": rec["tid"], "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def active_spans_tree() -> List[str]:
    """The currently-open spans as indented text lines, grouped by
    trace — the hang watchdog appends this to its diagnostic dump so a
    stall names the span it wedged in.  Never raises."""
    try:
        now = time.perf_counter()
        open_spans = [s for s in list(_OPEN.values())
                      if getattr(s, "span_id", None) is not None]
        by_id = {s.span_id: s for s in open_spans}
        children: Dict[str, List[_Span]] = {}
        roots: List[_Span] = []
        for s in open_spans:
            if s.parent_id and s.parent_id in by_id:
                children.setdefault(s.parent_id, []).append(s)
            else:
                roots.append(s)
        roots.sort(key=lambda s: (s.trace_id, s.t_begin))
        lines: List[str] = []

        def walk(s: "_Span", depth: int) -> None:
            age_ms = (now - s.t_begin) * 1e3
            attrs = " ".join(f"{k}={v}" for k, v in s.attrs.items())
            lines.append(
                f"{'  ' * depth}{s.name} trace={s.trace_id[:8]} "
                f"span={s.span_id[:8]} +{age_ms:.0f}ms "
                f"thread={s._thread}" + (f" {attrs}" if attrs else ""))
            for c in sorted(children.get(s.span_id, []),
                            key=lambda x: x.t_begin):
                walk(c, depth + 1)

        for r in roots:
            walk(r, 0)
        return lines
    except Exception:   # noqa: BLE001 - diagnostics must never raise
        return []
