"""Dynamic micro-batching: bucket policy, bounded queue, load shedding.

Counterpart of ``mxnet_tpu/serving/batching.py`` (``OverloadError``,
``_pow2_buckets``, ``BucketPolicy``, ``Request``, ``DynamicBatcher``) with
the same padding, bucket and shedding rules:

* requests enter a BOUNDED queue; a full queue sheds the newcomer
  immediately,
* the batcher flushes a batch when a bucket fills OR the oldest request
  has waited ``MXNET_SERVING_BATCH_TIMEOUT_MS``,
* a request whose deadline passed while queued is shed at dequeue time,
* during a drain (:meth:`DynamicBatcher.start_drain`) a new request is
  shed at submit while queued ones keep flowing.

Shed requests fail with :class:`OverloadError`. :class:`SlotScheduler` is
the generation engine's prefill queue and decode slot table
(``batching.py:463``), with the same shed rules. The serving families of
the JAX package (``batching.py:213-238``) are declared here and fed as
there; each request captures the submitter's trace context, and its
queue wait is a retroactive ``queue.wait`` span in that trace.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as _np

from .. import metrics as _metrics
from .. import tracing as _tracing
from ..base import MXNetError, getenv, register_env

__all__ = ["BucketPolicy", "DynamicBatcher", "OverloadError", "Request",
           "SlotScheduler"]

register_env("MXNET_SERVING_MAX_BATCH", 32,
             "Largest micro-batch the serving batcher assembles (also the "
             "top batch bucket when no explicit bucket list is given).")
register_env("MXNET_SERVING_BATCH_TIMEOUT_MS", 5,
             "Micro-batching window: a queued request is batched with "
             "arrivals for at most this long before the batch flushes "
             "partially full. 0 flushes immediately.")
register_env("MXNET_SERVING_QUEUE_LIMIT", 256,
             "Bound on queued serving requests: past it, new requests are "
             "shed immediately with a structured OverloadError.")
register_env("MXNET_SERVING_DEADLINE_MS", 0,
             "Default per-request serving deadline: a request still queued "
             "after this long is shed. 0 (default) disables.")


class OverloadError(MXNetError):
    """A request was shed by the serving layer (NOT a server fault).

    ``reason`` is ``"queue_full"`` (shed at submit), ``"deadline"``
    (shed at dequeue) or ``"draining"`` (shed at submit during a drain);
    ``retry_after_ms`` is a backoff hint.
    """

    def __init__(self, reason: str, queue_depth: int = 0,
                 retry_after_ms: float = 0.0) -> None:
        self.reason = reason
        self.queue_depth = queue_depth
        self.retry_after_ms = retry_after_ms
        super().__init__(
            f"request shed ({reason}); queue_depth={queue_depth} "
            f"retry_after_ms={retry_after_ms:.0f}")

    def to_json(self) -> Dict[str, Any]:
        """The shed payload of the HTTP front end's 429."""
        return {"error": "overloaded", "reason": self.reason,
                "queue_depth": self.queue_depth,
                "retry_after_ms": round(self.retry_after_ms, 1)}


def _pow2_buckets(max_batch: int) -> Tuple[int, ...]:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


class BucketPolicy:
    """Pad-to-bucket shape policy: every batch has a shape from the
    finite grid ``batch_buckets x length_buckets``.

    * ``batch_buckets`` — allowed batch sizes; a batch of n requests pads
      (by repeating its first sample) up to the smallest bucket >= n.
    * ``pad_axis``/``length_buckets`` — opt-in variable length: the
      ``pad_axis`` dim of the FIRST input rounds up to a length bucket,
      padded with ``pad_value``; longer samples are rejected.
    """

    def __init__(self, max_batch: Optional[int] = None,
                 batch_buckets: Optional[Sequence[int]] = None,
                 pad_axis: Optional[int] = None,
                 length_buckets: Optional[Sequence[int]] = None,
                 pad_value: float = 0.0) -> None:
        if batch_buckets is None:
            if max_batch is None:
                max_batch = int(getenv("MXNET_SERVING_MAX_BATCH", 32))
            batch_buckets = _pow2_buckets(int(max_batch))
        self.batch_buckets = tuple(sorted({int(b) for b in batch_buckets}))
        if not self.batch_buckets or self.batch_buckets[0] < 1:
            raise MXNetError(f"bad batch_buckets {batch_buckets!r}")
        self.max_batch = self.batch_buckets[-1]
        if (length_buckets is None) != (pad_axis is None):
            raise MXNetError("pad_axis and length_buckets go together")
        self.pad_axis = pad_axis
        self.length_buckets = (tuple(sorted({int(b) for b in
                                             length_buckets}))
                               if length_buckets is not None else None)
        self.pad_value = pad_value

    def n_buckets(self) -> int:
        return len(self.batch_buckets) * (len(self.length_buckets)
                                          if self.length_buckets else 1)

    def round_batch(self, n: int) -> int:
        """Smallest batch bucket >= n (n must not exceed max_batch)."""
        for b in self.batch_buckets:
            if b >= n:
                return b
        raise MXNetError(f"batch {n} exceeds top bucket {self.max_batch}")

    def _round_length(self, length: int) -> int:
        for b in self.length_buckets:
            if b >= length:
                return b
        raise MXNetError(
            f"sample length {length} exceeds the top length bucket "
            f"{self.length_buckets[-1]}; longer requests must be "
            f"rejected, or the bucket grid becomes unbounded")

    def bucket_key(self, sample: Sequence[_np.ndarray]
                   ) -> Tuple[Tuple[Tuple[int, ...], str], ...]:
        """The padded (shape, dtype) per input — batches only ever mix
        requests with the same key."""
        key = []
        for i, a in enumerate(sample):
            shape = list(a.shape)
            if i == 0 and self.pad_axis is not None:
                shape[self.pad_axis] = self._round_length(
                    shape[self.pad_axis])
            key.append((tuple(shape), str(a.dtype)))
        return tuple(key)

    def _pad_sample(self, a: _np.ndarray,
                    shape: Tuple[int, ...]) -> _np.ndarray:
        if tuple(a.shape) == shape:
            return a
        pad = [(0, t - s) for s, t in zip(a.shape, shape)]
        return _np.pad(a, pad, constant_values=self.pad_value)

    def assemble(self, samples: List[Sequence[_np.ndarray]],
                 key: Tuple[Tuple[Tuple[int, ...], str], ...]
                 ) -> Tuple[List[_np.ndarray], int]:
        """Stack ``samples`` (all sharing ``key``) into bucket-padded
        batch arrays; returns ``(arrays, padded_batch_size)``.  Padding
        rows repeat the first sample."""
        n = len(samples)
        nb = self.round_batch(n)
        out = []
        for i, (shape, dtype) in enumerate(key):
            rows = [self._pad_sample(_np.asarray(s[i]), shape)
                    for s in samples]
            rows.extend([rows[0]] * (nb - n))
            out.append(_np.stack(rows, axis=0).astype(dtype, copy=False))
        return out, nb

    def warmup_signatures(self, sample_signature: Sequence[
            Tuple[Tuple[int, ...], Any]]) -> List[List[Tuple[
                Tuple[int, ...], Any]]]:
        """Every batched input signature the policy can produce.
        ``sample_signature`` is per-input (shape_without_batch, dtype)."""
        lengths = (self.length_buckets if self.length_buckets is not None
                   else [None])
        sigs = []
        for nb in self.batch_buckets:
            for lb in lengths:
                sig = []
                for i, (shape, dtype) in enumerate(sample_signature):
                    shape = list(shape)
                    if i == 0 and lb is not None:
                        shape[self.pad_axis] = lb
                    sig.append(((nb,) + tuple(shape), dtype))
                sigs.append(sig)
        return sigs


# serving metric families (eager, like the core families in metrics.py)
QUEUE_DEPTH = _metrics.gauge(
    "mxnet_serving_queue_depth",
    "Requests currently waiting in the serving batcher queue.")
QUEUE_WAIT_SECONDS = _metrics.histogram(
    "mxnet_serving_queue_wait_seconds",
    "Per-request wait from submit to batch assembly.")
BATCH_SIZE = _metrics.histogram(
    "mxnet_serving_batch_size",
    "Real (pre-padding) request count per assembled serving batch.",
    buckets=_metrics.exponential_buckets(1, 2, 11))
SHED_TOTAL = _metrics.counter(
    "mxnet_serving_shed_total",
    "Requests shed by the serving layer, by reason (queue_full at "
    "submit; deadline at dequeue).", labels=("reason",))
REQUESTS_TOTAL = _metrics.counter(
    "mxnet_serving_requests_total",
    "Serving requests by terminal status (ok / shed / error).",
    labels=("status",))
INFER_SECONDS = _metrics.histogram(
    "mxnet_serving_inference_seconds",
    "Wall time of one batched model execution (padded batch).")
BUCKET_COMPILES = _metrics.counter(
    "mxnet_serving_bucket_compiles_total",
    "First-time executions per padded batch signature — each is one "
    "compiled executable; bounded by the bucket grid.",
    labels=("bucket",))


class Request:
    """One queued inference request: the sample (tuple of per-input
    arrays WITHOUT the batch dim), its future, timing metadata, and the
    trace context captured at submit (the worker attaches it)."""

    __slots__ = ("sample", "key", "future", "enqueue_t", "deadline_t",
                 "trace")

    def __init__(self, sample: Sequence[_np.ndarray], key: Any,
                 future: Any, deadline_t: Optional[float]) -> None:
        self.sample = sample
        self.key = key
        self.future = future
        self.enqueue_t = time.monotonic()
        self.deadline_t = deadline_t
        self.trace = _tracing.capture()


def _fail(r: Request, exc: Exception) -> bool:
    """Set ``exc`` on the request's future; False if it was done."""
    try:
        r.future.set_exception(exc)
    except Exception:   # noqa: BLE001 - cancelled/done race
        return False
    return True


class DynamicBatcher:
    """Bounded queue + micro-batch assembly."""

    def __init__(self, policy: BucketPolicy,
                 timeout_ms: Optional[float] = None,
                 queue_limit: Optional[int] = None) -> None:
        self.policy = policy
        if timeout_ms is None:
            timeout_ms = float(getenv("MXNET_SERVING_BATCH_TIMEOUT_MS", 5))
        if queue_limit is None:
            queue_limit = int(getenv("MXNET_SERVING_QUEUE_LIMIT", 256))
        self.timeout_s = max(0.0, timeout_ms / 1e3)
        self.queue_limit = queue_limit
        self._q: List[Request] = []
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._closed = False
        self._draining = False

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    @property
    def draining(self) -> bool:
        return self._draining

    def start_drain(self) -> None:
        """Stop admitting: new submits shed with
        ``OverloadError("draining")`` while queued requests keep flowing
        to the workers."""
        with self._lock:
            self._draining = True

    def reopen(self) -> None:
        """Clear the closed and draining flags (the breaker reset
        re-admits traffic through the same batcher)."""
        with self._lock:
            self._closed = False
            self._draining = False

    def requeue(self, reqs: Sequence[Request]) -> None:
        """Front-insert requests a dying worker abandoned mid-batch
        (unresolved futures only: the future is the exactly-once
        boundary)."""
        live = [r for r in reqs if not r.future.done()]
        if not live:
            return
        with self._lock:
            if self._closed:
                for r in live:
                    if _fail(r, MXNetError("serving batcher closed with "
                                           "the request still queued")):
                        REQUESTS_TOTAL.labels(status="error").inc()
                return
            self._q[:0] = live
            QUEUE_DEPTH.set(len(self._q))
            self._nonempty.notify_all()

    def submit(self, req: Request) -> None:
        """Enqueue or shed immediately (OverloadError set on the future
        AND raised)."""
        with self._lock:
            if self._closed:
                raise MXNetError("serving batcher is closed")
            if self._draining:
                err = OverloadError("draining", queue_depth=len(self._q),
                                    retry_after_ms=1e3)
                SHED_TOTAL.labels(reason="draining").inc()
                REQUESTS_TOTAL.labels(status="shed").inc()
                req.future.set_exception(err)
                raise err
            if len(self._q) >= self.queue_limit:
                # abandoned (done) requests must not hold sheds high
                self._q[:] = [r for r in self._q if not r.future.done()]
                QUEUE_DEPTH.set(len(self._q))
            if len(self._q) >= self.queue_limit:
                depth = len(self._q)
                err = OverloadError(
                    "queue_full", queue_depth=depth,
                    retry_after_ms=1e3 * self.timeout_s * max(
                        1, depth // max(1, self.policy.max_batch)))
                SHED_TOTAL.labels(reason="queue_full").inc()
                REQUESTS_TOTAL.labels(status="shed").inc()
                req.future.set_exception(err)
                raise err
            self._q.append(req)
            QUEUE_DEPTH.set(len(self._q))
            self._nonempty.notify()

    def close(self, error: Optional[Exception] = None) -> None:
        """Stop accepting work and wake the consumers; queued requests
        fail with a server-stopped error (or ``error``)."""
        exc = error if error is not None else MXNetError(
            "serving batcher closed with the request still queued")
        with self._lock:
            self._closed = True
            for r in self._q:
                if _fail(r, exc):
                    REQUESTS_TOTAL.labels(status="error").inc()
            self._q.clear()
            QUEUE_DEPTH.set(0)
            self._nonempty.notify_all()

    def _shed_expired(self, now: float) -> None:
        keep = []
        for r in self._q:
            if r.future.done():
                continue
            if r.deadline_t is not None and now > r.deadline_t:
                if _fail(r, OverloadError(
                        "deadline", queue_depth=len(self._q),
                        retry_after_ms=1e3 * self.timeout_s)):
                    SHED_TOTAL.labels(reason="deadline").inc()
                    REQUESTS_TOTAL.labels(status="shed").inc()
            else:
                keep.append(r)
        self._q[:] = keep
        QUEUE_DEPTH.set(len(self._q))

    def next_batch(self, on_take: Optional[Callable[[List[Request]],
                                                    Any]] = None
                   ) -> Optional[List[Request]]:
        """Block until a batch is ready (a full bucket anywhere, or the
        oldest request aged past the window); None once closed and
        drained. ``on_take`` runs under the queue lock on the batch."""
        with self._lock:
            while True:
                self._shed_expired(time.monotonic())
                if self._q:
                    counts: Dict[Any, int] = {}
                    full_key = None
                    for r in self._q:
                        n = counts.get(r.key, 0) + 1
                        counts[r.key] = n
                        if n >= self.policy.max_batch:
                            full_key = r.key
                            break
                    head = self._q[0]
                    key = full_key if full_key is not None else head.key
                    same = [r for r in self._q if r.key == key]
                    age = time.monotonic() - head.enqueue_t
                    if (full_key is not None
                            or age >= self.timeout_s or self._closed):
                        take = same[:self.policy.max_batch]
                        taken = set(map(id, take))
                        self._q[:] = [r for r in self._q
                                      if id(r) not in taken]
                        QUEUE_DEPTH.set(len(self._q))
                        now = time.monotonic()
                        pc = time.perf_counter()
                        for r in take:
                            wait = now - r.enqueue_t
                            QUEUE_WAIT_SECONDS.observe(
                                wait,
                                exemplar=r.trace.trace_id
                                if r.trace is not None else None)
                            # retroactive span: submit -> batch take
                            _tracing.record_span(
                                "queue.wait", pc - wait, pc,
                                ctx=r.trace)
                        BATCH_SIZE.observe(len(take))
                        if on_take is not None:
                            on_take(take)
                        return take
                    self._nonempty.wait(self.timeout_s - age)
                    continue
                if self._closed:
                    return None
                self._nonempty.wait()


class SlotScheduler:
    """Prefill queue + decode slot table — the iteration-level scheduler
    behind :class:`~mxnet_tpu_torch.serving.generation.GenerationEngine`.

    * **prefill** — a BOUNDED FIFO of not-yet-admitted requests: a full
      queue sheds the newcomer at submit (``queue_full``); a request whose
      deadline passed while waiting for a slot is shed at admission time
      (``deadline``).
    * **decode** — the slot table: admitted requests occupy a slot until
      retirement (EOS / max-tokens / error) frees it. The engine drains
      admissions between decode iterations.

    Requests are duck-typed: they carry ``deadline_t`` (monotonic or None),
    ``enqueue_t``, and ``fail(exc)`` / ``is_cancelled()``.
    """

    def __init__(self, max_slots: int,
                 queue_limit: Optional[int] = None) -> None:
        if queue_limit is None:
            queue_limit = int(getenv("MXNET_SERVING_QUEUE_LIMIT", 256))
        self.max_slots = int(max_slots)
        self.queue_limit = int(queue_limit)
        self._q: List[Any] = []
        self._active: Dict[int, Any] = {}       # slot -> request
        # popped for admission but not yet slot-resident (prefill in
        # flight): counted so a drain poll never sees a false idle
        self._mid_admission = 0
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._closed = False

    # -- prefill queue ------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    def submit(self, req: Any, front: bool = False,
               force: bool = False) -> None:
        """Enqueue for admission, or shed immediately (OverloadError
        failed onto the request AND raised). ``force`` bypasses the
        queue_full shed and ``front`` queue-jumps — the recovery path."""
        with self._lock:
            if self._closed:
                raise MXNetError("generation scheduler is closed")
            if not force and len(self._q) >= self.queue_limit:
                # abandoned (cancelled-while-queued) entries must not
                # hold queue_full sheds high
                self._q[:] = [r for r in self._q if not r.is_cancelled()]
            if not force and len(self._q) >= self.queue_limit:
                depth = len(self._q)
                err = OverloadError("queue_full", queue_depth=depth,
                                    retry_after_ms=100.0 * max(1, depth))
                SHED_TOTAL.labels(reason="queue_full").inc()
                REQUESTS_TOTAL.labels(status="shed").inc()
                req.fail(err)
                raise err
            if front:
                self._q.insert(0, req)
            else:
                self._q.append(req)
            _metrics.GEN_QUEUE_DEPTH.set(len(self._q))
            self._work.notify_all()

    def discard(self, req: Any) -> bool:
        """Evict a still-queued request now (consumer cancelled). Returns
        True when the request was found queued."""
        with self._lock:
            try:
                self._q.remove(req)
            except ValueError:
                return False
            _metrics.GEN_QUEUE_DEPTH.set(len(self._q))
        REQUESTS_TOTAL.labels(status="cancelled").inc()
        return True

    def drain_queue(self) -> List[Any]:
        """Pop every queued request WITHOUT failing it (worker-death
        evacuation); also clears the mid-admission count."""
        with self._lock:
            out, self._q[:] = list(self._q), []
            self._mid_admission = 0
            _metrics.GEN_QUEUE_DEPTH.set(0)
            return out

    def pop_admissions(self, free_slots: int,
                       now: Optional[float] = None) -> List[Any]:
        """Up to ``free_slots`` admissible requests, FIFO; expired or
        cancelled entries are shed / dropped in passing."""
        if now is None:
            now = time.monotonic()
        out: List[Any] = []
        with self._lock:
            keep: List[Any] = []
            for r in self._q:
                if r.is_cancelled():
                    continue
                if r.deadline_t is not None and now > r.deadline_t:
                    err = OverloadError("deadline",
                                        queue_depth=len(self._q),
                                        retry_after_ms=100.0)
                    SHED_TOTAL.labels(reason="deadline").inc()
                    REQUESTS_TOTAL.labels(status="shed").inc()
                    r.fail(err)
                    continue
                if len(out) < free_slots:
                    out.append(r)
                    tr = getattr(r, "trace", None)
                    if tr is not None:
                        # submit -> admission pop = the slot wait
                        pc = time.perf_counter()
                        _tracing.record_span(
                            "queue.wait", pc - (now - r.enqueue_t),
                            pc, ctx=tr)
                else:
                    keep.append(r)
            self._q[:] = keep
            self._mid_admission += len(out)
            _metrics.GEN_QUEUE_DEPTH.set(len(self._q))
        return out

    def admission_done(self) -> None:
        """One popped request landed (activated or failed)."""
        with self._lock:
            self._mid_admission = max(0, self._mid_admission - 1)

    def busy(self) -> bool:
        """Anything queued, slot-resident, or mid-admission."""
        with self._lock:
            return bool(self._q or self._active or self._mid_admission)

    # -- decode slot table --------------------------------------------------
    def activate(self, slot: int, req: Any) -> None:
        with self._lock:
            self._active[int(slot)] = req

    def release(self, slot: int) -> Any:
        with self._lock:
            return self._active.pop(int(slot), None)

    def active(self) -> Dict[int, Any]:
        with self._lock:
            return dict(self._active)

    def n_active(self) -> int:
        with self._lock:
            return len(self._active)

    # -- engine-loop blocking ----------------------------------------------
    def wait_for_work(self, timeout: float) -> bool:
        """Block until there is anything to do (queued request, active
        slot, or close); returns False once closed AND drained."""
        with self._lock:
            if not self._q and not self._active and not self._closed:
                self._work.wait(timeout)
            return not (self._closed and not self._q
                        and not self._active)

    def close(self) -> None:
        """Stop admissions; queued requests fail with a shutdown error.
        Active slots are the engine's to fail (it owns the streams)."""
        with self._lock:
            self._closed = True
            for r in self._q:
                r.fail(MXNetError(
                    "generation scheduler closed with the request "
                    "still queued (shutdown)"))
                REQUESTS_TOTAL.labels(status="error").inc()
            self._q.clear()
            _metrics.GEN_QUEUE_DEPTH.set(0)
            self._work.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed
