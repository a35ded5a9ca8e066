"""ModelServer — batcher + model + replicated worker threads.

Counterpart of ``mxnet_tpu/serving/server.py:ModelServer`` (``start``,
``stop``, ``infer``, ``infer_async``, warmup, replicas, shedding, the
circuit breaker, the drain and the health split). Worker threads drain
the shared queue and execute batches; any number of producer threads (the
HTTP front end's, ``serving/http.py``) submit requests and wait on
futures. A dead worker's in-flight batch requeues to the survivors while
the :class:`~mxnet_tpu_torch.serving.replica.ReplicaSupervisor` restarts
it; when every replica has spent its budget the breaker opens and the
server is degraded until :meth:`ModelServer.reset_breaker`.
:meth:`ModelServer.start_drain` stops admissions (429 ``draining``) while
resident work finishes; :meth:`ModelServer.drain` then stops the server.

Each batch runs in a ``serving.execute`` span linking its requests' traces
and passes the ``serving.execute`` fault site; the worker loop passes the
``serving.worker`` site, where an error kills the worker thread. The JAX
package's hang watchdog around the execute (``health.watch_section``) is
ROADMAP Queue A 14. ``GenerationServer`` and ``serve_until_preempted``
wait for Queue A 5 and 12.
"""
from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

import numpy as _np

from .. import faults as _faults
from .. import metrics as _metrics
from .. import tracing as _tracing
from ..base import MXNetError, getenv
from .batching import BucketPolicy, DynamicBatcher, REQUESTS_TOTAL, Request
from .model import ServedModel
from .replica import ReplicaSupervisor

__all__ = ["ModelServer", "DegradedError"]

_LOG = logging.getLogger("mxnet_tpu_torch.serving")


class DegradedError(MXNetError):
    """The server cannot take requests (every worker replica dead, or the
    circuit breaker open); the HTTP front end answers 503."""


class ModelServer:
    """Serve a :class:`ServedModel` behind a dynamic micro-batching queue::

        server = ModelServer(ServedModel.from_block(net, sig), warmup=True)
        with server:
            y = server.infer(x_np)               # blocking, one sample
            fut = server.infer_async(x_np)       # concurrent.futures.Future

    ``infer`` raises :class:`OverloadError` when the request is shed
    (bounded queue, deadline, draining). ``stats`` counts executed batches
    and answered requests. A static export (``model.fixed_batch``) serves
    only its traced batch: the policy's batch buckets must be just it.
    """

    def __init__(self, model: ServedModel,
                 policy: Optional[BucketPolicy] = None,
                 timeout_ms: Optional[float] = None,
                 queue_limit: Optional[int] = None,
                 warmup: bool = False,
                 replicas: Optional[int] = None,
                 max_restarts: Optional[int] = None,
                 restart_backoff_ms: Optional[float] = None) -> None:
        self.model = model
        self.policy = policy if policy is not None \
            else model.default_policy()
        fixed = getattr(model, "fixed_batch", None)
        if fixed is not None and \
                tuple(self.policy.batch_buckets) != (fixed,):
            raise MXNetError(
                f"static export serves only batch={fixed}; the policy's "
                f"batch_buckets must be [{fixed}]")
        self.batcher = DynamicBatcher(self.policy, timeout_ms=timeout_ms,
                                      queue_limit=queue_limit)
        self._default_deadline_s = \
            float(getenv("MXNET_SERVING_DEADLINE_MS", 0)) / 1e3
        if replicas is None:
            replicas = int(getenv("MXNET_SERVING_REPLICAS", 1))
        self.replicas = max(1, int(replicas))
        self._workers: Dict[int, threading.Thread] = {}
        self._started = False
        self._stopping = False
        self._degraded = False
        self._inflight: Dict[int, List[Request]] = {}
        self._lock = threading.Lock()
        self.stats = {"batches": 0, "requests": 0}
        self.supervisor = ReplicaSupervisor(
            "oneshot", self.replicas, self._spawn_worker,
            self._on_degraded, self._worker_alive,
            max_restarts=max_restarts, backoff_ms=restart_backoff_ms)
        # warmup runs before start(): every bucket of the grid has run
        # once before the server takes traffic
        self.warmed = 0
        self.warmup_seconds = 0.0
        if warmup:
            t0 = time.perf_counter()
            self.warmed = model.warmup(self.policy)
            self.warmup_seconds = time.perf_counter() - t0

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "ModelServer":
        if self._started:
            return self
        if self.batcher._closed:
            raise MXNetError(
                "ModelServer cannot restart after stop(): the batcher is "
                "closed (build a fresh ModelServer)")
        self._started = True
        for wid in range(self.replicas):
            self._spawn_worker(wid)
        return self

    def _spawn_worker(self, wid: int) -> None:
        t = threading.Thread(target=self._run, args=(wid,),
                             name=f"mxnet-serving-worker-{wid}",
                             daemon=True)
        with self._lock:
            self._workers[wid] = t
        t.start()

    def _worker_alive(self, wid: int) -> bool:
        t = self._workers.get(wid)
        return bool(t is not None and t.is_alive())

    def stop(self, timeout: float = 10.0) -> None:
        if not self._started:
            return
        self._stopping = True
        self.supervisor.stop()
        self.batcher.close()
        deadline = time.monotonic() + timeout
        for t in list(self._workers.values()):
            t.join(max(0.0, deadline - time.monotonic()))
        self._fail_inflight(MXNetError(
            "ModelServer stopped with the request still in flight "
            "(shutdown)"))
        self._started = False

    def _fail_inflight(self, exc: Exception) -> None:
        with self._lock:
            batches = list(self._inflight.values())
            self._inflight.clear()
        for batch in batches:
            for r in batch:
                if not r.future.done():
                    try:
                        r.future.set_exception(exc)
                    except Exception:   # noqa: BLE001 - done() race
                        continue
                    REQUESTS_TOTAL.labels(status="error").inc()

    # -- health -------------------------------------------------------------
    @property
    def draining(self) -> bool:
        return self.batcher.draining

    @property
    def degraded(self) -> bool:
        return self._degraded

    def ready(self) -> bool:
        """Readiness for new traffic: started, breaker closed, not
        draining, a worker in rotation."""
        return bool(self._started and not self._degraded
                    and not self.draining
                    and self.supervisor.in_rotation() > 0)

    def healthy(self) -> bool:
        """The JAX package's alias of :meth:`ready`."""
        return self.ready()

    def __enter__(self) -> "ModelServer":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    # -- drain --------------------------------------------------------------
    def start_drain(self) -> None:
        """Stop admissions (new submits shed 429 ``draining``); queued and
        in-flight work keeps executing."""
        _metrics.SERVING_DRAINING.set(1)
        self.batcher.start_drain()

    def await_drained(self, timeout: float = 1.0) -> bool:
        """Poll until no request is queued or in flight, or ``timeout``
        seconds pass; True when drained."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                idle = not any(self._inflight.values())
            if idle and len(self.batcher) == 0:
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.01)

    def drain(self, deadline_s: Optional[float] = None,
              stop_timeout: float = 10.0) -> bool:
        """Graceful shutdown: stop admissions, finish resident work within
        ``deadline_s`` (default ``MXNET_SERVING_DRAIN_DEADLINE_S``), then
        stop. True when everything finished inside the budget."""
        if deadline_s is None:
            deadline_s = float(getenv("MXNET_SERVING_DRAIN_DEADLINE_S", 30))
        self.start_drain()
        drained = self.await_drained(float(deadline_s))
        self.stop(timeout=stop_timeout)
        return drained

    # -- breaker ------------------------------------------------------------
    def _on_degraded(self, exc: BaseException) -> None:
        """Every replica spent its restart budget: fail what is held and
        refuse new work until :meth:`reset_breaker`."""
        self._degraded = True
        err = DegradedError(
            f"ModelServer worker thread died repeatedly "
            f"({self.supervisor.max_restarts} restarts per replica spent); "
            f"circuit breaker tripped — the server is degraded (last "
            f"error: {exc!r}); reset_breaker() or restart")
        self._fail_inflight(err)
        self.batcher.close(error=err)
        _LOG.error("serving worker crash-loop: breaker tripped (%r)", exc)

    def reset_breaker(self) -> None:
        """The operator's word that the crash cause is gone: refill every
        restart budget, reopen the queue and respawn dead workers."""
        if not self._started:
            raise MXNetError("reset_breaker() on a stopped server — build "
                             "and start a fresh one")
        self.supervisor.reset()
        self._degraded = False
        self.batcher.reopen()
        for wid in range(self.replicas):
            if not self._worker_alive(wid):
                self._spawn_worker(wid)

    # -- request API --------------------------------------------------------
    def infer_async(self, *sample: _np.ndarray,
                    deadline_ms: Optional[float] = None) -> Future:
        """Submit one sample (per-input arrays WITHOUT the batch dim);
        returns a Future of the per-output arrays (list, or the single
        array for single-output models)."""
        if not self._started:
            raise MXNetError("ModelServer.start() first")
        if self._degraded:
            raise DegradedError(
                "ModelServer worker replicas are crash-looping and the "
                "circuit breaker is open — restart the server")
        arrays = [_np.asarray(a) for a in sample]
        sig = self.model.input_signature
        if len(arrays) != len(sig):
            raise MXNetError(
                f"model {self.model.name} takes {len(sig)} inputs, "
                f"got {len(arrays)}")
        for i, (a, (shape, dtype)) in enumerate(zip(arrays, sig)):
            got = tuple(a.shape)
            if i == 0 and self.policy.pad_axis is not None:
                ax = self.policy.pad_axis
                if len(got) != len(shape) or any(
                        g != s for j, (g, s) in enumerate(zip(got, shape))
                        if j != ax):
                    raise MXNetError(
                        f"sample shape {got} != model input {shape} "
                        f"(batch dim excluded; only axis {ax} is "
                        "length-bucketed)")
            elif got != tuple(shape):
                raise MXNetError(
                    f"sample shape {got} != model input {tuple(shape)} "
                    "(batch dim excluded); enable length bucketing "
                    "(pad_axis/length_buckets) for variable-shape "
                    "requests")
        key = self.policy.bucket_key(arrays)
        if deadline_ms is None and self._default_deadline_s > 0:
            deadline_ms = self._default_deadline_s * 1e3
        deadline_t = (time.monotonic() + deadline_ms / 1e3
                      if deadline_ms else None)
        fut: Future = Future()
        self.batcher.submit(Request(arrays, key, fut, deadline_t))
        return fut

    def infer(self, *sample: _np.ndarray,
              deadline_ms: Optional[float] = None,
              timeout: float = 60.0) -> Any:
        """Blocking single-sample inference."""
        return self.infer_async(*sample,
                                deadline_ms=deadline_ms).result(timeout)

    # -- worker -------------------------------------------------------------
    def _run(self, wid: int) -> None:
        def take(batch: List[Request]) -> None:
            with self._lock:
                self._inflight[wid] = batch

        try:
            while True:
                batch = self.batcher.next_batch(on_take=take)
                if batch is None:
                    return
                # the worker-death fault site: an error here (outside the
                # per-request handling) kills this worker thread
                _faults.maybe_fault("serving.worker", worker=wid,
                                    batch=len(batch))
                try:
                    self._execute(batch)
                except Exception:   # noqa: BLE001 - per-request faults
                    pass            # were already set on the futures
                with self._lock:
                    self._inflight.pop(wid, None)
        except BaseException as e:   # noqa: BLE001 - worker death is a
            self._on_worker_death(wid, e)   # replica-level event

    def _on_worker_death(self, wid: int, exc: BaseException) -> None:
        if self._stopping or self.batcher._closed:
            self._fail_inflight(MXNetError(
                f"ModelServer worker thread died: {exc!r}; the server "
                "is stopping"))
            return
        with self._lock:
            batch = self._inflight.pop(wid, None)
        if batch:
            self.batcher.requeue(batch)
        _LOG.error("serving worker %d died: %r — batch requeued; "
                   "supervisor restarting with backoff", wid, exc)
        self.supervisor.notify_death(wid, exc)

    def _execute(self, batch: List[Request]) -> None:
        try:
            # a batch serves many requests: its span is a trace of its
            # own that links each request's trace
            with _tracing.span("serving.execute",
                               batch=len(batch)) as xsp:
                for r in batch:
                    if r.trace is not None:
                        xsp.add_link(r.trace.trace_id)
                _faults.maybe_fault("serving.execute", batch=len(batch))
                arrays, _nb = self.policy.assemble(
                    [r.sample for r in batch], batch[0].key)
                outs = self.model.predict(arrays)
        except Exception as e:   # noqa: BLE001 - worker must survive
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)
                    REQUESTS_TOTAL.labels(status="error").inc()
            return
        with self._lock:
            self.stats["batches"] += 1
        for i, r in enumerate(batch):
            if r.future.done():
                continue
            rows = [o[i] for o in outs]
            if self.policy.pad_axis is not None:
                rows = self._strip_length(rows, r)
            try:
                r.future.set_result(rows[0] if len(rows) == 1 else rows)
            except Exception:   # noqa: BLE001 - cancelled in the window
                continue
            REQUESTS_TOTAL.labels(status="ok").inc()
            with self._lock:
                self.stats["requests"] += 1

    def _strip_length(self, rows: List[_np.ndarray],
                      req: Request) -> List[_np.ndarray]:
        """Slice length padding back off each output that keeps the
        sample's rank and the padded extent at ``pad_axis``."""
        real = req.sample[0].shape[self.policy.pad_axis]
        padded = req.key[0][0][self.policy.pad_axis]
        if real == padded:
            return rows
        sample_ndim = req.sample[0].ndim
        ax = self.policy.pad_axis
        out = []
        for o in rows:
            if o.ndim >= sample_ndim and o.ndim > ax \
                    and o.shape[ax] == padded:
                sl = [slice(None)] * o.ndim
                sl[ax] = slice(0, real)
                o = o[tuple(sl)]
            out.append(o)
        return out

    # -- introspection ------------------------------------------------------
    def describe(self) -> Dict[str, Any]:
        return {
            "model": self.model.describe(),
            "policy": {
                "batch_buckets": list(self.policy.batch_buckets),
                "pad_axis": self.policy.pad_axis,
                "length_buckets": (list(self.policy.length_buckets)
                                   if self.policy.length_buckets else None),
                "n_buckets": self.policy.n_buckets(),
            },
            "queue": {"depth": len(self.batcher),
                      "limit": self.batcher.queue_limit,
                      "batch_timeout_ms": self.batcher.timeout_s * 1e3},
            "warmed_buckets": self.warmed,
            "warmup_seconds": round(self.warmup_seconds, 6),
            "stats": dict(self.stats),
            "worker_alive": self.ready(),
            "resilience": {
                "replicas": self.replicas,
                "workers_alive": sum(1 for wid in range(self.replicas)
                                     if self._worker_alive(wid)),
                "draining": self.draining,
                "supervisor": self.supervisor.describe(),
            },
            "exec_cache": self.model.exec_cache_stats(),
        }
