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
ROADMAP Queue A 14.

:class:`GenerationServer` (``server.py:504-993``) hosts generation engine
replicas the same way: a least-loaded router, worker death evacuating the
replica's sequences onto the survivors (exactly-once and token-identical,
through each stream's index dedupe), supervised restarts, the breaker, the
drain and the health split. ``serve_until_preempted`` waits for Queue A 12.
"""
from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as _np

from .. import faults as _faults
from .. import metrics as _metrics
from .. import tracing as _tracing
from ..base import MXNetError, getenv
from .batching import (SHED_TOTAL, BucketPolicy, DynamicBatcher,
                       OverloadError, REQUESTS_TOTAL, Request)
from .generation import GenRequest, make_recovery_request
from .model import ServedModel
from .replica import ReplicaSupervisor

__all__ = ["ModelServer", "DegradedError", "GenerationServer"]

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


class _GenReplica:
    """One generation worker replica: its engine, its thread.
    ``dead`` flips the moment the death handler starts so the router
    stops feeding an engine that is being evacuated."""

    __slots__ = ("idx", "engine", "thread", "dead")

    def __init__(self, idx: int, engine: Any) -> None:
        self.idx = idx
        self.engine = engine
        self.thread: Optional[threading.Thread] = None
        self.dead = False


class GenerationServer:
    """Host :class:`~mxnet_tpu_torch.serving.generation.GenerationEngine`
    replicas on worker threads — the continuous-batching sibling of
    :class:`ModelServer`.

    The same concurrency shape per replica: one worker owns its engine
    (it runs the resident decode loop, one iteration at a time), while
    any number of
    producer threads submit prompts and drain their
    :class:`~mxnet_tpu_torch.serving.generation.TokenStream`.  A router
    picks
    the least-loaded healthy replica per request; worker death
    evacuates the replica's engine and resurrects its sequences on the
    survivors (exactly-once, token-identical — see the module doc).

    ::

        server = GenerationServer(engine, warmup=True).start()
        stream = server.generate(prompt_ids, max_new_tokens=64)
        for tok in stream: ...
        server.stop()

    Pass ``engine_factory=`` (and optionally ``replicas=``, default
    ``MXNET_SERVING_REPLICAS``) to host N independent engines; dead
    replicas are then rebuilt from the factory on restart.  Passing a
    single ``engine`` keeps the pre-replica behavior (one replica,
    restart reuses the evacuated engine).
    """

    def __init__(self, engine: Any = None, warmup: bool = False,
                 engine_factory: Optional[Callable[[], Any]] = None,
                 replicas: Optional[int] = None,
                 max_restarts: Optional[int] = None,
                 restart_backoff_ms: Optional[float] = None) -> None:
        if (engine is None) == (engine_factory is None):
            raise MXNetError(
                "GenerationServer takes an engine OR an engine_factory")
        self._factory = engine_factory
        self._warmup = bool(warmup)
        if engine is not None:
            engines = [engine]
        else:
            if replicas is None:
                replicas = int(getenv("MXNET_SERVING_REPLICAS", 1))
            engines = [engine_factory() for _ in range(max(1,
                                                           int(replicas)))]
        self.replicas = len(engines)
        self._replicas = [
            _GenReplica(i, eng) for i, eng in enumerate(engines)]
        self._started = False
        self._degraded = False
        self._draining = False
        self._stop = threading.Event()
        self._lock = threading.Lock()
        # accepted requests waiting for a replica to come back (every
        # replica dead/restarting): flushed on restart, failed on
        # degrade/stop — never silently dropped
        self._pending: List[GenRequest] = []
        self.supervisor = ReplicaSupervisor(
            "generation", self.replicas, self._spawn_replica,
            self._on_degraded, self._replica_alive,
            max_restarts=max_restarts, backoff_ms=restart_backoff_ms)
        # prewarm BEFORE any replica thread exists or ready() can flip:
        # every replica captures its decode graphs here, and /v1/model
        # reports how long that took (warmup_seconds)
        self.warmup_seconds = 0.0
        t0 = time.perf_counter()
        for rep in self._replicas:
            rep.engine.recovery_sink = self._recover
            if warmup:
                rep.engine.warmup()
        if warmup:
            self.warmup_seconds = time.perf_counter() - t0

    # -- compat surface ------------------------------------------------------
    @property
    def engine(self) -> Any:
        """The first replica's engine (pre-replica API compat)."""
        return self._replicas[0].engine

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "GenerationServer":
        if self._started:
            return self
        if self.engine.scheduler.closed:
            raise MXNetError(
                "GenerationServer cannot restart after stop(): build a "
                "fresh engine")
        self._started = True
        for rep in self._replicas:
            self._spawn_thread(rep)
        return self

    def _spawn_thread(self, rep: _GenReplica) -> None:
        t = threading.Thread(
            target=self._run, args=(rep,),
            name=f"mxnet-generation-worker-{rep.idx}", daemon=True)
        rep.thread = t
        t.start()

    def _replica_alive(self, rid: int) -> bool:
        rep = self._replicas[rid]
        # the death handler runs ON the dying thread, so is_alive() is
        # still True mid-evacuation — the dead flag closes that window
        return bool(not rep.dead and rep.thread is not None
                    and rep.thread.is_alive())

    def stop(self, timeout: float = 10.0) -> None:
        if not self._started:
            return
        self._stop.set()
        self.supervisor.stop()
        # close the admission queues: sheds queued requests with a
        # structured shutdown error and wakes parked workers
        for rep in self._replicas:
            rep.engine.scheduler.close()
        deadline = time.monotonic() + timeout
        for rep in self._replicas:
            if rep.thread is not None:
                rep.thread.join(max(0.0, deadline - time.monotonic()))
        # a respawn under way builds and warms an engine (graph captures):
        # let it finish, so that no device work outlives the server
        self.supervisor.join(max(0.0, deadline - time.monotonic()))
        # whether the workers exited cleanly or not, no stream may be
        # left to block forever
        for rep in self._replicas:
            rep.engine.close()
        err = MXNetError("generation server stopped with the request "
                         "still pending (shutdown)")
        with self._lock:
            pending, self._pending = self._pending, []
        for req in pending:
            req.fail(err)
        self._started = False

    # -- health split -------------------------------------------------------
    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def degraded(self) -> bool:
        return self._degraded

    def ready(self) -> bool:
        """Readiness: in rotation for NEW prompts — started, breaker
        closed, not draining, at least one replica serving or coming
        back."""
        return bool(self._started and not self._degraded
                    and not self._draining
                    and self.supervisor.in_rotation() > 0)

    def healthy(self) -> bool:
        """Back-compat alias for :meth:`ready`."""
        return self.ready()

    def __enter__(self) -> "GenerationServer":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    # -- drain --------------------------------------------------------------
    def start_drain(self) -> None:
        """Stop admitting NEW prompts (429 ``draining``); queued and
        slot-resident sequences decode to completion."""
        _metrics.SERVING_DRAINING.set(1)
        self._draining = True

    def await_drained(self, timeout: float = 1.0) -> bool:
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                pending = bool(self._pending)
            idle = not pending and not any(
                rep.engine.scheduler.busy() for rep in self._replicas)
            if idle:
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.01)

    def drain(self, deadline_s: Optional[float] = None,
              stop_timeout: float = 10.0) -> bool:
        """Stop admissions, finish every accepted sequence within
        ``deadline_s`` (default ``MXNET_SERVING_DRAIN_DEADLINE_S``),
        then stop.  Returns True when everything finished in budget
        (leftovers fail with the structured shutdown error)."""
        if deadline_s is None:
            deadline_s = float(
                getenv("MXNET_SERVING_DRAIN_DEADLINE_S", 30))
        self.start_drain()
        drained = self.await_drained(float(deadline_s))
        self.stop(timeout=stop_timeout)
        return drained

    # -- request API --------------------------------------------------------
    def generate(self, tokens: Any, max_new_tokens: int = 64,
                 eos_token: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 method: Optional[str] = None,
                 temperature: Optional[float] = None,
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 seed: Optional[int] = None,
                 speculative: Optional[bool] = None) -> Any:
        """Submit one prompt; returns its ``TokenStream``.  Sampling
        parameters pass through to the engine (on-device sampling,
        deterministic by ``seed`` — including across worker-death
        resurrection), as does ``speculative`` (None = the engine's
        MXNET_GEN_SPEC_MODE default; the flag rides recovery, so a
        resurrected sequence keeps its draft config and its bytes).
        Sheds with ``OverloadError`` (queue full / no
        slot within deadline / draining / every replica mid-restart)
        and refuses with :class:`DegradedError` when the breaker is
        open — the same 429-vs-503 split as the one-shot path."""
        if not self._started:
            raise MXNetError("GenerationServer.start() first")
        if self._degraded:
            raise DegradedError(
                "generation worker replicas are crash-looping and the "
                "circuit breaker is open; the server is degraded "
                "(healthz reports 503) — reset_breaker() or restart it")
        if self._draining:
            SHED_TOTAL.labels(reason="draining").inc()
            REQUESTS_TOTAL.labels(status="shed").inc()
            raise OverloadError("draining", retry_after_ms=1e3)
        reps = sorted(
            (rep for rep in self._replicas
             if self._replica_alive(rep.idx)
             and not rep.engine.scheduler.closed),
            key=lambda rep: (len(rep.engine.scheduler)
                             + rep.engine.scheduler.n_active()))
        if not reps:
            if self.supervisor.any_pending():
                # transient: every replica is mid-restart — structured
                # backpressure, not a fake acceptance that could die
                raise OverloadError(
                    "restarting",
                    retry_after_ms=self.supervisor.backoff_ms)
            raise DegradedError(
                "no generation worker replica is alive; the server is "
                "degraded (healthz reports 503) — restart it")
        last: Optional[OverloadError] = None
        for rep in reps:
            try:
                return rep.engine.submit(
                    tokens, max_new_tokens=max_new_tokens,
                    eos_token=eos_token, deadline_ms=deadline_ms,
                    method=method, temperature=temperature,
                    top_k=top_k, top_p=top_p, seed=seed,
                    speculative=speculative)
            except OverloadError as e:
                last = e                 # replica full: try the next
        raise last if last is not None else MXNetError(
            "no replica accepted the request")

    # -- worker -------------------------------------------------------------
    def _run(self, rep: _GenReplica) -> None:
        try:
            while not self._stop.is_set():
                if not rep.engine.scheduler.wait_for_work(0.5):
                    return               # closed and fully drained
                if len(rep.engine.scheduler) \
                        or rep.engine.scheduler.n_active():
                    # the worker-death chaos site, hit only on passes
                    # with work so seeded after=N plans count decode
                    # activity, not idle parks
                    _faults.maybe_fault("serving.worker",
                                        replica=rep.idx)
                rep.engine.run_iteration()
        except BaseException as e:   # noqa: BLE001 - worker death is a
            # replica-level event: evacuate + resurrect elsewhere
            self._on_worker_death(rep, e)

    def _on_worker_death(self, rep: _GenReplica, exc: BaseException) -> None:
        if self._stop.is_set():
            try:
                rep.engine.close()
            except Exception:   # noqa: BLE001 - already dying
                pass
            return
        _LOG.error(
            "generation worker %d died: %r — evacuating its sequences "
            "to surviving replicas; supervisor restarting with backoff",
            rep.idx, exc)
        rep.dead = True          # router must not feed a dying engine
        try:
            queued, resident = rep.engine.evacuate()
        except Exception:   # noqa: BLE001 - the engine is too broken
            # even to evacuate: strand nothing — close() fails every
            # stream it still holds so waiters unblock deterministically
            queued, resident = [], []
            try:
                rep.engine.close()
            except Exception:   # noqa: BLE001 - already beyond help
                pass
        for req in queued:
            _metrics.SERVING_RECOVERIES_TOTAL.labels(site="queue").inc()
            self._route(req, exclude=rep)
        self._recover(resident, exc, "worker", exclude=rep)
        self.supervisor.notify_death(rep.idx, exc)

    def _recover(self, victims: Sequence[GenRequest],
                 exc: BaseException, site: str,
                 exclude: Optional[_GenReplica] = None) -> None:
        """Resurrect slot-resident sequences from their stream
        transcripts (exactly-once: deterministic greedy re-prefill +
        the TokenStream index dedupe).  Each sequence carries a
        recovery budget (the supervisor's restart budget, reused): a
        deterministically-poisoned sequence that crashes every decode
        step it joins must eventually FAIL with the underlying error,
        not resurrect forever while churning its slot-mates."""
        for req in victims:
            if req.recoveries >= self.supervisor.max_restarts:
                req.fail(MXNetError(
                    f"sequence recovered {req.recoveries} times and "
                    f"failed again ({exc!r}); recovery budget spent — "
                    "failing it instead of resurrecting forever"))
                REQUESTS_TOTAL.labels(status="error").inc()
                continue
            try:
                # the resurrection stays inside the original request's
                # trace: attach its captured context so the recovery
                # span (and the re-prefill that follows on the new
                # replica) share the request's trace id
                with _tracing.attach(req.trace), _tracing.child_span(
                        "serving.recover", site=site,
                        request_id=req.request_id,
                        recovered_tokens=len(req.stream.tokens)):
                    r = make_recovery_request(req)
            except MXNetError as e:
                req.fail(e)
                REQUESTS_TOTAL.labels(status="error").inc()
                continue
            _metrics.SERVING_RECOVERIES_TOTAL.labels(site=site).inc()
            _metrics.SERVING_RECOVERED_TOKENS.inc(len(req.stream.tokens))
            self._route(r, exclude=exclude)

    def _route(self, req: GenRequest,
               exclude: Optional[_GenReplica] = None) -> None:
        """Hand an already-accepted request to a healthy replica, or
        park it for the next restart — never shed, never drop."""
        reps = sorted(
            (rep for rep in self._replicas
             if rep is not exclude and self._replica_alive(rep.idx)
             and not rep.engine.scheduler.closed),
            key=lambda rep: (len(rep.engine.scheduler)
                             + rep.engine.scheduler.n_active()))
        for rep in reps:
            try:
                rep.engine.submit_request(req, front=True)
                return
            except MXNetError:
                continue                 # closed in a race: next
        with self._lock:
            if not self._degraded and not self._stop.is_set():
                self._pending.append(req)
                return
        req.fail(DegradedError(
            "sequence lost its worker and no replica is available "
            "(server degraded/stopping)"))
        REQUESTS_TOTAL.labels(status="error").inc()

    def _spawn_replica(self, rid: int) -> None:
        """Supervisor callback (after backoff): bring replica ``rid``
        back — fresh engine from the factory when there is one, the
        evacuated engine otherwise — and flush parked requests into
        it."""
        if self._stop.is_set() or self._degraded:
            return
        rep = self._replicas[rid]
        late_q: List[GenRequest] = []
        late_r: List[GenRequest] = []
        if self._factory is not None:
            eng = self._factory()
            if self._warmup:
                eng.warmup()
            # a generate() that read the replica as alive just before
            # the dead flag flipped may have queued into the old engine
            # AFTER its evacuation — sweep once more before orphaning it
            try:
                late_q, late_r = rep.engine.evacuate()
            except Exception:   # noqa: BLE001 - poisoned old engine
                pass
        else:
            eng = rep.engine             # evacuated + buffers reset
        eng.recovery_sink = self._recover
        with self._lock:
            if self._stop.is_set() or self._degraded:
                return
            rep.engine = eng
            rep.dead = False
            pending, self._pending = self._pending, []
        self._spawn_thread(rep)
        for req in late_q + pending:
            try:
                rep.engine.submit_request(req, front=True)
            except MXNetError as e:
                req.fail(e)
                REQUESTS_TOTAL.labels(status="error").inc()
        if late_r:
            self._recover(late_r, MXNetError(
                "worker died while the sequence was being admitted"),
                "worker")

    # -- breaker ------------------------------------------------------------
    def _on_degraded(self, exc: BaseException) -> None:
        self._degraded = True
        err = DegradedError(
            f"generation worker replicas died repeatedly "
            f"({self.supervisor.max_restarts} restarts per replica "
            f"spent); circuit breaker tripped — the server is degraded "
            f"(last error: {exc!r}); reset_breaker() or restart")
        with self._lock:
            pending, self._pending = self._pending, []
        for req in pending:
            req.fail(err)
            REQUESTS_TOTAL.labels(status="error").inc()
        for rep in self._replicas:
            try:
                queued, resident = rep.engine.evacuate()
            except Exception:   # noqa: BLE001 - poisoned engine
                continue
            for req in queued + resident:
                req.fail(err)
                REQUESTS_TOTAL.labels(status="error").inc()
        _LOG.error(
            "generation worker crash-loop: breaker tripped after %d "
            "restarts/replica — /healthz now reports degraded (503); "
            "reset_breaker() re-admits traffic (last error: %r)",
            self.supervisor.max_restarts, exc)

    def reset_breaker(self) -> None:
        """Refill every restart budget and bring dead replicas back —
        the operator's re-admit-traffic lever."""
        if not self._started:
            raise MXNetError("reset_breaker() on a stopped server — "
                             "build and start a fresh one")
        self.supervisor.reset()
        self._degraded = False
        for rep in self._replicas:
            if not self._replica_alive(rep.idx):
                self._spawn_replica(rep.idx)

    # -- introspection ------------------------------------------------------
    def describe(self) -> Dict[str, Any]:
        d = self.engine.describe()
        if self.replicas > 1:
            d["slots"] = {
                "max": sum(rep.engine.max_slots
                           for rep in self._replicas),
                "active": sum(rep.engine.scheduler.n_active()
                              for rep in self._replicas),
                "free": sum(len(rep.engine.cache.free_slots())
                            for rep in self._replicas),
            }
            d["queue"] = {
                "depth": sum(len(rep.engine.scheduler)
                             for rep in self._replicas),
                "limit": sum(rep.engine.scheduler.queue_limit
                             for rep in self._replicas),
            }
        d["worker_alive"] = self.ready()
        d["warmup_seconds"] = round(self.warmup_seconds, 6)
        d["resilience"] = {
            "replicas": self.replicas,
            "workers_alive": sum(
                1 for rep in self._replicas
                if self._replica_alive(rep.idx)),
            "draining": self._draining,
            "pending_recoveries": len(self._pending),
            "supervisor": self.supervisor.describe(),
        }
        return d
