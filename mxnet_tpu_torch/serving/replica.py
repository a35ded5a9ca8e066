"""Replica supervision — the serving layer's restart policy.

Counterpart of ``mxnet_tpu/serving/replica.py:ReplicaSupervisor`` with its
own copy of the jittered exponential backoff schedule
(``mxnet_tpu/retry.py:backoff_delays``):

* a dead worker replica is restarted after a jittered backoff;
* each replica has a restart budget (``MXNET_SERVING_MAX_RESTARTS``);
  past it the replica's breaker trips and it leaves the rotation;
* when no replica remains in rotation the server is degraded;
* :meth:`ReplicaSupervisor.reset` (the servers' ``reset_breaker()``)
  refills every budget and clears the breaker.

Restarts count into ``mxnet_serving_worker_restarts_total`` and each runs
in a ``replica.restart`` span; ``mxnet_serving_breaker_open`` is 1 while
the breaker is open.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional

from .. import metrics as _metrics
from .. import tracing as _tracing
from ..base import MXNetError, getenv, register_env

__all__ = ["ReplicaSupervisor", "backoff_delays"]

register_env("MXNET_SERVING_REPLICAS", 1,
             "Worker replicas hosted by each serving server.")
register_env("MXNET_SERVING_DRAIN_DEADLINE_S", 30,
             "Graceful-drain budget of ModelServer.drain(): admissions "
             "stop, resident requests finish for at most this long, then "
             "the server stops.")
register_env("MXNET_SERVING_MAX_RESTARTS", 3,
             "Restart budget per serving worker replica.")
register_env("MXNET_SERVING_RESTART_BACKOFF_MS", 100,
             "First-restart backoff after a serving worker replica dies; "
             "doubles per restart (jittered).")

_JITTER_RNG = random.Random()

WORKER_RESTARTS = _metrics.counter(
    "mxnet_serving_worker_restarts_total",
    "Serving worker replicas restarted by the replica supervisor after "
    "a worker death, by server kind (oneshot = ModelServer, generation "
    "= GenerationServer).", labels=("server",))
BREAKER_OPEN = _metrics.gauge(
    "mxnet_serving_breaker_open",
    "1 while a serving server's circuit breaker is open (every replica "
    "exhausted its MXNET_SERVING_MAX_RESTARTS budget — the server is "
    "degraded and sheds with DegradedError until reset_breaker()), by "
    "server kind.", labels=("server",))


def backoff_delays(attempts: int, base_ms: float, max_ms: float = 2000.0,
                   jitter: float = 0.5) -> Iterator[float]:
    """Yield the sleep (seconds) before retry 1, 2, ... — at most
    ``attempts - 1`` values (one fewer sleep than tries), doubling from
    ``base_ms`` up to ``max_ms``, each cut by up to ``jitter``."""
    if attempts < 1:
        raise MXNetError(f"retry attempts must be >= 1, got {attempts}")
    for i in range(attempts - 1):
        d = min(max_ms, base_ms * (2.0 ** i)) / 1e3
        yield d * (1.0 - jitter * _JITTER_RNG.random())


class _ReplicaState:
    __slots__ = ("delays", "pending", "tripped")

    def __init__(self, delays: Iterator[float]) -> None:
        self.delays = delays
        self.pending = False      # a restart is scheduled/backing off
        self.tripped = False      # budget exhausted: out of rotation


class ReplicaSupervisor:
    """Restart/breaker policy for one server's replica set.

    ``spawn(rid)`` is called from a supervisor thread after the backoff
    sleep; ``on_degraded(exc)`` fires once when the last replica leaves
    the rotation; ``alive_fn(rid)`` reports whether a replica is alive.
    """

    def __init__(self, server_label: str, n_replicas: int,
                 spawn: Callable[[int], None],
                 on_degraded: Callable[[BaseException], None],
                 alive_fn: Callable[[int], bool],
                 max_restarts: Optional[int] = None,
                 backoff_ms: Optional[float] = None) -> None:
        self.label = server_label
        if max_restarts is None:
            max_restarts = int(getenv("MXNET_SERVING_MAX_RESTARTS", 3))
        if backoff_ms is None:
            backoff_ms = float(
                getenv("MXNET_SERVING_RESTART_BACKOFF_MS", 100))
        self.max_restarts = int(max_restarts)
        self.backoff_ms = float(backoff_ms)
        self.restarts = 0
        self._spawn = spawn
        self._on_degraded = on_degraded
        self._alive = alive_fn
        self._lock = threading.Lock()
        self._stopped = False
        self._degraded = False
        self._state: Dict[int, _ReplicaState] = {
            rid: _ReplicaState(self._fresh_delays())
            for rid in range(int(n_replicas))}
        BREAKER_OPEN.labels(server=self.label).set(0)

    def _fresh_delays(self) -> Iterator[float]:
        return backoff_delays(attempts=self.max_restarts + 1,
                              base_ms=self.backoff_ms)

    def in_rotation(self) -> int:
        """Replicas alive or with a restart pending."""
        with self._lock:
            return sum(1 for rid, st in self._state.items()
                       if st.pending or (not st.tripped
                                         and self._alive(rid)))

    def notify_death(self, rid: int, exc: BaseException) -> bool:
        """A replica's worker died. Returns True when a restart was
        scheduled; False when its breaker tripped."""
        with self._lock:
            if self._stopped or self._degraded:
                return False
            st = self._state[rid]
            delay = next(st.delays, None)
            if delay is None:
                st.tripped = True
                st.pending = False
                if not any(s.pending or (not s.tripped and self._alive(r))
                           for r, s in self._state.items()):
                    self._degraded = True
            else:
                st.pending = True
        if delay is None:
            if self._degraded:
                BREAKER_OPEN.labels(server=self.label).set(1)
                self._on_degraded(exc)
            return False
        threading.Thread(target=self._restart_after, args=(rid, delay),
                         name=f"mxnet-serving-restart-{self.label}-{rid}",
                         daemon=True).start()
        return True

    def _restart_after(self, rid: int, delay: float) -> None:
        time.sleep(delay)
        with self._lock:
            st = self._state.get(rid)
            if self._stopped or self._degraded or st is None \
                    or not st.pending:
                return
            st.pending = False
            self.restarts += 1
        WORKER_RESTARTS.labels(server=self.label).inc()
        try:
            with _tracing.span("replica.restart", server=self.label,
                               replica=rid, delay_s=delay):
                self._spawn(rid)
        except Exception as e:   # noqa: BLE001 - a failed respawn is
            self.notify_death(rid, e)   # one more death

    def reset(self) -> None:
        """Refill every replica's restart budget and clear the breaker
        (the servers' ``reset_breaker()``); the server respawns its dead
        replicas itself after this."""
        with self._lock:
            self._degraded = False
            for st in self._state.values():
                st.delays = self._fresh_delays()
                st.pending = False
                st.tripped = False
        BREAKER_OPEN.labels(server=self.label).set(0)

    def stop(self) -> None:
        """Server shutdown: cancel pending restarts."""
        with self._lock:
            self._stopped = True
            for st in self._state.values():
                st.pending = False

    def describe(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "max_restarts": self.max_restarts,
                "backoff_ms": self.backoff_ms,
                "restarts": self.restarts,
                "degraded": self._degraded,
                "replicas": {
                    rid: {"alive": self._alive(rid),
                          "restart_pending": st.pending,
                          "breaker_tripped": st.tripped}
                    for rid, st in self._state.items()},
            }
