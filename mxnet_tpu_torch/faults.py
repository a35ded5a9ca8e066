"""Deterministic, seeded fault injection.

Counterpart of ``mxnet_tpu/faults.py``, an own copy: named fault **sites**
are ``maybe_fault(site)`` calls at the runtime's choke points, and a
**plan** arms them with a seeded probability sequence, so a chaos test
replays the same fault schedule on every run, and the same plan fires at
the same calls in both packages. The site table (:func:`known_sites`) is
the JAX package's; the port's code calls these of them:

* ``dispatch.op``      — ``ndarray/register.py:invoke`` and
  ``invoke_with_custom_vjp``, per op;
* ``trainer.step``     — ``gluon.Trainer.step`` before the update; a
  tensor-corrupting site (``kind=nan`` poisons the first fresh gradient
  through :func:`maybe_corrupt`);
* ``serving.execute``  — the ``ModelServer`` worker, per assembled batch;
* ``serving.worker``   — the ``ModelServer`` worker loop itself, outside
  the per-request handling (an error here kills the worker thread).

Arming: ``MXNET_FAULT_PLAN`` (parsed at import) or the API
(:func:`arm`, :func:`disarm`, :class:`fault_plan`, :func:`arm_from_env`).
Plan grammar: ``;``-separated clauses ``site:k=v:k=v...`` with the fields
``p`` (probability per hit, default 1), ``kind`` (``error`` | ``timeout``
| ``crash`` | ``delay`` | ``nan``), ``after`` (skip the first N hits),
``times`` (stop after M injections), ``delay_ms`` and ``seed``.

Determinism: each clause draws from its own ``random.Random(seed ^
crc32(site))``, ``seed`` being ``MXNET_FAULT_SEED`` (default 0) unless the
clause sets it. Every injection counts into
``mxnet_faults_injected_total{site,kind}``. Unarmed, a site costs one
read of the module's ``_ARMED`` flag.
"""
from __future__ import annotations

import os
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Sequence

from .base import MXNetError, register_env
from . import metrics as _metrics

__all__ = [
    "FaultInjected", "FaultSpec", "arm", "disarm", "fault_plan",
    "parse_plan", "arm_from_env", "armed_sites", "known_sites",
    "maybe_fault", "maybe_corrupt", "injected_count",
]

register_env(
    "MXNET_FAULT_PLAN", "",
    "Deterministic fault-injection plan, ';'-separated clauses of "
    "'site:p=0.05:kind=timeout' form (kinds: error, timeout, crash, "
    "delay, nan; fields: p, kind, after, times, delay_ms, seed). "
    "Sites: see docs/fault_tolerance.md. Parsed once at import; empty "
    "(default) disarms everything.")
register_env(
    "MXNET_FAULT_SEED", 0,
    "Base seed for the per-site fault-injection RNGs: the same "
    "MXNET_FAULT_PLAN + seed replays the identical fault schedule in "
    "every process (per-clause 'seed=' overrides).")

FAULTS_INJECTED = _metrics.counter(
    "mxnet_faults_injected_total",
    "Faults injected by the chaos layer (mxnet_tpu.faults), by site and "
    "kind. Nonzero outside a chaos run means MXNET_FAULT_PLAN is set in "
    "production.", labels=("site", "kind"))

# The authoritative site table (name -> where it lives). ci/run.sh lints
# that every name appears in docs/fault_tolerance.md.
_SITES: Dict[str, str] = {
    "checkpoint.write":
        "CheckpointManager.save — after the staging dir exists, before "
        "files rename into place (crash here leaves an orphan staging "
        "dir for the __init__ sweep)",
    "kvstore.send":
        "dist_async worker client, before a request frame is sent to a "
        "parameter server",
    "kvstore.recv":
        "dist_async worker client, before a reply frame is read (a "
        "timeout here is the silent-dead-server case)",
    "dataloader.worker":
        "inside a DataLoader worker process/thread, per batch job "
        "(kind=crash is the killed-worker case)",
    "serving.execute":
        "ModelServer worker thread, per assembled batch, before the "
        "model executes",
    "serving.worker":
        "the serving worker loop itself (ModelServer per dequeued "
        "batch, GenerationServer per decode-loop pass), OUTSIDE the "
        "per-request error handling — an injected error here kills the "
        "worker thread, the in-process worker-death analog the replica "
        "supervisor trains against (requeue/recover + restart + "
        "circuit breaker)",
    "ps.server":
        "the dist_async parameter-server serve loop (per received "
        "frame, OUTSIDE the per-request error handling that would "
        "convert an exception into an error reply): kind=crash "
        "os._exits the server process — the SIGKILL analog the launch "
        "supervisor + durable snapshot restore train against — and "
        "kind=error kills the serve loop itself; seedable like "
        "serving.worker",
    "worker.heartbeat":
        "the dist_async worker heartbeat thread, per (tick, server): "
        "an injected error SUPPRESSES that beat, simulating a "
        "wedged-not-dead rank whose lease expires so barriers and "
        "coordinated checkpoints name it DEAD within "
        "MXNET_PS_HEARTBEAT_DEADLINE_S",
    "dispatch.op":
        "the imperative op dispatch path (ndarray.register.invoke), "
        "per op call",
    "compile_cache.read":
        "persistent compile-cache lookup (CompileCache.load), before "
        "the entry manifest is opened — an injected error degrades "
        "the lookup to a miss (the program recompiles); never a step "
        "or request failure",
    "compile_cache.write":
        "persistent compile-cache write-back (CompileCache.store), "
        "before serialization/staging — an injected error abandons "
        "the write; the freshly compiled executable still serves this "
        "process from memory",
    "trainer.step":
        "the optimizer-step boundary (gluon Trainer.step before the "
        "gradient reduction, SPMDTrainer.step before the compiled "
        "program), per step — a tensor-corrupting site: kind=nan "
        "poisons the first gradient (gluon) / the batch (SPMD) with "
        "NaN so the health sentry's detect/skip/rewind schedule "
        "replays deterministically",
}

_KINDS = ("error", "timeout", "crash", "delay", "nan")

_ARMED = False                       # hot-path gate, rebuilt on arm/disarm
_PLAN: Dict[str, List["FaultSpec"]] = {}
_LOCK = threading.Lock()


class FaultInjected(MXNetError):
    """An injected fault (kind=error) — never raised outside a plan."""

    def __init__(self, site: str, ctx: Dict[str, Any]) -> None:
        self.site = site
        self.ctx = dict(ctx)
        extra = f" ({ctx})" if ctx else ""
        super().__init__(f"injected fault at site {site!r}{extra} "
                         "[mxnet_tpu_torch.faults]")

    def __reduce__(self):
        # cross-process propagation (a DataLoader pool re-raises worker
        # exceptions by pickle) needs the real constructor args
        return (FaultInjected, (self.site, self.ctx))


class FaultSpec:
    """One armed clause: site + probability + kind + hit accounting."""

    __slots__ = ("site", "p", "kind", "after", "times", "delay_ms",
                 "hits", "injected", "_rng", "_lock")

    def __init__(self, site: str, p: float = 1.0, kind: str = "error",
                 after: int = 0, times: Optional[int] = None,
                 delay_ms: float = 10.0,
                 seed: Optional[int] = None) -> None:
        if site not in _SITES:
            raise MXNetError(
                f"unknown fault site {site!r}; known sites: "
                f"{sorted(_SITES)}")
        if kind not in _KINDS:
            raise MXNetError(
                f"unknown fault kind {kind!r}; known kinds: {_KINDS}")
        if not 0.0 <= p <= 1.0:
            raise MXNetError(f"fault probability must be in [0,1], "
                             f"got {p}")
        self.site = site
        self.p = float(p)
        self.kind = kind
        self.after = int(after)
        self.times = None if times is None else int(times)
        self.delay_ms = float(delay_ms)
        self.hits = 0
        self.injected = 0
        if seed is None:
            seed = int(os.environ.get("MXNET_FAULT_SEED", "0") or 0)
        import random
        # a stable per-site stream: thread scheduling and unrelated RNG
        # use cannot perturb the fault schedule
        self._rng = random.Random(seed ^ zlib.crc32(site.encode()))
        self._lock = threading.Lock()

    def __repr__(self) -> str:
        return (f"FaultSpec({self.site}:p={self.p}:kind={self.kind}"
                f":after={self.after}:times={self.times}"
                f" hits={self.hits} injected={self.injected})")

    def _check(self, ctx: Dict[str, Any],
               corrupt: Optional[Any] = None) -> None:
        with self._lock:
            self.hits += 1
            if self.hits <= self.after:
                return
            if self.times is not None and self.injected >= self.times:
                return
            if self.p < 1.0 and self._rng.random() >= self.p:
                return
            self.injected += 1
        FAULTS_INJECTED.labels(site=self.site, kind=self.kind).inc()
        if self.kind == "delay":
            time.sleep(self.delay_ms / 1e3)
            return
        if self.kind == "timeout":
            import socket
            raise socket.timeout(
                f"injected timeout at site {self.site!r} "
                "[mxnet_tpu_torch.faults]")
        if self.kind == "crash":
            os._exit(17)
        if self.kind == "nan":
            # tensor corruption: only sites that pass arrays through
            # maybe_corrupt can apply it — a kind=nan clause armed at a
            # tensor-less site is a plan bug and fails loudly
            if corrupt is None:
                raise MXNetError(
                    f"fault kind 'nan' armed at site {self.site!r}, "
                    "which passes no tensor to corrupt — use a "
                    "tensor-carrying site (trainer.step)")
            corrupt()
            return
        raise FaultInjected(self.site, ctx)


def _rebuild_armed() -> None:
    global _ARMED
    _ARMED = any(_PLAN.values())


def parse_plan(plan: str) -> List[FaultSpec]:
    """Parse a ``MXNET_FAULT_PLAN`` string into specs (no arming)."""
    specs: List[FaultSpec] = []
    for clause in plan.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        parts = clause.split(":")
        site = parts[0].strip()
        kw: Dict[str, Any] = {}
        for field in parts[1:]:
            if "=" not in field:
                raise MXNetError(
                    f"bad fault-plan field {field!r} in clause "
                    f"{clause!r} (want k=v)")
            k, v = field.split("=", 1)
            k = k.strip()
            if k == "kind":
                kw["kind"] = v.strip()
            elif k == "p":
                kw["p"] = float(v)
            elif k == "delay_ms":
                kw["delay_ms"] = float(v)
            elif k in ("after", "times", "seed"):
                kw[k] = int(v)
            else:
                raise MXNetError(
                    f"unknown fault-plan field {k!r} in clause "
                    f"{clause!r} (known: p, kind, after, times, "
                    "delay_ms, seed)")
        specs.append(FaultSpec(site, **kw))
    return specs


def arm(site: str, p: float = 1.0, kind: str = "error", after: int = 0,
        times: Optional[int] = None, delay_ms: float = 10.0,
        seed: Optional[int] = None) -> FaultSpec:
    """Arm one site programmatically; returns the live spec (its
    ``hits``/``injected`` counters are readable for assertions)."""
    spec = FaultSpec(site, p=p, kind=kind, after=after, times=times,
                     delay_ms=delay_ms, seed=seed)
    with _LOCK:
        _PLAN.setdefault(site, []).append(spec)
        _rebuild_armed()
    return spec


def disarm(site: Optional[str] = None) -> None:
    """Disarm one site, or everything (``site=None``)."""
    with _LOCK:
        if site is None:
            _PLAN.clear()
        else:
            _PLAN.pop(site, None)
        _rebuild_armed()


class fault_plan:
    """Context manager: arm a plan string for the block, then restore
    the previous arming exactly."""

    def __init__(self, plan: str) -> None:
        self._plan_str = plan
        self._saved: Optional[Dict[str, List[FaultSpec]]] = None
        self.specs: List[FaultSpec] = []

    def __enter__(self) -> "fault_plan":
        self.specs = parse_plan(self._plan_str)
        with _LOCK:
            self._saved = {k: list(v) for k, v in _PLAN.items()}
            for spec in self.specs:
                _PLAN.setdefault(spec.site, []).append(spec)
            _rebuild_armed()
        return self

    def __exit__(self, *exc: Any) -> None:
        with _LOCK:
            _PLAN.clear()
            if self._saved:
                _PLAN.update(self._saved)
            _rebuild_armed()


def arm_from_env() -> int:
    """(Re-)arm from ``MXNET_FAULT_PLAN``; returns the number of clauses
    armed.  Called once at import; callable again after an env change."""
    plan = os.environ.get("MXNET_FAULT_PLAN", "")
    if not plan.strip():
        return 0
    specs = parse_plan(plan)
    with _LOCK:
        for spec in specs:
            _PLAN.setdefault(spec.site, []).append(spec)
        _rebuild_armed()
    return len(specs)


def armed_sites() -> List[str]:
    with _LOCK:
        return sorted(k for k, v in _PLAN.items() if v)


def known_sites() -> Dict[str, str]:
    """The full site table (name -> location doc) — the CI doc lint and
    docs/fault_tolerance.md are generated against this."""
    return dict(_SITES)


def injected_count(site: str) -> int:
    """Total injections at ``site`` across all armed specs."""
    with _LOCK:
        return sum(s.injected for s in _PLAN.get(site, ()))


def maybe_fault(site: str, **ctx: Any) -> None:
    """The site call: no-op unless a plan armed this site.  Callers on
    hot paths should gate on the module's ``_ARMED`` bool first."""
    if not _ARMED:
        return
    specs = _PLAN.get(site)
    if not specs:
        return
    for spec in list(specs):
        spec._check(ctx)


def _float_idx(arrays: Sequence[Any]) -> Optional[int]:
    """Index of the first floating-point tensor or numpy array (only
    floats can carry a NaN; token-id int batches pass through)."""
    import numpy as onp
    import torch
    for i, a in enumerate(arrays):
        if isinstance(a, torch.Tensor):
            if a.is_floating_point():
                return i
        elif isinstance(a, onp.ndarray) and \
                onp.issubdtype(a.dtype, onp.floating):
            return i
    return None


def _poison_nan(a: Any) -> Any:
    """A copy of ``a`` (a tensor or a numpy array) with its first
    element NaN."""
    a = a.clone() if hasattr(a, "clone") else a.copy()
    a[(0,) * a.ndim] = float("nan")
    return a


def maybe_corrupt(site: str, arrays: Sequence[Any], **ctx: Any) -> List[Any]:
    """Tensor-carrying site call: like :func:`maybe_fault`, but a firing
    ``kind=nan`` clause corrupts the first FLOAT array with NaN instead
    of raising (other kinds behave exactly as at any site).  Returns
    the (possibly corrupted) arrays; callers gate on ``_ARMED``
    first."""
    out = list(arrays)
    if not _ARMED:
        return out
    specs = _PLAN.get(site)
    if not specs:
        return out
    fire = []
    fi = _float_idx(out)

    def _do() -> None:
        if fi is None:
            # the clause fired but there is nothing that can carry a
            # NaN (int-only tensors): a silent no-injection would make
            # the plan's metrics lie — fail loudly instead
            raise MXNetError(
                f"fault kind 'nan' fired at site {site!r} but none of "
                f"the {len(out)} tensors present has a float dtype — "
                "nothing can carry a NaN (int token batches?); target "
                "a float-input model or a different site")
        fire.append(True)

    for spec in list(specs):
        spec._check(ctx, corrupt=_do)
    if fire:
        out[fi] = _poison_nan(out[fi])
    return out


# Arm from the environment at import: chaos subprocesses configure the
# whole schedule with MXNET_FAULT_PLAN alone.
arm_from_env()
